#!/bin/bash
# Synthetic quick demo on the PyTorch/CUDA port: train a pileup model from
# scratch on simulated spliced RNA reads, call variants with it, and
# benchmark against the planted truth -- demo/synthetic_quick_demo.sh
# through `python -m clair3_rna_torch` (data generation replaces the HG004
# download; tensor2bin + train replace the shipped checkpoint; compare_vcf
# replaces hap.py).
#
# Usage: bash demo/torch_synthetic_quick_demo.sh [WORKDIR]
#   Runs on the CUDA card (and fails without one).
#   CLAIR3_RNA_TORCH_DEMO_CPU=1 runs every step with --device cpu instead.
set -euo pipefail

DEMO_DIR="$(cd "$(dirname "$0")" && pwd)"
REPO="$(dirname "$DEMO_DIR")"
WORK="${1:-$REPO/.bench_data/torch_demo}"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
DEVICE=cuda
if [ "${CLAIR3_RNA_TORCH_DEMO_CPU:-0}" = "1" ]; then
    DEVICE=cpu
fi

echo "== 1/5 generate synthetic datasets (train + held-out eval) =="
python "$DEMO_DIR/torch_make_demo_data.py" --output_dir "$WORK/train_data" \
    --contig_len 900000 --n_variants 2400 --seed 7
python "$DEMO_DIR/torch_make_demo_data.py" --output_dir "$WORK/data" \
    --contig_len 300000 --n_variants 800 --seed 2024

echo "== 2/5 build training bins (from the training genome only) =="
python -m clair3_rna_torch tensor2bin \
    --bam_fn "$WORK/train_data/reads.bam" --ref_fn "$WORK/train_data/ref.fa" \
    --truth_vcf_fn "$WORK/train_data/truth.vcf" --output_dir "$WORK/bins" \
    --non_variant_keep_fraction 1.0 --device "$DEVICE"

echo "== 3/5 train =="
python -m clair3_rna_torch train \
    --bin_dir "$WORK/bins" --output_fn "$WORK/weights.npz" \
    --max_epochs 60 --batch_size 256 --no_indel_length --device "$DEVICE"

echo "== 4/5 call variants with the trained weights =="
python -m clair3_rna_torch call \
    -B "$WORK/data/reads.bam" -R "$WORK/data/ref.fa" -o "$WORK/out" \
    -p ont_dorado_drna004 --model_path "$WORK/weights.npz" \
    --include_all_ctgs --device "$DEVICE"

echo "== 5/5 benchmark vs planted truth =="
python -m clair3_rna_torch compare_vcf \
    --vcf_fn "$WORK/out/output.vcf.gz" \
    --truth_vcf_fn "$WORK/data/truth.vcf" \
    --bed_fn "$WORK/data/high_conf.bed" --best_f1

echo "== demo complete: outputs in $WORK =="
