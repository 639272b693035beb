#!/usr/bin/env python
"""The phasing model's F1 delta on synthetic reads, trained and called
with the PyTorch/CUDA port (the counterpart of tools/phased_delta.py).

  1. simulate a diploid dataset with planted haplotypes and a raised
     error rate (noise is what makes per-haplotype counts informative);
  2. train an 18-channel model on unphased tensors (the port's tensor2bin
     and train), call, score F1 against the planted variants;
  3. phase + haplotag with the port's pairwise phaser, train a 30-channel
     model on the tagged reads, call with --enable_phasing_model, score;
  4. print both and the delta.

    python tools/torch_phased_delta.py [--contig-len N] [--n-variants N]
        [--depth 25] [--error-rate 0.06] [--epochs 30] [--quick]
        [--device cuda|cpu] [--data-dir DIR]

Every subcommand runs through `python -m clair3_rna_torch`'s entry point
on --device. --quick: a 12 kb contig, 60 variants, 2 epochs, 1% errors
(a model trained 2 epochs on reads with 6% errors calls nothing, which
would leave the quick run nothing to compare). Writes
TORCH_PHASED_DELTA.json (--quick: <data-dir>/torch_phased_delta_quick.json).
"""

import argparse
import json
import os
import random
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_truth_vcf(path, variants):
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\tS\n")
        for v in variants["chr1"]:
            gt = "1/1" if v.genotype == (1, 1) else "0/1"
            f.write(f"chr1\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t60\tPASS\t.\t"
                    f"GT\t{gt}\n")


def f1_of(call_vcf, truth_vcf):
    from clair3_rna_torch.evaluation.compare_vcf import compare_vcf
    r = compare_vcf(call_vcf, truth_vcf, skip_genotyping=True)
    return {"overall": r.overall.f1, "snv": r.by_type["snv"].f1,
            "ins": r.by_type["ins"].f1, "del": r.by_type["del"].f1}


def experiment(d, contig_len, n_variants, depth, error_rate, epochs,
               device):
    """Steps 1-3 in directory d on `device`: the dataset, both models,
    both calls and their F1 against the planted variants. -> the paths of
    what it wrote and {"f1": {"unphased": ..., "phased": ...}}."""
    from clair3_rna_torch import simdata
    from clair3_rna_torch.cli import main as cli
    from clair3_rna_torch.io.fasta import write_fasta

    dev = ["--device", device]
    rng = random.Random(4242)
    genome = simdata.random_genome(rng, [("chr1", contig_len)])
    variants = simdata.plant_variants(
        rng, genome, n_per_contig=n_variants,
        het_genotypes=((0, 1), (1, 0)))
    fasta = os.path.join(d, "ref.fa")
    bam = os.path.join(d, "reads.bam")
    truth = os.path.join(d, "truth.vcf")
    write_fasta(fasta, genome)
    simdata.simulate_bam(bam, genome, variants, rng, depth=depth,
                         error_rate=error_rate)
    build_truth_vcf(truth, variants)

    # A: unphased model
    bins = os.path.join(d, "bins18")
    w18 = os.path.join(d, "w18.npz")
    cli(["tensor2bin", "--bam_fn", bam, "--ref_fn", fasta,
         "--truth_vcf_fn", truth, "--output_dir", bins,
         "--non_variant_keep_fraction", "1.0", *dev])
    cli(["train", "--bin_dir", bins, "--output_fn", w18,
         "--no_indel_length", "--max_epochs", str(epochs),
         "--batch_size", "256", *dev])
    out18 = os.path.join(d, "call18")
    cli(["call", "-B", bam, "-R", fasta, "-o", out18, "--model_path",
         w18, "--include_all_ctgs", "--no_compress", *dev])
    f18 = f1_of(os.path.join(out18, "output.vcf"), truth)

    # B: phase + haplotag with the port's pairwise phaser, then the
    # phased model
    tagged = os.path.join(d, "tagged.bam")
    cli(["phase_bam", "--bam_fn", bam, "--ref_fn", fasta, "--vcf_fn",
         os.path.join(out18, "output.vcf"), "--output_bam_fn", tagged])
    bins30 = os.path.join(d, "bins30")
    w30 = os.path.join(d, "w30.npz")
    cli(["tensor2bin", "--bam_fn", tagged, "--ref_fn", fasta,
         "--truth_vcf_fn", truth, "--output_dir", bins30, "--phased",
         "--non_variant_keep_fraction", "1.0", *dev])
    cli(["train", "--bin_dir", bins30, "--output_fn", w30, "--phased",
         "--no_indel_length", "--max_epochs", str(epochs),
         "--batch_size", "256", *dev])
    out30 = os.path.join(d, "call30")
    cli(["call", "-B", bam, "-R", fasta, "-o", out30, "--model_path",
         w18, "--include_all_ctgs", "--no_compress",
         "--enable_phasing_model", "--phased_model_path", w30, *dev])
    phased_vcf = os.path.join(out30, "output_enable_phasing.vcf")
    if not os.path.exists(phased_vcf):
        phased_vcf = os.path.join(out30, "output.vcf")
    f30 = f1_of(phased_vcf, truth)
    return {"fasta": fasta, "bam": bam, "truth": truth, "w18": w18,
            "w30": w30, "unphased_vcf": os.path.join(out18, "output.vcf"),
            "tagged_bam": tagged, "phased_vcf": phased_vcf,
            "f1": {"unphased": f18, "phased": f30}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--contig-len", type=int, default=None)
    ap.add_argument("--n-variants", type=int, default=None)
    ap.add_argument("--depth", type=int, default=25)
    ap.add_argument("--error-rate", type=float, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--data-dir", default=None)
    args = ap.parse_args(argv)

    from clair3_rna_torch import resolve_device

    device = resolve_device(args.device).type   # raises without a card
    contig_len = args.contig_len or (12_000 if args.quick else 400_000)
    n_variants = args.n_variants or (60 if args.quick else 1200)
    epochs = args.epochs or (2 if args.quick else 30)
    error_rate = args.error_rate or (0.01 if args.quick else 0.06)
    data_dir = os.path.abspath(args.data_dir or os.path.join(REPO,
                                                             ".bench_data"))
    os.makedirs(data_dir, exist_ok=True)

    with tempfile.TemporaryDirectory(dir=data_dir) as d:
        run = experiment(d, contig_len, n_variants, args.depth,
                         error_rate, epochs, device)
    f18, f30 = run["f1"]["unphased"], run["f1"]["phased"]

    result = {"device": device, "quick": bool(args.quick),
              "dataset": {"contig_len": contig_len, "variants": n_variants,
                          "depth": args.depth, "error_rate": error_rate,
                          "seed": 4242},
              "epochs": epochs, "unphased": f18, "phased": f30,
              "delta": {k: f30[k] - f18[k] for k in f18}}
    out = (os.path.join(data_dir, "torch_phased_delta_quick.json")
           if args.quick else os.path.join(REPO, "TORCH_PHASED_DELTA.json"))
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print("F1 (zygosity disregarded, skip_genotyping):")
    print(f"{'':12}{'unphased':>10}{'phased':>10}{'delta':>9}")
    for k in ("overall", "snv", "ins", "del"):
        print(f"{k:12}{f18[k]:>10.4f}{f30[k]:>10.4f}{f30[k] - f18[k]:>+9.4f}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
