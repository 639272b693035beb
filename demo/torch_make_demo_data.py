#!/usr/bin/env python
"""Generate the synthetic quick-demo dataset of the PyTorch/CUDA port: a
spliced-read RNA BAM, its reference FASTA, and a GIAB-style truth VCF +
high-confidence BED (demo/make_demo_data.py's files, simulated by
clair3_rna_torch/simdata.py: the same files from the same seed).

The reference's quick demos download an HG004 chr1 slice
(demo/ont_quick_demo.sh:1-97); this demo is fully synthetic so it runs
anywhere without a download, while exercising the same workflow:
train -> call -> evaluate.
"""

import argparse
import os
import random
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--contig_len", type=int, default=300_000)
    ap.add_argument("--n_variants", type=int, default=800)
    ap.add_argument("--depth", type=int, default=35)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--contig_name", default="chr1")
    args = ap.parse_args()

    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.fasta import write_fasta

    ctg = args.contig_name
    os.makedirs(args.output_dir, exist_ok=True)
    rng = random.Random(args.seed)
    genome = simdata.random_genome(rng, [(ctg, args.contig_len)])
    variants = simdata.plant_variants(rng, genome,
                                      n_per_contig=args.n_variants)
    fasta = os.path.join(args.output_dir, "ref.fa")
    bam = os.path.join(args.output_dir, "reads.bam")
    write_fasta(fasta, genome)
    mid = args.contig_len // 2
    simdata.simulate_bam(bam, genome, variants, rng, depth=args.depth,
                         splice_sites={ctg: [(mid - 2000, mid + 3000)]})

    truth = os.path.join(args.output_dir, "truth.vcf")
    with open(truth, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\tSAMPLE\n")
        for v in variants[ctg]:
            gt = "1/1" if v.genotype == (1, 1) else "0/1"
            f.write(f"{ctg}\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t60\tPASS\t.\t"
                    f"GT\t{gt}\n")

    bed = os.path.join(args.output_dir, "high_conf.bed")
    with open(bed, "w") as f:
        f.write(f"{ctg}\t0\t{args.contig_len}\n")
    print(f"[INFO] demo data in {args.output_dir}: "
          f"{len(variants[ctg])} planted variants")


if __name__ == "__main__":
    main()
