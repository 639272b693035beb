#!/usr/bin/env python
"""Mixed-depth genome-scale run of the port's routes and hybrid router
(the PyTorch/CUDA counterpart of tools/mixed_scale_run.py).

tools/mixed_scale_run.py's dataset (2 contigs x 10 Mb at 14x, three 50 kb
islands a contig at +246x, 900 bp reads, 0.5% errors, 5,000 variants a
contig, seed 777, indexed; cached under <data-dir>) goes through three
clean child processes on the card -- --pileup_backend host, fused and
hybrid (tools/torch_scale_run.run_child) -- whose VCF bodies must be
pairwise identical. The hybrid run's routing counters, whether it routed
both ways, and its ratio to the best pure route are recorded; speed is
not asserted.

    python tools/torch_mixed_scale_run.py [--contig-len N] [--quick]
        [--device cuda|cpu] [--data-dir DIR] [--data-only]

--contig-len cuts the contigs (variants keep their density; the islands
keep their length and depth and sit at the quarters of each contig).
--quick: 2 contigs x 12 kb with 1 kb islands. --data-only simulates and
indexes the dataset and stops. Writes
TORCH_MIXED_SCALE.json (--quick: <data-dir>/torch_mixed_scale_quick.json).
Raises without a card unless --device cpu.
"""

import argparse
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_scale_run as tsr  # noqa: E402

N_CONTIGS = 2
CONTIG_LEN = 10_000_000
DEPTH = 14
ISLANDS_PER_CONTIG = 3
ISLAND_LEN = 50_000
ISLAND_EXTRA_DEPTH = 246       # 14 + 246 = 260x, the renorm regime
N_VARIANTS = 5_000             # per contig of CONTIG_LEN
SEED = 777
QUICK = {"contig_len": 12_000, "island_len": 1_000}


def islands(contig_len, island_len):
    """extra_regions for simulate_bam: the islands at each contig's
    quarters."""
    def extra(names):
        out = {}
        for name, _len in names:
            out[name] = []
            for k in range(ISLANDS_PER_CONTIG):
                lo = (k + 1) * contig_len // (ISLANDS_PER_CONTIG + 1)
                out[name].append((lo, lo + island_len, ISLAND_EXTRA_DEPTH))
        return out
    return extra


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--contig-len", type=int, default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--data-only", action="store_true",
                    help="simulate and index the dataset, then stop")
    args = ap.parse_args(argv)

    import torch
    import bench_torch
    from clair3_rna_torch import resolve_device

    device = resolve_device(args.device)   # raises without a card
    if args.data_dir:
        bench_torch.DATA_DIR = os.path.abspath(args.data_dir)
    contig_len = args.contig_len or (QUICK["contig_len"] if args.quick
                                     else CONTIG_LEN)
    island_len = QUICK["island_len"] if args.quick else ISLAND_LEN
    n_var = tsr.n_variants_for(contig_len, N_VARIANTS, CONTIG_LEN)
    data_dir = os.path.join(
        bench_torch.DATA_DIR, f"mixed_{N_CONTIGS}x{contig_len}_{DEPTH}"
        f"+{ISLAND_EXTRA_DEPTH}x{island_len}_{SEED}")
    fasta, bam, gen_s = tsr.make_data(
        data_dir, N_CONTIGS, contig_len, n_var, seed=SEED,
        extra=islands(contig_len, island_len))
    if args.data_only:
        return None
    card = bench_torch.card_line() if device.type == "cuda" else None
    t0 = time.time()
    weights = tsr.prepare(device, args.quick)
    prep_s = time.time() - t0
    workdir = os.path.join(data_dir, "run")
    shutil.rmtree(workdir, ignore_errors=True)

    runs, rows = {}, {}
    for backend in ("host", "fused", "hybrid"):
        runs[backend] = tsr.run_child("full", fasta, bam,
                                      os.path.join(workdir, backend),
                                      device, weights, backend)
        rows[backend] = tsr.body(os.path.join(workdir, backend, "full.vcf"))
        print(f"[torch_mixed_scale_run] {backend}: "
              f"{runs[backend]['sites_per_s']} sites/s, "
              f"{len(rows[backend])} rows", file=sys.stderr)
    for backend in ("fused", "hybrid"):
        if rows[backend] != rows["host"]:
            raise RuntimeError(f"{backend} diverged from host: "
                               f"{len(rows[backend])} vs {len(rows['host'])}"
                               " rows")

    best_pure = max(runs["host"]["sites_per_s"], runs["fused"]["sites_per_s"])
    routing = runs["hybrid"].get("routing", {})
    result = {
        "device": {"type": device.type, "card": card,
                   "kind": torch.cuda.get_device_name(0)
                   if device.type == "cuda" else "cpu"},
        "dataset": {
            "contigs": N_CONTIGS, "contig_len": contig_len,
            "total_mb": N_CONTIGS * contig_len / 1e6,
            "background_depth": DEPTH,
            "islands": ISLANDS_PER_CONTIG * N_CONTIGS,
            "island_len": island_len,
            "island_depth": DEPTH + ISLAND_EXTRA_DEPTH,
            "variants_per_contig": n_var, "seed": SEED,
            "bam_compressed_mb": runs["host"]["bam_compressed_mb"],
            "simulated_s": round(gen_s, 1),
        },
        "cut": None if (contig_len, island_len) == (CONTIG_LEN, ISLAND_LEN)
        else {"of_total_mb": N_CONTIGS * CONTIG_LEN / 1e6,
              "run_total_mb": N_CONTIGS * contig_len / 1e6},
        "quick": bool(args.quick),
        "prepare_s": round(prep_s, 1),
        "host": runs["host"],
        "fused": runs["fused"],
        "hybrid": {**runs["hybrid"],
                   "vs_best_pure": round(
                       runs["hybrid"]["sites_per_s"] / best_pure, 3),
                   "vs_host": round(runs["hybrid"]["sites_per_s"]
                                    / runs["host"]["sites_per_s"], 3),
                   "vs_fused": round(runs["hybrid"]["sites_per_s"]
                                     / runs["fused"]["sites_per_s"], 3)},
        "rows_identical": True,
        "n_rows": len(rows["host"]),
        "routing_mixed": bool(routing.get("fused_chunks")
                              and routing.get("host_chunks")),
    }
    out = (os.path.join(bench_torch.DATA_DIR, "torch_mixed_scale_quick.json")
           if args.quick else os.path.join(REPO, "TORCH_MIXED_SCALE.json"))
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
