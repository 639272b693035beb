#!/usr/bin/env python
"""Scaling measurements of the PyTorch/CUDA port (the counterpart of
tools/scaling_bench.py):

1. the dp mesh (parallel/mesh.py) at dp = 1/2/4 under run_calling on a
   600 kb dataset at depth 35 (random weights, batch 512, 100 kb chunks):
   the VCF body must be identical at every dp. On one card the mesh's
   slots repeat the card (as chip_smoke.py's mesh does), so this shows the
   sharded program runs and stays row-identical; it cannot show a
   speed-up, and none is expected;
2. shard balance from measured work: candidates per 20 kb chunk of the
   same dataset, round-robin shard_tasks assignment, efficiency = mean /
   max shard load for 2/4/8/16 shards;
3. the GRCh38 projection: the same policy over GRCh38's chromosome lengths
   in the reference's 5 Mb chunks, chunk cost proportional to length.

    python tools/torch_scaling_bench.py [--quick] [--device cuda|cpu]
                                        [--data-dir DIR]

--quick: a 60 kb contig, 20 kb chunks. Writes TORCH_SCALING.json
(--quick: <data-dir>/torch_scaling_quick.json), with the single-card
sites/s of TORCH_BENCH_DETAIL.json as anchor when that file exists.
Raises without a card unless --device cpu.
"""

import argparse
import json
import os
import random
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GRCH38 = [  # chromosome lengths (bp), GRCh38 primary assembly
    248956422, 242193529, 198295559, 190214555, 181538259, 170805979,
    159345973, 145138636, 138394717, 133797422, 135086622, 133275309,
    114364328, 107043718, 101991189, 90338345, 83257441, 80373285,
    58617616, 64444167, 46709983, 50818468, 156040895, 57227415,
]
FULL = {"contig_len": 600_000, "n_variants": 3300, "chunk": 100_000}
QUICK = {"contig_len": 60_000, "n_variants": 330, "chunk": 20_000}


def make_data(data_dir, contig_len, n_variants, depth=35):
    """tools/scaling_bench.py's dataset (seed 1234), cached in data_dir."""
    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.fasta import write_fasta

    d = os.path.join(data_dir, f"scaling_{contig_len}_{depth}_{n_variants}")
    fasta, bam = os.path.join(d, "ref.fa"), os.path.join(d, "reads.bam")
    if os.path.exists(bam) and os.path.getsize(bam) > 0:
        return fasta, bam
    os.makedirs(d, exist_ok=True)
    rng = random.Random(1234)
    genome = simdata.random_genome(rng, [("chr1", contig_len)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=n_variants)
    write_fasta(fasta, genome)
    simdata.simulate_bam(bam + ".tmp", genome, variants, rng, depth=depth)
    os.replace(bam + ".tmp", bam)
    return fasta, bam


def measure_dp_mesh(fasta, bam, device, chunk, dps=(1, 2, 4)):
    """run_calling through a ShardedNet on a mesh of dp repeated slots of
    `device`: warm run, then one timed run each; bodies must agree."""
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.caller.pipeline import run_calling
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.models.network import (init_params,
                                                 make_wire_forward_fn)
    from clair3_rna_torch.parallel.mesh import make_mesh, shard_params
    import bench_torch

    cfg = PileupConfig(batch_size=512)
    call_cfg = CallConfig(show_ref=False)
    net = init_params(0, device=device)
    _, forward = make_wire_forward_fn()
    results, baseline = {}, None
    out = bam + ".dp.vcf"
    for dp in dps:
        params = shard_params(net, make_mesh(devices=[device] * dp, tp=1))
        kw = dict(cfg=cfg, call_cfg=call_cfg, params=params, forward=forward,
                  contigs=["chr1"], chunk_size=chunk, compress=False,
                  progress=False)
        run_calling(bam, fasta, out, **kw)
        t0 = time.perf_counter()
        _, stats = run_calling(bam, fasta, out, **kw)
        bench_torch.sync(device)
        wall = time.perf_counter() - t0
        rows = [ln for ln in open(out) if not ln.startswith("#")]
        if baseline is None:
            baseline = rows
        if rows != baseline:
            raise RuntimeError(f"dp={dp} VCF diverged from dp=1")
        results[dp] = {"sites_per_s": stats.candidates / wall,
                       "wall_s": wall, "candidates": stats.candidates,
                       "rows": len(rows)}
    return results


def measured_shard_balance(fasta_path, bam_path, device):
    """Per-chunk measured candidate counts -> round-robin shard balance."""
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.io.fasta import FastaFile
    from clair3_rna_torch.parallel.distributed import shard_tasks
    from clair3_rna_torch.pileup.chunk import (build_chunk_tensors, open_bam,
                                               plan_chunks)

    fasta = FastaFile(fasta_path)
    bam = open_bam(bam_path)
    cfg = PileupConfig()
    tasks = plan_chunks(fasta, contigs=["chr1"], chunk_size=20_000)
    loads = [len(build_chunk_tensors(bam, fasta, t, cfg, device=device))
             for t in tasks]
    out = {}
    for n in (2, 4, 8, 16):
        shard_loads = [sum(loads[i] for i in shard_tasks(
            list(range(len(tasks))), n, s)) for s in range(n)]
        mean = sum(shard_loads) / n
        out[n] = round(mean / max(shard_loads), 4) if max(shard_loads) \
            else 1.0
    return {"n_chunks": len(tasks), "total_candidates": sum(loads),
            "efficiency_by_shards": out}


def genome_projection(chunk_mb=5):
    from clair3_rna_torch.parallel.distributed import shard_tasks

    chunk = chunk_mb * 1_000_000
    chunks = []
    for length in GRCH38:
        n = max(1, -(-length // chunk))
        per = length // n + (1 if length % n else 0)
        for i in range(n):
            chunks.append(min(per, length - per * i))
    out = {}
    for n in (8, 16, 32, 64, 128, 256):
        shard_loads = [sum(chunks[i] for i in shard_tasks(
            list(range(len(chunks))), n, s)) for s in range(n)]
        out[n] = round(sum(shard_loads) / n / max(shard_loads), 4)
    return {"n_chunks": len(chunks), "efficiency_by_shards": out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--data-dir", default=None)
    args = ap.parse_args(argv)

    import torch
    import bench_torch
    from clair3_rna_torch import resolve_device

    device = resolve_device(args.device)   # raises without a card
    if args.data_dir:
        bench_torch.DATA_DIR = os.path.abspath(args.data_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    sizes = QUICK if args.quick else FULL
    card = bench_torch.card_line() if device.type == "cuda" else None
    fasta, bam = make_data(bench_torch.DATA_DIR, sizes["contig_len"],
                           sizes["n_variants"])
    dp_mesh = measure_dp_mesh(fasta, bam, device, sizes["chunk"])
    anchor = None
    if os.path.exists(bench_torch.DETAIL):
        with open(bench_torch.DETAIL) as f:
            d = json.load(f)
        anchor = {"sites_per_s": d.get("value"),
                  "device": d.get("device"), "file": "TORCH_BENCH_DETAIL.json"}
    result = {
        "device": {"type": device.type, "card": card,
                   "kind": torch.cuda.get_device_name(0)
                   if device.type == "cuda" else "cpu"},
        "quick": bool(args.quick),
        "dataset": {"contig_len": sizes["contig_len"], "depth": 35,
                    "variants": sizes["n_variants"], "seed": 1234},
        "single_card_anchor": anchor,
        "dp_mesh": dp_mesh,
        "dp_mesh_note": ("dp slots repeat one device: rows must be "
                         "identical at every dp; no speed-up is expected"),
        "balance": measured_shard_balance(fasta, bam, device),
        "projection": genome_projection(),
    }
    out = (os.path.join(bench_torch.DATA_DIR,
                                    "torch_scaling_quick.json")
                       if args.quick else os.path.join(REPO,
                                                       "TORCH_SCALING.json"))
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
