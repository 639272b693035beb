#!/usr/bin/env python
"""Whole-genome-scale run of the PyTorch/CUDA port (the counterpart of
tools/scale_run.py).

Generates tools/scale_run.py's dataset once (8 contigs x 12.5 Mb = 100 Mb
at depth 14, 900 bp reads, 0.5% errors, 6,000 variants a contig, seed
4242, indexed; cached under <data-dir>), then, each in a clean child
process forked from sh (so ru_maxrss starts fresh) on the card:

1. a full indexed streaming run on the host route, with its per-chunk
   joblog and peak RSS (and the RSS of its ready state: imports, the CUDA
   context, the weights, one small network pass);
2. an 8-shard run (parallel/distributed.run_sharded_calling per shard, one
   after another in one child) whose merge_shards body must equal the full
   run's;
3. the fused route and the hybrid router over the same dataset, each body
   equal to the host route's (routing counters and hybrid's ratio to the
   best pure route recorded, not gated);

and from the full run's joblog the shard balance for 8, 16 and 32 shards
under round-robin and the BAI-cost LPT assignment. Each child reports the
calling wall (`wall_s`), the seconds before it (`ready_s`: imports, the
CUDA context, weights to the card) and the parent's wall around the whole
process (`child_wall_s`). The CUDA kernels are built once in the parent
before the children start.

    python tools/torch_scale_run.py [--contig-len N] [--quick]
        [--device cuda|cpu] [--data-dir DIR] [--data-only]

--contig-len cuts the contigs (variants keep their density per base); the
cut is recorded in the artifact. --quick: 4 contigs x 6 kb. --data-only
simulates and indexes the dataset and stops.
Writes TORCH_SCALE_RUN.json (--quick: <data-dir>/torch_scale_run_quick.json).
The RSS budget (2,048 MB, tools/scale_run.py's) bounds what each run adds
to its ready state, asserted after the artifact is written. Raises without
a card unless --device cpu.
"""

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_CONTIGS = 8
CONTIG_LEN = 12_500_000
DEPTH = 14
ERROR_RATE = 0.005
READ_LEN = 900
N_VARIANTS = 6_000            # per contig of CONTIG_LEN
SEED = 4242
RSS_BUDGET_MB = 2_048
CHUNK_SIZE = 100_000
QUICK = {"n_contigs": 4, "contig_len": 6_000}


def n_variants_for(contig_len, per_contig=N_VARIANTS, full_len=CONTIG_LEN):
    """Variants per contig at the full size's density."""
    return max(1, per_contig * contig_len // full_len)


def make_data(data_dir, n_contigs, contig_len, n_variants, seed=SEED,
              extra=None):
    """Simulate (once) and index the dataset: (fasta, bam, the seconds its
    simulation took, kept beside it in simulated.json)."""
    fasta = os.path.join(data_dir, "ref.fa")
    bam = os.path.join(data_dir, "reads.bam")
    stamp = os.path.join(data_dir, "simulated.json")
    if os.path.exists(stamp):
        with open(stamp) as f:
            return fasta, bam, json.load(f)["simulated_s"]
    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.bai import build_index
    from clair3_rna_torch.io.fasta import write_fasta

    tmp = data_dir + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    rng = random.Random(seed)
    names = [(f"chr{i + 1}", contig_len) for i in range(n_contigs)]
    t0 = time.time()
    genome = simdata.random_genome(rng, names)
    variants = simdata.plant_variants(rng, genome, n_per_contig=n_variants)
    extra_regions = extra(names) if extra else None
    write_fasta(os.path.join(tmp, "ref.fa"), genome)
    with open(os.path.join(tmp, "truth_counts.json"), "w") as f:
        json.dump({c: len(v) for c, v in variants.items()}, f)
    simdata.simulate_bam(os.path.join(tmp, "reads.bam"), genome, variants,
                         rng, depth=DEPTH, read_len=READ_LEN,
                         error_rate=ERROR_RATE, extra_regions=extra_regions)
    build_index(os.path.join(tmp, "reads.bam"))
    secs = time.time() - t0
    with open(os.path.join(tmp, "simulated.json"), "w") as f:
        json.dump({"simulated_s": secs}, f)
    shutil.rmtree(data_dir, ignore_errors=True)
    os.rename(tmp, data_dir)
    print(f"[torch_scale_run] dataset generated in {secs:.0f}s "
          f"({os.path.getsize(bam) / 1e6:.0f} MB BAM)", file=sys.stderr)
    return fasta, bam, secs


CHILD = r"""
import json, os, resource, sys, time
t_start = time.time()
sys.path.insert(0, {repo!r})
import torch
torch.backends.cuda.matmul.allow_tf32 = False
from clair3_rna_torch.caller.decode import CallConfig
from clair3_rna_torch.caller.pipeline import run_calling
from clair3_rna_torch.config import PileupConfig
from clair3_rna_torch.models.network import make_wire_forward_fn
from clair3_rna_torch.models.params_io import load_params, params_from_numpy
from clair3_rna_torch.pileup.chunk import open_bam

mode, fasta, bam_path, outdir, device, weights = sys.argv[1:7]
backend = sys.argv[7] if len(sys.argv) > 7 else "host"
params = params_from_numpy(load_params(weights), device=device)
_, forward = make_wire_forward_fn()
cfg = PileupConfig(batch_size=2048)
call_cfg = CallConfig(show_ref=False)
bam = open_bam(bam_path)
if not getattr(bam, "has_index", False):
    raise RuntimeError("the scale run requires indexed streaming mode "
                       "(.bai missing?)")
# one small pass first: the device's libraries are loaded before the
# ready state's high-water mark is read
import numpy as np
forward(params, np.zeros((64, 33, cfg.channel_size), np.uint8),
        np.zeros((64, 33), np.int8)).cpu()
rss_ready = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
t0 = time.time()
if mode == "full":
    _, stats = run_calling(
        bam_path, fasta, os.path.join(outdir, "full.vcf"), cfg=cfg,
        call_cfg=call_cfg, params=params, forward=forward, bam=bam,
        chunk_size={chunk_size}, compress=False, progress=False,
        joblog=os.path.join(outdir, "joblog.tsv"), pileup_backend=backend)
    n = stats.candidates
else:
    from clair3_rna_torch.parallel.distributed import (
        merge_shards, run_sharded_calling, run_shards_with_retry)
    n_shards = int(mode)
    shard_walls = []

    def one_shard(shard_id, resume):
        t1 = time.time()
        st = run_sharded_calling(
            bam_path, fasta, outdir, cfg=cfg, call_cfg=call_cfg,
            params=params, forward=forward, contigs=None,
            n_shards=n_shards, shard_id=shard_id, chunk_size={chunk_size},
            resume=resume, pileup_backend=backend)
        shard_walls.append(time.time() - t1)
        return st

    stats_list = run_shards_with_retry(one_shard, n_shards)
    n = sum(st.candidates for st in stats_list)
    merge_shards(outdir, n_shards, os.path.join(outdir, "merged.vcf"),
                 show_ref=False, qual_cutoff=cfg.effective_qual_cutoff,
                 reference_file_path=fasta, compress=False)
if params.device.type == "cuda":
    torch.cuda.synchronize()
wall = time.time() - t0
out = {{"mode": mode, "wall_s": round(wall, 2), "ready_s": round(t0 - t_start, 2),
        "candidates": int(n), "sites_per_s": round(n / wall, 1),
        "rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024,
        "rss_ready_mb": rss_ready,
        "device": torch.cuda.get_device_name(0)
        if params.device.type == "cuda" else "cpu",
        "pileup_backend": backend,
        "bam_compressed_mb": round(os.path.getsize(bam_path) / 1e6, 1),
        "bytes_inflated_mb": round(bam.bytes_read() / 1e6, 1)
        if hasattr(bam, "bytes_read") else None}}
if mode != "full":
    out["shard_walls"] = [round(w, 2) for w in shard_walls]
else:
    if stats.fused is not None:
        out["fused_counters"] = stats.fused
    if stats.routing is not None:
        out["routing"] = {{k: v for k, v in stats.routing.items()
                          if k != "bucket_walls"}}
print("SCALE_RESULT " + json.dumps(out))
"""


def run_child(mode, fasta, bam, outdir, device, weights, backend="host"):
    """One clean child process; its SCALE_RESULT plus the parent's wall
    around it (process start included)."""
    os.makedirs(outdir, exist_ok=True)
    script = os.path.join(outdir, "child.py")
    with open(script, "w") as f:
        f.write(CHILD.format(repo=REPO, chunk_size=CHUNK_SIZE))
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("CLAIR3_RNA_TORCH_PILEUP_BACKEND", None)
    # sh hop: ru_maxrss is inherited across fork; forking the measured
    # python from sh gives a clean high-water mark
    cmd = " ".join([sys.executable, script, mode, fasta, bam, outdir,
                    device.type, weights, backend])
    t0 = time.time()
    out = subprocess.run(["/bin/sh", "-c", cmd], env=env,
                         capture_output=True, text=True)
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise RuntimeError(f"child {mode} ({backend}) failed")
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("SCALE_RESULT ")][-1]
    res = json.loads(line[len("SCALE_RESULT "):])
    res["child_wall_s"] = round(time.time() - t0, 2)
    return res


def prepare(device, quick):
    """Kernels built once (children load them) and the bench weights
    (bench_torch.py's, trained on the device if not cached): their path."""
    import bench_torch
    if device.type == "cuda":
        from clair3_rna_torch import csrc
        csrc.build_all()
    sizes = bench_torch.QUICK if quick else bench_torch.FULL
    bench_torch.get_trained_params(sizes, device)
    return bench_torch.weights_path(sizes)


def body(path):
    return [ln for ln in open(path) if not ln.startswith("#")]


def shard_balance_from_joblog(joblog_path, bam_path,
                              shard_counts=(8, 16, 32)):
    """Measured per-chunk walls -> shard balance under round-robin and the
    BAI-cost LPT assignment run_sharded_calling uses (the LPT assignment
    from the shards' own cost estimate, the times measured)."""
    from clair3_rna_torch.parallel.distributed import (estimate_chunk_costs,
                                                       shard_tasks_lpt)
    from clair3_rna_torch.pileup.chunk import ChunkTask

    times, tasks = [], []
    with open(joblog_path) as f:
        next(f)
        for line in f:
            cols = line.rstrip("\n").split("\t")
            tasks.append(ChunkTask(cols[0], int(cols[1]), int(cols[2])))
            times.append(float(cols[4]))
    costs = estimate_chunk_costs(bam_path, tasks)
    idx = list(range(len(times)))
    out = {}
    for n in shard_counts:
        policies = {"round_robin": [idx[i::n] for i in range(n)]}
        if costs is not None:
            policies["lpt"] = [shard_tasks_lpt(idx, n, s, costs)
                               for s in range(n)]
        entry = {"chunks": len(times)}
        for name, shards in policies.items():
            shard_time = [sum(times[i] for i in ids) for ids in shards]
            mean = sum(shard_time) / n
            entry[name] = {"mean_s": round(mean, 3),
                           "max_s": round(max(shard_time), 3),
                           "efficiency": round(mean / max(shard_time), 4)
                           if max(shard_time) else 1.0}
        head = entry.get("lpt") or entry["round_robin"]
        entry.update(mean_s=head["mean_s"], max_s=head["max_s"],
                     efficiency=head["efficiency"])
        out[n] = entry
    return out


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
    n_contigs = QUICK["n_contigs"] if args.quick else N_CONTIGS
    contig_len = args.contig_len or (QUICK["contig_len"] if args.quick
                                     else CONTIG_LEN)
    n_var = n_variants_for(contig_len)
    data_dir = os.path.join(bench_torch.DATA_DIR,
                            f"scale_{n_contigs}x{contig_len}_{DEPTH}_{SEED}")
    fasta, bam, gen_s = make_data(data_dir, n_contigs, contig_len, n_var)
    if args.data_only:
        return None
    card = bench_torch.card_line() if device.type == "cuda" else None
    t0 = time.time()
    weights = prepare(device, args.quick)
    prep_s = time.time() - t0
    workdir = os.path.join(data_dir, "run")
    shutil.rmtree(workdir, ignore_errors=True)

    def child(mode, name, backend="host"):
        return run_child(mode, fasta, bam, os.path.join(workdir, name),
                         device, weights, backend)

    full = child("full", "full")
    sharded = child("8", "sharded")
    full_rows = body(os.path.join(workdir, "full", "full.vcf"))
    merged_rows = body(os.path.join(workdir, "sharded", "merged.vcf"))
    if merged_rows != full_rows:
        raise RuntimeError(f"8-shard merge diverged: {len(merged_rows)} vs "
                           f"{len(full_rows)} rows")
    fused = child("full", "fused", "fused")
    hybrid = child("full", "hybrid", "hybrid")
    for name in ("fused", "hybrid"):
        rows = body(os.path.join(workdir, name, "full.vcf"))
        if rows != full_rows:
            raise RuntimeError(f"{name} run diverged from the host route: "
                               f"{len(rows)} vs {len(full_rows)} rows")
    best_pure = max(full["sites_per_s"], fused["sites_per_s"])
    hybrid["vs_best_pure"] = round(hybrid["sites_per_s"] / best_pure, 3)
    routing = hybrid.get("routing", {})
    hybrid["routing_mixed"] = bool(routing.get("fused_chunks")
                                   and routing.get("host_chunks"))

    result = {
        "device": {"type": device.type, "card": card,
                   "kind": torch.cuda.get_device_name(0)
                   if device.type == "cuda" else "cpu"},
        "dataset": {
            "contigs": n_contigs, "contig_len": contig_len,
            "total_mb": n_contigs * contig_len / 1e6, "depth": DEPTH,
            "variants_per_contig": n_var, "seed": SEED,
            "bam_compressed_mb": full["bam_compressed_mb"],
            "decompressed_stream_mb": full.get("bytes_inflated_mb"),
            "simulated_s": round(gen_s, 1),
        },
        "cut": None if (n_contigs, contig_len) == (N_CONTIGS, CONTIG_LEN)
        else {"of_total_mb": N_CONTIGS * CONTIG_LEN / 1e6,
              "run_total_mb": n_contigs * contig_len / 1e6},
        "quick": bool(args.quick),
        "prepare_s": round(prep_s, 1),
        "full_run": full,
        "sharded_8": {**sharded, "merged_rows_identical_to_full": True,
                      "n_rows": len(full_rows)},
        "fused": {**fused, "rows_identical_to_full": True},
        "hybrid": {**hybrid, "rows_identical_to_full": True},
        "rss_budget_mb": RSS_BUDGET_MB,
        "measured_shard_balance": shard_balance_from_joblog(
            os.path.join(workdir, "full", "joblog.tsv"), bam),
    }
    out = (os.path.join(bench_torch.DATA_DIR, "torch_scale_run_quick.json")
           if args.quick else os.path.join(REPO, "TORCH_SCALE_RUN.json"))
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    # the memory bar after the artifact is written: what a run adds to its
    # process's ready state (a CUDA process maps GBs of libraries before it
    # reads a record; tools/scale_run.py's child ran JAX on the CPU)
    grown = {k: r["rss_mb"] - r["rss_ready_mb"]
             for k, r in (("full", full), ("sharded", sharded),
                          ("fused", fused), ("hybrid", hybrid))}
    if max(grown.values()) >= RSS_BUDGET_MB:
        raise RuntimeError(f"peak RSS grew past the {RSS_BUDGET_MB} MB "
                           f"budget over the ready state: {grown}")
    return result


if __name__ == "__main__":
    main()
