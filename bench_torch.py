#!/usr/bin/env python
"""Benchmark of the PyTorch/CUDA port (clair3_rna_torch): bench.py's
configurations, datasets and gates, run through the port on the card.

    python bench_torch.py [--quick] [--device cuda|cpu] [--data-dir DIR]

Configurations, in bench.py's order: main (candidate sites/s of
run_calling, host route, best and median of 5 timed runs), high_depth
(260x, the renormalisation regime), sustained_5mb (50 chunks, BAM open
included), fused_e2e (the fused route; body equal to the host route's),
fused_high_depth (fused, renorm candidates folded, no fallback, no second
windows fetch), mixed_depth (14x with three +246x islands: host, fused and
hybrid, identical bodies; hybrid's routing and its ratio to the best pure
route are recorded, not gated), phased_e2e (phase + haplotag of the main
dataset, then the 30-channel re-call on both routes, identical bodies) and
fused_device_only (the fused pass over chunks staged on the card, timed
stream-ordered with CUDA events; with the events wire, K3, as ablation).
One more fused run of the main dataset runs under CLAIR3_RNA_TORCH_PROFILE,
outside the timed runs: its torch.profiler trace gives the device's busy
share over the trace's window (first to last recorded event), the same
device time over the unprofiled fused run's wall, the kernels with the
most device time and the longest idle gaps.

Data: bench.py's datasets, simulated by clair3_rna_torch/simdata.py (a copy
of tests/simdata.py: the same files from the same seed), cached under
--data-dir (default .bench_data/). First-pass weights are trained once
through the port's tensor2bin and train on the device, as bench.py trains
its own, and cached as <data-dir>/torch_bench_weights.npz beside the
recipe that trained them (retrained when it differs); the phased
weights are the committed BENCH_WEIGHTS_PHASED.npz. The reference chain's
sites/s is read from BENCH_BASELINE_CACHE.json (measured on an earlier
host, never rewritten here) and reported as such, not as a ratio on this
card.

--quick cuts every dataset to one 8-60 kb contig (30 kb chunks), the
weights to 2 epochs on 20 kb, and every configuration to one run: for the
CPU tests and chip_smoke.py. Without a card the run raises unless
--device cpu is given; a CPU run's times are CPU times and its busy share
is not measured.

Writes TORCH_BENCH_DETAIL.json (--quick: <data-dir>/torch_bench_quick.json)
and prints the detail, then a compact summary as the last line.
"""

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

CACHE = os.path.join(REPO, "BENCH_BASELINE_CACHE.json")
WEIGHTS_PHASED = os.path.join(REPO, "BENCH_WEIGHTS_PHASED.npz")
DETAIL = os.path.join(REPO, "TORCH_BENCH_DETAIL.json")
SEED = 1234
DATA_DIR = os.path.join(REPO, ".bench_data")  # regenerable, gitignored

# bench.py's sizes (bench.py:26-30, 219-224, 287-291, 98-119)
FULL = {
    "main": ("main", 1_200_000, 35, 6600, None),
    "high_depth": ("high_depth", 150_000, 260, 800, None),
    "sustained": ("sustained", 5_000_000, 35, 27_000, None),
    "mixed": ("mixed_depth", 1_200_000, 14, 6600,
              {"chr1": [(200_000, 260_000, 246), (600_000, 660_000, 246),
                        (900_000, 960_000, 246)]}),
    "train": (400_000, 35, 1200, 40),   # contig, depth, variants, epochs
    "chunk_size": 100_000,
    "runs": {"main": 5, "high_depth": 1, "sustained": 2, "fused_warm": 1,
             "fused": 3, "fused_high_depth": 2, "mixed_host": 2,
             "mixed_fused": 2, "mixed_hybrid": 3, "phased": 2, "device": 3},
    "warm_batches": (2048, 1024, 512),
}
# the same shapes on one short contig: variant density, depths and island
# placement scaled with the contig
QUICK = {
    "main": ("main", 30_000, 35, 165, None),
    "high_depth": ("high_depth", 8_000, 260, 43, None),
    "sustained": ("sustained", 60_000, 35, 330, None),
    "mixed": ("mixed_depth", 45_000, 14, 248,
              {"chr1": [(7_500, 9_750, 246), (22_500, 24_750, 246),
                        (33_750, 36_000, 246)]}),
    "train": (20_000, 35, 60, 2),
    "chunk_size": 30_000,
    "runs": {k: (0 if k == "fused_warm" else 1) for k in FULL["runs"]},
    "warm_batches": (64,),
}


def card_line():
    """`nvidia-smi`'s name and power limit of the card(s)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def _dataset(tag, contig_len, depth, n_variants, splice=True,
             extra_regions=None):
    """Build (or reuse from DATA_DIR) one synthetic dataset: bench.py's
    _dataset, byte for byte, through the port's simulator."""
    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.fasta import write_fasta

    d = _dataset_dir(tag, contig_len, depth, n_variants)
    fasta_path = os.path.join(d, "ref.fa")
    bam_path = os.path.join(d, "reads.bam")

    def _valid(p):
        try:
            return os.path.getsize(p) > 0
        except OSError:
            return False
    if _valid(fasta_path) and _valid(bam_path):
        return fasta_path, bam_path
    tmp = d + ".tmp"  # build in a staging dir; publish atomically by rename
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    rng = random.Random(SEED)
    genome = simdata.random_genome(rng, [("chr1", contig_len)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=n_variants)
    write_fasta(os.path.join(tmp, "ref.fa"), genome)
    mid = contig_len // 2
    simdata.simulate_bam(
        os.path.join(tmp, "reads.bam"), genome, variants, rng, depth=depth,
        splice_sites={"chr1": [(mid - 2000, mid + 3000)]} if splice else None,
        extra_regions=extra_regions)
    shutil.rmtree(d, ignore_errors=True)
    os.rename(tmp, d)
    return fasta_path, bam_path


def _training_set(tdir, contig_len, depth, n_variants):
    """bench.py's weight-training dataset (seed 777) and its truth VCF."""
    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.fasta import write_fasta

    rng = random.Random(777)
    genome = simdata.random_genome(rng, [("chr1", contig_len)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=n_variants)
    fasta_path = os.path.join(tdir, "ref.fa")
    bam_path = os.path.join(tdir, "reads.bam")
    truth_path = os.path.join(tdir, "truth.vcf")
    write_fasta(fasta_path, genome)
    simdata.simulate_bam(bam_path, genome, variants, rng, depth=depth)
    with open(truth_path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\tSAMPLE\n")
        for v in variants["chr1"]:
            gt = "1/1" if v.genotype == (1, 1) else "0/1"
            f.write(f"chr1\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t60\tPASS"
                    f"\t.\tGT\t{gt}\n")
    return fasta_path, bam_path, truth_path


def _make(job):
    """One dataset job (run in a worker process when several are due)."""
    kind, args = job
    if kind == "train":
        return _training_set(*args)
    tag, contig_len, depth, n_variants, extra = args
    return _dataset(tag, contig_len, depth, n_variants, extra_regions=extra)


def make_datasets(sizes, train_dir=None):
    """Every dataset of `sizes` (and the training set into train_dir when
    given), those not cached simulated in parallel worker processes when
    more than one is due: {key: (fasta, bam)} (+ "train": (fasta, bam,
    truth))."""
    jobs = {k: ("data", sizes[k]) for k in ("main", "high_depth",
                                             "sustained", "mixed")}
    if train_dir is not None:
        jobs["train"] = ("train", (train_dir,) + sizes["train"][:3])
    due = [k for k in jobs if k == "train" or not _cached(*sizes[k][:4])]
    out = {}
    if len(due) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        t0 = time.time()
        with ProcessPoolExecutor(
                max_workers=min(len(due), os.cpu_count() or 1),
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_set_data_dir, initargs=(DATA_DIR,)) as pool:
            futs = {k: pool.submit(_make, jobs[k]) for k in due}
            out = {k: f.result() for k, f in futs.items()}
        print(f"[bench_torch] simulated {sorted(due)} in "
              f"{time.time() - t0:.1f} s", file=sys.stderr)
    out.update({k: _make(j) for k, j in jobs.items() if k not in out})
    return out


def _set_data_dir(path):
    global DATA_DIR
    DATA_DIR = path


def _dataset_dir(tag, contig_len, depth, n_variants):
    return os.path.join(DATA_DIR,
                        f"{tag}_{contig_len}_{depth}_{n_variants}_{SEED}")


def _cached(*size):
    d = _dataset_dir(*size)
    return all(os.path.exists(os.path.join(d, f)) and
               os.path.getsize(os.path.join(d, f)) > 0
               for f in ("ref.fa", "reads.bam"))


def weights_path(sizes):
    name = "torch_bench_weights_quick.npz" if sizes is QUICK \
        else "torch_bench_weights.npz"
    return os.path.join(DATA_DIR, name)


def _recipe(sizes):
    """What trains the bench weights, kept beside them."""
    return {"train": list(sizes["train"]), "batch_size": 256}


def _recipe_path(sizes):
    return weights_path(sizes)[:-len(".npz")] + ".recipe.json"


def weights_cached(sizes):
    """Whether weights_path(sizes) holds weights of sizes' recipe."""
    try:
        with open(_recipe_path(sizes)) as f:
            return (json.load(f) == _recipe(sizes)
                    and os.path.exists(weights_path(sizes)))
    except OSError:
        return False


def get_trained_params(sizes, device, train_set=None):
    """First-pass weights trained through the port's tensor2bin and train
    on `device` (bench.py's recipe: every candidate kept, batch 256, no
    indel-length heads), cached in weights_path(sizes) beside a stamp of
    the recipe that trained them (retrained when the recipe differs).
    -> numpy tree."""
    from clair3_rna_torch.cli import main as cli_main
    from clair3_rna_torch.models.params_io import load_params

    path, recipe = weights_path(sizes), _recipe(sizes)
    if weights_cached(sizes):
        return load_params(path)
    print("[bench_torch] training bench weights (one-time, cached)...",
          file=sys.stderr)
    t0 = time.time()
    os.makedirs(DATA_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=DATA_DIR) as tdir:
        if train_set is None:
            train_set = _training_set(tdir, *sizes["train"][:3])
        fasta_path, bam_path, truth_path = train_set
        bins = os.path.join(tdir, "bins")
        cli_main(["tensor2bin", "--bam_fn", bam_path, "--ref_fn", fasta_path,
                  "--truth_vcf_fn", truth_path, "--output_dir", bins,
                  "--non_variant_keep_fraction", "1.0",
                  "--device", device.type])
        tmp = os.path.join(tdir, "weights.npz")
        cli_main(["train", "--bin_dir", bins, "--output_fn", tmp,
                  "--max_epochs", str(sizes["train"][3]),
                  "--batch_size", str(recipe["batch_size"]),
                  "--no_indel_length", "--device", device.type])
        os.replace(tmp, path)
        with open(os.path.join(tdir, "recipe.json"), "w") as f:
            json.dump(recipe, f)
        os.replace(os.path.join(tdir, "recipe.json"), _recipe_path(sizes))
    print(f"[bench_torch] weights trained in {time.time() - t0:.1f} s",
          file=sys.stderr)
    return load_params(path)


def _vcf_body(path):
    return [line for line in open(path) if not line.startswith("#")]


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stream_seconds(calls, device):
    """Seconds for `calls` enqueued back to back on the current stream:
    between two CUDA events, synchronizing once after the last; on the
    CPU, the host clock around the calls."""
    import torch
    if device.type != "cuda":
        t0 = time.perf_counter()
        for c in calls:
            c()
        return time.perf_counter() - t0
    sync(device)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for c in calls:
        c()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / 1e3


def warm_network(params, forward, cfg, batches):
    """One pass at each batch size the pipeline dispatches (bench.py's: the
    full batch and the final-flush halves down to 512), before the timed
    region."""
    import numpy as np
    for b in batches:
        forward(params, np.zeros((b, 33, cfg.channel_size), np.uint8),
                np.zeros((b, 33), np.int8)).cpu()


def timed_runs(bam_path, fasta_path, cfg, call_cfg, params, forward, *,
               n_runs, chunk_size, backend="host", include_open=False):
    """bench.py's _timed_runs on the port: n_runs of run_calling over chr1
    from one BAM open; the best run, with the median sites/s."""
    from clair3_rna_torch.caller.pipeline import run_calling
    from clair3_rna_torch.pileup.chunk import open_bam

    out_path = bam_path + ".bench_out.vcf"
    t0 = time.perf_counter()
    bam = open_bam(bam_path)
    open_s = time.perf_counter() - t0
    runs = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        _, stats = run_calling(
            bam_path, fasta_path, out_path, cfg=cfg, call_cfg=call_cfg,
            params=params, forward=forward, contigs=["chr1"], bam=bam,
            chunk_size=chunk_size, compress=False, progress=False,
            pileup_backend=backend)
        sync(params.device)
        total = time.perf_counter() - t0
        if include_open:
            total += open_s
        if stats.candidates == 0:
            raise RuntimeError("bench produced no candidates")
        run = {"n_candidates": stats.candidates,
               "bam_open_s": round(open_s, 3), "build_s": stats.build_s,
               "infer_s": stats.infer_s, "decode_s": stats.decode_s,
               "wall_s": total, "sites_per_s": stats.candidates / total,
               "backend": backend}
        if stats.fused is not None:
            run["fused_counters"] = stats.fused
        if stats.routing is not None:
            run["routing"] = stats.routing
        runs.append(run)
    walls = [r["wall_s"] for r in runs]
    runs.sort(key=lambda r: r["sites_per_s"])
    best = dict(runs[-1])
    best["n_runs"] = n_runs
    best["wall_s_runs"] = walls
    best["median_sites_per_s"] = round(runs[len(runs) // 2]["sites_per_s"], 1)
    best["sites_per_s_open_amortized"] = round(
        best["n_candidates"] / (best["wall_s"] + (0 if include_open
                                                  else best["bam_open_s"])), 1)
    return best


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_activity(trace_path, top=10, n_gaps=5):
    """Busy share of the device over a torch.profiler Chrome trace's
    window (every complete event, host and device), from the device's own
    activity rows (kernels, copies, memsets): their union over the window.
    Also the `top` kernels by device time with their launches, and the
    `n_gaps` longest gaps with no device activity. A
    CLAIR3_RNA_TORCH_PROFILE trace holds every thread's host operators and
    spans, and its window is the whole of run_calling: set-up, the chunk
    loop, sort, bgzip and tabix."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e and "ts" in e]
    if not events:
        return {"busy_share": None, "note": "empty trace"}
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("cat") in DEVICE_CATS)
    out = {"window_ms": (hi - lo) / 1e3, "device_events": len(dev)}
    if not dev:
        out.update(busy_share=None, note="no device activity in the trace")
        return out
    merged = [list(dev[0])]
    for s, e in dev[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1] - lo)
            for i in range(len(merged) - 1)]
    gaps += [(merged[0][0] - lo, 0.0), (hi - merged[-1][1], merged[-1][1] - lo)]
    gaps.sort(reverse=True)
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            ent = by_name.setdefault(e.get("name", "?"), [0.0, 0])
            ent[0] += float(e["dur"])
            ent[1] += 1
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    out.update(
        busy_ms=busy / 1e3, busy_share=busy / (hi - lo),
        kernel_ms=sum(v[0] for v in by_name.values()) / 1e3,
        kernel_launches=sum(v[1] for v in by_name.values()),
        top_kernels=[{"name": n[:120], "ms": v[0] / 1e3, "launches": v[1]}
                     for n, v in kernels],
        longest_idle_gaps=[{"ms": g / 1e3, "at_ms": at / 1e3}
                           for g, at in gaps[:n_gaps]])
    return out


def profiled_run(bam_path, fasta_path, cfg, call_cfg, params, forward,
                 chunk_size, backend="fused"):
    """One run under CLAIR3_RNA_TORCH_PROFILE (outside the timed runs) and
    the device activity of its trace; the busy share is over the whole
    run, its serial head and tail included."""
    pdir = os.path.join(DATA_DIR, "torch_profile")
    shutil.rmtree(pdir, ignore_errors=True)
    os.environ["CLAIR3_RNA_TORCH_PROFILE"] = pdir
    try:
        run = timed_runs(bam_path, fasta_path, cfg, call_cfg, params,
                         forward, n_runs=1, chunk_size=chunk_size,
                         backend=backend)
    finally:
        os.environ.pop("CLAIR3_RNA_TORCH_PROFILE", None)
    act = device_activity(os.path.join(pdir, "trace.json"))
    act.update(backend=backend, wall_s=run["wall_s"],
               n_candidates=run["n_candidates"],
               trace=os.path.relpath(os.path.join(pdir, "trace.json"), REPO))
    return act


def stage_bench_chunks(bam_path, fasta_path, cfg, chunk_size, device,
                       modes=("packed",)):
    """chr1's chunks extracted and staged as the fused route stages them,
    with their tensors on `device`: a list of dicts with the staging
    ("packed": StagedPacked, "events": StagedChunk), tensors, core, and
    the host seconds of extraction and staging per mode (`extract_s`)."""
    from clair3_rna_torch import config as _c
    from clair3_rna_torch.io.fasta import FastaFile
    from clair3_rna_torch.ops.fused_pileup import (resolve_wire, stage_chunk,
                                                   stage_chunk_packed,
                                                   staged_tensors)
    from clair3_rna_torch.pileup.chunk import (extract_region_events,
                                               open_bam, plan_chunks,
                                               ref_codes_from)
    from clair3_rna_torch.pileup.packed import extract_region_packed

    fasta = FastaFile(fasta_path)
    bam = open_bam(bam_path)
    wire = resolve_wire()
    chunks = []
    for task in plan_chunks(fasta, contigs=["chr1"], chunk_size=chunk_size):
        contig_len = fasta.contig_length(task.ctg_name)
        row_lo = max(0, task.start - 33)
        row_hi = min(contig_len, task.end + 33)
        ref_lo = max(0, task.start - _c.EXPAND_REFERENCE_REGION)
        ref_seq = fasta.fetch(task.ctg_name, ref_lo, min(
            contig_len, task.end + _c.EXPAND_REFERENCE_REGION))
        codes = ref_codes_from(ref_seq[row_lo - ref_lo: row_hi - ref_lo])
        ent = {"task": task, "extract_s": {}}
        for mode in modes:
            t0 = time.perf_counter()
            if mode == "packed":
                pk = extract_region_packed(bam, task.ctg_name, row_lo,
                                           row_hi, cfg)
                ent["n_events"] = pk.n_events
                st = stage_chunk_packed(pk, codes, cfg, task.start,
                                        task.end, wire=wire)
            else:
                ev = extract_region_events(bam, task.ctg_name, row_lo,
                                           row_hi, cfg)
                st = stage_chunk(ev, codes, cfg, task.start, task.end)
            ent["extract_s"][mode] = time.perf_counter() - t0
            ent[mode] = st
            ent[mode + "_tensors"] = staged_tensors(st, device)
            ent[mode + "_wire_bytes"] = sum(
                a.nbytes for a in vars(st).values()
                if hasattr(a, "nbytes"))
        ent["core"] = (st.core_lo, st.core_hi)
        chunks.append(ent)
    sync(device)
    return chunks, wire


def bench_fused_device(bam_path, fasta_path, params, cfg, chunk_size,
                       n_timed=3, ablation=True):
    """bench.py's _bench_fused_device on the port: the fused pass over
    chr1's chunks staged on the card (no extraction or host-to-card copy
    in the timed region). device_s: one pass per chunk, each chunk's
    header fetched (one round trip a chunk); device_stream_s: every chunk
    enqueued, CUDA events around, one synchronize at the end; the sel
    entry point (no mask, no network) for the front end. With `ablation`,
    the events wire (K3) the same way."""
    import torch
    from clair3_rna_torch.ops.fused_pileup import make_fused_fn

    device = params.device
    modes = ("packed", "events") if ablation else ("packed",)
    chunks, wire = stage_bench_chunks(bam_path, fasta_path, cfg, chunk_size,
                                      device, modes=modes)
    n_events = sum(c["n_events"] for c in chunks)

    def time_mode(mode):
        fn = make_fused_fn(params, cfg, max_candidates=1024, wire=wire,
                           mode=mode)
        args = [(c[mode + "_tensors"], c["core"]) for c in chunks]
        sel = torch.arange(1024, dtype=torch.int32, device=device)

        def full_pass():
            t0 = time.perf_counter()
            outs = [fn(t, core) for t, core in args]
            n = sum(int(o[0, 0].item()) for o in outs)
            return time.perf_counter() - t0, n

        full = [lambda t=t, core=core: fn(t, core) for t, core in args]
        front = [lambda t=t, core=core: fn(t, core, sel=sel)
                 for t, core in args]
        if n_timed > 1:  # first passes: allocator growth, first launches
            full_pass()
            stream_seconds(front, device)
        runs = [full_pass() for _ in range(n_timed)]
        dt = min(r[0] for r in runs)
        n_cands = runs[0][1]
        stream_s = min(stream_seconds(full, device) for _ in range(n_timed))
        win_s = min(stream_seconds(front, device) for _ in range(n_timed))
        return {"n_candidates": n_cands, "n_events": int(n_events),
                "n_chunks": len(chunks), "mode": mode,
                "wire": wire if mode == "packed" else "events",
                "device_s": round(dt, 4),
                "device_s_runs": [round(r[0], 4) for r in runs],
                "device_stream_s": round(stream_s, 4),
                "stream_events_per_s": round(n_events / stream_s, 1),
                "stage_expand_count_gather_s": round(win_s, 4),
                "stage_mask_network_s_est": round(max(stream_s - win_s, 0.0),
                                                  4),
                "wire_mb": round(sum(c[mode + "_wire_bytes"]
                                     for c in chunks) / 1e6, 1),
                "extract_s": round(sum(c["extract_s"][mode]
                                       for c in chunks), 3),
                "sites_per_s": round(n_cands / dt, 1),
                "events_per_s": round(n_events / dt, 1)}

    result = time_mode("packed")
    result["note"] = ("fused pass (tilelet kernel + side channel + mask + "
                      "gather + network + prescreen) over packed reads "
                      "staged on the device; excludes host extraction and "
                      "the host-to-device copy")
    if ablation:
        result["events_wire_ablation"] = time_mode("events")
    return result


def bench_phased(fasta_path, bam_path, cfg, call_cfg, device, sizes):
    """Phase + haplotag the main dataset from its own host-route calls,
    then the 30-channel re-call on the host and fused routes."""
    from clair3_rna_torch.models.network import make_wire_forward_fn
    from clair3_rna_torch.models.params_io import (load_params,
                                                   params_from_numpy)
    from clair3_rna_torch.phasing.pipeline import phase_and_haplotag

    ph_params = params_from_numpy(load_params(WEIGHTS_PHASED), device=device)
    phased_cfg = cfg.with_(phased=True)
    _, ph_forward = make_wire_forward_fn()
    warm_network(ph_params, ph_forward, phased_cfg, sizes["warm_batches"])
    n_runs = sizes["runs"]["phased"]
    chunk = sizes["chunk_size"]

    tagged = bam_path + ".bench_tagged.bam"
    t0 = time.perf_counter()
    phase_and_haplotag(bam_path, fasta_path, bam_path + ".bench_out.vcf",
                       tagged, phaser="builtin")
    out = {"phase_haplotag_s": round(time.perf_counter() - t0, 2)}
    out["host"] = timed_runs(tagged, fasta_path, phased_cfg, call_cfg,
                             ph_params, ph_forward, n_runs=n_runs,
                             chunk_size=chunk)
    host_vcf = _vcf_body(tagged + ".bench_out.vcf")
    out["fused"] = timed_runs(tagged, fasta_path, phased_cfg, call_cfg,
                              ph_params, ph_forward, n_runs=n_runs,
                              chunk_size=chunk, backend="fused")
    fused_vcf = _vcf_body(tagged + ".bench_out.vcf")
    out["fused"]["fused_vcf_identical"] = fused_vcf == host_vcf
    if fused_vcf != host_vcf:
        raise RuntimeError(
            f"phased fused VCF differs from phased host VCF: "
            f"{len(fused_vcf)} vs {len(host_vcf)} rows")
    fc = out["fused"].get("fused_counters", {})
    if fc.get("fallback_chunks"):
        raise RuntimeError(f"phased fused run fell back to host: {fc}")
    out["n_rows"] = len(host_vcf)
    return out


def bench_ours(data, params, device, sizes):
    """Every configuration, in bench.py's order, with its gates."""
    from clair3_rna_torch.caller.backend import probe_link_bandwidth
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.models.network import make_wire_forward_fn

    cfg = PileupConfig(batch_size=2048)
    call_cfg = CallConfig(show_ref=False)
    _, forward = make_wire_forward_fn()
    warm_network(params, forward, cfg, sizes["warm_batches"])
    runs, chunk = sizes["runs"], sizes["chunk_size"]

    def timed(key, n_runs, backend="host", **kw):
        fasta, bam = data[key]
        return timed_runs(bam, fasta, cfg, call_cfg, params, forward,
                          n_runs=n_runs, chunk_size=chunk, backend=backend,
                          **kw)

    fasta_path, bam_path = data["main"]
    result = timed("main", runs["main"])
    result["link_h2d_mbps"] = round(probe_link_bandwidth(device) / 1e6, 1)
    result["high_depth"] = timed("high_depth", runs["high_depth"])
    result["sustained_5mb"] = timed("sustained", runs["sustained"],
                                    include_open=True)
    host_vcf = _vcf_body(bam_path + ".bench_out.vcf")
    hd_bam = data["high_depth"][1]
    hd_host_vcf = _vcf_body(hd_bam + ".bench_out.vcf")

    if runs["fused_warm"]:
        timed("main", runs["fused_warm"], "fused")  # first fused passes
    result["fused_e2e"] = timed("main", runs["fused"], "fused")
    fused_vcf = _vcf_body(bam_path + ".bench_out.vcf")
    result["fused_e2e"]["fused_vcf_identical"] = fused_vcf == host_vcf
    result["fused_e2e"]["mode"] = "packed"
    if fused_vcf != host_vcf:
        raise RuntimeError(f"fused VCF differs from host VCF: "
                           f"{len(fused_vcf)} vs {len(host_vcf)} rows")
    # renormalisation regime: every chunk runs fused, its flagged
    # candidates ride the folded windows, no whole-chunk fallback and no
    # second windows fetch
    result["fused_high_depth"] = timed("high_depth", runs["fused_high_depth"],
                                       "fused")
    hd_fused_vcf = _vcf_body(hd_bam + ".bench_out.vcf")
    result["fused_high_depth"]["fused_vcf_identical"] = \
        hd_fused_vcf == hd_host_vcf
    if hd_fused_vcf != hd_host_vcf:
        raise RuntimeError(f"fused high-depth VCF differs from host: "
                           f"{len(hd_fused_vcf)} vs {len(hd_host_vcf)} rows")
    hd_counters = result["fused_high_depth"].get("fused_counters", {})
    if not hd_counters.get("renorm_candidates"):
        raise RuntimeError("fused_high_depth did not exercise the renorm "
                           f"path: {hd_counters}")
    if hd_counters.get("fallback_chunks"):
        raise RuntimeError("fused_high_depth fell back to the host path: "
                           f"{hd_counters}")
    if hd_counters.get("renorm_window_fetches"):
        raise RuntimeError("fused_high_depth paid a second windows fetch: "
                           f"{hd_counters}")

    # hybrid on a mixed-depth genome: rows identical to both pure routes;
    # its routing and its ratio to the best pure route are a readout
    mx_bam = data["mixed"][1]
    mixed = {}
    for be_name in ("host", "fused", "hybrid"):
        mixed[be_name] = timed("mixed", runs["mixed_" + be_name], be_name)
        body = _vcf_body(mx_bam + ".bench_out.vcf")
        mixed[be_name]["vcf_rows"] = len(body)
        if be_name == "host":
            mx_host_vcf = body
        elif body != mx_host_vcf:
            raise RuntimeError(f"mixed_depth {be_name} VCF differs from host")
        else:
            mixed[be_name]["vcf_identical"] = True
    routing = mixed["hybrid"].get("routing", {})
    mixed["hybrid"]["routing_mixed"] = bool(routing.get("fused_chunks")
                                            and routing.get("host_chunks"))
    best_pure = max(mixed["host"]["sites_per_s"],
                    mixed["fused"]["sites_per_s"])
    mixed["hybrid"]["vs_best_pure"] = round(
        mixed["hybrid"]["sites_per_s"] / best_pure, 3)
    result["mixed_depth"] = mixed

    result["phased_e2e"] = bench_phased(fasta_path, bam_path, cfg, call_cfg,
                                        device, sizes)
    result["fused_device_only"] = bench_fused_device(
        bam_path, fasta_path, params, cfg, chunk, n_timed=runs["device"])
    prof = profiled_run(bam_path, fasta_path, cfg, call_cfg, params,
                        forward, chunk)
    if prof.get("busy_ms") is not None:
        # the profiled run's wall also holds the profiler's start and the
        # trace export: its device time against the unprofiled wall
        prof["busy_share_of_unprofiled_wall"] = \
            prof["busy_ms"] / 1e3 / result["fused_e2e"]["wall_s"]
    result["profile_fused_e2e"] = prof
    return result


def compact_summary(ours, baseline, device_kind, card):
    """Small per-configuration digest, printed last."""
    def pick(cfg, *keys):
        d = ours.get(cfg) or {}
        out = {k: d[k] for k in keys if k in d}
        if "fused_counters" in d:
            fc = d["fused_counters"]
            for k in ("renorm_candidates", "fallback_chunks",
                      "renorm_window_fetches"):
                out[k] = fc.get(k)
        return out

    def sub(d, cfg, *keys):
        e = d.get(cfg) or {}
        out = {k: e[k] for k in keys if k in e}
        if "fused_counters" in e:
            out["fallback_chunks"] = e["fused_counters"].get(
                "fallback_chunks")
        if "routing" in e:
            out["routing"] = {k: e["routing"].get(k) for k in
                              ("fused_chunks", "host_chunks")}
        return out

    mixed = ours.get("mixed_depth") or {}
    phased = ours.get("phased_e2e") or {}
    prof = ours.get("profile_fused_e2e") or {}
    return {
        "metric": "candidate-sites/s (pileup build + Bi-LSTM + decode), "
                  "PyTorch/CUDA port",
        "value": round(ours["sites_per_s"], 1),
        "unit": "sites/s",
        "device": device_kind, "card": card,
        "headline_median_sites_per_s": ours.get("median_sites_per_s"),
        "reference_chain_cached_sites_per_s": baseline.get("sites_per_s"),
        "configs": {
            "high_depth": pick("high_depth", "sites_per_s"),
            "sustained_5mb": pick("sustained_5mb", "sites_per_s"),
            "fused_e2e": pick("fused_e2e", "sites_per_s",
                              "median_sites_per_s", "fused_vcf_identical"),
            "fused_high_depth": pick("fused_high_depth", "sites_per_s",
                                     "fused_vcf_identical"),
            "mixed_depth": {
                "host": sub(mixed, "host", "sites_per_s"),
                "fused": sub(mixed, "fused", "sites_per_s", "vcf_identical"),
                "hybrid": sub(mixed, "hybrid", "sites_per_s",
                              "vcf_identical", "vs_best_pure",
                              "routing_mixed"),
            },
            "phased_e2e": {
                "phase_haplotag_s": phased.get("phase_haplotag_s"),
                "host": sub(phased, "host", "sites_per_s"),
                "fused": sub(phased, "fused", "sites_per_s",
                             "fused_vcf_identical"),
            },
            "fused_device_only": pick(
                "fused_device_only", "device_s", "events_per_s",
                "device_stream_s", "stream_events_per_s", "sites_per_s",
                "stage_expand_count_gather_s", "stage_mask_network_s_est"),
            "profile_fused_e2e": {k: prof.get(k) for k in
                                  ("busy_share", "window_ms", "busy_ms",
                                   "busy_share_of_unprofiled_wall")},
        },
        "link_h2d_mbps": ours.get("link_h2d_mbps"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="one short contig per dataset, one run each")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--data-dir", default=None,
                    help="dataset and weight cache (default .bench_data/)")
    args = ap.parse_args(argv)

    import torch
    from clair3_rna_torch import resolve_device
    from clair3_rna_torch.models.params_io import params_from_numpy

    global DATA_DIR
    device = resolve_device(args.device)   # raises without a card
    if args.data_dir:
        DATA_DIR = os.path.abspath(args.data_dir)
    sizes = QUICK if args.quick else FULL
    out_path = (os.path.join(DATA_DIR, "torch_bench_quick.json")
                            if args.quick else DETAIL)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line() if device.type == "cuda" else None
    kind = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    if card:
        print(f"[bench_torch] card: {card}", flush=True)

    t0 = time.time()
    setup = {}
    if device.type == "cuda":  # the kernels, before any timed run
        from clair3_rna_torch import csrc
        csrc.build_all()
        setup["kernels_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    os.makedirs(DATA_DIR, exist_ok=True)
    need_weights = not weights_cached(sizes)
    with tempfile.TemporaryDirectory(dir=DATA_DIR) as tdir:
        data = make_datasets(sizes, train_dir=tdir if need_weights else None)
        setup["datasets_s"] = round(time.time() - t0, 1)
        t1 = time.time()
        tree = get_trained_params(sizes, device, data.pop("train", None))
        setup["weights_s"] = round(time.time() - t1, 1)
    params = params_from_numpy(tree, device=device)
    ours = bench_ours(data, params, device, sizes)

    baseline = {"sites_per_s": None}
    if os.path.exists(CACHE):
        with open(CACHE) as f:
            baseline = json.load(f)
    baseline["note"] = ("the reference chain (generate_tensor + TF "
                        "predict_on_batch + decode) measured on an earlier "
                        "host's CPU by bench.py and cached there; not "
                        "measured on this device")
    result = {
        "metric": "candidate-sites/s (pileup build + Bi-LSTM + decode), "
                  "PyTorch/CUDA port",
        "value": round(ours["sites_per_s"], 1), "unit": "sites/s",
        "device": {"type": device.type, "kind": kind, "card": card,
                   "count": torch.cuda.device_count()
                   if device.type == "cuda" else 0},
        "quick": bool(args.quick),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "setup": setup,
        "detail": {"ours": ours, "reference_chain_cached": baseline},
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    if card:
        print(f"[bench_torch] card: {card_line()}", flush=True)
    summary = compact_summary(ours, baseline, kind, card)
    summary["detail_file"] = os.path.relpath(out_path, REPO)
    print(json.dumps(summary))
    return result


if __name__ == "__main__":
    main()
