#!/usr/bin/env python3
"""Chip smoke test for the PyTorch/CUDA port (clair3_rna_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failed check raises; the exit code is then non-zero):

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel from clair3_rna_torch/csrc (one nvcc per source,
   started together);
3. kernels: the tilelet expansion kernel, v2 wire (K1) and nibble wire
   (K2), unphased and phased, against its plain PyTorch version on the card
   -- rows of a real staged 100 kb chunk, a deep chunk, and random rows
   with rank ties, empty tiles and pad rows; counts and ranks must be
   bit-identical. The kernel alone (launches replayed from a CUDA graph),
   its wrapper and the plain version are timed with CUDA events at the
   main path's shape;
4. network: full-width PileupNet on the card and on the CPU with the same
   seeded weights over real candidate windows; probabilities within 1e-4,
   and rows bit-identical across the pipeline's batch buckets on the card;
   logged beside it, how far rows move without the fixed slab and what one
   pass costs at each slab size;
5. end to end: `call` through the CLI entry point on a simulated dataset,
   host route, fused route (v2 wire) and fused route (nibble wire); the
   three VCF bodies must be identical and each fused run must launch its
   kernel.

Prints one {"kernels": [...]} line and, last, the
{"ok": true, "device": {...}} line. Exits non-zero without CUDA, and when
run outside a checkout of the repository.
"""

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
H100_HBM_BPS = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
H100_FP32_OPS = 67e12      # non-tensor float32 rate, used for int ops too
NET_TOL = 1e-4
CHUNK = 100_000
SEED = 20261016
DEVICE = "cuda"


def fail(msg):
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def sync():
    import torch
    torch.cuda.synchronize()


def cuda_time(fn, iters=20, warmup=3):
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_only_ms(wire, t, want, iters=20, reps=5):
    """Device milliseconds of the tilelet kernel alone: `iters` launches
    with precomputed row offsets and preallocated outputs, captured in one
    CUDA graph, so the wrapper's searchsorted, allocations and Python
    enqueue are left out. The last replay's outputs must equal `want` (the
    plain version's). Launches made here bypass the wrapper's count."""
    import torch

    from clair3_rna_torch.csrc import launch_tilelet
    from clair3_rna_torch.ops import tilelet as tlt

    dev = t["codes"].device
    n_tiles = t["width"] // tlt.POS_TILE
    row_off = torch.searchsorted(
        t["tile"], torch.arange(n_tiles + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    counts = torch.empty((tlt.C_PAD, t["width"]), dtype=torch.float32,
                         device=dev)
    grank = torch.empty((tlt.G_PAD, t["width"]), dtype=torch.float32,
                        device=dev)

    def launch():
        launch_tilelet(wire, False, t["codes"], t["valid"], row_off,
                       t["rank"], t["strand"], t["hp"], n_tiles, t["width"],
                       counts, grank)

    launch()
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            launch()
    graph.replay()
    sync()
    ms = cuda_time(graph.replay, iters=reps, warmup=1) / iters
    if not (torch.equal(counts, want[0]) and torch.equal(grank, want[1])):
        fail(f"tilelet {wire}: graph-launched kernel != plain")
    return ms


def make_dataset(work):
    """Two contigs at depth 35 (300 kb with a splice region, 200 kb) and a
    20 kb contig at ~325x so renormalization flags fire (1.5 * MAX_DEPTH =
    216 for the default platform)."""
    import random

    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.fasta import write_fasta

    rng = random.Random(SEED)
    genome = simdata.random_genome(
        rng, [("chr1", 300_000), ("chr2", 200_000), ("chr3", 20_000)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=300)
    fasta = os.path.join(work, "ref.fa")
    bam = os.path.join(work, "reads.bam")
    write_fasta(fasta, genome)
    simdata.simulate_bam(bam, genome, variants, rng, depth=35,
                         splice_sites={"chr1": [(150_000, 151_200)]},
                         extra_regions={"chr3": [(0, 20_000, 290)]})
    return fasta, bam


def staged_chunk(bam_path, fasta_path, ctg, start, end, wire):
    """Stage one chunk the way the fused route does."""
    from clair3_rna_torch import config
    from clair3_rna_torch.io.fasta import FastaFile
    from clair3_rna_torch.ops.fused_pileup import stage_chunk_packed
    from clair3_rna_torch.pileup.chunk import open_bam, ref_codes_from
    from clair3_rna_torch.pileup.packed import extract_region_packed

    cfg = config.PileupConfig()
    fasta = FastaFile(fasta_path)
    bam = open_bam(bam_path)
    lo = max(0, start - config.NO_OF_POSITIONS)
    hi = min(fasta.contig_length(ctg), end + config.NO_OF_POSITIONS)
    codes = ref_codes_from(fasta.fetch(ctg, lo, hi))
    data = extract_region_packed(bam, ctg, lo, hi, cfg)
    return stage_chunk_packed(data, codes, cfg, start, end, wire=wire)


def random_rows(rng, n_tiles=64, n_rows=3000):
    """Tile-sorted random nibble rows: rank ties, holes, empty tiles, hp
    tags and pad rows (tile == n_tiles)."""
    import numpy as np

    from clair3_rna_torch.ops import tilelet as tlt

    live = np.sort(rng.choice(n_tiles, size=n_tiles * 3 // 4, replace=False))
    tiles = np.sort(rng.choice(live, size=n_rows)).astype(np.int32)
    nib = rng.integers(0, 4, size=(n_rows, tlt.POS_TILE))
    nib[rng.random((n_rows, tlt.POS_TILE)) < 0.3] = tlt.EMPTY
    codes = ((nib[:, 0::2] << 4) | nib[:, 1::2]).astype(np.uint8)
    r_pad = tlt.quantize_rows(n_rows + 5)

    def pad(a, fill):
        return np.concatenate(
            [a, np.full((r_pad - n_rows,) + a.shape[1:], fill, a.dtype)])

    return {
        "codes": pad(codes, np.uint8(0xFF)),
        "tile": pad(tiles, np.int32(n_tiles)),
        "rank": pad(rng.integers(0, 40, n_rows).astype(np.int32),
                    np.int32(tlt.MAX_RANK)),
        "strand": pad(rng.integers(0, 2, n_rows).astype(np.int8),
                      np.int8(0)),
        "hp": pad(rng.integers(0, 3, n_rows).astype(np.int8), np.int8(0)),
        "width": n_tiles * tlt.POS_TILE,
    }


def kernel_phase(work, fasta, bam):
    import numpy as np
    import torch

    from clair3_rna_torch.ops import tilelet as tlt

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    cases = {}
    for wire in ("v2", "nibble"):
        for name, (ctg, lo, hi) in (("chunk", ("chr1", 0, CHUNK)),
                                    ("deep", ("chr3", 0, 20_000))):
            st = staged_chunk(bam, fasta, ctg, lo, hi, wire)
            cases[(wire, name)] = {
                "codes": st.tl_codes, "valid": st.tl_valid,
                "tile": st.tl_tile, "rank": st.tl_rank,
                "strand": st.tl_strand,
                # the simulated reads carry no HP tag: random hp values
                # exercise the phased channels
                "hp": rng.integers(0, 3, len(st.tl_tile)).astype(np.int8),
                "width": st.width}
        rr = random_rows(rng)
        if wire == "v2":
            rr["codes"], rr["valid"] = tlt.nibble_to_v2(rr["codes"])
        else:
            rr["valid"] = None
        cases[(wire, "random")] = rr

    def to_dev(c):
        return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    if isinstance(v, np.ndarray) else v)
                for k, v in c.items()}

    def run(wire, t, phased):
        if wire == "v2":
            return tlt.tilelet_expand_v2(
                t["codes"], t["valid"], t["tile"], t["rank"], t["strand"],
                t["width"], tl_hp=t["hp"], phased=phased)
        return tlt.tilelet_expand(t["codes"], t["tile"], t["rank"],
                                  t["strand"], t["width"], tl_hp=t["hp"],
                                  phased=phased)

    def plain(wire, t, phased):
        return tlt.tilelet_expand_plain(
            t["codes"], t["valid"], t["tile"], t["rank"], t["strand"],
            t["hp"], t["width"], phased=phased, wire=wire)

    results = {}
    max_err = {}
    for (wire, name), c in cases.items():
        t = to_dev(c)
        for phased in (False, True):
            counts, grank = run(wire, t, phased)
            pc, pg = plain(wire, t, phased)
            sync()
            err = max(float((counts - pc).abs().max()),
                      float((grank - pg).abs().max()))
            max_err[wire] = max(max_err.get(wire, 0.0), err)
            if not (torch.equal(counts, pc) and torch.equal(grank, pg)):
                fail(f"tilelet {wire} {name} phased={phased}: kernel != "
                     f"plain (max abs err {err})")
            log(f"tilelet {wire:6s} {name:6s} phased={phased!s:5s}: "
                f"bit-identical to plain ({len(c['tile'])} rows, "
                f"W={c['width']}, {int(counts.sum())} counts)")
        if name == "chunk":
            wrapper_ms = cuda_time(lambda: run(wire, t, False))
            ms = kernel_only_ms(wire, t, plain(wire, t, False))
            plain_ms = cuda_time(lambda: plain(wire, t, False), iters=5)
            in_bytes = sum(v.nbytes for v in c.values()
                           if isinstance(v, np.ndarray))
            out_bytes = (tlt.C_PAD + tlt.G_PAD) * c["width"] * 4
            n_rows = int((c["tile"] < c["width"] // tlt.POS_TILE).sum())
            bytes_ms = (in_bytes + out_bytes) / H100_HBM_BPS * 1e3
            ops_ms = n_rows * tlt.POS_TILE * 4 / H100_FP32_OPS * 1e3
            results[wire] = {
                "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "rows": n_rows, "bytes": in_bytes + out_bytes}
            log(f"tilelet {wire} at the main path's shape ({n_rows} rows, "
                f"W={c['width']}): kernel alone {ms:.4f} ms, wrapper "
                f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{results[wire]['bound_ms']:.4f} ms "
                f"({in_bytes + out_bytes} B at 3.35 TB/s)")
    for wire in results:
        results[wire]["max_abs_err"] = max_err[wire]
    log(f"kernel phase launches (checks and timing, not the main path): "
        f"{dict(tlt.launches)}")
    return results


def network_phase(fasta, bam):
    import numpy as np
    import torch

    from clair3_rna_torch import config
    from clair3_rna_torch.caller.pipeline import batch_wire
    from clair3_rna_torch.io.fasta import FastaFile
    from clair3_rna_torch.models.network import (init_params,
                                                 make_wire_forward_fn)
    from clair3_rna_torch.pileup.chunk import (ChunkTask, build_chunk_tensors,
                                               open_bam)

    cfg = config.PileupConfig()
    records = build_chunk_tensors(open_bam(bam), FastaFile(fasta),
                                  ChunkTask("chr1", 0, CHUNK), cfg)
    wire, codes = batch_wire(records[:96], cfg)
    _, forward = make_wire_forward_fn()
    net_gpu = init_params(SEED, device=DEVICE)
    net_cpu = init_params(SEED, device="cpu")
    t0 = time.time()
    gpu = forward(net_gpu, wire, codes).cpu().numpy()
    cpu = forward(net_cpu, wire, codes).numpy()
    diff = float(np.abs(gpu - cpu).max())
    log(f"network: {len(wire)} real windows, card vs CPU max abs prob "
        f"diff {diff:.3e} (tolerance {NET_TOL}) [{time.time() - t0:.2f} s]")
    if not diff <= NET_TOL:
        fail(f"network card vs CPU differ by {diff}")
    for bucket in (128, 1024, 2048, 4096, 8192):
        pad = np.zeros((bucket - len(wire),) + wire.shape[1:], wire.dtype)
        cpad = np.zeros((bucket - len(codes), codes.shape[1]), codes.dtype)
        out = forward(net_gpu, np.concatenate([wire, pad]),
                      np.concatenate([codes, cpad])).cpu().numpy()
        if not np.array_equal(out[:len(wire)], gpu):
            fail(f"network rows differ at batch bucket {bucket}: "
                 f"{np.abs(out[:len(wire)] - gpu).max()}")
    log("network: rows bit-identical across batch buckets "
        "96/128/1024/2048/4096/8192")
    slab_evidence(net_gpu, forward, wire, codes)
    return diff


def slab_evidence(net, forward, wire, codes):
    """What the fixed network slab (models/network.NET_SLAB) answers and
    costs on this card. Logs (checks nothing): whether the same rows differ
    when the whole batch runs as one unslabbed pass at each of the main
    path's batch sizes, and the milliseconds of one unslabbed pass at each
    candidate slab size."""
    import numpy as np
    import torch

    from clair3_rna_torch.models import network as tnet

    saved = dict(tnet.NET_SLAB)
    n = len(wire)
    try:
        outs = {}
        for bucket in (n, 128, 299, 1024, 2048, 4096, 8192):
            tnet.NET_SLAB["cuda"] = bucket
            pad = np.zeros((bucket - n,) + wire.shape[1:], wire.dtype)
            cpad = np.zeros((bucket - n, codes.shape[1]), codes.dtype)
            outs[bucket] = forward(net, np.concatenate([wire, pad]),
                                   np.concatenate([codes, cpad]))[:n]
        base = outs[n]
        diffs = {b: float((o - base).abs().max()) for b, o in outs.items()}
        log(f"network without slabs: max abs prob diff of the same {n} rows "
            f"in one pass of each batch size vs {n} rows: {diffs}")
        x = torch.zeros((8192, 33, wire.shape[2]), device=net.device)
        times = {}
        with torch.inference_mode():
            for slab in (64, 128, 256, 512, 1024, 2048, 4096, 8192):
                times[slab] = cuda_time(lambda: net._slab(x[:slab]), iters=5,
                                        warmup=1)
        log("network: ms of one pass at each slab size "
            + json.dumps({s: round(ms, 4) for s, ms in times.items()}))
    finally:
        tnet.NET_SLAB.clear()
        tnet.NET_SLAB.update(saved)


def e2e_phase(work, fasta, bam):
    from clair3_rna_torch.cli import main as cli_main
    from clair3_rna_torch.models.network import init_params
    from clair3_rna_torch.models.params_io import save_params
    from clair3_rna_torch.ops import tilelet as tlt

    weights = save_params(os.path.join(work, "weights.npz"),
                          init_params(SEED, device=DEVICE))
    runs = {}
    # each route once cold (first run in the process), then host and
    # fused v2 again warm
    for name, backend, wire in (("host", "host", "v2"),
                                ("fused_v2", "fused", "v2"),
                                ("fused_nibble", "fused", "nibble"),
                                ("host_warm", "host", "v2"),
                                ("fused_v2_warm", "fused", "v2")):
        out = os.path.join(work, f"out_{name}")
        os.environ["CLAIR3_RNA_TORCH_TILELET_WIRE"] = wire
        sync()
        tlt.reset_launches()
        t0 = time.time()
        outputs, stats = cli_main([
            "call", "-B", bam, "-R", fasta, "-o", out,
            "--model_path", weights, "--device", DEVICE,
            "--pileup_backend", backend, "--chunk_size", str(CHUNK),
            "--no_compress", "--include_all_ctgs"])
        sync()
        wall = time.time() - t0
        launches = dict(tlt.launches)
        with open(outputs[0]) as f:
            body = [line for line in f if not line.startswith("#")]
        runs[name] = {"wall_s": wall, "candidates": stats.candidates,
                      "rows": len(body), "body": body,
                      "sites_per_s": stats.candidates / wall,
                      "launches": launches, "fused": stats.fused,
                      # thread-summed stage seconds (CallStats): build
                      # overlaps across the two prefetch threads
                      "build_s": stats.build_s, "infer_s": stats.infer_s,
                      "decode_s": stats.decode_s}
        log(f"e2e {name}: {wall:.2f} s wall, {stats.candidates} candidate "
            f"sites ({stats.candidates / wall:.1f} sites/s), {len(body)} "
            f"VCF rows, kernel launches {launches}, fused counters "
            f"{stats.fused}")
    os.environ.pop("CLAIR3_RNA_TORCH_TILELET_WIRE", None)
    for name in runs:
        if runs[name]["body"] != runs["host"]["body"]:
            diff = [(a, b) for a, b in zip(runs["host"]["body"],
                                           runs[name]["body"]) if a != b]
            fail(f"{name} VCF body differs from the host route: "
                 f"{len(runs[name]['body'])} vs {len(runs['host']['body'])} "
                 f"rows, first differences {diff[:3]}")
    if not runs["host"]["body"]:
        fail("no VCF rows")
    for name in ("fused_v2", "fused_v2_warm"):
        if runs[name]["launches"]["tilelet_expand_v2"] <= 0:
            fail(f"{name} launched no tilelet_expand_v2 kernel")
    if runs["fused_nibble"]["launches"]["tilelet_expand"] <= 0:
        fail("fused nibble run launched no tilelet_expand kernel")
    for name in ("host", "host_warm"):
        if any(runs[name]["launches"].values()):
            fail(f"{name} launched tilelet kernels: "
                 f"{runs[name]['launches']}")
    for name in ("fused_v2", "fused_nibble", "fused_v2_warm"):
        if runs[name]["fused"]["renorm_candidates"] <= 0:
            fail(f"{name}: the deep contig flagged no renorm candidate")
    log(f"e2e: host, fused v2 and fused nibble VCF bodies identical "
        f"({len(runs['host']['body'])} rows)")
    return runs


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    if not os.path.isdir(os.path.join(HERE, "clair3_rna_torch", "csrc")):
        fail(f"no clair3_rna_torch package beside {__file__}: run from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from clair3_rna_torch import csrc
    from clair3_rna_torch.native import get_library

    t0 = time.time()
    report = csrc.build_all(force=True)
    for src, (secs, ptxas) in report.items():
        log(f"built {src} in {secs:.1f} s (nvcc sm_90a)")
        for line in ptxas.strip().splitlines():
            log(f"  {line.strip()}")
    if get_library() is None:
        fail("native pileup library did not build")
    log(f"kernels + native library built in {time.time() - t0:.1f} s")

    work = os.path.join(HERE, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        t0 = time.time()
        fasta, bam = make_dataset(work)
        log(f"dataset simulated in {time.time() - t0:.1f} s")
        kern = kernel_phase(work, fasta, bam)
        network_phase(fasta, bam)
        runs = e2e_phase(work, fasta, bam)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for wire, name, fn, line in (
            ("v2", "tilelet_expand_v2 (K1)", "tilelet_expand_v2",
             "clair3_rna_tpu/ops/tilelet.py:283"),
            ("nibble", "tilelet_expand (K2)", "tilelet_expand",
             "clair3_rna_tpu/ops/tilelet.py:190")):
        k = kern[wire]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "clair3_rna_torch/csrc/tilelet.cu", "replaces": line,
            "launches": runs["fused_" + wire]["launches"][fn],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "wrapper_ms": k["wrapper_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None})
    summary = {name: {k: r[k] for k in ("wall_s", "candidates", "rows",
                                         "sites_per_s", "build_s", "infer_s",
                                         "decode_s", "fused")}
               for name, r in runs.items()}
    log("e2e summary " + json.dumps(summary))
    print(f"[chip_smoke] card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
