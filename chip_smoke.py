#!/usr/bin/env python3
"""Chip smoke test for the PyTorch/CUDA port (clair3_rna_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failed check raises; the exit code is then non-zero):

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel from clair3_rna_torch/csrc (one nvcc per source,
   started together);
3. kernels: the tilelet expansion kernel, v2 wire (K1) and nibble wire
   (K2), unphased and phased, against its plain PyTorch version on the card
   -- rows of a real staged 100 kb chunk, a deep chunk, a chunk of
   50-row tiles with one 5,000-row tile, and random rows with rank ties,
   empty tiles and pad rows; counts and ranks must be bit-identical,
   through the wrapper as the fused route calls it (row offsets and the
   deepest tile's rows from the staging), with the offsets only, and
   without them. The kernel alone (launches replayed from a CUDA graph)
   warm, with the L2 cold, on the deep chunk, on the one-deep-tile chunk
   and phased; its wrapper as the fused route calls it and without the
   offsets; the plain version; and a library yardstick (torch.bincount +
   torch.scatter_reduce "amin" over slot keys decoded beforehand) are
   timed with CUDA events; one wrapper call as the fused route makes it
   must enqueue exactly one kernel. Then the event scatter kernel (K3) on the events of
   the same chunk in the events wire's staging order and shuffled, the
   deep chunk (likewise), and random events in random order with rank
   ties, duplicates, empty stretches, stars, pads, negative positions and
   bad channels, and random events over 2^23 positions (several of the
   kernel's bucketing ranges); and the channel-count kernel (K4) on that
   chunk's pure-array builder calls (18-channel base+star, ins/del,
   4-group; the first also shuffled), a random 30-channel case and a
   random case over 8 M positions. Both bit-identical to
   their plain versions and the same in any event order, timed the same
   way (warm, and with the L2 cold: the graph rotates over copies of the
   inputs and outputs that together exceed it), beside one library call of
   the same function (K3: torch.bincount + torch.scatter_reduce "amin",
   two calls; K4: torch.bincount) and, for K4, the builder's whole call on
   the host clock;
4. network: full-width PileupNet on the card and on the CPU with the same
   seeded weights over real candidate windows; probabilities within 1e-4,
   and rows bit-identical across the pipeline's batch buckets on the card;
   logged beside it, how far rows move without the fixed slab and what one
   pass costs at each slab size;
5. end to end: `call` through the CLI entry point on a simulated dataset:
   host route, fused route (v2 wire, nibble wire), then the fused route on
   the events wire (CLAIR3_RNA_TORCH_FUSED_MODE=events, K3) and the host
   route on the pure-array builder with its counts on the card
   (CLAIR3_RNA_TORCH_NO_NATIVE=1, CLAIR3_RNA_TORCH_PILEUP_BACKEND=kernel,
   K4). Every VCF body must equal the host route's, each kernel must
   launch on its own path and on no other. The events wire's host staging
   and host-to-card copies are logged per chunk.

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
H100_L2_BYTES = 50_000_000  # L2 cache (NVIDIA data sheet)
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


def graph_ms(launch, iters=20, reps=5):
    """Device milliseconds of one `launch()` alone: `iters` launches
    captured in one CUDA graph and replayed, so allocations and Python
    enqueue are left out. With the same inputs every time, whatever of
    them fits in L2 stays there (warm)."""
    return rotated_graph_ms([launch], iters, reps)


def rotated_graph_ms(launches, iters=20, reps=5):
    """Device milliseconds per launch of `iters` launches that cycle over
    `launches` (each on its own copy of inputs and outputs), captured in
    one CUDA graph and replayed."""
    import torch

    for launch in launches:
        launch()
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            launches[i % len(launches)]()
    graph.replay()
    sync()
    return cuda_time(graph.replay, iters=reps, warmup=1) / iters


def kernel_breakdown(launch, reps=5):
    """{kernel or memset name: device ms per launch()} over `reps` launches,
    from torch.profiler's CUDA activity (logged, checks nothing)."""
    from torch.profiler import ProfilerActivity, profile

    launch()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        sync()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us > 0:
            out[e.key[:48]] = round(us / reps / 1e3, 5)
    return out


def l2_copies(n_bytes):
    """Copies of a launch's inputs and outputs to rotate over so that the
    others' bytes between two launches of one copy exceed the L2 twice:
    each launch then finds its inputs and outputs cold."""
    return 1 + max(1, -(-2 * H100_L2_BYTES // n_bytes))


def tilelet_launcher(wire, t, phased):
    """(launch(), counts, grank): one launch of csrc/tilelet.cu straight
    through its ctypes entry point on `t`'s rows, with the row offsets and
    the deepest tile's rows as the staging ships them and outputs
    preallocated, so no wrapper work is left in it. Such launches bypass
    the wrappers' count."""
    import torch

    from clair3_rna_torch.csrc import launch_tilelet
    from clair3_rna_torch.ops import tilelet as tlt

    dev = t["codes"].device
    row_off = t["row_off"]
    counts = torch.empty((tlt.C_PAD, t["width"]), dtype=torch.float32,
                         device=dev)
    grank = torch.empty((tlt.G_PAD, t["width"]), dtype=torch.float32,
                        device=dev)
    n_tiles = t["width"] // tlt.POS_TILE

    def go():
        launch_tilelet(wire, phased, t["codes"], t["valid"], row_off,
                       t["rank"], t["strand"], t["hp"], n_tiles, t["width"],
                       counts, grank, max_rows=t["max_rows"])

    return go, counts, grank


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


def padded_rows(nib, tiles, rank, rng, n_tiles):
    """Nibble codes [R, POS_TILE] with tiles, ranks and random strand and
    hp -> the staged arrays, padded as the staging pads (pad rows at tile
    n_tiles, no valid slot)."""
    import numpy as np

    from clair3_rna_torch.ops import tilelet as tlt

    n_rows = len(tiles)
    codes = ((nib[:, 0::2] << 4) | nib[:, 1::2]).astype(np.uint8)
    r_pad = tlt.quantize_rows(n_rows + 5)

    def pad(a, fill):
        return np.concatenate(
            [a, np.full((r_pad - n_rows,) + a.shape[1:], fill, a.dtype)])

    return {
        "codes": pad(codes, np.uint8(0xFF)),
        "tile": pad(tiles.astype(np.int32), np.int32(n_tiles)),
        "rank": pad(rank.astype(np.int32), np.int32(tlt.MAX_RANK)),
        "strand": pad(rng.integers(0, 2, n_rows).astype(np.int8),
                      np.int8(0)),
        "hp": pad(rng.integers(0, 3, n_rows).astype(np.int8), np.int8(0)),
        "width": n_tiles * tlt.POS_TILE,
    }


def random_rows(rng, n_tiles=64, n_rows=3000):
    """Tile-sorted random nibble rows: rank ties, holes, empty tiles, hp
    tags and pad rows (tile == n_tiles)."""
    import numpy as np

    from clair3_rna_torch.ops import tilelet as tlt

    live = np.sort(rng.choice(n_tiles, size=n_tiles * 3 // 4, replace=False))
    tiles = np.sort(rng.choice(live, size=n_rows))
    nib = rng.integers(0, 4, size=(n_rows, tlt.POS_TILE))
    nib[rng.random((n_rows, tlt.POS_TILE)) < 0.3] = tlt.EMPTY
    return padded_rows(nib, tiles, rng.integers(0, 40, n_rows), rng,
                       n_tiles)


def one_deep_tile(rng, n_tiles=512, rows=50, deep_rows=5000, deep_tile=300):
    """A chunk as wide as the main path's (W = 131,072) of 50-row tiles
    with one 5,000-row tile, as one gene at thousands-fold depth among
    shallow ones; ranks ascend within each tile, as the staging emits
    them."""
    import numpy as np

    from clair3_rna_torch.ops import tilelet as tlt

    per_tile = np.full(n_tiles, rows)
    per_tile[deep_tile] = deep_rows
    tiles = np.repeat(np.arange(n_tiles), per_tile)
    nib = rng.integers(0, 4, size=(len(tiles), tlt.POS_TILE))
    nib[rng.random(nib.shape) < 0.3] = tlt.EMPTY
    return padded_rows(nib, tiles, np.arange(len(tiles)), rng, n_tiles)


def tilelet_library(wire, t):
    """The library yardstick for K1/K2: one torch.bincount over (position x
    32 + channel) keys and one torch.scatter_reduce "amin" over (position x
    8 + base) keys of the chunk's slots, decoded into those flat keys
    beforehand (the decode is left out, in the library's favour). Returns
    (library(), check) where check(want) holds its result to the plain
    version's."""
    import torch

    from clair3_rna_torch.ops import tilelet as tlt

    dev = t["codes"].device
    width = t["width"]
    code = tlt._decode(t["codes"], t["valid"], wire)           # [R, 256]
    pos = (t["tile"].long()[:, None] * tlt.POS_TILE
           + torch.arange(tlt.POS_TILE, device=dev)[None, :])
    live = (code < 4) & (pos < width)
    pos, code = pos[live], code[live]
    row = torch.nonzero(live)[:, 0]
    ckey = pos * tlt.C_PAD + code + 9 * t["strand"].long()[row]
    rkey = pos * tlt.G_PAD + code
    rank = t["rank"][row]
    rinit = torch.full((width * tlt.G_PAD,), int(tlt.RANK_INF_F),
                       dtype=torch.int32, device=dev)

    def library():
        return (torch.bincount(ckey, minlength=width * tlt.C_PAD),
                torch.scatter_reduce(rinit, 0, rkey, rank, "amin"))

    def check(want):
        lc, lr = library()
        if not (torch.equal(lc.reshape(width, tlt.C_PAD).T.float(), want[0])
                and torch.equal(lr.reshape(width, tlt.G_PAD).T.float(),
                                want[1])):
            fail(f"tilelet {wire}: the library yardstick computes another "
                 "function")

    return library, check


def kernel_phase(fasta, bam):
    """The tilelet kernel (K1 v2 wire, K2 nibble wire) against its plain
    version on every case, bit-identical, through the wrapper with and
    without staged row offsets; timings at the main path's shape (the
    first chr1 chunk), on the deep chunk and on one deep tile among
    shallow ones."""
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
                "row_off": st.tl_row_off, "max_rows": st.tl_max_rows,
                "width": st.width}
        for name, make in (("one_deep", one_deep_tile),
                           ("random", random_rows)):
            rr = make(rng)
            if wire == "v2":
                rr["codes"], rr["valid"] = tlt.nibble_to_v2(rr["codes"])
            else:
                rr["valid"] = None
            rr["row_off"] = np.searchsorted(
                rr["tile"], np.arange(rr["width"] // tlt.POS_TILE + 1)
            ).astype(np.int32)
            rr["max_rows"] = int(np.diff(rr["row_off"]).max())
            cases[(wire, name)] = rr

    def to_dev(c):
        return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    if isinstance(v, np.ndarray) else v)
                for k, v in c.items()}

    def run(wire, t, phased, offsets="staged"):
        """A wrapper call: "staged" as the fused route makes it (row offsets
        and the deepest tile's rows), "offsets" through the public function
        with the offsets, "none" without them."""
        if offsets == "staged":
            return tlt.expand(wire, t["codes"], t["valid"], t["tile"],
                              t["rank"], t["strand"], t["width"],
                              tl_hp=t["hp"], phased=phased,
                              tl_row_off=t["row_off"],
                              max_rows=t["max_rows"])
        row_off = t["row_off"] if offsets == "offsets" else None
        if wire == "v2":
            return tlt.tilelet_expand_v2(
                t["codes"], t["valid"], t["tile"], t["rank"], t["strand"],
                t["width"], tl_hp=t["hp"], phased=phased,
                tl_row_off=row_off)
        return tlt.tilelet_expand(t["codes"], t["tile"], t["rank"],
                                  t["strand"], t["width"], tl_hp=t["hp"],
                                  phased=phased, tl_row_off=row_off)

    def plain(wire, t, phased):
        return tlt.tilelet_expand_plain(
            t["codes"], t["valid"], t["tile"], t["rank"], t["strand"],
            t["hp"], t["width"], phased=phased, wire=wire)

    def case_bytes(c, phased=False):
        """What one launch must move: each of the tiles' rows read once
        (codes, validity, rank, strand, and hp when phased; the pad rows
        past row_off[-1] are never read), the tile offsets, and 40 f32 a
        position written."""
        row = (c["codes"].shape[1] + 4 + 1 + (1 if phased else 0)
               + (c["valid"].shape[1] if c["valid"] is not None else 0))
        return (int(c["row_off"][-1]) * row + c["row_off"].nbytes
                + (tlt.C_PAD + tlt.G_PAD) * c["width"] * 4)

    def case_bound(c, phased=False):
        n_rows = int(c["row_off"][-1])
        return bound(case_bytes(c, phased), n_rows * tlt.POS_TILE * 4), n_rows

    def alone(wire, t, phased, want):
        go, oc, og = tilelet_launcher(wire, t, phased)
        ms = graph_ms(go)
        if not (torch.equal(oc, want[0]) and torch.equal(og, want[1])):
            fail(f"tilelet {wire}: graph-launched kernel != plain")
        return ms

    def cold(wire, c, t, want):
        copies = [tilelet_launcher(
            wire, {k: (v.clone() if torch.is_tensor(v) else v)
                   for k, v in t.items()}, False)
            for _ in range(l2_copies(case_bytes(c)))]
        ms = rotated_graph_ms([g for g, _, _ in copies],
                              iters=4 * len(copies))
        for _, oc, og in copies:
            if not (torch.equal(oc, want[0]) and torch.equal(og, want[1])):
                fail(f"tilelet {wire}: cold graph-launched kernel != plain")
        return ms, len(copies)

    results = {}
    max_err = {}
    devs = {}
    for (wire, name), c in cases.items():
        t = devs[(wire, name)] = to_dev(c)
        for phased in (False, True):
            pc, pg = plain(wire, t, phased)
            for offsets in ("staged", "offsets", "none"):
                counts, grank = run(wire, t, phased, offsets)
                sync()
                err = max(float((counts - pc).abs().max()),
                          float((grank - pg).abs().max()))
                max_err[wire] = max(max_err.get(wire, 0.0), err)
                if not (torch.equal(counts, pc) and torch.equal(grank, pg)):
                    fail(f"tilelet {wire} {name} phased={phased} "
                         f"offsets={offsets}: kernel != plain (max abs err "
                         f"{err})")
            log(f"tilelet {wire:6s} {name:8s} phased={phased!s:5s}: "
                f"bit-identical to plain, staged, with offsets only and "
                f"without ({len(c['tile'])} rows, deepest tile "
                f"{c['max_rows']}, W={c['width']}, {int(counts.sum())} "
                f"counts)")

    for wire in ("v2", "nibble"):
        c, t = cases[(wire, "chunk")], devs[(wire, "chunk")]
        r = results[wire] = {}
        (r["bound_ms"], r["bound_by"]), n_rows = case_bound(c)
        (r["phased_bound_ms"], _), _ = case_bound(c, phased=True)
        want = plain(wire, t, False)
        r["ms"] = alone(wire, t, False, want)
        r["cold_ms"], n_copies = cold(wire, c, t, want)
        r["phased_ms"] = alone(wire, t, True, plain(wire, t, True))
        shapes = {}
        for name in ("deep", "one_deep"):
            xc, xt = cases[(wire, name)], devs[(wire, name)]
            (r[f"{name}_bound_ms"], _), rows = case_bound(xc)
            r[f"{name}_ms"] = alone(wire, xt, False, plain(wire, xt, False))
            shapes[name] = (f"{rows} rows, deepest tile {xc['max_rows']}, "
                            f"W={xc['width']}, {case_bytes(xc)} B")
        r["wrapper_ms"] = cuda_time(lambda: run(wire, t, False))
        r["wrapper_nooff_ms"] = cuda_time(
            lambda: run(wire, t, False, offsets="none"))
        r["plain_ms"] = cuda_time(lambda: plain(wire, t, False), iters=5)
        library, check = tilelet_library(wire, t)
        check(want)
        r["library_ms"] = cuda_time(library)
        passes = kernel_breakdown(lambda: run(wire, t, False))
        log(f"tilelet {wire}, device ms by kernel of one staged wrapper "
            f"call: {json.dumps(passes)}")
        if len(passes) != 1:
            fail(f"tilelet {wire}: a staged wrapper call enqueued "
                 f"{len(passes)} kernels, not one: {passes}")
        log(f"tilelet {wire} at the main path's shape ({n_rows} rows, "
            f"W={c['width']}): kernel alone {r['ms']:.4f} ms warm, "
            f"{r['cold_ms']:.4f} ms with L2 cold ({n_copies} rotated "
            f"copies), phased {r['phased_ms']:.4f} ms (bound "
            f"{r['phased_bound_ms']:.4f} ms); the wrapper "
            f"{r['wrapper_ms']:.4f} ms with staged offsets, "
            f"{r['wrapper_nooff_ms']:.4f} ms without; plain "
            f"{r['plain_ms']:.4f} ms; library (bincount + scatter_reduce "
            f"amin on keys decoded beforehand, decode left out) "
            f"{r['library_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
            f"({case_bytes(c)} B at 3.35 TB/s). Deep chunk "
            f"({shapes['deep']}): alone {r['deep_ms']:.4f} ms, bound "
            f"{r['deep_bound_ms']:.4f} ms. One deep tile among 50-row "
            f"tiles ({shapes['one_deep']}): alone {r['one_deep_ms']:.4f} "
            f"ms, bound {r['one_deep_bound_ms']:.4f} ms")
    for wire in results:
        results[wire]["max_abs_err"] = max_err[wire]
    log(f"kernel phase launches (checks and timing, not the main path): "
        f"{dict(tlt.launches)}")
    return results


EV_KEYS = ("ev_pos", "ev_chan", "ev_group", "ev_rank")


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    the operations over the non-tensor float32 rate."""
    bytes_ms = n_bytes / H100_HBM_BPS * 1e3
    ops_ms = n_ops / H100_FP32_OPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def staged_events(bam_path, fasta_path, ctg, start, end):
    """Stage one chunk the way the fused route's events wire does (events
    in staging order): ({EV_KEYS: numpy array}, padded width)."""
    from clair3_rna_torch import config
    from clair3_rna_torch.io.fasta import FastaFile
    from clair3_rna_torch.ops.fused_pileup import stage_chunk
    from clair3_rna_torch.pileup.chunk import (extract_region_events,
                                               open_bam, ref_codes_from)

    cfg = config.PileupConfig()
    fasta = FastaFile(fasta_path)
    lo = max(0, start - config.NO_OF_POSITIONS)
    hi = min(fasta.contig_length(ctg), end + config.NO_OF_POSITIONS)
    codes = ref_codes_from(fasta.fetch(ctg, lo, hi))
    data = extract_region_events(open_bam(bam_path), ctg, lo, hi, cfg)
    st = stage_chunk(data, codes, cfg, start, end)
    return {k: getattr(st, k) for k in EV_KEYS}, st.width


def shuffled(rng, arrays):
    """The same events in a random order."""
    perm = rng.permutation(len(next(iter(arrays.values()))))
    return {k: v[perm] for k, v in arrays.items()}


def random_events(rng, width=16384, n=200_000):
    """Random events in random order: rank ties and duplicate events
    (ranks 0..39), a quarter of the positions' 256-blocks empty, a tenth of
    the events on eight deep columns, stars (group 6) and group-7 events
    inside [0, W), and inert events: pads at W, negative positions and
    channels outside [0, 32)."""
    import numpy as np

    live = rng.choice(width // 256, size=width // 256 * 3 // 4,
                      replace=False)
    pos = rng.choice(live, n) * 256 + rng.integers(0, 256, n)
    deep = rng.choice(pos, 8)
    pos[:n // 10] = deep[rng.integers(0, 8, n // 10)]
    pos = np.concatenate([pos, np.full(n // 50, width),
                          rng.integers(-5, 0, 10), rng.integers(0, width, 7)])
    m = len(pos)
    chan = rng.integers(0, 18, m)
    chan[-7:] = [32, 33, 40, 100, 127, -1, -128]
    ev = {"ev_pos": pos.astype(np.int32), "ev_chan": chan.astype(np.int8),
          "ev_group": rng.integers(0, 8, m).astype(np.int8),
          "ev_rank": rng.integers(0, 40, m).astype(np.int32)}
    return shuffled(rng, ev), width


def wide_events(rng, width=1 << 23, n=300_000):
    """Random events in random order over 2^23 positions, six of the
    kernel's bucketing ranges of 6144 256-position tiles, with a pile on
    each range boundary and pads at W."""
    import numpy as np

    edges = np.arange(1, 6) * 6144 * 256
    pos = np.concatenate([rng.integers(0, width, n),
                          rng.choice(edges, 5000) + rng.integers(-3, 3, 5000),
                          np.full(100, width)])
    m = len(pos)
    return {"ev_pos": pos.astype(np.int32),
            "ev_chan": rng.integers(0, 18, m).astype(np.int8),
            "ev_group": rng.integers(0, 8, m).astype(np.int8),
            "ev_rank": rng.integers(0, 1000, m).astype(np.int32)}, width


def scatter_phase(fasta, bam):
    """The event scatter kernel (K3) against its plain version on every
    case, bit-identical; timings at the main path's shape (the events of
    the first chr1 chunk, in staging order)."""
    import numpy as np
    import torch

    from clair3_rna_torch.csrc import launch_fused_scatter
    from clair3_rna_torch.ops import fused_scatter as fsc

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    chunk = staged_events(bam, fasta, "chr1", 0, CHUNK)
    deep = staged_events(bam, fasta, "chr3", 0, 20_000)
    cases = {"chunk": chunk,
             "chunk_shuffled": (shuffled(rng, chunk[0]), chunk[1]),
             "deep": deep,
             "deep_shuffled": (shuffled(rng, deep[0]), deep[1]),
             "random": random_events(rng),
             "wide": wide_events(rng)}
    max_err = 0.0
    res = {}
    outs = {}
    for name, (ev, width) in cases.items():
        t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in ev.items()}
        args = [t[k] for k in EV_KEYS]
        counts, grank = fsc.fused_scatter(*args, width)
        pc, pg = fsc.fused_scatter_plain(*args, width)
        sync()
        err = max(float((counts - pc).abs().max()),
                  float((grank - pg).abs().max()))
        max_err = max(max_err, err)
        if not (torch.equal(counts, pc) and torch.equal(grank, pg)):
            fail(f"fused_scatter {name}: kernel != plain (max abs err "
                 f"{err})")
        outs[name] = (counts, grank)
        base = name.split("_")[0]
        if base != name and not (torch.equal(counts, outs[base][0])
                                 and torch.equal(grank, outs[base][1])):
            fail(f"fused_scatter {name}: the event order changed the result")
        n_ev = len(ev["ev_pos"])
        log(f"fused_scatter {name:14s}: bit-identical to plain ({n_ev} "
            f"events, W={width}, {int(counts.sum())} counts)")
        if name != "chunk":
            continue
        n_bytes = (sum(v.nbytes for v in ev.values())
                   + (fsc.C_PAD + fsc.G_PAD) * width * 4)
        copies = [([a.clone() for a in args], torch.empty_like(pc),
                   torch.empty_like(pg)) for _ in range(l2_copies(n_bytes))]
        oc, og = torch.empty_like(pc), torch.empty_like(pg)
        ms = graph_ms(lambda: launch_fused_scatter(*args, width, oc, og))
        if not (torch.equal(oc, pc) and torch.equal(og, pg)):
            fail("fused_scatter: graph-launched kernel != plain")
        cold_ms = rotated_graph_ms(
            [lambda c=c: launch_fused_scatter(*c[0], width, c[1], c[2])
             for c in copies], iters=4 * len(copies))
        for _, c_out, g_out in copies:
            if not (torch.equal(c_out, pc) and torch.equal(g_out, pg)):
                fail("fused_scatter: cold graph-launched kernel != plain")
        log("fused_scatter, device ms by pass: " + json.dumps(
            kernel_breakdown(lambda: launch_fused_scatter(*args, width, oc,
                                                          og))))
        wrapper_ms = cuda_time(lambda: fsc.fused_scatter(*args, width))
        plain_ms = cuda_time(lambda: fsc.fused_scatter_plain(*args, width),
                             iters=5)
        # the library yardstick: the two reductions as one PyTorch call
        # each, on keys built beforehand (the chunk has no inert events)
        pos = t["ev_pos"].long()
        ckey = pos * fsc.C_PAD + t["ev_chan"].long()
        rkey = pos * fsc.G_PAD + t["ev_group"].long()
        rinit = torch.full((width * fsc.G_PAD,), int(fsc.RANK_INF_F),
                           dtype=torch.int32, device=dev)

        def library():
            return (torch.bincount(ckey, minlength=width * fsc.C_PAD),
                    torch.scatter_reduce(rinit, 0, rkey, t["ev_rank"],
                                         "amin"))

        lc, lr = library()
        if not (torch.equal(lc.reshape(width, fsc.C_PAD).T.float(), pc)
                and torch.equal(lr.reshape(width, fsc.G_PAD).T[:6].float(),
                                pg[:6])):
            fail("fused_scatter: the library yardstick computes another "
                 "function")
        library_ms = cuda_time(library)
        bound_ms, bound_by = bound(n_bytes, 2 * n_ev)
        res = {"ms": ms, "cold_ms": cold_ms,
               "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "events": n_ev, "bytes": n_bytes}
        log(f"fused_scatter at the main path's shape ({n_ev} events in "
            f"staging order, W={width}): whole operation alone {ms:.4f} ms "
            f"warm, {cold_ms:.4f} ms with L2 cold ({len(copies)} rotated "
            f"copies); the wrapper {wrapper_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library (bincount + scatter_reduce amin) "
            f"{library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({n_bytes} B at 3.35 TB/s)")
    res["max_abs_err"] = max_err
    return res


def builder_count_calls(fasta, bam, ctg, start, end):
    """[(pos, chan, length, n_channels)] of every channel-count call the
    pure-array builder makes for one chunk, recorded while it runs with the
    kernel backend on the card."""
    import numpy as np

    from clair3_rna_torch import config
    from clair3_rna_torch.io.fasta import FastaFile
    from clair3_rna_torch.ops import pileup_kernel as tpk
    from clair3_rna_torch.pileup.chunk import (ChunkTask, build_chunk_tensors,
                                               open_bam)

    calls = []
    orig = tpk.pileup_counts

    def record(pos, chan, length, n_channels, backend, device):
        calls.append((np.array(pos), np.array(chan), length, n_channels))
        return orig(pos, chan, length, n_channels, backend, device)

    tpk.pileup_counts = record
    os.environ["CLAIR3_RNA_TORCH_PILEUP_BACKEND"] = "kernel"
    try:
        build_chunk_tensors(open_bam(bam, prefer_native=False),
                            FastaFile(fasta), ChunkTask(ctg, start, end),
                            config.PileupConfig(), device=DEVICE)
    finally:
        tpk.pileup_counts = orig
        os.environ.pop("CLAIR3_RNA_TORCH_PILEUP_BACKEND")
    return calls


def counts_phase(fasta, bam):
    """The channel-count kernel (K4) against its plain version and the
    host bincount on the first chr1 chunk's builder calls (in the order
    the builder gives the events, and shuffled) and a random 30-channel
    case, bit-identical; timings at the largest builder call (base+star,
    18 channels)."""
    import numpy as np
    import torch

    from clair3_rna_torch.csrc import launch_pileup_counts
    from clair3_rna_torch.ops import pileup_kernel as tpk

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    calls = builder_count_calls(fasta, bam, "chr1", 0, CHUNK)
    if [c[3] for c in calls] != [18, 18, 4]:
        fail(f"builder count calls: channels {[c[3] for c in calls]}, "
             "expected base+star 18, ins/del 18, groups 4")
    cases = dict(zip(("base+star", "ins/del", "groups"), calls))
    perm = rng.permutation(len(calls[0][0]))
    cases["base+star_shuffled"] = (calls[0][0][perm], calls[0][1][perm],
                                   *calls[0][2:])
    length = CHUNK + 66
    centers = rng.integers(0, length, 2000)
    pos = np.clip(rng.choice(centers, 400_000)
                  + rng.integers(-40, 40, 400_000), 0, length - 1)
    pos = np.concatenate([pos, np.full(100, -1)])    # inert pads
    cases["random_30ch"] = (pos, rng.integers(0, 30, len(pos)), length, 30)
    # 8 M positions, over several of the kernel's bucketing ranges
    length = 8_000_000
    pos = np.concatenate([rng.integers(0, length, 300_000),
                          np.arange(1, 6) * 6144 * 256 - 1, [length - 1]])
    cases["wide"] = (pos, rng.integers(0, 4, len(pos)), length, 4)
    max_err = 0.0
    for name, (pos, chan, length, n_ch) in cases.items():
        ev_pos, ev_chan, length_pad = tpk.prepare(pos, chan, length)
        t = [ev_pos.to(dev), ev_chan.to(dev)]
        k = tpk.pileup_counts_kernel(*t, length_pad)
        p = tpk.pileup_counts_plain(*t, length_pad)
        sync()
        err = float((k - p).abs().max())
        max_err = max(max_err, err)
        valid = pos >= 0
        host = np.bincount(pos[valid] * n_ch + chan[valid],
                           minlength=length * n_ch).reshape(length, n_ch)
        if not (torch.equal(k, p) and np.array_equal(
                k[:length, :n_ch].cpu().numpy(), host)):
            fail(f"pileup_counts {name}: kernel != plain or host bincount "
                 f"(max abs err vs plain {err})")
        log(f"pileup_counts {name:18s}: bit-identical to plain and the "
            f"host bincount ({len(pos)} events, length {length}, {n_ch} "
            f"channels)")
    pos, chan, length, n_ch = max(calls, key=lambda c: len(c[0]))
    ev_pos, ev_chan, length_pad = tpk.prepare(pos, chan, length)
    t = [ev_pos.to(dev), ev_chan.to(dev)]
    want = tpk.pileup_counts_plain(*t, length_pad)
    n_bytes = ev_pos.nbytes + ev_chan.nbytes + length_pad * tpk.C_PAD * 4
    copies = [([a.clone() for a in t], torch.empty_like(want))
              for _ in range(l2_copies(n_bytes))]
    out = torch.empty_like(want)
    ms = graph_ms(lambda: launch_pileup_counts(*t, length_pad, out))
    if not torch.equal(out, want):
        fail("pileup_counts: graph-launched kernel != plain")
    cold_ms = rotated_graph_ms(
        [lambda c=c: launch_pileup_counts(*c[0], length_pad, c[1])
         for c in copies], iters=4 * len(copies))
    if not all(torch.equal(c[1], want) for c in copies):
        fail("pileup_counts: cold graph-launched kernel != plain")
    log("pileup_counts, device ms by pass: " + json.dumps(kernel_breakdown(
        lambda: launch_pileup_counts(*t, length_pad, out))))
    wrapper_ms = cuda_time(lambda: tpk.pileup_counts_kernel(*t, length_pad))
    plain_ms = cuda_time(lambda: tpk.pileup_counts_plain(*t, length_pad),
                         iters=5)
    key = torch.from_numpy(pos.astype(np.int64) * n_ch + chan).to(dev)
    lib = torch.bincount(key, minlength=length * n_ch)
    if not torch.equal(lib.reshape(length, n_ch).to(torch.int32),
                       want[:length, :n_ch]):
        fail("pileup_counts: the library yardstick computes another "
             "function")
    library_ms = cuda_time(lambda: torch.bincount(key,
                                                  minlength=length * n_ch))
    # what the builder pays per call (dtype conversion into pinned memory,
    # copies both ways, the kernel), after one call that warms the pinned
    # host allocator; and the conversion alone
    tpk.pileup_counts(pos, chan, length, n_ch, "kernel", DEVICE)
    t0 = time.perf_counter()
    for _ in range(5):
        tpk.pileup_counts(pos, chan, length, n_ch, "kernel", DEVICE)
    dispatch_ms = (time.perf_counter() - t0) / 5 * 1e3
    t0 = time.perf_counter()
    for _ in range(5):
        tpk.prepare(pos, chan, length, pin=True)
    prepare_ms = (time.perf_counter() - t0) / 5 * 1e3
    bound_ms, bound_by = bound(n_bytes, len(pos))
    res = {"ms": ms, "cold_ms": cold_ms,
           "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "dispatch_ms": dispatch_ms, "prepare_ms": prepare_ms,
           "events": len(pos), "bytes": n_bytes, "max_abs_err": max_err}
    log(f"pileup_counts at the main path's largest call ({len(pos)} events "
        f"in the builder's order, length {length}, {n_ch} channels): whole "
        f"operation alone {ms:.4f} ms warm, {cold_ms:.4f} ms with L2 cold "
        f"({len(copies)} rotated copies); the wrapper "
        f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, library (bincount) "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({n_bytes} B at "
        f"3.35 TB/s); the builder's whole call {dispatch_ms:.4f} ms on the "
        f"host clock, of which the dtype conversion into pinned memory "
        f"{prepare_ms:.4f} ms")
    return res


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


def chunk_stage_timer(fp):
    """Patches fused_pileup's stage_chunk and staged_tensors (the events
    wire's host staging and its host-to-card copies, both called by
    FusedChunkCaller.call_chunk in one prefetch thread per chunk) with
    host-clock timers. Returns (per-chunk records, restore)."""
    import threading

    records = []
    last = threading.local()
    stage, to_dev = fp.stage_chunk, fp.staged_tensors

    def timed_stage(*a, **k):
        t0 = time.perf_counter()
        st = stage(*a, **k)
        last.stage = (time.perf_counter() - t0, len(st.ev_pos),
                      sum(getattr(st, k).nbytes for k in EV_KEYS))
        return st

    def timed_to_dev(*a, **k):
        t0 = time.perf_counter()
        out = to_dev(*a, **k)
        stage_s, n_ev, n_bytes = last.stage
        records.append({"events": n_ev, "event_bytes": n_bytes,
                        "stage_s": stage_s,
                        "h2d_s": time.perf_counter() - t0})
        return out

    def restore():
        fp.stage_chunk, fp.staged_tensors = stage, to_dev

    fp.stage_chunk, fp.staged_tensors = timed_stage, timed_to_dev
    return records, restore


def e2e_phase(work, fasta, bam):
    from clair3_rna_torch.cli import main as cli_main
    from clair3_rna_torch.models.network import init_params
    from clair3_rna_torch.models.params_io import save_params
    from clair3_rna_torch.ops import fused_pileup as fp
    from clair3_rna_torch.ops import fused_scatter as fsc
    from clair3_rna_torch.ops import pileup_kernel as tpk
    from clair3_rna_torch.ops import tilelet as tlt

    weights = save_params(os.path.join(work, "weights.npz"),
                          init_params(SEED, device=DEVICE))
    counters = (tlt, fsc, tpk)
    runs = {}
    # each route once cold (first run in the process), then host and
    # fused v2 again warm, then the two paths of K3 and K4
    for name, backend, env in (
            ("host", "host", {}),
            ("fused_v2", "fused", {"CLAIR3_RNA_TORCH_TILELET_WIRE": "v2"}),
            ("fused_nibble", "fused",
             {"CLAIR3_RNA_TORCH_TILELET_WIRE": "nibble"}),
            ("host_warm", "host", {}),
            ("fused_v2_warm", "fused",
             {"CLAIR3_RNA_TORCH_TILELET_WIRE": "v2"}),
            ("fused_events", "fused", {"CLAIR3_RNA_TORCH_FUSED_MODE": "events"}),
            ("host_pure_kernel", "host",
             {"CLAIR3_RNA_TORCH_NO_NATIVE": "1",
              "CLAIR3_RNA_TORCH_PILEUP_BACKEND": "kernel"})):
        out = os.path.join(work, f"out_{name}")
        os.environ.update(env)
        sync()
        # the events wire's staging and copies, timed per chunk (host
        # clock; a few perf_counter calls per chunk)
        chunks, restore = (chunk_stage_timer(fp) if name == "fused_events"
                           else ([], lambda: None))
        for mod in counters:
            mod.reset_launches()
        t0 = time.time()
        try:
            outputs, stats = cli_main([
                "call", "-B", bam, "-R", fasta, "-o", out,
                "--model_path", weights, "--device", DEVICE,
                "--pileup_backend", backend, "--chunk_size", str(CHUNK),
                "--no_compress", "--include_all_ctgs"])
            sync()
        finally:
            restore()
            for key in env:
                os.environ.pop(key)
        wall = time.time() - t0
        for i, c in enumerate(chunks):
            log(f"e2e {name} chunk {i}: {c['events']} events "
                f"({c['event_bytes']} B), staging {c['stage_s']:.4f} s, "
                f"host-to-card copies {c['h2d_s']:.4f} s (host clock)")
        launches = {k: v for mod in counters for k, v in mod.launches.items()}
        with open(outputs[0]) as f:
            body = [line for line in f if not line.startswith("#")]
        runs[name] = {"wall_s": wall, "candidates": stats.candidates,
                      "rows": len(body), "body": body,
                      "sites_per_s": stats.candidates / wall,
                      "launches": launches, "fused": stats.fused,
                      # thread-summed stage seconds (CallStats): build
                      # overlaps across the two prefetch threads
                      "build_s": stats.build_s, "infer_s": stats.infer_s,
                      "decode_s": stats.decode_s, "chunks": chunks}
        log(f"e2e {name}: {wall:.2f} s wall, {stats.candidates} candidate "
            f"sites ({stats.candidates / wall:.1f} sites/s), {len(body)} "
            f"VCF rows, kernel launches {launches}, fused counters "
            f"{stats.fused}")
    for name in runs:
        if runs[name]["body"] != runs["host"]["body"]:
            diff = [(a, b) for a, b in zip(runs["host"]["body"],
                                           runs[name]["body"]) if a != b]
            fail(f"{name} VCF body differs from the host route: "
                 f"{len(runs[name]['body'])} vs {len(runs['host']['body'])} "
                 f"rows, first differences {diff[:3]}")
    if not runs["host"]["body"]:
        fail("no VCF rows")
    # each kernel launches on its own paths and on no other
    own = {"tilelet_expand_v2": ("fused_v2", "fused_v2_warm"),
           "tilelet_expand": ("fused_nibble",),
           "fused_scatter": ("fused_events",),
           "pileup_counts": ("host_pure_kernel",)}
    for fn, names in own.items():
        for name, r in runs.items():
            n = r["launches"][fn]
            if name in names and n <= 0:
                fail(f"{name} launched no {fn} kernel")
            if name not in names and n != 0:
                fail(f"{name} launched {fn} {n} times: {r['launches']}")
    for name in ("fused_v2", "fused_nibble", "fused_v2_warm", "fused_events"):
        if runs[name]["fused"]["renorm_candidates"] <= 0:
            fail(f"{name}: the deep contig flagged no renorm candidate")
    log(f"e2e: {', '.join(runs)} VCF bodies identical "
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
        kern = kernel_phase(fasta, bam)
        kern["scatter"] = scatter_phase(fasta, bam)
        kern["counts"] = counts_phase(fasta, bam)
        network_phase(fasta, bam)
        runs = e2e_phase(work, fasta, bam)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for key, name, fn, run, src, line in (
            ("v2", "tilelet_expand_v2 (K1)", "tilelet_expand_v2", "fused_v2",
             "tilelet.cu", "clair3_rna_tpu/ops/tilelet.py:283"),
            ("nibble", "tilelet_expand (K2)", "tilelet_expand",
             "fused_nibble", "tilelet.cu",
             "clair3_rna_tpu/ops/tilelet.py:190"),
            ("scatter", "fused_scatter (K3)", "fused_scatter",
             "fused_events", "scatter.cu",
             "clair3_rna_tpu/ops/fused_scatter.py:131"),
            ("counts", "pileup_counts (K4)", "pileup_counts",
             "host_pure_kernel", "scatter.cu",
             "clair3_rna_tpu/ops/pileup_kernel.py:36")):
        k = kern[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"clair3_rna_torch/csrc/{src}", "replaces": line,
            "launches": runs[run]["launches"][fn],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "cold_ms": k.get("cold_ms"),
            "wrapper_ms": k["wrapper_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
            **{f: k[f] for f in ("deep_ms", "deep_bound_ms", "one_deep_ms",
                                 "one_deep_bound_ms", "phased_ms",
                                 "phased_bound_ms", "wrapper_nooff_ms")
               if f in k}})
    summary = {name: {k: r[k] for k in ("wall_s", "candidates", "rows",
                                         "sites_per_s", "build_s", "infer_s",
                                         "decode_s", "fused", "chunks")}
               for name, r in runs.items()}
    log("e2e summary " + json.dumps(summary))
    print(f"[chip_smoke] card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
