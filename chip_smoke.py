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
   K4), and `call --pileup_backend hybrid` (the per-chunk router, with
   CLAIR3_RNA_TORCH_ROUTE_PROBE_AFTER=1 so that both routes serve chunks:
   at least one chunk each, K1 launched once per fused pass; its routing
   counters and the probed host-to-card link are logged). Every VCF body
   must equal the host route's, each kernel must launch on its own path
   and on no other. The events wire's host staging
   and host-to-card copies are logged per chunk. Then three two-pass runs
   (--enable_phasing_model --phaser builtin, the committed trained
   BENCH_WEIGHTS_PHASED.npz for the 30-channel re-call): host route, fused
   route on the v2 wire and on the nibble wire. Their first passes must
   equal the host route's body, their output_enable_phasing.vcf bodies
   must be identical and non-empty, the phaser must tag reads, the fused
   re-calls must flag renorm candidates on the deep contig with no
   whole-chunk fallback, and the phased K1 (K2) must launch only in the
   phased v2 (nibble) run. Phase + haplotag seconds, the re-call's wall,
   candidates, sites/s and stage seconds are logged per run;
6. the other entry points: `call` under
   --enable_variant_calling_at_sequence_head_and_tail over chr1:1-100000 in
   10 kb chunks on the host route and the fused route (identical bodies:
   the head/tail halo repair); create_tensor_pileup on chr1's first chunk
   piped into call_variants on the card, and call_var_bam on the card for
   the same chunk (rows equal to `call`'s there); cal_af_distribution over
   the host route's sites with the builder's counts from K4
   (CLAIR3_RNA_TORCH_PILEUP_BACKEND=kernel) and from the host backend
   (byte-identical outputs, K4 launched under kernel only);
7. the phased kernel on the main path's own inputs: chunks of the tagged
   BAM staged as the phased re-call stages them (real hp), K1 and K2
   bit-identical to the plain version, timed alone;
8. sharded calling and the mesh: `call --n_shards 2 --shard_id 0|1` as two
   concurrent processes on the card, on the host route (then
   `merge_shards`) and on the fused route (the two in a gloo group through
   parallel/distributed.initialize, rank 0 merging after a barrier); both
   merged bodies equal the single-process bodies and the fused shards' K1
   launches sum to their fused passes. Then a mesh of repeated cuda:0:
   the sharded forward against one card (dp 4 x tp 1 bit-identical,
   dp 2 x tp 2 within 1e-5, both timed against one card), `call --tp 2`
   on that mesh (fused route, body equal to one card's, K1 launched) and
   parallel/dryrun.dryrun_multichip(4). Shard walls, the merge wall and
   the mesh forward's time are logged;
9. training: tensor2bin on chr1 against its planted variants and `train`
   (batch 2,000, lr 1e-3, 3 epochs), for the 18-channel model and for the
   30-channel model on the tagged BAM of phase 5; the trained loss on the
   bins must fall below the init's, and `call` (call_var_bam --phased for
   the 30-channel model) runs with the trained weights; the train step on
   the card against the CPU (dropout off, 3 steps: loss within 1e-5
   relative, weights within 1e-5); steps/s and samples/s of the train
   step at batch 2,000, 18 and 30 channels;
10. the instruments at quick size on the card, in this process:
   bench_torch.py --quick (every configuration of bench.py on one short
   contig each: host, fused, high-depth renorm, mixed-depth host/fused/
   hybrid, the phased re-call, the fused pass staged on the card with the
   events-wire ablation, and one fused run under torch.profiler), which
   raises on any row or path gate; its device busy share must be read
   from the trace's device rows, and K1 and K3 must launch. Then
   tools/torch_roofline.py --quick: the kernel, front-end and full-graph
   slices, K1 launched once a chunk, and the full graph's candidates equal
   to the bench's staged fused pass's. The busy share, the top kernels and
   the three slices' times are logged.

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
    216 for the default platform). Returns (fasta, bam, truth VCF of the
    variants planted on chr1)."""
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
    truth = os.path.join(work, "truth_chr1.vcf")
    write_truth(truth, variants, "chr1")
    return fasta, bam, truth


def staged_chunk(bam_path, fasta_path, ctg, start, end, wire, phased=False):
    """Stage one chunk the way the fused route does (the phased re-call's
    way with `phased`: hp from the reads' HP tags)."""
    from clair3_rna_torch import config
    from clair3_rna_torch.io.fasta import FastaFile
    from clair3_rna_torch.ops.fused_pileup import stage_chunk_packed
    from clair3_rna_torch.pileup.chunk import open_bam, ref_codes_from
    from clair3_rna_torch.pileup.packed import extract_region_packed

    cfg = config.PileupConfig(phased=phased)
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


def tagged_reads(bam_path):
    """(HP-tagged reads, all reads) of a BAM."""
    from clair3_rna_torch.io.bam import BamReader

    reader = BamReader(bam_path)
    n_hp = n_all = 0
    for ctg in reader.references:
        for rec in reader.fetch(ctg):
            n_all += 1
            n_hp += rec.tags.get("HP", 0) in (1, 2)
    return n_hp, n_all


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
    phasing = ["--enable_phasing_model", "--phaser", "builtin",
               "--phased_model_path",
               os.path.join(HERE, "BENCH_WEIGHTS_PHASED.npz")]
    counters = (tlt, fsc, tpk)
    runs = {}
    # each route once cold (first run in the process), then host and
    # fused v2 again warm, then the two paths of K3 and K4, then the
    # two-pass phased runs on the host route and on both fused wires
    for name, backend, env, phased in (
            ("host", "host", {}, False),
            ("fused_v2", "fused", {"CLAIR3_RNA_TORCH_TILELET_WIRE": "v2"},
             False),
            ("fused_nibble", "fused",
             {"CLAIR3_RNA_TORCH_TILELET_WIRE": "nibble"}, False),
            ("host_warm", "host", {}, False),
            ("fused_v2_warm", "fused",
             {"CLAIR3_RNA_TORCH_TILELET_WIRE": "v2"}, False),
            ("hybrid", "hybrid", {"CLAIR3_RNA_TORCH_TILELET_WIRE": "v2"},
             False),
            ("fused_events", "fused",
             {"CLAIR3_RNA_TORCH_FUSED_MODE": "events"}, False),
            ("host_pure_kernel", "host",
             {"CLAIR3_RNA_TORCH_NO_NATIVE": "1",
              "CLAIR3_RNA_TORCH_PILEUP_BACKEND": "kernel"}, False),
            ("host_phased", "host", {}, True),
            ("fused_phased_v2", "fused",
             {"CLAIR3_RNA_TORCH_TILELET_WIRE": "v2"}, True),
            ("fused_phased_nibble", "fused",
             {"CLAIR3_RNA_TORCH_TILELET_WIRE": "nibble"}, True)):
        out = os.path.join(work, f"out_{name}")
        os.environ.update(env)
        sync()
        # the events wire's staging and copies, timed per chunk (host
        # clock; a few perf_counter calls per chunk)
        chunks, restore = (chunk_stage_timer(fp) if name == "fused_events"
                           else ([], lambda: None))
        for mod in counters:
            mod.reset_launches()
        # the phased runs write a joblog per pass (build seconds a chunk)
        joblog = os.path.join(work, f"joblog_{name}.tsv")
        t0 = time.time()
        try:
            outputs, stats = cli_main([
                "call", "-B", bam, "-R", fasta, "-o", out,
                "--model_path", weights, "--device", DEVICE,
                "--pileup_backend", backend, "--chunk_size", str(CHUNK),
                "--no_compress", "--include_all_ctgs"]
                + (phasing + ["--joblog", joblog] if phased else []))
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
                      "routing": stats.routing,
                      # thread-summed stage seconds (CallStats): build
                      # overlaps across the two prefetch threads
                      "build_s": stats.build_s, "infer_s": stats.infer_s,
                      "decode_s": stats.decode_s, "chunks": chunks}
        log(f"e2e {name}: {wall:.2f} s wall, {stats.candidates} candidate "
            f"sites ({stats.candidates / wall:.1f} sites/s), {len(body)} "
            f"VCF rows, kernel launches {launches}, fused counters "
            f"{stats.fused}"
            + (f", routing {json.dumps(stats.routing)}" if stats.routing
               else ""))
        if not phased:
            continue
        ph = stats.phased
        phased_vcf = os.path.join(out, "output_enable_phasing.vcf")
        if phased_vcf not in outputs or ph is None:
            fail(f"{name}: no phased second pass ({outputs})")
        with open(phased_vcf) as f:
            phased_body = [line for line in f if not line.startswith("#")]
        tagged_bam = os.path.join(out, "phased_tagged.bam")
        n_hp, n_reads = tagged_reads(tagged_bam)
        runs[name]["phased"] = {
            "phase_s": ph.phase_s, "recall_wall_s": ph.wall_s,
            "first_pass_wall_s": stats.wall_s,
            "candidates": ph.candidates, "rows": len(phased_body),
            "sites_per_s": ph.candidates / ph.wall_s,
            "build_s": ph.build_s, "infer_s": ph.infer_s,
            "decode_s": ph.decode_s, "fused": ph.fused,
            "tagged_reads": n_hp, "reads": n_reads}
        for key, path in (("first_pass_chunk_s", joblog),
                          ("recall_chunk_s", joblog + ".phased")):
            with open(path) as f:
                runs[name]["phased"][key] = [
                    float(line.split("\t")[4]) for line in list(f)[1:]]
        runs[name]["phased_body"] = phased_body
        runs[name]["tagged_bam"] = tagged_bam
        log(f"e2e {name} phased pass: first pass {stats.wall_s:.2f} s, "
            f"phase + haplotag {ph.phase_s:.2f} s ({n_hp}/{n_reads} reads "
            f"tagged), re-call {ph.wall_s:.2f} s wall, {ph.candidates} "
            f"candidate sites ({ph.candidates / ph.wall_s:.1f} sites/s), "
            f"{len(phased_body)} VCF rows, stage seconds build "
            f"{ph.build_s:.3f} infer {ph.infer_s:.3f} decode "
            f"{ph.decode_s:.3f}, fused counters {ph.fused}; build seconds "
            f"a chunk, first pass {runs[name]['phased']['first_pass_chunk_s']}"
            f", re-call {runs[name]['phased']['recall_chunk_s']}")
    for name in runs:
        if runs[name]["body"] != runs["host"]["body"]:
            diff = [(a, b) for a, b in zip(runs["host"]["body"],
                                           runs[name]["body"]) if a != b]
            fail(f"{name} VCF body differs from the host route: "
                 f"{len(runs[name]['body'])} vs {len(runs['host']['body'])} "
                 f"rows, first differences {diff[:3]}")
    if not runs["host"]["body"]:
        fail("no VCF rows")
    want = runs["host_phased"]["phased_body"]
    if not want:
        fail("host_phased: no phased VCF rows")
    for name in ("fused_phased_v2", "fused_phased_nibble"):
        got = runs[name]["phased_body"]
        if got != want:
            diff = [(a, b) for a, b in zip(want, got) if a != b]
            fail(f"{name} phased VCF body differs from host_phased: "
                 f"{len(got)} vs {len(want)} rows, first differences "
                 f"{diff[:3]}")
        ph = runs[name]["phased"]
        if ph["fused"]["fallback_chunks"] != 0:
            fail(f"{name}: the phased re-call fell back to the host route "
                 f"on {ph['fused']['fallback_chunks']} chunks")
        if ph["fused"]["renorm_candidates"] <= 0:
            fail(f"{name}: the phased re-call flagged no renorm candidate "
                 "on the deep contig")
    for name in ("host_phased", "fused_phased_v2", "fused_phased_nibble"):
        if runs[name]["phased"]["tagged_reads"] <= 0:
            fail(f"{name}: the phaser tagged no read")
    # each kernel launches on its own paths and on no other; the phased
    # forms of K1/K2 only in the phased re-call of their wire's run
    own = {"tilelet_expand_v2": ("fused_v2", "fused_v2_warm", "hybrid",
                                 "fused_phased_v2"),
           "tilelet_expand": ("fused_nibble", "fused_phased_nibble"),
           "tilelet_expand_v2_phased": ("fused_phased_v2",),
           "tilelet_expand_phased": ("fused_phased_nibble",),
           "fused_scatter": ("fused_events",),
           "pileup_counts": ("host_pure_kernel",)}
    for fn, names in own.items():
        for name, r in runs.items():
            n = r["launches"][fn]
            if name in names and n <= 0:
                fail(f"{name} launched no {fn} kernel")
            if name not in names and n != 0:
                fail(f"{name} launched {fn} {n} times: {r['launches']}")
    for name in ("fused_v2", "fused_nibble", "fused_v2_warm", "fused_events",
                 "fused_phased_v2", "fused_phased_nibble"):
        if runs[name]["fused"]["renorm_candidates"] <= 0:
            fail(f"{name}: the deep contig flagged no renorm candidate")
    # hybrid: both routes served chunks, and K1 launched once per pass of
    # the chunks routed fused (a budget retry or a windows fetch is a pass)
    r, f = runs["hybrid"]["routing"], runs["hybrid"]["fused"]
    if r is None or r["fused_chunks"] < 1 or r["host_chunks"] < 1:
        fail(f"hybrid: both routes must serve chunks, routing {r}")
    want_k1 = (r["fused_chunks"] + f["overflow_retries"]
               + f["renorm_window_fetches"])
    got_k1 = runs["hybrid"]["launches"]["tilelet_expand_v2"]
    if got_k1 != want_k1:
        fail(f"hybrid: K1 launched {got_k1} times for {r['fused_chunks']} "
             f"fused chunks ({f['overflow_retries']} retries, "
             f"{f['renorm_window_fetches']} windows fetches)")
    log(f"e2e hybrid: {r['fused_chunks']} chunks fused, {r['host_chunks']} "
        f"host, {r['fused_failures']} fused failures, probed link "
        f"{r['link_bps'] / 1e9:.2f} GB/s (pinned host to card), walls per "
        f"bucket {json.dumps(r['bucket_walls'])}; K1 launches {got_k1}")
    log(f"e2e: {', '.join(runs)} VCF bodies identical "
        f"({len(runs['host']['body'])} rows); phased bodies of "
        f"host_phased, fused_phased_v2, fused_phased_nibble identical "
        f"({len(want)} rows)")
    return runs


def blank_filter(rows):
    """VCF rows with the FILTER column blanked: the merge of `call` marks
    LowQual, per-chunk outputs do not."""
    return ["\t".join(r.split("\t")[:6] + ["."] + r.split("\t")[7:])
            for r in rows]


def slice6_phase(work, fasta, bam, runs):
    """This slice's paths on the card: `call` under head/tail on both
    routes at 10 kb chunks; create_tensor_pileup piped into call_variants,
    and call_var_bam, on chr1's first chunk against `call`'s rows; and
    cal_af_distribution with the builder's counts from K4 and from the host
    backend. Returns a summary dict."""
    import contextlib
    import io

    from clair3_rna_torch.cli import main as cli_main
    from clair3_rna_torch.ops import pileup_kernel as tpk

    weights = os.path.join(work, "weights.npz")
    out = {}
    # head/tail: host and fused v2 over chr1:1-100000 in 10 kb chunks must
    # give identical rows (the halo repair)
    bodies = {}
    for name, backend in (("host", "host"), ("fused_v2", "fused")):
        d = os.path.join(work, f"head_tail_{name}")
        t0 = time.time()
        outputs, stats = cli_main([
            "call", "-B", bam, "-R", fasta, "-o", d, "--model_path", weights,
            "--device", DEVICE, "--pileup_backend", backend, "--chunk_size",
            "10000", "--region", "chr1:1-100000",
            "--enable_variant_calling_at_sequence_head_and_tail",
            "--no_compress", "--include_all_ctgs"])
        sync()
        wall = time.time() - t0
        with open(outputs[0]) as f:
            bodies[name] = [line for line in f if not line.startswith("#")]
        out[f"head_tail_{name}"] = {"wall_s": wall, "rows": len(bodies[name]),
                                    "candidates": stats.candidates,
                                    "fused": stats.fused}
        log(f"head/tail {name}: {wall:.2f} s wall, {stats.candidates} "
            f"candidates, {len(bodies[name])} VCF rows over chr1:1-100000 in "
            f"10 kb chunks, fused counters {stats.fused}")
    if not bodies["host"] or bodies["host"] != bodies["fused_v2"]:
        diff = [(a, b) for a, b in zip(bodies["host"], bodies["fused_v2"])
                if a != b]
        fail(f"head/tail: host and fused bodies differ ({len(bodies['host'])}"
             f" vs {len(bodies['fused_v2'])} rows), first {diff[:3]}")

    # interop on chr1's first chunk ([0, CHUNK): --chunk_id 1 of 3): the
    # per-chunk rows must be `call`'s rows there; off head/tail a chunk also
    # emits halo rows within 17 bp past its end, which `call` has from the
    # next chunk
    host = blank_filter([r.rstrip("\n") for r in runs["host"]["body"]])
    core = [r for r in host if r.startswith("chr1\t")
            and int(r.split("\t")[1]) <= CHUNK]

    def check_chunk(name, rows):
        rows = blank_filter(rows)
        got = [r for r in rows if int(r.split("\t")[1]) <= CHUNK]
        halo = [r for r in rows if int(r.split("\t")[1]) > CHUNK]
        if got != core or not set(halo) <= set(host):
            fail(f"{name}: chr1 chunk 1 rows differ from call's ({len(got)} "
                 f"vs {len(core)} core rows, {len(halo)} halo rows)")
        return len(got), len(halo)

    t0 = time.time()
    tsv = io.StringIO()
    with contextlib.redirect_stdout(tsv):
        cli_main(["create_tensor_pileup", "--bam_fn", bam, "--ref_fn", fasta,
                  "--ctgName", "chr1", "--chunk_id", "1", "--chunk_num", "3",
                  "--device", DEVICE])
    t_tsv = time.time() - t0
    n_tsv = len(tsv.getvalue().splitlines())
    cv = os.path.join(work, "call_variants.vcf")
    stdin = sys.stdin
    sys.stdin = io.StringIO(tsv.getvalue())
    try:
        t0 = time.time()
        cli_main(["call_variants", "--call_fn", cv, "--chkpnt_fn", weights,
                  "--device", DEVICE])
        sync()
        t_cv = time.time() - t0
    finally:
        sys.stdin = stdin
    with open(cv) as f:
        n_core, n_halo = check_chunk("create_tensor_pileup | call_variants",
                                     [line.rstrip("\n") for line in f])
    out["interop_pipe"] = {"tsv_rows": n_tsv, "core_rows": n_core,
                           "halo_rows": n_halo, "create_s": t_tsv,
                           "call_variants_s": t_cv}
    log(f"interop: create_tensor_pileup chr1 chunk 1 -> {n_tsv} tensor rows "
        f"in {t_tsv:.2f} s, piped into call_variants on the card -> "
        f"{n_core} rows equal to call's in the chunk (+{n_halo} halo rows "
        f"found in call's output) in {t_cv:.2f} s")
    cvb = os.path.join(work, "call_var_bam.vcf")
    t0 = time.time()
    cli_main(["call_var_bam", "--bam_fn", bam, "--ref_fn", fasta,
              "--chkpnt_fn", weights, "--ctgName", "chr1", "--chunk_id", "1",
              "--chunk_num", "3", "--call_fn", cvb, "--device", DEVICE])
    sync()
    t_cvb = time.time() - t0
    with open(cvb) as f:
        n_core, n_halo = check_chunk(
            "call_var_bam", [line.rstrip("\n") for line in f
                             if not line.startswith("#")])
    out["call_var_bam"] = {"core_rows": n_core, "halo_rows": n_halo,
                           "wall_s": t_cvb}
    log(f"interop: call_var_bam chr1 chunk 1 on the card -> {n_core} rows "
        f"equal to call's (+{n_halo} halo rows) in {t_cvb:.2f} s")

    # the toolkit on K4: per-site support of the host route's calls, with
    # the builder's channel counts from the count kernel and from the host
    truth = os.path.join(work, "sites.vcf")
    with open(truth, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\tSAMPLE\n")
        f.writelines(runs["host"]["body"])
    files, k4 = {}, {}
    for backend in ("host", "kernel"):
        path = os.path.join(work, f"af_{backend}.txt")
        os.environ["CLAIR3_RNA_TORCH_PILEUP_BACKEND"] = backend
        tpk.reset_launches()
        t0 = time.time()
        try:
            cli_main(["cal_af_distribution", "--normal_bam_fn", bam,
                      "--ref_fn", fasta, "--truth_vcf_fn", truth,
                      "--output_fn", path, "--device", DEVICE])
            sync()
        finally:
            os.environ.pop("CLAIR3_RNA_TORCH_PILEUP_BACKEND")
        k4[backend] = tpk.launches["pileup_counts"]
        with open(path, "rb") as f:
            files[backend] = f.read()
        out[f"af_{backend}"] = {"wall_s": time.time() - t0,
                                "k4_launches": k4[backend],
                                "rows": files[backend].count(b"\n")}
    if not files["host"] or files["host"] != files["kernel"]:
        fail("cal_af_distribution: the K4 output differs from the host "
             "backend's")
    if k4["host"] != 0 or k4["kernel"] <= 0:
        fail(f"cal_af_distribution: K4 launches {k4} (must be > 0 under "
             "kernel only)")
    log(f"toolkit: cal_af_distribution over {out['af_host']['rows']} sites, "
        f"byte-identical with counts from K4 ({k4['kernel']} launches, "
        f"{out['af_kernel']['wall_s']:.2f} s) and from the host backend (0 "
        f"launches, {out['af_host']['wall_s']:.2f} s)")
    return out


def phased_kernel_check(fasta, tagged_bam):
    """K1/K2 phased on the main path's own inputs: the first chr1 chunk and
    the deep chr3 chunk of the tagged BAM, staged as the phased re-call
    stages them (hp from the HP tags), against the plain version through
    the wrapper as the fused route calls it; the chr1 chunk also timed
    alone. Returns {wire: {"max_abs_err", "phased_real_ms"}}."""
    import numpy as np
    import torch

    from clair3_rna_torch.ops import tilelet as tlt

    dev = torch.device(DEVICE)
    out = {}
    for wire in ("v2", "nibble"):
        r = out[wire] = {"max_abs_err": 0.0}
        for name, (ctg, lo, hi) in (("chunk", ("chr1", 0, CHUNK)),
                                    ("deep", ("chr3", 0, 20_000))):
            st = staged_chunk(tagged_bam, fasta, ctg, lo, hi, wire,
                              phased=True)
            t = {k: (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                     if v is not None else None)
                 for k, v in (("codes", st.tl_codes), ("valid", st.tl_valid),
                              ("tile", st.tl_tile), ("rank", st.tl_rank),
                              ("strand", st.tl_strand), ("hp", st.tl_hp),
                              ("row_off", st.tl_row_off))}
            t["width"], t["max_rows"] = st.width, st.tl_max_rows
            counts, grank = tlt.expand(
                wire, t["codes"], t["valid"], t["tile"], t["rank"],
                t["strand"], t["width"], tl_hp=t["hp"], phased=True,
                tl_row_off=t["row_off"], max_rows=t["max_rows"])
            pc, pg = tlt.tilelet_expand_plain(
                t["codes"], t["valid"], t["tile"], t["rank"], t["strand"],
                t["hp"], t["width"], phased=True, wire=wire)
            sync()
            err = max(float((counts - pc).abs().max()),
                      float((grank - pg).abs().max()))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if not (torch.equal(counts, pc) and torch.equal(grank, pg)):
                fail(f"tilelet {wire} phased, tagged {name}: kernel != "
                     f"plain (max abs err {err})")
            hp = np.bincount(st.tl_hp[:int(st.tl_row_off[-1])], minlength=3)
            hp_counts = int(counts[18:30].sum())
            if hp_counts <= 0:
                fail(f"tilelet {wire} phased, tagged {name}: no hp count")
            msg = (f"tilelet {wire:6s} phased, tagged BAM {name:5s}: "
                   f"bit-identical to plain ({int(st.tl_row_off[-1])} rows, "
                   f"hp 0/1/2 rows {hp.tolist()}, deepest tile "
                   f"{st.tl_max_rows}, {hp_counts} hp-plane counts)")
            if name == "chunk":
                go, oc, og = tilelet_launcher(wire, t, True)
                r["phased_real_ms"] = graph_ms(go)
                if not (torch.equal(oc, pc) and torch.equal(og, pg)):
                    fail(f"tilelet {wire}: graph-launched phased kernel != "
                         "plain")
                msg += f"; alone {r['phased_real_ms']:.4f} ms warm"
            log(msg)
    return out


SHARD_WORKER = '''
import json, sys, time
here, coord, n, pid, call_argv, merge_argv = sys.argv[1:7]
sys.path.insert(0, here)
import torch
from clair3_rna_torch.cli import main
from clair3_rna_torch.ops import tilelet as tlt
from clair3_rna_torch.parallel import distributed
n, pid = int(n), int(pid)
rank = pid
if coord != "-":
    world, rank = distributed.initialize(coordinator_address=coord,
                                         num_processes=n, process_id=pid)
    assert (world, rank) == (n, pid), (world, rank)
tlt.reset_launches()
t0 = time.time()
_, stats = main(json.loads(call_argv) + ["--n_shards", str(n),
                                         "--shard_id", str(rank)])
if torch.cuda.is_available():
    torch.cuda.synchronize()
out = {"rank": rank, "wall_s": time.time() - t0,
       "candidates": stats.candidates, "fused": stats.fused,
       "launches": dict(tlt.launches)}
if coord != "-":
    import torch.distributed as dist
    dist.barrier()
    if rank == 0:
        t0 = time.time()
        main(json.loads(merge_argv))
        out["merge_s"] = time.time() - t0
    dist.destroy_process_group()
assert not [m for m in sys.modules if m.split(".")[0] in
            ("jax", "flax", "optax", "clair3_rna_tpu")]
print("SHARD_RESULT " + json.dumps(out), flush=True)
'''


def shard_pair(work, call_argv, merge_argv, coord):
    """Two shard processes of `call ... --n_shards 2` run concurrently on
    the card (through a gloo group on localhost when `coord` is given, rank
    0 then merging after a barrier). Returns their SHARD_RESULT dicts, rank
    order, and the pair's wall."""
    script = os.path.join(work, "shard_worker.py")
    with open(script, "w") as f:
        f.write(SHARD_WORKER)
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, script, HERE, coord or "-", "2", str(pid),
         json.dumps(call_argv), json.dumps(merge_argv)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("SHARD_RESULT ")]
            if p.returncode != 0 or not lines:
                fail(f"shard process failed (rc {p.returncode}):\n"
                     f"{err[-3000:]}")
            results.append(json.loads(lines[-1][len("SHARD_RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return sorted(results, key=lambda r: r["rank"]), time.time() - t0


def wall_ms(fn, reps=5):
    """Mean host-clock milliseconds of `fn()` over `reps` calls after one,
    synchronized."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def body_of(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


def parallel_phase(work, fasta, bam, runs):
    """Sharded calling and the device mesh on the card: `call --n_shards 2`
    as two concurrent processes on the host route (then `merge_shards`)
    and on the fused route (the two joined by a gloo group on localhost,
    rank 0 merging after a barrier), each merged body equal to the
    single-process body of its route, K1 launches of the fused shards
    summing to their fused passes; then a mesh of repeated cuda:0: the
    sharded forward against one card (dp 4 x tp 1 bit-identical, dp 2 x
    tp 2 within 1e-5), `call --tp 2` on that mesh (fused route, the network
    through the mesh; body equal to one card's, K1 launched) and
    dryrun_multichip(4). Returns a summary dict."""
    import socket

    import numpy as np
    import torch

    from clair3_rna_torch import config
    from clair3_rna_torch.caller import driver
    from clair3_rna_torch.caller.pipeline import batch_wire
    from clair3_rna_torch.cli import main as cli_main
    from clair3_rna_torch.io.fasta import FastaFile
    from clair3_rna_torch.models.network import make_wire_forward_fn
    from clair3_rna_torch.models.params_io import (load_params,
                                                   params_from_numpy)
    from clair3_rna_torch.ops import tilelet as tlt
    from clair3_rna_torch.parallel.dryrun import dryrun_multichip
    from clair3_rna_torch.parallel.mesh import make_mesh, shard_params
    from clair3_rna_torch.pileup.chunk import (ChunkTask, build_chunk_tensors,
                                               open_bam, plan_chunks)

    weights = os.path.join(work, "weights.npz")
    n_chunks = len(plan_chunks(FastaFile(fasta), chunk_size=CHUNK))
    out = {}
    for route, single, gloo in (("host", "host", False),
                                ("fused", "fused_v2", True)):
        d = os.path.join(work, f"shards_{route}")
        merged = os.path.join(work, f"merged_{route}.vcf")
        call_argv = ["call", "-B", bam, "-R", fasta, "-o", d,
                     "--model_path", weights, "--device", DEVICE,
                     "--pileup_backend", route, "--chunk_size", str(CHUNK),
                     "--no_compress", "--include_all_ctgs"]
        merge_argv = ["merge_shards", "--work_dir", d, "--n_shards", "2",
                      "--output_fn", merged, "--ref_fn", fasta,
                      "--no_compress"]
        coord = None
        if gloo:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            coord = f"127.0.0.1:{s.getsockname()[1]}"
            s.close()
        shards, pair_wall = shard_pair(work, call_argv, merge_argv, coord)
        if gloo:
            merge_s = shards[0]["merge_s"]
        else:
            t0 = time.time()
            cli_main(merge_argv)
            merge_s = time.time() - t0
        body = body_of(merged)
        if not body or body != runs[single]["body"]:
            fail(f"{route} shards: merged body differs from the single "
                 f"process's ({len(body)} vs {len(runs[single]['body'])} "
                 "rows)")
        k1 = sum(r["launches"]["tilelet_expand_v2"] for r in shards)
        passes = (n_chunks + sum(r["fused"]["overflow_retries"]
                                 + r["fused"]["renorm_window_fetches"]
                                 for r in shards)) if route == "fused" else 0
        if k1 != passes:
            fail(f"{route} shards: K1 launched {k1} times for {passes} "
                 f"fused passes ({n_chunks} chunks)")
        out[f"shards_{route}"] = {
            "shard_wall_s": [r["wall_s"] for r in shards],
            "pair_wall_s": pair_wall, "merge_s": merge_s,
            "candidates": [r["candidates"] for r in shards],
            "k1_launches": k1, "rows": len(body), "gloo": gloo}
        log(f"shards {route}: 2 concurrent processes"
            f"{' in a gloo group' if gloo else ''}, shard walls "
            f"{[round(r['wall_s'], 3) for r in shards]} s (call entry to "
            f"return), pair {pair_wall:.2f} s with process start, "
            f"candidates {[r['candidates'] for r in shards]}, merge_shards "
            f"{merge_s:.3f} s -> {len(body)} rows equal to the single "
            f"process's {single} body; K1 launches {k1} for {passes} fused "
            "passes")

    # the mesh on repeated cuda:0: sharded forward against one card
    cfg = config.PileupConfig()
    records = build_chunk_tensors(open_bam(bam), FastaFile(fasta),
                                  ChunkTask("chr1", 0, CHUNK), cfg)
    # the host route's full 2,048-row batch: the chunk's real windows,
    # repeated
    wire, codes = batch_wire(records, cfg)
    rows = np.resize(np.arange(len(wire)), 2048)
    wire, codes = wire[rows], codes[rows]
    _, forward = make_wire_forward_fn()
    net = params_from_numpy(load_params(weights), device=DEVICE)
    one = forward(net, wire, codes)
    card = torch.device(DEVICE, 0)

    mesh_out = {"rows": len(wire), "real_windows": len(records),
                "one_card_ms": wall_ms(lambda: forward(net, wire, codes))}
    for dp, tp in ((4, 1), (2, 2)):
        mesh = make_mesh(devices=[card] * 4, tp=tp)
        sharded = shard_params(net, mesh)
        got = forward(sharded, wire, codes)
        err = float((got - one).abs().max())
        if tp == 1 and not torch.equal(got, one):
            fail(f"mesh dp {dp} x tp 1: probabilities differ from one card "
                 f"(max abs {err})")
        if not err <= 1e-5:
            fail(f"mesh dp {dp} x tp {tp}: max abs prob diff {err} > 1e-5")
        ms = wall_ms(lambda: forward(sharded, wire, codes))
        mesh_out[f"dp{dp}_tp{tp}"] = {"max_abs_err": err, "ms": ms}
        log(f"mesh forward dp {dp} x tp {tp} on repeated cuda:0: "
            f"{len(wire)} rows ({len(records)} real windows repeated), max "
            f"abs prob diff vs one card "
            f"{err:.3e}, {ms:.2f} ms a wire call against "
            f"{mesh_out['one_card_ms']:.2f} ms on one card (host clock, "
            "synchronized, 5 calls)")
    # `call --tp 2` with the driver's mesh on repeated cuda:0
    saved = driver.default_mesh
    driver.default_mesh = lambda tp=1, device=None: make_mesh(
        devices=[card] * 4, tp=tp)
    tlt.reset_launches()
    d = os.path.join(work, "out_mesh")
    t0 = time.time()
    try:
        outputs, stats = cli_main([
            "call", "-B", bam, "-R", fasta, "-o", d, "--model_path",
            weights, "--device", DEVICE, "--pileup_backend", "fused",
            "--chunk_size", str(CHUNK), "--no_compress", "--include_all_ctgs",
            "--tp", "2"])
        sync()
    finally:
        driver.default_mesh = saved
    wall = time.time() - t0
    k1 = tlt.launches["tilelet_expand_v2"]
    body = body_of(outputs[0])
    if body != runs["fused_v2"]["body"]:
        diff = [(a, b) for a, b in zip(runs["fused_v2"]["body"], body)
                if a != b]
        fail(f"call on the dp 2 x tp 2 mesh: body differs from one card's "
             f"({len(body)} vs {len(runs['fused_v2']['body'])} rows), first "
             f"{diff[:3]}")
    if k1 <= 0:
        fail("call on the mesh launched no K1")
    mesh_out["call"] = {"wall_s": wall, "candidates": stats.candidates,
                        "rows": len(body), "k1_launches": k1}
    log(f"call --tp 2 on a dp 2 x tp 2 mesh of repeated cuda:0 (fused "
        f"route): {wall:.2f} s wall, {stats.candidates} candidates, "
        f"{len(body)} rows equal to one card's, K1 launches {k1}")
    t0 = time.time()
    dry = dryrun_multichip(4, device=DEVICE)
    mesh_out["dryrun"] = dict(dry, wall_s=time.time() - t0)
    log(f"dryrun_multichip(4) on the card: {mesh_out['dryrun']}")
    out["mesh"] = mesh_out
    return out


def write_truth(path, variants, contig):
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\tSAMPLE\n")
        for v in sorted(variants[contig], key=lambda v: v.pos):
            gt = "1/1" if v.genotype == (1, 1) else "0/1"
            f.write(f"{contig}\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t60\tPASS\t"
                    f".\tGT\t{gt}\n")


def train_phase(work, fasta, bam, truth, tagged_bam):
    """Training on the card: tensor2bin on chr1 against its planted
    variants, `train` at full width (batch 2,000, lr 1e-3, 3 epochs, the
    calling heads) whose loss on the bins must fall below the init's,
    `call` with the trained weights (sorted, unique rows; F1 against the
    planted variants logged); the same for the 30-channel model on the
    tagged BAM, called by call_var_bam --phased over its chr1; the train
    step on the card against the CPU from the same weights and batches
    (dropout off: loss within 1e-5 relative, weights within 1e-5 after 3
    steps); steps/s at batch 2,000, 18 and 30 channels. Returns a summary
    dict."""
    import numpy as np
    import torch

    from clair3_rna_torch import config
    from clair3_rna_torch.cli import main as cli_main
    from clair3_rna_torch.evaluation.compare_vcf import compare_vcf
    from clair3_rna_torch.models.network import init_params
    from clair3_rna_torch.models.params_io import (load_params,
                                                   params_from_numpy,
                                                   params_to_numpy)
    from clair3_rna_torch.parallel.mesh import task_loss, train_step_fn
    from clair3_rna_torch.train.data import load_bins
    from clair3_rna_torch.train.radam import RAdam

    out = {}
    for name, bam_in, phased in (("18ch", bam, False),
                                 ("30ch", tagged_bam, True)):
        flag = ["--phased"] if phased else []
        bins = os.path.join(work, f"bins_{name}")
        t0 = time.time()
        cli_main(["tensor2bin", "--bam_fn", bam_in, "--ref_fn", fasta,
                  "--truth_vcf_fn", truth, "--output_dir", bins,
                  "--ctg_name", "chr1", "--non_variant_keep_fraction", "1.0",
                  "--device", DEVICE] + flag)
        t_bins = time.time() - t0
        X, Y = load_bins(bins)
        weights = os.path.join(work, f"trained_{name}.npz")
        t0 = time.time()
        cli_main(["train", "--bin_dir", bins, "--output_fn", weights,
                  "--max_epochs", "3", "--no_indel_length", "--device",
                  DEVICE] + flag)
        sync()
        t_train = time.time() - t0
        trained = params_from_numpy(load_params(weights), device=DEVICE)
        init = init_params(0, phased=phased, device=DEVICE)

        def loss_on_bins(net):
            with torch.inference_mode():
                x = torch.from_numpy(X).to(DEVICE, torch.float32)
                y = torch.from_numpy(Y[:, :24]).to(DEVICE, torch.float32)
                return float(task_loss(net(x), y))

        l_init, l_trained = loss_on_bins(init), loss_on_bins(trained)
        if not np.isfinite(l_trained) or not l_trained < l_init:
            fail(f"train {name}: loss on the bins {l_trained} not below the "
                 f"init's {l_init}")
        t0 = time.time()
        if phased:  # one 30-channel pass over the tagged BAM's chr1
            vcf = os.path.join(work, f"call_var_bam_{name}.vcf")
            cli_main(["call_var_bam", "--bam_fn", bam_in, "--ref_fn", fasta,
                      "--chkpnt_fn", weights, "--ctgName", "chr1",
                      "--phased", "--call_fn", vcf, "--device", DEVICE])
        else:
            vcf = cli_main([
                "call", "-B", bam_in, "-R", fasta, "-o",
                os.path.join(work, f"out_trained_{name}"), "--model_path",
                weights, "--device", DEVICE, "--pileup_backend", "fused",
                "--ctg_name", "chr1", "--chunk_size", str(CHUNK),
                "--no_compress"])[0][0]
        sync()
        t_call = time.time() - t0
        rows = body_of(vcf)
        positions = [int(r.split("\t")[1]) for r in rows]
        if positions != sorted(set(positions)):
            fail(f"call with the trained {name} weights: rows not sorted "
                 "and unique")
        f1 = compare_vcf(vcf, truth, ctg_name="chr1",
                         skip_genotyping=True).overall.f1
        out[name] = {"samples": len(X), "tensor2bin_s": t_bins,
                     "train_s": t_train, "loss_init": l_init,
                     "loss_trained": l_trained, "call_s": t_call,
                     "call_rows": len(rows), "f1_vs_planted": f1}
        log(f"train {name}: tensor2bin chr1 -> {len(X)} samples in "
            f"{t_bins:.2f} s; train (batch 2000, lr 1e-3, 3 epochs) "
            f"{t_train:.2f} s, loss on the bins {l_init:.4f} (init) -> "
            f"{l_trained:.4f}; call with the trained weights "
            f"({os.path.basename(vcf)}) {t_call:.2f} s, {len(rows)} rows, "
            f"F1 vs the planted variants {f1:.4f}")

    # the train step on the card against the CPU, dropout off
    tree = params_to_numpy(init_params(SEED, device="cpu"))
    nets = {d: params_from_numpy(tree, device=d).requires_grad_(True)
            for d in ("cpu", DEVICE)}
    opts = {d: RAdam(1e-3) for d in nets}
    states = {d: opts[d].init(nets[d].parameters()) for d in nets}
    steps = {d: train_step_fn(opts[d]) for d in nets}
    rng = np.random.RandomState(SEED)
    worst_loss = 0.0
    for _ in range(3):
        x = rng.randint(-30, 30, (512, 33, 18)).astype(np.int32)
        y = np.zeros((512, 24), np.float32)
        y[np.arange(512), rng.randint(0, 21, 512)] = 1
        y[np.arange(512), 21 + rng.randint(0, 3, 512)] = 1
        losses = {}
        for d in nets:
            nets[d], states[d], loss = steps[d](nets[d], states[d], x, y,
                                                None)
            losses[d] = float(loss)
        rel = abs(losses[DEVICE] - losses["cpu"]) / abs(losses["cpu"])
        worst_loss = max(worst_loss, rel)
        if not rel <= 1e-5:
            fail(f"train step: card loss {losses[DEVICE]} vs CPU "
                 f"{losses['cpu']} (relative {rel})")
    wdiff = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(nets[DEVICE].parameters(),
                                nets["cpu"].parameters()))
    if not wdiff <= 1e-5:
        fail(f"train step: weights after 3 steps differ by {wdiff}")
    out["card_vs_cpu"] = {"loss_rel": worst_loss, "weights_abs": wdiff}
    log(f"train step card vs CPU (512 rows, dropout off, 3 steps): loss "
        f"relative diff {worst_loss:.3e} (<= 1e-5), weights max abs diff "
        f"{wdiff:.3e} (<= 1e-5)")

    # steps/s at the default batch, with dropout as training runs it
    for name, channels in (("18ch", 18), ("30ch", 30)):
        net = init_params(SEED, add_indel_length=True,
                          phased=channels == 30,
                          device=DEVICE).requires_grad_(True)
        opt = RAdam(1e-3)
        state = opt.init(net.parameters())
        step = train_step_fn(opt, add_indel_length=True)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        x = torch.from_numpy(rng.randint(-30, 30, (2000, 33, channels))
                             .astype(np.float32)).to(DEVICE)
        y = torch.zeros((2000, config.LABEL_SIZE), device=DEVICE)
        y[:, 0] = y[:, 21] = y[:, 40] = y[:, 73] = 1.0
        for _ in range(2):
            net, state, loss = step(net, state, x, y, gen)
        sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        n_steps = 5
        for _ in range(n_steps):
            net, state, loss = step(net, state, x, y, gen)
        sync()
        dt = (time.perf_counter() - t0) / n_steps
        peak = torch.cuda.max_memory_allocated() / 2**20
        # the step's forward alone (dropout on, no graph kept)
        with torch.no_grad():
            fwd_ms = wall_ms(lambda: net(x, train=True, generator=gen))
        out[f"step_{name}"] = {"ms": dt * 1e3, "steps_per_s": 1 / dt,
                               "samples_per_s": 2000 / dt,
                               "forward_ms": fwd_ms, "peak_mib": peak}
        log(f"train step {name}, batch 2000 with dropout: {dt * 1e3:.1f} "
            f"ms ({1 / dt:.2f} steps/s, {2000 / dt:.0f} samples/s; host "
            f"clock, synchronized, {n_steps} steps after 2), its forward "
            f"alone {fwd_ms:.1f} ms, peak {peak:.0f} MiB")
    return out


def instruments_phase(work):
    """The instruments at quick size on the card (bench_torch.py --quick,
    tools/torch_roofline.py --quick) in this process, their detail output
    kept in a log file. Returns a summary dict with the kernel launches
    of the bench run (the counts set to 0 just before it)."""
    import contextlib

    sys.path.insert(0, os.path.join(HERE, "tools"))
    import bench_torch
    import torch_roofline
    from clair3_rna_torch.ops import fused_scatter as fsc
    from clair3_rna_torch.ops import pileup_kernel as tpk
    from clair3_rna_torch.ops import tilelet as tlt

    data = os.path.join(work, "bench")
    os.makedirs(data)
    logfile = os.path.join(work, "instruments.log")
    for mod in (tlt, fsc, tpk):
        mod.reset_launches()
    t0 = time.time()
    with open(logfile, "w") as fh, contextlib.redirect_stdout(fh):
        bench = bench_torch.main(["--quick", "--data-dir", data])
    bench_s = time.time() - t0
    launches = {**tlt.launches, **fsc.launches, **tpk.launches}
    ours = bench["detail"]["ours"]
    for fn in ("tilelet_expand_v2", "fused_scatter"):
        if not launches[fn]:
            fail(f"bench_torch --quick never launched {fn}: {launches}")
    mixed = ours["mixed_depth"]
    checks = {
        "fused_vcf_identical": ours["fused_e2e"]["fused_vcf_identical"],
        "high_depth_identical":
            ours["fused_high_depth"]["fused_vcf_identical"],
        "renorm_candidates":
            ours["fused_high_depth"]["fused_counters"]["renorm_candidates"],
        "mixed_identical": all(mixed[b].get("vcf_identical")
                               for b in ("fused", "hybrid")),
        "phased_identical":
            ours["phased_e2e"]["fused"]["fused_vcf_identical"]}
    if not all(checks.values()):
        fail(f"bench_torch --quick gates: {checks}")
    prof = ours["profile_fused_e2e"]
    if not prof.get("busy_share"):
        fail(f"no device busy share in the profiled fused run: {prof}")
    log(f"bench_torch --quick: every configuration and gate passed in "
        f"{bench_s:.1f} s (datasets {bench['setup']['datasets_s']} s, "
        f"weights {bench['setup']['weights_s']} s); main {ours['sites_per_s']:.1f} "
        f"sites/s host, fused {ours['fused_e2e']['sites_per_s']:.1f}; "
        f"launches {dict((k, v) for k, v in launches.items() if v)}")
    log(f"profiled fused run: device busy {prof['busy_ms']:.1f} of "
        f"{prof['window_ms']:.1f} ms = {prof['busy_share']:.4f}, "
        f"{prof['kernel_launches']} kernel launches; top kernels "
        + "; ".join(f"{k['name'][:48]} {k['ms']:.2f} ms x{k['launches']}"
                    for k in prof["top_kernels"][:5])
        + "; longest idle gaps (ms) "
        + ", ".join(f"{g['ms']:.1f}" for g in prof["longest_idle_gaps"]))
    tlt.reset_launches()
    t0 = time.time()
    with open(logfile, "a") as fh, contextlib.redirect_stdout(fh):
        roof = torch_roofline.main(["--quick", "--data-dir", data])
    roof_s = time.time() - t0
    if roof["kernel_launches"]["tilelet_expand_v2"] != roof["n_chunks"]:
        fail(f"roofline kernel_only: K1 launches {roof['kernel_launches']} "
             f"for {roof['n_chunks']} chunks")
    dev_only = ours["fused_device_only"]["n_candidates"]
    if roof["n_candidates"] != dev_only:
        fail(f"roofline full graph found {roof['n_candidates']} candidates, "
             f"the bench's staged fused pass {dev_only}")
    log(f"roofline --quick ({roof_s:.1f} s, {roof['n_chunks']} chunks, "
        f"{roof['n_events']} events): kernel {roof['kernel_only_s'] * 1e3:.3f}"
        f" ms, front end {roof['front_end_s'] * 1e3:.3f} ms, full graph "
        f"{roof['full_graph_s'] * 1e3:.3f} ms (kernel "
        f"{roof['kernel_share_of_full']:.3f}, tail "
        f"{roof['tail_share_of_full']:.3f}, mask + network "
        f"{roof['mask_network_share_of_full']:.3f}); HBM bound "
        f"{roof['hbm_bound_s'] * 1e3:.4f} ms = "
        f"{roof['kernel_pct_of_roofline']:.1f}% of the kernel's time")
    return {"bench_s": bench_s, "roofline_s": roof_s, "launches": launches,
            "busy_share": prof["busy_share"],
            "sites_per_s": {"host": ours["sites_per_s"],
                            "fused": ours["fused_e2e"]["sites_per_s"]},
            "roofline": {k: roof[k] for k in (
                "kernel_only_s", "front_end_s", "full_graph_s",
                "hbm_bound_s", "n_candidates")}}


def main():
    # the hybrid run's probe cadence: a bucket with one route measured
    # tries the other on its next chunk, so both routes serve chunks within
    # the smoke's six (read when the router's module is first imported)
    os.environ["CLAIR3_RNA_TORCH_ROUTE_PROBE_AFTER"] = "1"
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
        fasta, bam, truth = make_dataset(work)
        log(f"dataset simulated in {time.time() - t0:.1f} s")
        kern = kernel_phase(fasta, bam)
        kern["scatter"] = scatter_phase(fasta, bam)
        kern["counts"] = counts_phase(fasta, bam)
        network_phase(fasta, bam)
        runs = e2e_phase(work, fasta, bam)
        slice6 = slice6_phase(work, fasta, bam, runs)
        phased_real = phased_kernel_check(
            fasta, runs["fused_phased_v2"]["tagged_bam"])
        t0 = time.time()
        parallel = parallel_phase(work, fasta, bam, runs)
        parallel["wall_s"] = time.time() - t0
        t0 = time.time()
        train = train_phase(work, fasta, bam, truth,
                            runs["fused_phased_v2"]["tagged_bam"])
        train["wall_s"] = time.time() - t0
        t0 = time.time()
        instruments = instruments_phase(work)
        instruments["wall_s"] = time.time() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)

    for wire, r in phased_real.items():
        kern[wire]["max_abs_err"] = max(kern[wire]["max_abs_err"],
                                        r["max_abs_err"])
        kern[wire]["phased_real_ms"] = r["phased_real_ms"]
        kern[wire]["phased_launches"] = runs[
            {"v2": "fused_phased_v2", "nibble": "fused_phased_nibble"}[wire]
        ]["launches"][("tilelet_expand_v2" if wire == "v2"
                       else "tilelet_expand") + "_phased"]
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
            "bench_launches": instruments["launches"][fn],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "cold_ms": k.get("cold_ms"),
            "wrapper_ms": k["wrapper_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
            **{f: k[f] for f in ("deep_ms", "deep_bound_ms", "one_deep_ms",
                                 "one_deep_bound_ms", "phased_ms",
                                 "phased_bound_ms", "wrapper_nooff_ms",
                                 "phased_real_ms", "phased_launches")
               if f in k}})
    summary = {name: {k: r[k] for k in ("wall_s", "candidates", "rows",
                                         "sites_per_s", "build_s", "infer_s",
                                         "decode_s", "fused", "routing",
                                         "chunks", "phased") if k in r}
               for name, r in runs.items()}
    log("e2e summary " + json.dumps(summary))
    log("slice 6 summary " + json.dumps(slice6))
    log("parallel summary " + json.dumps(parallel))
    log("train summary " + json.dumps(train))
    log("instruments summary " + json.dumps(instruments))
    print(f"[chip_smoke] card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
