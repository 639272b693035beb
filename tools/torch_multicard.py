#!/usr/bin/env python3
"""The PyTorch port's device mesh and contig shards across real cards.

    python3 tools/torch_multicard.py

Needs a host with two or more CUDA cards (fails otherwise); run from a
checkout of the repository. On a small simulated dataset (seeded):

1. the wire forward on a mesh over every card, dp N x tp 1 and
   dp N/2 x tp 2, against one card: tp 1 bit-identical, tp 2 within 1e-5;
   both timed against one card;
2. `call --tp 1` and `call --tp 2` (the driver's default mesh over every
   card) on the host route and the fused route: VCF bodies equal to
   `call --no_device_mesh` on one card; the fused runs launch K1;
3. parallel/dryrun.dryrun_multichip(N) on the cards;
4. `call --n_shards N`, one process per card (CUDA_VISIBLE_DEVICES) in one
   gloo group, rank 0 merging after a barrier: body equal to one card's.

Prints one JSON summary line, then the cards' names and power limits.
"""

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from chip_smoke import (SEED, SHARD_WORKER, body_of, sync,  # noqa: E402
                        wall_ms)

CHUNK = 50_000


def fail(msg):
    print(f"[multicard] FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg):
    print(f"[multicard] {msg}", flush=True)


def card_lines():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def make_dataset(work):
    """Two contigs (150 kb, 100 kb) at depth 30, 150 planted variants
    each."""
    import random

    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.fasta import write_fasta

    rng = random.Random(SEED)
    genome = simdata.random_genome(rng, [("chr1", 150_000),
                                         ("chr2", 100_000)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=150)
    fasta = os.path.join(work, "ref.fa")
    bam = os.path.join(work, "reads.bam")
    write_fasta(fasta, genome)
    simdata.simulate_bam(bam, genome, variants, rng, depth=30)
    return fasta, bam


def shard_processes(work, n, call_argv, merge_argv):
    """`call ... --n_shards n` as n processes, process i on card i alone
    (CUDA_VISIBLE_DEVICES), joined by a gloo group; rank 0 merges after a
    barrier. Returns their results, rank order, and the wall."""
    import socket

    script = os.path.join(work, "shard_worker.py")
    with open(script, "w") as f:
        f.write(SHARD_WORKER)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, script, HERE, coord, str(n), str(i),
         json.dumps(call_argv), json.dumps(merge_argv)],
        env=dict(os.environ, PYTHONPATH=HERE, CUDA_VISIBLE_DEVICES=str(i)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(n)]
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


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        fail("needs two or more CUDA cards")
    n = torch.cuda.device_count()
    log(f"{n} cards: {card_lines()!r}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    from clair3_rna_torch import config, csrc
    from clair3_rna_torch.caller.pipeline import batch_wire
    from clair3_rna_torch.cli import main as cli_main
    from clair3_rna_torch.io.fasta import FastaFile
    from clair3_rna_torch.models.network import (init_params,
                                                 make_wire_forward_fn)
    from clair3_rna_torch.models.params_io import save_params
    from clair3_rna_torch.native import get_library
    from clair3_rna_torch.ops import tilelet as tlt
    from clair3_rna_torch.parallel.dryrun import dryrun_multichip
    from clair3_rna_torch.parallel.mesh import make_mesh, shard_params
    from clair3_rna_torch.pileup.chunk import (ChunkTask, build_chunk_tensors,
                                               open_bam)

    t0 = time.time()
    csrc.build_all()
    if get_library() is None:
        fail("native pileup library did not build")
    log(f"kernels + native library built in {time.time() - t0:.1f} s")
    work = os.path.join(HERE, ".multicard_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {"cards": n}
    try:
        fasta, bam = make_dataset(work)
        net = init_params(SEED, device="cuda")
        weights = save_params(os.path.join(work, "weights.npz"), net)
        base = ["-B", bam, "-R", fasta, "--model_path", weights,
                "--device", "cuda", "--chunk_size", str(CHUNK),
                "--no_compress", "--include_all_ctgs"]

        # 1. the wire forward on a mesh over the cards against one card
        cfg = config.PileupConfig()
        records = build_chunk_tensors(open_bam(bam), FastaFile(fasta),
                                      ChunkTask("chr1", 0, CHUNK), cfg)
        wire, codes = batch_wire(records, cfg)
        rows = np.resize(np.arange(len(wire)), 2048)
        wire, codes = wire[rows], codes[rows]
        _, forward = make_wire_forward_fn()
        one = forward(net, wire, codes)
        out["forward"] = {"rows": len(wire), "real_windows": len(records),
                          "one_card_ms": wall_ms(
                              lambda: forward(net, wire, codes))}
        for tp in (1, 2):
            mesh = make_mesh(tp=tp)
            sharded = shard_params(net, mesh)
            got = forward(sharded, wire, codes)
            err = float((got - one).abs().max())
            if (tp == 1 and not torch.equal(got, one)) or not err <= 1e-5:
                fail(f"mesh dp {n // tp} x tp {tp}: max abs prob diff "
                     f"{err} against one card")
            ms = wall_ms(lambda: forward(sharded, wire, codes))
            out["forward"][f"tp{tp}"] = {"dp": n // tp, "max_abs_err": err,
                                         "ms": ms}
            log(f"mesh dp {n // tp} x tp {tp} over {n} cards: max abs prob "
                f"diff {err:.3e}, {ms:.2f} ms a 2,048-row wire call against "
                f"{out['forward']['one_card_ms']:.2f} ms on one card")

        # 2. `call` on the driver's mesh against one card
        bodies = {}
        for route in ("host", "fused"):
            for tp in (0, 1, 2):
                flags = ["--no_device_mesh"] if tp == 0 else ["--tp",
                                                              str(tp)]
                d = os.path.join(work, f"out_{route}_tp{tp}")
                tlt.reset_launches()
                t0 = time.time()
                outputs, stats = cli_main(["call", "-o", d,
                                           "--pileup_backend", route]
                                          + base + flags)
                sync()
                wall = time.time() - t0
                k1 = tlt.launches["tilelet_expand_v2"]
                body = body_of(outputs[0])
                name = f"{route}_{'one_card' if tp == 0 else f'tp{tp}'}"
                out[name] = {"wall_s": wall, "rows": len(body),
                             "candidates": stats.candidates, "k1": k1}
                log(f"call {name}: {wall:.2f} s, {stats.candidates} "
                    f"candidates, {len(body)} rows, K1 launches {k1}")
                if route == "fused" and k1 <= 0:
                    fail(f"call {name} launched no K1")
                bodies[name] = body
        want = bodies["host_one_card"]
        for name, body in bodies.items():
            if not body or body != want:
                fail(f"call {name}: body differs from one card's host route "
                     f"({len(body)} vs {len(want)} rows)")

        # 3. the dry run on the cards
        t0 = time.time()
        out["dryrun"] = dict(dryrun_multichip(n, device="cuda"),
                             wall_s=time.time() - t0)

        # 4. one shard process per card, merged
        merged = os.path.join(work, "merged.vcf")
        shards, wall = shard_processes(
            work, n, ["call", "-o", os.path.join(work, "shards"),
                      "--pileup_backend", "fused", "--no_device_mesh"]
            + base,
            ["merge_shards", "--work_dir", os.path.join(work, "shards"),
             "--n_shards", str(n), "--output_fn", merged, "--ref_fn", fasta,
             "--no_compress"])
        if body_of(merged) != want:
            fail(f"{n} shard processes: merged body differs from one card's")
        out["shards"] = {"wall_s": wall, "merge_s": shards[0]["merge_s"],
                         "shard_wall_s": [r["wall_s"] for r in shards],
                         "candidates": [r["candidates"] for r in shards],
                         "k1": [r["launches"]["tilelet_expand_v2"]
                                for r in shards]}
        log(f"{n} shard processes, one a card, in a gloo group: shard walls "
            f"{[round(r['wall_s'], 3) for r in shards]} s, {wall:.2f} s with "
            f"process start, merge {shards[0]['merge_s']:.3f} s, body equal "
            "to one card's")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out))
    print(card_lines())


if __name__ == "__main__":
    main()
