"""Multi-device dry run: one sharded training step, the sharded forward and
the calling pipeline on a dp x tp mesh (the port's analogue of the JAX
package's __graft_entry__.dryrun_multichip)."""

import os
import random
import tempfile

import numpy as np
import torch

from clair3_rna_torch import config, resolve_device


def _mesh_devices(n_devices, device):
    """n_devices mesh slots on `device`'s type: the visible CUDA cards in
    turn (so one card repeats), or the CPU repeated."""
    device = resolve_device(device)
    if device.type == "cpu":
        return [device] * n_devices
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n_devices)]


def dryrun_multichip(n_devices, device="cuda"):
    """One sharded RAdam training step on an n_devices mesh (tp=2 when
    n_devices is even and >= 4), the sharded forward, then `call`'s host
    route and fused route on the mesh, whose VCF bodies must be identical.
    Prints one `dryrun_multichip OK: ...` line; returns {"loss", "rows",
    "dp", "tp"}."""
    from clair3_rna_torch import simdata
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.caller.pipeline import run_calling
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.io.fasta import write_fasta
    from clair3_rna_torch.models.network import init_params
    from clair3_rna_torch.parallel.mesh import (make_mesh, shard_params,
                                                sharded_forward_fn,
                                                sharded_train_step_fn)
    from clair3_rna_torch.train.radam import RAdam

    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(devices=_mesh_devices(n_devices, device), tp=tp)
    params = shard_params(init_params(0, device=mesh.device), mesh)
    params.requires_grad_(True)
    optimizer = RAdam(config.INITIAL_LEARNING_RATE)
    opt_state = optimizer.init(params.parameters())
    train_step = sharded_train_step_fn(None, optimizer, mesh)

    batch = max(8, n_devices * 2)
    rng = np.random.RandomState(0)
    x = rng.randint(-20, 20, size=(batch, config.NO_OF_POSITIONS,
                                   config.CHANNEL_SIZE)).astype(np.int32)
    y = np.zeros((batch, config.LABEL_SIZE), np.float32)
    y[:, 0] = 1.0  # gt21 AA
    y[:, 21] = 1.0  # homo ref
    y[:, 24 + 16] = 1.0
    y[:, 57 + 16] = 1.0
    gen = torch.Generator(device=mesh.device).manual_seed(1)
    params, opt_state, loss = train_step(params, opt_state, x, y, gen)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite training loss: {loss}")
    params.requires_grad_(False)

    # sharded inference path runs too
    forward = sharded_forward_fn(None, mesh)
    probs = forward(params, x).cpu().numpy()
    if probs.shape != (batch, 24) or not np.all(np.isfinite(probs)):
        raise RuntimeError(f"sharded forward: bad probabilities "
                           f"{probs.shape}")

    # the product graph on the same mesh: the host route and the fused
    # route (packed reads, tilelet expansion, mesh-sharded network) must
    # write identical VCF bodies
    with tempfile.TemporaryDirectory() as td:
        rng2 = random.Random(5)
        genome = simdata.random_genome(rng2, [("chr1", 16_000)])
        variants = simdata.plant_variants(rng2, genome, n_per_contig=40)
        fasta = os.path.join(td, "ref.fa")
        bam = os.path.join(td, "reads.bam")
        write_fasta(fasta, genome)
        simdata.simulate_bam(bam, genome, variants, rng2, depth=12)
        cfg = PileupConfig(batch_size=64)
        ccfg = CallConfig(show_ref=True)
        bodies = {}
        for backend in ("host", "fused"):
            out = os.path.join(td, f"{backend}.vcf")
            run_calling(bam, fasta, out, cfg=cfg, call_cfg=ccfg,
                        params=params, forward=forward, contigs=["chr1"],
                        chunk_size=8_000, compress=False, progress=False,
                        pileup_backend=backend)
            with open(out) as f:
                bodies[backend] = [line for line in f
                                   if not line.startswith("#")]
    if len(bodies["host"]) <= 5:
        raise RuntimeError("dryrun produced too few calls")
    if bodies["fused"] != bodies["host"]:
        raise RuntimeError("fused calling graph diverged from the host "
                           "route on the mesh")
    dp = mesh.shape["dp"]
    print(f"dryrun_multichip OK: {n_devices} devices (dp={dp}, tp={tp}, "
          f"{mesh.device.type}), loss={loss:.4f}; sharded calling pipeline "
          f"(fused pileup + mesh inference + merge) VCF-identical, "
          f"{len(bodies['host'])} rows", flush=True)
    return {"loss": loss, "rows": len(bodies["host"]), "dp": dp, "tp": tp}

