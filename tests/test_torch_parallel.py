"""Sharded calling and the device mesh on the PyTorch port, against the JAX
package.

- param_spec: the port's layout of every weight equals the JAX package's
  (18/30 channels, with and without the indel-length heads, tp 1/2/4/8);
- a mesh of 8 repeated CPU devices (tp 1 and 2): VCF bodies equal one
  device's and the JAX host route's, and tp=1 probabilities are
  bit-identical to one device's (tp=2 within 1e-5);
- contig sharding (tests/test_distributed.py's six cases): partition, 1-
  and 4-shard merges equal to one process and to the JAX host route,
  resume, LPT balance, cost estimates equal to the JAX package's on the
  same BAI, retry after a crash;
- two processes through a gloo process group on localhost whose merged
  body equals one process's (the workers import no JAX);
- the driver's mesh choice, `call --n_shards`, the merge_shards CLI and the
  multi-device dry run.
"""

import os
import random
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from clair3_rna_torch.caller.decode import CallConfig
from clair3_rna_torch.caller.pipeline import run_calling
from clair3_rna_torch.config import PileupConfig
from clair3_rna_torch.models.network import (init_params, make_forward_fn,
                                             make_wire_forward_fn)
from clair3_rna_torch.models.params_io import params_from_numpy
from clair3_rna_torch.parallel import distributed as tdist
from clair3_rna_torch.parallel.mesh import (REPLICATE, ShardedNet,
                                            _spec_for_module, make_mesh,
                                            shard_params, sharded_forward_fn)
from clair3_rna_torch.pileup.chunk import ChunkTask

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8


def _rows(path):
    return [line for line in open(path) if not line.startswith("#")]


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _weights(**kw):
    """(JAX params, port net on the CPU) from the JAX package's
    init_params(0)."""
    from clair3_rna_tpu.models.network import init_params as jinit
    jp = jinit(0, **kw)
    return jp, params_from_numpy(_to_numpy(jp), device="cpu")


def _dataset(tmp_path, seed, contigs, n_variants, depth=30):
    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.fasta import write_fasta

    rng = random.Random(seed)
    genome = simdata.random_genome(rng, contigs)
    variants = simdata.plant_variants(rng, genome, n_per_contig=n_variants)
    fasta, bam = str(tmp_path / "ref.fa"), str(tmp_path / "reads.bam")
    write_fasta(fasta, genome)
    simdata.simulate_bam(bam, genome, variants, rng, depth=depth)
    return fasta, bam


def _jax_host(fasta, bam, out, jparams, contigs, chunk_size):
    from clair3_rna_tpu.caller.decode import CallConfig as JCall
    from clair3_rna_tpu.caller.pipeline import run_calling as jrun
    from clair3_rna_tpu.config import PileupConfig as JCfg

    jrun(bam, fasta, out, cfg=JCfg(batch_size=64),
         call_cfg=JCall(show_ref=True), params=jparams, contigs=contigs,
         chunk_size=chunk_size, compress=False, progress=False,
         pileup_backend="host")
    return _rows(out)


@pytest.mark.parametrize("phased", [False, True])
@pytest.mark.parametrize("indel", [False, True])
def test_param_spec_equals_jax(phased, indel):
    import functools

    import jax
    from clair3_rna_tpu.models.network import init_params as jinit
    from clair3_rna_tpu.parallel.mesh import _spec_for_module as jspec

    # the JAX tree's shapes (the specs read nothing else)
    tree = jax.eval_shape(functools.partial(
        jinit, 0, add_indel_length=indel, phased=phased))
    net = init_params(0, add_indel_length=indel, phased=phased, device="cpu")
    dirs = {"forward": "fwd", "backward": "bwd"}
    for tp in (1, 2, 4, 8):
        port_specs = ShardedNet(net, make_mesh(devices=CPU8, tp=tp)).specs
        seen = 0

        def check(path, leaf):
            nonlocal seen
            keys = [p.key for p in path]
            module = tree
            for k in keys[:-1]:
                module = module[k]
            want = jspec(module, keys[-1], leaf, tp)
            want = list(want).index("tp") if "tp" in tuple(want) \
                else REPLICATE
            got = _spec_for_module(module, keys[-1], leaf, tp)
            name = ".".join(dirs.get(k, k) for k in keys)
            assert got == want == port_specs[name], (tp, name, got, want)
            seen += 1

        jax.tree_util.tree_map_with_path(check, tree)
        assert seen == len(port_specs) == len(list(net.parameters()))
    # the L4 kernel is row-parallel with its bias replicated, the LSTM
    # gates column-parallel, the logits replicated
    assert port_specs["l4.kernel"] == 0 and port_specs["l4.bias"] == REPLICATE
    assert port_specs["lstm1.fwd.kernel"] == 1
    assert port_specs["gt21_logits.kernel"] == REPLICATE


def test_mesh_calling_matches_single_device(tmp_path):
    """test_parallel_calling.py:16 on a port mesh of 8 repeated CPU
    devices, host route at tp 1 and 2, fused route at tp 2."""
    from clair3_rna_torch import simdata
    from clair3_rna_torch.caller.pipeline import batch_wire
    from clair3_rna_torch.io.fasta import FastaFile
    from clair3_rna_torch.pileup.chunk import build_chunk_tensors, open_bam

    fasta, bam, _, _ = simdata.make_dataset(
        tmp_path, seed=41, contig_len=8000, n_variants=20, depth=30)
    jparams, net = _weights()
    cfg = PileupConfig(batch_size=64)
    call_cfg = CallConfig(show_ref=True)
    single = str(tmp_path / "single.vcf")
    run_calling(bam, fasta, single, cfg=cfg, call_cfg=call_cfg, params=net,
                contigs=["chr1"], chunk_size=3000, compress=False,
                progress=False, pileup_backend="host")
    want = _rows(single)
    assert len(want) > 0
    assert want == _jax_host(fasta, bam, str(tmp_path / "jax.vcf"), jparams,
                             ["chr1"], 3000)

    records = build_chunk_tensors(open_bam(bam), FastaFile(fasta),
                                  ChunkTask("chr1", 0, 8000), cfg)
    wire, codes = batch_wire(records[:150], cfg)
    _, wfwd = make_wire_forward_fn()
    one = wfwd(net, wire, codes)
    model, _ = make_forward_fn()
    for tp, backends in ((1, ("host",)), (2, ("host", "fused"))):
        mesh = make_mesh(n_devices=8, tp=tp, devices=CPU8)
        sharded = shard_params(net, mesh)
        probs = wfwd(sharded, wire, codes)
        if tp == 1:
            assert torch.equal(probs, one)
        else:
            np.testing.assert_allclose(probs.numpy(), one.numpy(), rtol=0,
                                       atol=1e-5)
        for backend in backends:
            out = str(tmp_path / f"mesh_tp{tp}_{backend}.vcf")
            run_calling(bam, fasta, out, cfg=cfg, call_cfg=call_cfg,
                        params=sharded,
                        forward=sharded_forward_fn(model, mesh),
                        contigs=["chr1"], chunk_size=3000, compress=False,
                        progress=False, pileup_backend=backend)
            assert _rows(out) == want, f"tp={tp} {backend} diverged"


def test_shard_tasks_partition():
    tasks = [ChunkTask("chr1", i * 100, (i + 1) * 100) for i in range(10)]
    parts = [tdist.shard_tasks(tasks, 3, s) for s in range(3)]
    assert sorted(sum([[t.start for t in p] for p in parts], [])) == \
        [t.start for t in tasks]
    sizes = [len(p) for p in parts]
    assert max(sizes) - min(sizes) <= 1
    with pytest.raises(ValueError):
        tdist.shard_tasks(tasks, 3, 3)


def test_sharded_merge_matches_single_host(tmp_path):
    fasta, bam = _dataset(tmp_path, 51, [("chr1", 9000), ("chr2", 6000)], 15)
    jparams, net = _weights()
    cfg = PileupConfig(batch_size=64)
    call_cfg = CallConfig(show_ref=True)
    _, forward = make_wire_forward_fn()
    contigs = ["chr1", "chr2"]
    single = str(tmp_path / "single.vcf")
    run_calling(bam, fasta, single, cfg=cfg, call_cfg=call_cfg, params=net,
                forward=forward, contigs=contigs, chunk_size=2500,
                compress=False, progress=False)
    assert _rows(single) == _jax_host(fasta, bam, str(tmp_path / "jax.vcf"),
                                      jparams, contigs, 2500)
    for n_shards in (1, 4):
        work = str(tmp_path / f"work{n_shards}")
        for shard_id in range(n_shards):
            tdist.run_sharded_calling(
                bam, fasta, work, cfg=cfg, call_cfg=call_cfg, params=net,
                forward=forward, contigs=contigs, n_shards=n_shards,
                shard_id=shard_id, chunk_size=2500)
        merged = str(tmp_path / f"merged{n_shards}.vcf")
        tdist.merge_shards(work, n_shards, merged, show_ref=True,
                           compress=False,
                           qual_cutoff=cfg.effective_qual_cutoff)
        assert _rows(merged) == _rows(single), f"{n_shards}-shard diverged"
    assert len(_rows(single)) > 0


def test_sharded_resume_skips_completed(tmp_path):
    """A shard retried with resume=True reuses its manifests."""
    fasta, bam = _dataset(tmp_path, 52, [("chr1", 6000)], 10)
    net = init_params(0, device="cpu")
    cfg = PileupConfig(batch_size=64)
    call_cfg = CallConfig(show_ref=True)
    work = str(tmp_path / "work")
    kw = dict(cfg=cfg, call_cfg=call_cfg, params=net, forward=None,
              contigs=["chr1"], n_shards=1, shard_id=0, chunk_size=3000)
    stats1 = tdist.run_sharded_calling(bam, fasta, work, **kw)
    assert stats1.candidates > 0
    stats2 = tdist.run_sharded_calling(bam, fasta, work, resume=True, **kw)
    assert stats2.candidates == 0, "resume should skip completed work"
    merged = str(tmp_path / "merged.vcf")
    _, n_rows, _ = tdist.merge_shards(work, 1, merged, show_ref=True,
                                      compress=False)
    assert n_rows == len(_rows(merged)) > 0
    with pytest.raises(FileNotFoundError, match="shard_0001"):
        tdist.merge_shards(work, 2, str(tmp_path / "m2.vcf"))


def test_shard_tasks_lpt_partition_and_balance():
    """Every task lands on exactly one shard and the makespan beats
    round-robin on a skewed cost vector (a few chunks cost 20x)."""
    tasks = [ChunkTask("chr1", i * 100, (i + 1) * 100) for i in range(64)]
    costs = [1.0] * 64
    for i in range(0, 64, 16):
        costs[i] = 20.0  # deep islands, round-robin stacks them on shard 0
    parts = [tdist.shard_tasks_lpt(tasks, 4, s, costs) for s in range(4)]
    starts = sorted(t.start for p in parts for t in p)
    assert starts == [t.start for t in tasks]

    def makespan(parts_):
        by_start = {t.start: c for t, c in zip(tasks, costs)}
        return max(sum(by_start[t.start] for t in p) for p in parts_)

    rr = [tdist.shard_tasks(tasks, 4, s) for s in range(4)]
    assert makespan(parts) < makespan(rr)
    assert makespan(parts) <= sum(costs) / 4 * 1.1
    with pytest.raises(ValueError, match="align"):
        tdist.shard_tasks_lpt(tasks, 4, 0, costs[:-1])


def test_estimate_chunk_costs_equal_jax(tmp_path):
    from clair3_rna_tpu.parallel.distributed import (
        estimate_chunk_costs as jcosts)

    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.fasta import write_fasta

    rng = random.Random(57)
    genome = simdata.random_genome(rng, [("chr1", 40_000)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=20)
    fasta, bam = str(tmp_path / "ref.fa"), str(tmp_path / "reads.bam")
    write_fasta(fasta, genome)
    simdata.simulate_bam(bam, genome, variants, rng, depth=15,
                         extra_regions={"chr1": [(20_000, 30_000, 150)]})
    tasks = [ChunkTask("chr1", s, s + 10_000) for s in range(0, 40_000,
                                                            10_000)]
    costs = tdist.estimate_chunk_costs(bam, tasks)  # builds the .bai itself
    assert costs is not None and len(costs) == 4
    # the deep island chunk reads as heavy (the byte-proportional part)
    fixed = tdist.CHUNK_FIXED_COST_CBYTES
    assert costs[2] - fixed > 3 * (costs[0] - fixed)
    # the same estimates as the JAX package's on the same BAI
    from clair3_rna_tpu.pileup.chunk import ChunkTask as JTask
    assert jcosts(bam, [JTask(t.ctg_name, t.start, t.end)
                        for t in tasks]) == costs


def test_run_shards_with_retry_recovers_crashed_shard(tmp_path):
    """An injected shard crash recovers through resume, and the merge is
    identical to the single-process run."""
    fasta, bam = _dataset(tmp_path, 58, [("chr1", 9000), ("chr2", 6000)], 15)
    net = init_params(0, device="cpu")
    cfg = PileupConfig(batch_size=64)
    call_cfg = CallConfig(show_ref=True)
    contigs = ["chr1", "chr2"]
    single = str(tmp_path / "single.vcf")
    run_calling(bam, fasta, single, cfg=cfg, call_cfg=call_cfg, params=net,
                contigs=contigs, chunk_size=2500, compress=False,
                progress=False)
    work = str(tmp_path / "work")
    crashes = []

    def one_shard(shard_id, resume):
        st = tdist.run_sharded_calling(
            bam, fasta, work, cfg=cfg, call_cfg=call_cfg, params=net,
            forward=None, contigs=contigs, n_shards=3, shard_id=shard_id,
            chunk_size=2500, resume=resume)
        if shard_id == 1 and not crashes:
            crashes.append(1)  # crash AFTER manifests landed: the retry
            raise RuntimeError("injected shard crash")  # must not redo them
        return st

    stats = tdist.run_shards_with_retry(one_shard, 3)
    assert len(stats) == 3 and crashes
    assert stats[1].candidates == 0
    merged = str(tmp_path / "merged.vcf")
    tdist.merge_shards(work, 3, merged, show_ref=True, compress=False,
                       qual_cutoff=cfg.effective_qual_cutoff)
    assert _rows(merged) == _rows(single)

    def always_fails(shard_id, resume):
        raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError, match="persistent"):
        tdist.run_shards_with_retry(always_fails, 1, max_retries=1)


WORKER = textwrap.dedent("""
    import sys
    repo, work, bam, fasta, coord, n_proc, pid = sys.argv[1:8]
    sys.path.insert(0, repo)
    n_proc, pid = int(n_proc), int(pid)
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist

    from clair3_rna_torch.parallel import distributed

    n, i = distributed.initialize(coordinator_address=coord,
                                  num_processes=n_proc, process_id=pid)
    assert (n, i) == (n_proc, pid), (n, i)
    assert dist.get_world_size() == n_proc

    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.models.network import init_params

    stats = distributed.run_sharded_calling(
        bam, fasta, work, cfg=PileupConfig(batch_size=64),
        call_cfg=CallConfig(show_ref=True),
        params=init_params(0, device="cpu"), forward=None,
        contigs=["chr1", "chr2"], n_shards=n_proc, shard_id=pid,
        chunk_size=2500)
    dist.barrier()
    dist.destroy_process_group()
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax",
                                       "clair3_rna_tpu")]
    print("SHARD_DONE", pid, stats.rows, flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_calling(tmp_path):
    """tests/test_multiprocess_distributed.py:56 on the port: two processes
    join one gloo group on localhost, each calls its shard, and the merge
    equals the single-process body."""
    fasta, bam = _dataset(tmp_path, 61, [("chr1", 8000), ("chr2", 5000)], 14)
    single = str(tmp_path / "single.vcf")
    run_calling(bam, fasta, single, cfg=PileupConfig(batch_size=64),
                call_cfg=CallConfig(show_ref=True),
                params=init_params(0, device="cpu"), contigs=["chr1", "chr2"],
                chunk_size=2500, compress=False, progress=False)
    work = str(tmp_path / "work")
    worker_py = str(tmp_path / "worker.py")
    with open(worker_py, "w") as f:
        f.write(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, worker_py, REPO, work, bam, fasta, coord, "2",
         str(pid)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        finally:
            if p.poll() is None:
                p.kill()
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\nstdout:{out}\nstderr:{err[-2000:]}"
        assert "SHARD_DONE" in out
    merged = str(tmp_path / "merged.vcf")
    tdist.merge_shards(work, 2, merged, show_ref=True, compress=False,
                       qual_cutoff=PileupConfig().effective_qual_cutoff,
                       reference_file_path=fasta)
    assert _rows(merged) == _rows(single)
    assert len(_rows(merged)) > 10
    assert tdist.initialize(num_processes=1) == (1, 0)


def test_default_mesh(monkeypatch):
    from clair3_rna_torch.caller.driver import default_mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = default_mesh(tp=2, device=torch.device("cuda"))
    assert mesh.shape == {"dp": 2, "tp": 2}
    assert mesh.devices == [[torch.device("cuda", 0), torch.device("cuda", 1)],
                            [torch.device("cuda", 2), torch.device("cuda", 3)]]
    assert default_mesh(device=torch.device("cpu")) is None
    with pytest.raises(ValueError, match="not divisible"):
        default_mesh(tp=3, device=torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert default_mesh(device=torch.device("cuda")) is None


def test_call_shards_and_merge_shards_cli(tmp_path):
    """`call --n_shards 2 --shard_id 0|1` then `merge_shards` equals one
    `call`; --n_shards without --shard_id refuses to run."""
    from clair3_rna_torch import simdata
    from clair3_rna_torch.cli import main

    fasta, bam, _, _ = simdata.make_dataset(
        tmp_path, seed=42, contig_len=6000, n_variants=12, depth=30)
    base = ["-B", bam, "-R", fasta, "--device", "cpu", "--include_all_ctgs",
            "--print_ref_calls", "--chunk_size", "2000", "--no_compress",
            "-t", "1"]
    outputs, _ = main(["call", "-o", str(tmp_path / "one"), *base])
    work = str(tmp_path / "shards")
    with pytest.raises(SystemExit, match="requires --shard_id"):
        main(["call", "-o", work, *base, "--n_shards", "2"])
    for shard_id in (0, 1):
        out, stats = main(["call", "-o", work, *base, "--n_shards", "2",
                           "--shard_id", str(shard_id), "--pileup_backend",
                           "fused"])
        assert out == [] and stats.candidates > 0
    merged = main(["merge_shards", "--work_dir", work, "--n_shards", "2",
                   "--output_fn", str(tmp_path / "merged.vcf"), "--ref_fn",
                   fasta, "--show_ref", "--no_compress"])
    assert _rows(merged[0]) == _rows(outputs[0])
    assert len(_rows(merged[0])) > 0


def test_dryrun_multichip_cpu(capsys):
    from clair3_rna_torch.parallel.dryrun import dryrun_multichip

    result = dryrun_multichip(8, device="cpu")
    assert (result["dp"], result["tp"]) == (4, 2)
    assert np.isfinite(result["loss"]) and result["rows"] > 5
    assert "dryrun_multichip OK: 8 devices (dp=4, tp=2" in \
        capsys.readouterr().out


@pytest.mark.cuda
def test_mesh_forward_on_card():
    """A mesh of repeated cuda:0 (dp 2 x tp 2, and dp 4 x tp 1): tp=1
    probabilities bit-identical to one card, tp=2 within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    net = init_params(3, device="cuda")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-30, 30, (300, 33, 18))
                         .astype(np.float32)).cuda()
    with torch.inference_mode():
        one = net(x)
    for tp in (1, 2):
        mesh = make_mesh(devices=[torch.device("cuda", 0)] * 4, tp=tp)
        got = sharded_forward_fn(None, mesh)(shard_params(net, mesh), x)
        if tp == 1:
            assert torch.equal(got, one)
        else:
            assert float((got - one).abs().max()) <= 1e-5
