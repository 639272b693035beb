"""The phased second pass (`call --enable_phasing_model`) of the port on the
CPU, held to the JAX package's: first pass, phase + haplotag, 30-channel
re-call. The port's host and fused routes must write the JAX package's
output_enable_phasing.vcf body with the same npz weights; the fused route's
phased re-call (phased tilelet expansion, the hp side channel, the renorm
fold at 30 channels) must equal the JAX host route with no whole-chunk
fallback; and the two resume grains of tests/test_phased_resume.py (chunk
manifests in tmp_phased, the phase+haplotag marker) must hold.
"""

import json
import os
import random
import shutil

import numpy as np
import pytest
import torch

from clair3_rna_torch import simdata
from clair3_rna_torch.caller import pipeline as tpl
from clair3_rna_torch.cli import main as tmain

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANNED = [0, 10_000, 20_000, 30_000, 40_000, 50_000]


def _body(path):
    return [line for line in open(path) if not line.startswith("#")]


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _records(reader_cls, path):
    reader = reader_cls(path)
    return [(r.name, r.flag, ctg, r.pos, r.mapq, list(map(tuple, r.cigar)),
             r.seq, bytes(r.qual), dict(r.tags))
            for ctg in reader.references for r in reader.fetch(ctg)]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """tests/test_phased_resume.py's dataset (seed 77, chr1 60 kb, 160
    variants, depth 30); first-pass weights: the port's random init saved
    as npz; phased weights: the committed trained BENCH_WEIGHTS_PHASED.npz.
    Both packages load both files through their own params_io."""
    from clair3_rna_torch.io.fasta import write_fasta
    from clair3_rna_torch.models.network import init_params
    from clair3_rna_torch.models.params_io import save_params

    tmp = tmp_path_factory.mktemp("torch_phased")
    rng = random.Random(77)
    genome = simdata.random_genome(rng, [("chr1", 60_000)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=160)
    fasta, bam = str(tmp / "ref.fa"), str(tmp / "reads.bam")
    write_fasta(fasta, genome)
    simdata.simulate_bam(bam, genome, variants, rng, depth=30)
    weights = save_params(str(tmp / "w.npz"), init_params(0, device="cpu"))
    return {"fasta": fasta, "bam": bam, "weights": weights,
            "phased_weights": os.path.join(REPO, "BENCH_WEIGHTS_PHASED.npz"),
            "tmp": tmp}


def _args(d, out, resume=False, extra=()):
    # small batches so the cross-chunk inference queue drains mid-contig
    # (chunk manifest lines only land once a chunk's candidates drain)
    args = ["call", "-B", d["bam"], "-R", d["fasta"], "-o", out,
            "--include_all_ctgs", "--no_compress", "--chunk_size", "10000",
            "--batch_size", "32", "--enable_phasing_model",
            "--phaser", "builtin", "--model_path", d["weights"],
            "--phased_model_path", d["phased_weights"], *extra]
    return args + (["--resume"] if resume else [])


def _port_args(d, out, backend, resume=False, extra=()):
    return _args(d, out, resume, ["--device", "cpu", "--pileup_backend",
                                  backend, *extra])


@pytest.fixture(scope="module")
def jax_run(dataset):
    """One two-pass run of the JAX package: its output directory."""
    from clair3_rna_tpu.cli import main as jmain

    out = str(dataset["tmp"] / "jax")
    jmain(_args(dataset, out))
    assert _body(os.path.join(out, "output_enable_phasing.vcf"))
    return out


@pytest.fixture(scope="module")
def port_host_run(dataset):
    """One two-pass run of the port on the host route: (out dir, stats)."""
    out = str(dataset["tmp"] / "port_host")
    _, stats = tmain(_port_args(dataset, out, "host"))
    return out, stats


def _spy_expand(monkeypatch):
    """Record the `phased` flag of every tilelet expansion call."""
    from clair3_rna_torch.ops import tilelet as ttl

    seen = []
    orig = ttl.expand

    def spy(*a, **k):
        seen.append(k.get("phased", False))
        return orig(*a, **k)

    monkeypatch.setattr(ttl, "expand", spy)
    return seen


@pytest.mark.parametrize("backend", ["host", "fused"])
def test_two_pass_matches_jax(dataset, jax_run, port_host_run, backend,
                              monkeypatch):
    """Both VCF bodies, the tagged BAM's records and the marker's stamp
    equal the JAX package's. The fused run takes the phased tilelet
    expansion in its second pass with no whole-chunk fallback, and
    --remove_intermediate_dir removes tmp and tmp_phased."""
    from clair3_rna_torch.io.bam import BamReader as TBam
    from clair3_rna_tpu.io.bam import BamReader as JBam

    if backend == "host":
        out, stats = port_host_run
    else:
        out = str(dataset["tmp"] / "port_fused")
        seen = _spy_expand(monkeypatch)
        _, stats = tmain(_port_args(dataset, out, "fused",
                                    extra=["--remove_intermediate_dir"]))
        assert True in seen and False in seen
        for s in (stats, stats.phased):
            assert s.fused["fallback_chunks"] == 0
        for sub in ("tmp", "tmp_phased"):
            assert not os.path.exists(os.path.join(out, sub))
    for name in ("output.vcf", "output_enable_phasing.vcf"):
        assert _body(os.path.join(out, name)) == \
            _body(os.path.join(jax_run, name)), name
    tagged = "phased_tagged.bam"
    assert _records(TBam, os.path.join(out, tagged)) == \
        _records(JBam, os.path.join(jax_run, tagged))
    stamp = json.load(open(os.path.join(out, tagged + ".done.json")))
    want = json.load(open(os.path.join(jax_run, tagged + ".done.json")))
    assert stamp.pop("first_pass_vcf") == os.path.join(out, "output.vcf")
    want.pop("first_pass_vcf")
    assert stamp == want
    assert stats.phased is not None and stats.phased.phased is None
    assert stats.phased.candidates > 0 and stats.phased.phase_s > 0


def test_phase_bam_cli_matches_jax(dataset, jax_run, tmp_path):
    """The port's `phase_bam` subcommand on the JAX run's first-pass VCF
    writes the JAX run's tagged records."""
    from clair3_rna_torch.io.bam import BamReader

    out_bam = str(tmp_path / "tagged.bam")
    tmain(["phase_bam", "--bam_fn", dataset["bam"], "--ref_fn",
           dataset["fasta"], "--vcf_fn", os.path.join(jax_run, "output.vcf"),
           "--output_bam_fn", out_bam])
    got = _records(BamReader, out_bam)
    assert got == _records(BamReader,
                           os.path.join(jax_run, "phased_tagged.bam"))
    assert any(r[-1].get("HP") in (1, 2) for r in got)


@pytest.mark.parametrize("case", ["depth28", "renorm250"])
def test_fused_phased_matches_jax(tmp_path, monkeypatch, case):
    """tests/test_fused_pileup.py:178 and :212 against the JAX package's
    host route: a phased (HP-tagged, 30-channel) run_calling on the port's
    host and fused routes, on 40 kb at depth 28, and on 3 kb at depth 250
    where every candidate takes the renorm fold."""
    from clair3_rna_torch.caller.decode import CallConfig as TCall
    from clair3_rna_torch.config import PileupConfig as TCfg
    from clair3_rna_torch.io.fasta import write_fasta
    from clair3_rna_torch.models.params_io import params_from_numpy
    from clair3_rna_tpu.caller.decode import CallConfig
    from clair3_rna_tpu.caller.pipeline import run_calling
    from clair3_rna_tpu.config import PileupConfig
    from clair3_rna_tpu.models.network import init_params

    seed, length, n_var, depth, chunk = {
        "depth28": (53, 40_000, 140, 28, 15_000),
        "renorm250": (57, 3_000, 10, 250, 3_000)}[case]
    rng = random.Random(seed)
    genome = simdata.random_genome(rng, [("chr1", length)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=n_var,
                                      het_genotypes=((0, 1), (1, 0)))
    fasta, bam = str(tmp_path / "ref.fa"), str(tmp_path / "reads.bam")
    write_fasta(fasta, genome)
    simdata.simulate_bam(bam, genome, variants, rng, depth=depth,
                         with_hp=True)
    jp = init_params(0, phased=True)
    net = params_from_numpy(_to_numpy(jp), device="cpu")
    run_calling(bam, fasta, str(tmp_path / "jax.vcf"),
                cfg=PileupConfig(batch_size=256, phased=True),
                call_cfg=CallConfig(show_ref=True), params=jp,
                contigs=["chr1"], chunk_size=chunk, compress=False,
                progress=False, pileup_backend="host")
    want = _body(str(tmp_path / "jax.vcf"))
    assert len(want) > (30 if case == "depth28" else 3)
    seen = _spy_expand(monkeypatch)
    for backend in ("host", "fused"):
        out = str(tmp_path / f"{backend}.vcf")
        _, stats = tpl.run_calling(
            bam, fasta, out, cfg=TCfg(batch_size=256, phased=True),
            call_cfg=TCall(show_ref=True), params=net, contigs=["chr1"],
            chunk_size=chunk, compress=False, progress=False,
            pileup_backend=backend)
        assert _body(out) == want, backend
    assert seen and all(seen)
    assert stats.fused["fallback_chunks"] == 0
    if case == "renorm250":
        assert stats.fused["renorm_candidates"] > 0
        assert stats.fused["renorm_fold_chunks"] > 0


def test_crash_in_second_pass_resumes(dataset, jax_run, tmp_path,
                                      monkeypatch):
    """tests/test_phased_resume.py:50 on the port: the re-call dies on its
    fifth planned chunk; phase + haplotag is marked done, and --resume
    restores the first pass whole, does not re-phase (the tagged BAM is not
    rewritten) and redoes exactly the unfinished second-pass chunks. The
    phased body equals the JAX package's uninterrupted run. The crash is
    keyed on the chunk (phased config, start), not on call order, because
    two prefetch threads build chunks. (The host route: both routes share
    run_calling's manifests and prefetch pool, and
    tests/test_torch_calling.py crashes the fused route's first pass.)"""
    target, name = tpl, "build_chunk_tensors"

    def key(a):      # (bam, fasta, task, cfg, ...)
        return bool(a[3].phased), a[2].start
    orig = getattr(target, name)

    def crashing(*a, **k):
        if key(a) == (True, PLANNED[4]):
            raise RuntimeError("injected crash")
        return orig(*a, **k)

    out = str(tmp_path / "crash")
    monkeypatch.setattr(target, name, crashing)
    with pytest.raises(RuntimeError, match="injected crash"):
        tmain(_port_args(dataset, out, "host"))
    monkeypatch.undo()
    tagged = os.path.join(out, "phased_tagged.bam")
    assert os.path.exists(tagged + ".done.json")
    tagged_mtime = os.stat(tagged).st_mtime_ns
    lines = [json.loads(line) for line in open(
        os.path.join(out, "tmp_phased", "chr1.chunks.jsonl"))]
    assert 1 <= len(lines) <= 4
    restored = {rec["start"] for rec in lines}
    assert PLANNED[4] not in restored

    redone = []

    def counting(*a, **k):
        redone.append(key(a))
        return orig(*a, **k)

    monkeypatch.setattr(target, name, counting)
    tmain(_port_args(dataset, out, "host", resume=True))
    assert os.stat(tagged).st_mtime_ns == tagged_mtime
    assert sorted(redone) == [(True, s)
                              for s in sorted(set(PLANNED) - restored)]
    assert _body(os.path.join(out, "output_enable_phasing.vcf")) == \
        _body(os.path.join(jax_run, "output_enable_phasing.vcf"))


def test_marker_mismatch_redoes_phasing(dataset, jax_run, port_host_run,
                                        tmp_path, monkeypatch):
    """tests/test_phased_resume.py:106 on the port: a resume whose marker
    no longer matches the first-pass VCF re-runs phase + haplotag; a
    matching marker does not."""
    from clair3_rna_torch.phasing import pipeline as tpp

    out = str(tmp_path / "o")
    shutil.copytree(port_host_run[0], out)
    marker = os.path.join(out, "phased_tagged.bam.done.json")
    stamp = json.load(open(marker))
    stamp["first_pass_vcf"] = os.path.join(out, "output.vcf")
    json.dump(stamp, open(marker, "w"))
    orig = tpp.phase_and_haplotag
    redone = []

    def spy(*a, **k):
        redone.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(tpp, "phase_and_haplotag", spy)
    tmain(_port_args(dataset, out, "host", resume=True))
    assert not redone
    stamp["vcf_body_sha1"] = "0" * 40
    json.dump(stamp, open(marker, "w"))
    tmain(_port_args(dataset, out, "host", resume=True))
    assert redone
    assert json.load(open(marker))["vcf_body_sha1"] != "0" * 40
    assert _body(os.path.join(out, "output_enable_phasing.vcf")) == \
        _body(os.path.join(jax_run, "output_enable_phasing.vcf"))


def test_second_pass_with_loaded_weights(dataset, port_host_run, tmp_path):
    """caller/driver.run_second_pass, the function `call
    --enable_phasing_model` runs, given the phased weights already loaded
    and the first pass's VCF, writes the two-pass run's phased body and
    tagged records. Its phase + haplotag record: the four spans (the
    three inside `phase`, `phase` inside phase_s), records written equal
    records read, tagged reads within them, the same counters as the
    call's; under a profiler each span is a range on the calling
    thread."""
    from torch.profiler import ProfilerActivity, profile

    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.caller.driver import run_second_pass
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.io.bam import BamReader
    from clair3_rna_torch.models.network import make_wire_forward_fn
    from clair3_rna_torch.models.params_io import (load_params,
                                                   params_from_numpy)

    first_out, call_stats = port_host_run
    params = params_from_numpy(load_params(dataset["phased_weights"]),
                               device="cpu")
    _, forward = make_wire_forward_fn()
    out = str(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outputs, stats = run_second_pass(
            dataset["bam"], dataset["fasta"],
            os.path.join(first_out, "output.vcf"), out,
            cfg=PileupConfig(batch_size=32), call_cfg=CallConfig(),
            params=params, forward=forward, contigs=["chr1"],
            chunk_size=10000, compress=False, progress=False,
            pileup_backend="host", device="cpu")
    assert outputs[0] == os.path.join(out, "output_enable_phasing.vcf")
    assert _body(outputs[0]) == \
        _body(os.path.join(first_out, "output_enable_phasing.vcf"))
    tagged = os.path.join(out, "phased_tagged.bam")
    assert _records(BamReader, tagged) == _records(
        BamReader, os.path.join(first_out, "phased_tagged.bam"))
    assert os.path.exists(tagged + ".bai")
    assert json.load(open(tagged + ".done.json"))["first_pass_vcf"] == \
        os.path.join(first_out, "output.vcf")

    ph = stats.phase
    inner = ph["scan_s"] + ph["link_s"] + ph["rewrite_s"]
    assert min(ph["scan_s"], ph["link_s"], ph["rewrite_s"]) > 0
    assert inner <= ph["phase_s"] <= stats.phase_s
    assert ph["records_written"] == ph["records_read"] > 0
    tagged_reads = ph["tagged_hp1"] + ph["tagged_hp2"]
    assert 0 < tagged_reads <= ph["records_written"]
    assert ph["tagged_hp1"] > 0 and ph["tagged_hp2"] > 0
    assert 0 < ph["phase_blocks"] <= ph["het_sites"] // 2
    hp = [r[-1].get("HP", 0) for r in _records(BamReader, tagged)]
    assert (hp.count(1), hp.count(2), len(hp)) == (
        ph["tagged_hp1"], ph["tagged_hp2"], ph["records_written"])
    counters = {k: v for k, v in ph.items() if not k.endswith("_s")}
    assert counters == {k: v for k, v in call_stats.phased.phase.items()
                        if not k.endswith("_s")}

    threads = {}
    for e in prof.events():
        if e.name.startswith("phase") or e.name == "call.head":
            threads.setdefault(e.name, set()).add(e.thread)
    assert set(threads) == {"phase", "phase.scan", "phase.link",
                            "phase.rewrite", "call.head"}
    # one thread: the one that ran the re-call's head
    assert len(set().union(*threads.values())) == 1
