"""End-to-end calling: the port's run_calling on the CPU, host and fused
routes, against the JAX package's host route with the same weights. VCF
bodies must be identical (the JAX package's own fused-vs-host contract,
tests/test_fused_pileup.py), including the renorm-depth and isolated
splice-hatch escape paths and chunk-granular --resume.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from clair3_rna_torch.caller import pipeline as tpl
from clair3_rna_torch.caller.decode import CallConfig as TCall
from clair3_rna_torch.config import PileupConfig as TCfg
from clair3_rna_torch.models.params_io import params_from_numpy

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _weights(seed=0):
    from clair3_rna_tpu.models.network import init_params
    jp = init_params(seed)
    return jp, params_from_numpy(_to_numpy(jp), device="cpu")


def _dataset(tmp_path, seed, contig_len, n_variants, depth, splice=None,
             variants=None, **sim_kw):
    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.fasta import write_fasta

    rng = random.Random(seed)
    genome = simdata.random_genome(rng, [("chr1", contig_len)])
    if variants is None:
        variants = simdata.plant_variants(rng, genome,
                                          n_per_contig=n_variants)
    else:
        variants = variants(genome)
    fasta, bam = str(tmp_path / "ref.fa"), str(tmp_path / "reads.bam")
    write_fasta(fasta, genome)
    simdata.simulate_bam(bam, genome, variants, rng, depth=depth,
                         splice_sites={"chr1": [splice]} if splice else None,
                         **sim_kw)
    return fasta, bam


def _body(path):
    return [line for line in open(path) if not line.startswith("#")]


def _jax_host(fasta, bam, out, jparams, show_ref=True, cfg_kw=None, **kw):
    from clair3_rna_tpu.caller.decode import CallConfig
    from clair3_rna_tpu.caller.pipeline import run_calling
    from clair3_rna_tpu.config import PileupConfig

    run_calling(bam, fasta, out,
                cfg=PileupConfig(batch_size=256, **(cfg_kw or {})),
                call_cfg=CallConfig(show_ref=show_ref), params=jparams,
                contigs=["chr1"], compress=False, progress=False,
                pileup_backend="host", **kw)
    return _body(out)


def _port(fasta, bam, out, net, backend, show_ref=True, cfg_kw=None,
          batch_size=256, **kw):
    _, stats = tpl.run_calling(
        bam, fasta, out, cfg=TCfg(batch_size=batch_size, **(cfg_kw or {})),
        call_cfg=TCall(show_ref=show_ref), params=net, contigs=["chr1"],
        compress=False, progress=False, pileup_backend=backend, **kw)
    return _body(out), stats


@pytest.mark.parametrize("show_ref", [False, True])
def test_calling_matches_jax(tmp_path, show_ref):
    fasta, bam = _dataset(tmp_path, seed=41, contig_len=30_000,
                          n_variants=100, depth=30, splice=(14_000, 16_000))
    jp, net = _weights()
    want = _jax_host(fasta, bam, str(tmp_path / "jax.vcf"), jp, show_ref,
                     chunk_size=10_000)
    assert len(want) > 40
    for backend in ("host", "fused"):
        got, stats = _port(fasta, bam, str(tmp_path / f"{backend}.vcf"), net,
                           backend, show_ref, chunk_size=10_000)
        assert got == want, backend
    assert stats.fused["fallback_chunks"] == 0


def test_renorm_depth_matches_jax(tmp_path):
    """A ~260x island: its candidates need the reference's float64
    renormalization, taken on the host from the fused pass's raw windows."""
    fasta, bam = _dataset(tmp_path, seed=45, contig_len=8_000, n_variants=24,
                          depth=30, extra_regions={"chr1": [(3_000, 4_500,
                                                             230)]})
    jp, net = _weights()
    want = _jax_host(fasta, bam, str(tmp_path / "jax.vcf"), jp)
    host, _ = _port(fasta, bam, str(tmp_path / "host.vcf"), net, "host")
    fused, stats = _port(fasta, bam, str(tmp_path / "fused.vcf"), net,
                         "fused")
    assert len(want) > 5
    assert host == want and fused == want
    assert stats.fused["renorm_candidates"] > 0
    assert stats.fused["renorm_fold_chunks"] > 0
    assert stats.fused["fallback_chunks"] == 0


def test_isolated_splice_hatch_matches_jax(tmp_path):
    """An ISOLATED splice-trigger candidate rides the per-candidate host
    rebuild (the hatch) while the rest of the chunk stays fused."""
    from clair3_rna_torch import simdata

    def variants(genome):
        seq = genome["chr1"]
        return {"chr1": [
            simdata.Variant(p, seq[p],
                            next(b for b in "ACGT" if b != seq[p]), (0, 1))
            for p in (500, 1_500, 3_000 - 8, 4_600)]}

    fasta, bam = _dataset(tmp_path, seed=63, contig_len=6_000, n_variants=0,
                          depth=30, splice=(3_000, 3_200), variants=variants,
                          error_rate=0.0)
    jp, net = _weights()
    kw = dict(cfg_kw=dict(enable_splice_padding=True))
    want = _jax_host(fasta, bam, str(tmp_path / "jax.vcf"), jp, **kw)
    fused, stats = _port(fasta, bam, str(tmp_path / "fused.vcf"), net,
                         "fused", **kw)
    assert len(want) >= 3
    assert fused == want
    assert stats.fused["hatch_candidates"] > 0
    assert stats.fused["fallback_chunks"] == 0


@pytest.mark.parametrize("backend", ["host", "fused"])
def test_crash_resume_matches_jax(tmp_path, monkeypatch, backend):
    """A run that dies mid-contig leaves finished chunks in the chunk
    manifest; --resume redoes only the rest and the VCF body equals the JAX
    package's uninterrupted run."""
    from clair3_rna_torch.ops import fused_pileup as tfp

    fasta, bam = _dataset(tmp_path, seed=71, contig_len=40_000,
                          n_variants=120, depth=25)
    jp, net = _weights()
    want = _jax_host(fasta, bam, str(tmp_path / "jax.vcf"), jp,
                     chunk_size=8_000)
    assert len(want) > 40

    calls = []
    if backend == "host":
        target, name = tpl, "build_chunk_tensors"
    else:
        target, name = tfp.FusedChunkCaller, "call_chunk"
    orig = getattr(target, name)

    def crashing(*a, **k):
        calls.append(1)
        if len(calls) > 3:
            raise RuntimeError("injected crash")
        return orig(*a, **k)

    mdir = str(tmp_path / "manifests")
    monkeypatch.setattr(target, name, crashing)
    with pytest.raises(RuntimeError, match="injected crash"):
        _port(fasta, bam, str(tmp_path / "crashed.vcf"), net, backend,
              chunk_size=8_000, manifest_dir=mdir, batch_size=16)
    monkeypatch.undo()
    lines = [json.loads(line) for line in
             open(os.path.join(mdir, "chr1.chunks.jsonl"))]
    assert 1 <= len(lines) <= 3

    redone = []

    def counting(*a, **k):
        redone.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(target, name, counting)
    got, _ = _port(fasta, bam, str(tmp_path / "resumed.vcf"), net, backend,
                   chunk_size=8_000, manifest_dir=mdir, resume=True,
                   batch_size=16)
    assert got == want
    assert len(redone) == 5 - len(lines)
    assert os.path.exists(os.path.join(mdir, "chr1.done.json"))
