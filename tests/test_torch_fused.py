"""The port's fused chunk pass against the JAX package's.

One staged chunk goes through the JAX package's
make_fused_fn(scatter="xla", mode="packed") and through the port's
make_fused_fn (its tilelet plain version on the CPU). Integer columns --
the header's candidate count, candidate positions, group counts and ranks,
ref count, depth, host flags, the raw renorm windows -- must match exactly;
probabilities within rtol 5e-5 / atol 5e-6 (tests/test_model_parity.py's
CPU bound), and the 0/1 prescreen column exactly.
"""

import random

import numpy as np
import pytest
import torch

from clair3_rna_torch.models.params_io import params_from_numpy
from clair3_rna_torch.ops import fused_pileup as tfp

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)

RTOL, ATOL = 5e-5, 5e-6
CONTIG = 30_000


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.fasta import write_fasta

    tmp = tmp_path_factory.mktemp("torch_fused")
    rng = random.Random(61)
    genome = simdata.random_genome(rng, [("chr1", CONTIG)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=90)
    fasta, bam = str(tmp / "ref.fa"), str(tmp / "reads.bam")
    write_fasta(fasta, genome)
    # a splice region and a ~280x island, so splice and renorm flags fire
    simdata.simulate_bam(bam, genome, variants, rng, depth=25,
                         splice_sites={"chr1": [(9_000, 10_500)]},
                         extra_regions={"chr1": [(20_000, 22_000, 260)]})
    return fasta, bam


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _params():
    from clair3_rna_tpu.models.network import init_params

    jp = init_params(5)
    return jp, params_from_numpy(_to_numpy(jp), device="cpu")


def _chunk(dataset, cfg, lo, hi):
    """(JAX PackedReads, port PackedReads, ref codes) for core [lo, hi)."""
    from clair3_rna_torch.pileup import chunk as tchunk
    from clair3_rna_torch.pileup.packed import extract_region_packed as tx
    from clair3_rna_tpu.io.fasta import FastaFile
    from clair3_rna_tpu.pileup import chunk as jchunk
    from clair3_rna_tpu.pileup.packed import extract_region_packed as jx

    fasta, bam = dataset
    row_lo, row_hi = max(0, lo - 33), min(CONTIG, hi + 33)
    codes = jchunk.ref_codes_from(FastaFile(fasta).fetch("chr1", row_lo,
                                                         row_hi))
    jdata = jx(jchunk.open_bam(bam), "chr1", row_lo, row_hi, cfg)
    tdata = tx(tchunk.open_bam(bam), "chr1", row_lo, row_hi, cfg)
    return jdata, tdata, codes


CASES = {
    "v2": dict(wire="v2"),
    "nibble": dict(wire="nibble"),
    "renorm_fold": dict(wire="v2", fold=True),
    "splice_head_tail": dict(wire="v2", splice=True, head_tail=True),
    "known_sites": dict(wire="v2", known=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_output_matches_jax(dataset, case):
    from clair3_rna_tpu.config import PileupConfig as JCfg
    from clair3_rna_tpu.ops import fused_pileup as jfp

    from clair3_rna_torch.config import PileupConfig as TCfg

    c = CASES[case]
    kw = dict(enable_splice_padding=c.get("splice", False),
              enable_head_tail=c.get("head_tail", False))
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    jp, net = _params()
    jdata, tdata, codes = _chunk(dataset, jcfg, 0, CONTIG)
    cand_allow = None
    if c.get("known"):
        cand_allow = np.zeros(len(codes), np.int8)
        cand_allow[np.random.default_rng(3).choice(len(codes), 200)] = 1
    budget = 1024
    jst = jfp.stage_chunk_packed(jdata, codes, jcfg, 0, CONTIG,
                                 scatter="xla", cand_allow=cand_allow,
                                 wire=c["wire"])
    jfn = jfp.make_fused_fn(jp, jcfg, max_candidates=budget, scatter="xla",
                            mode="packed", wire=c["wire"],
                            known_only=c.get("known", False),
                            with_renorm_windows=c.get("fold", False))
    want = np.asarray(jfn(*jfp.staged_packed_args(jst)))

    tst = tfp.stage_chunk_packed(tdata, codes, tcfg, 0, CONTIG,
                                 cand_allow=cand_allow, wire=c["wire"])
    tfn = tfp.make_fused_fn(net, tcfg, max_candidates=budget,
                            wire=c["wire"], known_only=c.get("known", False),
                            with_renorm_windows=c.get("fold", False))
    got = tfn(tfp.staged_tensors(tst, "cpu"),
              (tst.core_lo, tst.core_hi)).numpy()

    assert got.shape == want.shape
    n = int(want[0, 0])
    assert 20 < n <= budget and got[0, 0] == want[0, 0]
    body_w, body_g = want[1:1 + budget], got[1:1 + budget]
    P = body_w.shape[1] - 12
    np.testing.assert_array_equal(body_g[:, 0], body_w[:, 0])
    np.testing.assert_array_equal(body_g[:, P:], body_w[:, P:])
    np.testing.assert_allclose(body_g[:, 1:P], body_w[:, 1:P], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got[1 + budget:], want[1 + budget:])
    flags = body_w[:n, -1].astype(int)
    if c.get("fold"):
        assert (flags & 1).any(), "no renorm-depth candidate in the island"
    if c.get("splice"):
        assert (flags & 2).any(), "no splice-trigger flag"


def test_windows_fetch_matches_jax(dataset):
    """`sel` mode returns the raw negated count windows at given centers
    (the renorm re-read), exactly."""
    from clair3_rna_tpu.config import PileupConfig as JCfg
    from clair3_rna_tpu.ops import fused_pileup as jfp

    from clair3_rna_torch.config import PileupConfig as TCfg

    jp, net = _params()
    jdata, tdata, codes = _chunk(dataset, JCfg(), 18_000, 24_000)
    sel = np.array([30, 2_000, 2_033, 3_100, 5_000, 6_040], np.int32)
    jst = jfp.stage_chunk_packed(jdata, codes, JCfg(), 18_000, 24_000,
                                 scatter="xla", wire="v2")
    jfn = jfp.make_fused_fn(jp, JCfg(), scatter="xla", mode="packed",
                            wire="v2")
    want = np.asarray(jfn(*jfp.staged_packed_args(jst), sel=sel))
    tst = tfp.stage_chunk_packed(tdata, codes, TCfg(), 18_000, 24_000,
                                 wire="v2")
    got = tfp.make_fused_fn(net, TCfg(), wire="v2")(
        tfp.staged_tensors(tst, "cpu"), (tst.core_lo, tst.core_hi),
        sel=torch.from_numpy(sel)).numpy()
    assert np.abs(want).max() > 200  # deep island windows
    np.testing.assert_array_equal(got, want)


def test_events_mode_not_ported(monkeypatch):
    monkeypatch.setenv("CLAIR3_RNA_TORCH_FUSED_MODE", "events")
    with pytest.raises(NotImplementedError, match="K3"):
        tfp.resolve_mode()
