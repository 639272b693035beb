"""The port's mpileup-text emulation (clair3_rna_torch/pileup/text.py)
against the JAX package's: the hand-derived golden corpus of
tests/test_mpileup_golden.py and a simulated BAM with splices, indels and
haplotype tags must give the same columns, field for field.

The JAX package and the golden corpus are imported inside the tests, so
this file still collects where JAX is absent."""

import random

import pytest
import torch

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)


def _fields(columns):
    return [(c.pos, c.bases, c.depth, list(c.haplotypes)) for c in columns]


def _both(records, start, end, **kw):
    from clair3_rna_torch.pileup.text import pileup_columns as port
    from clair3_rna_tpu.pileup.text import pileup_columns as jax_side
    return (_fields(port(records, start, end, **kw)),
            _fields(jax_side(records, start, end, **kw)))


def test_golden_corpus_matches_jax_and_spec():
    """Every case of the golden corpus: the port's columns equal the JAX
    module's and the hand-derived expected strings."""
    from tests.test_mpileup_golden import CASES
    from clair3_rna_torch.pileup.text import pileup_columns
    assert len(CASES) > 10
    for name, reads, expected in CASES:
        port, ref = _both(reads, 0, 100)
        assert port == ref, name
        got = {c.pos: c for c in pileup_columns(reads, 0, 100)}
        assert set(got) == set(expected), name
        for pos, (bases, depth) in expected.items():
            assert (got[pos].bases, got[pos].depth) == (bases, depth), name


@pytest.mark.parametrize("case", ["low_bq", "window_edges", "haplotypes"])
def test_golden_edge_cases_match_jax(case):
    """The corpus's three stand-alone cases: low-BQ drops, window clipping
    of indel carriers and deletion bodies, per-entry haplotype tags."""
    from tests.test_mpileup_golden import Read
    from clair3_rna_torch.io.bam import CIGAR_D, CIGAR_M
    if case == "low_bq":
        reads = [Read(0, [(CIGAR_M, 3)], "ACG", qual=bytes([30, 3, 30]))]
        kw, span = {"min_bq": 10}, (0, 100)
    elif case == "window_edges":
        reads = [Read(8, [(CIGAR_M, 2), (CIGAR_D, 3), (CIGAR_M, 1)], "ACG")]
        kw, span = {}, (10, 12)
    else:
        reads = [Read(0, [(CIGAR_M, 1)], "A", tags={"HP": 1}),
                 Read(0, [(CIGAR_M, 1)], "C", tags={"HP": 2}),
                 Read(0, [(CIGAR_M, 1)], "G")]
        kw, span = {"with_haplotype": True}, (0, 100)
    port, ref = _both(reads, *span, **kw)
    assert port and port == ref


@pytest.mark.parametrize("min_bq,with_haplotype", [(0, False), (0, True),
                                                   (20, True)])
def test_simulated_bam_matches_jax(tmp_path, min_bq, with_haplotype):
    """A seeded simulated BAM with a splice junction, indels and HP tags:
    the port's pileup_columns_from_bam equals the JAX package's over the
    whole contig (each package reads the BAM with its own reader)."""
    from clair3_rna_torch import simdata
    from clair3_rna_torch.io.fasta import write_fasta
    from clair3_rna_torch.pileup.text import pileup_columns_from_bam as port
    from clair3_rna_tpu.pileup.text import pileup_columns_from_bam as ref

    rng = random.Random(31)
    genome = simdata.random_genome(rng, [("chr1", 6000)])
    variants = simdata.plant_variants(rng, genome, n_per_contig=40,
                                      indel_fraction=0.5)
    write_fasta(str(tmp_path / "ref.fa"), genome)
    bam = str(tmp_path / "reads.bam")
    simdata.simulate_bam(bam, genome, variants, rng, depth=20,
                         splice_sites={"chr1": [(2500, 3300)]},
                         with_hp=True, error_rate=0.05)
    got = _fields(port(bam, "chr1", 0, 6000, min_bq=min_bq,
                       with_haplotype=with_haplotype))
    want = _fields(ref(bam, "chr1", 0, 6000, min_bq=min_bq,
                       with_haplotype=with_haplotype))
    assert got == want
    text = "".join(c[1] for c in got)
    for mark in ("+", "-", ">", "<", "*", "#", "^", "$"):
        assert mark in text, mark  # splices, indels, both strands covered
    if with_haplotype:
        assert {"1", "2"} <= {h for c in got for h in c[3]}
