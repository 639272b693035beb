"""The benchmark's generator: deterministic, shaped as its traffic file says,
and readable by the program's BAM reader."""

import hashlib
import os

import numpy as np

from callbench.gen.bam import write_sample
from callbench.gen.simulate import (DEL, INS, SNP, gene_depths, gene_layout,
                                     make_contig)
from callbench.tests.small import GENES, SKEW

SEED = 2**31 + 4242


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_same_seed_same_bytes(tmp_path):
    a, b, c = (tmp_path / "a", tmp_path / "b", tmp_path / "c")
    for d in (a, b, c):
        d.mkdir()
    ia = write_sample(SKEW, SEED, 1, str(a))
    ib = write_sample(SKEW, SEED, 1, str(b))
    ic = write_sample(SKEW, SEED + 1, 1, str(c))
    for key in ("bam", "fasta"):
        assert _digest(ia[key]) == _digest(ib[key])
    assert _digest(ia["bam"]) != _digest(ic["bam"])
    assert ia["read_bases"] == ib["read_bases"] > 0


def test_shape_matches_traffic():
    ctg = make_contig(GENES, SEED, 0)
    v, p, L = ctg.variants, ctg.plan, ctg.length
    assert len(v.pos) == GENES["variants_per_contig"]
    assert np.diff(v.pos).min() >= 40
    kinds = np.bincount(v.kind, minlength=3) / len(v.kind)
    assert 0.75 < kinds[SNP] < 0.97 and kinds[INS] + kinds[DEL] > 0.03
    depth = np.zeros(L)
    n_bases = subs = ins = dels = 0
    for blk in ctg.blocks(with_query=False):
        np.add.at(depth, blk.al_pos, 1)
        n_bases += len(blk.al_pos)
        subs += int((blk.al_code != ctg.ref[blk.al_pos]).sum())
        ins, dels = ins + len(blk.ins_read), dels + len(blk.del_read)
    # every gene at one of the Zipf depths (the exons' middles, where the
    # transcript ends do not thin it), no aligned base inside an intron
    width, exonic, first = gene_layout(GENES, L)
    intron = width - exonic
    seen = []
    for g in range(GENES["genes"]):
        g0 = g * width
        mid = np.concatenate([depth[g0 + 500:g0 + first - 500],
                              depth[g0 + first + intron + 500:g0 + width - 500]])
        seen.append(mid.mean())
        assert depth[g0 + first:g0 + first + intron].max() == 0
    want = np.sort(gene_depths(GENES))
    assert np.all(np.abs(np.sort(seen) - want) < 0.15 * want), (seen, want)
    # spliced reads skip their gene's intron whole
    spliced = p.intron_lo >= 0
    assert spliced.sum() > 20
    assert ((p.intron_lo[spliced] % width == first)
            & (p.intron_hi[spliced] - p.intron_lo[spliced] == intron)).all()
    assert ((p.start[spliced] < p.intron_lo[spliced])
            & (p.end[spliced] > p.intron_hi[spliced])).all()
    # read lengths and the error mix, as the traffic states them (indel
    # errors are kept off planted variants and each other: a few fewer)
    aligned = p.end - p.start - np.where(spliced, p.intron_hi - p.intron_lo, 0)
    assert abs(np.median(aligned) / GENES["read_len_median"] - 1) < 0.1
    rate, mix = np.mean(GENES["error_rate"]), GENES["error_mix"]
    for kind, seen_rate in (("sub", subs), ("ins", ins), ("del", dels)):
        assert abs(seen_rate / n_bases / (rate * mix[kind]) - 1) < 0.25, kind
    assert dels > ins > 0
    assert (np.diff(p.start) >= 0).all()


def test_program_reads_every_record(tmp_path):
    from clair3_rna_torch.io.bam import BamReader

    info = write_sample(SKEW, SEED, 0, str(tmp_path))
    ctg = make_contig(SKEW, SEED, 0)
    recs = list(BamReader(info["bam"], load_index=False))
    assert len(recs) == len(ctg.plan.start)
    seqs, cigars = [], []
    for blk in ctg.blocks():
        q = np.frombuffer(b"ACGT", np.uint8)[blk.q_code].tobytes().decode()
        seqs += [q[blk.q_off[i]:blk.q_off[i + 1]] for i in range(blk.n)]
        cigars += blk.cigars
    for i, rec in enumerate(recs):
        assert rec.pos == ctg.plan.start[i]
        assert rec.seq == seqs[i]
        assert [tuple(c) for c in rec.cigar] == [tuple(c) for c in cigars[i]]
        assert rec.is_reverse == bool(ctg.plan.strand[i])
        assert rec.mapq == ctg.plan.mapq[i]
    assert sum(len(s) for s in seqs) == info["read_bases"]
    assert os.path.getsize(info["fasta"] + ".fai") > 0
