"""What decides `correct`: the program's outputs of the window against the
plain reference, computed after the window from the generator's reads.

Four numbers, each beside its limit (the cell's `checks`):

- missing_candidates: reference candidates whose 33-row tensor is not among
  the rows the program fed its network, over the jobs sampled for capture
  (the program may feed more rows: halo duplicates, and the fused route's
  deep windows before their renormalisation; those are not counted);
- prob_gap: the widest gap between the program's probabilities and the
  reference network's (float32, TF32 off) on the same candidates;
- row_mismatch: VCF rows of every job of the window that differ from the
  rows the frozen decoder makes of the program's own probabilities (the
  reference follows the program one stage here, and the stage it skips is
  checked by prob_gap);
- ref_row_mismatch: calls (contig, position, REF, ALT, genotype) of the
  first job of each contig that differ from the calls the frozen decoder
  makes of the reference's own probabilities, so that the decoder also runs
  on inputs the program did not compute.

The decoder is a frozen copy of the program's: these numbers hold decode to
a snapshot of itself, which catches a later change to it, not a fault that
both copies share. The reference imports nothing of the program.
"""

import gzip
import multiprocessing
import os
from collections import Counter
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from callbench.reference import decode
from callbench.reference.pileup import FLANK

_REF_GT21 = np.array([0, 4, 7, 9])   # AA CC GG TT in the gt21 order
_CODE = {b: i for i, b in enumerate("ACGT")}


def contig_candidates(traffic, seed, index, params):
    """The reference's candidates of one contig (run in a child)."""
    from callbench.gen.simulate import make_contig
    from callbench.reference.pileup import pileup
    return pileup(make_contig(traffic, seed, index), params)


def all_candidates(traffic, seed, params, indices):
    """contig index -> Candidates, a spawned child a contig."""
    indices = list(indices)
    with ProcessPoolExecutor(
            max_workers=max(1, min(len(indices), os.cpu_count() or 1)),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = {i: pool.submit(contig_candidates, traffic, seed, i, params)
                for i in indices}
        return {i: f.result() for i, f in futs.items()}


def _row_keys(tensors):
    t = np.ascontiguousarray(tensors, dtype=np.int32)
    return [r.tobytes() for r in t.reshape(len(t), -1)]


def match(cands, prog_x, prog_p):
    """Program probabilities of each reference candidate, looked up by its
    tensor among the rows the program fed its network -> (probs [n, 24]
    with NaN rows where missing, number missing)."""
    table = {}
    nonzero = np.abs(prog_x).reshape(len(prog_x), -1).sum(axis=1) > 0
    for k, p in zip(_row_keys(prog_x[nonzero]), prog_p[nonzero]):
        table.setdefault(k, p)
    out = np.full((len(cands.pos), prog_p.shape[1] if len(prog_p) else 24),
                  np.nan, np.float32)
    missing = 0
    for i, k in enumerate(_row_keys(cands.tensors)):
        p = table.get(k)
        if p is None:
            missing += 1
        else:
            out[i] = p
    return out[:, :24], missing


def expected_rows(cands, probs, qual_cutoff):
    """VCF body rows of one contig from the candidates and probabilities:
    the homozygous-reference prescreen, the frozen decoder, then the sort
    step's reference-row drop and LowQual mark."""
    probs = np.asarray(probs, np.float32)
    center = np.array([_CODE[s[FLANK]] for s in cands.ref_seq], np.int64)
    ref_p = probs[np.arange(len(probs)), _REF_GT21[center]]
    certain_ref = (probs[:, 21] >= 0.5) & (ref_p >= 0.5)
    idx = np.nonzero(~certain_ref)[0]
    rows = decode.decode_batch(
        [cands.contig] * len(idx), [int(cands.pos[i]) + 1 for i in idx],
        [cands.ref_seq[i] for i in idx], [cands.alt_data[i] for i in idx],
        probs[idx], decode.CallConfig())
    by_pos = {}
    for row in rows:
        cols = row.split("\t")
        if cols[4] == "." or cols[3] == cols[4]:
            continue
        if qual_cutoff and float(cols[5]) <= qual_cutoff:
            cols[6] = "LowQual"
        by_pos[int(cols[1])] = "\t".join(cols)
    return [by_pos[p] for p in sorted(by_pos)]


def vcf_body(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return [line.rstrip("\n") for line in f if not line.startswith("#")]


def _calls(rows):
    """(contig, position, REF, ALT, genotype) of each VCF row."""
    out = set()
    for row in rows:
        cols = row.split("\t")
        out.add((cols[0], cols[1], cols[3], cols[4], cols[9].split(":")[0]))
    return out


def judge(cands_by_contig, ref_probs, captures, bodies, qual_cutoff):
    """The numbers of one run.

    cands_by_contig / ref_probs: contig name -> reference Candidates / their
    reference probabilities. captures: [(contig, x [m, 33, C], p [m, 24+])]
    of the sampled jobs. bodies: [(contig, [VCF body rows])] of every job,
    in the window's order. -> {name: number}.
    """
    missing, gap = 0, 0.0
    prog_probs = {}
    for ctg, x, p in captures:
        cands = cands_by_contig[ctg]
        probs, miss = match(cands, x, p)
        missing += miss
        ok = ~np.isnan(probs[:, 0])
        if ok.any():
            gap = max(gap, float(np.abs(probs[ok] - ref_probs[ctg][ok]).max()))
        if ctg not in prog_probs:
            prog_probs[ctg] = np.where(ok[:, None], probs, ref_probs[ctg])
    expected = {ctg: expected_rows(cands_by_contig[ctg],
                                   prog_probs.get(ctg, ref_probs[ctg]),
                                   qual_cutoff)
                for ctg in cands_by_contig}
    mismatch = 0
    first = {}
    for ctg, rows in bodies:
        first.setdefault(ctg, rows)
        diff = Counter(rows)
        diff.subtract(Counter(expected[ctg]))
        mismatch += sum(abs(v) for v in diff.values())
    ref_mismatch = sum(
        len(_calls(rows) ^ _calls(expected_rows(cands_by_contig[ctg],
                                                ref_probs[ctg], qual_cutoff)))
        for ctg, rows in first.items())
    return {"missing_candidates": missing, "prob_gap": gap,
            "row_mismatch": mismatch, "ref_row_mismatch": ref_mismatch}
