"""Vectorised simulation of an RNA long-read sample from a seed.

One contig at a time: a random genome, planted germline variants (SNPs and
1-3 bp indels, at least 40 bp apart), and RNA reads drawn from the genes
that tile it: two exons around an intron each, expressed at depths that
follow Zipf's law over the genes' ranks, with log-normal read lengths and
per-read error rates split into substitutions, insertions and deletions.
Reads come out in coordinate order, in blocks, each block with its flat
arrays:

- the aligned bases (reference position, base code, read index): what a
  pileup counts;
- the query sequence and qualities as the BAM stores them;
- the applied insertions (anchor, inserted codes) and deletions (anchor,
  length), and each read's CIGAR.

The same (seed, traffic, contig index) gives the same arrays in any process,
so the BAM writer (gen/bam.py) and the plain reference (reference/pileup.py)
read one source. Every draw comes from numpy's Philox-free default
generator seeded with a SeedSequence of (seed, contig, stream, block).
"""

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

BASES = "ACGT"
SNP, INS, DEL = 0, 1, 2
# BAM CIGAR op codes
OP_M, OP_I, OP_D, OP_N = 0, 1, 2, 3
READS_PER_BLOCK = 2048
# base qualities: int(N(25, 5)) clipped to [10, 40], drawn as a uniform
# byte through the normal's quantiles at the 256 midpoints
_QUAL_TABLE = np.clip(np.array(
    [int(NormalDist(25.0, 5.0).inv_cdf((k + 0.5) / 256)) for k in range(256)]),
    10, 40).astype(np.uint8)


def _rng(seed, *stream):
    return np.random.default_rng(np.random.SeedSequence([int(seed) & (2**63 - 1), *stream]))


@dataclass
class Variants:
    pos: np.ndarray        # int64, sorted
    kind: np.ndarray       # int8: SNP / INS / DEL
    alt: np.ndarray        # int8: SNP alt code (else -1)
    del_len: np.ndarray    # int32: DEL length (else 0)
    ins: list              # INS inserted codes (uint8 arrays; None elsewhere)
    gt: np.ndarray         # bool [n, 2]: carried on haplotype 0 / 1


@dataclass
class ReadPlan:
    start: np.ndarray      # int64, coordinate order
    end: np.ndarray        # int64, exclusive reference end
    strand: np.ndarray     # int8, 1 = reverse
    hap: np.ndarray        # int8
    mapq: np.ndarray       # uint8
    error: np.ndarray      # float64 per-read error rate
    intron_lo: np.ndarray  # int64, -1 without an intron
    intron_hi: np.ndarray


@dataclass
class ReadBlock:
    first: int             # index of the block's first read in the contig
    n: int
    al_pos: np.ndarray     # int64 aligned reference positions, read-major
    al_code: np.ndarray    # uint8 base codes 0..3
    al_read: np.ndarray    # int64 read index (contig-wide)
    q_code: np.ndarray     # uint8 query bases, read-major (insertions inline)
    q_off: np.ndarray      # int64 [n + 1] offsets into q_code
    qual: np.ndarray       # uint8 phred, aligned with q_code
    ins_read: np.ndarray   # int64 read index of each applied insertion
    ins_anchor: np.ndarray  # int64
    ins_seq: list          # str inserted bases
    del_read: np.ndarray
    del_anchor: np.ndarray
    del_len: np.ndarray
    cigars: list           # per read: list of (op, length)


@dataclass
class Contig:
    name: str
    ref: np.ndarray        # uint8 codes 0..3
    variants: Variants
    plan: ReadPlan
    traffic: dict
    seed: int
    index: int

    @property
    def length(self):
        return len(self.ref)

    def variant_at(self):
        """[L] int32: the index of the variant at each position, -1 for
        none."""
        if getattr(self, "_var_at", None) is None:
            self._var_at = np.full(self.length, -1, np.int32)
            self._var_at[self.variants.pos] = np.arange(
                len(self.variants.pos), dtype=np.int32)
        return self._var_at

    def near_variant(self):
        """[L] bool: within 4 bases of a planted variant, where no
        sequencing error is put."""
        if getattr(self, "_near", None) is None:
            edge = np.zeros(self.length + 1, np.int64)
            np.add.at(edge, np.maximum(self.variants.pos - 4, 0), 1)
            np.add.at(edge, np.minimum(self.variants.pos + 5, self.length), -1)
            self._near = np.cumsum(edge[:-1]) > 0
        return self._near

    def ref_text(self):
        return np.frombuffer(b"ACGT", np.uint8)[self.ref].tobytes().decode()

    def blocks(self, with_query=True):
        """The contig's reads, in coordinate order, block by block; without
        the query sequences, qualities and CIGARs unless with_query."""
        n = len(self.plan.start)
        for b, lo in enumerate(range(0, n, READS_PER_BLOCK)):
            yield _make_block(self, lo, min(n, lo + READS_PER_BLOCK), b,
                              with_query)


def contig_name(index):
    return f"chr{index + 1}"


def make_contig(traffic, seed, index):
    """Genome, variants and read plan of contig `index` of a traffic mix."""
    length = int(traffic["contig_len"])
    rng = _rng(seed, index, 0)
    ref = rng.integers(0, 4, length, dtype=np.uint8)
    variants = _plant_variants(traffic, ref, _rng(seed, index, 1))
    plan = _plan_reads(traffic, length, _rng(seed, index, 2))
    return Contig(contig_name(index), ref, variants, plan, traffic, seed,
                  index)


def _plant_variants(traffic, ref, rng):
    """n variants, one in each of n equal bins over [50, L - 50), at least
    40 bp apart; 30% indels (half insertions, half deletions, 1-3 bp)."""
    n = int(traffic["variants_per_contig"])
    lo, hi = 50, len(ref) - 50
    width = (hi - lo) // n
    if width < 44:
        raise ValueError("variants too dense for a 40 bp spacing")
    pos = lo + np.arange(n, dtype=np.int64) * width \
        + rng.integers(0, width - 40, n)
    r = rng.random(n)
    indel = float(traffic.get("indel_fraction", 0.3))
    kind = np.where(r > indel, SNP, np.where(r > indel / 2, INS, DEL)) \
        .astype(np.int8)
    shift = rng.integers(1, 4, n)
    alt = np.where(kind == SNP, (ref[pos] + shift) % 4, -1).astype(np.int8)
    lens = rng.integers(1, 4, n).astype(np.int32)
    del_len = np.where(kind == DEL, lens, 0).astype(np.int32)
    ins_codes = rng.integers(0, 4, (n, 3), dtype=np.uint8)
    ins = [ins_codes[i, :lens[i]].copy() if kind[i] == INS else None
           for i in range(n)]
    genotypes = [tuple(g) for g in traffic["het_genotypes"]] + [(1, 1)]
    gt = np.array(genotypes, dtype=bool)[rng.integers(0, len(genotypes), n)]
    return Variants(pos, kind, alt, del_len, ins, gt)


def read_length_mean(traffic):
    """Mean length of the traffic's reads: its log-normal clipped to its
    range, by quadrature over 4,096 normal quantiles."""
    z = np.array([NormalDist().inv_cdf((k + 0.5) / 4096) for k in range(4096)])
    lo, hi = traffic["read_len_range"]
    return float(np.clip(traffic["read_len_median"]
                         * np.exp(traffic["read_len_sigma"] * z), lo, hi).mean())


def gene_depths(traffic):
    """Depth of each expression rank: top depth / rank ** exponent (Zipf)."""
    ranks = np.arange(1, int(traffic["genes"]) + 1, dtype=np.float64)
    return traffic["zipf_top_depth"] / ranks ** traffic["zipf_exponent"]


def gene_layout(traffic, length):
    """(gene width, exonic length, first exon's length): genes tile the
    contig, each two exons around one intron."""
    width = length // int(traffic["genes"])
    exonic = width - int(traffic["intron_len"])
    return width, exonic, exonic // 2


def _plan_reads(traffic, length, rng):
    """Reads of every gene: the seed permutes which gene takes which Zipf
    depth, so every seed makes the same set of depths. A read is a stretch
    of its gene's transcript (its two exons joined); one that crosses the
    exon junction is spliced across the intron."""
    width, exonic, first = gene_layout(traffic, length)
    intron = width - exonic
    depth = gene_depths(traffic)[rng.permutation(int(traffic["genes"]))]
    n_reads = np.round(depth * exonic / read_length_mean(traffic)).astype(np.int64)
    gene = np.repeat(np.arange(len(depth)), n_reads)
    m = len(gene)
    lo_len, hi_len = traffic["read_len_range"]
    rlen = np.clip(np.round(traffic["read_len_median"] * np.exp(
        traffic["read_len_sigma"] * rng.standard_normal(m))),
        lo_len, min(hi_len, exonic)).astype(np.int64)
    t0 = (rng.random(m) * (exonic - rlen + 1)).astype(np.int64)
    t1 = t0 + rlen
    g0 = gene * width
    start = np.where(t0 < first, g0 + t0, g0 + intron + t0)
    end = np.where(t1 <= first, g0 + t1, g0 + intron + t1)
    spliced = (t0 < first) & (t1 > first)
    ilo = np.where(spliced, g0 + first, -1)
    ihi = np.where(spliced, g0 + first + intron, -1)
    lo_err, hi_err = traffic["error_rate"]
    error = rng.uniform(lo_err, hi_err, m)
    strand = (rng.random(m) < 0.5).astype(np.int8)
    hap = rng.integers(0, 2, m).astype(np.int8)
    mq_lo, mq_hi = traffic.get("mapq", [20, 60])
    mapq = rng.integers(mq_lo, mq_hi, m).astype(np.uint8)
    order = np.argsort(start, kind="stable")
    return ReadPlan(start[order], end[order], strand[order], hap[order],
                    mapq[order], error[order], ilo[order], ihi[order])


def _indel_errors(ctg, rng, u, rate, pos, lens, s_hi):
    """Insertion and deletion errors of a block's tokens -> (is insertion,
    anchor token, length), tokens ascending. An error sits at least 5 bases
    from any planted variant and from the error before it, and leaves a
    base of its segment after it, so no two events touch."""
    mix = ctg.traffic["error_mix"]
    sub = np.float32(mix["sub"])
    ins = np.float32(mix["sub"] + mix["ins"])
    every = np.float32(mix["sub"] + mix["ins"] + mix["del"])
    tok = np.nonzero((u >= rate * sub) & (u < rate * every))[0]
    lengths = np.asarray(ctg.traffic["indel_error_len"], np.float64)
    ln = 1 + np.searchsorted(np.cumsum(lengths / lengths.sum()),
                             rng.random(len(tok)), side="right")
    ln = np.minimum(ln, len(lengths))
    is_ins = u[tok] < rate[tok] * ins
    seg = np.searchsorted(np.cumsum(lens) - lens, tok, side="right") - 1
    room = np.where(is_ins, 1, ln + 1)
    ok = (~ctg.near_variant()[pos[tok]]) & (pos[tok] + room < s_hi[seg])
    ok &= np.diff(tok, prepend=-(1 << 40)) > 4
    return is_ins[ok], tok[ok], ln[ok].astype(np.int64)


def _make_block(ctg, lo, hi, block_index, with_query=True):
    """Reads [lo, hi) of the plan: sequences, CIGARs and flat arrays."""
    rng = _rng(ctg.seed, ctg.index, 3, block_index)
    p = ctg.plan
    n = hi - lo
    start, end = p.start[lo:hi], p.end[lo:hi]
    ilo, ihi = p.intron_lo[lo:hi], p.intron_hi[lo:hi]
    has_intron = ilo >= 0
    # segments: [start, end) or [start, ilo) + [ihi, end)
    seg_read = np.concatenate([np.arange(n), np.arange(n)[has_intron]])
    s_lo = np.concatenate([start, ihi[has_intron]])
    s_hi = np.concatenate([np.where(has_intron, ilo, end), end[has_intron]])
    order = np.lexsort((s_lo, seg_read))
    seg_read, s_lo, s_hi = seg_read[order], s_lo[order], s_hi[order]
    lens = s_hi - s_lo
    total = int(lens.sum())
    pos = np.arange(total, dtype=np.int32) + np.repeat(
        (s_lo - (np.cumsum(lens) - lens)).astype(np.int32), lens)
    tok_read = np.repeat(seg_read, lens)

    # variants carried by each token's read haplotype (looked at only where
    # a variant sits)
    var = ctg.variants
    at = np.nonzero(ctg.variant_at()[pos] >= 0)[0]
    v_at = ctg.variant_at()[pos[at]]
    seg_hi_at = np.repeat(s_hi, lens)[at] if len(at) else at
    carried = var.gt[v_at, p.hap[lo:hi][tok_read[at]]]
    kind = np.where(carried, var.kind[v_at], -1)
    dlen_at = var.del_len[v_at]
    snp_t = at[kind == SNP]
    ins_m = (kind == INS) & (pos[at] + 1 < seg_hi_at)
    del_m = (kind == DEL) & (pos[at] + dlen_at + 1 < seg_hi_at)
    i_tok, d_tok = at[ins_m], at[del_m]

    code = ctg.ref[pos]
    code[snp_t] = var.alt[v_at[kind == SNP]]
    # sequencing errors: each base draws once against its read's rate,
    # split into substitutions, insertions after it and deletions after it
    mix = ctg.traffic["error_mix"]
    rate = np.repeat(p.error[lo:hi].astype(np.float32),
                     np.bincount(seg_read, lens, n).astype(np.int64))
    u = rng.random(total, dtype=np.float32)
    hit = u < rate * np.float32(mix["sub"])
    hit[snp_t] = hit[i_tok] = hit[d_tok] = False
    n_hit = int(hit.sum())
    code[hit] = (code[hit] + rng.integers(1, 4, n_hit, dtype=np.uint8)) % 4
    e_ins, e_tok, e_len = _indel_errors(ctg, rng, u, rate, pos, lens, s_hi)
    i_tok = np.concatenate([i_tok, e_tok[e_ins]])
    d_tok = np.concatenate([d_tok, e_tok[~e_ins]])
    ins_seqs = [var.ins[v] for v in v_at[ins_m]] + [
        rng.integers(0, 4, k, dtype=np.uint8) for k in e_len[e_ins].tolist()]
    d_len = np.concatenate([dlen_at[del_m], e_len[~e_ins]]).astype(np.int64)
    order = np.argsort(i_tok, kind="stable")
    i_tok, ins_seqs = i_tok[order], [ins_seqs[k] for k in order.tolist()]
    order = np.argsort(d_tok, kind="stable")
    d_tok, d_len = d_tok[order], d_len[order]

    # deletions remove the next dlen tokens of the same segment
    keep = np.ones(total, bool)
    if len(d_tok):
        rm = np.repeat(d_tok + 1, d_len) + (
            np.arange(int(d_len.sum())) - np.repeat(np.cumsum(d_len) - d_len,
                                                    d_len))
        keep[rm] = False
    al_pos, al_code, al_read = pos[keep], code[keep], tok_read[keep] + lo

    if not with_query:
        return ReadBlock(
            first=lo, n=n, al_pos=al_pos, al_code=al_code, al_read=al_read,
            q_code=None, q_off=None, qual=None,
            ins_read=tok_read[i_tok] + lo, ins_anchor=pos[i_tok],
            ins_seq=["".join(BASES[c] for c in s) for s in ins_seqs],
            del_read=tok_read[d_tok] + lo, del_anchor=pos[d_tok],
            del_len=d_len, cigars=None)
    ins_lens = np.array([len(s) for s in ins_seqs], np.int64)
    ins_flat = np.concatenate(ins_seqs) if ins_seqs else np.zeros(0, np.uint8)
    # kept tokens before each insertion's anchor, + the anchor itself
    after = np.repeat(i_tok + 1 - np.searchsorted(np.nonzero(~keep)[0], i_tok),
                      ins_lens)
    q_code = np.insert(al_code, after, ins_flat)
    per_read = np.bincount(al_read - lo, minlength=n) + np.bincount(
        tok_read[i_tok], weights=ins_lens, minlength=n).astype(np.int64)
    q_off = np.concatenate([[0], np.cumsum(per_read)])
    qual = _QUAL_TABLE[rng.integers(0, 256, len(q_code), dtype=np.uint8)]

    # CIGARs from each read's events in reference order
    ev_read = np.concatenate([tok_read[i_tok], tok_read[d_tok]])
    ev_pos = np.concatenate([pos[i_tok], pos[d_tok]])
    ev_op = np.concatenate([np.full(len(i_tok), OP_I), np.full(len(d_tok), OP_D)])
    ev_len = np.concatenate([ins_lens, d_len])
    ev_order = np.lexsort((ev_pos, ev_read))
    ev_read, ev_pos, ev_op, ev_len = (a[ev_order] for a in
                                      (ev_read, ev_pos, ev_op, ev_len))
    bounds = np.searchsorted(ev_read, np.arange(n + 1))
    cigars = []
    s_l, e_l, il_l, ih_l = start.tolist(), end.tolist(), ilo.tolist(), ihi.tolist()
    evp, evo, evl = ev_pos.tolist(), ev_op.tolist(), ev_len.tolist()
    bl = bounds.tolist()
    for r in range(n):
        events = [(evp[k], evo[k], evl[k]) for k in range(bl[r], bl[r + 1])]
        if il_l[r] >= 0:
            events.append((il_l[r] - 1, OP_N, ih_l[r] - il_l[r]))
            events.sort()
        cur = s_l[r]
        ops = []
        for anchor, op, length in events:
            ops.append((OP_M, anchor + 1 - cur))
            ops.append((op, length))
            cur = anchor + 1 + (length if op in (OP_D, OP_N) else 0)
        ops.append((OP_M, e_l[r] - cur))
        cigars.append(ops)

    return ReadBlock(
        first=lo, n=n, al_pos=al_pos, al_code=al_code, al_read=al_read,
        q_code=q_code, q_off=q_off, qual=qual,
        ins_read=tok_read[i_tok] + lo, ins_anchor=pos[i_tok],
        ins_seq=["".join(BASES[c] for c in s) for s in ins_seqs],
        del_read=tok_read[d_tok] + lo, del_anchor=pos[d_tok], del_len=d_len,
        cigars=cigars)
