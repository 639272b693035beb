"""Plain NumPy pileup of a simulated contig: candidates, their 33-row
tensors and allele summaries, straight from the generator's read arrays.

It follows Clair3-RNA's pileup semantics (create_tensor_pileup.py: samtools
mpileup columns, the 18 channels of shared/param_p.py, the AF and coverage
tests, the reference-channel negation, the 1.5 x max_depth
renormalisation of clair3_rna/utils.py) for what the benchmark's traffic
contains: M/I/D/N alignments, MAPQ 20-60, no secondary or duplicate flags,
no head/tail calling and no splice padding. Counts come from the reads the
generator drew, not from the BAM the program reads.

Ranks give the order in which a column first shows each allele (the
reference's Counter insertion order): 2 x the read's index in coordinate
order for its base, + 1 for the indel that follows it.
"""

from dataclasses import dataclass

import numpy as np

FLANK = 16
N_CH = 18
# channel layout (shared/param_p.py:31): A C G T I I1 D D1 * / a c g t i i1 d d1 #
CH_I, CH_I1, CH_D, CH_D1, CH_STAR = 4, 5, 6, 7, 8
REV = 9
GROUP_I, GROUP_D = 4, 5
INF = np.int64(1) << 60
BASES = "ACGT"


@dataclass
class Candidates:
    contig: str
    pos: np.ndarray          # int64 0-based centers
    tensors: np.ndarray      # int32 [n, 33, C], as the network takes them
    depth: np.ndarray        # int64
    ref_seq: list            # 33-base windows
    alt_data: list           # (depth, {allele: count}) in the reference's order


def _max_allele(pos, strand, allele, width):
    """Per (position, strand): reads of the most supported single allele."""
    out = np.zeros((width, 2), np.int32)
    if len(pos) == 0:
        return out
    n_all = int(allele.max()) + 1
    key = (pos * 2 + strand) * n_all + allele
    uniq, cnt = np.unique(key, return_counts=True)
    ps = uniq // n_all
    np.maximum.at(out, (ps // 2, ps % 2), cnt.astype(np.int32))
    return out


def pileup(ctg, params):
    """Candidates of one contig (callbench.gen.simulate.Contig) under the
    configuration's calling parameters."""
    L = ctg.length
    plan = ctg.plan
    use = plan.mapq >= params["min_mq"]
    counts = np.zeros((L, N_CH), np.int64)
    base_rank = np.full(L * 4, INF, np.int64)
    cover = np.zeros(L + 1, np.int64)
    np.add.at(cover, plan.start[use], 1)
    np.add.at(cover, plan.end[use], -1)
    ins_parts, del_parts, ins_seq = [], [], []
    for blk in ctg.blocks(with_query=False):
        keep = use[blk.al_read]
        pos, code, read = blk.al_pos[keep], blk.al_code[keep], blk.al_read[keep]
        strand = plan.strand[read].astype(np.int64)
        lo, hi = int(pos.min()), int(pos.max()) + 1
        counts[lo:hi, :N_CH] += np.bincount(
            (pos - lo) * N_CH + code + REV * strand,
            minlength=(hi - lo) * N_CH).reshape(hi - lo, N_CH)
        np.minimum.at(base_rank, pos * 4 + code, 2 * read)
        k = use[blk.ins_read]
        ins_parts.append((blk.ins_anchor[k], blk.ins_read[k]))
        ins_seq += [seq for seq, ok in zip(blk.ins_seq, k) if ok]
        k = use[blk.del_read]
        del_parts.append((blk.del_anchor[k], blk.del_read[k], blk.del_len[k]))
    ip, i_read = (np.concatenate(a).astype(np.int64) for a in zip(*ins_parts))
    dp, d_read, dln = (np.concatenate(a).astype(np.int64) for a in zip(*del_parts))
    ist = plan.strand[i_read].astype(np.int64)
    dst = plan.strand[d_read].astype(np.int64)
    i_rank, d_rank = 2 * i_read + 1, 2 * d_read + 1

    np.add.at(counts, (ip, CH_I + REV * ist), 1)
    np.add.at(counts, (dp, CH_D + REV * dst), 1)
    # '*' (forward) / '#' (reverse) at every deleted position
    star = np.repeat(dp + 1, dln) + (np.arange(int(dln.sum()))
                                     - np.repeat(np.cumsum(dln) - dln, dln))
    np.add.at(counts, (star, CH_STAR + REV * np.repeat(dst, dln)), 1)
    seq_ids = {}
    allele = np.array([seq_ids.setdefault(seq, len(seq_ids)) for seq in ins_seq],
                      np.int64)
    imax = _max_allele(ip, ist, allele, L)
    counts[:, CH_I1], counts[:, CH_I1 + REV] = imax[:, 0], imax[:, 1]
    dmax = _max_allele(dp, dst, dln, L)
    counts[:, CH_D1], counts[:, CH_D1 + REV] = dmax[:, 0], dmax[:, 1]

    ref = ctg.ref.astype(np.int64)
    rows = np.arange(L)
    gc = np.zeros((L, 6), np.int64)
    gc[:, :4] = counts[:, 0:4] + counts[:, REV:REV + 4]
    ins_total = counts[:, CH_I] + counts[:, CH_I + REV]
    del_total = counts[:, CH_D] + counts[:, CH_D + REV]
    star_total = counts[:, CH_STAR] + counts[:, CH_STAR + REV]
    gc[:, GROUP_I], gc[:, GROUP_D] = ins_total, del_total
    base_total = gc[:, :4].sum(axis=1)
    depth = base_total + star_total
    alt_count = base_total - gc[rows, ref]
    ref_count = np.maximum(0, depth - (del_total + star_total) - ins_total
                           - alt_count)
    covered = np.cumsum(cover[:-1]) > 0

    grank = np.full((L, 6), INF, np.int64)
    grank[:, :4] = base_rank.reshape(L, 4)
    np.minimum.at(grank[:, GROUP_I], ip, i_rank)
    np.minimum.at(grank[:, GROUP_D], dp, d_rank)

    # pass_af (create_tensor_pileup.py:267-299, 535-556)
    denom = np.where(depth > 0, depth, 1).astype(np.float64)
    non_ref = gc[:, :4].copy()
    non_ref[rows, ref] = 0
    pass_snp = (non_ref / denom[:, None] >= params["snp_min_af"]).any(axis=1)
    pass_indel = ((ins_total / denom >= params["indel_min_af"])
                  | (del_total / denom >= params["indel_min_af"]))
    key = (gc << 32) - np.minimum(grank, 1 << 31)
    key[gc == 0] = np.iinfo(np.int64).min
    top = key.argmax(axis=1)
    pass_top = (gc[rows, top] > 0) & (top != ref)
    mask = covered & (pass_top | pass_snp | pass_indel) \
        & (depth >= params["min_coverage"])

    # a window is emitted when its covered run spans the whole 33 rows
    idx = np.arange(L)
    run_start = np.maximum.accumulate(np.where(
        covered & np.concatenate(([True], ~covered[:-1])), idx, -1))
    run_end = np.minimum.accumulate(np.where(
        covered & np.concatenate((~covered[1:], [True])), idx, L + 1)[::-1])[::-1]
    cand = np.nonzero(mask)[0]
    cand = cand[(run_start[cand] <= cand - FLANK) & (run_end[cand] >= cand + FLANK)]

    # the tensor image: the reference base's channels hold -(strand depth)
    img = counts.copy()
    img[rows, ref] = -counts[:, 0:4].sum(axis=1)
    img[rows, ref + REV] = -counts[:, REV:REV + 4].sum(axis=1)
    win = cand[:, None] + np.arange(-FLANK, FLANK + 1)[None, :]
    tensors = img[win]
    cdepth = depth[cand]
    max_depth = params["max_depth"]
    deep = cdepth > max_depth * 1.5
    if deep.any():  # clair3_rna/utils.py:88-92: scale, then truncate
        tensors[deep] = (tensors[deep] / (cdepth[deep, None, None] / max_depth)
                         ).astype(np.int64)
    text = ctg.ref_text()

    ins_order = np.argsort(ip, kind="stable")
    del_order = np.argsort(dp, kind="stable")
    ip_s, dp_s = ip[ins_order], dp[del_order]
    alt = []
    for c in cand.tolist():
        rb = BASES[ref[c]]
        entries = [(int(grank[c, k]), "X" + BASES[k], int(gc[c, k]))
                   for k in range(4) if k != ref[c] and gc[c, k]]
        groups = {}
        for j in ins_order[np.searchsorted(ip_s, c):np.searchsorted(ip_s, c, "right")]:
            k = "I" + rb + ins_seq[j]
            n, r = groups.get(k, (0, INF))
            groups[k] = (n + 1, min(r, int(i_rank[j])))
        for j in del_order[np.searchsorted(dp_s, c):np.searchsorted(dp_s, c, "right")]:
            k = "D" + text[c + 1:c + 1 + int(dln[j])]
            n, r = groups.get(k, (0, INF))
            groups[k] = (n + 1, min(r, int(d_rank[j])))
        entries += [(r, k, n) for k, (n, r) in groups.items()]
        entries.sort(key=lambda e: e[0])
        d = {k: n for _, k, n in entries}
        if ref_count[c] > 0:
            d["R" + rb] = int(ref_count[c])
        alt.append((int(depth[c]), d))
    ref_seq = [text[c - FLANK:c + FLANK + 1] for c in cand.tolist()]
    return Candidates(ctg.name, cand.astype(np.int64),
                      tensors.astype(np.int32), cdepth.astype(np.int64),
                      ref_seq, alt)
