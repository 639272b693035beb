"""The 30-channel pileup of the phasing model: the 18 channels of
reference/pileup.py and 12 per-haplotype counts, from the generator's reads
and each read's HP (reference/phase.py).

Clair3-RNA's phased tensor (src/create_tensor_pileup.py:181-217, the
program's config.PHASED_CHANNELS) appends, per position, the reads tagged
HP 1 then HP 2: their A, C, G, T bases (both strands together), their
insertions (at the anchor base) and their deletions (at the anchor base).
Untagged reads add nothing there; the reference-base negation touches only
the first 18 channels; a window deeper than 1.5 x max_depth is scaled and
truncated over all 30 (clair3_rna/utils.py:88-92), as pileup.py does over
18. The candidates, their 18 channels and allele summaries are pileup.py's,
unchanged: a read's HP does not move a candidate.
"""

from dataclasses import replace

import numpy as np

from callbench.reference.pileup import FLANK

N_HP_CH = 12
_I, _D = 4, 5


def hp_image(ctg, hp, params):
    """int64 [L, 12] per-haplotype counts of a contig, given each read's
    HP."""
    plan = ctg.plan
    hp = np.asarray(hp, np.int64)
    use = plan.mapq >= params["min_mq"]
    tagged = use & (hp > 0)
    base = 6 * (hp - 1)
    img = np.zeros((ctg.length, N_HP_CH), np.int64)
    flat = img.reshape(-1)
    for blk in ctg.blocks(with_query=False):
        parts = []
        k = tagged[blk.al_read]
        parts.append(blk.al_pos[k] * N_HP_CH + base[blk.al_read[k]]
                     + blk.al_code[k])
        k = tagged[blk.ins_read]
        parts.append(blk.ins_anchor[k] * N_HP_CH + base[blk.ins_read[k]] + _I)
        k = tagged[blk.del_read]
        parts.append(blk.del_anchor[k] * N_HP_CH + base[blk.del_read[k]] + _D)
        idx = np.concatenate([p.astype(np.int64) for p in parts])
        if len(idx):
            lo, hi = int(idx.min()), int(idx.max()) + 1
            flat[lo:hi] += np.bincount(idx - lo, minlength=hi - lo)
    return img


def phased_windows(ctg, hp, params, cands):
    """int32 [n, 33, 12]: the candidates' windows of the per-haplotype
    counts, scaled where the candidate is deep."""
    img = hp_image(ctg, hp, params)
    win = cands.pos[:, None] + np.arange(-FLANK, FLANK + 1)[None, :]
    t = img[win]
    max_depth = params["max_depth"]
    deep = cands.depth > max_depth * 1.5
    if deep.any():
        t[deep] = (t[deep] / (cands.depth[deep, None, None] / max_depth)
                   ).astype(np.int64)
    return t.astype(np.int32)


def with_haplotypes(cands, windows):
    """The 18-channel candidates with their 12 per-haplotype channels
    appended: the 30-channel Candidates."""
    return replace(cands, tensors=np.concatenate(
        [cands.tensors, windows], axis=2).astype(np.int32))
