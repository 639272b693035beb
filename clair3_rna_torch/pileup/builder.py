"""Vectorized pileup tensor builder.

Re-designs the reference's streaming per-position loop
(src/create_tensor_pileup.py:85-302,461-637) as dense tile-wide array work:

  events -> channel-count image [L, 18(+12)] -> candidate mask -> 33-wide
  window gather at candidate centers -> tensor records.

The reference's 33-slot ring buffer, Counter tie-breaking, splice padding and
head/tail flush semantics are reproduced exactly (documented inline) so output
tensors are byte-identical; the *mechanism* (scatter counts + run-length
emission rules) is chosen to map onto TPU scatter/matmul kernels.
"""

from dataclasses import dataclass

import numpy as np

from clair3_rna_torch import config
from clair3_rna_torch.config import CHANNEL_INDEX, CHANNEL_SIZE, PHASED_CHANNEL_SIZE, PileupConfig
from clair3_rna_torch.pileup.events import PileupEvents

_BASES = "ACGT"
_CODE_FROM_BASE = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate(_BASES):
    _CODE_FROM_BASE[ord(_b)] = _i
    _CODE_FROM_BASE[ord(_b.lower())] = _i

# pileup_dict groups, in channel terms: A C G T (case merged), I, D
GROUP_A, GROUP_C, GROUP_G, GROUP_T, GROUP_I, GROUP_D = range(6)
_RANK_INF = np.int64(1) << 60


@dataclass
class TileFeatures:
    """Dense per-position features for one region [start, end)."""

    start: int
    end: int
    counts: np.ndarray        # [L, 18(+12)] int32, before ref-channel negation
    depth: np.ndarray         # [L] int32 (ACGT + */# entries)
    covered: np.ndarray       # [L] bool: an mpileup row exists here
    group_count: np.ndarray   # [L, 6] int32
    group_rank: np.ndarray    # [L, 6] int64 (first-occurrence order)
    ins_total: np.ndarray     # [L]
    del_total: np.ndarray     # [L] '-' events only
    star_total: np.ndarray    # [L]
    alt_count: np.ndarray     # [L] non-ref ACGT
    ref_count: np.ndarray     # [L]
    max_del_length: np.ndarray  # [L]
    max_skip: np.ndarray      # [L] max(read_start, read_end, skip_fwd, skip_rev)
    ref_code: np.ndarray      # [L] int8 true ref base code, -1 if not ACGT
    eff_ref_code: np.ndarray  # [L] int8 with non-ACGT mapped to A (evc_base_from)
    counts_negated: bool = False  # True when counts is already the emit image
                                  # (native finalize applied the negation)


class TensorRecord:
    """One emitted candidate window.

    alt_info ("depth-K1 c1 K2 c2 ...") is computed lazily: in the calling
    pipeline only the ~1% of sites surviving the homRef prescreen ever read
    it, so serializing every candidate's allele summary upfront would
    dominate host time (the reference pays this cost for every site,
    src/create_tensor_pileup.py:595-605)."""

    __slots__ = ("ctg_name", "position", "ref_seq", "tensor", "depth",
                 "_alt_info", "_alt_data", "_alt_thunk")

    def __init__(self, ctg_name, position, ref_seq, tensor, depth,
                 alt_info=None, alt_thunk=None):
        self.ctg_name = ctg_name
        self.position = position   # 1-based center position (VCF coordinate)
        self.ref_seq = ref_seq     # 33-base window reference sequence
        self.tensor = tensor       # [33, 18(+12)] int32
        self.depth = depth
        self._alt_info = alt_info
        self._alt_data = None
        self._alt_thunk = alt_thunk

    @property
    def alt_data(self) -> tuple:
        """(read_depth, {allele_key: count}) — parsed form of alt_info."""
        if self._alt_data is None:
            if self._alt_thunk is not None:
                self._alt_data = self._alt_thunk()
                self._alt_thunk = None
            else:
                from clair3_rna_torch.caller.decode import parse_alt_info
                self._alt_data = parse_alt_info(self._alt_info)
        return self._alt_data

    @property
    def alt_info(self) -> str:
        if self._alt_info is None:
            self._alt_info = format_alt_info(*self.alt_data)
        return self._alt_info

    def to_reference_row(self) -> str:
        """Serialize in the reference TSV format (create_tensor_pileup.py:597-603)."""
        flat = " ".join(
            " ".join(str(int(v)) for v in row) for row in self.tensor
        )
        return f"{self.ctg_name}\t{self.position}\t{self.ref_seq}\t{flat}\t{self.alt_info}"


def _pileup_backend():
    """Channel-count accumulation backend for the pure-array builder path:
    'host' (numpy bincount, default); 'device' and 'pallas' name the
    device count kernel (K4), not ported yet. The native C++ tile builder
    bypasses this entirely."""
    import os
    return os.environ.get("CLAIR3_RNA_TORCH_PILEUP_BACKEND", "host")


def _scatter_count(pos, extra_idx, width, n_extra):
    """bincount positions x small-index into a [width, n_extra] int32 image."""
    if len(pos) == 0:
        return np.zeros((width, n_extra), dtype=np.int32)
    backend = _pileup_backend()
    if backend in ("device", "pallas"):
        raise NotImplementedError(
            f"pileup backend {backend!r}: the device count kernel (K4) is "
            "not ported yet (ROADMAP Queue 2 K4)")
    linear = pos.astype(np.int64) * n_extra + extra_idx
    return np.bincount(linear, minlength=width * n_extra).reshape(width, n_extra).astype(np.int32)


def _max_per_allele(pos, strand, allele, width, n_alleles):
    """For each (pos, strand): the count of the most supported single allele."""
    out = np.zeros((width, 2), dtype=np.int32)
    if len(pos) == 0 or n_alleles == 0:
        return out
    key = (pos.astype(np.int64) * 2 + strand) * n_alleles + allele
    uniq, cnt = np.unique(key, return_counts=True)
    ps = uniq // n_alleles
    np.maximum.at(out, (ps // 2, ps % 2), cnt.astype(np.int32))
    return out


def _min_rank(pos, group, rank, width, n_groups, out=None):
    if out is None:
        out = np.full((width, n_groups), _RANK_INF, dtype=np.int64)
    if len(pos):
        np.minimum.at(out, (pos, group), rank)
    return out


def build_tile_features(events: PileupEvents, ref_codes: np.ndarray,
                        cfg: PileupConfig) -> TileFeatures:
    """Turn packed events into the dense per-position feature image."""
    start, end = events.start, events.end
    width = end - start
    n_channels = cfg.channel_size
    counts = np.zeros((width, n_channels), dtype=np.int32)

    bpos = events.base_pos - start
    spos = events.star_pos - start
    ipos = events.ins_pos - start
    dpos = events.del_pos - start

    # base channels: code + 9*strand -> A..T fwd / a..t rev
    base_ch = events.base_code.astype(np.int64) + 9 * events.base_strand
    counts[:, :] += _scatter_count(
        np.concatenate([bpos, spos]),
        np.concatenate([base_ch, np.where(events.star_strand == 0,
                                          CHANNEL_INDEX["*"], CHANNEL_INDEX["#"])]),
        width, n_channels,
    )
    # insertion / deletion totals by strand
    ins_ch = np.where(events.ins_strand == 0, CHANNEL_INDEX["I"], CHANNEL_INDEX["i"])
    del_ch = np.where(events.del_strand == 0, CHANNEL_INDEX["D"], CHANNEL_INDEX["d"])
    counts += _scatter_count(np.concatenate([ipos, dpos]),
                             np.concatenate([ins_ch, del_ch]), width, n_channels)
    # most-supported single allele counts (I1/i1, D1/d1)
    ins_max = _max_per_allele(ipos, events.ins_strand, events.ins_allele,
                              width, len(events.ins_seqs))
    counts[:, CHANNEL_INDEX["I1"]] = ins_max[:, 0]
    counts[:, CHANNEL_INDEX["i1"]] = ins_max[:, 1]
    n_del_alleles = int(events.del_len.max()) + 1 if len(events.del_len) else 0
    del_max = _max_per_allele(dpos, events.del_strand, events.del_len,
                              width, n_del_alleles)
    counts[:, CHANNEL_INDEX["D1"]] = del_max[:, 0]
    counts[:, CHANNEL_INDEX["d1"]] = del_max[:, 1]

    if cfg.phased:
        # 12 haplotype channels: ACGT+I+D split by HP tag 1 (P) / 2 (M),
        # strands merged (src/create_tensor_pileup.py:181-217)
        for hp, base_off in ((1, CHANNEL_SIZE), (2, CHANNEL_SIZE + 6)):
            sel = events.base_hp == hp
            counts += _scatter_count(bpos[sel],
                                     events.base_code[sel].astype(np.int64) + base_off,
                                     width, n_channels)
            sel = events.ins_hp == hp
            counts += _scatter_count(ipos[sel],
                                     np.full(int(sel.sum()), base_off + 4, dtype=np.int64),
                                     width, n_channels)
            sel = events.del_hp == hp
            counts += _scatter_count(dpos[sel],
                                     np.full(int(sel.sum()), base_off + 5, dtype=np.int64),
                                     width, n_channels)

    # pileup_dict groups: case-merged ACGT + I + D, with first-occurrence
    # ranks replicating Counter insertion-order tie-breaking
    group_count = np.zeros((width, 6), dtype=np.int32)
    group_count[:, :4] = _scatter_count(bpos, events.base_code.astype(np.int64), width, 4)
    ins_total = counts[:, CHANNEL_INDEX["I"]] + counts[:, CHANNEL_INDEX["i"]]
    del_total = counts[:, CHANNEL_INDEX["D"]] + counts[:, CHANNEL_INDEX["d"]]
    star_total = counts[:, CHANNEL_INDEX["*"]] + counts[:, CHANNEL_INDEX["#"]]
    group_count[:, GROUP_I] = ins_total
    group_count[:, GROUP_D] = del_total

    group_rank = np.full((width, 6), _RANK_INF, dtype=np.int64)
    _min_rank(bpos, events.base_code.astype(np.int64), events.base_rank,
              width, 6, group_rank)
    _min_rank(ipos, np.full(len(ipos), GROUP_I, dtype=np.int64), events.ins_rank,
              width, 6, group_rank)
    _min_rank(dpos, np.full(len(dpos), GROUP_D, dtype=np.int64), events.del_rank,
              width, 6, group_rank)

    max_del_length = np.zeros(width, dtype=np.int32)
    if len(dpos):
        np.maximum.at(max_del_length, dpos, events.del_len)

    return finalize_features(
        start, end, counts, group_count, group_rank, max_del_length,
        events.cover_count, events.read_start_count, events.read_end_count,
        events.skip_fwd_count, events.skip_rev_count, ref_codes)


def finalize_features(start, end, counts, group_count, group_rank,
                      max_del_length, cover_count, read_start_count,
                      read_end_count, skip_fwd_count, skip_rev_count,
                      ref_codes) -> TileFeatures:
    """Derive the scalar per-position features shared by the Python and
    native (C++) tile builders."""
    ins_total = counts[:, CHANNEL_INDEX["I"]] + counts[:, CHANNEL_INDEX["i"]]
    del_total = counts[:, CHANNEL_INDEX["D"]] + counts[:, CHANNEL_INDEX["d"]]
    star_total = counts[:, CHANNEL_INDEX["*"]] + counts[:, CHANNEL_INDEX["#"]]
    base_total = group_count[:, :4].sum(axis=1)
    depth = base_total + star_total

    ref_code = ref_codes.astype(np.int8)
    eff_ref_code = np.where(ref_code >= 0, ref_code, 0).astype(np.int8)
    ref_base_count = np.take_along_axis(
        group_count[:, :4], eff_ref_code[:, None].astype(np.int64), axis=1
    )[:, 0]
    alt_count = base_total - ref_base_count
    # ref_count = depth - del - ins - alt with del = '-'events + '*'/'#'
    # (src/create_tensor_pileup.py:219-259)
    ref_count = np.maximum(0, depth - (del_total + star_total) - ins_total - alt_count)

    # mpileup emits a row wherever any read covers via M/D/N (incl. N bases)
    covered = cover_count > 0
    max_skip = np.maximum.reduce([
        read_start_count, read_end_count, skip_fwd_count, skip_rev_count,
    ]).astype(np.int32)

    return TileFeatures(
        start=start, end=end, counts=counts, depth=depth, covered=covered,
        group_count=group_count, group_rank=group_rank, ins_total=ins_total,
        del_total=del_total, star_total=star_total, alt_count=alt_count,
        ref_count=ref_count, max_del_length=max_del_length, max_skip=max_skip,
        ref_code=ref_code, eff_ref_code=eff_ref_code,
    )


def candidate_mask_from(feat: TileFeatures, cfg: PileupConfig,
                        bed_mask: np.ndarray | None = None,
                        known_positions: np.ndarray | None = None) -> np.ndarray:
    """Vectorized pass_af + coverage candidate test
    (src/create_tensor_pileup.py:267-299,535-556)."""
    width = feat.end - feat.start
    if known_positions is not None:
        mask = np.zeros(width, dtype=bool)
        kp = known_positions - feat.start
        kp = kp[(kp >= 0) & (kp < width)]
        mask[kp] = True
        return mask & feat.covered

    denom = np.where(feat.depth > 0, feat.depth, 1).astype(np.float64)
    snp_af = cfg.effective_snp_af
    indel_af = cfg.effective_indel_min_af
    fast = cfg.platform == "ont" and cfg.fast_mode

    base_counts = feat.group_count[:, :4]
    non_ref = base_counts.copy()
    rows = np.arange(width)
    non_ref[rows, feat.eff_ref_code.astype(np.int64)] = 0
    base_af_ok = non_ref / denom[:, None] >= snp_af
    if fast:
        base_af_ok &= non_ref >= 4
    pass_snp_af = base_af_ok.any(axis=1)
    pass_indel_af = ((feat.ins_total / denom >= indel_af)
                     | (feat.del_total / denom >= indel_af))

    # pileup_list[0][0] != reference_base with Counter-stable tie order:
    # maximize (count, -rank); groups with zero count are absent
    sort_key = (feat.group_count.astype(np.int64) << 32) - np.minimum(feat.group_rank, 1 << 31)
    sort_key[feat.group_count == 0] = np.iinfo(np.int64).min
    top_group = sort_key.argmax(axis=1)
    top_count = np.take_along_axis(feat.group_count, top_group[:, None], axis=1)[:, 0]
    pass_top = (top_count > 0) & (top_group != feat.eff_ref_code.astype(np.int64))

    if cfg.call_snp_only:
        pass_af = pass_snp_af
    else:
        pass_af = pass_top | pass_snp_af | pass_indel_af
    # reference sites become candidates when either AF threshold is zero
    # (github.com/HKU-BAL/Clair3-RNA/issues/6; create_tensor_pileup.py:536-537)
    if snp_af == 0.0 or indel_af == 0.0:
        pass_af = pass_af | (feat.depth > 0)

    mask = (feat.covered & (feat.ref_code >= 0) & pass_af
            & (feat.depth >= cfg.min_coverage))
    if bed_mask is not None:
        mask &= bed_mask
    return mask


@dataclass
class SparseIndels:
    """Position-sorted insertion/deletion detail for alt_info reconstruction."""

    ins_pos: np.ndarray      # int64, sorted
    ins_rank: np.ndarray
    ins_allele: np.ndarray
    ins_seqs: list
    del_pos: np.ndarray      # int64, sorted
    del_rank: np.ndarray
    del_len: np.ndarray

    @classmethod
    def from_arrays(cls, ins_pos, ins_rank, ins_allele, ins_seqs,
                    del_pos, del_rank, del_len):
        io = np.argsort(ins_pos, kind="stable")
        do = np.argsort(del_pos, kind="stable")
        return cls(
            ins_pos=np.asarray(ins_pos)[io].astype(np.int64),
            ins_rank=np.asarray(ins_rank)[io],
            ins_allele=np.asarray(ins_allele)[io],
            ins_seqs=list(ins_seqs),
            del_pos=np.asarray(del_pos)[do].astype(np.int64),
            del_rank=np.asarray(del_rank)[do],
            del_len=np.asarray(del_len)[do],
        )

    @classmethod
    def from_events(cls, events: PileupEvents):
        return cls.from_arrays(events.ins_pos, events.ins_rank,
                               events.ins_allele, events.ins_seqs,
                               events.del_pos, events.del_rank, events.del_len)


def alt_info_data(indels: SparseIndels, feat: TileFeatures, pos: int,
                  ref_seq: str, ref_seq_start: int) -> tuple:
    """Build the candidate's allele summary exactly like the reference
    alt_dict (src/create_tensor_pileup.py:219-261, 595-596): keys in
    first-occurrence column order, 'R<ref>' appended last. SNP (X) entries
    come straight from the case-merged group counts/ranks.

    Returns (depth, {key: count}) — the already-parsed form of the
    reference's "depth-<alleles>" TSV field, so the in-process decoder can
    skip the string round-trip (alt_info_string formats the TSV field from
    this for wire-format interop)."""
    i = pos - feat.start
    ref_base = _BASES[feat.eff_ref_code[i]]
    entries = []  # (rank, key, count)

    eff = int(feat.eff_ref_code[i])
    for code in range(4):
        if code == eff:
            continue
        count = int(feat.group_count[i, code])
        if count:
            entries.append((int(feat.group_rank[i, code]), "X" + _BASES[code], count))

    i_lo = np.searchsorted(indels.ins_pos, pos, side="left")
    i_hi = np.searchsorted(indels.ins_pos, pos, side="right")
    if i_hi > i_lo:
        by_allele = {}
        for j in range(i_lo, i_hi):
            allele = indels.ins_allele[j]
            rank = int(indels.ins_rank[j])
            cnt, mn = by_allele.get(allele, (0, _RANK_INF))
            by_allele[allele] = (cnt + 1, min(mn, rank))
        for allele, (count, rank) in by_allele.items():
            entries.append((rank, "I" + ref_base + indels.ins_seqs[allele], count))

    d_lo = np.searchsorted(indels.del_pos, pos, side="left")
    d_hi = np.searchsorted(indels.del_pos, pos, side="right")
    if d_hi > d_lo:
        by_len = {}
        for j in range(d_lo, d_hi):
            dlen = int(indels.del_len[j])
            rank = int(indels.del_rank[j])
            cnt, mn = by_len.get(dlen, (0, _RANK_INF))
            by_len[dlen] = (cnt + 1, min(mn, rank))
        for dlen, (count, rank) in by_len.items():
            del_base = ref_seq[pos + 1 - ref_seq_start: pos + 1 + dlen - ref_seq_start]
            entries.append((rank, "D" + del_base, count))

    entries.sort(key=lambda e: e[0])
    alt_dict = {key: count for _, key, count in entries}
    rc = int(feat.ref_count[i])
    if rc > 0:
        alt_dict["R" + ref_base] = rc
    return int(feat.depth[i]), alt_dict


def alt_info_string(indels: SparseIndels, feat: TileFeatures, pos: int,
                    ref_seq: str, ref_seq_start: int) -> str:
    """The reference "depth-<alleles>" TSV field (create_tensor_pileup.py:595-596)."""
    return format_alt_info(*alt_info_data(indels, feat, pos, ref_seq,
                                          ref_seq_start))


def format_alt_info(depth: int, alt_dict: dict) -> str:
    return f"{depth}-" + " ".join(f"{k} {v}" for k, v in alt_dict.items())


def negated_counts(feat: TileFeatures) -> np.ndarray:
    """Apply the reference-channel negation trick
    (src/create_tensor_pileup.py:296-297): the ref base's fwd/rev channels are
    replaced by -(sum of fwd)/- (sum of rev) ACGT counts."""
    if feat.counts_negated:
        # native finalize already negated in place; counts has no other
        # consumer, so returning it directly (including build_tensors'
        # in-place splice-padding mutations on it) is safe
        return feat.counts
    out = feat.counts.copy()
    width = out.shape[0]
    rows = np.arange(width)
    fwd_sum = feat.counts[:, 0:4].sum(axis=1)
    rev_sum = feat.counts[:, 9:13].sum(axis=1)
    eff = feat.eff_ref_code.astype(np.int64)
    out[rows, eff] = -fwd_sum
    out[rows, eff + 9] = -rev_sum
    return out


def compute_runs(covered: np.ndarray):
    """Per-position [run_start, run_end] of the maximal covered run."""
    width = len(covered)
    run_start = np.full(width, -1, dtype=np.int64)
    run_end = np.full(width, -1, dtype=np.int64)
    idx = np.arange(width)
    # start of run: covered and (first or previous uncovered)
    starts = covered & np.concatenate(([True], ~covered[:-1]))
    start_idx = np.where(starts, idx, -1)
    start_ff = np.maximum.accumulate(start_idx)
    run_start = np.where(covered, start_ff, -1)
    ends = covered & np.concatenate((~covered[1:], [True]))
    end_idx = np.where(ends, idx, width + 1)
    end_bf = np.minimum.accumulate(end_idx[::-1])[::-1]
    run_end = np.where(covered, end_bf, -1)
    return run_start, run_end


def _sliding_window_max(values: np.ndarray, flank: int) -> np.ndarray:
    """out[i] = max(values[i-flank : i+flank+1]) with zero padding."""
    padded = np.concatenate([
        np.zeros(flank, values.dtype), values, np.zeros(flank, values.dtype)])
    view = np.lib.stride_tricks.sliding_window_view(padded, 2 * flank + 1)
    return view.max(axis=1)


def build_tensors(indels, feat: TileFeatures, cfg: PileupConfig,
                  ctg_name: str, ref_seq: str, ref_seq_start: int,
                  candidate_mask: np.ndarray,
                  emit_lo: int | None = None, emit_hi: int | None = None):
    """Gather 33-wide windows at candidate centers and serialize records.

    emit_lo/emit_hi bound the candidate centers actually emitted (tile core),
    while indels/feat may span a halo. Positions are 0-based internally.
    `indels` is a SparseIndels or a PileupEvents (converted on the fly).

    The emission is a single batched gather: eligibility (run-length rules)
    and the splice-padding trigger precondition are computed vectorized, and
    only candidates that may trigger padding -- or sit within the 2*flank
    reach of one's in-place image mutations -- take a sequential path that
    replays the reference's ring-buffer mutation order exactly
    (src/create_tensor_pileup.py:561-611).
    """
    if isinstance(indels, PileupEvents):
        indels = SparseIndels.from_events(indels)
    flank = config.FLANKING_BASE_NUM
    window = config.NO_OF_POSITIONS
    start, end = feat.start, feat.end
    width = end - start

    tensor_img = negated_counts(feat)
    run_start, run_end = compute_runs(feat.covered)
    cand_idx = np.nonzero(candidate_mask)[0]
    if emit_lo is not None:
        cand_idx = cand_idx[cand_idx + start >= emit_lo]
    if emit_hi is not None:
        cand_idx = cand_idx[cand_idx + start < emit_hi]
    if len(cand_idx) == 0:
        return []

    last_covered = int(np.nonzero(feat.covered)[0][-1]) if feat.covered.any() else -1

    # eligibility: depends only on covered-run extents, never on mutations
    rs = run_start[cand_idx]
    re_ = run_end[cand_idx]
    if cfg.enable_head_tail:
        kept = (re_ >= cand_idx + flank) | (re_ == last_covered)
        from_flush = re_ < cand_idx + flank
    else:
        kept = (rs <= cand_idx - flank) & (re_ >= cand_idx + flank)
        from_flush = np.zeros(len(cand_idx), dtype=bool)
    cand_idx = cand_idx[kept]
    rs, re_, from_flush = rs[kept], re_[kept], from_flush[kept]
    n = len(cand_idx)
    if n == 0:
        return []

    # splice-padding trigger precondition (conservative superset): the actual
    # trigger ratio max_skip_win / max_depth_live exceeds the threshold only
    # if max_skip_win > threshold * depth[center], because the center is
    # always live so max_depth_live >= depth[center].
    if cfg.enable_splice_padding:
        skip_masked = np.where(feat.covered, feat.max_skip, 0).astype(np.int32)
        win_max_skip = _sliding_window_max(skip_masked, flank)[cand_idx]
        cdepth = feat.depth[cand_idx].astype(np.float64)
        maybe = (~from_flush) & (
            (win_max_skip > config.SKIP_PROPORTION_THRESHOLD * cdepth)
            | ((cdepth == 0) & (win_max_skip > 0)))
    else:
        maybe = np.zeros(n, dtype=bool)

    # a maybe-trigger's image mutations reach positions within +-flank of its
    # center, i.e. windows of candidates within 2*flank; those emit serially
    if maybe.any():
        maybe_pos = cand_idx[maybe]
        j = np.searchsorted(maybe_pos, cand_idx)
        unsafe = np.zeros(n, dtype=bool)
        has_left = j > 0
        unsafe[has_left] = (cand_idx[has_left]
                            - maybe_pos[j[has_left] - 1]) <= 2 * flank
        has_right = j < len(maybe_pos)
        unsafe[has_right] |= (maybe_pos[j[has_right]]
                              - cand_idx[has_right]) <= 2 * flank
    else:
        unsafe = np.zeros(n, dtype=bool)

    n_channels = tensor_img.shape[1]
    tensors = np.zeros((n, window, n_channels), dtype=np.int32)

    safe_i = np.nonzero(~unsafe)[0]
    if len(safe_i):
        pos = cand_idx[safe_i, None] + np.arange(-flank, flank + 1)[None, :]
        valid = (pos >= 0) & (pos < width)
        gathered = tensor_img[np.clip(pos, 0, width - 1)]
        gathered[~valid] = 0
        if cfg.enable_head_tail:
            # ring-buffer reset semantics: slots outside this run are zero
            zero_rows = (pos < rs[safe_i, None]) | (pos > re_[safe_i, None])
            gathered[zero_rows] = 0
        tensors[safe_i] = gathered

    if unsafe.any():
        # emitted-before-current marks (the reference deletes a candidate's
        # depth_dict entry when its window is emitted, so later overlapping
        # windows treat it as depth 0 -- modelled by this boolean image)
        emitted = np.zeros(width, dtype=bool)
        mark_ptr = 0
        for i in np.nonzero(unsafe)[0]:
            ci = int(cand_idx[i])
            while mark_ptr < n and cand_idx[mark_ptr] < ci:
                emitted[cand_idx[mark_ptr]] = True
                mark_ptr += 1
            lo = ci - flank
            hi = ci + flank + 1
            tensor = tensors[i]
            src_lo, src_hi = max(lo, 0), min(hi, width)
            tensor[src_lo - lo: src_hi - lo] = tensor_img[src_lo:src_hi]
            if cfg.enable_head_tail:
                in_run = np.arange(lo, hi)
                zero_rows = (in_run < rs[i]) | (in_run > re_[i])
                tensor[zero_rows] = 0

            if maybe[i]:
                win_positions = np.arange(src_lo, src_hi)
                live = feat.covered[win_positions].copy()
                live &= ~emitted[win_positions] | (win_positions == ci)
                live_pos = win_positions[live]
                if len(live_pos):
                    max_depth = int(feat.depth[live_pos].max())
                    cov_pos = win_positions[feat.covered[win_positions]]
                    max_skip_count = int(feat.max_skip[cov_pos].max()) if len(cov_pos) else 0
                    cand_depth = int(feat.depth[ci])
                    if max_depth > 0 and max_skip_count / float(max_depth) > config.SKIP_PROPORTION_THRESHOLD:
                        eff_center = int(feat.eff_ref_code[ci])
                        fwd = abs(int(tensor[flank][eff_center]))
                        rev = abs(int(tensor[flank][eff_center + 9]))
                        fwd_pct = fwd / float(fwd + rev) if fwd + rev > 0 else 0.0
                        rev_pct = 1 - fwd_pct
                        for idx in range(window):
                            p = ci - flank + idx
                            if idx == flank:
                                continue
                            if 0 <= p < width and feat.covered[p] and not emitted[p]:
                                current_depth = int(feat.depth[p])
                            else:
                                current_depth = 0
                            if current_depth < cand_depth * config.SKIP_PROPORTION_THRESHOLD:
                                if not (0 <= p < width):
                                    continue
                                # write both the emitted window and the shared
                                # image: the reference mutates its ring-buffer
                                # row lists in place
                                # (create_tensor_pileup.py:592-593), so padding
                                # persists into later overlapping windows
                                eff = int(feat.eff_ref_code[p])
                                tensor[idx][eff] = -int(cand_depth * fwd_pct)
                                tensor[idx][eff + 9] = -int(cand_depth * rev_pct)
                                tensor_img[p][eff] = tensor[idx][eff]
                                tensor_img[p][eff + 9] = tensor[idx][eff + 9]

    depths = feat.depth[cand_idx]
    # everything the lazy alt_data thunks need, precomputed in a handful of
    # vectorized ops so the thunk body is pure Python scalars (per-candidate
    # numpy indexing dominated host decode time otherwise)
    pos_abs = cand_idx.astype(np.int64) + start
    eff_l = feat.eff_ref_code[cand_idx].tolist()
    gc_l = feat.group_count[cand_idx, :4].tolist()
    gr_l = feat.group_rank[cand_idx, :4].tolist()
    rc_l = feat.ref_count[cand_idx].tolist()
    dp_l = depths.tolist()
    ins_lo = np.searchsorted(indels.ins_pos, pos_abs, side="left").tolist()
    ins_hi = np.searchsorted(indels.ins_pos, pos_abs, side="right").tolist()
    del_lo = np.searchsorted(indels.del_pos, pos_abs, side="left").tolist()
    del_hi = np.searchsorted(indels.del_pos, pos_abs, side="right").tolist()

    records = []
    for i in range(n):
        center_abs = int(pos_abs[i])
        records.append(TensorRecord(
            ctg_name=ctg_name,
            position=center_abs + 1,
            ref_seq=_flanked_ref(ref_seq, ref_seq_start, center_abs, flank),
            tensor=tensors[i],
            depth=dp_l[i],
            alt_thunk=(lambda i=i, p=center_abs: _alt_data_fast(
                indels, p, dp_l[i], eff_l[i], gc_l[i], gr_l[i], rc_l[i],
                ins_lo[i], ins_hi[i], del_lo[i], del_hi[i],
                ref_seq, ref_seq_start)),
        ))
    return records


def _alt_data_fast(indels, pos, depth, eff, gcounts, granks, ref_count,
                   i_lo, i_hi, d_lo, d_hi, ref_seq, ref_seq_start):
    """alt_info_data with all per-candidate lookups pre-resolved to Python
    scalars by build_tensors; semantics identical (differentially tested by
    tests/test_pileup_parity.py through the TSV wire format)."""
    entries = []
    for code in range(4):
        if code == eff:
            continue
        count = gcounts[code]
        if count:
            entries.append((granks[code], "X" + _BASES[code], count))

    if i_hi > i_lo:
        alleles = indels.ins_allele[i_lo:i_hi].tolist()
        ranks = indels.ins_rank[i_lo:i_hi].tolist()
        ref_base = _BASES[eff]
        by_allele = {}
        for allele, rank in zip(alleles, ranks):
            cnt, mn = by_allele.get(allele, (0, _RANK_INF))
            by_allele[allele] = (cnt + 1, rank if rank < mn else mn)
        for allele, (count, rank) in by_allele.items():
            entries.append((rank, "I" + ref_base + indels.ins_seqs[allele], count))

    if d_hi > d_lo:
        dlens = indels.del_len[d_lo:d_hi].tolist()
        ranks = indels.del_rank[d_lo:d_hi].tolist()
        by_len = {}
        for dlen, rank in zip(dlens, ranks):
            cnt, mn = by_len.get(dlen, (0, _RANK_INF))
            by_len[dlen] = (cnt + 1, rank if rank < mn else mn)
        for dlen, (count, rank) in by_len.items():
            del_base = ref_seq[pos + 1 - ref_seq_start: pos + 1 + dlen - ref_seq_start]
            entries.append((rank, "D" + del_base, count))

    entries.sort(key=lambda e: e[0])
    alt_dict = {key: count for _, key, count in entries}
    if ref_count > 0:
        alt_dict["R" + _BASES[eff]] = ref_count
    return depth, alt_dict


def _flanked_ref(ref_seq: str, ref_seq_start: int, center: int, flank: int) -> str:
    """33-base reference window, 'A'-padded out of bounds
    (src/create_tensor_pileup.py:313-331)."""
    lo = center - flank - ref_seq_start
    hi = center + flank + 1 - ref_seq_start
    out = []
    if lo < 0:
        out.append("A" * (-lo))
        lo = 0
    out.append(ref_seq[lo:hi])
    if hi > len(ref_seq):
        out.append("A" * (hi - len(ref_seq)))
    return "".join(out)
