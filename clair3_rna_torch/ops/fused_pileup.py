"""Fused device pileup pass: reads -> counts -> candidate mask -> 33-window
gather -> PileupNet, one device pass per chunk.

A chunk's reads are staged to the device once and nothing round-trips
between stages (the reference's per-position loop being
replaced is src/create_tensor_pileup.py:85-302 plus the separate predict
process). Contrast with the host route, where the C++ tile builder makes the
count image on the host and only candidate windows reach the device.

Exactness strategy (VCF-identical to the host route):

- channel counts / negation / window gather are integer math, exact in f32
  (all values < 2^24);
- the candidate AF tests (count/depth >= af, float64 on the host,
  src/create_tensor_pileup.py:272-299) become per-depth integer thresholds
  precomputed on the host in float64 (`_af_thresholds`), so the device
  compares integers only;
- Counter insertion-order tie-breaking (pileup_list[0][0]) uses a min over
  event ranks, then argmax-count with argmin-rank tie-break;
- BED restriction, known-site (-G) candidates and head/tail mode run on the
  device (mask inputs + run-extent rules; see make_fused_fn's flags);
- candidates that need the high-coverage renormalization (depth >
  1.5*max_depth) are flagged (`host_flags` bit 1): their RAW count windows
  ride the same output and the reference's float64 scale-then-truncate
  (clair3_rna/utils.py:88-92) is applied on the host, then they go through
  the host route's wire forward (FusedChunkCaller._renorm_records);
- candidates that could trigger the splice-padding backfill are flagged
  (bit 2) and rebuilt on the host as 1-position mini chunks
  (FusedChunkCaller._hatch_records) when ISOLATED (no other candidate
  within 2*FLANK); clustered triggers fall back per chunk;
- only candidate overflow beyond max_budget, rank overflow, depths beyond
  the AF-threshold table, clustered splice triggers, or more splice flags
  than hatch_max fall back per chunk.

Two wires feed the pass (CLAIR3_RNA_TORCH_FUSED_MODE):

- mode="packed" (default): base codes ride the tilelet rows
  (ops/tilelet.py: the CUDA kernel K1/K2 on a card); stars and indels (~1%
  of events) ride a sparse side channel of index_add_ / scatter_reduce.
- mode="events": flat per-event arrays (~10 B/event) through
  ops/fused_scatter.py (the CUDA kernel K3 on a card), which builds the
  count image and the group ranks in one launch.

Both share `_tail`, everything after the count image.
"""

import dataclasses
import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from clair3_rna_torch import config
from clair3_rna_torch.config import PileupConfig
from clair3_rna_torch.ops import fused_scatter as fsc
from clair3_rna_torch.ops import tilelet as tlt

FLANK = config.FLANKING_BASE_NUM
GROUP_NONE = 6              # star placeholders count depth but no group
D_TABLE = 4096              # AF-threshold table size; candidates at depths
                            # beyond it fall back (clamped thresholds would
                            # be lenient -> candidacy itself unsound)
RANK_INF = 2 ** 31 - 1      # empty-group rank (an empty segment-min)


def _af_thresholds(af, max_depth=D_TABLE - 1):
    """thr[d] = min count c with float64(c/d) >= af -- exact mirror of the
    host's float64 comparison, one integer per depth."""
    d = np.arange(max_depth + 1, dtype=np.float64)
    d[0] = 1.0  # the host divides by max(depth, 1)
    c0 = np.floor(af * d).astype(np.int64)
    # c0 or c0+1, depending on float64 rounding of c/d
    thr = np.where(c0.astype(np.float64) / d >= af, c0, c0 + 1)
    return np.maximum(thr, 0).astype(np.int32)


def _pad_pow2(arr, fill, min_size=1024):
    """Pad a 1D/2D array's first axis to the next power of two (>=
    min_size)."""
    n = len(arr)
    size = min_size
    while size < n:
        size *= 2
    if size == n:
        return arr
    pad_shape = (size - n,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)])


@dataclass
class StagedChunk:
    """Host-staged flat-event arrays for one chunk (mode="events").

    Events stay in staging order (base, star, insertion, deletion events,
    each read-major); the scatter kernel takes any order. Nothing is
    padded: every event is real and lies in [0, width)."""

    width: int
    core_lo: int
    core_hi: int
    start: int
    ev_pos: np.ndarray        # [E] int32 position offsets
    ev_chan: np.ndarray       # [E] int8 channel 0..17
    ev_group: np.ndarray      # [E] int8 0..5, GROUP_NONE for stars
    ev_rank: np.ndarray       # [E] int32
    cover_pos: np.ndarray     # [K] int32 positions with cover deltas
    cover_delta: np.ndarray   # [K] int32
    i1_pos: np.ndarray        # [K] int32 positions with I1/i1/D1/d1 patches
    i1_vals: np.ndarray       # [K, 4] int32
    ref_code: np.ndarray      # [W] int8 (-1 non-ACGT)
    thr_snp: np.ndarray       # [D_TABLE] int32
    thr_indel: np.ndarray
    cover_allow: np.ndarray   # [W] int8 bed+-33 mask (1-elt placeholder off)
    cand_allow: np.ndarray    # [W] int8 bed-span / known-site mask
    max_skip: np.ndarray      # [W] int32 splice statistics (placeholder off)


@dataclass
class StagedPacked:
    """Host-staged packed-read arrays for one chunk.

    Tilelet rows are tile-sorted and padded to a quantize_rows bucket with
    inert rows (tile == width/POS_TILE, no valid slot); the sparse side
    arrays are power-of-two padded with weight-0 events at `width`."""

    width: int
    core_lo: int
    core_hi: int
    start: int
    tl_codes: np.ndarray      # [R_pad, POS_TILE/4] crumbs (v2) or
    #                           [R_pad, POS_TILE/2] nibbles
    tl_valid: np.ndarray      # [R_pad, POS_TILE/8] validity bits (v2 wire;
    #                           None on the nibble wire)
    tl_tile: np.ndarray       # [R_pad] int32
    tl_rank: np.ndarray       # [R_pad] int32
    tl_strand: np.ndarray     # [R_pad] int8
    tl_hp: np.ndarray         # [R_pad] int8 (phased mode)
    tl_row_off: np.ndarray    # [n_tiles + 1] int32 first row of each tile
    tl_max_rows: int          # the deepest tile's rows
    sp_pos: np.ndarray        # [S_pad] int32 sparse star/ins/del events
    sp_chan: np.ndarray       # [S_pad] int8
    sp_group: np.ndarray      # [S_pad] int8 (4 ins, 5 del, 6 star, 7 pad)
    sp_rank: np.ndarray       # [S_pad] int32
    sp_weight: np.ndarray     # [S_pad] int8
    cover_pos: np.ndarray     # [K] int32 positions with cover deltas
    cover_delta: np.ndarray   # [K] int32
    i1_pos: np.ndarray        # [K] int32 positions with I1/i1/D1/d1 patches
    i1_vals: np.ndarray       # [K, 4] int32
    ref_code: np.ndarray      # [W] int8 (-1 non-ACGT)
    thr_snp: np.ndarray       # [D_TABLE] int32
    thr_indel: np.ndarray
    cover_allow: np.ndarray   # [W] int8 bed+-33 mask (1-elt placeholder off)
    cand_allow: np.ndarray    # [W] int8 bed-span / known-site mask
    max_skip: np.ndarray      # [W] int32 splice statistics (placeholder off)


def _mask_args(data, width_pad, cover_allow, cand_allow, with_max_skip):
    """Padded (cover_allow, cand_allow, max_skip) staged arrays; 1-element
    placeholders when the corresponding feature flag is off (never read)."""
    width = data.end - data.start
    z = np.zeros(1, np.int8)
    ca = z if cover_allow is None else np.pad(
        np.asarray(cover_allow, np.int8), (0, width_pad - width))
    aa = z if cand_allow is None else np.pad(
        np.asarray(cand_allow, np.int8), (0, width_pad - width))
    if with_max_skip:
        ms = np.maximum.reduce([
            data.read_start_count, data.read_end_count,
            data.skip_fwd_count, data.skip_rev_count]).astype(np.int32)
        ms = np.pad(ms, (0, width_pad - width))
    else:
        ms = np.zeros(1, np.int32)
    return ca, aa, ms


def _sparse_side(packed, width_pad, phased=False):
    """Star/ins/del events as padded flat arrays for the side channel. In
    phased mode, HP-tagged ins/del events add count-only events into the
    IP/DP (hp=1) and IM/DM (hp=2) channels
    (src/create_tensor_pileup.py:181-217)."""
    start = packed.start
    star_chan = np.where(packed.star_strand == 0, config.CHANNEL_INDEX["*"],
                         config.CHANNEL_INDEX["#"]).astype(np.int8)
    ins_chan = np.where(packed.ins_strand == 0, config.CHANNEL_INDEX["I"],
                        config.CHANNEL_INDEX["i"]).astype(np.int8)
    del_chan = np.where(packed.del_strand == 0, config.CHANNEL_INDEX["D"],
                        config.CHANNEL_INDEX["d"]).astype(np.int8)
    pos_parts = [packed.star_pos - start, packed.ins_pos - start,
                 packed.del_pos - start]
    chan_parts = [star_chan, ins_chan, del_chan]
    group_parts = [np.full(len(packed.star_pos), GROUP_NONE, np.int8),
                   np.full(len(packed.ins_pos), 4, np.int8),
                   np.full(len(packed.del_pos), 5, np.int8)]
    rank_parts = [np.zeros(len(packed.star_pos), np.int64),
                  packed.ins_rank, packed.del_rank]
    if phased:
        base = config.CHANNEL_SIZE  # 18: IP/DP at +4/+5, IM/DM at +10/+11
        for hp_val, off in ((1, base), (2, base + 6)):
            for kind_pos, kind_hp in ((packed.ins_pos, packed.ins_hp),
                                      (packed.del_pos, packed.del_hp)):
                sel = kind_hp == hp_val
                n = int(sel.sum())
                ch = off + (4 if kind_pos is packed.ins_pos else 5)
                pos_parts.append((kind_pos[sel] - start).astype(np.int32))
                chan_parts.append(np.full(n, ch, np.int8))
                group_parts.append(np.full(n, 7, np.int8))  # count-only
                rank_parts.append(np.zeros(n, np.int64))
    sp_pos = np.concatenate(pos_parts).astype(np.int32)
    sp_chan = np.concatenate(chan_parts)
    sp_group = np.concatenate(group_parts)
    sp_rank = np.concatenate(rank_parts).astype(np.int32)
    sp_pos = _pad_pow2(sp_pos, width_pad, min_size=512)
    sp_weight = (sp_pos < width_pad).astype(np.int8)
    return (sp_pos, _pad_pow2(sp_chan, 0, min_size=512),
            _pad_pow2(sp_group, 7, min_size=512),
            _pad_pow2(sp_rank, tlt.MAX_RANK, min_size=512), sp_weight)


def _width_pad(width):
    """Padded chunk width: the next power of two >= 16384."""
    width_pad = 16384
    while width_pad < width:
        width_pad *= 2
    return width_pad


def _indel_patch(data, width):
    """(i1_pos, i1_vals): positions with I1/i1/D1/d1 counts, the most
    supported single allele per (pos, strand), from the sparse indels."""
    from clair3_rna_torch.pileup.builder import _max_per_allele
    ins_max = _max_per_allele(data.ins_pos - data.start, data.ins_strand,
                              data.ins_allele, width, len(data.ins_seqs))
    n_del_alleles = int(data.del_len.max()) + 1 if len(data.del_len) else 0
    del_max = _max_per_allele(data.del_pos - data.start, data.del_strand,
                              data.del_len, width, n_del_alleles)
    patch = np.concatenate([ins_max, del_max], axis=1)
    i1_pos = np.nonzero(patch.any(axis=1))[0].astype(np.int32)
    return i1_pos, patch[i1_pos].astype(np.int32)


def _cover_deltas(cover_count):
    """Cover-count deltas, including the closing delta at `width`: without
    it the device cumsum carries coverage into the pad region and the
    covered-run extents bleed past the region end."""
    diff = np.diff(np.concatenate([[0], cover_count, [0]])).astype(np.int32)
    nz = np.nonzero(diff)[0].astype(np.int32)
    return nz, diff[nz]


def _tail_arrays(data, ref_codes, cfg, width_pad, cover_allow, cand_allow):
    """The staged arrays both wires share, by StagedChunk/StagedPacked
    field name."""
    width = data.end - data.start
    i1_pos, i1_vals = _indel_patch(data, width)
    cover_pos, cover_delta = _cover_deltas(data.cover_count)
    ca, aa, ms = _mask_args(data, width_pad, cover_allow, cand_allow,
                            cfg.enable_splice_padding)
    return dict(
        cover_pos=_pad_pow2(cover_pos, 0, min_size=256),
        cover_delta=_pad_pow2(cover_delta, 0, min_size=256),
        i1_pos=_pad_pow2(i1_pos, 0, min_size=256),
        i1_vals=_pad_pow2(i1_vals, 0, min_size=256),
        ref_code=np.pad(ref_codes.astype(np.int8), (0, width_pad - width),
                        constant_values=-1),
        thr_snp=_af_thresholds(cfg.effective_snp_af),
        thr_indel=_af_thresholds(cfg.effective_indel_min_af),
        cover_allow=ca, cand_allow=aa, max_skip=ms)


def stage_chunk(events, ref_codes, cfg: PileupConfig, core_lo, core_hi,
                width_pad=None, cover_allow=None, cand_allow=None):
    """PileupEvents -> StagedChunk (one host pass; no dense image built):
    base, star, insertion and deletion events as one flat list, in the
    order they come, for the scatter kernel."""
    width = events.end - events.start
    if width_pad is None:
        width_pad = _width_pad(width)
    CI = config.CHANNEL_INDEX
    start = events.start
    ev_pos = np.concatenate([
        events.base_pos - start, events.star_pos - start,
        events.ins_pos - start, events.del_pos - start]).astype(np.int32)
    ev_chan = np.concatenate([
        events.base_code.astype(np.int32) + 9 * events.base_strand,
        np.where(events.star_strand == 0, CI["*"], CI["#"]),
        np.where(events.ins_strand == 0, CI["I"], CI["i"]),
        np.where(events.del_strand == 0, CI["D"], CI["d"])]).astype(np.int8)
    ev_group = np.concatenate([
        events.base_code.astype(np.int32),
        np.full(len(events.star_pos), GROUP_NONE, np.int32),
        np.full(len(events.ins_pos), 4, np.int32),
        np.full(len(events.del_pos), 5, np.int32)]).astype(np.int8)
    ev_rank = np.concatenate([
        events.base_rank, np.zeros(len(events.star_pos), np.int64),
        events.ins_rank, events.del_rank]).astype(np.int32)
    return StagedChunk(
        width=width_pad, core_lo=core_lo - start, core_hi=core_hi - start,
        start=start, ev_pos=ev_pos, ev_chan=ev_chan, ev_group=ev_group,
        ev_rank=ev_rank,
        **_tail_arrays(events, ref_codes, cfg, width_pad, cover_allow,
                       cand_allow))


def stage_chunk_packed(packed, ref_codes, cfg: PileupConfig, core_lo,
                       core_hi, width_pad=None, cover_allow=None,
                       cand_allow=None, wire=None):
    """PackedReads -> StagedPacked (one cheap host pass over ~rows plus the
    sparse side arrays). wire="v2" repacks the extractor's nibble arenas
    into 2-bit crumbs + a validity bitmap (tlt.nibble_to_v2)."""
    wire = resolve_wire() if wire is None else wire
    if width_pad is None:
        width_pad = _width_pad(packed.end - packed.start)

    # pad rows point at tile n_tiles (beyond every position) and carry no
    # valid slot, so they are inert in the kernel and the plain version
    n_tiles = width_pad // tlt.POS_TILE
    r_pad = tlt.quantize_rows(len(packed.tl_tile))

    def _pad_rows(a, fill):
        pad_shape = (r_pad - len(a),) + a.shape[1:]
        return np.concatenate([a, np.full(pad_shape, fill, a.dtype)])

    tl_codes = np.full((r_pad, tlt.HALF), 0xFF, np.uint8)
    tl_codes[:len(packed.tl_codes)] = packed.tl_codes
    tl_valid = None
    if wire == "v2":
        tl_codes, tl_valid = tlt.nibble_to_v2(tl_codes)
    # the per-tile arenas: tile t owns rows [tl_row_off[t], tl_row_off[t+1])
    tl_tile = _pad_rows(packed.tl_tile.astype(np.int32), np.int32(n_tiles))
    tl_row_off = np.searchsorted(
        tl_tile, np.arange(n_tiles + 1, dtype=np.int32)).astype(np.int32)
    sp_pos, sp_chan, sp_group, sp_rank, sp_weight = _sparse_side(
        packed, width_pad, phased=cfg.phased)
    return StagedPacked(
        width=width_pad, core_lo=core_lo - packed.start,
        core_hi=core_hi - packed.start, start=packed.start,
        tl_codes=tl_codes, tl_valid=tl_valid,
        tl_tile=tl_tile, tl_row_off=tl_row_off,
        tl_max_rows=int(np.diff(tl_row_off).max(initial=0)),
        tl_rank=_pad_rows(packed.tl_rank.astype(np.int32),
                          np.int32(tlt.MAX_RANK)),
        tl_strand=_pad_rows(packed.tl_strand.astype(np.int8), np.int8(0)),
        tl_hp=_pad_rows(packed.tl_hp.astype(np.int8), np.int8(0)),
        sp_pos=sp_pos, sp_chan=sp_chan, sp_group=sp_group, sp_rank=sp_rank,
        sp_weight=sp_weight,
        **_tail_arrays(packed, ref_codes, cfg, width_pad, cover_allow,
                       cand_allow))


def staged_tensors(st: StagedPacked, device):
    """{array field: tensor on device} for the fused function (tl_valid is
    None on the nibble wire), plus tl_max_rows where the staging has it."""
    out = {}
    for f in dataclasses.fields(st):
        a = getattr(st, f.name)
        if isinstance(a, np.ndarray):
            out[f.name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        elif a is None or f.name == "tl_max_rows":
            out[f.name] = a
    return out


def make_fused_fn(params, cfg: PileupConfig, *, max_candidates=1024,
                  known_only=False, with_masks=False,
                  with_renorm_windows=False, wire="v2", mode="packed"):
    """The fused function over staged device tensors.

    fused(t, core, sel=None) with t = staged_tensors(...) of a StagedPacked
    (mode="packed", tilelet wire `wire`) or a StagedChunk (mode="events")
    and core = (core_lo, core_hi) returns one f32 tensor
    [max_candidates + 1, P + 12]
    (header row carries n_cand; body rows are cand | probs+mask | gcount4 |
    grank4 | ref_count | depth | host_flags, P = probs-plus-prescreen
    width), so the host fetches ONE tensor per chunk. With `sel` (int32
    window centers, pads = W) the mask and network stages are skipped and
    the RAW negated count windows at those centers come back instead.

    Feature flags:
    - known_only: candidate mask = known-site positions & covered (-G
      genotyping); positions arrive as the staged cand_allow bitmask.
    - with_masks: BED restriction -- cover_allow (bed +-33) clips coverage
      runs, cand_allow (bed vs candidate deletion span) clips candidates.
    - cfg.enable_splice_padding: candidates whose 33-window splice-skip
      statistics could trigger the reference's backfill are flagged.
    - cfg.enable_head_tail: run-tail candidates kept and window slots
      outside the candidate's covered run zeroed.
    - with_renorm_windows: the raw windows ride the same output as extra
      rows (deep chunks, whose candidates may need the host renorm).
    """
    from clair3_rna_torch.models.network import prescreen_column

    net = params
    n_ch = cfg.channel_size  # 18, or 30 in phased mode
    phased = bool(cfg.phased)
    if mode not in ("packed", "events"):
        raise ValueError(f"bad fused mode {mode!r} (packed|events)")
    if phased and mode != "packed":
        raise ValueError("phased fused mode requires mode='packed'")
    min_cov = int(cfg.min_coverage)
    fast = cfg.platform == "ont" and cfg.fast_mode
    af_zero = (cfg.effective_snp_af == 0.0
               or cfg.effective_indel_min_af == 0.0)
    snp_only = bool(cfg.call_snp_only)
    max_depth = config.MAX_DEPTH_BY_PLATFORM.get(cfg.platform,
                                                 config.MAX_DEPTH)
    CI = config.CHANNEL_INDEX
    splice = bool(cfg.enable_splice_padding)
    head_tail = bool(cfg.enable_head_tail)
    SKIP_THR = float(config.SKIP_PROPORTION_THRESHOLD)
    def _counts_packed(t):
        """Steps 1+2: base channels + base group ranks from the tilelet
        kernel, then the sparse star/ins/del side channel."""
        W = t["ref_code"].shape[0]
        dev = t["ref_code"].device
        counts_f, ranks_f = tlt.expand(
            wire, t["tl_codes"], t["tl_valid"], t["tl_tile"], t["tl_rank"],
            t["tl_strand"], W, tl_hp=t["tl_hp"], phased=phased,
            tl_row_off=t["tl_row_off"], max_rows=t["tl_max_rows"])
        counts = counts_f[:n_ch].T.to(torch.int32)             # [W, n_ch]
        grank6 = ranks_f[:6].T.to(torch.int32)
        pos_c = t["sp_pos"].to(torch.int64).clamp(max=W - 1)
        flat = counts.reshape(-1).clone()
        flat.index_add_(0, pos_c * n_ch + t["sp_chan"].to(torch.int64),
                        t["sp_weight"].to(torch.int32))
        counts = flat.reshape(W, n_ch)
        gidx = pos_c * 8 + t["sp_group"].to(torch.int64).clamp(max=7)
        sp_grank = torch.full((W * 8,), RANK_INF, dtype=torch.int32,
                              device=dev)
        sp_grank.scatter_reduce_(0, gidx, t["sp_rank"], "amin",
                                 include_self=True)
        grank6 = torch.minimum(grank6, sp_grank.reshape(W, 8)[:, :6])
        return counts, grank6

    def _counts_events(t):
        """Steps 1+2: the channel-count image and the first-occurrence
        group ranks of every event from the scatter kernel (empty groups
        read 2^30; _tail masks them by count)."""
        counts_f, ranks_f = fsc.fused_scatter(
            t["ev_pos"], t["ev_chan"], t["ev_group"], t["ev_rank"],
            t["ref_code"].shape[0])
        return (counts_f[:n_ch].T.to(torch.int32).contiguous(),
                ranks_f[:6].T.to(torch.int32))

    def _tail(counts, grank6, t, core, sel=None):
        """Steps 3-8, shared by both wires: i1 patch, features, candidate
        mask, window gather, network, prescreen, host flags."""
        ref_code = t["ref_code"]
        W = ref_code.shape[0]
        dev = ref_code.device
        i1 = t["i1_vals"]
        patch = torch.zeros((i1.shape[0], n_ch), dtype=torch.int32,
                            device=dev)
        for j, name in enumerate(("I1", "i1", "D1", "d1")):
            patch[:, CI[name]] = i1[:, j]
        counts.index_add_(0, t["i1_pos"].to(torch.int64), patch)
        eff = ref_code.clamp(min=0).to(torch.int64)
        pos_iota = torch.arange(W, device=dev)

        # 3. coverage + covered-run extents (finalize_features/compute_runs
        # mirror); a closing delta at W is dropped as segment_sum drops it
        seg = torch.zeros(W + 1, dtype=torch.int32, device=dev)
        seg.index_add_(0, t["cover_pos"].to(torch.int64), t["cover_delta"])
        covered = torch.cumsum(seg[:W], 0) > 0
        if with_masks:  # bed +-33 clips coverage (and so run extents)
            covered &= t["cover_allow"] != 0
        first = torch.cat([covered.new_ones(1), ~covered[:-1]])
        last = torch.cat([~covered[1:], covered.new_ones(1)])
        run_start = torch.cummax(torch.where(covered & first, pos_iota, -1),
                                 0).values
        run_end = -torch.cummax(torch.where(
            covered & last, -pos_iota, -(W + 1)).flip(0), 0).values.flip(0)

        if sel is None:
            gcount = torch.stack([
                counts[:, 0] + counts[:, 9], counts[:, 1] + counts[:, 10],
                counts[:, 2] + counts[:, 11], counts[:, 3] + counts[:, 12],
                counts[:, CI["I"]] + counts[:, CI["i"]],
                counts[:, CI["D"]] + counts[:, CI["d"]],
            ], dim=1)                                          # [W, 6]
            grank = torch.where(gcount > 0, grank6, RANK_INF)
            star_total = counts[:, CI["*"]] + counts[:, CI["#"]]
            base_total = gcount[:, :4].sum(dim=1)
            depth = base_total + star_total
            ins_total, del_total = gcount[:, 4], gcount[:, 5]
            ref_base_count = gcount[:, :4].gather(1, eff[:, None])[:, 0]
            alt_count = base_total - ref_base_count
            ref_count = (depth - (del_total + star_total) - ins_total
                         - alt_count).clamp(min=0)

            # 4. candidate mask (candidate_mask_from mirror, integer-exact)
            if known_only:
                mask = covered & (t["cand_allow"] != 0)
            else:
                thr_snp, thr_indel = t["thr_snp"], t["thr_indel"]
                dcl = depth.clamp(max=thr_snp.shape[0] - 1).to(torch.int64)
                non_ref = gcount[:, :4].scatter(1, eff[:, None], 0)
                snp_ok = non_ref >= thr_snp[dcl][:, None]
                if fast:
                    snp_ok &= non_ref >= 4
                pass_snp = snp_ok.any(dim=1)
                ti = thr_indel[dcl]
                pass_indel = (ins_total >= ti) | (del_total >= ti)
                max_gc = gcount.max(dim=1).values
                rank_if_top = torch.where(gcount == max_gc[:, None], grank,
                                          RANK_INF)
                # first-occurrence tie-break, as jnp.argmin
                top_group = torch.argmin(rank_if_top, dim=1)
                pass_top = (max_gc > 0) & (top_group != eff)
                pass_af = pass_snp if snp_only \
                    else (pass_top | pass_snp | pass_indel)
                if af_zero:
                    pass_af = pass_af | (depth > 0)
                mask = covered & (ref_code >= 0) & pass_af \
                    & (depth >= min_cov)
                if with_masks:  # bed vs candidate deletion span
                    mask &= t["cand_allow"] != 0

            # 5. full-window eligibility from covered-run extents
            if head_tail:
                last_covered = torch.where(covered, pos_iota, -1).max()
                kept = ((run_end >= pos_iota + FLANK)
                        | (run_end == last_covered))
            else:
                kept = ((run_start <= pos_iota - FLANK)
                        & (run_end >= pos_iota + FLANK))
            mask &= kept & (pos_iota >= core[0]) & (pos_iota < core[1])

            # nonzero(mask, size=budget, fill_value=W) without a host sync:
            # the k-th set position lands in slot k, overflow in a trash slot
            n_cand = mask.sum()
            slot = torch.cumsum(mask, 0) - 1
            slot = torch.where(mask & (slot < max_candidates), slot,
                               max_candidates)
            cand = torch.full((max_candidates + 1,), W, dtype=torch.int64,
                              device=dev)
            cand.scatter_(0, slot, pos_iota)
            cand = cand[:max_candidates]
        else:
            cand = sel.to(torch.int64)

        # 6. ref-channel negation (negated_counts mirror)
        ch_iota = torch.arange(n_ch, device=dev)[None, :]
        fwd_sum = counts[:, 0:4].sum(dim=1)
        rev_sum = counts[:, 9:13].sum(dim=1)
        neg_f = ch_iota == eff[:, None]
        neg_r = ch_iota == (eff[:, None] + 9)
        image = torch.where(neg_f, -fwd_sum[:, None],
                            torch.where(neg_r, -rev_sum[:, None], counts))

        # 7. 33-window gather (zero outside [0, W))
        win_pos = cand[:, None] + torch.arange(-FLANK, FLANK + 1,
                                               device=dev)[None, :]
        valid = (win_pos >= 0) & (win_pos < W) & (cand[:, None] < W)
        cc = cand.clamp(0, W - 1)
        if head_tail:
            valid &= ((win_pos >= run_start[cc][:, None])
                      & (win_pos <= run_end[cc][:, None]))
        wp = win_pos.clamp(0, W - 1)
        windows = torch.where(valid[:, :, None], image[wp], 0) \
            .to(torch.float32)
        if sel is not None:
            # windows-fetch mode: raw integer windows, exact in f32
            return windows

        # 8. network + homRef prescreen (wire-forward mirror)
        with torch.inference_mode():
            probs = net(windows)
        out = torch.cat([probs, prescreen_column(probs, eff[cc])], dim=-1)

        depth_c = depth[cc]
        # host_flags: per-candidate escape codes (0 = fully fused).
        # 1 = renormalization depth (the host's float64 scale+truncate,
        #     clair3_rna/utils.py:88-92, FusedChunkCaller._renorm_records);
        # 2 = conservative splice-padding trigger superset -- isolated
        #     candidates rebuild host-side (_hatch_records), clustered ones
        #     whole-chunk fall back;
        # 4 = depth beyond the AF-threshold table: the clamped thresholds
        #     are lenient, so candidacy itself may be a false positive ->
        #     whole-chunk host fallback.
        flags = torch.where(depth_c > max_depth * 1.5, 1, 0)
        flags = flags + torch.where(depth_c >= D_TABLE, 4, 0)
        if splice:
            # the exact superset build_tensors uses; with SKIP_THR = 1/5
            # the comparison is integer-exact
            skip_m = torch.where(covered, t["max_skip"], 0)
            wmax = skip_m
            for d in range(1, FLANK + 1):
                zpad = skip_m.new_zeros(d)
                wmax = torch.maximum(wmax, torch.cat([skip_m[d:], zpad]))
                wmax = torch.maximum(wmax, torch.cat([zpad, skip_m[:-d]]))
            wm_c = wmax[cc]
            if abs(SKIP_THR - 0.2) < 1e-12:
                over = wm_c * 5 > depth_c
            else:  # >= makes float32 rounding err on the safe (host) side
                over = (wm_c.to(torch.float32)
                        >= SKIP_THR * depth_c.to(torch.float32))
            maybe = over | ((depth_c == 0) & (wm_c > 0))
            if head_tail:
                maybe &= run_end[cc] >= cc + FLANK  # flush windows never pad
            flags = flags + torch.where(maybe, 2, 0)
        flags = torch.where(cand < W, flags, 0)

        # one f32 output: positions < 2^17, counts/depth < 2^24, and ranks
        # clamped to the 2^24 MAX_RANK sentinel (clamped sentinels only
        # fill absent groups, whose rank is never read downstream)
        grank_c = grank[cc][:, :4].clamp(max=tlt.MAX_RANK)
        body = torch.cat([
            cand[:, None].to(torch.float32),
            out,
            gcount[cc][:, :4].to(torch.float32),
            grank_c.to(torch.float32),
            ref_count[cc][:, None].to(torch.float32),
            depth_c[:, None].to(torch.float32),
            flags[:, None].to(torch.float32),
        ], dim=-1)
        header = torch.zeros((1, body.shape[1]), dtype=torch.float32,
                             device=dev)
        header[0, 0] = n_cand.to(torch.float32)
        if with_renorm_windows:
            # the raw windows reflowed to the body's column width: the host
            # slices them back by shape
            cols = body.shape[1]
            flat = windows.reshape(-1)
            k = -(-flat.shape[0] // cols)
            flat = torch.cat([flat, flat.new_zeros(k * cols - flat.shape[0])])
            return torch.cat([header, body, flat.reshape(k, cols)], dim=0)
        return torch.cat([header, body], dim=0)

    counts_fn = _counts_events if mode == "events" else _counts_packed

    def fused(t, core, sel=None):
        counts, grank6 = counts_fn(t)
        return _tail(counts, grank6, t, core, sel=sel)

    return fused


def resolve_wire():
    """Tilelet wire from CLAIR3_RNA_TORCH_TILELET_WIRE: "v2" (2-bit crumbs
    + validity bitmap, 96 B/row; default) or "nibble" (128 B/row)."""
    wire = os.environ.get("CLAIR3_RNA_TORCH_TILELET_WIRE", "v2")
    if wire not in ("nibble", "v2"):
        raise ValueError(f"bad CLAIR3_RNA_TORCH_TILELET_WIRE: {wire}")
    return wire


def resolve_mode():
    """Wire format from CLAIR3_RNA_TORCH_FUSED_MODE (packed|events); packed
    is the default."""
    mode = os.environ.get("CLAIR3_RNA_TORCH_FUSED_MODE", "packed")
    if mode not in ("packed", "events"):
        raise ValueError(f"bad CLAIR3_RNA_TORCH_FUSED_MODE: {mode}")
    return mode


class FusedChunkCaller:
    """Chunk-level driver around the fused pass: stage -> device -> rows.

    Candidates the fused pass cannot finish exactly are flagged in
    host_flags:

    - renormalization depth (bit 1): the raw windows ride the chunk's
      output (deep chunks select the fold variant up front) or are re-read
      from the staged tensors (`_renorm_records`); the reference's float64
      scale-then-truncate is applied on the host and the windows go through
      the host route's wire forward;
    - splice-padding trigger superset (bit 2): ISOLATED flagged candidates
      (no other candidate within 2*FLANK) are rebuilt on the host as
      1-position mini chunks (`_hatch_records`); clustered ones force a
      whole-chunk fallback because the host backfill mutates the shared
      image in place across neighboring windows.

    A chunk whose candidate count exceeds the budget reruns once at the
    smallest power-of-two budget that fits, up to max_budget. call_chunk
    returns None only for whole-chunk fallbacks.

    Thread-safe: the pipeline's prefetch pool calls call_chunk from two
    threads, so the counters and the adaptive budget sit behind a lock.
    """

    def __init__(self, params, cfg: PileupConfig, call_cfg,
                 max_candidates=1024, known_only=False, with_masks=False):
        self.cfg = cfg
        self.call_cfg = call_cfg
        self.params = params
        self.device = params.device
        self.max_candidates = max_candidates
        self.hatch_max = int(os.environ.get(
            "CLAIR3_RNA_TORCH_FUSED_HATCH_MAX", "64"))
        self.hatch_chunks = 0      # chunks that used the splice hatch
        self.hatch_candidates = 0  # candidates rebuilt host-side via hatch
        self.renorm_chunks = 0     # chunks with renorm candidates
        self.renorm_candidates = 0  # candidates renormalized on the host
        self.renorm_fold_chunks = 0    # renorm windows rode the main output
        self.renorm_window_fetches = 0  # separate windows-fetch passes
        self.fallback_chunks = 0   # whole-chunk host fallbacks
        # dense-candidate ceiling: shallow noisy data passes the AF test at
        # 2 reads, so real chunks reach 4-6k candidates per 100 kb
        self.max_budget = int(os.environ.get(
            "CLAIR3_RNA_TORCH_FUSED_MAX_BUDGET", "8192"))
        # adaptive starting budget: candidate density is locally
        # correlated, so start each chunk at a power of two sized from the
        # previous chunk's count (+25% headroom)
        self._next_budget = max_candidates
        self.overflow_retries = 0   # chunks rerun with a widened budget
        self.mode = resolve_mode()
        if cfg.phased and self.mode != "packed":
            raise ValueError("phased fused mode requires "
                             "CLAIR3_RNA_TORCH_FUSED_MODE=packed")
        self.wire = resolve_wire()
        self.known_only = known_only
        self.with_masks = with_masks
        self._lock = threading.Lock()
        # fused passes run so far, by (kind, budget, fold): the first of
        # each pays one-off costs (allocator growth, first launches)
        self._passes = set()

    def _count(self, name, delta=1):
        with self._lock:
            setattr(self, name, getattr(self, name) + delta)

    def counters(self):
        """Snapshot of the counters (cumulative over the caller's life)."""
        with self._lock:
            return {k: getattr(self, k) for k in (
                "renorm_candidates", "renorm_chunks", "renorm_fold_chunks",
                "renorm_window_fetches", "hatch_candidates",
                "hatch_chunks", "overflow_retries", "fallback_chunks")}

    def _fallback(self):
        """Record and request a whole-chunk host fallback."""
        self._count("fallback_chunks")
        return None

    @property
    def one_off_count(self):
        """One-off costs paid so far: the first fused pass at each budget
        (and fold, and the windows fetch) plus every CUDA library built or
        loaded in the process. A chunk whose call grows this count carries
        a wall the hybrid router must not learn from."""
        from clair3_rna_torch import csrc
        with self._lock:
            n = len(self._passes)
        return n + csrc.one_off_count()

    def _get_fused(self, budget, fold=False, kind="chunk"):
        with self._lock:
            self._passes.add((kind, budget, fold))
        return make_fused_fn(
            self.params, self.cfg, max_candidates=budget,
            known_only=self.known_only, with_masks=self.with_masks,
            with_renorm_windows=fold, wire=self.wire, mode=self.mode)

    def call_chunk(self, data, ref_codes, ctg_name, ref_seq, ref_lo,
                   core_lo, core_hi, cover_allow=None, cand_allow=None,
                   host_ctx=None):
        """One chunk: stage, run the fused pass, decode on the host.

        `data` is a PackedReads (mode="packed"; a PileupEvents is
        converted) or a PileupEvents (mode="events"). Returns
        (vcf_rows, n_candidates) or None for host fallback. `host_ctx`
        enables the per-candidate escape paths: a dict with "bam", "fasta",
        "forward" (the pipeline's wire forward, so escape-path
        probabilities equal host-route probabilities) and optionally
        "known_positions"/"bed_regions" for the splice-hatch mini builds."""
        from clair3_rna_torch.caller.decode import decode_batch
        from clair3_rna_torch.pileup.builder import (SparseIndels,
                                                     _alt_data_fast)

        if self.mode == "packed":
            if not hasattr(data, "tl_codes"):  # PileupEvents given: convert
                from clair3_rna_torch.pileup.packed import packed_from_events
                data = packed_from_events(data)
            if data.max_rank >= tlt.MAX_RANK:
                # rank exceeds the exact-f32 range: host route handles it
                return self._fallback()
            staged = stage_chunk_packed(data, ref_codes, self.cfg, core_lo,
                                        core_hi, cover_allow=cover_allow,
                                        cand_allow=cand_allow,
                                        wire=self.wire)
            indels = data.sparse_indels()
        else:
            max_rank = max((int(a.max()) for a in (
                data.base_rank, data.ins_rank, data.del_rank) if len(a)),
                default=0)
            if max_rank >= fsc.MAX_RANK:
                # the scatter kernel's ranks are f32: beyond 2^24 the host
                # route handles the chunk
                return self._fallback()
            staged = stage_chunk(data, ref_codes, self.cfg, core_lo,
                                 core_hi, cover_allow=cover_allow,
                                 cand_allow=cand_allow)
            indels = SparseIndels.from_events(data)
        tensors = staged_tensors(staged, self.device)
        core = (staged.core_lo, staged.core_hi)
        # deep chunks fold their raw windows into the one output (max
        # coverage bounds candidate depth, so only such chunks can flag
        # renorm candidates)
        max_depth = config.MAX_DEPTH_BY_PLATFORM.get(self.cfg.platform,
                                                     config.MAX_DEPTH)
        fold = bool(len(data.cover_count)
                    and int(data.cover_count.max()) > max_depth * 1.5)
        if fold:
            # the fold block is sized by the budget, so deep (candidate-
            # sparse) chunks always probe at the base budget
            budget = self.max_candidates
        else:
            with self._lock:
                budget = self._next_budget
        packed_out = self._get_fused(budget, fold)(tensors, core) \
            .cpu().numpy()
        n = int(packed_out[0, 0])
        if n > budget:
            # dense-candidate chunk: rerun the SAME staged tensors once at
            # the smallest power-of-two budget that fits (mask and counts
            # are budget-independent, only the padded gather widens)
            if n > self.max_budget:
                return self._fallback()
            while budget < n:
                budget *= 2
            self._count("overflow_retries")
            packed_out = self._get_fused(budget, fold)(tensors, core) \
                .cpu().numpy()
        if not fold:
            want = self.max_candidates
            while want < min(n + (n >> 2), self.max_budget):
                want *= 2
            with self._lock:
                self._next_budget = want
        win_rows = packed_out[1 + budget:]
        body = packed_out[1:1 + budget]
        P = body.shape[1] - 12
        cand = body[:, 0].astype(np.int64)
        out = body[:, 1:1 + P]
        gcounts = body[:, 1 + P:5 + P].astype(np.int64)
        granks = body[:, 5 + P:9 + P].astype(np.int64)
        ref_count = body[:, 9 + P].astype(np.int64)
        depth_c = body[:, 10 + P].astype(np.int64)
        flags = body[:, 11 + P].astype(np.int64)
        cand = cand[:n]
        flags = flags[:n]
        probs, needs_decode = out[:n, :-1], out[:n, -1] != 0.0
        if self.call_cfg.show_ref:
            needs_decode = np.ones(n, dtype=bool)
        if (flags >= 4).any():
            # depth beyond the AF-threshold table: candidacy itself unsound
            return self._fallback()

        pos_abs = cand.astype(np.int64) + staged.start
        ins_lo = np.searchsorted(indels.ins_pos, pos_abs, side="left")
        ins_hi = np.searchsorted(indels.ins_pos, pos_abs, side="right")
        del_lo = np.searchsorted(indels.del_pos, pos_abs, side="left")
        del_hi = np.searchsorted(indels.del_pos, pos_abs, side="right")
        eff = np.maximum(staged.ref_code[cand], 0)

        def _alt(i):
            return _alt_data_fast(
                indels, int(pos_abs[i]), int(depth_c[i]), int(eff[i]),
                gcounts[i].tolist(), granks[i].tolist(), int(ref_count[i]),
                int(ins_lo[i]), int(ins_hi[i]), int(del_lo[i]),
                int(del_hi[i]), ref_seq, ref_lo)

        host_rows = []
        splice_idx = np.nonzero((flags & 2) != 0)[0]
        if len(splice_idx):
            if host_ctx is None or len(splice_idx) > self.hatch_max:
                return self._fallback()
            # the host backfill mutates the shared image across +-FLANK, so
            # the 1-position mini rebuild is exact only for flagged
            # candidates with no other candidate within 2*FLANK
            for i in splice_idx:
                if ((i > 0 and cand[i] - cand[i - 1] <= 2 * FLANK)
                        or (i + 1 < n and cand[i + 1] - cand[i] <= 2 * FLANK)):
                    return self._fallback()
            recs = self._hatch_records(host_ctx, ctg_name, cand, splice_idx,
                                       staged.start)
            if recs is None:
                return self._fallback()
            from clair3_rna_torch.caller.pipeline import call_tensor_records
            host_rows += call_tensor_records(recs, host_ctx["forward"],
                                             self.params, self.cfg,
                                             self.call_cfg)
            needs_decode = needs_decode.copy()
            needs_decode[splice_idx] = False  # handled by the hatch
            self._count("hatch_chunks")
            self._count("hatch_candidates", len(splice_idx))

        renorm_idx = np.nonzero(flags == 1)[0]
        if len(renorm_idx):
            if host_ctx is None:
                return self._fallback()
            wins = None
            if fold and len(win_rows):
                n_ch = self.cfg.channel_size
                w = config.NO_OF_POSITIONS
                wins_all = win_rows.reshape(-1)[:budget * w * n_ch] \
                    .reshape(budget, w, n_ch)
                wins = wins_all[renorm_idx].astype(np.int32)
                self._count("renorm_fold_chunks")
            recs = self._renorm_records(tensors, core, ctg_name, staged,
                                        cand, renorm_idx, depth_c, ref_seq,
                                        ref_lo, _alt, wins=wins)
            from clair3_rna_torch.caller.pipeline import call_tensor_records
            host_rows += call_tensor_records(recs, host_ctx["forward"],
                                             self.params, self.cfg,
                                             self.call_cfg)
            needs_decode = needs_decode.copy()
            needs_decode[renorm_idx] = False  # handled by the renorm path
            self._count("renorm_chunks")
            self._count("renorm_candidates", len(renorm_idx))

        dec_idx = np.nonzero(needs_decode)[0]
        alt_data = [_alt(i) for i in dec_idx]
        from clair3_rna_torch.pileup.builder import _flanked_ref
        refseqs = [_flanked_ref(ref_seq, ref_lo, int(pos_abs[i]), FLANK)
                   for i in dec_idx]
        rows = decode_batch([ctg_name] * len(dec_idx),
                            [int(pos_abs[i]) + 1 for i in dec_idx],
                            refseqs, alt_data, probs[dec_idx], self.call_cfg)
        if host_rows:
            rows = sorted(rows + host_rows,
                          key=lambda r: int(r.split("\t", 2)[1]))
        return rows, n

    def _hatch_records(self, host_ctx, ctg_name, cand, flagged, start):
        """Targeted host rebuild of isolated splice-flagged candidates: each
        becomes a 1-position mini ChunkTask through build_chunk_tensors,
        whose +-33 row halo sees exactly the reads and coverage runs the
        full-chunk build would (window content, splice backfill and
        head/tail zeroing are window-local given the isolation
        precondition). Returns None to request whole-chunk fallback on a
        device/host candidacy disagreement (defensive)."""
        from clair3_rna_torch.pileup.chunk import (ChunkTask,
                                                   build_chunk_tensors)
        recs = []
        for i in flagged:
            p = int(cand[i]) + start
            mini = ChunkTask(ctg_name, p, p + 1)
            rr = build_chunk_tensors(
                host_ctx["bam"], host_ctx["fasta"], mini, self.cfg,
                known_positions=host_ctx.get("known_positions"),
                bed_regions=host_ctx.get("bed_regions"), device=self.device)
            rec = next((r for r in rr if r.position == p + 1), None)
            if rec is None:
                return None
            recs.append(rec)
        return recs

    def _renorm_records(self, tensors, core, ctg_name, staged, cand,
                        renorm_idx, depth_c, ref_seq, ref_lo, alt_fn,
                        wins=None):
        """Renorm-flagged candidates as TensorRecords from the DEVICE image.

        `wins` normally arrives from the fold rows of the chunk's output.
        Without it the staged tensors are re-read by a windows-fetch pass at
        the flagged centers. The reference's float64 scale-then-truncate
        (clair3_rna/utils.py:88-92) is then applied downstream by
        batch_wire/_stack_renormed exactly as on the host route."""
        from clair3_rna_torch.pileup.builder import TensorRecord, _flanked_ref

        if wins is None:
            self._count("renorm_window_fetches")
            sel = torch.from_numpy(cand[renorm_idx].astype(np.int64)) \
                .to(self.device)
            wins = self._get_fused(self.max_candidates, kind="windows")(
                tensors, core, sel=sel).cpu().numpy().astype(np.int32)
        recs = []
        for j, i in enumerate(renorm_idx):
            p = int(cand[i]) + staged.start
            recs.append(TensorRecord(
                ctg_name, p + 1, _flanked_ref(ref_seq, ref_lo, p, FLANK),
                wins[j], int(depth_c[i]),
                alt_thunk=(lambda i=int(i): alt_fn(i))))
        return recs
