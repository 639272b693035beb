"""Flat-event scatter: per-event (pos, chan, group, rank) -> channel-count
image + first-occurrence group ranks (the events wire of the fused pass).

  counts[c, p] = #events with chan c at position p
  grank[g, p]  = min rank over events with group g at p      (g in 0..5)

Group 6 (star) counts but takes no rank, group 7 (pad) takes no rank
either, and an event whose position lies outside [0, W) is inert. A pad
event therefore sits at position W (the staging guarantees it); its group
does not gate its count, as in the JAX package's kernel and oracle.

Events reach the device bucketed by POS_TILE-position tile (`bucket_events`,
a stable host sort), so tile t owns the contiguous range
[ev_off[t], ev_off[t+1]). `fused_scatter` launches the hand-written CUDA
kernel (csrc/scatter.cu) for CUDA tensors and runs `fused_scatter_plain`
for CPU tensors; `scatter_oracle` is the numpy scalar-loop reference.
"""

import numpy as np
import torch

from clair3_rna_torch.ops import kernel_io

POS_TILE = 256            # positions per tile (one CTA of the kernel)
TILE_SHIFT = 8
C_PAD = 32                # 18 channels padded to 32
G_PAD = 8                 # 6 rank groups padded to 8
RANK_INF_F = float(2 ** 30)   # empty group; exact in f32
MAX_RANK = 2 ** 24        # ranks must stay below this (exact in f32)

launches, reset_launches, _count_launch = kernel_io.launch_counter(
    "fused_scatter")


# --- host staging -------------------------------------------------------------

def tile_sort(ev_pos, n_tiles):
    """(order, ev_off) for int32 positions: the stable order that buckets
    events by POS_TILE tile (numpy radix sort, O(E)) and the int32 offsets
    [n_tiles + 1] of the sorted events, so tile t owns [ev_off[t],
    ev_off[t+1]). Events at negative positions sort before ev_off[0] and
    events at or beyond n_tiles * POS_TILE after ev_off[n_tiles], so no
    tile owns them. Both kernels of csrc/scatter.cu take this layout."""
    key = ev_pos >> TILE_SHIFT
    order = np.argsort(key, kind="stable")
    ev_off = np.searchsorted(key[order], np.arange(n_tiles + 1))
    return order, ev_off.astype(np.int32)


def bucket_events(ev_pos, ev_chan, ev_group, ev_rank, width_pad):
    """Events bucketed by tile (tile_sort): {"ev_pos" int32, "ev_chan" int8,
    "ev_group" int8, "ev_rank" int32, "ev_off" int32 [n_tiles + 1]}.
    Nothing is padded: PyTorch compiles no shapes."""
    ev_pos = np.asarray(ev_pos, np.int32)
    order, ev_off = tile_sort(ev_pos, width_pad // POS_TILE)
    return {
        "ev_pos": ev_pos[order],
        "ev_chan": np.asarray(ev_chan, np.int8)[order],
        "ev_group": np.asarray(ev_group, np.int8)[order],
        "ev_rank": np.asarray(ev_rank, np.int32)[order],
        "ev_off": ev_off,
    }


def scatter_oracle(ev_pos, ev_chan, ev_group, ev_rank, width):
    """Numpy reference: plain scatter loops, outputs position-minor like
    `fused_scatter`'s."""
    counts = np.zeros((C_PAD, width), np.int64)
    ranks = np.full((G_PAD, width), RANK_INF_F, np.float64)
    for p, c, g, r in zip(ev_pos, ev_chan, ev_group, ev_rank):
        if 0 <= p < width:
            counts[c, p] += 1
            if 0 <= g < 6:
                ranks[g, p] = min(ranks[g, p], float(r))
    return counts, ranks


# --- plain PyTorch version ---------------------------------------------------

def tile_owned(ev_pos, ev_off):
    """[E] bool: the event lies inside the tile whose offset range holds
    its index (what the kernels' CTAs count: one CTA per tile, so nothing
    outside [0, n_tiles * POS_TILE) either)."""
    dev = ev_pos.device
    idx = torch.arange(ev_pos.shape[0], dtype=torch.int32, device=dev)
    tile = torch.searchsorted(ev_off, idx, right=True, out_int32=True) - 1
    n_tiles = ev_off.shape[0] - 1
    pos = ev_pos.to(torch.int64)
    return ((tile >= 0) & (tile < n_tiles) & (pos >= 0)
            & ((pos >> TILE_SHIFT) == tile))


def fused_scatter_plain(ev_pos, ev_chan, ev_group, ev_rank, ev_off,
                        width_pad):
    """index_add_ / scatter_reduce_("amin") version with the kernel's
    outputs: counts [C_PAD, W] f32 and grank [G_PAD, W] f32 (RANK_INF_F
    for an empty group)."""
    dev = ev_pos.device
    owned = tile_owned(ev_pos, ev_off)
    pos_c = ev_pos.to(torch.int64).clamp(0, width_pad - 1)
    chan = ev_chan.to(torch.int64)
    take = owned & (chan >= 0) & (chan < C_PAD)
    counts = torch.zeros(width_pad * C_PAD, dtype=torch.int32, device=dev)
    counts.index_add_(0, pos_c * C_PAD + chan.clamp(0, C_PAD - 1),
                      take.to(torch.int32))
    group = ev_group.to(torch.int64)
    ranked = owned & (group >= 0) & (group < 6)
    gidx = pos_c * G_PAD + torch.where(ranked, group, G_PAD - 1)
    rank_e = torch.where(ranked, ev_rank.to(torch.int64), int(RANK_INF_F))
    granks = torch.full((width_pad * G_PAD,), int(RANK_INF_F),
                        dtype=torch.int64, device=dev)
    granks.scatter_reduce_(0, gidx, rank_e, "amin", include_self=True)
    granks = granks.reshape(width_pad, G_PAD)
    granks[:, 6:] = int(RANK_INF_F)
    return (counts.reshape(width_pad, C_PAD).T.to(torch.float32)
            .contiguous(),
            granks.T.to(torch.float32).contiguous())


# --- kernel wrapper ------------------------------------------------------------

def fused_scatter(ev_pos, ev_chan, ev_group, ev_rank, ev_off, width_pad):
    """Tile-bucketed events -> (counts [C_PAD, W] f32, grank [G_PAD, W]
    f32, RANK_INF_F = empty).

    ev_pos int32 [E], ev_chan/ev_group int8 [E], ev_rank int32 [E]
    (< MAX_RANK, so exact in f32), ev_off int32 [W/POS_TILE + 1] from
    `bucket_events`. CUDA tensors launch the kernel (replacing
    clair3_rna_tpu/ops/fused_scatter.py _kernel); CPU tensors run
    fused_scatter_plain."""
    if width_pad <= 0 or width_pad % POS_TILE:
        raise ValueError(f"width_pad {width_pad} is not a positive multiple "
                         f"of {POS_TILE}")
    e = ev_pos.shape[0]
    n_tiles = width_pad // POS_TILE
    kernel_io.check("ev_pos", ev_pos, torch.int32, (e,))
    kernel_io.check("ev_chan", ev_chan, torch.int8, (e,))
    kernel_io.check("ev_group", ev_group, torch.int8, (e,))
    kernel_io.check("ev_rank", ev_rank, torch.int32, (e,))
    kernel_io.check("ev_off", ev_off, torch.int32, (n_tiles + 1,))
    dev = kernel_io.one_device("scatter", (ev_pos, ev_chan, ev_group,
                                           ev_rank, ev_off))
    if dev.type == "cpu":
        return fused_scatter_plain(ev_pos, ev_chan, ev_group, ev_rank,
                                   ev_off, width_pad)

    from clair3_rna_torch.csrc import launch_fused_scatter

    counts = torch.empty((C_PAD, width_pad), dtype=torch.float32,
                         device=dev)
    grank = torch.empty((G_PAD, width_pad), dtype=torch.float32, device=dev)
    launch_fused_scatter(ev_pos, ev_chan, ev_group, ev_rank, ev_off,
                         n_tiles, width_pad, counts, grank)
    _count_launch("fused_scatter")
    return counts, grank
