"""Flat-event scatter: per-event (pos, chan, group, rank) -> channel-count
image + first-occurrence group ranks (the events wire of the fused pass).

  counts[c, p] = #events with chan c at position p
  grank[g, p]  = min rank over events with group g at p      (g in 0..5)

An event is inert (counts nothing, takes no rank) when its position lies
outside [0, W) or its channel outside [0, 32). Group 6 (star) counts but
takes no rank, and so does group 7 (pad); groups 6 and 7 and an empty group
read RANK_INF_F, as in the JAX package's oracle.

Events come in any order (the staging's, read-major): counts are sums and
ranks minima, so the result does not depend on it. `fused_scatter`
launches the hand-written CUDA kernel (csrc/scatter.cu) for CUDA tensors and
runs `fused_scatter_plain` for CPU tensors; `scatter_oracle` is the numpy
scalar-loop reference.
"""

import numpy as np
import torch

from clair3_rna_torch.ops import kernel_io

C_PAD = 32                # 18 channels padded to 32
G_PAD = 8                 # 6 rank groups padded to 8
G_RANK = 6                # groups that take a rank
RANK_INF_F = float(2 ** 30)   # empty group; exact in f32
MAX_RANK = 2 ** 24        # ranks must stay below this (exact in f32)

launches, reset_launches, _count_launch = kernel_io.launch_counter(
    "fused_scatter")


def scatter_oracle(ev_pos, ev_chan, ev_group, ev_rank, width):
    """Numpy reference: plain scatter loops, outputs position-minor like
    `fused_scatter`'s, inert events skipped as the module docstring says."""
    counts = np.zeros((C_PAD, width), np.int64)
    ranks = np.full((G_PAD, width), RANK_INF_F, np.float64)
    for p, c, g, r in zip(ev_pos, ev_chan, ev_group, ev_rank):
        if 0 <= p < width and 0 <= c < C_PAD:
            counts[c, p] += 1
            if 0 <= g < G_RANK:
                ranks[g, p] = min(ranks[g, p], float(r))
    return counts, ranks


# --- plain PyTorch version ---------------------------------------------------

def fused_scatter_plain(ev_pos, ev_chan, ev_group, ev_rank, width_pad):
    """index_add_ / scatter_reduce_("amin") version with the kernel's
    outputs: counts [C_PAD, W] f32 and grank [G_PAD, W] f32 (RANK_INF_F
    for an empty group)."""
    dev = ev_pos.device
    pos = ev_pos.to(torch.int64)
    chan = ev_chan.to(torch.int64)
    group = ev_group.to(torch.int64)
    live = (pos >= 0) & (pos < width_pad) & (chan >= 0) & (chan < C_PAD)
    pos_c = pos.clamp(0, width_pad - 1)
    counts = torch.zeros(C_PAD * width_pad, dtype=torch.int32, device=dev)
    counts.index_add_(0, chan.clamp(0, C_PAD - 1) * width_pad + pos_c,
                      live.to(torch.int32))
    ranked = live & (group >= 0) & (group < G_RANK)
    gidx = torch.where(ranked, group, G_PAD - 1) * width_pad + pos_c
    rank_e = torch.where(ranked, ev_rank.to(torch.int64), int(RANK_INF_F))
    granks = torch.full((G_PAD * width_pad,), int(RANK_INF_F),
                        dtype=torch.int64, device=dev)
    granks.scatter_reduce_(0, gidx, rank_e, "amin", include_self=True)
    granks = granks.reshape(G_PAD, width_pad)
    granks[G_RANK:] = int(RANK_INF_F)
    return (counts.reshape(C_PAD, width_pad).to(torch.float32),
            granks.to(torch.float32))


# --- kernel wrapper ------------------------------------------------------------

def fused_scatter(ev_pos, ev_chan, ev_group, ev_rank, width_pad):
    """Events in any order -> (counts [C_PAD, W] f32, grank [G_PAD, W] f32,
    RANK_INF_F = empty).

    ev_pos int32 [E], ev_chan/ev_group int8 [E], ev_rank int32 [E]
    (< MAX_RANK, so exact in f32). CUDA tensors launch the kernel
    (replacing clair3_rna_tpu/ops/fused_scatter.py _kernel); CPU tensors
    run fused_scatter_plain."""
    if width_pad <= 0:
        raise ValueError(f"width_pad {width_pad} is not positive")
    e = ev_pos.shape[0]
    kernel_io.check("ev_pos", ev_pos, torch.int32, (e,))
    kernel_io.check("ev_chan", ev_chan, torch.int8, (e,))
    kernel_io.check("ev_group", ev_group, torch.int8, (e,))
    kernel_io.check("ev_rank", ev_rank, torch.int32, (e,))
    dev = kernel_io.one_device("scatter", (ev_pos, ev_chan, ev_group,
                                           ev_rank))
    if dev.type == "cpu":
        return fused_scatter_plain(ev_pos, ev_chan, ev_group, ev_rank,
                                   width_pad)

    from clair3_rna_torch.csrc import launch_fused_scatter

    counts = torch.empty((C_PAD, width_pad), dtype=torch.float32,
                         device=dev)
    grank = torch.empty((G_PAD, width_pad), dtype=torch.float32, device=dev)
    launch_fused_scatter(ev_pos, ev_chan, ev_group, ev_rank, width_pad,
                         counts, grank)
    _count_launch("fused_scatter")
    return counts, grank
