"""Pileup channel counts for the pure-array builder: counts[p, c] = #events
at (position p, channel c), an integer histogram.

`pileup_counts` is the builder's dispatch (pileup/builder._scatter_count):

- backend "kernel": events are bucketed by POS_TILE tile on the host
  (`prepare`) and counted by the hand-written CUDA kernel (csrc/scatter.cu)
  through `pileup_counts_kernel`; on a CPU device that wrapper runs
  `pileup_counts_plain` instead;
- backend "device": `pileup_counts_torch`, one torch.bincount on the run's
  device (the counterpart of the JAX package's XLA segment sum).

Either way the result comes back as a numpy [length, n_channels] int32
array. Channel ids are < C_PAD (18, 30 phased, or 4 group counts);
positions outside [0, length) are inert.
"""

import numpy as np
import torch

from clair3_rna_torch.ops import kernel_io
from clair3_rna_torch.ops.fused_scatter import (POS_TILE, tile_owned,
                                                tile_sort)

C_PAD = 32                # channel ids < 32, output padded to 32 columns

launches, reset_launches, _count_launch = kernel_io.launch_counter(
    "pileup_counts")


def prepare(event_pos, event_channel, length):
    """Host bucketing for the kernel (fused_scatter.tile_sort, the layout
    both kernels of csrc/scatter.cu take) -> (ev_pos int32, ev_chan int8,
    ev_off int32 [n_tiles + 1], length_pad)."""
    length_pad = max(1, -(-length // POS_TILE)) * POS_TILE
    pos = np.asarray(event_pos, np.int32)
    order, ev_off = tile_sort(pos, length_pad // POS_TILE)
    return (pos[order], np.asarray(event_channel, np.int8)[order], ev_off,
            length_pad)


def pileup_counts_plain(ev_pos, ev_chan, ev_off, length_pad):
    """index_add_ version with the kernel's output: int32 [length_pad,
    C_PAD], position-major. Counts what the kernel's CTAs read: events
    inside the tile whose offset range holds them (tile_owned), with a
    channel in [0, C_PAD)."""
    pos = ev_pos.to(torch.int64)
    chan = ev_chan.to(torch.int64)
    take = tile_owned(ev_pos, ev_off) & (chan >= 0) & (chan < C_PAD)
    flat = (pos.clamp(0, length_pad - 1) * C_PAD
            + chan.clamp(0, C_PAD - 1))
    out = torch.zeros(length_pad * C_PAD, dtype=torch.int32,
                      device=ev_pos.device)
    out.index_add_(0, flat, take.to(torch.int32))
    return out.reshape(length_pad, C_PAD)


def pileup_counts_kernel(ev_pos, ev_chan, ev_off, length_pad):
    """Tile-bucketed events (from `prepare`) -> int32 [length_pad, C_PAD].

    ev_pos int32 [E], ev_chan int8 [E], ev_off int32 [length_pad/POS_TILE
    + 1]. CUDA tensors launch the kernel (replacing
    clair3_rna_tpu/ops/pileup_kernel.py _kernel); CPU tensors run
    pileup_counts_plain."""
    if length_pad <= 0 or length_pad % POS_TILE:
        raise ValueError(f"length_pad {length_pad} is not a positive "
                         f"multiple of {POS_TILE}")
    e = ev_pos.shape[0]
    n_tiles = length_pad // POS_TILE
    kernel_io.check("ev_pos", ev_pos, torch.int32, (e,))
    kernel_io.check("ev_chan", ev_chan, torch.int8, (e,))
    kernel_io.check("ev_off", ev_off, torch.int32, (n_tiles + 1,))
    dev = kernel_io.one_device("count", (ev_pos, ev_chan, ev_off))
    if dev.type == "cpu":
        return pileup_counts_plain(ev_pos, ev_chan, ev_off, length_pad)

    from clair3_rna_torch.csrc import launch_pileup_counts

    out = torch.empty((length_pad, C_PAD), dtype=torch.int32, device=dev)
    launch_pileup_counts(ev_pos, ev_chan, ev_off, n_tiles, out)
    _count_launch("pileup_counts")
    return out


def pileup_counts_torch(event_pos, event_channel, length, n_channels,
                        device):
    """One torch.bincount on `device`: int32 tensor [length, n_channels]
    (positions must lie in [0, length), channels in [0, n_channels))."""
    pos = torch.as_tensor(np.asarray(event_pos, np.int64)).to(device)
    chan = torch.as_tensor(np.asarray(event_channel, np.int64)).to(device)
    flat = torch.bincount(pos * n_channels + chan,
                          minlength=length * n_channels)
    return flat.to(torch.int32).reshape(length, n_channels)


def pileup_counts(event_pos, event_channel, length, n_channels, backend,
                  device):
    """counts[length, n_channels] int32 numpy from (pos, channel) events on
    `device` through `backend` ("kernel" or "device"). No events: zeros,
    no launch."""
    if len(event_pos) == 0:
        return np.zeros((length, n_channels), np.int32)
    if backend == "device":
        out = pileup_counts_torch(event_pos, event_channel, length,
                                  n_channels, device)
        return out.cpu().numpy()
    if backend != "kernel":
        raise ValueError(f"bad count backend {backend!r} (kernel|device)")
    pos, chan, off, length_pad = prepare(event_pos, event_channel, length)
    out = pileup_counts_kernel(torch.from_numpy(pos).to(device),
                               torch.from_numpy(chan).to(device),
                               torch.from_numpy(off).to(device), length_pad)
    return out[:length, :n_channels].cpu().numpy()
