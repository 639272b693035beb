"""Pileup channel counts for the pure-array builder: counts[p, c] = #events
at (position p, channel c), an integer histogram.

`pileup_counts` is the builder's dispatch (pileup/builder._scatter_count):

- backend "kernel": the events, in the order the builder gives them, are
  converted to the kernel's dtypes (`prepare`; in pinned host memory for a
  card) and counted by the hand-written CUDA kernel (csrc/scatter.cu)
  through `pileup_counts_kernel`; on a CPU device that wrapper runs
  `pileup_counts_plain` instead;
- backend "device": `pileup_counts_torch`, one torch.bincount on the run's
  device (the counterpart of the JAX package's XLA segment sum).

Either way the result comes back as a numpy [length, n_channels] int32
array. Channel ids are < C_PAD (18, 30 phased, or 4 group counts); an
event whose position lies outside [0, length_pad) or whose channel lies
outside [0, C_PAD) is inert.
"""

import numpy as np
import torch

from clair3_rna_torch.ops import kernel_io

C_PAD = 32                # channel ids < 32, output padded to 32 columns
LENGTH_ALIGN = 256        # length_pad is a multiple of this

launches, reset_launches, _count_launch = kernel_io.launch_counter(
    "pileup_counts")


def prepare(event_pos, event_channel, length, pin=False):
    """(ev_pos int32 tensor, ev_chan int8 tensor, length_pad): the events
    in the kernel's dtypes and in the order given, written straight into
    pinned host memory when `pin` (for a fast copy to a card). No sort."""
    length_pad = max(1, -(-length // LENGTH_ALIGN)) * LENGTH_ALIGN
    n = len(event_pos)
    pos = torch.empty(n, dtype=torch.int32, pin_memory=pin)
    chan = torch.empty(n, dtype=torch.int8, pin_memory=pin)
    pos.numpy()[:] = event_pos
    chan.numpy()[:] = event_channel
    return pos, chan, length_pad


def pileup_counts_plain(ev_pos, ev_chan, length_pad):
    """index_add_ version with the kernel's output: int32 [length_pad,
    C_PAD], position-major. Events outside [0, length_pad) or with a
    channel outside [0, C_PAD) are inert."""
    pos = ev_pos.to(torch.int64)
    chan = ev_chan.to(torch.int64)
    live = (pos >= 0) & (pos < length_pad) & (chan >= 0) & (chan < C_PAD)
    flat = (pos.clamp(0, length_pad - 1) * C_PAD
            + chan.clamp(0, C_PAD - 1))
    out = torch.zeros(length_pad * C_PAD, dtype=torch.int32,
                      device=ev_pos.device)
    out.index_add_(0, flat, live.to(torch.int32))
    return out.reshape(length_pad, C_PAD)


def pileup_counts_kernel(ev_pos, ev_chan, length_pad):
    """Events in any order -> int32 [length_pad, C_PAD].

    ev_pos int32 [E], ev_chan int8 [E]. CUDA tensors launch the kernel
    (replacing clair3_rna_tpu/ops/pileup_kernel.py _kernel); CPU tensors
    run pileup_counts_plain."""
    if length_pad <= 0 or length_pad % LENGTH_ALIGN:
        raise ValueError(f"length_pad {length_pad} is not a positive "
                         f"multiple of {LENGTH_ALIGN}")
    e = ev_pos.shape[0]
    kernel_io.check("ev_pos", ev_pos, torch.int32, (e,))
    kernel_io.check("ev_chan", ev_chan, torch.int8, (e,))
    dev = kernel_io.one_device("count", (ev_pos, ev_chan))
    if dev.type == "cpu":
        return pileup_counts_plain(ev_pos, ev_chan, length_pad)

    from clair3_rna_torch.csrc import launch_pileup_counts

    out = torch.empty((length_pad, C_PAD), dtype=torch.int32, device=dev)
    launch_pileup_counts(ev_pos, ev_chan, length_pad, out)
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
    dev = torch.device(device)
    card = dev.type == "cuda"
    pos, chan, length_pad = prepare(event_pos, event_channel, length,
                                    pin=card)
    out = pileup_counts_kernel(pos.to(dev, non_blocking=True),
                               chan.to(dev, non_blocking=True), length_pad)
    rows = out[:length]                  # contiguous: position-major
    if card:
        host = torch.empty(rows.shape, dtype=torch.int32, pin_memory=True)
        host.copy_(rows, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        rows = host
    return rows.numpy()[:, :n_channels]
