"""PyTorch Bi-LSTM pileup genotyping network.

Architecturally identical to the reference Keras `Clair3_P`
(clair3_rna/model.py:88-216) and to the JAX package's PileupNet:
BiLSTM(128) -> BiLSTM(160) -> flatten -> Dense(128, selu) -> two heads (gt21
21-way, zygosity 3-way; optionally two 33-way variant-length heads), each
Dense(selu) -> Dense(selu) -> softmax. Weights keep the Keras layout (kernel
[in, out], LSTM gate order i,f,g,o, one bias per direction), so the JAX
package's npz files and TF checkpoints load 1:1 (models/params_io.py).

The input projections of all 33 timesteps (both directions) are one matmul;
the recurrence is a Python loop of matmuls, as the JAX package runs it
outside any kernel. No cuDNN LSTM: its second bias and fused gates would
change the arithmetic.

Rows are computed in fixed slabs (the batch is padded to a whole number of
slabs): every matmul then has the same shape whatever the caller's batch,
so the BLAS picks the same kernel and a row's probabilities do not depend
on which batch it rode in. The host route (cross-chunk batches) and the
fused route (per-chunk candidate budgets) must emit identical rows; without
slabs the same rows differ between batch sizes, by up to ~3e-7 on an H100
and at batches of a few rows on the CPU. On a card an eager pass is bound
by its ~1,490 launches and costs the same from 64 to 4096 rows on an H100
(chip_smoke.py logs both), so the slab is 4096 rows: the host route's
2048-row batches and the fused route's candidate budgets (1024 and up) take
one pass each. On the CPU padding rows cost real time, so the slab is 64.

On a card those launches are host time, so an inference slab replays a
CUDA graph of itself: the same kernels on the same shapes, so the same
bits. A module's first slab of each (device, channels, slab rows) runs
eagerly; later ones take a free graph slot (its graph, static input and
output, its own memory pool, ~2.5 GB at 4096 rows), capturing one when none
is free, up to GRAPH_SLOTS a key for the callers that run at once (two
prefetch threads and the main thread), and run eagerly beyond that. A
replay copies the slab in, replays and copies the output out on the
caller's stream, so what forward returns never aliases a slot. Training,
tensors autograd records, the CPU and the mesh's shells (parallel/mesh.py,
whose layers are not this module's) stay eager. The counters net_slabs
and net_graph_slabs (caller/spans.py) count a chunk's slabs and replays.

Training (`forward(x, train=True, generator=g)`) runs the whole batch as
one unslabbed pass with the JAX model's five dropout sites active:
inverted dropout (kept values scaled by 1/(1-p)) of 0.2 after lstm2, 0.5
after the L4 selu and 0.2 after each head's dense, its masks drawn from
the explicit generator `g` (none without one). Inference never draws a
mask and keeps its slabs.
"""

import math
import threading
import weakref

import numpy as np
import torch
from torch import nn

from clair3_rna_torch import config, resolve_device
from clair3_rna_torch.caller import spans

NET_SLAB = {"cuda": 4096, "cpu": 64}
# graph slots a module keeps a key: two prefetch threads and the main thread
GRAPH_SLOTS = 3
# dropout rates of the JAX model (clair3_rna_tpu/models/network.py): after
# lstm2, after the L4 selu (the reference's L4 dropout takes the LSTM2
# rate, clair3_rna/model.py:144), after each head's dense
L3_DROPOUT, L4_DROPOUT, HEAD_DROPOUT = 0.2, 0.5, 0.2
# GT21 indices of the homozygous-reference labels AA/CC/GG/TT (task.GT21)
_REF_GT21_BY_CODE = (0, 4, 7, 9)
_REF_GT21 = {}  # device -> _REF_GT21_BY_CODE on it (prescreen_column)


class LSTMDirection(nn.Module):
    """One LSTM direction in Keras layout (gates i,f,g,o)."""

    def __init__(self, in_dim, units):
        super().__init__()
        self.units = units
        self.kernel = nn.Parameter(torch.empty(in_dim, 4 * units))
        self.recurrent_kernel = nn.Parameter(torch.empty(units, 4 * units))
        self.bias = nn.Parameter(torch.empty(4 * units))


def _gates(z, c, units):
    i = torch.sigmoid(z[:, :units])
    f = torch.sigmoid(z[:, units:2 * units])
    g = torch.tanh(z[:, 2 * units:3 * units])
    o = torch.sigmoid(z[:, 3 * units:])
    c = f * c + i * g
    return o * torch.tanh(c), c


class BiLSTM(nn.Module):
    """Bidirectional LSTM over [B, T, D] -> [B, T, 2U] (forward then
    backward features, as Keras' Bidirectional concat)."""

    def __init__(self, in_dim, units):
        super().__init__()
        self.units = units
        self.fwd = LSTMDirection(in_dim, units)
        self.bwd = LSTMDirection(in_dim, units)

    def forward(self, x):
        b, t, _ = x.shape
        u = self.units
        k = torch.cat([self.fwd.kernel, self.bwd.kernel], dim=1)
        bias = torch.cat([self.fwd.bias, self.bwd.bias])
        xp = torch.matmul(x, k) + bias                      # [B, T, 8U]
        xp_f, xp_b = xp[..., :4 * u], xp[..., 4 * u:]
        rf, rb = self.fwd.recurrent_kernel, self.bwd.recurrent_kernel
        hf = cf = hb = cb = x.new_zeros((b, u))
        outs_f, outs_b = [], []
        for s in range(t):
            hf, cf = _gates(xp_f[:, s] + torch.matmul(hf, rf), cf, u)
            hb, cb = _gates(xp_b[:, t - 1 - s] + torch.matmul(hb, rb), cb, u)
            outs_f.append(hf)
            outs_b.append(hb)
        fwd = torch.stack(outs_f, dim=1)
        bwd = torch.stack(outs_b[::-1], dim=1)
        return torch.cat([fwd, bwd], dim=-1)


class Dense(nn.Module):
    """x @ kernel + bias with a Keras-layout [in, out] kernel."""

    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def forward(self, x):
        return torch.matmul(x, self.kernel) + self.bias


def _dropout(x, keep, rate):
    """Inverted dropout with a boolean keep mask (flax.linen.Dropout's
    arithmetic: kept values divided by the keep probability)."""
    return torch.where(keep.to(x.device), x / (1.0 - rate), 0.0)


class PileupNet(nn.Module):
    """gt21 + zygosity (+ variant length) pileup classifier over
    [B, 33, in_channels] (18 channels, or 30 for the phased model)."""

    def __init__(self, add_indel_length=False, in_channels=None,
                 lstm1_units=128, lstm2_units=160, dense_units=128,
                 head_units=128):
        super().__init__()
        self.add_indel_length = add_indel_length
        self.in_channels = in_channels or config.CHANNEL_SIZE
        self.dense_units, self.head_units = dense_units, head_units
        self.lstm1 = BiLSTM(self.in_channels, lstm1_units)
        self.lstm2 = BiLSTM(2 * lstm1_units, lstm2_units)
        self.l4 = Dense(config.NO_OF_POSITIONS * 2 * lstm2_units, dense_units)
        widths = [("gt21", 21), ("genotype", 3)]
        if add_indel_length:
            widths += [("length1", config.NO_OF_POSITIONS),
                       ("length2", config.NO_OF_POSITIONS)]
        self.head_names = [name for name, _ in widths]
        for name, width in widths:
            setattr(self, f"{name}_dense", Dense(dense_units, head_units))
            setattr(self, f"{name}_logits", Dense(head_units, width))

    @property
    def device(self):
        return self.l4.kernel.device

    @property
    def n_probs(self):
        return 24 + (2 * config.NO_OF_POSITIONS if self.add_indel_length
                     else 0)

    def dropout_masks(self, batch, generator):
        """Keep masks of the five dropout sites for `batch` rows, in the
        JAX model's order (l3, l4, then one per head), drawn from
        `generator` on its device."""
        shapes = [((batch, config.NO_OF_POSITIONS, 2 * self.lstm2.units),
                   L3_DROPOUT), ((batch, self.dense_units), L4_DROPOUT)]
        shapes += [((batch, self.head_units), HEAD_DROPOUT)] \
            * len(self.head_names)
        return [torch.rand(shape, generator=generator,
                           device=generator.device) < 1.0 - rate
                for shape, rate in shapes]

    def _slab(self, x, masks=None):
        x = self.lstm2(self.lstm1(x))
        if masks is not None:
            x = _dropout(x, masks[0], L3_DROPOUT)
        x = torch.selu(self.l4(x.reshape(x.shape[0], -1)))
        if masks is not None:
            x = _dropout(x, masks[1], L4_DROPOUT)
        outs = []
        for i, name in enumerate(self.head_names):
            h = torch.selu(getattr(self, f"{name}_dense")(x))
            if masks is not None:
                h = _dropout(h, masks[2 + i], HEAD_DROPOUT)
            logits = torch.selu(getattr(self, f"{name}_logits")(h))
            outs.append(torch.softmax(logits.float(), dim=-1))
        return torch.cat(outs, dim=-1)

    def forward(self, x, train=False, generator=None):
        """[B, 33, C] float32 -> [B, n_probs] probabilities. With
        train=True: one unslabbed pass over the batch, dropout masks from
        `generator` (no dropout without one)."""
        if train:
            masks = None if generator is None \
                else self.dropout_masks(x.shape[0], generator)
            return self._slab(x, masks)
        return self.forward_slabs(x)

    def forward_slabs(self, x):
        """Inference in fixed slabs, replayed from CUDA graphs where
        _slab_graphs allows (module docstring)."""
        n = x.shape[0]
        slab = NET_SLAB[x.device.type]
        n_pad = -(-n // slab) * slab
        if n_pad != n:
            x = torch.cat([x, x.new_zeros((n_pad - n,) + tuple(x.shape[1:]))])
        graphs = self._slab_graphs(x)
        key = (x.device, x.shape[-1], slab)
        outs, replayed = [], 0
        for lo in range(0, n_pad, slab):
            out = None if graphs is None else graphs.run(self, key,
                                                         x[lo:lo + slab])
            if out is None:
                out = self._slab(x[lo:lo + slab])
            else:
                replayed += 1
            outs.append(out)
        spans.count("net_slabs", len(outs))
        spans.count("net_graph_slabs", replayed)
        return (outs[0] if len(outs) == 1 else torch.cat(outs))[:n]

    def _slab_graphs(self, x):
        """This module's graph slots if its slabs of x may replay a graph,
        else None: float32 on a CUDA device, autograd not recording, and a
        plain PileupNet (its own layers, not a mesh shell's) whose weights
        all lie on x's device. Slots captured from other weight tensors
        are dropped."""
        if x.device.type != "cuda" or x.dtype != torch.float32:
            return None
        if any(type(m) not in (BiLSTM, Dense) for m in self.children()):
            return None
        params = list(self.parameters())
        if not params or any(p.device != x.device for p in params):
            return None
        if torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in params)):
            return None
        weights = tuple(p.data_ptr() for p in params)
        with _GRAPHS_LOCK:
            graphs = _GRAPHS.get(self)
            if graphs is None or graphs.weights != weights:
                graphs = _GRAPHS[self] = _SlabGraphs(weights)
        return graphs


class _Slot:
    """One captured slab: its graph, static input and output, and an event
    after its last copy-out."""

    def __init__(self, graph, x, out):
        self.graph, self.x, self.out = graph, x, out
        self.done = torch.cuda.Event()


class _SlabGraphs:
    """A module's graph slots by key (device, channels, slab rows), behind a
    lock: the first slab of a key runs eagerly (the warm-up a capture
    needs), a free slot replays, a new slot is captured while fewer than
    GRAPH_SLOTS exist, and beyond that the slab runs eagerly."""

    def __init__(self, weights):
        self.weights = weights
        self._lock = threading.Lock()
        self._seen = set()
        self._free = {}
        self._made = {}

    def _take(self, key):
        """-> a free slot, "capture" (one more slot is the caller's to
        capture), or None (run eagerly)."""
        with self._lock:
            if key not in self._seen:
                self._seen.add(key)
                return None
            free = self._free.setdefault(key, [])
            if free:
                return free.pop()
            if self._made.get(key, 0) < GRAPH_SLOTS:
                self._made[key] = self._made.get(key, 0) + 1
                return "capture"
            return None

    def run(self, net, key, xs):
        """net's slab xs [slab, 33, C] replayed from a slot -> a fresh
        output tensor, or None if it is to run eagerly."""
        slot = self._take(key)
        if slot is None:
            return None
        stream = torch.cuda.current_stream(xs.device)
        if slot == "capture":
            try:
                slot = _capture(net, xs, stream)
            except BaseException:
                with self._lock:
                    self._made[key] -= 1
                raise
        else:
            stream.wait_event(slot.done)  # its last user's copy-out
            with torch.inference_mode():
                slot.x.copy_(xs)
        slot.graph.replay()
        out = slot.out.clone()
        slot.done.record(stream)
        with self._lock:
            self._free[key].append(slot)
        return out


def _capture(net, xs, stream):
    """A new slot holding net's slab of xs's shape, captured on a side
    stream after a warm-up there (this thread's BLAS handle and workspace
    made outside the capture); its static input holds xs. One capture at
    a time; thread-local capture mode, so the other threads' launches,
    syncs and allocations go on."""
    dev = xs.device
    with _CAPTURE_LOCK, torch.inference_mode():
        x = xs.clone()
        side = _CAPTURE_STREAMS.get(dev)
        if side is None:
            side = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            net._slab(x)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = net._slab(x)
            finally:
                graph.capture_end()
        stream.wait_stream(side)
    return _Slot(graph, x, out)


# graph slots by module, without keeping a module alive or entering its
# state (deepcopy, state_dict); one capture stream a device
_GRAPHS = weakref.WeakKeyDictionary()
_GRAPHS_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()
_CAPTURE_STREAMS = {}


def _as_tensor(a, device, dtype=None):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def make_forward_fn(add_indel_length=False):
    """-> (model, forward) with forward(params, x) -> [B, n_probs] tensor on
    params' device; params is a PileupNet holding the weights and `model`
    an architecture-only PileupNet, as the JAX package's pair."""
    model = PileupNet(add_indel_length=add_indel_length)

    @torch.inference_mode()
    def forward(params, x):
        return params(_as_tensor(x, params.device, torch.float32))

    return model, forward


def prescreen_column(probs, center_codes):
    """homRef early-exit verdict (clair3_rna/call_variants.py:540-542) as a
    0/1 float column: 1 = needs host decode. center_codes [B] are the
    reference-base codes (0..3) at the window centers."""
    ref_gt21 = _REF_GT21.get(probs.device)
    if ref_gt21 is None:
        # copied once a device: a copy from host memory waits for the
        # device's queue, which would hold the caller up mid-pass
        ref_gt21 = _REF_GT21[probs.device] = torch.tensor(
            _REF_GT21_BY_CODE, dtype=torch.int64, device=probs.device)
    ref_idx = ref_gt21[center_codes.to(torch.int64)]
    ref_prob = probs[:, :21].gather(1, ref_idx[:, None])[:, 0]
    certain_ref = (probs[:, 21] >= 0.5) & (ref_prob >= 0.5)
    return (~certain_ref).to(torch.float32)[:, None]


def _is_uint8(a):
    if isinstance(a, torch.Tensor):
        return a.dtype == torch.uint8
    return a.dtype == np.uint8


def make_wire_forward_fn(add_indel_length=False):
    """Wire decode + forward + homRef prescreen.

    forward(params, wire, codes) takes the pipeline's candidate windows as
    unsigned uint8 channel magnitudes (or signed int16/int32 when a row's
    depth exceeds 255) plus per-row reference-base codes [B, 33]. On the
    device it rebuilds the signs -- after the reference-channel negation the
    ref base's fwd/rev channels (code, code+9) are the only negative entries
    -- runs the network and appends the prescreen verdict: one
    [B, n_probs + 1] tensor on params' device (one host fetch per batch).
    forward.wire marks the capability for the pipeline's dispatch."""
    model = PileupNet(add_indel_length=add_indel_length)
    n_ch = config.CHANNEL_SIZE

    @torch.inference_mode()
    def forward(params, wire, codes):
        dev = params.device
        codes = _as_tensor(codes, dev, torch.int64)
        if _is_uint8(wire):
            mags = _as_tensor(wire, dev).to(torch.float32)
            c = torch.arange(n_ch, device=dev)[None, None, :]
            cc = codes[:, :, None]
            neg = (c == cc) | (c == cc + 9)
            x = torch.cat([torch.where(neg, -mags[..., :n_ch],
                                       mags[..., :n_ch]),
                           mags[..., n_ch:]], dim=-1)
        else:
            x = _as_tensor(wire, dev, torch.float32)
        probs = params(x)
        return torch.cat([probs, prescreen_column(
            probs, codes[:, config.FLANKING_BASE_NUM])], dim=-1)

    forward.wire = True
    return model, forward


def _keras_init_(net, generator):
    """Keras/Flax default initializers: glorot-uniform input kernels,
    orthogonal recurrent kernels, unit forget-gate bias; lecun-normal dense
    kernels with zero bias (flax.linen.Dense)."""
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, LSTMDirection):
                fan_in, fan_out = mod.kernel.shape
                lim = math.sqrt(6.0 / (fan_in + fan_out))
                mod.kernel.uniform_(-lim, lim, generator=generator)
                q = torch.empty(4 * mod.units, mod.units)
                q.normal_(generator=generator)
                q, r = torch.linalg.qr(q)
                q *= torch.sign(torch.diagonal(r))[None, :]
                mod.recurrent_kernel.copy_(q.T)
                mod.bias.zero_()
                mod.bias[mod.units:2 * mod.units] = 1.0
            elif isinstance(mod, Dense):
                fan_in = mod.kernel.shape[0]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(mod.kernel, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                mod.kernel.mul_(std)
                mod.bias.zero_()


def init_params(seed=0, add_indel_length=False, phased=False, device=None):
    """A PileupNet with random weights from `seed` (explicit generator), on
    `device`: CUDA unless the caller asks for "cpu"."""
    device = resolve_device(device)
    channels = config.CHANNEL_SIZE + (config.PHASED_CHANNEL_SIZE if phased
                                      else 0)
    net = PileupNet(add_indel_length=add_indel_length, in_channels=channels)
    gen = torch.Generator().manual_seed(int(seed))
    _keras_init_(net, gen)
    return net.requires_grad_(False).to(device).eval()
