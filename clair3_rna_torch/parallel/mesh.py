"""Device mesh: dp x tp sharded inference and training in one process.

The JAX package's mesh is single-controller: one process drives every
local device, and forward(params, x) returns the whole batch. This is its
PyTorch counterpart, with no torch.distributed in it (a process group would
have every rank repeat the host pipeline for the same chunks):

  - a Mesh is a [dp, tp] grid of torch.devices (a device may repeat);
  - shard_params lays each PileupNet weight out per param_spec: each dp row
    holds it replicated on its tp devices or split across them;
  - the batch axis splits over dp rows (candidate windows are
    embarrassingly parallel, mirroring the reference's chunk fan-out);
  - within a row, column-parallel LSTM gates and dense outputs are gathered
    by columns onto the row's first device (the LSTM gathers its full gate
    row z every one of its 33 steps, since gates i,f and g,o land on
    different tp devices when tp = 2), and the row-parallel L4 sums its
    partial products there;
  - probabilities return on the mesh's first device.

Each dp slice runs the network's fixed inference slabs (models/network.py),
so tp=1 rows are bit-identical to one device; tp > 1 changes the float32
rounding order of the split matmuls and sums. A training step sums each
weight's gradients over the dp replicas and applies one update, written
back to every replica.
"""

import numpy as np
import torch
from torch import nn

from clair3_rna_torch import config
from clair3_rna_torch.models.network import PileupNet, _gates

REPLICATE = "replicate"
# the flatten->L4 dense is the one kernel whose INPUT dimension is large
# (33 positions x 2*160 lstm2 features); anything above this is row-sharded
_ROW_PARALLEL_MIN_FAN_IN = 1024


class Mesh:
    """A ('dp', 'tp') grid of torch.devices: devices[r][j] holds tp piece j
    of dp row r. shape is {"dp": dp, "tp": tp}, as jax.sharding.Mesh."""

    def __init__(self, devices):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        self.shape = {"dp": len(self.devices), "tp": len(self.devices[0])}

    @property
    def device(self):
        """The mesh's first device: where inputs gather and outputs land."""
        return self.devices[0][0]


def make_mesh(n_devices=None, tp=1, devices=None):
    """Build a ('dp', 'tp') mesh over `devices` (default: every CUDA
    device; a list may repeat a device, e.g. [torch.device("cpu")] * 8)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device for the mesh: pass devices= "
                               "(e.g. [torch.device('cpu')] * n)")
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % tp != 0:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    return Mesh([devices[r * tp:(r + 1) * tp] for r in range(n // tp)])


def _is_row_parallel(leaf):
    return leaf.ndim == 2 and leaf.shape[0] >= _ROW_PARALLEL_MIN_FAN_IN


def param_spec(path_names, leaf, tp=1):
    """Split dim (0 or 1) or REPLICATE for one parameter leaf, decided
    STRUCTURALLY (by shape), never by name -- the JAX package's rules:
    the large-fan-in kernel (flatten->L4, [33*320, 128]) splits its rows;
    other kernels split their output (gate) columns when they divide by tp
    and are at least 64 wide; 1-D leaves split likewise; else replicate."""
    del path_names  # structural rules only
    if leaf.ndim == 2:
        if _is_row_parallel(leaf) and leaf.shape[0] % tp == 0:
            return 0                 # row-parallel: [33*320/tp, 128]
        if leaf.shape[1] % tp == 0 and leaf.shape[1] >= 64:
            return 1                 # column-parallel gates/heads
        return REPLICATE
    if leaf.ndim == 1 and leaf.shape[0] % tp == 0 and leaf.shape[0] >= 64:
        return 0
    return REPLICATE


def _spec_for_module(module_params, leaf_name, leaf, tp):
    """param_spec with the row-parallel bias exception resolved from the
    sibling kernel's shape: the output of a row-parallel matmul is complete
    after its sum, so its bias replicates."""
    if leaf.ndim == 1:
        kernel = module_params.get("kernel")
        if kernel is not None and _is_row_parallel(kernel):
            return REPLICATE
    return param_spec((leaf_name,), leaf, tp=tp)


def _place(t, spec, row):
    """One dp row's copy of leaf `t`: tp replicas, or its tp pieces."""
    t = t.detach()
    if spec == REPLICATE:
        return [t.to(d).clone() for d in row]
    return [c.to(d).clone().contiguous()
            for c, d in zip(torch.chunk(t, len(row), dim=spec), row)]


def _gather_cols(parts, dev):
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(dev) for p in parts], dim=-1)


class _ShardedDense(nn.Module):
    """x @ kernel + bias over one dp row's pieces, on the row's first
    device: replicated, column-parallel (outputs gathered by columns) or
    row-parallel (partial products summed, then the replicated bias)."""

    def __init__(self, pieces, name, spec, bias_spec, devices):
        super().__init__()
        self.k, self.b = pieces[name + ".kernel"], pieces[name + ".bias"]
        self.spec, self.devices = spec, devices
        # a column-split kernel splits its bias; a replicated or
        # row-split one replicates it
        if (spec, bias_spec) not in ((1, 0), (REPLICATE, REPLICATE),
                                     (0, REPLICATE)):
            raise NotImplementedError(
                f"{name}: kernel spec {spec} with bias spec {bias_spec}")

    def forward(self, x):
        k, b, devs = self.k, self.b, self.devices
        if self.spec == REPLICATE:
            return torch.matmul(x, k[0]) + b[0]
        if self.spec == 1:
            return _gather_cols([torch.matmul(x.to(d), kj) + bj
                                 for d, kj, bj in zip(devs, k, b)], devs[0])
        xs = torch.split(x, [kj.shape[0] for kj in k], dim=-1)
        acc = torch.matmul(xs[0], k[0])
        for d, xj, kj in zip(devs[1:], xs[1:], k[1:]):
            acc = acc + torch.matmul(xj.to(d), kj).to(devs[0])
        return acc + b[0]


class _ShardedBiLSTM(nn.Module):
    """models/network.BiLSTM over one dp row's pieces: each tp device
    projects its gate columns of both directions, and every step gathers
    the full gate rows on the row's first device, computes the cell there
    and hands h back to every tp device."""

    def __init__(self, pieces, name, specs, units, devices):
        super().__init__()
        leaves = ("kernel", "recurrent_kernel", "bias")
        kernels = {specs[f"{name}.{d}.{leaf}"] for d in ("fwd", "bwd")
                   for leaf in leaves[:2]}
        biases = {specs[f"{name}.{d}.bias"] for d in ("fwd", "bwd")}
        # gate columns split everywhere (biases with them), or replicated
        if (kernels, biases) not in (({1}, {0}), ({REPLICATE}, {REPLICATE})):
            raise NotImplementedError(f"{name}: specs {kernels}, {biases}")
        n = len(devices) if kernels == {1} else 1

        def get(direction, leaf):
            return pieces[f"{name}.{direction}.{leaf}"][:n]
        self.kf, self.rf, self.bf = (get("fwd", k) for k in leaves)
        self.kb, self.rb, self.bb = (get("bwd", k) for k in leaves)
        self.units, self.devices = units, devices[:n]

    def forward(self, x):
        b, t, _ = x.shape
        u, devs = self.units, self.devices
        d0 = devs[0]
        xp_f, xp_b = [], []
        for d, kf, kb, bf, bb in zip(devs, self.kf, self.kb, self.bf,
                                     self.bb):
            k = torch.cat([kf, kb], dim=1)
            xp = torch.matmul(x.to(d), k) + torch.cat([bf, bb])
            w = kf.shape[1]
            xp_f.append(xp[..., :w])
            xp_b.append(xp[..., w:])
        hf = cf = hb = cb = x.new_zeros((b, u))
        outs_f, outs_b = [], []
        for s in range(t):
            zf = _gather_cols([xf[:, s] + torch.matmul(hf.to(d), r)
                               for d, xf, r in zip(devs, xp_f, self.rf)], d0)
            zb = _gather_cols([xb[:, t - 1 - s] + torch.matmul(hb.to(d), r)
                               for d, xb, r in zip(devs, xp_b, self.rb)], d0)
            hf, cf = _gates(zf, cf, u)
            hb, cb = _gates(zb, cb, u)
            outs_f.append(hf)
            outs_b.append(hb)
        fwd = torch.stack(outs_f, dim=1)
        bwd = torch.stack(outs_b[::-1], dim=1)
        return torch.cat([fwd, bwd], dim=-1)


class ShardedNet:
    """A PileupNet laid out on a mesh (shard_params). Called like one:
    net(x) -> [B, n_probs] on mesh.device (train=True, generator=g: one
    unslabbed pass per dp slice with the full batch's dropout masks drawn
    from g and sliced, so a mesh step draws the plain step's masks).

    rows[r][name] is dp row r's list of tp tensors for the PileupNet
    parameter `name` (its replicas, or its pieces along specs[name])."""

    def __init__(self, net, mesh):
        tp = mesh.shape["tp"]
        self.mesh = mesh
        self._arch = dict(add_indel_length=net.add_indel_length,
                          in_channels=net.in_channels,
                          lstm1_units=net.lstm1.units,
                          lstm2_units=net.lstm2.units,
                          dense_units=net.dense_units,
                          head_units=net.head_units)
        modules = dict(net.named_modules())
        self.specs = {}
        for name, p in net.named_parameters():
            mod, leaf = name.rsplit(".", 1)
            siblings = dict(modules[mod].named_parameters(recurse=False))
            self.specs[name] = _spec_for_module(siblings, leaf, p, tp)
        self.names = list(self.specs)
        self.rows = [{name: _place(p, self.specs[name], devs)
                      for name, p in net.named_parameters()}
                     for devs in mesh.devices]
        # one architecture shell per dp row whose layers read that row's
        # pieces: PileupNet's own slab, slab loop and dropout code run it
        self.row_nets = []
        for pieces, devs in zip(self.rows, mesh.devices):
            with torch.device("meta"):
                shell = PileupNet(**self._arch)
            for lstm in ("lstm1", "lstm2"):
                setattr(shell, lstm, _ShardedBiLSTM(
                    pieces, lstm, self.specs, getattr(shell, lstm).units,
                    devs))
            for dense in ["l4"] + [f"{h}_{k}" for h in shell.head_names
                                   for k in ("dense", "logits")]:
                setattr(shell, dense, _ShardedDense(
                    pieces, dense, self.specs[dense + ".kernel"],
                    self.specs[dense + ".bias"], devs))
            self.row_nets.append(shell)

    @property
    def device(self):
        return self.mesh.device

    def __call__(self, x, train=False, generator=None):
        n = x.shape[0]
        masks = None
        if train and generator is not None:
            masks = self.row_nets[0].dropout_masks(n, generator)
        sizes = [len(s) for s in np.array_split(np.arange(n),
                                                self.mesh.shape["dp"])]
        outs, lo = [], 0
        for shell, devs, size in zip(self.row_nets, self.mesh.devices,
                                     sizes):
            if size == 0:
                continue
            xs = x[lo:lo + size].to(devs[0])
            if not train:
                out = shell.forward_slabs(xs)
            else:
                out = shell._slab(xs, None if masks is None else
                                  [m[lo:lo + size] for m in masks])
            outs.append(out.to(self.device))
            lo += size
        return torch.cat(outs)

    def masters(self):
        """(name, j, tensor) of every weight the optimizer updates: dp row
        0's tp pieces of a split leaf, its first replica of a replicated
        one, in PileupNet's parameter order."""
        out = []
        for name in self.names:
            pieces = self.rows[0][name]
            n = 1 if self.specs[name] == REPLICATE else len(pieces)
            out += [(name, j, pieces[j]) for j in range(n)]
        return out

    def parameters(self):
        return [t for _, _, t in self.masters()]

    def requires_grad_(self, flag=True):
        for pieces in self.rows:
            for ts in pieces.values():
                for t in ts:
                    t.requires_grad_(flag)
        return self

    def replica_grads(self, loss):
        """d(loss)/d(master) summed over the dp replicas: each row's
        pieces took the gradient of its batch slice."""
        leaves = [(r, name, j) for r in range(len(self.rows))
                  for name, j, _ in self.masters()]
        grads = torch.autograd.grad(
            loss, [self.rows[r][name][j] for r, name, j in leaves],
            allow_unused=True)
        summed = {}
        for (r, name, j), g in zip(leaves, grads):
            master = self.rows[0][name][j]
            g = torch.zeros_like(master) if g is None else g.to(
                master.device)
            key = (name, j)
            summed[key] = g if key not in summed else summed[key] + g
        return [summed[(name, j)] for name, j, _ in self.masters()]

    @torch.no_grad()
    def apply_updates(self, updates):
        """master += update, then every replica and piece copy of it."""
        for (name, j, master), u in zip(self.masters(), updates):
            master.add_(u)
            replicated = self.specs[name] == REPLICATE
            for pieces in self.rows:
                targets = range(len(pieces[name])) if replicated else (j,)
                for jj in targets:
                    if pieces[name][jj] is not master:
                        pieces[name][jj].copy_(master)

    def unshard(self):
        """The weights gathered into one PileupNet on mesh.device."""
        with torch.device("meta"):
            net = PileupNet(**self._arch)
        state = {}
        for name in self.names:
            pieces = [p.detach().to(self.device) for p in self.rows[0][name]]
            spec = self.specs[name]
            state[name] = pieces[0].clone() if spec == REPLICATE \
                else torch.cat(pieces, dim=spec)
        net.load_state_dict(state, strict=True, assign=True)
        return net.requires_grad_(False).eval()


def shard_params(params, mesh):
    """A PileupNet -> ShardedNet on `mesh` (weights per param_spec)."""
    if isinstance(params, ShardedNet):
        params = params.unshard()
    return ShardedNet(params, mesh)


def _as_tensor(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(a)).to(device=device,
                                              dtype=torch.float32)


def sharded_forward_fn(model, mesh):
    """forward(params, x) -> [B, n_probs] on mesh.device, with params a
    ShardedNet on `mesh` (the batch splits over dp inside it)."""
    del model  # the architecture travels with the ShardedNet

    @torch.inference_mode()
    def forward(params, x):
        return params(_as_tensor(x, mesh.device))

    return forward


def focal_loss(probabilities, labels, gamma=2.0):
    """Focal loss on softmax outputs (the reference's default loss,
    shared/param_p.py:9 FocalLoss)."""
    p = torch.clamp(probabilities, 1e-9, 1.0)
    return -torch.sum(labels * ((1.0 - p) ** gamma) * torch.log(p), dim=-1)


def task_loss(probabilities, labels, add_indel_length=False):
    """Mean over the batch of the per-head focal losses, in the label
    layout (clair3_rna/task/main.py:10-48)."""
    cum = config.LABEL_SHAPE_CUM
    loss = focal_loss(probabilities[:, :cum[0]], labels[:, :cum[0]])
    loss = loss + focal_loss(probabilities[:, cum[0]:cum[1]],
                             labels[:, cum[0]:cum[1]])
    if add_indel_length:
        loss = loss + focal_loss(probabilities[:, cum[1]:cum[2]],
                                 labels[:, cum[1]:cum[2]])
        loss = loss + focal_loss(probabilities[:, cum[2]:cum[3]],
                                 labels[:, cum[2]:cum[3]])
    return torch.mean(loss)


def l2_regularization(params, lam=config.L2_REGULARIZATION_LAMBDA):
    """lam * the sum of squares of every weight with ndim >= 2 (LSTM
    kernels, recurrent kernels, dense kernels) of a PileupNet or of a
    ShardedNet's masters, on the net's device."""
    dev = params.device
    return lam * sum(torch.sum(torch.square(p)).to(dev)
                     for p in params.parameters() if p.ndim >= 2)


def _step_fn(optimizer, add_indel_length, sharded):
    def train_step(params, opt_state, x, y, dropout_rng=None):
        x = _as_tensor(x, params.device)
        y = _as_tensor(y, params.device)
        with torch.enable_grad():
            probs = params(x, train=True, generator=dropout_rng)
            loss = task_loss(probs, y, add_indel_length) \
                + l2_regularization(params)
            if sharded:
                grads = params.replica_grads(loss)
            else:
                grads = torch.autograd.grad(loss, list(params.parameters()))
        updates, opt_state = optimizer.update(grads, opt_state)
        if sharded:
            params.apply_updates(updates)
        else:
            with torch.no_grad():
                for p, u in zip(params.parameters(), updates):
                    p.add_(u)
        return params, opt_state, loss.detach()

    return train_step


def train_step_fn(optimizer, add_indel_length=False):
    """train_step(net, opt_state, x, y, dropout_rng=None) -> (net,
    opt_state, loss) on one device: focal task loss + L2, gradients of
    every weight, one optimizer update applied in place. dropout_rng is a
    torch.Generator (None: no dropout)."""
    return _step_fn(optimizer, add_indel_length, sharded=False)


def sharded_train_step_fn(model, optimizer, mesh, add_indel_length=False):
    """train_step for a ShardedNet on `mesh`: the batch splits over dp,
    gradients sum over the dp replicas, one update reaches every replica."""
    del model, mesh
    return _step_fn(optimizer, add_indel_length, sharded=True)
