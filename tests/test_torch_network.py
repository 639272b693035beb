"""PyTorch port's PileupNet against the JAX package's network.

Weights come from the JAX package (its init_params, or the committed
trained BENCH_WEIGHTS_PHASED.npz) and are carried across as numpy, so both
networks compute with the same parameters; inputs are made with numpy from a
seed. Tolerance: rtol 5e-5 / atol 5e-6, the repo's CPU bound for float32
networks that sum in a different order (tests/test_model_parity.py).
"""

import os

import numpy as np
import pytest
import torch

from clair3_rna_torch.models import network as tnet
from clair3_rna_torch.models import params_io as tio

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 5e-5, 5e-6


def _jax_params(seed, add_indel_length=False, phased=False):
    from clair3_rna_tpu.models.network import init_params
    p = init_params(seed, add_indel_length=add_indel_length, phased=phased)
    return p, _to_numpy(p)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _windows(rng, n, channels):
    """Signed windows with the ref-channel negation pattern, and the
    (uint8 magnitudes, codes) wire that carries them."""
    codes = rng.integers(0, 4, (n, 33)).astype(np.int8)
    mags = rng.integers(0, 60, (n, 33, channels)).astype(np.int32)
    x = mags.copy()
    rows = np.arange(33)
    for b in range(n):
        x[b, rows, codes[b]] *= -1
        x[b, rows, codes[b] + 9] *= -1
    return x, mags.astype(np.uint8), codes


CONFIGS = {
    "18ch": dict(add_indel_length=False, phased=False),
    "30ch_phased": dict(add_indel_length=False, phased=True),
    "indel_length": dict(add_indel_length=True, phased=False),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name):
    from clair3_rna_tpu.models.network import (make_forward_fn,
                                               make_wire_forward_fn)

    kw = CONFIGS[name]
    jparams, tree = _jax_params(3, **kw)
    net = tio.params_from_numpy(tree, device="cpu")
    channels = 30 if kw["phased"] else 18
    x, mags, codes = _windows(np.random.default_rng(5), 24, channels)

    _, jfwd = make_forward_fn(add_indel_length=kw["add_indel_length"])
    _, tfwd = tnet.make_forward_fn(add_indel_length=kw["add_indel_length"])
    want = np.asarray(jfwd(jparams, x))
    got = tfwd(net, x).numpy()
    assert got.shape == want.shape == (24, net.n_probs)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    _, jwire = make_wire_forward_fn(add_indel_length=kw["add_indel_length"])
    _, twire = tnet.make_wire_forward_fn(
        add_indel_length=kw["add_indel_length"])
    want_w = np.asarray(jwire(jparams, mags, codes))
    got_w = twire(net, mags, codes).numpy()
    np.testing.assert_allclose(got_w[:, :-1], want_w[:, :-1], rtol=RTOL,
                               atol=ATOL)
    # the prescreen column is a 0/1 verdict on the probabilities
    np.testing.assert_array_equal(got_w[:, -1], want_w[:, -1])
    # the wire rebuilds exactly the signed windows
    np.testing.assert_array_equal(got_w[:, :-1], got)


def test_trained_phased_weights_match_jax():
    """The committed trained 30-channel weights load in both packages and
    give the same probabilities."""
    from clair3_rna_tpu.models.network import make_forward_fn
    from clair3_rna_tpu.models.params_io import load_params

    path = os.path.join(REPO, "BENCH_WEIGHTS_PHASED.npz")
    jparams = load_params(path)
    net = tio.params_from_numpy(tio.load_params(path), device="cpu")
    assert net.in_channels == 30
    x, _, _ = _windows(np.random.default_rng(8), 16, 30)
    _, jfwd = make_forward_fn()
    _, tfwd = tnet.make_forward_fn()
    np.testing.assert_allclose(tfwd(net, x).numpy(),
                               np.asarray(jfwd(jparams, x)),
                               rtol=RTOL, atol=ATOL)


def test_rows_invariant_across_batch_buckets():
    """A row's probabilities do not depend on the batch it rides in: the
    pipeline's tail buckets (64..2048) and the fused route's candidate
    budgets (1024..8192) must give identical rows (the network runs in
    fixed-size slabs). Plus the float64 numpy LSTM oracle on one row."""
    _, tree = _jax_params(7)
    net = tio.params_from_numpy(tree, device="cpu")
    _, fwd = tnet.make_forward_fn()
    x, _, _ = _windows(np.random.default_rng(4), 96, 18)

    def run(bucket):
        pad = np.zeros((bucket - len(x), 33, 18), np.int32)
        return fwd(net, np.concatenate([x, pad])).numpy()[:96]

    base = run(96)
    for bucket in (128, 512, 1024, 2048):
        np.testing.assert_array_equal(run(bucket), base)

    p1 = tree["lstm1"]

    def np_lstm(xr, d, units=128):
        k, r, b = (p1[d][n].astype(np.float64) for n in
                   ("kernel", "recurrent_kernel", "bias"))
        h = np.zeros(units)
        c = np.zeros(units)
        out = []
        for t in range(xr.shape[0]):
            z = xr[t].astype(np.float64) @ k + h @ r + b
            i = 1 / (1 + np.exp(-z[:units]))
            f = 1 / (1 + np.exp(-z[units:2 * units]))
            g = np.tanh(z[2 * units:3 * units])
            o = 1 / (1 + np.exp(-z[3 * units:]))
            c = f * c + i * g
            h = o * np.tanh(c)
            out.append(h.copy())
        return np.stack(out)

    x0 = x[0].astype(np.float32)
    oracle = np.concatenate([np_lstm(x0, "forward"),
                             np_lstm(x0[::-1], "backward")[::-1]], axis=-1)
    with torch.inference_mode():
        ours = net.lstm1(torch.from_numpy(x0)[None])[0].numpy()
    np.testing.assert_allclose(ours, oracle, rtol=1e-4, atol=1e-5)


def test_npz_round_trips_between_packages(tmp_path):
    """An npz saved by the port loads in the JAX package (same forward), and
    one saved by the JAX package loads in the port bit for bit."""
    from clair3_rna_tpu.models.network import make_forward_fn
    from clair3_rna_tpu.models.params_io import load_params, save_params

    net = tnet.init_params(11, add_indel_length=True, device="cpu")
    path = tio.save_params(str(tmp_path / "port"), net)
    jparams = load_params(path)
    x, _, _ = _windows(np.random.default_rng(2), 8, 18)
    _, jfwd = make_forward_fn(add_indel_length=True)
    _, tfwd = tnet.make_forward_fn(add_indel_length=True)
    np.testing.assert_allclose(np.asarray(jfwd(jparams, x)),
                               tfwd(net, x).numpy(), rtol=RTOL, atol=ATOL)

    jp, tree = _jax_params(12, phased=True)
    jpath = save_params(str(tmp_path / "jax"), jp)
    back = tio.params_to_numpy(
        tio.params_from_numpy(tio.load_params(jpath), device="cpu"))
    flat_a, flat_b = tio._flatten(tree), tio._flatten(back)
    assert sorted(flat_a) == sorted(flat_b)
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k])


def test_wire_int16_fallback_exact():
    """Magnitudes beyond uint8 ride the signed int16 wire; both wires give
    the signed forward's probabilities bit for bit."""
    from clair3_rna_torch.caller.pipeline import batch_tensors, batch_wire
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.pileup.builder import TensorRecord

    rng = np.random.RandomState(5)
    cfg = PileupConfig(batch_size=64)
    records = []
    for i in range(64):
        seq = "".join(rng.choice(list("ACGT"), 33))
        t = rng.randint(0, 300 if i % 3 else 600, (33, 18)).astype(np.int32)
        eff = np.array(["ACGT".index(c) for c in seq])
        rows = np.arange(33)
        t[rows, eff] = -np.abs(t[rows, eff])
        t[rows, eff + 9] = -np.abs(t[rows, eff + 9])
        records.append(TensorRecord("chr1", 100 + i, seq, t, depth=30,
                                    alt_info="30-RG 30"))
    net = tnet.init_params(0, device="cpu")
    _, legacy = tnet.make_forward_fn()
    _, wire_fwd = tnet.make_wire_forward_fn()
    wire, codes = batch_wire(records, cfg)
    assert wire.dtype == np.int16
    np.testing.assert_array_equal(
        wire_fwd(net, wire, codes).numpy()[:, :-1],
        legacy(net, batch_tensors(records, cfg)).numpy())
    small = [TensorRecord(r.ctg_name, r.position, r.ref_seq,
                          np.clip(r.tensor, -200, 200), depth=30,
                          alt_info="30-RG 30") for r in records]
    wire8, codes8 = batch_wire(small, cfg)
    assert wire8.dtype == np.uint8
    np.testing.assert_array_equal(
        wire_fwd(net, wire8, codes8).numpy()[:, :-1],
        legacy(net, batch_tensors(small, cfg)).numpy())


def test_weights_default_to_cuda():
    """init_params and params_from_numpy put the network on CUDA unless the
    caller asks for the CPU; without a card that request raises instead of
    falling back."""
    tree = tio.params_to_numpy(tnet.init_params(1, device="cpu"))
    if torch.cuda.is_available():
        assert tnet.init_params(1).device.type == "cuda"
        assert tio.params_from_numpy(tree).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnet.init_params(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tio.params_from_numpy(tree)


@pytest.mark.cuda
def test_network_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the port's own init: a card's machine has no JAX
    tree = tio.params_to_numpy(tnet.init_params(3, device="cpu"))
    cpu = tio.params_from_numpy(tree, device="cpu")
    gpu = tio.params_from_numpy(tree, device="cuda")
    _, fwd = tnet.make_forward_fn()
    x, _, _ = _windows(np.random.default_rng(6), 300, 18)
    np.testing.assert_allclose(fwd(gpu, x).cpu().numpy(),
                               fwd(cpu, x).numpy(), rtol=0, atol=1e-4)


# --------------------------------------------------------------- graph slabs
# The graph policy (PileupNet._slab_graphs) reads the input's device, dtype
# and requires_grad and the weights' devices: a stand-in input on "cuda"
# and stand-in weights there exercise each rule without a card.

class _FakeWeight:
    def __init__(self, i, requires_grad=False):
        self.device = torch.device("cuda", 0)
        self.requires_grad = requires_grad
        self._ptr = 4096 * (i + 1)

    def data_ptr(self):
        return self._ptr


def _fake_x(dtype=torch.float32, requires_grad=False):
    from types import SimpleNamespace
    return SimpleNamespace(device=torch.device("cuda", 0), dtype=dtype,
                           requires_grad=requires_grad)


def _on_fake_card(net, requires_grad=False):
    """net with stand-in weights on "cuda" (a mesh shell has none of its
    own: it gets some too, so only its layers can refuse it)."""
    net.parameters = lambda: [_FakeWeight(i, requires_grad)
                              for i in range(20)]
    return net


def _mesh_shell():
    from clair3_rna_torch.parallel.mesh import make_mesh, shard_params
    net = tnet.init_params(3, device="cpu")
    mesh = make_mesh(devices=[torch.device("cpu")] * 2, tp=2)
    return shard_params(net, mesh).row_nets[0]


GRAPH_CASES = {
    # case -> (module, input, grad enabled, graphs expected)
    "plain_on_card": (lambda: _on_fake_card(tnet.init_params(3, device="cpu")),
                      _fake_x, False, True),
    "plain_on_card_grad_on_frozen_weights": (
        lambda: _on_fake_card(tnet.init_params(3, device="cpu")), _fake_x,
        True, True),
    "cpu_tensor": (lambda: tnet.init_params(3, device="cpu"),
                   lambda: torch.zeros((64, 33, 18)), False, False),
    "weights_off_the_input_device": (
        lambda: tnet.init_params(3, device="cpu"), _fake_x, False, False),
    "autograd_records_the_weights": (
        lambda: _on_fake_card(tnet.init_params(3, device="cpu"), True),
        _fake_x, True, False),
    "autograd_records_the_input": (
        lambda: _on_fake_card(tnet.init_params(3, device="cpu")),
        lambda: _fake_x(requires_grad=True), True, False),
    "half_input": (lambda: _on_fake_card(tnet.init_params(3, device="cpu")),
                   lambda: _fake_x(torch.float16), False, False),
    "mesh_shell": (_mesh_shell, _fake_x, False, False),
    "mesh_shell_with_weights_on_card": (
        lambda: _on_fake_card(_mesh_shell()), _fake_x, False, False),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_policy(case):
    """Slabs replay a graph only for float32 on a card, autograd not
    recording, and a plain PileupNet whose weights lie on the input's
    device: not on the CPU, nor for a mesh shell (its layers are not the
    plain ones) nor while autograd records."""
    make_net, make_x, grad, want = GRAPH_CASES[case]
    net = make_net()
    with torch.set_grad_enabled(grad):
        graphs = net._slab_graphs(make_x())
    assert (graphs is not None) == want
    if want:  # one slot store a module, kept outside its state
        assert net._slab_graphs(make_x()) is graphs
        assert not any("graph" in k for k in vars(net))


def test_train_never_consults_graphs_and_cpu_slabs_count(monkeypatch):
    """forward(train=True) never asks for graph slots, inference does (and
    gets none on the CPU); inside a chunk's record the CPU slabs count as
    slabs, none replayed; outside one nothing is counted; deepcopy (the
    training snapshot) works after inference."""
    import copy

    from clair3_rna_torch.caller import spans
    net = tnet.init_params(3, device="cpu")
    asked = []
    real = tnet.PileupNet._slab_graphs

    def spy(self, x):
        asked.append(real(self, x))
        return asked[-1]
    monkeypatch.setattr(tnet.PileupNet, "_slab_graphs", spy)
    x = torch.zeros((130, 33, 18))
    with torch.inference_mode():
        with spans.Chunk() as rec:
            net(x, train=True)
            assert rec.counters == {} and asked == []
            net(x)
        net(x)
    assert rec.counters == {"net_slabs": 3, "net_graph_slabs": 0}
    assert asked == [None, None]
    copy.deepcopy(net)


def _graph_net(channels):
    return tnet.init_params(5, phased=channels == 30, device="cuda")


def _eager(net, x):
    """The slabs of x run eagerly, as the graph-free forward did."""
    slab = tnet.NET_SLAB["cuda"]
    n = x.shape[0]
    n_pad = -(-n // slab) * slab
    xp = torch.cat([x, x.new_zeros((n_pad - n,) + tuple(x.shape[1:]))])
    return torch.cat([net._slab(xp[lo:lo + slab])
                      for lo in range(0, n_pad, slab)])[:n]


def _card_x(seed, n, channels):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-40, 60, (n, 33, channels))
                            .astype(np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [18, 30])
def test_graph_slabs_bit_identical_on_card(channels):
    """The first call runs eagerly, the second captures, the rest replay:
    every output equals the eager slabs bit for bit, at one slab and then
    at three (8,292 rows, all replayed), and the counters say so."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from clair3_rna_torch.caller import spans
    net = _graph_net(channels)
    for n in (3000, 8292):
        x = _card_x(n, n, channels)
        with torch.inference_mode():
            want = _eager(net, x)
            for k in range(4):
                with spans.Chunk() as rec:
                    got = net(x)
                assert torch.equal(got, want), (n, k)
                slabs = -(-n // tnet.NET_SLAB["cuda"])
                # only the key's very first slab ran eagerly
                assert rec.counters == {
                    "net_slabs": slabs,
                    "net_graph_slabs": 0 if (n, k) == (3000, 0) else slabs}


@pytest.mark.cuda
def test_graph_slabs_two_threads_on_card():
    """Two threads replaying at once each get their own rows, equal to the
    eager slabs, from at most GRAPH_SLOTS slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from concurrent.futures import ThreadPoolExecutor
    net = _graph_net(18)
    xs = [_card_x(100 + i, 4096, 18) for i in range(2)]
    with torch.inference_mode():
        want = [_eager(net, x) for x in xs]
        net(xs[0])
        net(xs[0])

    def replay(i):
        with torch.inference_mode():
            return [net(xs[i]) for _ in range(20)]

    with ThreadPoolExecutor(2) as pool:
        outs = list(pool.map(replay, range(2)))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, want[i]) for o in outs[i]), i
    graphs = tnet._GRAPHS[net]
    key = (xs[0].device, 18, tnet.NET_SLAB["cuda"])
    assert 1 <= graphs._made[key] <= tnet.GRAPH_SLOTS


@pytest.mark.cuda
def test_graph_output_not_aliased_on_card():
    """An output returned earlier is unchanged after later replays, and
    shares no memory with a slot's static output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    net = _graph_net(18)
    a, b = _card_x(1, 2000, 18), _card_x(2, 2000, 18)
    with torch.inference_mode():
        net(a)
        first = net(a)
        kept = first.clone()
        for _ in range(3):
            net(b)
    torch.cuda.synchronize()
    assert torch.equal(first, kept)
    key = (a.device, 18, tnet.NET_SLAB["cuda"])
    for slot in tnet._GRAPHS[net]._free[key]:
        lo = slot.out.untyped_storage().data_ptr()
        hi = lo + slot.out.untyped_storage().nbytes()
        assert not lo <= first.data_ptr() < hi
