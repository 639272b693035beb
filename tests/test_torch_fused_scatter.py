"""The flat-event scatter (K3) in the PyTorch port against the JAX package.

The port's plain PyTorch version (what `fused_scatter` runs on CPU tensors)
must equal the JAX package's Pallas kernel run in interpret mode (on
events bucketed by the JAX package's own `bucket_events`) and both numpy
oracles EXACTLY: counts and ranks are integers. The port takes events in
any order, unbucketed. Mirrors tests/test_fused_scatter.py (tile
boundaries, empty tiles, rank ties, pad inertness, the max-rank guard),
plus order invariance and the inert-event rule. The CUDA kernel against
the plain version runs only on a card (marker `cuda`), on shuffled events.
"""

import numpy as np
import pytest
import torch

from clair3_rna_torch.ops import fused_scatter as tfs

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _args(ev_pos, ev_chan, ev_group, ev_rank, device="cpu"):
    """The events as the wrapper's tensors, in the order given."""
    return [_t(np.asarray(a, dt)).to(device) for a, dt in (
        (ev_pos, np.int32), (ev_chan, np.int8), (ev_group, np.int8),
        (ev_rank, np.int32))]


def _port(ev_pos, ev_chan, ev_group, ev_rank, width_pad, device="cpu"):
    """Scatter through the wrapper, events unbucketed."""
    return tfs.fused_scatter(*_args(ev_pos, ev_chan, ev_group, ev_rank,
                                    device), width_pad)


def _jax_all(ev_pos, ev_chan, ev_group, ev_rank, width_pad):
    """The JAX package's oracle and its Pallas kernel (interpret mode)."""
    import jax.numpy as jnp

    from clair3_rna_tpu.ops import fused_scatter as jfs

    oracle = jfs.scatter_oracle(ev_pos, ev_chan, ev_group, ev_rank,
                                width_pad)
    b = jfs.bucket_events(np.asarray(ev_pos, np.int32),
                          np.asarray(ev_chan, np.int8),
                          np.asarray(ev_group, np.int8),
                          np.asarray(ev_rank, np.int32), width_pad)
    pallas = jfs.fused_scatter(
        jnp.asarray(b["ev_pos"]), jnp.asarray(b["ev_chan"]),
        jnp.asarray(b["ev_group"]), jnp.asarray(b["ev_rank"], jnp.float32),
        jnp.asarray(b["visit_tiles"]), jnp.asarray(b["visit_blocks"]),
        jnp.asarray(b["visit_firsts"]), jnp.asarray(b["visit_lasts"]),
        jnp.asarray(b["visit_valid"]), width_pad, interpret=True)
    return {"jax_oracle": oracle,
            "pallas": tuple(np.asarray(a) for a in pallas),
            "port_oracle": tfs.scatter_oracle(ev_pos, ev_chan, ev_group,
                                              ev_rank, width_pad)}


def _assert_exact(port, ref, name):
    """Every count row and every rank row (groups 6 and 7 read RANK_INF_F
    in the kernel, its plain version and both oracles)."""
    pc, pr = (a.cpu().numpy() for a in port)
    rc, rr = ref
    assert pc.dtype == np.float32 and pr.dtype == np.float32, name
    assert np.array_equal(pc.astype(np.float64), rc.astype(np.float64)), name
    assert np.array_equal(pr.astype(np.float64), rr.astype(np.float64)), name


CASES = {
    # events clumped in one tile; empty tiles elsewhere
    "single_tile": dict(n=500, width_pad=4096, lo=600, hi=1000),
    # events straddling tile boundaries
    "tile_boundary": dict(n=3000, width_pad=4096, lo=480, hi=560),
    # uniform spread over every tile
    "uniform": dict(n=20000, width_pad=8192, lo=0, hi=8192),
    # fewer events than one of the TPU kernel's 2048-event blocks
    "tiny": dict(n=7, width_pad=1024, lo=0, hi=1024),
}


def _random_events(case):
    p = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    n = p["n"]
    return (rng.integers(p["lo"], p["hi"], n).astype(np.int32),
            rng.integers(0, 18, n).astype(np.int8),
            rng.integers(0, 8, n).astype(np.int8),   # incl. 6 star / 7 pad
            rng.integers(0, 2**20, n).astype(np.int32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_differential(case):
    ev = _random_events(case)
    width_pad = CASES[case]["width_pad"]
    port = _port(*ev, width_pad)
    for name, ref in _jax_all(*ev, width_pad).items():
        _assert_exact(port, ref, f"{case}:{name}")


def test_rank_ties_and_duplicates():
    """Several events at one (pos, group) with duplicate ranks: the
    minimum wins whatever the event order."""
    ev = (np.array([100, 100, 100, 100, 612, 612], np.int32),
          np.array([0, 0, 0, 9, 1, 1], np.int8),
          np.array([0, 0, 0, 0, 1, 1], np.int8),
          np.array([44, 2, 2, 8, 7, 3], np.int32))
    port = _port(*ev, 1024)
    for name, ref in _jax_all(*ev, 1024).items():
        _assert_exact(port, ref, f"ties:{name}")
    pc, pr = port
    assert pr[0, 100] == 2.0 and pr[1, 612] == 3.0
    assert pc[0, 100] == 3 and pc[9, 100] == 1


def test_empty_input_and_pad_inertness():
    """Zero events give a zero image with RANK_INF_F ranks. Events at W
    (the staging's pads), beyond it and at negative positions are inert;
    a star (group 6) counts without a rank, and so does a group-7 event
    inside [0, W), as in the JAX kernel and oracle."""
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int8),
             np.zeros(0, np.int8), np.zeros(0, np.int32))
    pc, pr = _port(*empty, 2048)
    assert pc.shape == (tfs.C_PAD, 2048) and pc.sum() == 0
    assert (pr == tfs.RANK_INF_F).all()
    for name, ref in _jax_all(*empty, 2048).items():
        _assert_exact((pc, pr), ref, f"empty:{name}")

    ev = (np.array([2048, 2048, 5000, -1, 7, 7, 300], np.int32),
          np.array([0, 3, 1, 2, 16, 17, 4], np.int8),
          np.array([7, 0, 0, 1, 6, 6, 7], np.int8),
          np.array([tfs.MAX_RANK, 1, 1, 1, 0, 0, 5], np.int32))
    pc, pr = _port(*ev, 2048)
    assert pc.sum() == 3 and pc[16, 7] == 1 and pc[17, 7] == 1
    assert pc[4, 300] == 1
    assert (pr == tfs.RANK_INF_F).all()
    ref = tfs.scatter_oracle(*ev, 2048)
    _assert_exact((pc, pr), ref, "pads:port_oracle")


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_order_invariance(seed):
    """The same events shuffled with a numpy seed give outputs identical
    to the events in staging order, and equal to the JAX oracle."""
    ev = _random_events("uniform")
    width_pad = CASES["uniform"]["width_pad"]
    perm = np.random.default_rng(seed).permutation(len(ev[0]))
    shuffled = _port(*(a[perm] for a in ev), width_pad)
    in_order = _port(*ev, width_pad)
    assert all(torch.equal(a, b) for a, b in zip(shuffled, in_order))
    from clair3_rna_tpu.ops import fused_scatter as jfs
    _assert_exact(shuffled, jfs.scatter_oracle(*ev, width_pad),
                  f"shuffled {seed}:jax_oracle")


def test_inert_events():
    """An event at W, beyond it, at a negative position or with a channel
    outside [0, 32) counts nothing and takes no rank; a group-6 or
    group-7 event counts but takes no rank. Real events mixed with them
    give exactly what the port's oracle gives on all of them, and what the
    JAX oracle gives on the same events with the bad-channel ones dropped
    (the JAX oracle indexes its count rows by channel, so it cannot take
    them)."""
    from clair3_rna_tpu.ops import fused_scatter as jfs

    width_pad = 2048
    real = _random_events("tile_boundary")
    bad = (np.array([2048, 2048, 9000, -1, -300, 5, 6, 7, 900, 901],
                    np.int32),
           np.array([0, 3, 1, 2, 0, 32, 40, -1, 4, 5], np.int8),
           np.array([0, 1, 2, 3, 4, 0, 1, 2, 6, 7], np.int8),
           np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.int32))
    ev = tuple(np.concatenate([a, b]) for a, b in zip(real, bad))
    keep = (ev[1] >= 0) & (ev[1] < tfs.C_PAD)
    want = jfs.scatter_oracle(*(a[keep] for a in ev), width_pad)
    pc, pr = _port(*ev, width_pad)
    _assert_exact((pc, pr), want, "inert:jax_oracle")
    _assert_exact((pc, pr), tfs.scatter_oracle(*ev, width_pad),
                  "inert:port_oracle")
    # only the group-6/7 events at 900/901 count; none of the rank-0
    # events ranks
    assert int(pc.sum()) == len(real[0]) + 2
    assert pc[4, 900] == 1 and pc[5, 901] == 1
    assert (pr[:, 900:902] == tfs.RANK_INF_F).all()
    assert (pr[:, 5:8] == tfs.RANK_INF_F).all()


def test_constants_match_jax():
    """The kernel contract's constants. The port has no position tile:
    its kernel takes events unbucketed (the TPU kernel's tile is 512)."""
    from clair3_rna_tpu.ops import fused_scatter as jfs

    for name in ("C_PAD", "G_PAD", "RANK_INF_F", "MAX_RANK"):
        assert getattr(tfs, name) == getattr(jfs, name), name
    assert not hasattr(tfs, "POS_TILE") and not hasattr(tfs, "bucket_events")


def test_max_rank_fallback_guard(monkeypatch):
    """FusedChunkCaller returns None (host fallback) when a chunk's ranks
    leave the scatter kernel's exact-f32 range, in events and packed
    mode alike."""
    from clair3_rna_torch.caller.decode import CallConfig
    from clair3_rna_torch.config import PileupConfig
    from clair3_rna_torch.models.network import init_params
    from clair3_rna_torch.ops.fused_pileup import FusedChunkCaller
    from clair3_rna_torch.pileup.events import PileupEvents

    width = 1024
    z8 = np.zeros(0, np.int8)
    z32 = np.zeros(0, np.int32)
    z64 = np.zeros(0, np.int64)
    dense = np.zeros(width, np.int32)
    events = PileupEvents(
        start=0, end=width,
        base_pos=np.array([5], np.int32), base_code=np.array([0], np.int8),
        base_strand=np.array([0], np.int8),
        base_rank=np.array([tfs.MAX_RANK + 2], np.int64),
        base_hp=np.array([0], np.int8),
        star_pos=z32, star_strand=z8, star_hp=z8,
        ins_pos=z32, ins_strand=z8, ins_rank=z64, ins_hp=z8, ins_allele=z32,
        ins_seqs=[], del_pos=z32, del_strand=z8, del_rank=z64, del_hp=z8,
        del_len=z32, read_start_count=dense, read_end_count=dense,
        skip_fwd_count=dense, skip_rev_count=dense,
        cover_count=np.ones(width, np.int32))
    params = init_params(0, device="cpu")
    for mode in ("events", "packed"):
        monkeypatch.setenv("CLAIR3_RNA_TORCH_FUSED_MODE", mode)
        caller = FusedChunkCaller(params, PileupConfig(), CallConfig())
        assert caller.mode == mode
        out = caller.call_chunk(events, np.zeros(width, np.int8), "chr1",
                                "A" * width, 0, 0, width)
        assert out is None
        assert caller.counters()["fallback_chunks"] == 1


def test_wrapper_rejects_bad_inputs():
    args = _args(*_random_events("tiny"))
    with pytest.raises(TypeError):
        tfs.fused_scatter(args[0].to(torch.int64), *args[1:], 1024)
    with pytest.raises(TypeError):
        tfs.fused_scatter(*args[:3], args[3].to(torch.float32), 1024)
    with pytest.raises(ValueError):
        tfs.fused_scatter(args[0], args[1][:-1], *args[2:], 1024)
    with pytest.raises(ValueError):
        tfs.fused_scatter(*args, 0)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        tfs.fused_scatter(*meta, 1024)


# the kernel buckets tiles in ranges of this many 256-position tiles
# (csrc/scatter.cu RANGE_TILES); the wide case spans several
RANGE_POSITIONS = 6144 * 256


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES) + ["deep_ties", "deep_few",
                                                  "wide"])
def test_kernel_matches_plain_on_card(case):
    """csrc/scatter.cu against the plain version, on shuffled events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(9)
    if case == "deep_ties":
        # one deep column per 256 positions: heavy atomic contention, many
        # ties, groups 6/7 and pads at W
        n, width_pad = 200_000, 16384
        ev = (np.concatenate([rng.integers(0, 64, n) * 256 + 17,
                              np.full(500, width_pad)]).astype(np.int32),
              rng.integers(0, 18, n + 500).astype(np.int8),
              rng.integers(0, 8, n + 500).astype(np.int8),
              rng.integers(0, 50, n + 500).astype(np.int32))
    elif case == "deep_few":
        # every event on three positions: the atomics collide all the time
        n, width_pad = 300_001, 16384
        ev = (rng.choice([5, 6, 9000], n).astype(np.int32),
              rng.integers(0, 18, n).astype(np.int8),
              rng.integers(0, 8, n).astype(np.int8),
              rng.integers(0, 1000, n).astype(np.int32))
    elif case == "wide":
        # 2^23 positions, six bucketing ranges, the last one partial:
        # events spread over all of them and piled on each range boundary
        n, width_pad = 200_000, 1 << 23
        edges = np.arange(1, 6) * RANGE_POSITIONS
        pos = np.concatenate([rng.integers(0, width_pad, n),
                              rng.choice(edges, 5000)
                              + rng.integers(-3, 3, 5000),
                              [0, width_pad - 1, width_pad, -1]])
        m = len(pos)
        ev = (pos.astype(np.int32), rng.integers(0, 18, m).astype(np.int8),
              rng.integers(0, 8, m).astype(np.int8),
              rng.integers(0, 1000, m).astype(np.int32))
    else:
        ev = _random_events(case)
        width_pad = CASES[case]["width_pad"]
    perm = rng.permutation(len(ev[0]))
    args = _args(*(a[perm] for a in ev), device="cuda")
    before = tfs.launches["fused_scatter"]
    kc, kr = tfs.fused_scatter(*args, width_pad)
    assert tfs.launches["fused_scatter"] == before + 1
    pc, pr = tfs.fused_scatter_plain(*args, width_pad)
    torch.cuda.synchronize()
    assert torch.equal(kc, pc) and torch.equal(kr, pr)
