"""The flat-event scatter (K3) in the PyTorch port against the JAX package.

The port's plain PyTorch version (what `fused_scatter` runs on CPU tensors)
must equal the JAX package's Pallas kernel run in interpret mode and both
numpy oracles EXACTLY: counts and ranks are integers. Mirrors
tests/test_fused_scatter.py (tile boundaries, empty tiles, rank ties,
pad inertness, the max-rank guard). The CUDA kernel against the plain
version runs only on a card (marker `cuda`).
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


def _port(ev_pos, ev_chan, ev_group, ev_rank, width_pad, device="cpu"):
    """Bucket on the host, scatter through the wrapper."""
    b = tfs.bucket_events(ev_pos, ev_chan, ev_group, ev_rank, width_pad)
    t = {k: _t(v).to(device) for k, v in b.items()}
    return tfs.fused_scatter(t["ev_pos"], t["ev_chan"], t["ev_group"],
                             t["ev_rank"], t["ev_off"], width_pad)


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


def test_bucket_events_offsets():
    """Events come out stably sorted by tile; tile t owns exactly the
    events of [ev_off[t], ev_off[t+1]), each inside the tile; events
    outside [0, W) fall outside every tile's range."""
    rng = np.random.default_rng(5)
    n, width_pad = 5000, 4096
    pos = rng.integers(-300, width_pad + 600, n).astype(np.int32)
    rank = np.arange(n, dtype=np.int32)
    b = tfs.bucket_events(pos, np.zeros(n, np.int8), np.zeros(n, np.int8),
                          rank, width_pad)
    off = b["ev_off"]
    n_tiles = width_pad // tfs.POS_TILE
    assert off.dtype == np.int32 and off.shape == (n_tiles + 1,)
    assert (np.diff(off) >= 0).all()
    key = b["ev_pos"] >> tfs.TILE_SHIFT
    assert (np.diff(key) >= 0).all()
    for t in range(n_tiles):
        sel = slice(off[t], off[t + 1])
        assert (key[sel] == t).all()
        assert (np.diff(b["ev_rank"][sel]) > 0).all()  # stable
    owned = off[-1] - off[0]
    assert owned == int(((pos >= 0) & (pos < width_pad)).sum())
    assert (b["ev_pos"][:off[0]] < 0).all()
    assert (b["ev_pos"][off[-1]:] >= width_pad).all()


def test_constants_match_jax():
    """The kernel contract's constants; the port's tile width (256, one
    CTA) is its own choice, the TPU kernel's is 512."""
    from clair3_rna_tpu.ops import fused_scatter as jfs

    for name in ("C_PAD", "G_PAD", "RANK_INF_F", "MAX_RANK"):
        assert getattr(tfs, name) == getattr(jfs, name), name
    assert tfs.POS_TILE == 1 << tfs.TILE_SHIFT


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
    ev = _random_events("tiny")
    b = {k: _t(v) for k, v in tfs.bucket_events(*ev, 1024).items()}
    args = [b["ev_pos"], b["ev_chan"], b["ev_group"], b["ev_rank"],
            b["ev_off"]]
    with pytest.raises(TypeError):
        tfs.fused_scatter(args[0].to(torch.int64), *args[1:], 1024)
    with pytest.raises(TypeError):
        tfs.fused_scatter(*args[:3], args[3].to(torch.float32), args[4],
                          1024)
    with pytest.raises(ValueError):
        tfs.fused_scatter(*args[:4], args[4][:-1], 1024)
    with pytest.raises(ValueError):
        tfs.fused_scatter(*args, 1000)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        tfs.fused_scatter(*meta, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES) + ["deep_ties"])
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if case == "deep_ties":
        # one deep column per tile: heavy atomic contention, many ties,
        # groups 6/7 and pads at W
        rng = np.random.default_rng(9)
        n, width_pad = 200_000, 16384
        ev = (np.concatenate([rng.integers(0, 64, n) * 256 + 17,
                              np.full(500, width_pad)]).astype(np.int32),
              rng.integers(0, 18, n + 500).astype(np.int8),
              rng.integers(0, 8, n + 500).astype(np.int8),
              rng.integers(0, 50, n + 500).astype(np.int32))
    else:
        ev = _random_events(case)
        width_pad = CASES[case]["width_pad"]
    before = tfs.launches["fused_scatter"]
    kc, kr = _port(*ev, width_pad, device="cuda")
    assert tfs.launches["fused_scatter"] == before + 1
    b = {k: _t(v).cuda() for k, v in
         tfs.bucket_events(*ev, width_pad).items()}
    pc, pr = tfs.fused_scatter_plain(b["ev_pos"], b["ev_chan"],
                                     b["ev_group"], b["ev_rank"],
                                     b["ev_off"], width_pad)
    torch.cuda.synchronize()
    assert torch.equal(kc, pc) and torch.equal(kr, pr)
