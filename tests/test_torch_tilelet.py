"""Tilelet expansion in the PyTorch port against the JAX package.

The port's plain PyTorch version (what its wrappers run on CPU tensors) must
equal the JAX package's Pallas kernels run in interpret mode, its XLA
expansion and its numpy oracle EXACTLY: counts and ranks are integers.
Mirrors tests/test_tilelet.py (fills, rank ties and empty tiles, both
wires, phased). The CUDA kernel against the plain version runs only on a
card (marker `cuda`).
"""

import numpy as np
import pytest
import torch

from clair3_rna_torch.ops import tilelet as ttl

# one intra-op thread: the suite runs six worker processes on a
# shared host, where PyTorch's spinning thread pools oversubscribe it
torch.set_num_threads(1)


def _random_rows(rng, n_rows, n_tiles, fill=0.5):
    """Synthetic tile-sorted nibble rows (as tests/test_tilelet.py)."""
    tile = np.sort(rng.integers(0, n_tiles, n_rows)).astype(np.int32)
    codes = np.full((n_rows, ttl.POS_TILE), ttl.EMPTY, np.uint8)
    mask = rng.random((n_rows, ttl.POS_TILE)) < fill
    codes[mask] = rng.integers(0, 4, int(mask.sum()))
    packed = ((codes[:, 0::2] << 4) | codes[:, 1::2]).astype(np.uint8)
    rank = rng.integers(0, 2**20, n_rows).astype(np.int32)
    strand = rng.integers(0, 2, n_rows).astype(np.int8)
    return packed, tile, rank, strand


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port(wire, packed, tile, rank, strand, width_pad, hp=None,
          phased=False):
    """Port expansion from the nibble arena, on either wire (CPU tensors:
    the plain version)."""
    hp_t = None if hp is None else _t(hp)
    if wire == "v2":
        codes2, valid = ttl.nibble_to_v2(packed)
        c, r = ttl.tilelet_expand_v2(_t(codes2), _t(valid), _t(tile),
                                     _t(rank), _t(strand), width_pad,
                                     tl_hp=hp_t, phased=phased)
    else:
        c, r = ttl.tilelet_expand(_t(packed), _t(tile), _t(rank),
                                  _t(strand), width_pad, tl_hp=hp_t,
                                  phased=phased)
    return c.numpy(), r.numpy()


def _jax_all(wire, packed, tile, rank, strand, width_pad, hp=None,
             phased=False):
    """JAX oracle, XLA expansion and Pallas kernel (interpret mode)."""
    import jax.numpy as jnp

    from clair3_rna_tpu.ops import tilelet as jtl

    oracle = jtl.tilelet_oracle(packed, tile, rank, strand, width_pad,
                                tl_hp=hp, phased=phased)
    hp_j = None if hp is None else jnp.asarray(hp)
    b = jtl.bucket_rows(tile, packed, rank, strand, width_pad, tl_hp=hp)
    visits = [jnp.asarray(b[k]) for k in ("visit_tiles", "visit_blocks",
                                          "visit_firsts", "visit_lasts",
                                          "visit_valid")]
    if wire == "v2":
        codes2, valid = jtl.nibble_to_v2(packed)
        xla = jtl.tilelet_expand_xla(
            jnp.asarray(codes2), jnp.asarray(tile), jnp.asarray(rank),
            jnp.asarray(strand), width_pad, tl_hp=hp_j, phased=phased,
            tl_valid=jnp.asarray(valid), wire="v2")
        c2p, vp = jtl.nibble_to_v2(b["tl_codes"])
        pallas = jtl.tilelet_expand_v2(
            jnp.asarray(c2p), jnp.asarray(vp), jnp.asarray(b["tl_tile"]),
            jnp.asarray(b["tl_rank"], jnp.float32),
            jnp.asarray(b["tl_strand"]), *visits, width_pad, interpret=True,
            tl_hp=jnp.asarray(b["tl_hp"]), phased=phased)
    else:
        xla = jtl.tilelet_expand_xla(
            jnp.asarray(packed), jnp.asarray(tile), jnp.asarray(rank),
            jnp.asarray(strand), width_pad, tl_hp=hp_j, phased=phased)
        pallas = jtl.tilelet_expand(
            jnp.asarray(b["tl_codes"]), jnp.asarray(b["tl_tile"]),
            jnp.asarray(b["tl_rank"], jnp.float32),
            jnp.asarray(b["tl_strand"]), *visits, width_pad, interpret=True,
            tl_hp=jnp.asarray(b["tl_hp"]), phased=phased)
    return {"oracle": oracle,
            "xla": tuple(np.asarray(a) for a in xla),
            "pallas": tuple(np.asarray(a) for a in pallas)}


def _assert_exact(port, ref, name):
    pc, pr = port
    rc, rr = ref
    assert np.array_equal(pc.astype(np.float64), rc.astype(np.float64)), name
    # groups 0..3 carry ranks; the JAX oracle leaves 4..7 at RANK_INF_F
    assert np.array_equal(pr[:4].astype(np.float64),
                          rr[:4].astype(np.float64)), name
    assert (pr[4:] == ttl.RANK_INF_F).all(), name


CASES = {
    "deep_single_tile": dict(n_rows=150, n_tiles=1, width_pad=512),
    "many_sparse_tiles": dict(n_rows=90, n_tiles=16, width_pad=8192),
    "tiny": dict(n_rows=3, n_tiles=8, width_pad=4096),
    "dense": dict(n_rows=400, n_tiles=8, width_pad=4096, fill=0.95),
}


@pytest.mark.parametrize("wire", ["v2", "nibble"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_differential(case, wire):
    p = dict(CASES[case])
    fill = p.pop("fill", 0.5)
    rng = np.random.default_rng(sum(map(ord, case)))
    packed, tile, rank, strand = _random_rows(rng, p["n_rows"], p["n_tiles"],
                                              fill)
    port = _port(wire, packed, tile, rank, strand, p["width_pad"])
    refs = _jax_all(wire, packed, tile, rank, strand, p["width_pad"])
    for name, ref in refs.items():
        _assert_exact(port, ref, f"{case}:{wire}:{name}")


@pytest.mark.parametrize("fill", [0.15, 0.6, 0.97])
def test_v2_fill_differential(fill):
    """Holes at every density (deletion errors / bq-masked bases): an
    invalid slot counts nothing and takes no part in the rank min."""
    rng = np.random.default_rng(11)
    width_pad = 6 * ttl.POS_TILE
    packed, tile, rank, strand = _random_rows(rng, 300, 6, fill=fill)
    port = _port("v2", packed, tile, rank, strand, width_pad)
    for name, ref in _jax_all("v2", packed, tile, rank, strand,
                              width_pad).items():
        _assert_exact(port, ref, f"v2 fill={fill}:{name}")


@pytest.mark.parametrize("wire", ["v2", "nibble"])
def test_phased_differential(wire):
    rng = np.random.default_rng(13)
    width_pad = 4 * ttl.POS_TILE
    packed, tile, rank, strand = _random_rows(rng, 160, 4, fill=0.5)
    hp = rng.integers(0, 3, 160).astype(np.int8)
    port = _port(wire, packed, tile, rank, strand, width_pad, hp=hp,
                 phased=True)
    assert port[0][18:22].sum() > 0 and port[0][24:28].sum() > 0
    for name, ref in _jax_all(wire, packed, tile, rank, strand, width_pad,
                              hp=hp, phased=True).items():
        _assert_exact(port, ref, f"phased {wire}:{name}")


@pytest.mark.parametrize("wire", ["v2", "nibble"])
def test_rank_ties_empty_tiles_and_pad_rows(wire):
    """Duplicate ranks at one (pos, code) resolve to the minimum; empty
    tiles and pad rows (tile == n_tiles, no valid slot) are inert; a
    zero-row input still gives a zero image with RANK_INF_F ranks."""
    packed = np.full((4, ttl.HALF), 0xFF, np.uint8)
    packed[0, 0] = 0x0F   # row 0: code 0 at tile offset 0
    packed[1, 0] = 0x0F   # row 1: same position, same code
    packed[1, 1] = 0x3F   # and code 3 at offset 2
    tile = np.array([2, 2, 8, 8], np.int32)   # rows 2, 3: pad rows
    rank = np.array([40, 12, ttl.MAX_RANK, ttl.MAX_RANK], np.int32)
    strand = np.array([0, 1, 0, 0], np.int8)
    width_pad = 8 * ttl.POS_TILE
    pc, pr = _port(wire, packed, tile, rank, strand, width_pad)
    p0 = 2 * ttl.POS_TILE
    assert pr[0, p0] == 12.0 and pr[3, p0 + 2] == 12.0
    assert pc[0, p0] == 1 and pc[9, p0] == 1  # one per strand
    assert pc.sum() == 3
    refs = _jax_all(wire, packed[:2], tile[:2], rank[:2], strand[:2],
                    width_pad)
    for name, ref in refs.items():
        _assert_exact((pc, pr), ref, f"ties {wire}:{name}")

    ec, er = _port(wire, np.zeros((0, ttl.HALF), np.uint8),
                   np.zeros(0, np.int32), np.zeros(0, np.int32),
                   np.zeros(0, np.int8), 1024)
    assert ec.shape == (ttl.C_PAD, 1024) and ec.sum() == 0
    assert (er == ttl.RANK_INF_F).all()


def test_staging_helpers_match_jax():
    from clair3_rna_tpu.ops import tilelet as jtl

    rng = np.random.default_rng(7)
    packed, _, _, _ = _random_rows(rng, 200, 8, fill=0.6)
    codes2, valid = ttl.nibble_to_v2(packed)
    jc, jv = jtl.nibble_to_v2(packed)
    assert np.array_equal(codes2, jc) and np.array_equal(valid, jv)
    assert np.array_equal(ttl.unpack_v2(codes2, valid),
                          jtl.unpack_v2(jc, jv))
    for n in (0, 1, 31, 33, 100, 1000, 5000, 123_457):
        assert ttl.quantize_rows(n) == jtl.quantize_rows(n)
    for name in ("POS_TILE", "HALF", "C_PAD", "G_PAD", "RANK_INF_F",
                 "MAX_RANK", "EMPTY", "V2_HALF", "V2_VBYTES"):
        assert getattr(ttl, name) == getattr(jtl, name), name


def test_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(3)
    packed, tile, rank, strand = _random_rows(rng, 10, 2)
    with pytest.raises(TypeError):
        ttl.tilelet_expand(_t(packed), _t(tile.astype(np.int64)), _t(rank),
                           _t(strand), 512)
    with pytest.raises(ValueError):
        ttl.tilelet_expand(_t(packed[:, :64]), _t(tile), _t(rank),
                           _t(strand), 512)
    with pytest.raises(ValueError):
        ttl.tilelet_expand(_t(packed), _t(tile), _t(rank), _t(strand), 500)
    row_off = np.searchsorted(tile, np.arange(3)).astype(np.int32)
    with pytest.raises(TypeError):   # tl_row_off of the wrong dtype
        ttl.tilelet_expand(_t(packed), _t(tile), _t(rank), _t(strand), 512,
                           tl_row_off=_t(row_off.astype(np.int64)))
    with pytest.raises(ValueError):  # ... or length (n_tiles + 1 = 3)
        ttl.tilelet_expand(_t(packed), _t(tile), _t(rank), _t(strand), 512,
                           tl_row_off=_t(row_off[:2]))
    codes2, valid = ttl.nibble_to_v2(packed)
    with pytest.raises(ValueError):
        ttl.tilelet_expand_v2(_t(codes2), _t(valid), _t(tile), _t(rank),
                              _t(strand), 512,
                              tl_row_off=_t(np.zeros(4, np.int32)))
    # the right offsets change nothing on the CPU
    got = ttl.tilelet_expand(_t(packed), _t(tile), _t(rank), _t(strand), 512,
                             tl_row_off=_t(row_off))
    want = ttl.tilelet_expand(_t(packed), _t(tile), _t(rank), _t(strand),
                              512)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # ... nor does the deepest tile's row count the fused route passes
    got = ttl.expand("nibble", _t(packed), None, _t(tile), _t(rank),
                     _t(strand), 512, tl_row_off=_t(row_off),
                     max_rows=int(np.diff(row_off).max()))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("phased", [False, True])
@pytest.mark.parametrize("wire", ["v2", "nibble"])
def test_kernel_matches_plain_on_card(wire, phased):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(21)
    n_tiles = 40
    packed, tile, rank, strand = _random_rows(rng, 5000, n_tiles, fill=0.7)
    rank = rng.integers(0, 30, len(tile)).astype(np.int32)  # many ties
    hp = rng.integers(0, 3, len(tile)).astype(np.int8)
    width_pad = (n_tiles + 2) * ttl.POS_TILE     # two empty tiles at the end
    dev = torch.device("cuda")
    if wire == "v2":
        codes2, valid = ttl.nibble_to_v2(packed)
        args = [_t(codes2).to(dev), _t(valid).to(dev)]
    else:
        args = [_t(packed).to(dev), None]
    rest = [_t(a).to(dev) for a in (tile, rank, strand, hp)]
    fn = ttl.tilelet_expand_v2 if wire == "v2" else ttl.tilelet_expand
    before = dict(ttl.launches)
    if wire == "v2":
        kc, kr = fn(args[0], args[1], *rest[:3], width_pad, tl_hp=rest[3],
                    phased=phased)
    else:
        kc, kr = fn(args[0], *rest[:3], width_pad, tl_hp=rest[3],
                    phased=phased)
    name = "tilelet_expand_v2" if wire == "v2" else "tilelet_expand"
    assert ttl.launches[name] == before[name] + 1
    assert (ttl.launches[name + "_phased"]
            == before[name + "_phased"] + int(phased))
    pc, pr = ttl.tilelet_expand_plain(args[0], args[1], *rest[:3], rest[3],
                                      width_pad, phased=phased, wire=wire)
    torch.cuda.synchronize()
    assert torch.equal(kc, pc) and torch.equal(kr, pr)


STAGE = 128   # rows per staged buffer in csrc/tilelet.cu


def _tile_rows(rng, rows_per_tile, n_tiles, rank_order="ascending",
               fill=0.7, all_invalid=0.0, base_p=None, strand_p=0.5):
    """Nibble rows with the given row count per tile (tile-sorted), ranks
    ascending within each tile as the staging emits them, or shuffled with
    ties, plus 5 pad rows (tile == n_tiles, no valid slot). base_p weighs
    the four bases, strand_p is the share of reverse rows."""
    tile = np.repeat(np.arange(len(rows_per_tile), dtype=np.int32),
                     rows_per_tile)
    n = len(tile)
    codes = np.full((n, ttl.POS_TILE), ttl.EMPTY, np.uint8)
    mask = rng.random((n, ttl.POS_TILE)) < fill
    codes[mask] = rng.choice(4, int(mask.sum()), p=base_p)
    codes[rng.random(n) < all_invalid] = ttl.EMPTY
    if rank_order == "ascending":
        rank = np.arange(n, dtype=np.int32) * 2
    else:   # out of rank order within each tile, with many ties
        rank = rng.integers(0, 50, n).astype(np.int32)
    packed = ((codes[:, 0::2] << 4) | codes[:, 1::2]).astype(np.uint8)
    pad = 5
    return {
        "packed": np.concatenate([packed, np.full((pad, ttl.HALF), 0xFF,
                                                  np.uint8)]),
        "tile": np.concatenate([tile, np.full(pad, n_tiles, np.int32)]),
        "rank": np.concatenate([rank, np.full(pad, ttl.MAX_RANK,
                                              np.int32)]),
        "strand": (rng.random(n + pad) < strand_p).astype(np.int8),
        "hp": rng.integers(0, 3, n + pad).astype(np.int8),
        "width": n_tiles * ttl.POS_TILE,
    }


def _deep_tile(rng):
    """One tile with 72,000 rows beside an empty one, nearly all forward
    A, so one channel's count passes what a 16-bit lane holds."""
    return _tile_rows(rng, [72_000], 2, fill=0.99,
                      base_p=[0.97, 0.01, 0.01, 0.01], strand_p=0.02)


def _stage_edges(rng):
    """Tiles whose row counts straddle the stage size and the 255-row run
    of one warp (4 warps: 1020/1021 rows), with empty tiles between."""
    counts = [STAGE - 1, 0, STAGE, STAGE + 1, 0, 2 * STAGE + 1, 1, 4 * 255,
              4 * 255 + 1, 3]
    return _tile_rows(rng, counts, len(counts) + 2)


def _rank_disorder(rng):
    """Rows out of rank order within each tile, with rank ties."""
    return _tile_rows(rng, [300, 40, 0, 700, 5, 129], 6, rank_order="random")


def _invalid_and_empty(rng):
    """All-invalid rows (a fifth), empty tiles and pad rows."""
    counts = np.zeros(40, np.int64)
    counts[rng.choice(40, 25, replace=False)] = rng.integers(1, 90, 25)
    return _tile_rows(rng, counts, 40, all_invalid=0.2)


def _wide(rng):
    """2^20 positions (4,096 tiles, more than one wave of CTAs), sparse."""
    n_tiles = (1 << 20) // ttl.POS_TILE
    counts = rng.integers(0, 4, n_tiles)
    counts[rng.choice(n_tiles, 8, replace=False)] = 150
    return _tile_rows(rng, counts, n_tiles, fill=0.5)


def _one_deep(rng):
    """50-row tiles with one 5,000-row tile, as one gene at thousands-fold
    depth among shallow ones."""
    counts = np.full(64, 50)
    counts[30] = 5000
    return _tile_rows(rng, counts, 64)


def _mixed_splits(rng):
    """Tiles deep enough to be split 8, 4 and 2 ways beside unsplit and
    empty ones, in one group of 8 tiles and the next."""
    return _tile_rows(rng, [1600, 700, 300, 50, 0, 2000, 193, 1, 400, 60],
                      12)


CUDA_CASES = {"deep_tile_70k": _deep_tile, "stage_edges": _stage_edges,
              "rank_disorder": _rank_disorder,
              "invalid_and_empty": _invalid_and_empty, "wide_2e20": _wide,
              "one_deep": _one_deep, "mixed_splits": _mixed_splits}


@pytest.mark.cuda
@pytest.mark.parametrize("phased", [False, True])
@pytest.mark.parametrize("wire", ["v2", "nibble"])
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_kernel_cases_on_card(case, wire, phased):
    """The kernel bit-identical to its plain version on the shapes that
    stress its schedule, through the wrapper as the fused route calls it
    (row offsets and the deepest tile's rows, which set the cluster size),
    with the offsets only and without them; each call counts one
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(sum(map(ord, case)))
    c = CUDA_CASES[case](rng)
    dev = torch.device("cuda")
    n_tiles = c["width"] // ttl.POS_TILE
    row_off = np.searchsorted(c["tile"], np.arange(n_tiles + 1))
    if wire == "v2":
        codes2, valid = ttl.nibble_to_v2(c["packed"])
        codes, valid = _t(codes2).to(dev), _t(valid).to(dev)
    else:
        codes, valid = _t(c["packed"]).to(dev), None
    tile, rank, strand, hp = (_t(c[k]).to(dev)
                              for k in ("tile", "rank", "strand", "hp"))
    off = _t(row_off.astype(np.int32)).to(dev)
    name = "tilelet_expand_v2" if wire == "v2" else "tilelet_expand"
    pc, pr = ttl.tilelet_expand_plain(codes, valid, tile, rank, strand, hp,
                                      c["width"], phased=phased, wire=wire)
    deepest = int(np.diff(row_off).max())
    for tl_row_off, max_rows in ((off, deepest), (off, None), (None, None)):
        before = ttl.launches[name]
        if max_rows is not None:
            kc, kr = ttl.expand(wire, codes, valid, tile, rank, strand,
                                c["width"], tl_hp=hp, phased=phased,
                                tl_row_off=tl_row_off, max_rows=max_rows)
        elif wire == "v2":
            kc, kr = ttl.tilelet_expand_v2(codes, valid, tile, rank, strand,
                                           c["width"], tl_hp=hp,
                                           phased=phased,
                                           tl_row_off=tl_row_off)
        else:
            kc, kr = ttl.tilelet_expand(codes, tile, rank, strand,
                                        c["width"], tl_hp=hp, phased=phased,
                                        tl_row_off=tl_row_off)
        torch.cuda.synchronize()
        assert ttl.launches[name] == before + 1
        assert torch.equal(kc, pc) and torch.equal(kr, pr), (
            case, tl_row_off is None, max_rows)
    if case == "deep_tile_70k":
        assert int(pc[0, :256].max()) > 65_535
