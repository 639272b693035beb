"""Tilelet expansion: packed read rows -> channel-count image + group ranks.

The host ships "tilelet" rows -- for each (read, POS_TILE-position tile)
pair, the read's aligned base codes at their tile-relative offsets -- and
this module expands them on the device into

  counts[c, p] = #rows r in tile(p) with code[r, p] == base(c), strand(c)
  grank[g, p]  = min rank over rows with code[r, p] == g        (g in 0..3)

(A C G T forward at channels 0..3, reverse at 9..12; the phased form adds
hp=1 at 18..21 and hp=2 at 24..27; every other channel is 0 and groups
4..7 read RANK_INF_F.) Two wires carry the codes:

- v2 (default): 2-bit crumbs [R, POS_TILE/4] (slot 4j+c at bits 2c of
  byte j) plus a validity bitmap [R, POS_TILE/8] (slot s at bit s&7 of
  byte s>>3): 96 B/row. An invalid slot counts nothing and takes no part
  in the rank min.
- nibble: two 4-bit codes per byte [R, POS_TILE/2] (even slot in the high
  nibble), EMPTY=15 for "no base here": 128 B/row.

Rows are tile-sorted (the extractor emits per-tile arenas; pad rows carry
tile W/POS_TILE and lie past the last tile). `tilelet_expand_v2` /
`tilelet_expand` launch the hand-written CUDA kernel (csrc/tilelet.cu) for
CUDA tensors and run `tilelet_expand_plain` for CPU tensors; given
`tl_row_off` (int32 [W/POS_TILE + 1], each tile's first row, as the fused
staging ships it) a call enqueues exactly one kernel, without it the
wrapper finds the offsets with one searchsorted. The fused route calls
their common body, `expand`, with the deepest tile's row count as well,
which sets the kernel's cluster size. `tilelet_oracle` is the numpy
scalar-loop reference.
"""

import numpy as np
import torch

from clair3_rna_torch.ops import kernel_io

POS_TILE = 256            # positions per tile
HALF = POS_TILE // 2      # nibble-packed bytes per row
TILE_SHIFT = 8
ROW_BLOCK = 32            # row-count padding granule (quantize_rows)
C_PAD = 32                # 18 (30 phased) channels padded to 32
G_PAD = 8                 # 6 rank groups padded to 8
RANK_INF_F = float(2 ** 30)
MAX_RANK = 2 ** 24        # ranks must stay below this (exact in f32)
EMPTY = 15                # nibble value for "no base here"
V2_HALF = POS_TILE // 4   # v2 code bytes per row (4 crumbs each)
V2_VBYTES = POS_TILE // 8  # v2 validity bytes per row

# byte LUTs for nibble_to_v2: for a nibble byte x = (hi n0, lo n1),
# _V2_PAIR[x] = the two crumbs (c0 | c1<<2, holes forced to 0) and
# _V2_VAL[x] = the two validity bits (v0 | v1<<1)
_x = np.arange(256, dtype=np.uint16)
_n0, _n1 = (_x >> 4) & 15, _x & 15
_v0, _v1 = (_n0 != EMPTY), (_n1 != EMPTY)
_V2_PAIR = (np.where(_v0, _n0 & 3, 0)
            | (np.where(_v1, _n1 & 3, 0) << 2)).astype(np.uint8)
_V2_VAL = (_v0 | (_v1 << 1)).astype(np.uint8)
del _x, _n0, _n1, _v0, _v1


def nibble_to_v2(tl_codes):
    """[R, POS_TILE/2] nibble arena -> (codes2 [R, POS_TILE/4] uint8,
    valid [R, POS_TILE/8] uint8). Hole slots carry crumb 0, masked by the
    validity bit; round-trips exactly via unpack_v2."""
    pair = _V2_PAIR[tl_codes]   # [R, POS_TILE/2] crumb pairs (4 bits used)
    val = _V2_VAL[tl_codes]     # [R, POS_TILE/2] validity pairs (2 bits)
    codes2 = (pair[:, 0::2] | (pair[:, 1::2] << 4)).astype(np.uint8)
    vbits = (val[:, 0::4] | (val[:, 1::4] << 2) | (val[:, 2::4] << 4)
             | (val[:, 3::4] << 6)).astype(np.uint8)
    return codes2, vbits


def unpack_v2(codes2, valid):
    """(codes2, valid) -> [R, POS_TILE] codes with EMPTY holes (tests)."""
    r = codes2.shape[0]
    out = np.empty((r, POS_TILE), np.uint8)
    for c in range(4):
        out[:, c::4] = (codes2 >> (2 * c)) & 3
    vb = np.unpackbits(valid, axis=1, bitorder="little")[:, :POS_TILE]
    out[vb == 0] = EMPTY
    return out


def quantize_rows(n):
    """Row-count padding bucket: whole ROW_BLOCKs, quantized to 1/8 octave
    (<=12.5% pad waste)."""
    n = max(n, ROW_BLOCK)
    octave = 1
    while octave * 2 <= n:
        octave *= 2
    step = max(octave // 8, ROW_BLOCK)
    return -(-n // step) * step


# each launch counts under its wire's name; a phased launch also under
# "<name>_phased", so a run shows which of its launches took the hp planes
launches, reset_launches, _count_launch = kernel_io.launch_counter(
    "tilelet_expand_v2", "tilelet_expand", "tilelet_expand_v2_phased",
    "tilelet_expand_phased")


# --- plain PyTorch version ---------------------------------------------------

def kernel_bytes(st):
    """What one K1/K2 launch on a staged chunk (a StagedPacked) must move:
    each staged row read once (codes, validity on the v2 wire, rank,
    strand), the tile offsets, and C_PAD + G_PAD f32 a position written."""
    row = (st.tl_codes.shape[1] + 4 + 1
           + (st.tl_valid.shape[1] if st.tl_valid is not None else 0))
    return (int(st.tl_row_off[-1]) * row + st.tl_row_off.nbytes
            + (C_PAD + G_PAD) * st.width * 4)


def _decode(tl_codes, tl_valid, wire):
    """[R, bytes] wire -> [R, POS_TILE] int64 codes, >= 4 meaning no base."""
    r = tl_codes.shape[0]
    packed = tl_codes.to(torch.int64)
    if wire == "v2":
        crumbs = torch.stack([(packed >> (2 * c)) & 3 for c in range(4)],
                             dim=-1).reshape(r, POS_TILE)
        vb = tl_valid.to(torch.int64)
        bits = torch.stack([(vb >> b) & 1 for b in range(8)],
                           dim=-1).reshape(r, POS_TILE)
        return torch.where(bits != 0, crumbs, EMPTY)
    return torch.stack([(packed >> 4) & 15, packed & 15],
                       dim=-1).reshape(r, POS_TILE)


def tilelet_expand_plain(tl_codes, tl_valid, tl_tile, tl_rank, tl_strand,
                         tl_hp, width_pad, phased=False, wire="v2"):
    """Scatter-based expansion with the kernel's outputs: counts [C_PAD, W]
    f32 and grank [G_PAD, W] f32. Rows whose tile lies at or beyond
    width_pad (the pad rows) are inert."""
    dev = tl_codes.device
    codes = _decode(tl_codes, tl_valid, wire)
    pos = (tl_tile.to(torch.int64)[:, None] * POS_TILE
           + torch.arange(POS_TILE, device=dev)[None, :])
    valid = (codes < 4) & (pos < width_pad)
    strand = tl_strand.to(torch.int64)[:, None]
    chan = torch.where(valid, codes + 9 * strand, C_PAD - 1)
    pos_c = pos.clamp(max=width_pad - 1)
    counts = torch.zeros(width_pad * C_PAD, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, (pos_c * C_PAD + chan).reshape(-1),
                        valid.to(torch.int64).reshape(-1))
    if phased and tl_hp is not None:
        hp = tl_hp.to(torch.int64)[:, None]
        valid_hp = valid & ((hp == 1) | (hp == 2))
        chan_hp = torch.where(valid_hp, codes + 12 + 6 * hp, C_PAD - 1)
        counts.scatter_add_(0, (pos_c * C_PAD + chan_hp).reshape(-1),
                            valid_hp.to(torch.int64).reshape(-1))
    counts = counts.reshape(width_pad, C_PAD)
    counts[:, C_PAD - 1] = 0
    group = torch.where(valid, codes, G_PAD - 1)
    rank_e = torch.where(valid, tl_rank.to(torch.int64)[:, None],
                         int(RANK_INF_F))
    granks = torch.full((width_pad * G_PAD,), int(RANK_INF_F),
                        dtype=torch.int64, device=dev)
    granks.scatter_reduce_(0, (pos_c * G_PAD + group).reshape(-1),
                           rank_e.reshape(-1), "amin", include_self=True)
    granks = granks.reshape(width_pad, G_PAD)
    granks[:, G_PAD - 1] = int(RANK_INF_F)
    return (counts.T.to(torch.float32).contiguous(),
            granks.T.to(torch.float32).contiguous())


# --- kernel wrappers ---------------------------------------------------------

def expand(wire, tl_codes, tl_valid, tl_tile, tl_rank, tl_strand, width_pad,
           tl_hp=None, phased=False, tl_row_off=None, max_rows=None):
    """The body of tilelet_expand_v2 (wire "v2") and tilelet_expand
    ("nibble", tl_valid None), with one more input for callers that have
    it: max_rows, the deepest tile's row count (the fused staging's
    tl_max_rows), which sets the kernel's cluster size; without it the
    kernel takes the largest, which suits any depth. A count below the
    true one costs time, not exactness."""
    kernel_name = "tilelet_expand_v2" if wire == "v2" else "tilelet_expand"
    r = tl_codes.shape[0]
    row_bytes = V2_HALF if wire == "v2" else HALF
    if width_pad % POS_TILE:
        raise ValueError(f"width_pad {width_pad} is not a multiple of "
                         f"{POS_TILE}")
    n_tiles = width_pad // POS_TILE
    kernel_io.check("tl_codes", tl_codes, torch.uint8, (r, row_bytes))
    if wire == "v2":
        kernel_io.check("tl_valid", tl_valid, torch.uint8, (r, V2_VBYTES))
    kernel_io.check("tl_tile", tl_tile, torch.int32, (r,))
    kernel_io.check("tl_rank", tl_rank, torch.int32, (r,))
    kernel_io.check("tl_strand", tl_strand, torch.int8, (r,))
    tensors = [tl_codes, tl_tile, tl_rank, tl_strand]
    if tl_hp is not None:
        kernel_io.check("tl_hp", tl_hp, torch.int8, (r,))
        tensors.append(tl_hp)
    if tl_row_off is not None:
        kernel_io.check("tl_row_off", tl_row_off, torch.int32,
                        (n_tiles + 1,))
        tensors.append(tl_row_off)
    if wire == "v2":
        tensors.append(tl_valid)
    dev = kernel_io.one_device("tilelet", tensors)
    if dev.type == "cpu":
        return tilelet_expand_plain(tl_codes, tl_valid, tl_tile, tl_rank,
                                    tl_strand, tl_hp, width_pad,
                                    phased=phased, wire=wire)

    from clair3_rna_torch.csrc import launch_tilelet

    if tl_row_off is None:
        # rows are tile-sorted (the extractor emits per-tile arenas); tile t
        # owns rows [row_off[t], row_off[t+1]) and pad rows (tile ==
        # n_tiles) fall past row_off[n_tiles]
        tl_row_off = torch.searchsorted(
            tl_tile, torch.arange(n_tiles + 1, dtype=torch.int32,
                                  device=dev), out_int32=True)
    counts = torch.empty((C_PAD, width_pad), dtype=torch.float32,
                         device=dev)
    grank = torch.empty((G_PAD, width_pad), dtype=torch.float32, device=dev)
    # the unphased kernel never reads hp; a missing hp reads as all 0
    launch_tilelet(wire, phased, tl_codes, tl_valid, tl_row_off, tl_rank,
                   tl_strand, tl_hp if phased else None, n_tiles, width_pad,
                   counts, grank, max_rows=max_rows)
    _count_launch(kernel_name)
    if phased:
        _count_launch(kernel_name + "_phased")
    return counts, grank


def tilelet_expand_v2(tl_codes2, tl_valid, tl_tile, tl_rank, tl_strand,
                      width_pad, tl_hp=None, phased=False, tl_row_off=None):
    """v2 wire -> (counts [C_PAD, W] f32, grank [G_PAD, W] f32).

    tl_codes2 uint8 [R, 64], tl_valid uint8 [R, 32], tl_tile int32 [R]
    (nondecreasing: rows are tile-sorted; pad rows carry tile
    width_pad/POS_TILE), tl_rank int32 [R] (< MAX_RANK, any order within a
    tile), tl_strand/tl_hp int8 [R] (tl_hp None reads as all 0).
    tl_row_off, optional int32 [width_pad/POS_TILE + 1], is the first row of
    each tile (np.searchsorted(tl_tile, arange(n_tiles + 1))); the staging
    ships it, and a call that has it enqueues exactly one kernel. CUDA
    tensors launch the kernel (replacing ops/tilelet.py _make_kernel_v2 of
    the JAX package); CPU tensors run tilelet_expand_plain."""
    return expand("v2", tl_codes2, tl_valid, tl_tile, tl_rank, tl_strand,
                  width_pad, tl_hp=tl_hp, phased=phased,
                  tl_row_off=tl_row_off)


def tilelet_expand(tl_codes, tl_tile, tl_rank, tl_strand, width_pad,
                   tl_hp=None, phased=False, tl_row_off=None):
    """Nibble wire (uint8 [R, 128], EMPTY=15) -> the same outputs as
    tilelet_expand_v2, with the same contract (replacing the JAX package's
    _make_kernel)."""
    return expand("nibble", tl_codes, None, tl_tile, tl_rank, tl_strand,
                  width_pad, tl_hp=tl_hp, phased=phased,
                  tl_row_off=tl_row_off)


def tilelet_oracle(tl_codes, tl_tile, tl_rank, tl_strand, width,
                   tl_hp=None, phased=False):
    """Numpy reference: scalar loops over unpacked nibbles."""
    counts = np.zeros((C_PAD, width), np.int64)
    ranks = np.full((G_PAD, width), RANK_INF_F, np.float64)
    for r in range(len(tl_tile)):
        base = int(tl_tile[r]) * POS_TILE
        hp = int(tl_hp[r]) if tl_hp is not None else 0
        for j in range(POS_TILE):
            b = int(tl_codes[r, j // 2])
            code = (b >> 4) if j % 2 == 0 else (b & 15)
            p = base + j
            if code < 4 and 0 <= p < width:
                counts[code + 9 * int(tl_strand[r]), p] += 1
                ranks[code, p] = min(ranks[code, p], float(tl_rank[r]))
                if phased and hp in (1, 2):
                    counts[12 + 6 * hp + code, p] += 1
    return counts, ranks
