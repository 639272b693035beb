"""Packed read batches: the host-side wire format for device CIGAR expansion.

A PackedReads holds, for one region [start, end) of one contig:

- tilelet rows: for each (read, POS_TILE-position tile) the read's aligned base
  codes, nibble-packed at tile-relative offsets (ops/tilelet.py expands them
  on device). ~0.5-0.9 B/base vs the 11 B/event of the flat event arrays,
  which is what makes the fused TPU-resident path win end-to-end
  (VERDICT round-2 item 1; the replaced loop is the reference's
  src/create_tensor_pileup.py:485-611).
- sparse star/insertion/deletion events (~1% of events in RNA data), which
  ride an XLA segment-op side channel and feed host alt_info reconstruction.
- the dense per-position auxiliary counts (read starts/ends, splice skips,
  cover) shared with pileup.events.PileupEvents.

Produced natively by pileup_native.cc:extract_packed_native, or converted
from PileupEvents here (pure-Python reader path and differential tests).
"""

from dataclasses import dataclass

import numpy as np

from clair3_rna_torch.ops.tilelet import EMPTY, POS_TILE, TILE_SHIFT

HALF = POS_TILE // 2


@dataclass
class PackedReads:
    start: int
    end: int
    n_base: int               # aligned base codes in the tilelets
    tl_codes: np.ndarray      # [R, POS_TILE/2] uint8 nibble-packed (even=hi)
    tl_tile: np.ndarray       # [R] int32, nondecreasing
    tl_rank: np.ndarray       # [R] int32 (2 * read_index)
    tl_strand: np.ndarray     # [R] int8
    tl_hp: np.ndarray         # [R] int8
    star_pos: np.ndarray      # absolute positions, like PileupEvents
    star_strand: np.ndarray
    star_hp: np.ndarray
    ins_pos: np.ndarray
    ins_strand: np.ndarray
    ins_rank: np.ndarray
    ins_hp: np.ndarray
    ins_allele: np.ndarray
    ins_seqs: list
    del_pos: np.ndarray
    del_strand: np.ndarray
    del_rank: np.ndarray
    del_hp: np.ndarray
    del_len: np.ndarray
    read_start_count: np.ndarray
    read_end_count: np.ndarray
    skip_fwd_count: np.ndarray
    skip_rev_count: np.ndarray
    cover_count: np.ndarray

    @property
    def width(self) -> int:
        return self.end - self.start

    @property
    def n_events(self) -> int:
        """Base + star event count (bench accounting parity with events)."""
        return self.n_base + len(self.star_pos)

    @property
    def max_rank(self) -> int:
        ranks = [int(a.max()) for a in (self.tl_rank, self.ins_rank,
                                        self.del_rank) if len(a)]
        return max(ranks, default=0)

    def sparse_indels(self):
        from clair3_rna_torch.pileup.builder import SparseIndels
        return SparseIndels.from_arrays(
            self.ins_pos, self.ins_rank, self.ins_allele, self.ins_seqs,
            self.del_pos, self.del_rank, self.del_len)


_KEY_SHIFT = 34  # tile-major row key; ranks stay well under 2^34


def packed_from_events(events) -> PackedReads:
    """PileupEvents -> PackedReads (vectorized; pure-Python reader path).

    Row identity is (tile, rank): a read's base events within one tile share
    a row. Rows come out tile-major (rank-minor), matching the native
    extractor's per-tile arena order.
    """
    start, width = events.start, events.end - events.start
    n_tiles = max(1, -(-width // POS_TILE))
    off = events.base_pos.astype(np.int64) - start
    tile = off >> TILE_SHIFT
    key = (tile << _KEY_SHIFT) | events.base_rank.astype(np.int64)
    rows, inv = np.unique(key, return_inverse=True)
    r = len(rows)
    codes = np.full((r, POS_TILE), EMPTY, np.uint8)
    codes[inv, off & (POS_TILE - 1)] = events.base_code
    tl_codes = ((codes[:, 0::2] << 4) | codes[:, 1::2]).astype(np.uint8)
    tl_strand = np.zeros(r, np.int8)
    tl_strand[inv] = events.base_strand
    tl_hp = np.zeros(r, np.int8)
    tl_hp[inv] = events.base_hp
    return PackedReads(
        start=start, end=events.end, n_base=len(events.base_pos),
        tl_codes=tl_codes,
        tl_tile=(rows >> _KEY_SHIFT).astype(np.int32),
        tl_rank=(rows & ((1 << _KEY_SHIFT) - 1)).astype(np.int32),
        tl_strand=tl_strand, tl_hp=tl_hp,
        star_pos=events.star_pos, star_strand=events.star_strand,
        star_hp=events.star_hp,
        ins_pos=events.ins_pos, ins_strand=events.ins_strand,
        ins_rank=events.ins_rank, ins_hp=events.ins_hp,
        ins_allele=events.ins_allele, ins_seqs=events.ins_seqs,
        del_pos=events.del_pos, del_strand=events.del_strand,
        del_rank=events.del_rank, del_hp=events.del_hp,
        del_len=events.del_len,
        read_start_count=events.read_start_count,
        read_end_count=events.read_end_count,
        skip_fwd_count=events.skip_fwd_count,
        skip_rev_count=events.skip_rev_count,
        cover_count=events.cover_count,
    )


def extract_region_packed(bam, contig, start, end, cfg) -> PackedReads:
    """Dispatch packed extraction: native (C++) or via the Python reader."""
    if hasattr(bam, "extract_packed"):  # NativeBam
        return bam.extract_packed(contig, start, end, min_mq=cfg.min_mq,
                                  min_bq=cfg.min_bq,
                                  exclude_flags=cfg.exclude_flags)
    from clair3_rna_torch.pileup.chunk import extract_region_events
    return packed_from_events(
        extract_region_events(bam, contig, start, end, cfg))


def unpack_codes(tl_codes: np.ndarray) -> np.ndarray:
    """[R, POS_TILE/2] nibble-packed -> [R, POS_TILE] codes (tests/debug)."""
    r = tl_codes.shape[0]
    out = np.empty((r, POS_TILE), np.uint8)
    out[:, 0::2] = tl_codes >> 4
    out[:, 1::2] = tl_codes & 15
    return out
