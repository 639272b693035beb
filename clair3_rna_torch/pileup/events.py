"""BAM records -> packed pileup event arrays.

TPU-first redesign of the reference's per-character mpileup-string parsing
(src/create_tensor_pileup.py:113-176): instead of streaming text columns, each
read's CIGAR is expanded once into flat numpy event arrays (base matches,
in-deletion placeholders, insertions, deletions, read starts/ends, reference
skips). Downstream, channel counting becomes dense scatter/matmul work that
vectorizes on device; this module is the host-side extraction that will also
be backed by the C++ library.

Event ordering: reads are processed in BAM (coordinate) order and each event
carries `rank = 2*read_index (+1 for indels attached to a base)`. Within one
reference position this reproduces samtools' column order, which the reference
implementation leans on for tie-breaking via Counter insertion order
(src/create_tensor_pileup.py:268,279).
"""

from dataclasses import dataclass

import numpy as np

from clair3_rna_torch.io.bam import (
    CIGAR_M, CIGAR_I, CIGAR_D, CIGAR_N, CIGAR_S, CIGAR_H, CIGAR_P,
    CIGAR_EQ, CIGAR_X, CONSUMES_REF,
)

# byte -> base code lookup: A/a=0 C/c=1 G/g=2 T/t=3, everything else -1 (N etc.
# never enters any channel, matching generate_tensor's ACGT-only counting,
# src/create_tensor_pileup.py:246-258)
_BASE_CODE = np.full(256, -1, dtype=np.int8)
for i, b in enumerate("ACGT"):
    _BASE_CODE[ord(b)] = i
    _BASE_CODE[ord(b.lower())] = i


@dataclass
class PileupEvents:
    """Flat event arrays for one region [start, end) of one contig."""

    start: int
    end: int
    # base matches (M/=/X ops), N bases excluded
    base_pos: np.ndarray      # int32, absolute 0-based ref position
    base_code: np.ndarray     # int8, 0..3
    base_strand: np.ndarray   # int8, 0 fwd / 1 rev
    base_rank: np.ndarray     # int64, column-order rank
    base_hp: np.ndarray       # int8, 0 untagged / 1 / 2
    # in-deletion placeholders ('*' fwd / '#' rev under --reverse-del)
    star_pos: np.ndarray
    star_strand: np.ndarray
    star_hp: np.ndarray
    # insertions, attached to the preceding aligned base's position
    ins_pos: np.ndarray
    ins_strand: np.ndarray
    ins_rank: np.ndarray
    ins_hp: np.ndarray
    ins_allele: np.ndarray    # int32 index into ins_seqs
    ins_seqs: list            # uppercase inserted sequences
    # deletions, attached to the preceding aligned base's position
    del_pos: np.ndarray
    del_strand: np.ndarray
    del_rank: np.ndarray
    del_hp: np.ndarray
    del_len: np.ndarray       # int32
    # per-position auxiliary counts over [start, end): read starts/ends and
    # reference-skip coverage by strand (for splice-junction statistics,
    # src/create_tensor_pileup.py:109-178)
    read_start_count: np.ndarray
    read_end_count: np.ndarray
    skip_fwd_count: np.ndarray
    skip_rev_count: np.ndarray
    # reads covering each position via any ref-consuming op (M/D/N): exactly
    # the positions where mpileup emits a column row
    cover_count: np.ndarray

    @property
    def width(self) -> int:
        return self.end - self.start


def extract_events(records, start: int, end: int, min_bq: int = 0) -> PileupEvents:
    """Expand filtered, coordinate-sorted records into packed event arrays.

    Flag/MQ filtering is the caller's responsibility (BamReader.fetch).
    """
    width = end - start
    base_pos, base_code, base_strand, base_rank, base_hp = [], [], [], [], []
    star_pos, star_strand, star_hp = [], [], []
    ins_pos, ins_strand, ins_rank, ins_hp, ins_allele = [], [], [], [], []
    ins_seq_index: dict = {}
    ins_seqs: list = []
    del_pos, del_strand, del_rank, del_hp, del_len = [], [], [], [], []
    read_start_count = np.zeros(width, dtype=np.int32)
    read_end_count = np.zeros(width, dtype=np.int32)
    skip_fwd_count = np.zeros(width, dtype=np.int32)
    skip_rev_count = np.zeros(width, dtype=np.int32)
    cover_diff = np.zeros(width + 1, dtype=np.int32)

    for read_index, rec in enumerate(records):
        strand = 1 if rec.is_reverse else 0
        hp = rec.tags.get("HP", 0)
        if not isinstance(hp, int) or hp < 0 or hp > 2:
            hp = 0
        rank = 2 * read_index
        seq_bytes = np.frombuffer(rec.seq.encode(), dtype=np.uint8)
        quals = np.frombuffer(rec.qual, dtype=np.uint8) if rec.qual else None
        qpos = 0
        rpos = rec.pos
        ops = [(op, l) for op, l in rec.cigar if op not in (CIGAR_H, CIGAR_P)]
        if not ops:
            continue
        # read start/end marks attach to the first/last ref-consuming position
        p = rpos
        for op, length in ops:
            if CONSUMES_REF[op]:
                p += length
        if start <= rpos < end:
            read_start_count[rpos - start] += 1
        if start <= p - 1 < end:
            read_end_count[p - 1 - start] += 1
        clo, chi = max(rpos, start), min(p, end)
        if clo < chi:
            cover_diff[clo - start] += 1
            cover_diff[chi - start] -= 1

        for op_idx, (op, length) in enumerate(ops):
            if op in (CIGAR_M, CIGAR_EQ, CIGAR_X):
                lo = max(rpos, start)
                hi = min(rpos + length, end)
                if lo < hi:
                    off_lo = lo - rpos
                    off_hi = hi - rpos
                    codes = _BASE_CODE[seq_bytes[qpos + off_lo:qpos + off_hi]]
                    keep = codes >= 0
                    if min_bq > 0 and quals is not None:
                        q = quals[qpos + off_lo:qpos + off_hi]
                        keep &= (q >= min_bq) | (q == 0xFF)
                    positions = np.arange(lo, hi, dtype=np.int32)[keep]
                    base_pos.append(positions)
                    base_code.append(codes[keep])
                    base_strand.append(np.full(len(positions), strand, dtype=np.int8))
                    base_rank.append(np.full(len(positions), rank, dtype=np.int64))
                    base_hp.append(np.full(len(positions), hp, dtype=np.int8))
                # indel attached to the last base of this match segment
                attach = rpos + length - 1
                if start <= attach < end and op_idx + 1 < len(ops):
                    nop, nlen = ops[op_idx + 1]
                    if nop == CIGAR_I:
                        seq = rec.seq[qpos + length:qpos + length + nlen].upper()
                        allele = ins_seq_index.get(seq)
                        if allele is None:
                            allele = len(ins_seqs)
                            ins_seq_index[seq] = allele
                            ins_seqs.append(seq)
                        ins_pos.append(attach)
                        ins_strand.append(strand)
                        ins_rank.append(rank + 1)
                        ins_hp.append(hp)
                        ins_allele.append(allele)
                    elif nop == CIGAR_D:
                        del_pos.append(attach)
                        del_strand.append(strand)
                        del_rank.append(rank + 1)
                        del_hp.append(hp)
                        del_len.append(nlen)
                qpos += length
                rpos += length
            elif op == CIGAR_D:
                lo = max(rpos, start)
                hi = min(rpos + length, end)
                for p in range(lo, hi):
                    star_pos.append(p)
                    star_strand.append(strand)
                    star_hp.append(hp)
                rpos += length
            elif op == CIGAR_N:
                lo = max(rpos, start)
                hi = min(rpos + length, end)
                if lo < hi:
                    target = skip_rev_count if strand else skip_fwd_count
                    target[lo - start:hi - start] += 1
                rpos += length
            elif op in (CIGAR_I, CIGAR_S):
                qpos += length

    def cat(parts, dtype):
        if not parts:
            return np.zeros(0, dtype=dtype)
        return np.concatenate(parts).astype(dtype, copy=False)

    return PileupEvents(
        start=start,
        end=end,
        base_pos=cat(base_pos, np.int32),
        base_code=cat(base_code, np.int8),
        base_strand=cat(base_strand, np.int8),
        base_rank=cat(base_rank, np.int64),
        base_hp=cat(base_hp, np.int8),
        star_pos=np.asarray(star_pos, dtype=np.int32),
        star_strand=np.asarray(star_strand, dtype=np.int8),
        star_hp=np.asarray(star_hp, dtype=np.int8),
        ins_pos=np.asarray(ins_pos, dtype=np.int32),
        ins_strand=np.asarray(ins_strand, dtype=np.int8),
        ins_rank=np.asarray(ins_rank, dtype=np.int64),
        ins_hp=np.asarray(ins_hp, dtype=np.int8),
        ins_allele=np.asarray(ins_allele, dtype=np.int32),
        ins_seqs=ins_seqs,
        del_pos=np.asarray(del_pos, dtype=np.int32),
        del_strand=np.asarray(del_strand, dtype=np.int8),
        del_rank=np.asarray(del_rank, dtype=np.int64),
        del_hp=np.asarray(del_hp, dtype=np.int8),
        del_len=np.asarray(del_len, dtype=np.int32),
        read_start_count=read_start_count,
        read_end_count=read_end_count,
        skip_fwd_count=skip_fwd_count,
        skip_rev_count=skip_rev_count,
        cover_count=np.cumsum(cover_diff[:-1]).astype(np.int32),
    )
