"""samtools-mpileup text emulation from BAM records.

Reproduces the exact column strings of `samtools mpileup <bam> -r <region>
--reverse-del --min-MQ 5 --min-BQ 0 --excl-flags 2316` *without* a reference
fasta (the reference pipeline runs mpileup with no -f, so bases are letters,
case encodes strand, and deletion bodies print as N's;
src/create_tensor_pileup.py:446-451).

This module is deliberately implemented per-read/per-position, independent of
the vectorized tensor builder, so it can serve as a differential-testing
bridge: our packed-event builder must agree with the reference
`generate_tensor` applied to these columns. It is also a debugging aid.
"""

from dataclasses import dataclass, field

from clair3_rna_torch.io.bam import (
    BamReader, CIGAR_M, CIGAR_I, CIGAR_D, CIGAR_N, CIGAR_S, CIGAR_H,
    CIGAR_P, CIGAR_EQ, CIGAR_X, CONSUMES_QUERY, CONSUMES_REF,
)


@dataclass
class PileupColumn:
    pos: int                      # 0-based reference position
    bases: str                    # mpileup base-column string
    depth: int                    # mpileup depth (reads with base or deletion)
    haplotypes: list = field(default_factory=list)  # HP per base-ish entry ('0'/'1'/'2')


def _read_column_entries(rec, min_bq: int):
    """Yield (ref_pos, entry_string, counts_in_depth, hp_slot) for one read."""
    strand_lower = rec.is_reverse
    qpos = 0
    rpos = rec.pos
    ops = [(op, l) for op, l in rec.cigar if op not in (CIGAR_H, CIGAR_P)]
    first_aligned = True
    # find last ref-consuming index for '$' placement
    last_ref_idx = max((i for i, (op, l) in enumerate(ops) if CONSUMES_REF[op]), default=-1)
    for i, (op, length) in enumerate(ops):
        if op in (CIGAR_M, CIGAR_EQ, CIGAR_X):
            for k in range(length):
                base = rec.seq[qpos + k]
                bq = rec.qual[qpos + k] if qpos + k < len(rec.qual) else 0xFF
                entry = base.lower() if strand_lower else base.upper()
                if bq != 0xFF and bq < min_bq:
                    # mpileup drops low-BQ bases from the column entirely
                    continue
                prefix = ""
                if first_aligned and k == 0:
                    prefix = "^" + chr(rec.mapq + 33)
                suffix = ""
                # indel attached to this base if next op is I or D and this is
                # the last base of the current match segment
                if k == length - 1 and i + 1 < len(ops):
                    nop, nlen = ops[i + 1]
                    if nop == CIGAR_I:
                        ins = rec.seq[qpos + length:qpos + length + nlen]
                        ins = ins.lower() if strand_lower else ins.upper()
                        suffix = f"+{nlen}{ins}"
                    elif nop == CIGAR_D:
                        body = ("n" if strand_lower else "N") * nlen
                        suffix = f"-{nlen}{body}"
                if i == last_ref_idx and k == length - 1:
                    suffix += "$"
                yield rpos + k, prefix + entry + suffix, True, True
            first_aligned = False
            qpos += length
            rpos += length
        elif op == CIGAR_D:
            ch = "#" if strand_lower else "*"   # --reverse-del
            for k in range(length):
                suffix = "$" if (i == last_ref_idx and k == length - 1) else ""
                yield rpos + k, ch + suffix, True, True
            rpos += length
        elif op == CIGAR_N:
            ch = "<" if strand_lower else ">"
            for k in range(length):
                yield rpos + k, ch, False, True
            rpos += length
        elif op == CIGAR_I:
            qpos += length  # handled as suffix of previous base
        elif op == CIGAR_S:
            qpos += length
        # H/P filtered above


def pileup_columns(records, start: int, end: int, min_bq: int = 0,
                   with_haplotype: bool = False):
    """Build mpileup columns for [start, end) from coordinate-sorted records.

    `records` must already be filtered (flags/MQ) like the mpileup invocation.
    Returns only positions with at least one covering entry (mpileup emits no
    row for uncovered positions).
    """
    width = end - start
    entries = [[] for _ in range(width)]
    depths = [0] * width
    haplotypes = [[] for _ in range(width)] if with_haplotype else None
    for rec in records:
        hp = str(rec.tags.get("HP", 0)) if with_haplotype else None
        for pos, entry, in_depth, hp_slot in _read_column_entries(rec, min_bq):
            if pos < start or pos >= end:
                continue
            entries[pos - start].append(entry)
            if in_depth:
                depths[pos - start] += 1
            if with_haplotype and hp_slot:
                haplotypes[pos - start].append(hp)
    out = []
    for i in range(width):
        if entries[i]:
            out.append(PileupColumn(
                pos=start + i,
                bases="".join(entries[i]),
                depth=depths[i],
                haplotypes=haplotypes[i] if with_haplotype else [],
            ))
    return out


def pileup_columns_from_bam(bam_path: str, contig: str, start: int, end: int,
                            min_mq: int = 5, min_bq: int = 0,
                            exclude_flags: int = 2316,
                            with_haplotype: bool = False):
    reader = BamReader(bam_path)
    records = list(reader.fetch(contig, start, end,
                                exclude_flags=exclude_flags, min_mapq=min_mq))
    return pileup_columns(records, start, end, min_bq=min_bq,
                          with_haplotype=with_haplotype)
