"""RNA high-confidence BED construction.

Capability match for src/get_rna_bed.py:44-138 without external tools: the
reference pipes mosdepth per-base coverage through awk and bedtools
merge/intersect; here coverage comes from our BAM reader and the interval ops
from BedRegions.
"""

import numpy as np

from clair3_rna_torch.io.bam import BamReader
from clair3_rna_torch.io.bed import BedRegions, write_bed


def coverage_intervals(bam: BamReader, contig: str, min_coverage: int,
                       exclude_flags=2316, min_mq=0):
    """Maximal intervals with aligned-base coverage >= min_coverage."""
    length = bam.reference_lengths[contig]
    diff = np.zeros(length + 1, dtype=np.int32)
    for rec in bam.fetch(contig, 0, length, exclude_flags=exclude_flags,
                         min_mapq=min_mq):
        # mosdepth counts M/D spans (not N introns) toward per-base depth
        rpos = rec.pos
        from clair3_rna_torch.io.bam import CIGAR_M, CIGAR_D, CIGAR_N, CIGAR_EQ, CIGAR_X
        for op, ln in rec.cigar:
            if op in (CIGAR_M, CIGAR_D, CIGAR_EQ, CIGAR_X):
                lo, hi = rpos, min(rpos + ln, length)
                diff[lo] += 1
                diff[hi] -= 1
                rpos += ln
            elif op == CIGAR_N:
                rpos += ln
    cov = np.cumsum(diff[:-1])
    ok = cov >= min_coverage
    if not ok.any():
        return []
    edges = np.flatnonzero(np.diff(np.concatenate(([0], ok.view(np.int8), [0]))))
    return [(int(edges[i]), int(edges[i + 1])) for i in range(0, len(edges), 2)]


def build_rna_bed(bam_path: str, output_fn: str, min_coverage: int = 4,
                  high_conf_bed_fn: str | None = None, contigs=None):
    bam = BamReader(bam_path)
    contigs = contigs or bam.references
    intervals = {}
    for ctg in contigs:
        intervals[ctg] = coverage_intervals(bam, ctg, min_coverage)
    regions = BedRegions(intervals)
    if high_conf_bed_fn:
        high_conf = BedRegions.from_file(high_conf_bed_fn)
        intervals = {ctg: _intersect(regions, high_conf, ctg)
                     for ctg in regions.contigs}
    else:
        intervals = {ctg: list(zip(regions.starts[ctg], regions.ends[ctg]))
                     for ctg in regions.contigs}
    write_bed(output_fn, intervals)
    return output_fn


def _intersect(a: BedRegions, b: BedRegions, ctg):
    if a.is_empty(ctg) or b.is_empty(ctg):
        return []
    out = []
    bs, be = b.starts[ctg], b.ends[ctg]
    for s, e in zip(a.starts[ctg], a.ends[ctg]):
        lo = np.searchsorted(be, s, side="right")
        for i in range(lo, len(bs)):
            if bs[i] >= e:
                break
            out.append((int(max(s, bs[i])), int(min(e, be[i]))))
    return out
