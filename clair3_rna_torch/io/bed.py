"""BED regions: vectorized interval membership.

Replaces the reference's vendored interval tree (shared/interval_tree.py +
shared/intervaltree/, ~6.3k LoC of pure Python) with sorted merged interval
arrays + numpy searchsorted -- O(log n) membership, vectorizable over whole
position tiles, which is what candidate masking needs.
"""

import gzip
import os
from collections import defaultdict

import numpy as np


class BedRegions:
    """Per-contig merged, sorted half-open intervals [start, end)."""

    def __init__(self, intervals_by_contig: dict | None = None):
        self.starts = {}
        self.ends = {}
        if intervals_by_contig:
            for ctg, intervals in intervals_by_contig.items():
                self._set(ctg, intervals)

    def _set(self, ctg, intervals):
        merged = []
        for s, e in sorted(intervals):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts[ctg] = np.asarray([m[0] for m in merged], dtype=np.int64)
        self.ends[ctg] = np.asarray([m[1] for m in merged], dtype=np.int64)

    @classmethod
    def from_file(cls, bed_path: str, contig_name: str | None = None):
        intervals = defaultdict(list)
        opener = gzip.open if bed_path.endswith(".gz") else open
        with opener(bed_path, "rt") as f:
            for line in f:
                if not line.strip() or line.startswith(("#", "track", "browser")):
                    continue
                cols = line.rstrip("\n").split("\t")
                ctg = cols[0]
                if contig_name is not None and ctg != contig_name:
                    continue
                intervals[ctg].append((int(cols[1]), int(cols[2])))
        return cls(intervals)

    @property
    def contigs(self):
        return list(self.starts)

    def is_empty(self, ctg=None) -> bool:
        if ctg is not None:
            return ctg not in self.starts or len(self.starts[ctg]) == 0
        return all(len(v) == 0 for v in self.starts.values())

    def contig_span(self, ctg):
        """(min_start, max_end) over the contig's intervals."""
        if self.is_empty(ctg):
            return None
        return int(self.starts[ctg][0]), int(self.ends[ctg][-1])

    def overlaps(self, ctg: str, region_start, region_end) -> np.ndarray:
        """Vectorized: does [region_start_i, region_end_i) overlap any interval?

        Matches the reference's is_region_in overlap test
        (shared/interval_tree.py:80-89).
        """
        region_start = np.atleast_1d(np.asarray(region_start, dtype=np.int64))
        region_end = np.atleast_1d(np.asarray(region_end, dtype=np.int64))
        if ctg not in self.starts or len(self.starts[ctg]) == 0:
            return np.zeros(len(region_start), dtype=bool)
        starts, ends = self.starts[ctg], self.ends[ctg]
        # candidate interval: the last one starting before region_end
        idx = np.searchsorted(starts, region_end, side="left") - 1
        valid = idx >= 0
        idx_c = np.clip(idx, 0, len(starts) - 1)
        return valid & (ends[idx_c] > region_start)

    def contains(self, ctg: str, positions) -> np.ndarray:
        """Vectorized point membership (position in some [start, end))."""
        return self.overlaps(ctg, positions, np.asarray(positions) + 1)

    def mask_for_range(self, ctg: str, start: int, end: int) -> np.ndarray:
        """Dense bool mask over [start, end)."""
        width = end - start
        mask = np.zeros(width, dtype=bool)
        if ctg not in self.starts:
            return mask
        for s, e in zip(self.starts[ctg], self.ends[ctg]):
            lo, hi = max(s, start), min(e, end)
            if lo < hi:
                mask[lo - start:hi - start] = True
        return mask


def write_bed(path, intervals_by_contig):
    with open(path, "w") as f:
        for ctg, intervals in intervals_by_contig.items():
            for s, e in intervals:
                f.write(f"{ctg}\t{s}\t{e}\n")
    return path
