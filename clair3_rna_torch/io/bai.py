"""BAI (BAM index) reader, writer, and builder.

Gives the BAM layer htslib-grade random access: the reference gets region
streaming for free from `samtools mpileup -r ctg:start-end` over an indexed
BAM (src/create_tensor_pileup.py:438-451, samtools index at
run_clair3_rna:769-801); here the equivalent is a BAI consumed by
BamReader.fetch / the native tile builder, so a whole-genome BAM never has to
be resident in RAM — fetch cost scales with the region, not the file.

Format (SAM spec §5.2): R-tree binning of [pos, end) intervals into 6 levels
(bin 0 = whole contig, 4681.. = 16 kb leaves) plus a 16 kb-granularity linear
index of smallest virtual offsets, used to prune bins' chunk lists.
"""

import os
import struct

BAI_MAGIC = b"BAI\x01"
# bins 0..37448 are real; 37450 is samtools' unmapped-count pseudo-bin
MAX_BIN = 37449
_LINEAR_SHIFT = 14  # 16 kb linear-index windows


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin containing [beg, end) (SAM spec §5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int):
    """All bins overlapping [beg, end)."""
    end -= 1
    bins = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


class BaiIndex:
    """Parsed BAI: per-reference bin->chunks maps + 16 kb linear index."""

    def __init__(self, bins, linear, n_no_coor=0):
        self.bins = bins        # [ {bin: [(vbeg, vend), ...]} ] per reference
        self.linear = linear    # [ [voffset, ...] ] per reference
        self.n_no_coor = n_no_coor

    @classmethod
    def load(cls, path: str) -> "BaiIndex":
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != BAI_MAGIC:
            raise ValueError(f"{path}: not a BAI index")
        n_ref = struct.unpack_from("<i", data, 4)[0]
        off = 8
        bins, linear = [], []
        for _ in range(n_ref):
            n_bin = struct.unpack_from("<i", data, off)[0]
            off += 4
            bmap = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = list(
                    struct.iter_unpack("<QQ", data[off:off + 16 * n_chunk]))
                off += 16 * n_chunk
                if bin_id <= MAX_BIN:  # skip the 37450 metadata pseudo-bin
                    bmap[bin_id] = chunks
            n_intv = struct.unpack_from("<i", data, off)[0]
            off += 4
            linear.append(list(struct.unpack_from(f"<{n_intv}Q", data, off)))
            off += 8 * n_intv
            bins.append(bmap)
        n_no_coor = struct.unpack_from("<Q", data, off)[0] if off + 8 <= len(data) else 0
        return cls(bins, linear, n_no_coor)

    def save(self, path: str):
        out = bytearray(BAI_MAGIC)
        out += struct.pack("<i", len(self.bins))
        for bmap, lin in zip(self.bins, self.linear):
            out += struct.pack("<i", len(bmap))
            for bin_id in sorted(bmap):
                chunks = bmap[bin_id]
                out += struct.pack("<Ii", bin_id, len(chunks))
                for vbeg, vend in chunks:
                    out += struct.pack("<QQ", vbeg, vend)
            out += struct.pack("<i", len(lin))
            out += struct.pack(f"<{len(lin)}Q", *lin)
        out += struct.pack("<Q", self.n_no_coor)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(bytes(out))
        os.replace(tmp, path)

    def query(self, ref_id: int, beg: int, end: int):
        """Merged, sorted virtual-offset chunks possibly containing records
        overlapping [beg, end); pruned by the linear index."""
        if ref_id < 0 or ref_id >= len(self.bins):
            return []
        bmap = self.bins[ref_id]
        lin = self.linear[ref_id]
        win = beg >> _LINEAR_SHIFT
        min_off = lin[win] if win < len(lin) else (lin[-1] if lin else 0)
        chunks = []
        for b in reg2bins(beg, end):
            for vbeg, vend in bmap.get(b, ()):
                if vend > min_off:
                    chunks.append((max(vbeg, min_off), vend))
        chunks.sort()
        merged = []
        for vbeg, vend in chunks:
            # merge chunks that touch the same BGZF block (coffset equality
            # is enough; htslib merges when beg>>16 == prev_end>>16)
            if merged and vbeg >> 16 <= merged[-1][1] >> 16:
                merged[-1][1] = max(merged[-1][1], vend)
            else:
                merged.append([vbeg, vend])
        return [tuple(c) for c in merged]


class IndexBuilder:
    """Streaming accumulator: feed coordinate-sorted records, emit a BaiIndex.

    Memory is O(index), never O(file): only bin chunk lists and the linear
    index are retained.
    """

    def __init__(self, n_ref: int):
        self.bins = [{} for _ in range(n_ref)]
        self.linear = [[] for _ in range(n_ref)]
        self.n_no_coor = 0
        self._last_key = None

    def add(self, ref_id: int, pos: int, end: int, vbeg: int, vend: int):
        if ref_id < 0:
            self.n_no_coor += 1
            return
        key = (ref_id, pos)
        if self._last_key is not None and key < self._last_key:
            raise ValueError(
                f"BAM not coordinate-sorted (saw ref {ref_id}:{pos} after "
                f"{self._last_key[0]}:{self._last_key[1]}); cannot index")
        self._last_key = key
        end = max(end, pos + 1)
        b = reg2bin(pos, end)
        chunks = self.bins[ref_id].setdefault(b, [])
        # extend the previous chunk when contiguous in the file
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1][1] = vend
        else:
            chunks.append([vbeg, vend])
        lin = self.linear[ref_id]
        for win in range(pos >> _LINEAR_SHIFT, ((end - 1) >> _LINEAR_SHIFT) + 1):
            while len(lin) <= win:
                lin.append(0)
            if lin[win] == 0 or vbeg < lin[win]:
                lin[win] = vbeg

    def finish(self) -> BaiIndex:
        # fill linear-index holes with the next known offset (htslib keeps 0;
        # query() treats 0 as "no pruning", so backfilling forward keeps the
        # index valid AND tighter for sparse coverage)
        for lin in self.linear:
            last = 0
            for i in range(len(lin)):
                if lin[i] == 0:
                    lin[i] = last
                else:
                    last = lin[i]
        bins = [{b: [tuple(c) for c in chunks] for b, chunks in bmap.items()}
                for bmap in self.bins]
        return BaiIndex(bins, self.linear, self.n_no_coor)


def index_path_for(bam_path: str):
    """Existing index path for a BAM (.bam.bai preferred, then .bai twin)."""
    for cand in (bam_path + ".bai",
                 os.path.splitext(bam_path)[0] + ".bai"):
        if os.path.exists(cand):
            return cand
    return None


def build_index(bam_path: str, bai_path: str | None = None,
                write: bool = True, prefer_native: bool = True) -> BaiIndex:
    """Index a coordinate-sorted BAM (samtools-index equivalent).

    Streams the file block by block -- bounded memory. Prefers the C++
    builder (native/pileup_native.cc bam_build_index) when available and a
    file output is wanted; the pure-Python builder is the differential
    oracle (tests/test_bai.py). Returns the in-memory index; also writes
    `<bam>.bai` unless write=False.
    """
    import os
    target = bai_path or bam_path + ".bai"
    if write and prefer_native \
            and not os.environ.get("CLAIR3_RNA_TORCH_NO_NATIVE"):
        try:
            from clair3_rna_torch.native import get_library
            lib = get_library()
        except Exception:
            lib = None
        if lib is not None:
            rc = lib.bam_build_index(bam_path.encode(), target.encode())
            if rc == 3:
                raise ValueError(f"{bam_path}: not coordinate-sorted; "
                                 "cannot index")
            if rc == 0:
                return BaiIndex.load(target)
            # other failures: fall through to the Python builder

    from clair3_rna_torch.io.bam import BamReader

    reader = BamReader(bam_path, load_index=False)
    builder = IndexBuilder(len(reader.references))
    for ref_id, pos, end, vbeg, vend in reader._scan_extents():
        builder.add(ref_id, pos, end, vbeg, vend)
    index = builder.finish()
    if write:
        index.save(target)
    reader.close()
    return index
