"""Minimal tabix (.tbi) index writer for bgzipped VCFs.

Native replacement for the reference's external `tabix -p vcf` call
(src/sort_vcf.py:70-75): builds the standard R-tree binning + 16kb linear
index over BGZF virtual offsets so downstream htslib/IGV tools can seek.
"""

import struct
import zlib

from clair3_rna_torch.io.bgzf import bgzf_compress


def _reg2bin(beg: int, end: int) -> int:
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


def _iter_lines_with_voffsets(path):
    """Yield (voffset_start, voffset_end, line_bytes) over a BGZF text file."""
    with open(path, "rb") as f:
        raw = f.read()
    pos = 0
    pending = b""
    pending_voff = 0
    n = len(raw)
    while pos < n:
        if raw[pos:pos + 2] != b"\x1f\x8b":
            break
        xlen = struct.unpack_from("<H", raw, pos + 10)[0]
        extra = raw[pos + 12:pos + 12 + xlen]
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack_from("<H", extra, i + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", extra, i + 4)[0] + 1
            i += 4 + slen
        data = zlib.decompress(raw[pos + 12 + xlen:pos + bsize - 8], -15)
        within = 0
        while True:
            nl = data.find(b"\n", within)
            if nl < 0:
                if within < len(data):
                    if not pending:
                        pending_voff = (pos << 16) | within
                    pending += data[within:]
                break
            start_voff = pending_voff if pending else ((pos << 16) | within)
            line = pending + data[within:nl + 1]
            pending = b""
            within = nl + 1
            end_voff = (pos << 16) | within
            if within == len(data):
                # end lands exactly at block end: point at next block start
                end_voff = ((pos + bsize) << 16)
            yield start_voff, end_voff, line
        pos += bsize
    if pending:
        yield pending_voff, ((pos) << 16), pending


def build_tabix_index(gz_path: str, out_path: str | None = None) -> str:
    """Build a VCF-preset .tbi for a coordinate-sorted bgzipped VCF."""
    out_path = out_path or gz_path + ".tbi"
    names = []
    name_index = {}
    per_ref_bins = []   # list of {bin: [(beg_voff, end_voff)]}
    per_ref_linear = []  # list of {intv: min_voff}

    for beg_voff, end_voff, line in _iter_lines_with_voffsets(gz_path):
        if line.startswith(b"#") or not line.strip():
            continue
        cols = line.split(b"\t", 4)
        ctg = cols[0].decode()
        pos1 = int(cols[1])
        ref_allele = cols[3]
        beg0 = pos1 - 1
        end0 = beg0 + max(1, len(ref_allele))
        if ctg not in name_index:
            name_index[ctg] = len(names)
            names.append(ctg)
            per_ref_bins.append({})
            per_ref_linear.append({})
        rid = name_index[ctg]
        b = _reg2bin(beg0, end0)
        per_ref_bins[rid].setdefault(b, []).append((beg_voff, end_voff))
        for intv in range(beg0 >> 14, ((end0 - 1) >> 14) + 1):
            cur = per_ref_linear[rid].get(intv)
            if cur is None or beg_voff < cur:
                per_ref_linear[rid][intv] = beg_voff

    out = bytearray()
    out += b"TBI\x01"
    out += struct.pack("<i", len(names))
    concat_names = b"".join(n.encode() + b"\x00" for n in names)
    out += struct.pack("<6i", 2, 1, 2, 0, ord("#"), 0)  # VCF preset
    out += struct.pack("<i", len(concat_names))
    out += concat_names
    for rid in range(len(names)):
        bins = per_ref_bins[rid]
        out += struct.pack("<i", len(bins))
        for b in sorted(bins):
            chunks = _merge_chunks(bins[b])
            out += struct.pack("<I", b)
            out += struct.pack("<i", len(chunks))
            for cb, ce in chunks:
                out += struct.pack("<QQ", cb, ce)
        linear = per_ref_linear[rid]
        n_intv = (max(linear) + 1) if linear else 0
        out += struct.pack("<i", n_intv)
        filled = 0
        offsets = []
        for i in range(n_intv):
            if i in linear:
                filled = linear[i]
            offsets.append(filled)
        for off in offsets:
            out += struct.pack("<Q", off)

    with open(out_path, "wb") as f:
        f.write(bgzf_compress(bytes(out)))
    return out_path


def _merge_chunks(chunks):
    merged = []
    for beg, end in sorted(chunks):
        if merged and beg <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((beg, end))
    return merged
