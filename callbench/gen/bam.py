"""The benchmark's own BAM and FASTA writers (no code of the program).

write_sample(traffic, seed, index, out_dir) writes contig `index` of a
traffic mix as <name>.fa (+ .fai) and <name>.bam: a coordinate-sorted BAM
of BGZF blocks, one reference sequence, no tags unless the traffic asks for
haplotype tags. Returns the file paths and the read bases written.
"""

import os
import struct
import zlib

import numpy as np

from callbench.gen.simulate import make_contig

_NT16 = np.array([1, 2, 4, 8], np.uint8)          # A C G T in BAM's 4-bit code
_BLOCK = 65280                                     # BGZF payload per block
_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
_HDR = np.dtype([("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
                 ("l_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                 ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                 ("next_ref", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4")])


def _bgzf_blocks(data, level=1):
    out = []
    for i in range(0, len(data), _BLOCK):
        chunk = data[i:i + _BLOCK]
        comp = zlib.compressobj(level, zlib.DEFLATED, -15)
        payload = comp.compress(chunk) + comp.flush()
        out.append(struct.pack("<4BI2BH2B2H", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF,
                               6, 0x42, 0x43, 2, len(payload) + 25))
        out.append(payload)
        out.append(struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF,
                               len(chunk)))
    return b"".join(out)


def reg2bin(beg, end):
    """SAM specification's bin of [beg, end), vectorised."""
    end = end - 1
    out = np.zeros_like(beg)
    done = np.zeros(beg.shape, bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def write_fasta(path, name, text, width=60):
    lines = [text[i:i + width] for i in range(0, len(text), width)]
    head = f">{name}\n"
    with open(path, "w") as f:
        f.write(head + "\n".join(lines) + "\n")
    with open(path + ".fai", "w") as f:
        f.write(f"{name}\t{len(text)}\t{len(head)}\t{width}\t{width + 1}\n")


def _records(ctg, blk, tag_hp):
    """The block's BAM records as one bytes object."""
    n = blk.n
    lo = blk.first
    p = ctg.plan
    names = [f"r{lo + i}".encode() + b"\x00" for i in range(n)]
    q_len = np.diff(blk.q_off)
    hdr = np.zeros(n, _HDR)
    n_cig = np.array([len(c) for c in blk.cigars])
    tag_len = 4 if tag_hp else 0
    hdr["ref_id"] = 0
    hdr["pos"] = p.start[lo:lo + n]
    hdr["l_name"] = [len(s) for s in names]
    hdr["mapq"] = p.mapq[lo:lo + n]
    hdr["bin"] = reg2bin(p.start[lo:lo + n], p.end[lo:lo + n])
    hdr["n_cigar"] = n_cig
    hdr["flag"] = p.strand[lo:lo + n].astype(np.uint16) * 16
    hdr["l_seq"] = q_len
    hdr["next_ref"] = -1
    hdr["next_pos"] = -1
    hdr["block_size"] = (32 + hdr["l_name"].astype(np.int64) + 4 * n_cig
                         + (q_len + 1) // 2 + q_len + tag_len)
    # 4-bit packed sequences: pad odd reads with one 0 nibble
    nt = _NT16[blk.q_code]
    odd = np.nonzero(q_len % 2)[0]
    nt = np.insert(nt, blk.q_off[1:][odd], 0)
    packed = (nt[0::2] << 4) | nt[1::2]
    p_off = np.concatenate([[0], np.cumsum((q_len + 1) // 2)])
    hdr_b = hdr.tobytes()
    packed_b = packed.tobytes()
    qual_b = blk.qual.tobytes()
    q_off = blk.q_off.tolist()
    p_off = p_off.tolist()
    hap = p.hap[lo:lo + n].tolist()
    parts = []
    for i in range(n):
        parts.append(hdr_b[36 * i:36 * i + 36])
        parts.append(names[i])
        parts.append(b"".join(struct.pack("<I", (ln << 4) | op)
                              for op, ln in blk.cigars[i]))
        parts.append(packed_b[p_off[i]:p_off[i + 1]])
        parts.append(qual_b[q_off[i]:q_off[i + 1]])
        if tag_hp:
            parts.append(b"HPc" + bytes([hap[i] + 1]))
    return b"".join(parts)


def write_sample(traffic, seed, index, out_dir):
    """Contig `index` of the traffic mix into out_dir -> dict of paths,
    contig name, length and read bases."""
    ctg = make_contig(traffic, seed, index)
    fa = os.path.join(out_dir, ctg.name + ".fa")
    bam = os.path.join(out_dir, ctg.name + ".bam")
    write_fasta(fa, ctg.name, ctg.ref_text())
    text = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{ctg.name}\t"
            f"LN:{ctg.length}\n").encode()
    head = (b"BAM\x01" + struct.pack("<i", len(text)) + text
            + struct.pack("<i", 1)
            + struct.pack("<i", len(ctg.name) + 1) + ctg.name.encode()
            + b"\x00" + struct.pack("<i", ctg.length))
    bases = 0
    tag_hp = bool(traffic.get("hp_tags", False))
    tmp = bam + ".tmp"
    with open(tmp, "wb") as f:
        pending = head
        for blk in ctg.blocks():
            bases += int(blk.q_off[-1])
            pending += _records(ctg, blk, tag_hp)
            cut = len(pending) - len(pending) % _BLOCK
            f.write(_bgzf_blocks(pending[:cut]))
            pending = pending[cut:]
        f.write(_bgzf_blocks(pending))
        f.write(_EOF)
    os.replace(tmp, bam)
    return {"name": ctg.name, "fasta": fa, "bam": bam,
            "length": ctg.length, "read_bases": bases}
