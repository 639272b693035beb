"""Native BAM reader/writer (no htslib/pysam dependency).

Replaces the reference's `samtools mpileup`/`samtools view` subprocess data
path (src/create_tensor_pileup.py:438-451) with direct record decoding; the
writer exists for data synthesis (tests, benchmarks) and haplotag output.
"""

import struct
from dataclasses import dataclass, field

from clair3_rna_torch.io.bgzf import BgzfReader, BgzfWriter

CIGAR_OPS = "MIDNSHP=X"
CIGAR_M, CIGAR_I, CIGAR_D, CIGAR_N, CIGAR_S, CIGAR_H, CIGAR_P, CIGAR_EQ, CIGAR_X = range(9)
# ops that consume query / reference
CONSUMES_QUERY = (True, True, False, False, True, False, False, True, True)
CONSUMES_REF = (True, False, True, True, False, False, False, True, True)

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
SEQ_NT16_INDEX = {b: i for i, b in enumerate(SEQ_NT16)}
# packed byte -> two-character expansion for fast seq decode
_SEQ_PAIR = [SEQ_NT16[b >> 4] + SEQ_NT16[b & 0xF] for b in range(256)]

FLAG_PAIRED = 0x1
FLAG_UNMAP = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800


@dataclass
class BamRecord:
    name: str
    flag: int
    ref_id: int
    pos: int            # 0-based leftmost aligned position
    mapq: int
    cigar: list         # [(op, length), ...]
    seq: str
    qual: bytes         # raw phred values (no +33 offset)
    tags: dict = field(default_factory=dict)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def reference_end(self) -> int:
        return self.pos + sum(l for op, l in self.cigar if CONSUMES_REF[op])


def _parse_tags(buf: bytes) -> dict:
    tags = {}
    i = 0
    n = len(buf)
    while i + 3 <= n:
        tag = buf[i:i + 2].decode()
        typ = chr(buf[i + 2])
        i += 3
        if typ == "A":
            tags[tag] = chr(buf[i]); i += 1
        elif typ == "c":
            tags[tag] = struct.unpack_from("<b", buf, i)[0]; i += 1
        elif typ == "C":
            tags[tag] = struct.unpack_from("<B", buf, i)[0]; i += 1
        elif typ == "s":
            tags[tag] = struct.unpack_from("<h", buf, i)[0]; i += 2
        elif typ == "S":
            tags[tag] = struct.unpack_from("<H", buf, i)[0]; i += 2
        elif typ == "i":
            tags[tag] = struct.unpack_from("<i", buf, i)[0]; i += 4
        elif typ == "I":
            tags[tag] = struct.unpack_from("<I", buf, i)[0]; i += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", buf, i)[0]; i += 4
        elif typ in "ZH":
            end = buf.index(b"\x00", i)
            tags[tag] = buf[i:end].decode()
            i = end + 1
        elif typ == "B":
            sub = chr(buf[i]); count = struct.unpack_from("<I", buf, i + 1)[0]
            i += 5
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
            size = struct.calcsize(fmt)
            tags[tag] = list(struct.unpack_from(f"<{count}{fmt}", buf, i))
            i += count * size
        else:
            break
    return tags


def _decode_record(buf: bytes) -> BamRecord:
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     _next_ref, _next_pos, _tlen) = struct.unpack_from("<iiBBHHHiiii", buf, 0)
    off = 32
    name = buf[off:off + l_read_name - 1].decode()
    off += l_read_name
    cigar = []
    for k in range(n_cigar):
        v = struct.unpack_from("<I", buf, off + 4 * k)[0]
        cigar.append((v & 0xF, v >> 4))
    off += 4 * n_cigar
    seq_bytes = buf[off:off + (l_seq + 1) // 2]
    off += (l_seq + 1) // 2
    seq = "".join(map(_SEQ_PAIR.__getitem__, seq_bytes))[:l_seq]
    qual = buf[off:off + l_seq]
    off += l_seq
    tags = _parse_tags(buf[off:])
    return BamRecord(name, flag, ref_id, pos, mapq, cigar, seq, qual, tags)


class BamReader:
    """Streaming, index-aware BAM reader with bounded memory.

    Only the header is parsed at open; record access streams BGZF blocks on
    demand. With a BAI (`<bam>.bai`, auto-detected or built in memory on
    first fetch), region queries seek straight to the covering blocks --
    fetch cost scales with the region, not the file, matching what the
    reference gets from htslib (`samtools mpileup -r ctg:start-end`,
    src/create_tensor_pileup.py:438-451). The decompressed stream is never
    materialized whole.
    """

    def __init__(self, path: str, load_index: bool = True):
        self.path = path
        bz = BgzfReader(path)
        if bz.read(4) != b"BAM\x01":
            bz.close()
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", bz.read(4))[0]
        self.header_text = bz.read(l_text).decode(errors="replace")
        n_ref = struct.unpack("<i", bz.read(4))[0]
        self.references = []
        self.reference_lengths = {}
        for _ in range(n_ref):
            l_name = struct.unpack("<i", bz.read(4))[0]
            name = bz.read(l_name)[:-1].decode()
            l_ref = struct.unpack("<i", bz.read(4))[0]
            self.references.append(name)
            self.reference_lengths[name] = l_ref
        self._records_voffset = bz.virtual_offset
        bz.close()
        self.ref_index = {name: i for i, name in enumerate(self.references)}
        self._bai = None
        if load_index:
            from clair3_rna_torch.io.bai import BaiIndex, index_path_for
            bai_path = index_path_for(path)
            if bai_path is not None:
                self._bai = BaiIndex.load(bai_path)

    def close(self):
        pass  # handles are per-iteration; nothing persistent to release

    @property
    def has_index(self) -> bool:
        return self._bai is not None

    def _raw_blocks(self, voffset=None):
        """Fresh BgzfReader positioned at voffset (records start by default).

        Each iteration/fetch gets its own handle so concurrent generators on
        one BamReader never interfere.
        """
        bz = BgzfReader(self.path)
        bz.seek_virtual(self._records_voffset if voffset is None else voffset)
        return bz

    def _scan_extents(self, voffset=None):
        """Yield (ref_id, pos, ref_end, vbeg, vend) per record, decoding only
        the fields the BAI builder needs (no seq/qual/tags)."""
        bz = self._raw_blocks(voffset)
        try:
            while True:
                vbeg = bz.virtual_offset
                head = bz.read(4)
                if len(head) < 4:
                    return
                block_size = struct.unpack("<i", head)[0]
                buf = bz.read(block_size)
                vend = bz.virtual_offset
                ref_id, pos = struct.unpack_from("<ii", buf, 0)
                l_read_name = buf[8]
                n_cigar = struct.unpack_from("<H", buf, 12)[0]
                span = 0
                coff = 32 + l_read_name
                for k in range(n_cigar):
                    v = struct.unpack_from("<I", buf, coff + 4 * k)[0]
                    if CONSUMES_REF[v & 0xF]:
                        span += v >> 4
                yield ref_id, pos, pos + span, vbeg, vend
        finally:
            bz.close()

    def _records_from(self, voffset=None):
        """Yield (BamRecord, vend) streaming from voffset."""
        bz = self._raw_blocks(voffset)
        try:
            while True:
                head = bz.read(4)
                if len(head) < 4:
                    return
                block_size = struct.unpack("<i", head)[0]
                buf = bz.read(block_size)
                yield _decode_record(buf), bz.virtual_offset
        finally:
            bz.close()

    def __iter__(self):
        return (rec for rec, _ in self._records_from())

    def _ensure_index(self):
        if self._bai is None:
            from clair3_rna_torch.io.bai import IndexBuilder
            builder = IndexBuilder(len(self.references))
            for extent in self._scan_extents():
                builder.add(*extent)
            self._bai = builder.finish()
        return self._bai

    def fetch(self, contig: str, start: int = 0, end: int | None = None,
              exclude_flags: int = 0, min_mapq: int = 0):
        """Yield records overlapping [start, end) on contig (0-based).

        Uses the BAI when present (on-disk or built in memory on first call)
        to inflate only the blocks covering the region.
        """
        want_ref = self.ref_index[contig]
        if end is None:
            end = self.reference_lengths[contig]
        bai = self._ensure_index()
        for vbeg, vend in bai.query(want_ref, start, end):
            for rec, voff in self._records_from(vbeg):
                if rec.ref_id != want_ref or rec.pos >= end:
                    return  # coordinate-sorted: nothing later can overlap
                if not (rec.flag & exclude_flags) and rec.mapq >= min_mapq \
                        and rec.reference_end > start:
                    yield rec
                if voff >= vend:
                    break


class BamWriter:
    def __init__(self, path: str, references: list[tuple[str, int]],
                 header_text: str | None = None, threads: int = 1):
        self._w = BgzfWriter(path, threads=threads)
        self.references = references
        self.ref_index = {name: i for i, (name, _) in enumerate(references)}
        if header_text is None:
            lines = ["@HD\tVN:1.6\tSO:coordinate"]
            lines += [f"@SQ\tSN:{n}\tLN:{l}" for n, l in references]
            header_text = "\n".join(lines) + "\n"
        text = header_text.encode()
        out = bytearray(b"BAM\x01")
        out += struct.pack("<i", len(text)) + text
        out += struct.pack("<i", len(references))
        for name, length in references:
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self._w.write(bytes(out))

    @staticmethod
    def _encode_tags(tags: dict) -> bytes:
        out = bytearray()
        for tag, value in tags.items():
            t = tag.encode()
            if isinstance(value, int):
                if -128 <= value <= 127:
                    out += t + b"c" + struct.pack("<b", value)
                else:
                    out += t + b"i" + struct.pack("<i", value)
            elif isinstance(value, float):
                out += t + b"f" + struct.pack("<f", value)
            elif isinstance(value, str) and len(value) == 1:
                out += t + b"A" + value.encode()
            elif isinstance(value, str):
                out += t + b"Z" + value.encode() + b"\x00"
            else:
                raise TypeError(f"unsupported tag type for {tag}: {type(value)}")
        return bytes(out)

    def write(self, rec: BamRecord):
        name = rec.name.encode() + b"\x00"
        n_cigar = len(rec.cigar)
        l_seq = len(rec.seq)
        seq_bytes = bytearray((l_seq + 1) // 2)
        for i, base in enumerate(rec.seq):
            code = SEQ_NT16_INDEX.get(base.upper(), 15)
            if i % 2 == 0:
                seq_bytes[i // 2] |= code << 4
            else:
                seq_bytes[i // 2] |= code
        qual = rec.qual if rec.qual else bytes([0xFF] * l_seq)
        tags = self._encode_tags(rec.tags)
        body = bytearray()
        body += struct.pack(
            "<iiBBHHHiiii",
            rec.ref_id, rec.pos, len(name), rec.mapq,
            _reg2bin(rec.pos, rec.reference_end or rec.pos + 1),
            n_cigar, rec.flag, l_seq, -1, -1, 0,
        )
        body += name
        for op, length in rec.cigar:
            body += struct.pack("<I", (length << 4) | op)
        body += bytes(seq_bytes)
        body += qual
        body += tags
        self._w.write(struct.pack("<i", len(body)) + bytes(body))

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


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
