"""BGZF (blocked gzip) reader/writer.

BGZF is the container format of BAM and of bgzip-compressed VCF: a sequence of
independent gzip members, each <= 64 KiB uncompressed, carrying a BC extra
field with the compressed block size so readers can seek by (block offset,
intra-block offset) "virtual offsets". Replaces the reference's external
`bgzip` dependency (src/sort_vcf.py:70-75).
"""

import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
_HEADER = struct.Struct("<4BI2BH")  # magic, mtime, xfl, os, xlen
_MAX_BLOCK_DATA = 65280  # uncompressed payload per block (htslib convention)


def _build_block(data: bytes) -> bytes:
    compressor = zlib.compressobj(6, zlib.DEFLATED, -15)
    payload = compressor.compress(data) + compressor.flush()
    bsize = len(payload) + 25  # total block size - 1: header(12)+extra(6)+footer(8)-1
    header = struct.pack(
        "<4BI2BH2B2H",
        0x1F, 0x8B, 0x08, 0x04,  # gzip magic, deflate, FEXTRA
        0,                        # mtime
        0, 0xFF,                  # xfl, os
        6,                        # xlen
        0x42, 0x43,               # 'B','C'
        2,                        # subfield length
        bsize,                    # total block size - 1
    )
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data) & 0xFFFFFFFF)
    return header + payload + footer


def bgzf_compress(data: bytes) -> bytes:
    """Compress bytes into a complete BGZF stream (with EOF block)."""
    out = []
    for i in range(0, len(data), _MAX_BLOCK_DATA):
        out.append(_build_block(data[i:i + _MAX_BLOCK_DATA]))
    out.append(BGZF_EOF)
    return b"".join(out)


def bgzf_decompress(data: bytes) -> bytes:
    """Decompress a full BGZF (or plain multi-member gzip) byte stream."""
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        decomp = zlib.decompressobj(15 + 32)  # auto-detect gzip header
        out.append(decomp.decompress(data[pos:]))
        consumed = n - pos - len(decomp.unused_data)
        if consumed <= 0:
            break
        pos += consumed
    return b"".join(out)


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(18)
    return (
        len(head) >= 18
        and head[:4] == b"\x1f\x8b\x08\x04"
        and head[12:14] == b"BC"
    )


class BgzfReader:
    """Random-access BGZF reader supporting virtual-offset seeks (for BAI)."""

    def __init__(self, path: str):
        self._fp = open(path, "rb")
        self._block_start = 0       # compressed offset of current block
        self._buffer = b""
        self._within = 0            # uncompressed offset within current block

    def close(self):
        self._fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _load_block(self, compressed_offset=None):
        if compressed_offset is not None:
            self._fp.seek(compressed_offset)
        self._block_start = self._fp.tell()
        header = self._fp.read(12)
        if len(header) < 12:
            self._buffer = b""
            self._within = 0
            return False
        magic1, magic2, _, flg, _, _, _, xlen = _HEADER.unpack(header)
        if magic1 != 0x1F or magic2 != 0x8B:
            raise ValueError("not a BGZF stream")
        extra = self._fp.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack_from("<H", extra, i + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", extra, i + 4)[0] + 1
            i += 4 + slen
        if bsize is None:
            raise ValueError("missing BGZF BC extra field")
        payload = self._fp.read(bsize - 12 - xlen - 8)
        self._fp.read(8)  # crc + isize
        self._buffer = zlib.decompress(payload, -15)
        self._within = 0
        return True

    @property
    def virtual_offset(self) -> int:
        return (self._block_start << 16) | self._within

    def seek_virtual(self, voffset: int):
        coffset, uoffset = voffset >> 16, voffset & 0xFFFF
        self._load_block(coffset)
        self._within = uoffset

    def read(self, size: int) -> bytes:
        chunks = []
        need = size
        while need > 0:
            if self._within >= len(self._buffer):
                if not self._load_block():
                    break
                if not self._buffer:
                    continue
            take = min(need, len(self._buffer) - self._within)
            chunks.append(self._buffer[self._within:self._within + take])
            self._within += take
            need -= take
        return b"".join(chunks)


class BgzfWriter:
    """BGZF writer; threads > 1 deflates blocks on a thread pool (zlib
    releases the GIL) while this thread keeps packing records -- the
    in-process analogue of `bgzip -@N`. Ordered writes are preserved by
    draining futures FIFO; `virtual_offset` drains first so offsets remain
    exact for index builders."""

    def __init__(self, path: str, threads: int = 1):
        self._fp = open(path, "wb")
        self._pending = bytearray()
        self._pool = None
        self._futures = None
        if threads > 1:
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=threads)
            self._futures = deque()
            self._max_inflight = 4 * threads

    def _drain(self, down_to=0):
        while self._futures and len(self._futures) > down_to:
            self._fp.write(self._futures.popleft().result())

    def write(self, data: bytes):
        self._pending.extend(data)
        while len(self._pending) >= _MAX_BLOCK_DATA:
            block = bytes(self._pending[:_MAX_BLOCK_DATA])
            del self._pending[:_MAX_BLOCK_DATA]
            if self._pool is not None:
                self._futures.append(self._pool.submit(_build_block, block))
                self._drain(down_to=self._max_inflight)
            else:
                self._fp.write(_build_block(block))

    @property
    def virtual_offset(self) -> int:
        if self._pool is not None:
            self._drain()
        return (self._fp.tell() << 16) | len(self._pending)

    def flush_block(self):
        if self._pool is not None:
            self._drain()
        if self._pending:
            self._fp.write(_build_block(bytes(self._pending)))
            self._pending.clear()

    def close(self):
        self.flush_block()
        self._fp.write(BGZF_EOF)
        self._fp.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
