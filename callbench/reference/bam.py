"""A plain BAM record reader (BGZF blocks through zlib; no index, no code of
the program): each record's read name and HP tag, for the check of the
program's haplotagged BAM."""

import struct
import zlib

# bytes of one value of each fixed-size aux type (SAM specification 4.2.4)
_AUX_SIZE = {b"A": 1, b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4,
             b"f": 4}
_INT_AUX = {b"c": "<b", b"C": "<B", b"s": "<h", b"S": "<H", b"i": "<i",
            b"I": "<I"}


def _inflate(path):
    """The BGZF file's decompressed bytes, block after block."""
    with open(path, "rb") as f:
        data = f.read()
    out = []
    at = 0
    while at < len(data):
        if data[at:at + 4] != b"\x1f\x8b\x08\x04":
            raise ValueError(f"{path}: not BGZF at byte {at}")
        xlen = struct.unpack_from("<H", data, at + 10)[0]
        bsize = None
        x = at + 12
        while x < at + 12 + xlen:
            si, slen = data[x:x + 2], struct.unpack_from("<H", data, x + 2)[0]
            if si == b"BC":
                bsize = struct.unpack_from("<H", data, x + 4)[0]
            x += 4 + slen
        if bsize is None:
            raise ValueError(f"{path}: BGZF block without BSIZE at byte {at}")
        payload = data[at + 12 + xlen:at + bsize - 7]
        out.append(zlib.decompress(payload, -15))
        at += bsize + 1
    return b"".join(out)


def _hp(aux):
    """The HP tag's value in a record's aux bytes (0 without one)."""
    x = 0
    while x < len(aux):
        tag, typ = aux[x:x + 2], aux[x + 2:x + 3]
        x += 3
        if typ in _INT_AUX:
            if tag == b"HP":
                return struct.unpack_from(_INT_AUX[typ], aux, x)[0]
            x += _AUX_SIZE[typ]
        elif typ in _AUX_SIZE:
            x += _AUX_SIZE[typ]
        elif typ in (b"Z", b"H"):
            x = aux.index(b"\x00", x) + 1
        elif typ == b"B":
            sub, count = aux[x:x + 1], struct.unpack_from("<i", aux, x + 1)[0]
            x += 5 + count * _AUX_SIZE[sub]
        else:
            raise ValueError(f"unknown aux type {typ!r}")
    return 0


def read_hp(path):
    """[(read name, HP)] of every record of a BAM, in file order; HP 0
    where a record has no HP tag."""
    raw = _inflate(path)
    if raw[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    l_text = struct.unpack_from("<i", raw, 4)[0]
    at = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, at)[0]
    at += 4
    for _ in range(n_ref):
        at += 8 + struct.unpack_from("<i", raw, at)[0]
    out = []
    while at < len(raw):
        size = struct.unpack_from("<i", raw, at)[0]
        l_name = raw[at + 12]
        n_cigar, = struct.unpack_from("<H", raw, at + 16)
        l_seq, = struct.unpack_from("<i", raw, at + 20)
        name = raw[at + 36:at + 35 + l_name].decode()
        aux = at + 36 + l_name + 4 * n_cigar + (l_seq + 1) // 2 + l_seq
        out.append((name, _hp(raw[aux:at + 4 + size])))
        at += 4 + size
    return out
