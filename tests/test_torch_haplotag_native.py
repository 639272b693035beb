"""The builtin phaser's native passes (native/pileup_native.cc:
het_scan_native, haplotag_rewrite_contig) against the Python path they
replace, on the CPU: the scan's names and alleles equal
phase.read_alleles over BamReader.fetch; the rewrite's decompressed stream
and its blocks equal BamWriter's byte for byte, over hand-made records
(mate fields, every tag type, HP tags, repeated names, records fetch drops)
and across block windows smaller than the BAM; phase_and_haplotag's
counters equal the Python path's; with CLAIR3_RNA_TORCH_NO_NATIVE the Python
path runs; input the Python path raises on raises the same there.
"""

import random
import shutil
import struct

import numpy as np
import pytest

from clair3_rna_torch import native
from clair3_rna_torch.caller import spans
from clair3_rna_torch.io.bai import build_index
from clair3_rna_torch.io.bam import (SEQ_NT16, BamReader, BamWriter,
                                     header_bytes)
from clair3_rna_torch.io.bgzf import bgzf_compress, bgzf_decompress
from clair3_rna_torch.phasing import phase as tph
from clair3_rna_torch.phasing import pipeline as tpp

# tests/test_torch_phasing.py is imported inside the fixtures: where pytest
# runs without this repository's conftest (the card's `-m cuda` run), a
# top-level `tests` may name another installed package
CONTIG_LEN = {"chrA": 3000, "chrB": 2000, "chrC": 1500}
VCF_HEADER = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
              "FILTER\tINFO\tFORMAT\tS\n")


@pytest.fixture(scope="module")
def hp_dataset(tmp_path_factory):
    """tests/test_torch_phasing.py's hp_dataset."""
    from tests.test_torch_phasing import make_hp_dataset
    return make_hp_dataset(tmp_path_factory.mktemp("torch_phasing"))


@pytest.fixture(scope="module")
def lib():
    if native.get_library() is None:
        pytest.skip("the native library does not build here")
    return native.get_library()


def _tag(key, typ, payload):
    return key.encode() + typ.encode() + payload


def _record(name, flag, ref_id, pos, cigar, seq, tags=b"", mapq=30,
            mate=(-1, -1, 0), pad=0, qual=None):
    """Raw record bytes (with block_size) as an aligner may write them: mate
    fields, any tag types, a nonzero pad nibble after an odd sequence."""
    nb = name.encode() + b"\x00"
    packed = bytearray((len(seq) + 1) // 2)
    for i, base in enumerate(seq):
        packed[i // 2] |= SEQ_NT16.index(base) << (0 if i % 2 else 4)
    if len(seq) % 2:
        packed[-1] |= pad
    if qual is None:
        qual = bytes((20 + i % 17) for i in range(len(seq)))
    body = struct.pack("<iiBBHHHiiii", ref_id, pos, len(nb), mapq, 4680,
                       len(cigar), flag, len(seq), *mate)
    body += nb + b"".join(struct.pack("<I", n << 4 | op) for op, n in cigar)
    body += bytes(packed) + qual + tags
    return struct.pack("<i", len(body)) + body


def _write_bam(path, records):
    """Records sorted by position (stable; unmapped last), BGZF, a BAI."""
    def key(rec):
        ref_id, pos = struct.unpack_from("<ii", rec, 4)
        return ref_id < 0, ref_id, pos
    refs = list(CONTIG_LEN.items())
    data = header_bytes(refs, None) + b"".join(sorted(records, key=key))
    with open(path, "wb") as f:
        f.write(bgzf_compress(data))
    build_index(path)
    return path


def _genome(rng):
    return {c: "".join(rng.choice("ACGT") for _ in range(n))
            for c, n in CONTIG_LEN.items()}


def _filler(rng, genome, ref_id, ctg, n):
    """Sorted reads with substitutions, soft clips, an insertion, a
    deletion and a splice, each with a few tags."""
    out = []
    for i, pos in enumerate(sorted(rng.randrange(0, CONTIG_LEN[ctg] - 700)
                                   for _ in range(n))):
        ref = genome[ctg]
        a, b = rng.randrange(50, 200), rng.randrange(100, 300)
        p2 = pos + a + 2          # after the deletion
        p3 = p2 + b // 2 + 40     # after the splice
        seq = ("TT" + "".join(c if rng.random() > 0.05 else rng.choice("ACGTN")
                              for c in ref[pos:pos + a])
               + "G" + ref[p2:p2 + b // 2] + ref[p3:p3 + b - b // 2])
        cigar = [(4, 2), (0, a), (1, 1), (2, 2), (0, b // 2), (3, 40),
                 (0, b - b // 2)]
        tags = (_tag("NM", "C", bytes([i % 200])) + _tag("RG", "Z", b"grp1\0")
                + _tag("AS", "S", struct.pack("<H", 40 * i % 65536)))
        out.append(_record(f"{ctg}_r{i}", 16 * (i % 2), ref_id, pos, cigar,
                           seq, tags, mapq=rng.choice([3, 20, 60])))
    return out


def _edge_bam(path, rng, genome):
    """Filler reads, and one record of each kind the writer normalises or
    fetch drops, over chrA, chrB and chrC (the contig left out of
    `contigs`)."""
    g = genome["chrA"]
    recs = [_record("pos0_nospan", 0, 0, 0, [], "ACG")]   # fetch drops it
    recs += _filler(rng, genome, 0, "chrA", 150)
    every_tag = (
        _tag("XC", "C", bytes([200])) + _tag("Xc", "c", struct.pack("<b", -7))
        + _tag("Xs", "s", struct.pack("<h", -300))
        + _tag("XS", "S", struct.pack("<H", 60000))
        + _tag("XI", "I", struct.pack("<I", 70000))
        + _tag("Xi", "i", struct.pack("<i", 5))
        + _tag("XZ", "Z", b"a text\0") + _tag("X1", "Z", b"q\0")
        + _tag("X0", "Z", b"\0") + _tag("XA", "A", b"k")
        + _tag("Xf", "f", struct.pack("<f", 0.1))
        + _tag("XH", "H", b"1AE3\0") + _tag("XC", "i", struct.pack("<i", 9)))
    recs += [
        # mate fields set, every tag type, a key given twice
        _record("mate_tags", 1 | 32 | 64, 0, 2000, [(0, 60)],
                g[2000:2060], every_tag, mate=(1, 500, 350), pad=0),
        # existing HP tags: the phaser's HP replaces one, leaves the other
        _record("hp_kept", 0, 0, 2010, [(0, 51)], g[2010:2061],
                _tag("HP", "C", bytes([1])) + _tag("ZZ", "Z", b"end\0"),
                pad=5),
        _record("hp_replaced", 0, 0, 2020, [(0, 50)], g[2020:2070],
                _tag("HP", "i", struct.pack("<i", 1)) + _tag("NM", "C", b"\0")),
        # one name twice: primary and supplementary
        _record("twice", 0, 0, 2030, [(4, 5), (0, 40)], "NNNNN" + g[2030:2070]),
        _record("twice", 2048, 0, 2100, [(0, 30), (5, 20)], g[2100:2130]),
        # no sequence (secondary), an unknown tag type ending the tags
        _record("secondary", 256, 0, 2200, [(0, 30)], "", qual=b"",
                tags=_tag("XA", "A", b"z") + b"XQq\x01\x02\x03"),
        # placed unmapped: a position, no reference span
        _record("placed_unmapped", 4, 0, 2300, [], "ACGTA"),
        # an A tag above ASCII, written back as two UTF-8 bytes (last, so
        # the reader still parses the record: one byte is left over)
        _record("a_high", 0, 0, 2400, [(0, 10)], g[2400:2410],
                _tag("XB", "A", b"\xe9")),
        # past the contig's end: fetch stops here
        _record("past_end", 0, 0, 3100, [(0, 10)], "ACGTACGTAC"),
    ]
    recs += _filler(rng, genome, 1, "chrB", 80)
    recs += [_record("twice", 0, 1, 1990, [(0, 5)], "ACGTA")]
    recs += _filler(rng, genome, 2, "chrC", 40)
    recs += [_record(f"unmapped{i}", 4, -1, -1, [], "ACGT") for i in range(3)]
    return _write_bam(path, recs)


@pytest.fixture(scope="module")
def edge_dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("haplotag_native")
    rng = random.Random(41)
    genome = _genome(rng)
    bam = _edge_bam(str(tmp / "edge.bam"), rng, genome)
    # het sites: the genome's base as REF; a lowercase ALT and an N REF
    # that nothing matches
    sites = []
    for ctg in ("chrA", "chrB"):
        vcf_rows = []
        for pos in range(7, CONTIG_LEN[ctg] - 50, 23):
            ref = genome[ctg][pos]
            alt = "ACGT"[("ACGT".index(ref) + 1 + pos % 3) % 4]
            if pos % 10 == 3:
                alt = alt.lower()
            if pos % 10 == 5:
                ref = "N"
            vcf_rows.append(tph.HetSite(pos=pos, ref=ref, alt=alt))
        sites.append((ctg, vcf_rows))
    vcf = str(tmp / "calls.vcf")
    with open(vcf, "w") as f:
        f.write(VCF_HEADER)
        for ctg, rows in sites:
            for s in rows:
                f.write(f"{ctg}\t{s.pos + 1}\t.\t{s.ref}\t{s.alt}\t30\tPASS"
                        f"\t.\tGT\t0/1\n")
    return bam, vcf, dict(sites)


def _python_scan(bam_path, ctg, sites, exclude_flags, min_mq):
    positions = np.asarray([s.pos for s in sites], np.int64)
    lookup = {s.pos: i for i, s in enumerate(sites)}
    kept = [r for r in BamReader(bam_path).fetch(ctg)
            if not (r.flag & exclude_flags) and r.mapq >= min_mq]
    return ([r.name.encode() for r in kept],
            [tph.read_alleles(r, positions, lookup, sites) for r in kept])


def _native_scan(bam_path, ctg, sites, exclude_flags, min_mq):
    bam = BamReader(bam_path)
    return native.het_scan(bam_path, bam.chunks(ctg), bam.ref_index[ctg],
                           bam.reference_lengths[ctg], sites, exclude_flags,
                           min_mq)


def _split_chunks(monkeypatch, bam_path):
    """BamReader.chunks cut at the end of a middle record, the first part
    given twice: fetch, and the native walk, must stop at each chunk's
    end (one whole-contig chunk would never show it)."""
    extents = list(BamReader(bam_path, load_index=False)._scan_extents())
    mid = extents[len(extents) // 2][4]
    real = BamReader.chunks

    def chunks(self, contig, start=0, end=None):
        out = []
        for vbeg, vend in real(self, contig, start, end):
            out += [(vbeg, mid), (vbeg, vend)] if vbeg < mid < vend \
                else [(vbeg, vend)]
        return out
    monkeypatch.setattr(BamReader, "chunks", chunks)


@pytest.mark.parametrize("data,ctg,exclude_flags,min_mq", [
    ("hp", "chr1", 2316, 5), ("hp", "chr1", 0, 0), ("hp", "chr1", 16, 40),
    ("hp_split", "chr1", 2316, 5),
    ("edge", "chrA", 2316, 5), ("edge", "chrA", 256, 0), ("edge", "chrB", 2316, 5),
])
def test_scan_matches_read_alleles(lib, monkeypatch, hp_dataset,
                                   edge_dataset, data, ctg, exclude_flags,
                                   min_mq):
    """(a) The scan's names and (site, allele) pairs equal read_alleles
    over BamReader.fetch with the filter applied."""
    if data == "hp_split":
        _split_chunks(monkeypatch, hp_dataset[2])
    if data.startswith("hp"):
        _, _, bam, _, vcf = hp_dataset
        from clair3_rna_torch.io.vcf import VcfReader
        sites = tph.het_snvs_from_vcf(VcfReader(vcf, show_ref=False), ctg)
    else:
        bam, _, by_ctg = edge_dataset
        sites = by_ctg[ctg]
    want = _python_scan(bam, ctg, sites, exclude_flags, min_mq)
    got = _native_scan(bam, ctg, sites, exclude_flags, min_mq)
    assert got == want
    assert sum(map(len, want[1])) > 100  # the scan saw alleles


def _hp_by_contig(bam_path, seed):
    """A phaser's HP for most reads (0, 1 or 2), some names on two
    contigs."""
    rng = random.Random(seed)
    bam = BamReader(bam_path)
    out = {}
    for ctg in bam.references:
        names = {r.name for r in bam.fetch(ctg)}
        out[ctg] = {n: rng.choice((0, 1, 2, 2)) for n in sorted(names)}
    for ctg, h in (("chrA", {"hp_kept": 0, "hp_replaced": 2, "twice": 1,
                             "a_high": 0}),
                   ("chrB", {"twice": 2})):
        if ctg in out:
            out[ctg].update(h)
    return out


def _python_rewrite(bam_path, out_path, hp_by_contig):
    bam = BamReader(bam_path)
    refs = [(n, bam.reference_lengths[n]) for n in bam.references]
    with BamWriter(out_path, refs, header_text=bam.header_text) as writer:
        for ctg in bam.references:
            for rec in bam.fetch(ctg):
                h = hp_by_contig[ctg].get(rec.name, 0)
                if h:
                    rec.tags["HP"] = h
                writer.write(rec)


def _native_rewrite(bam_path, out_path, hp_by_contig, window_blocks):
    bam = BamReader(bam_path)
    refs = [(n, bam.reference_lengths[n]) for n in bam.references]
    writer = native.HaplotagWriter(
        out_path, header_bytes(refs, bam.header_text), window_blocks)
    for ref_id, ctg in enumerate(bam.references):
        writer.rewrite_contig(
            bam_path, bam.chunks(ctg), ref_id, bam.reference_lengths[ctg],
            {n.encode(): h for n, h in hp_by_contig[ctg].items()})
    writer.close()


def _blocks(path):
    """Each BGZF block's ISIZE, in file order."""
    data = open(path, "rb").read()
    sizes, pos = [], 0
    while pos < len(data):
        bsize = struct.unpack_from("<H", data, pos + 16)[0] + 1
        sizes.append(struct.unpack_from("<I", data, pos + bsize - 4)[0])
        pos += bsize
    return sizes


@pytest.mark.parametrize("data,window_blocks", [
    ("edge", 64), ("edge", 1), ("hp", 64), ("hp", 1), ("hp", 3),
    ("hp_split", 3)])
def test_rewrite_bytes_match_bamwriter(lib, tmp_path, monkeypatch,
                                       hp_dataset, edge_dataset,
                                       data, window_blocks):
    """(b), (c) The rewrite's decompressed stream, its blocks and its file
    bytes equal BamWriter's on the same fetch and HP map; windows of 1 and
    3 blocks hold less than the BAM, whose records cross the reader's
    buffer compaction."""
    bam = edge_dataset[0] if data == "edge" else hp_dataset[2]
    if data == "hp_split":
        _split_chunks(monkeypatch, bam)
    hp = _hp_by_contig(bam, 3)
    want, got = str(tmp_path / "python.bam"), str(tmp_path / "native.bam")
    _python_rewrite(bam, want, hp)
    _native_rewrite(bam, got, hp, window_blocks)
    want_raw = bgzf_decompress(open(want, "rb").read())
    assert bgzf_decompress(open(got, "rb").read()) == want_raw
    blocks = _blocks(want)
    assert _blocks(got) == blocks
    assert len(blocks) > window_blocks or window_blocks == 64
    assert open(got, "rb").read() == open(want, "rb").read()
    if data.startswith("hp"):
        assert len(want_raw) > 1 << 20
    if data == "edge":
        names = [r.name for c in CONTIG_LEN for r in BamReader(got).fetch(c)]
        assert "pos0_nospan" not in names and "past_end" not in names
        assert names.count("twice") == 3 and "placed_unmapped" in names
        rec = next(r for r in BamReader(got).fetch("chrA")
                   if r.name == "mate_tags")
        assert list(rec.tags)[:12] == ["XC", "Xc", "Xs", "XS", "XI", "Xi",
                                       "XZ", "X1", "X0", "XA", "Xf", "XH"]
        assert rec.tags["XC"] == 9 and rec.tags["XH"] == "1AE3"


def _phase(bam, vcf, out, contigs=None):
    rec = spans.Chunk()
    tpp.phase_and_haplotag(bam, "unused.fa", vcf, out, contigs=contigs,
                           record=rec)
    totals = tpp.stage_totals(rec)
    return {k: v for k, v in totals.items() if not k.endswith("_s")}


@pytest.mark.parametrize("data", ["hp", "edge", "edge_tail"])
def test_counters_and_bytes_match_python_path(lib, tmp_path, monkeypatch,
                                              hp_dataset, edge_dataset,
                                              data):
    """(d) phase_and_haplotag's counters equal the Python path's, with
    records_native equal to records_written; the fallback
    (CLAIR3_RNA_TORCH_NO_NATIVE) writes the same file and reports
    records_native 0. edge_tail: bytes that are no BGZF block after the
    EOF block, past where every fetch stops, which the native reader reads
    ahead but never needs."""
    if data == "hp":
        bam, vcf, contigs = hp_dataset[2], hp_dataset[4], None
    else:
        bam, vcf, _ = edge_dataset
        contigs = ["chrA", "chrB"]
    if data == "edge_tail":
        tail = str(tmp_path / "tail.bam")
        with open(tail, "wb") as f:
            f.write(open(bam, "rb").read() + b"not a BGZF block at all")
        shutil.copyfile(bam + ".bai", tail + ".bai")
        bam = tail
    got, want = str(tmp_path / "native.bam"), str(tmp_path / "python.bam")
    native_c = _phase(bam, vcf, got, contigs)
    monkeypatch.setenv("CLAIR3_RNA_TORCH_NO_NATIVE", "1")
    python_c = _phase(bam, vcf, want, contigs)
    assert native_c["records_native"] == native_c["records_written"] > 0
    assert python_c.pop("records_native") == 0
    native_c.pop("records_native")
    assert native_c == python_c
    assert python_c["tagged_hp1"] + python_c["tagged_hp2"] > 0
    if data == "hp":
        assert python_c["tagged_hp1"] > 0 and python_c["tagged_hp2"] > 0
    assert open(got, "rb").read() == open(want, "rb").read()
    assert open(got + ".bai", "rb").read() == open(want + ".bai", "rb").read()


@pytest.mark.parametrize("case,error", [
    ("b_array_tag", TypeError), ("no_seq_over_a_site", IndexError)])
def test_unsupported_input_fails_as_python_path(lib, tmp_path, monkeypatch,
                                                case, error):
    """A record the Python path raises on (a B-array tag in the writer, a
    read with no sequence over a het site in read_alleles) raises the same
    with the native library: the native calls leave the stage to it."""
    rng = random.Random(5)
    genome = _genome(rng)
    recs = _filler(rng, genome, 0, "chrA", 20)
    g = genome["chrA"]
    if case == "b_array_tag":
        recs.append(_record("marked", 0, 0, 2500, [(0, 20)], g[2500:2520],
                            _tag("ML", "B", b"C" + struct.pack("<I", 3)
                                 + b"\x01\x02\x03")))
    else:
        recs.append(_record("no_seq", 0, 0, 2500, [(0, 20)], "", qual=b""))
    bam = _write_bam(str(tmp_path / "in.bam"), recs)
    vcf = str(tmp_path / "calls.vcf")
    with open(vcf, "w") as f:
        f.write(VCF_HEADER + f"chrA\t2506\t.\t{g[2505]}\tN\t30\tPASS\t.\t"
                "GT\t0/1\n")
    out = str(tmp_path / "out.bam")
    with pytest.raises(error):
        _phase(bam, vcf, out)
    monkeypatch.setenv("CLAIR3_RNA_TORCH_NO_NATIVE", "1")
    with pytest.raises(error):
        _phase(bam, vcf, out)
