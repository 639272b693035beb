"""ctypes bindings for the native BAM decode + event extraction library.

Compiled on first use with g++ (cached in _build/); falls back cleanly to the
pure-Python extractor when no toolchain is available. `NativeBam` mirrors the
subset of BamReader the pileup pipeline needs and `extract_events_native`
returns the same PileupEvents as pileup.events.extract_events.
"""

import ctypes
import logging
import os
import subprocess

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "pileup_native.cc")
_BUILD_DIR = os.path.join(_HERE, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libpileup_native.so")
_lib = None
_load_error = None


class _EventsOut(ctypes.Structure):
    _fields_ = [
        ("n_base", ctypes.c_int64),
        ("base_pos", ctypes.POINTER(ctypes.c_int32)),
        ("base_code", ctypes.POINTER(ctypes.c_int8)),
        ("base_strand", ctypes.POINTER(ctypes.c_int8)),
        ("base_rank", ctypes.POINTER(ctypes.c_int64)),
        ("base_hp", ctypes.POINTER(ctypes.c_int8)),
        ("n_star", ctypes.c_int64),
        ("star_pos", ctypes.POINTER(ctypes.c_int32)),
        ("star_strand", ctypes.POINTER(ctypes.c_int8)),
        ("star_hp", ctypes.POINTER(ctypes.c_int8)),
        ("n_ins", ctypes.c_int64),
        ("ins_pos", ctypes.POINTER(ctypes.c_int32)),
        ("ins_strand", ctypes.POINTER(ctypes.c_int8)),
        ("ins_rank", ctypes.POINTER(ctypes.c_int64)),
        ("ins_hp", ctypes.POINTER(ctypes.c_int8)),
        ("ins_allele", ctypes.POINTER(ctypes.c_int32)),
        ("n_ins_seq", ctypes.c_int64),
        ("ins_seq_blob", ctypes.POINTER(ctypes.c_char)),
        ("ins_seq_blob_len", ctypes.c_int64),
        ("n_del", ctypes.c_int64),
        ("del_pos", ctypes.POINTER(ctypes.c_int32)),
        ("del_strand", ctypes.POINTER(ctypes.c_int8)),
        ("del_rank", ctypes.POINTER(ctypes.c_int64)),
        ("del_hp", ctypes.POINTER(ctypes.c_int8)),
        ("del_len", ctypes.POINTER(ctypes.c_int32)),
        ("read_start_count", ctypes.POINTER(ctypes.c_int32)),
        ("read_end_count", ctypes.POINTER(ctypes.c_int32)),
        ("skip_fwd_count", ctypes.POINTER(ctypes.c_int32)),
        ("skip_rev_count", ctypes.POINTER(ctypes.c_int32)),
        ("cover_count", ctypes.POINTER(ctypes.c_int32)),
    ]


class _PackedOut(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_tiles", ctypes.c_int64),
        ("n_base", ctypes.c_int64),
        ("tl_codes", ctypes.POINTER(ctypes.c_uint8)),
        ("tl_tile", ctypes.POINTER(ctypes.c_int32)),
        ("tl_rank", ctypes.POINTER(ctypes.c_int32)),
        ("tl_strand", ctypes.POINTER(ctypes.c_int8)),
        ("tl_hp", ctypes.POINTER(ctypes.c_int8)),
        ("n_star", ctypes.c_int64),
        ("star_pos", ctypes.POINTER(ctypes.c_int32)),
        ("star_strand", ctypes.POINTER(ctypes.c_int8)),
        ("star_hp", ctypes.POINTER(ctypes.c_int8)),
        ("n_ins", ctypes.c_int64),
        ("ins_pos", ctypes.POINTER(ctypes.c_int32)),
        ("ins_strand", ctypes.POINTER(ctypes.c_int8)),
        ("ins_rank", ctypes.POINTER(ctypes.c_int64)),
        ("ins_hp", ctypes.POINTER(ctypes.c_int8)),
        ("ins_allele", ctypes.POINTER(ctypes.c_int32)),
        ("n_ins_seq", ctypes.c_int64),
        ("ins_seq_blob", ctypes.POINTER(ctypes.c_char)),
        ("ins_seq_blob_len", ctypes.c_int64),
        ("n_del", ctypes.c_int64),
        ("del_pos", ctypes.POINTER(ctypes.c_int32)),
        ("del_strand", ctypes.POINTER(ctypes.c_int8)),
        ("del_rank", ctypes.POINTER(ctypes.c_int64)),
        ("del_hp", ctypes.POINTER(ctypes.c_int8)),
        ("del_len", ctypes.POINTER(ctypes.c_int32)),
        ("read_start_count", ctypes.POINTER(ctypes.c_int32)),
        ("read_end_count", ctypes.POINTER(ctypes.c_int32)),
        ("skip_fwd_count", ctypes.POINTER(ctypes.c_int32)),
        ("skip_rev_count", ctypes.POINTER(ctypes.c_int32)),
        ("cover_count", ctypes.POINTER(ctypes.c_int32)),
    ]


class _FinalizeOut(ctypes.Structure):
    _fields_ = [
        ("depth", ctypes.POINTER(ctypes.c_int32)),
        ("covered", ctypes.POINTER(ctypes.c_uint8)),
        ("ins_total", ctypes.POINTER(ctypes.c_int32)),
        ("del_total", ctypes.POINTER(ctypes.c_int32)),
        ("star_total", ctypes.POINTER(ctypes.c_int32)),
        ("alt_count", ctypes.POINTER(ctypes.c_int32)),
        ("ref_count", ctypes.POINTER(ctypes.c_int32)),
        ("max_skip", ctypes.POINTER(ctypes.c_int32)),
        ("eff_ref_code", ctypes.POINTER(ctypes.c_int8)),
        ("cand_mask", ctypes.POINTER(ctypes.c_uint8)),
    ]


class _TileOut(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int64),
        ("n_channels", ctypes.c_int32),
        ("counts", ctypes.POINTER(ctypes.c_int32)),
        ("group_count", ctypes.POINTER(ctypes.c_int32)),
        ("group_rank", ctypes.POINTER(ctypes.c_int64)),
        ("max_del_length", ctypes.POINTER(ctypes.c_int32)),
        ("read_start_count", ctypes.POINTER(ctypes.c_int32)),
        ("read_end_count", ctypes.POINTER(ctypes.c_int32)),
        ("skip_fwd_count", ctypes.POINTER(ctypes.c_int32)),
        ("skip_rev_count", ctypes.POINTER(ctypes.c_int32)),
        ("cover_count", ctypes.POINTER(ctypes.c_int32)),
        ("n_ins", ctypes.c_int64),
        ("ins_pos", ctypes.POINTER(ctypes.c_int32)),
        ("ins_strand", ctypes.POINTER(ctypes.c_int8)),
        ("ins_rank", ctypes.POINTER(ctypes.c_int64)),
        ("ins_allele", ctypes.POINTER(ctypes.c_int32)),
        ("n_ins_seq", ctypes.c_int64),
        ("ins_seq_blob", ctypes.POINTER(ctypes.c_char)),
        ("ins_seq_blob_len", ctypes.c_int64),
        ("n_del", ctypes.c_int64),
        ("del_pos", ctypes.POINTER(ctypes.c_int32)),
        ("del_strand", ctypes.POINTER(ctypes.c_int8)),
        ("del_rank", ctypes.POINTER(ctypes.c_int64)),
        ("del_len", ctypes.POINTER(ctypes.c_int32)),
    ]


def _build_library():
    # build to a private name and rename into place: concurrent test
    # workers may build at once, and a half-written .so must never load
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-o", tmp, "-lz", "-lpthread"]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB_PATH)


def get_library():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
            _build_library()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.bam_open.restype = ctypes.c_void_p
        lib.bam_open.argtypes = [ctypes.c_char_p]
        lib.bam_close.argtypes = [ctypes.c_void_p]
        lib.bam_n_refs.restype = ctypes.c_int32
        lib.bam_n_refs.argtypes = [ctypes.c_void_p]
        lib.bam_ref_name.restype = ctypes.c_char_p
        lib.bam_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.bam_ref_len.restype = ctypes.c_int64
        lib.bam_ref_len.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.bam_n_records.restype = ctypes.c_int64
        lib.bam_n_records.argtypes = [ctypes.c_void_p]
        lib.bam_is_indexed.restype = ctypes.c_int32
        lib.bam_is_indexed.argtypes = [ctypes.c_void_p]
        lib.bam_bytes_read.restype = ctypes.c_int64
        lib.bam_bytes_read.argtypes = [ctypes.c_void_p]
        lib.bam_build_index.restype = ctypes.c_int32
        lib.bam_build_index.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.extract_events_native.restype = ctypes.POINTER(_EventsOut)
        lib.extract_events_native.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.free_events_native.argtypes = [ctypes.POINTER(_EventsOut)]
        lib.extract_packed_native.restype = ctypes.POINTER(_PackedOut)
        lib.extract_packed_native.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.free_packed_native.argtypes = [ctypes.POINTER(_PackedOut)]
        lib.build_tile_native.restype = ctypes.POINTER(_TileOut)
        lib.build_tile_native.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.free_tile_native.argtypes = [ctypes.POINTER(_TileOut)]
        lib.finalize_tile_native.restype = ctypes.POINTER(_FinalizeOut)
        lib.finalize_tile_native.argtypes = [
            ctypes.POINTER(_TileOut), ctypes.POINTER(ctypes.c_int8),
            ctypes.c_double, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32]
        lib.free_finalize_native.argtypes = [ctypes.POINTER(_FinalizeOut)]
        _lib = lib
    except Exception as exc:  # missing g++/zlib: fall back to Python
        _load_error = exc
        logger.warning("native pileup library unavailable (%s); "
                       "using pure-Python extraction", exc)
    return _lib


def _copy(ptr, n, dtype):
    if n == 0 or not ptr:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


class NativeBam:
    """Native-decoded BAM with region event extraction."""

    def __init__(self, path: str):
        lib = get_library()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_load_error}")
        self._lib = lib
        self._handle = lib.bam_open(path.encode())
        if not self._handle:
            raise IOError(f"failed to open BAM: {path}")
        n = lib.bam_n_refs(self._handle)
        self.references = [lib.bam_ref_name(self._handle, i).decode()
                           for i in range(n)]
        self.reference_lengths = {
            name: lib.bam_ref_len(self._handle, i)
            for i, name in enumerate(self.references)}
        self.ref_index = {name: i for i, name in enumerate(self.references)}
        self.n_records = lib.bam_n_records(self._handle)  # -1 when indexed

    @property
    def has_index(self) -> bool:
        """True in bounded-memory BAI mode (region loads inflate only the
        covering BGZF blocks instead of holding the whole file in RAM)."""
        return bool(self._lib.bam_is_indexed(self._handle))

    def bytes_read(self) -> int:
        """Compressed bytes inflated so far (indexed mode I/O accounting)."""
        return int(self._lib.bam_bytes_read(self._handle))

    def close(self):
        if self._handle:
            self._lib.bam_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def extract_events(self, contig: str, start: int, end: int,
                       min_mq: int = 5, min_bq: int = 0,
                       exclude_flags: int = 2316):
        from clair3_rna_torch.pileup.events import PileupEvents

        out_ptr = self._lib.extract_events_native(
            self._handle, self.ref_index[contig], start, end,
            min_mq, min_bq, exclude_flags)
        out = out_ptr.contents
        width = end - start
        try:
            blob = ctypes.string_at(out.ins_seq_blob, out.ins_seq_blob_len).decode() \
                if out.ins_seq_blob_len else ""
            ins_seqs = blob.split("\x00")[:out.n_ins_seq] if out.n_ins_seq else []
            events = PileupEvents(
                start=start, end=end,
                base_pos=_copy(out.base_pos, out.n_base, np.int32),
                base_code=_copy(out.base_code, out.n_base, np.int8),
                base_strand=_copy(out.base_strand, out.n_base, np.int8),
                base_rank=_copy(out.base_rank, out.n_base, np.int64),
                base_hp=_copy(out.base_hp, out.n_base, np.int8),
                star_pos=_copy(out.star_pos, out.n_star, np.int32),
                star_strand=_copy(out.star_strand, out.n_star, np.int8),
                star_hp=_copy(out.star_hp, out.n_star, np.int8),
                ins_pos=_copy(out.ins_pos, out.n_ins, np.int32),
                ins_strand=_copy(out.ins_strand, out.n_ins, np.int8),
                ins_rank=_copy(out.ins_rank, out.n_ins, np.int64),
                ins_hp=_copy(out.ins_hp, out.n_ins, np.int8),
                ins_allele=_copy(out.ins_allele, out.n_ins, np.int32),
                ins_seqs=ins_seqs,
                del_pos=_copy(out.del_pos, out.n_del, np.int32),
                del_strand=_copy(out.del_strand, out.n_del, np.int8),
                del_rank=_copy(out.del_rank, out.n_del, np.int64),
                del_hp=_copy(out.del_hp, out.n_del, np.int8),
                del_len=_copy(out.del_len, out.n_del, np.int32),
                read_start_count=_copy(out.read_start_count, width, np.int32),
                read_end_count=_copy(out.read_end_count, width, np.int32),
                skip_fwd_count=_copy(out.skip_fwd_count, width, np.int32),
                skip_rev_count=_copy(out.skip_rev_count, width, np.int32),
                cover_count=_copy(out.cover_count, width, np.int32),
            )
        finally:
            self._lib.free_events_native(out_ptr)
        return events


    def extract_packed(self, contig: str, start: int, end: int,
                       min_mq: int = 5, min_bq: int = 0,
                       exclude_flags: int = 2316):
        """Region -> PackedReads (tilelet rows + sparse events): the wire
        format for device-side CIGAR expansion (ops/tilelet.py). Semantics
        match pileup.packed.packed_from_events(extract_events(...)),
        differentially tested in tests/test_tilelet.py."""
        from clair3_rna_torch.pileup.packed import HALF, PackedReads

        out_ptr = self._lib.extract_packed_native(
            self._handle, self.ref_index[contig], start, end,
            min_mq, min_bq, exclude_flags)
        out = out_ptr.contents
        width = end - start
        try:
            blob = ctypes.string_at(out.ins_seq_blob, out.ins_seq_blob_len).decode() \
                if out.ins_seq_blob_len else ""
            ins_seqs = blob.split("\x00")[:out.n_ins_seq] if out.n_ins_seq else []
            n = out.n_rows
            packed = PackedReads(
                start=start, end=end, n_base=int(out.n_base),
                tl_codes=_copy(out.tl_codes, n * HALF, np.uint8)
                .reshape(n, HALF),
                tl_tile=_copy(out.tl_tile, n, np.int32),
                tl_rank=_copy(out.tl_rank, n, np.int32),
                tl_strand=_copy(out.tl_strand, n, np.int8),
                tl_hp=_copy(out.tl_hp, n, np.int8),
                star_pos=_copy(out.star_pos, out.n_star, np.int32),
                star_strand=_copy(out.star_strand, out.n_star, np.int8),
                star_hp=_copy(out.star_hp, out.n_star, np.int8),
                ins_pos=_copy(out.ins_pos, out.n_ins, np.int32),
                ins_strand=_copy(out.ins_strand, out.n_ins, np.int8),
                ins_rank=_copy(out.ins_rank, out.n_ins, np.int64),
                ins_hp=_copy(out.ins_hp, out.n_ins, np.int8),
                ins_allele=_copy(out.ins_allele, out.n_ins, np.int32),
                ins_seqs=ins_seqs,
                del_pos=_copy(out.del_pos, out.n_del, np.int32),
                del_strand=_copy(out.del_strand, out.n_del, np.int8),
                del_rank=_copy(out.del_rank, out.n_del, np.int64),
                del_hp=_copy(out.del_hp, out.n_del, np.int8),
                del_len=_copy(out.del_len, out.n_del, np.int32),
                read_start_count=_copy(out.read_start_count, width, np.int32),
                read_end_count=_copy(out.read_end_count, width, np.int32),
                skip_fwd_count=_copy(out.skip_fwd_count, width, np.int32),
                skip_rev_count=_copy(out.skip_rev_count, width, np.int32),
                cover_count=_copy(out.cover_count, width, np.int32),
            )
        finally:
            self._lib.free_packed_native(out_ptr)
        return packed

    def build_tile(self, contig: str, start: int, end: int, cfg,
                   ref_codes: np.ndarray | None = None):
        """Native dense tile build -> (tile dict, SparseIndels[, fin dict]).

        Produces exactly what pileup.builder.build_tile_features +
        SparseIndels.from_events produce from the Python extractor, but the
        per-base accumulation runs in C++ (tests/test_native_events.py).

        With ref_codes given, the per-position feature derivation, candidate
        mask, and ref-channel negation also run in C++ (finalize_tile_native;
        the Python equivalents are builder.finalize_features /
        candidate_mask_from / negated_counts): the returned third value is a
        dict of those arrays and tile['counts'] is ALREADY negated."""
        from clair3_rna_torch.pileup import builder as pb
        from clair3_rna_torch.pileup.chunk import ref_codes_from  # noqa: cycle-free

        out_ptr = self._lib.build_tile_native(
            self._handle, self.ref_index[contig], start, end,
            cfg.min_mq, cfg.min_bq, cfg.exclude_flags, int(cfg.phased))
        out = out_ptr.contents
        width = end - start
        ch = out.n_channels
        fin = None
        fin_ptr = None
        try:
            if ref_codes is not None:
                codes_arr = np.ascontiguousarray(ref_codes, dtype=np.int8)
                fast = cfg.platform == "ont" and cfg.fast_mode
                fin_ptr = self._lib.finalize_tile_native(
                    out_ptr,
                    codes_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                    float(cfg.effective_snp_af),
                    float(cfg.effective_indel_min_af),
                    int(cfg.min_coverage), int(fast), int(cfg.call_snp_only))
                fo = fin_ptr.contents
                fin = dict(
                    depth=_copy(fo.depth, width, np.int32),
                    covered=_copy(fo.covered, width, np.uint8).astype(bool),
                    ins_total=_copy(fo.ins_total, width, np.int32),
                    del_total=_copy(fo.del_total, width, np.int32),
                    star_total=_copy(fo.star_total, width, np.int32),
                    alt_count=_copy(fo.alt_count, width, np.int32),
                    ref_count=_copy(fo.ref_count, width, np.int32),
                    max_skip=_copy(fo.max_skip, width, np.int32),
                    eff_ref_code=_copy(fo.eff_ref_code, width, np.int8),
                    cand_mask=_copy(fo.cand_mask, width, np.uint8).astype(bool),
                )
            counts = _copy(out.counts, width * ch, np.int32).reshape(width, ch)
            group_count = _copy(out.group_count, width * 6, np.int32).reshape(width, 6)
            group_rank = _copy(out.group_rank, width * 6, np.int64).reshape(width, 6)
            tile = dict(
                counts=counts, group_count=group_count, group_rank=group_rank,
                max_del_length=_copy(out.max_del_length, width, np.int32),
                cover_count=_copy(out.cover_count, width, np.int32),
                read_start_count=_copy(out.read_start_count, width, np.int32),
                read_end_count=_copy(out.read_end_count, width, np.int32),
                skip_fwd_count=_copy(out.skip_fwd_count, width, np.int32),
                skip_rev_count=_copy(out.skip_rev_count, width, np.int32),
            )
            blob = ctypes.string_at(out.ins_seq_blob, out.ins_seq_blob_len).decode() \
                if out.ins_seq_blob_len else ""
            ins_seqs = blob.split("\x00")[:out.n_ins_seq] if out.n_ins_seq else []
            indels = pb.SparseIndels.from_arrays(
                _copy(out.ins_pos, out.n_ins, np.int64),
                _copy(out.ins_rank, out.n_ins, np.int64),
                _copy(out.ins_allele, out.n_ins, np.int32),
                ins_seqs,
                _copy(out.del_pos, out.n_del, np.int64),
                _copy(out.del_rank, out.n_del, np.int64),
                _copy(out.del_len, out.n_del, np.int32),
            )
        finally:
            if fin_ptr is not None:
                self._lib.free_finalize_native(fin_ptr)
            self._lib.free_tile_native(out_ptr)
        if ref_codes is not None:
            return tile, indels, fin
        return tile, indels


def native_available() -> bool:
    return get_library() is not None
