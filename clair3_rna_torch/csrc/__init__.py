"""Build and bind the port's hand-written CUDA kernels.

Each `*.cu` here compiles with nvcc into its own shared library under
`_build/` (plain C entry points, no PyTorch headers) and is loaded with
ctypes on first use. Pointers come from `Tensor.data_ptr()`, the stream from
`torch.cuda.current_stream().cuda_stream`; each entry point returns
`cudaGetLastError()` and the wrapper raises if it is not 0. Nothing here
runs at import time: this module imports on machines with no CUDA.
"""

import ctypes
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("tilelet.cu", "scatter.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}
# libraries built or loaded in this process (each a one-off cost that a
# chunk's wall carries: ops/fused_pileup.FusedChunkCaller.one_off_count)
_one_offs = 0


def one_off_count():
    return _one_offs


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source with the CUDA toolkit")
    return path


def _lib_path(src):
    return os.path.join(_BUILD_DIR, "lib" + os.path.splitext(src)[0] + ".so")


def _stale(src):
    lib = _lib_path(src)
    return (not os.path.exists(lib) or os.path.getmtime(lib)
            < os.path.getmtime(os.path.join(_HERE, src)))


def build_all(force=False):
    """Compile every stale kernel source, one nvcc per source, all started
    together. Returns {source: (seconds, ptxas report)}."""
    global _one_offs
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.time()
    for src in SOURCES:
        if not force and not _stale(src):
            continue
        # private output name, renamed into place: concurrent builders never
        # load a half-written library
        tmp = f"{_lib_path(src)}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_HERE, src)]
        procs[src] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    report = {}
    _one_offs += len(procs)
    for src, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}\n{err}")
        os.replace(tmp, _lib_path(src))
        report[src] = (time.time() - t0, err)
    return report


def _load(src):
    global _one_offs
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            if _stale(src):
                build_all()
            lib = ctypes.CDLL(_lib_path(src))
            _libs[src] = lib
            _one_offs += 1
    return lib


_fns = {}


def _fn(src, name, argtypes, restype=ctypes.c_int):
    """The ctypes entry point `name` of `src`'s library, bound once (its
    argtypes set on first use) and cached: a wrapper call costs one dict
    lookup, not a lock and a re-bind."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_load(src), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _fns[name] = fn
    return fn


def _ptr(t, align=4):
    if t is None:
        return None
    if t.data_ptr() % align:
        raise ValueError(f"kernel input must be {align}-byte aligned")
    return t.data_ptr()


_P = ctypes.c_void_p
_TILELET_ARGS = [ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P,
                 ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                 ctypes.c_int, _P, _P, _P]


def launch_tilelet(wire, phased, codes, valid, row_off, rank, strand, hp,
                   n_tiles, width, counts, grank, max_rows=None):
    """Enqueue csrc/tilelet.cu (one kernel) on the current stream (inputs
    checked by ops/tilelet.expand; codes, valid, counts and grank 16-byte
    aligned, row_off, rank, strand and hp 4-byte aligned; hp may be None).
    max_rows, the deepest tile's row count where the caller knows it, sets
    the kernel's cluster size (None: the largest). Raises on a refused
    launch."""
    import torch

    fn = _fn("tilelet.cu", "tilelet_expand_launch", _TILELET_ARGS)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = fn(1 if wire == "v2" else 0, 1 if phased else 0, _ptr(codes, 16),
             _ptr(valid, 16), _ptr(row_off), _ptr(rank), _ptr(strand),
             _ptr(hp), int(codes.shape[0]), int(n_tiles), int(width),
             -1 if max_rows is None else int(max_rows), _ptr(counts, 16),
             _ptr(grank, 16), stream)
    if err != 0:
        raise RuntimeError(f"tilelet kernel launch failed: CUDA error {err}")


def _scatter_scratch(k3, n_events, limit, device):
    """csrc/scatter.cu's scratch buffer (the bucketed events and tile
    offsets): uint8, sized by the source's own plan for this launch."""
    import torch

    fn = _fn("scatter.cu", "scatter_scratch_bytes",
             [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong],
             ctypes.c_longlong)
    n = fn(int(k3), int(n_events), int(limit))
    if n < 0:
        raise RuntimeError("scatter kernel: no bucketing plan for "
                           f"{n_events} events over {limit} positions")
    return torch.empty(n, dtype=torch.uint8, device=device)


def launch_fused_scatter(pos, chan, group, rank, width, counts, grank):
    """Enqueue csrc/scatter.cu's K3 operation (bucketing by tile on the
    card, then one cluster per tile) on the current stream, for events in
    any order (inputs checked by ops/fused_scatter.fused_scatter; pos and
    rank 16-byte aligned, chan and group 4-byte aligned). Raises on a
    refused launch."""
    import torch

    p = _P
    fn = _fn("scatter.cu", "fused_scatter_launch",
             [p, p, p, p, ctypes.c_longlong, ctypes.c_longlong, p, p, p,
              ctypes.c_longlong, p])
    scratch = _scatter_scratch(True, pos.shape[0], width, pos.device)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = fn(_ptr(pos, 16), _ptr(chan), _ptr(group), _ptr(rank, 16),
             int(pos.shape[0]), int(width), _ptr(counts, 16),
             _ptr(grank, 16), _ptr(scratch, 16), scratch.numel(), stream)
    if err != 0:
        raise RuntimeError(f"scatter kernel launch failed: CUDA error {err}")


def launch_pileup_counts(pos, chan, length_pad, out):
    """Enqueue csrc/scatter.cu's K4 operation (bucketing by tile on the
    card, then one cluster per tile) on the current stream, for events in
    any order (inputs checked by ops/pileup_kernel.pileup_counts_kernel;
    `out` is int32 [length_pad, 32]; pos 16-byte aligned, chan 4-byte
    aligned). Raises on a refused launch."""
    import torch

    p = _P
    fn = _fn("scatter.cu", "pileup_counts_launch",
             [p, p, ctypes.c_longlong, ctypes.c_longlong, p, p,
              ctypes.c_longlong, p])
    scratch = _scatter_scratch(False, pos.shape[0], length_pad, pos.device)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = fn(_ptr(pos, 16), _ptr(chan), int(pos.shape[0]), int(length_pad),
             _ptr(out), _ptr(scratch, 16), scratch.numel(), stream)
    if err != 0:
        raise RuntimeError(f"count kernel launch failed: CUDA error {err}")
