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
SOURCES = ("tilelet.cu",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}


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
    for src, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}\n{err}")
        os.replace(tmp, _lib_path(src))
        report[src] = (time.time() - t0, err)
    return report


def _load(src):
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            if _stale(src):
                build_all()
            lib = ctypes.CDLL(_lib_path(src))
            _libs[src] = lib
    return lib


def _tilelet_fn():
    lib = _load("tilelet.cu")
    fn = lib.tilelet_expand_launch
    p = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, ctypes.c_int, p, p, p, p, p, p,
                   ctypes.c_int, ctypes.c_longlong, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    if t is None:
        return None
    if t.data_ptr() % 4:
        raise ValueError("kernel input must be 4-byte aligned")
    return t.data_ptr()


def launch_tilelet(wire, phased, codes, valid, row_off, rank, strand, hp,
                   n_tiles, width, counts, grank):
    """Enqueue csrc/tilelet.cu on the current stream (inputs checked by
    ops/tilelet._expand). Raises on a refused launch."""
    import torch

    fn = _tilelet_fn()
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = fn(1 if wire == "v2" else 0, 1 if phased else 0, _ptr(codes),
             _ptr(valid), _ptr(row_off), rank.data_ptr(), strand.data_ptr(),
             hp.data_ptr(), int(n_tiles), int(width), counts.data_ptr(),
             grank.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tilelet kernel launch failed: CUDA error {err}")
