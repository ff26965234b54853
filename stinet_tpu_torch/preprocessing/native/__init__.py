"""The native mesh decimator and depth rasterizer, bound with ctypes.

`decimator.cpp` is a copy of the JAX package's: QEM edge collapse, vertex
clustering on a uniform grid, and a z-buffer rasterizer for observer
visibility. g++ compiles it at first use into `stinet_tpu_torch/_build/`,
as `graph/native` builds its library: under a name that hashes the source
and the flags, to a private path that is then renamed, behind a lock, and a
failed compile raises RuntimeError with g++'s output.

The flags are the JAX build's and nothing more: QEM collapses are
floating-point decisions, so `-march=native` or `-ffast-math` would part
this library's decimations from the JAX package's.

Each entry point adds one to `calls[<C function>]` where it makes its C
call; `reset_calls()` zeroes them. Nothing here runs at import.
"""
import ctypes
import threading
from pathlib import Path

import numpy as np

from stinet_tpu_torch.graph.native import compile_library, hashed_path

SRC = Path(__file__).resolve().parent / "decimator.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lib_lock = threading.Lock()
_calls_lock = threading.Lock()
calls = {}

_dp = ctypes.POINTER(ctypes.c_double)
_ip = ctypes.POINTER(ctypes.c_int)
_int, _dbl = ctypes.c_int, ctypes.c_double

# (restype, argtypes) of every C entry point
_SIGNATURES = {
    "qem_decimate": (_int, [_int, _int, _dp, _ip, _int, _dp, _ip, _ip,
                            _ip]),
    "cluster_decimate": (_int, [_int, _int, _dp, _ip, _dbl, _dp, _ip, _ip,
                                _ip]),
    "rasterize_depth": (None, [_int, _int, _dp, _ip, _int, _int, _dp]),
}


def lib_path() -> Path:
    return hashed_path(SRC, BUILD_DIR, GXX_FLAGS)


def get_lib() -> ctypes.CDLL:
    """The loaded library, compiled first where no build of this source
    exists. Raises RuntimeError when it cannot be built."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                out = lib_path()
                if not out.exists():
                    compile_library(SRC, out, GXX_FLAGS)
                lib = ctypes.CDLL(str(out))
                for fn, (res, args) in _SIGNATURES.items():
                    getattr(lib, fn).restype = res
                    getattr(lib, fn).argtypes = args
                _lib = lib
    return _lib


def _count(fn: str) -> None:
    with _calls_lock:
        calls[fn] = calls.get(fn, 0) + 1


def reset_calls() -> None:
    with _calls_lock:
        calls.clear()


def _as_c(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _decimate(fn: str, vertices, faces, param):
    lib = get_lib()
    v = np.ascontiguousarray(vertices, dtype=np.float64)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    nv, nf = len(v), len(f)
    out_v = np.empty((nv, 3), np.float64)
    out_f = np.empty((max(nf, 1), 3), np.int32)
    out_nf = np.zeros(1, np.int32)
    trace = np.empty(nv, np.int32)
    _count(fn)
    out_nv = getattr(lib, fn)(
        nv, nf, _as_c(v, ctypes.c_double), _as_c(f, ctypes.c_int), param,
        _as_c(out_v, ctypes.c_double), _as_c(out_f, ctypes.c_int),
        _as_c(out_nf, ctypes.c_int), _as_c(trace, ctypes.c_int))
    if out_nv < 0:
        raise ValueError(
            f"face ids out of range [0, {nv}) (corrupt mesh data?)")
    return (out_v[:out_nv].copy(), out_f[:int(out_nf[0])].copy(),
            trace.astype(np.int64))


def qem_decimate(vertices: np.ndarray, faces: np.ndarray, target_nv: int):
    """QEM edge-collapse to ~target_nv vertices.
    Returns (out_vertices [M,3], out_faces [F,3], trace [N] -> [0,M))."""
    return _decimate("qem_decimate", vertices, faces, int(target_nv))


def cluster_decimate(vertices: np.ndarray, faces: np.ndarray,
                     cell_size: float):
    """Uniform-grid vertex clustering; same return contract as
    qem_decimate."""
    return _decimate("cluster_decimate", vertices, faces, float(cell_size))


def rasterize_depth(points_px: np.ndarray, faces: np.ndarray,
                    width: int, height: int) -> np.ndarray:
    """Z-buffer of the mesh given projected vertices [N, 3] =
    (pixel_x, pixel_y, camera_depth). Returns [height, width] float64
    (+inf where nothing renders); faces with an id out of range are
    skipped."""
    lib = get_lib()
    p = np.ascontiguousarray(points_px, dtype=np.float64)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    zbuf = np.full(height * width, np.inf, np.float64)
    _count("rasterize_depth")
    lib.rasterize_depth(len(p), len(f), _as_c(p, ctypes.c_double),
                        _as_c(f, ctypes.c_int), int(width), int(height),
                        _as_c(zbuf, ctypes.c_double))
    return zbuf.reshape(height, width)
