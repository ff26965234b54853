"""The native host graph builder, bound with ctypes.

`graph_builder.cpp` is a copy of the JAX package's
(`stinet_tpu/graph/native/graph_builder.cpp`): a bit-for-bit C++ twin of
`graph/build.py`'s numpy `_pad_edge_set` and `_build_children`, plus a
reverse-Cuthill-McKee order, the face-edge extraction and a BFS adjacency
for preprocessing. It is handle-based with no global state, so many
threads may call it at once, and `ctypes.CDLL` (never `PyDLL`) releases
the interpreter lock for the whole of each call.

g++ compiles it at first use into `stinet_tpu_torch/_build/`, under a name
that hashes the source and the flags (an edited source builds anew), to a
private path that is then renamed: concurrent test workers and loader
threads each see a whole library. A failed compile raises RuntimeError
with g++'s output; nothing falls back quietly. `graph/build.py` takes its
numpy path only when asked, with `STINET_NATIVE_BUILD=0` (the JAX
package's switch, with its meaning).

Each entry point adds one to `calls[<C function>]` where it makes its C
call, as a kernel wrapper counts its launches; `reset_calls()` zeroes them.
Nothing here runs at import.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "graph_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lib_lock = threading.Lock()
_calls_lock = threading.Lock()
calls = {}

_i64, _i32 = ctypes.c_int64, ctypes.c_int32
_p_i64 = ctypes.POINTER(ctypes.c_int64)
_p_i32 = ctypes.POINTER(ctypes.c_int32)
_p_f32 = ctypes.POINTER(ctypes.c_float)
_VP = ctypes.c_void_p

# (restype, argtypes) of every C entry point
_SIGNATURES = {
    "edge_set_build": (_VP, [_p_i64, _p_i64, _i64, _i64, _i32, _i32,
                             ctypes.c_double, ctypes.c_double, _i64]),
    "edge_set_sizes": (None, [_VP, _p_i64]),
    "edge_set_fill": (None, [_VP, _i64, _i64, _p_i32, _p_i32, _p_f32,
                             _p_i32, _p_i32, _p_f32, _p_f32, _p_i32,
                             _p_i32]),
    "edge_set_free": (None, [_VP]),
    "build_children": (_i64, [_p_i32, _i64, _i64, _i32, _i64, _p_i32,
                              _p_f32]),
    "rcm_order": (ctypes.c_int, [_p_i64, _p_i64, _i64, _i64, _p_i32]),
    "adj_build": (_VP, [_p_i64, _p_i64, _i64, _i64]),
    "adj_disk_update": (_i64, [_VP, _i64, _i64, _p_f32]),
    "adj_free": (None, [_VP]),
    "edges_from_faces": (_i64, [_p_i64, _i64, _i64, _p_i64, _p_i64]),
}


def available() -> bool:
    """True unless STINET_NATIVE_BUILD=0. It does not probe the compiler:
    a library that cannot be built raises at the first call instead."""
    return os.environ.get("STINET_NATIVE_BUILD", "1") != "0"


def hashed_path(src: Path, build_dir: Path, flags=GXX_FLAGS) -> Path:
    """`<build_dir>/<source stem>-<hash of the source and flags>.so`."""
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(flags).encode()).hexdigest()
    return build_dir / f"{src.stem}-{key[:16]}.so"


def lib_path() -> Path:
    return hashed_path(SRC, BUILD_DIR)


def compile_library(src: Path, out: Path, flags=GXX_FLAGS) -> None:
    """g++ `src` into `out` by way of a private path that is then renamed;
    raises RuntimeError with g++'s output where it fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *flags, str(src), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build {src}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {src} "
                           f"({' '.join(cmd)}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded library, compiled first where no build of this source
    exists. Raises RuntimeError when it cannot be built."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                out = lib_path()
                if not out.exists():
                    compile_library(SRC, out)
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


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _p32(a):
    return None if a is None else _ptr(a, ctypes.c_int32)


def _pf(a):
    return None if a is None else _ptr(a, ctypes.c_float)


def build_edge_set_tables(src: np.ndarray, dst: np.ndarray, e_pad: int,
                          trash: int, v_pad: int, max_deg: int,
                          cap_quantile: float, max_spill_frac: float,
                          window_halo, bucket):
    """The body of `graph/build.py:_pad_edge_set` (sort by destination,
    the ELL tables with their spill, the padding): returns the numpy fields
    that path assembles, by name (`halo` only with ELL tables). `bucket` is
    build.py's `bucket_size`, which pads the spill list."""
    lib = get_lib()
    e = int(src.shape[0])
    # a hard check: edge_set_fill copies e entries into e_pad-long buffers
    if e > e_pad:
        raise ValueError(f"edge bucket too small: {e} > {e_pad}")
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    halo = -1 if window_halo is None else int(window_halo)
    _count("edge_set_build")
    h = lib.edge_set_build(_ptr(src, ctypes.c_int64),
                           _ptr(dst, ctypes.c_int64), e, v_pad, trash,
                           max_deg, cap_quantile, max_spill_frac, halo)
    if not h:
        raise ValueError(f"edge ids out of range [0, {v_pad}) in the native "
                         "edge-set build (corrupted graph data?)")
    try:
        sizes = np.zeros(4, np.int64)
        lib.edge_set_sizes(h, _ptr(sizes, ctypes.c_int64))
        has_ell, d_cap, d_out, n_spill = (int(s) for s in sizes)
        out = dict(src=np.empty(e_pad, np.int32),
                   dst=np.empty(e_pad, np.int32),
                   num_edges=np.int32(e), degree=np.empty(v_pad, np.float32))
        ell = dict(nbr=None, rev_dst=None, out_degree=None, ell_degree=None,
                   spill_src=None, spill_dst=None)
        s_pad = 0
        if has_ell:
            ell.update(nbr=np.empty((v_pad, d_cap), np.int32),
                       rev_dst=np.empty((v_pad, d_out), np.int32),
                       out_degree=np.empty(v_pad, np.float32),
                       ell_degree=np.empty(v_pad, np.float32))
            if n_spill:
                s_pad = bucket(n_spill, 128)
                ell.update(spill_src=np.empty(s_pad, np.int32),
                           spill_dst=np.empty(s_pad, np.int32))
        lib.edge_set_fill(
            h, e_pad, s_pad, _p32(out["src"]), _p32(out["dst"]),
            _pf(out["degree"]), _p32(ell["nbr"]), _p32(ell["rev_dst"]),
            _pf(ell["out_degree"]), _pf(ell["ell_degree"]),
            _p32(ell["spill_src"]), _p32(ell["spill_dst"]))
    finally:
        lib.edge_set_free(h)
    if has_ell:
        out.update(ell, halo=window_halo)
    return out


def build_children_table(trace: np.ndarray, num_valid_fine: int,
                         coarse_pad: int, fine_trash: int,
                         max_children: int = 128):
    """`graph/build.py:_build_children`: (children [Vc, C] int32, counts
    [Vc] f32), or (None, None) when a cluster exceeds max_children."""
    lib = get_lib()
    tr = np.ascontiguousarray(trace[:num_valid_fine], dtype=np.int32)
    children = np.empty((coarse_pad, max(max_children, 1)), np.int32)
    counts = np.empty(coarse_pad, np.float32)
    _count("build_children")
    cmax = int(lib.build_children(
        _ptr(tr, ctypes.c_int32), num_valid_fine, coarse_pad, fine_trash,
        max_children, _ptr(children, ctypes.c_int32),
        _ptr(counts, ctypes.c_float)))
    if cmax < 0:
        raise ValueError(f"trace values out of range [0, {coarse_pad}) in "
                         "the native children build (corrupted trace data?)")
    if cmax == 0 or cmax > max_children:
        return None, None
    # the C buffer's row stride is cmax
    flat = children.reshape(-1)[:coarse_pad * cmax]
    return flat.reshape(coarse_pad, cmax).copy(), counts


def rcm_order(edges: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee on the symmetrized graph: order[new] = old
    (int32). Ties may break otherwise than in scipy's; any band-reducing
    relabelling serves."""
    lib = get_lib()
    src = np.ascontiguousarray(edges[0], dtype=np.int64)
    dst = np.ascontiguousarray(edges[1], dtype=np.int64)
    out = np.empty(n, np.int32)
    _count("rcm_order")
    rc = lib.rcm_order(_ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64),
                       src.shape[0], n, _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise ValueError(f"edge ids out of range [0, {n}) in the native RCM "
                         "(corrupted graph data?)")
    return out


def edges_from_faces(faces: np.ndarray, num_vertices: int) -> np.ndarray:
    """Directed, deduplicated [2, E] int64 edges of a triangle mesh's faces
    in first-occurrence order, self-loops dropped (the JAX package's
    `preprocessing.graph_levels.edges_from_faces`)."""
    lib = get_lib()
    f = np.ascontiguousarray(faces, dtype=np.int64)
    nf = f.shape[0]
    src = np.empty(6 * nf, np.int64)
    dst = np.empty(6 * nf, np.int64)
    _count("edges_from_faces")
    e = int(lib.edges_from_faces(_ptr(f, ctypes.c_int64), nf, num_vertices,
                                 _ptr(src, ctypes.c_int64),
                                 _ptr(dst, ctypes.c_int64)))
    if e < 0:
        raise ValueError(f"face ids out of range [0, {num_vertices}) "
                         "(corrupted mesh?)")
    return np.stack([src[:e], dst[:e]])


class Adjacency:
    """A symmetrized CSR adjacency behind a native handle, for repeated
    bounded-BFS disk updates (mask generation). The handle owns its BFS
    scratch, so one instance serves many disks, on one thread at a time."""

    def __init__(self, edges: np.ndarray, num_vertices: int):
        self._h = None
        self._lib = get_lib()
        src = np.ascontiguousarray(edges[0], dtype=np.int64)
        dst = np.ascontiguousarray(edges[1], dtype=np.int64)
        self.num_vertices = int(num_vertices)
        _count("adj_build")
        self._h = self._lib.adj_build(_ptr(src, ctypes.c_int64),
                                      _ptr(dst, ctypes.c_int64),
                                      src.shape[0], self.num_vertices)
        if not self._h:
            raise ValueError(f"edge ids out of range [0, {num_vertices}) in "
                             "the adjacency (corrupted graph data?)")

    def disk_update(self, seed: int, radius: int, mask: np.ndarray) -> int:
        """mask[v] = max(mask[v], radius - hops(seed, v)) in place; returns
        how many entries went from 0 to positive."""
        # hard checks: the pointer goes to C, which writes num_vertices
        if mask.dtype != np.float32 or not mask.flags.c_contiguous:
            raise ValueError("mask must be C-contiguous float32")
        if mask.shape != (self.num_vertices,):
            raise ValueError(
                f"mask shape {mask.shape} != ({self.num_vertices},)")
        _count("adj_disk_update")
        return int(self._lib.adj_disk_update(self._h, int(seed), int(radius),
                                             _ptr(mask, ctypes.c_float)))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.adj_free(self._h)
            self._h = None
