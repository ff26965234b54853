"""Build, load and call the hand-written CUDA kernels in `ops/cuda/*.cu`.

Each source is compiled by `nvcc` into its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds) and loaded with
ctypes. Libraries land in `stinet_tpu_torch/_build/`, named by a hash of the
source and the flags, so an edited source builds anew and an unchanged one
is reused. Sources build in parallel, one `nvcc` process each.

Nothing here runs at import: the CPU-only test suite imports every module.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

SRC_DIR = Path(__file__).resolve().parent / "cuda"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCES = ("ell_edge_conv", "instance_norm", "windowed_edge_conv")


def use_kernel(t: torch.Tensor, impl) -> bool:
    """Dispatch rule shared by every op with a kernel: a CUDA tensor takes
    the kernel, a CPU tensor the plain version; impl="plain" forces the
    plain version (tests and the smoke script compare the two)."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    return impl is None and t.is_cuda


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _lib_path(name: str) -> Path:
    # the key covers the source, every shared header and the flags
    src = b"".join(f.read_bytes() for f in
                   [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))])
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, all
    `nvcc` processes at once. Returns {name: compiler output} for the
    sources built in this call (ptxas register and spill counts). Raises
    with the compiler's output if a build fails."""
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, out in todo.items():
        # build to a private name, then rename: a concurrent builder never
        # sees a half-written library
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_I64 = ctypes.c_int64

# C signatures of the launchers: every launcher returns a cudaError_t
_SIGNATURES = {
    "ell_edge_conv": {
        # p, q, nbr, deg, mean_deg (or null), out, V, H, D, then the plan
        # (lanes, chunks, groups, blocks, vector), device, stream
        "ell_edge_conv_sum_fwd_f32": [_VP] * 6 + [_I] * 9 + [_VP],
        "ell_edge_conv_sum_fwd_bf16": [_VP] * 6 + [_I] * 9 + [_VP],
        # p, q, nbr, deg, g, out, V, H, D, the plan, device, stream
        "ell_edge_conv_dp_f32": [_VP] * 6 + [_I] * 9 + [_VP],
        "ell_edge_conv_dp_bf16": [_VP] * 6 + [_I] * 9 + [_VP],
        # q, g, p, rev, deg_out, out, V, H, D, the plan, device, stream
        "ell_edge_conv_dq_f32": [_VP] * 6 + [_I] * 9 + [_VP],
        "ell_edge_conv_dq_bf16": [_VP] * 6 + [_I] * 9 + [_VP],
        # x, mean_deg, out, V, H, device, stream
        "ell_mean_rows_f32": [_VP] * 3 + [_I] * 3 + [_VP],
        "ell_mean_rows_bf16": [_VP] * 3 + [_I] * 3 + [_VP],
    },
    "windowed_edge_conv": {
        # p, q, nbr, deg, mean_deg (or null), g (or null), out, V, H, D,
        # then the plan (tile, halo, W, cs, sub, ring, bufs, buf_rows,
        # strip_tiles, strips, smem), mode, device, stream
        "windowed_edge_conv_sum_bf16":
            [_VP] * 7 + [_I] * 16 + [_VP],
        # the same without g and mode
        "windowed_edge_conv_sum_f32":
            [_VP] * 6 + [_I] * 15 + [_VP],
        # q, g, p, rev, deg_out, out, V, H, D, the plan, device, stream
        "windowed_dq_bf16":
            [_VP] * 6 + [_I] * 15 + [_VP],
    },
    "instance_norm": {
        # x, num_valid, out, scratch, scratch floats, tickets, V, C, eps,
        # device, stream
        "masked_instance_norm_f32":
            [_VP, _VP, _VP, _VP, _I64, _VP, _I, _I, _F, _I, _VP],
        # x, num_valid, graph_id, out, scratch, scratch floats, tickets, V,
        # C, G, eps, device, stream
        "masked_instance_norm_multigraph_f32":
            [_VP, _VP, _VP, _VP, _VP, _I64, _VP, _I, _I, _I, _F, _I, _VP],
    },
}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of `ops/cuda/<name>.cu`, built on first use."""
    build([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.stinet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.stinet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_status(lib: ctypes.CDLL, fn: str, rc: int) -> None:
    if rc != 0:
        msg = lib.stinet_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn} failed: cudaError {rc} ({msg})")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 ndim: int, device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of rank `ndim` on
    `device` (a CUDA device)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if not t.is_cuda:
        raise ValueError(f"{name}: the kernel takes a CUDA tensor, got one "
                         f"on {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_of(device: torch.device) -> int:
    """The current stream of `device` as a cudaStream_t. torch's raw lookup
    takes 0.15 us where building a `torch.cuda.Stream` takes 3.9 (H100
    host, `chip_smoke.py` prints both); every kernel call pays it."""
    return torch._C._cuda_getCurrentRawStream(device.index)
