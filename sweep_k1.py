#!/usr/bin/env python3
"""Sweep compile-time variants of the K1 forward kernel on the flagship's
own tables.

    python3 sweep_k1.py        # from the repository root, one CUDA card

Compiles `stinet_tpu_torch/ops/cuda/ell_edge_conv.cu` once for each pair of
(gathered chunks a lane issues at once, resident blocks an SM the registers
are budgeted for) in LOADS x MIN_BLOCKS (0: no budget), by substituting the
source's own constants, all `nvcc` processes at once, into
`stinet_tpu_torch/_build/sweep/`, and prints each variant's registers and
spills. Then it records the K1 forward calls of one flagship f32 forward
and one bf16 train step (chip_smoke.py's captures), and runs every variant
under every split of the rows into 1, 2 or 4 groups that `ell_plan` allows,
on one call of each distinct shape: bitwise against the plain version, and
timed by the card alone (chip_smoke.host_device_us: calls queued behind a
sleeping kernel). Prints us a call by shape (dtype, V, H, D) and, per
variant, the sums over a forward and a step under `ell_plan`'s own split
and under the fastest split of each shape. Needs a card and nvcc.
"""
import collections
import ctypes
import re
import subprocess
import sys

import chip_smoke as cs

LOADS = (4, 8, 16)
MIN_BLOCKS = (0, 3, 4)
GROUPS = (1, 2, 4)
LOADS_LINE = "constexpr int kLoadsInFlight = {};"
BLOCKS_LINE = "constexpr int kMinBlocks = {};"
BOUNDS = "__launch_bounds__(stinet::kThreads, kMinBlocks)"


def committed(src, pattern):
    """The value the committed source gives the constant of `pattern`."""
    head, _ = pattern.split("{}")
    start = src.index(head) + len(head)
    return int(src[start:src.index(";", start)])


def variant_source(src, loads, blocks):
    out = src.replace(LOADS_LINE.format(committed(src, LOADS_LINE)),
                      LOADS_LINE.format(loads))
    if blocks:
        out = out.replace(BLOCKS_LINE.format(committed(src, BLOCKS_LINE)),
                          BLOCKS_LINE.format(blocks))
    else:
        out = out.replace(BOUNDS, "__launch_bounds__(stinet::kThreads)")
    cs.check(out.count(LOADS_LINE.format(loads)) == 1
             and (blocks == 0) == (BOUNDS not in out),
             "the source no longer has the constants this sweep varies")
    return out


def build_variants():
    """{(loads, blocks): loaded library}; prints registers and spills."""
    from stinet_tpu_torch.ops import _cuda
    src = (_cuda.SRC_DIR / "ell_edge_conv.cu").read_text()
    out_dir = _cuda.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for loads in LOADS:
        for blocks in MIN_BLOCKS:
            cu = out_dir / f"ell_L{loads}_B{blocks}.cu"
            cu.write_text(variant_source(src, loads, blocks))
            procs[loads, blocks] = subprocess.Popen(
                [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I",
                 str(_cuda.SRC_DIR), "-o", str(cu.with_suffix(".so")),
                 str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    libs = {}
    argtypes = _cuda._SIGNATURES["ell_edge_conv"]
    for key, proc in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"nvcc failed for {key}:\n{log}")
        kernel = "?"
        for line in log.splitlines():
            entry = re.search(r"entry function '\w*?_cu_\w{8}\d+(\w+?)"
                              r"(?:EE?v|E\d)", line)
            if entry:
                kernel = entry.group(1)
            elif "ell_fwd_rows" in kernel and ("Used" in line
                                               or "spill" in line):
                cs.say("sweep", f"loads {key[0]}, blocks {key[1]}: "
                       f"{kernel}: {line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(str(out_dir / f"ell_L{key[0]}_B{key[1]}.so"))
        for dt in ("f32", "bf16"):
            fn = getattr(lib, f"ell_edge_conv_sum_fwd_{dt}")
            fn.argtypes = argtypes[f"ell_edge_conv_sum_fwd_{dt}"]
            fn.restype = ctypes.c_int
        libs[key] = lib
    return libs


def captured_calls(torch):
    """{(dtype, V, H, D): [(p, q, nbr, deg), count]}: one call of each
    distinct shape among the K1 calls of a flagship f32 forward and a bf16
    train step, and how often the path makes it."""
    f32, bf16 = cs.capture_k1_calls(torch)
    shapes = collections.OrderedDict()
    for p, q, nbr, deg in list(f32) + list(bf16):
        key = (str(p.dtype).split(".")[-1], *p.shape, nbr.shape[1])
        shapes.setdefault(key, [(p, q, nbr, deg), 0])[1] += 1
    return shapes


def main():
    import torch
    if not torch.cuda.is_available():
        print("sweep_k1: CUDA is not available", file=sys.stderr)
        return 1
    from stinet_tpu_torch.ops import _cuda, ell
    card = cs.device_record(torch)
    libs = build_variants()
    shapes = captured_calls(torch)
    dev = torch.device("cuda", torch.cuda.current_device())
    # times[(loads, blocks)][shape] = {groups: us a call}
    times = collections.defaultdict(dict)
    for shape, ((p, q, nbr, deg), _) in shapes.items():
        want = ell.ell_edge_conv_sum_plain(p, q, nbr, deg)
        view = torch.int16 if p.dtype == torch.bfloat16 else torch.int32
        v, h = p.shape
        aligned = all(t.data_ptr() % 16 == 0 for t in (p, q))
        for key, lib in libs.items():
            fn = getattr(lib, f"ell_edge_conv_sum_fwd_{ell._DTYPES[p.dtype]}")
            per = times[key].setdefault(shape, {})
            for groups in GROUPS:
                try:
                    plan = ell.ell_plan(v, h, p.dtype, aligned, groups)
                except ValueError:
                    continue
                out = torch.empty_like(p)

                def call(fn=fn, plan=plan, out=out):
                    rc = fn(p.data_ptr(), q.data_ptr(), nbr.data_ptr(),
                            deg.data_ptr(), out.data_ptr(), v, h,
                            nbr.shape[1], *ell._plan_args(plan), dev.index,
                            _cuda.stream_of(dev))
                    cs.check(rc == 0, f"{key} {shape}: cudaError {rc}")

                call()
                torch.cuda.synchronize()
                cs.check(torch.equal(out.view(view), want.view(view)),
                         f"variant {key}, {groups} groups, {shape}: not "
                         "the plain version's bits")
                per[groups] = cs.host_device_us(torch, call)[2]
    own = {k: ell.ell_plan(k[1], k[2], getattr(torch, k[0])).groups
           for k in shapes}
    cs.say("sweep", "us a call by the card alone, by shape (dtype V H D) x "
           "calls, each split as groups:us; * ell_plan's split")
    for key, per in times.items():
        sums = {}
        for label, pick in (("ell_plan's split", lambda s, t: t[own[s]]),
                            ("fastest split", lambda s, t: min(t.values()))):
            sums[label] = {dt: sum(pick(s, t) * shapes[s][1]
                                   for s, t in per.items() if s[0] == dt)
                           / 1e3 for dt in ("float32", "bfloat16")}
        cs.say("sweep", f"loads {key[0]}, blocks {key[1]}: " + "; ".join(
            f"{label} f32 forward {v['float32']:.4f} ms, bf16 step "
            f"{v['bfloat16']:.4f} ms" for label, v in sums.items()))
        cs.say("sweep", "  " + "; ".join(
            f"{' '.join(map(str, s))} x{shapes[s][1]} " + " ".join(
                f"{g}{'*' if g == own[s] else ''}:{t:.1f}"
                for g, t in per[s].items()) for s in per))
    cs.say("sweep", f"on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
