#!/usr/bin/env python3
"""Sweep compile-time variants of the K1 row kernels (the forward, dp and
dq) on the flagship's own tables.

    python3 sweep_k1.py        # from the repository root, one CUDA card

Compiles `stinet_tpu_torch/ops/cuda/ell_edge_conv.cu` once for each pair of
(gathered chunks a lane issues at once, resident blocks an SM the registers
are budgeted for) in LOADS x MIN_BLOCKS (0: no budget), by substituting the
source's own constants (the forward's pair and the gradients' alike), all
`nvcc` processes at once, into `stinet_tpu_torch/_build/sweep/`, and prints
each variant's registers and spills by kernel. Then it records the K1
forward calls of one flagship f32 forward and the K1 forward, dp and dq
calls of one bf16 train step (chip_smoke.py's captures), and runs every
variant under every split of the rows into 1, 2 or 4 groups that `ell_plan`
allows, on one call of each distinct shape: bitwise against the plain
version, and timed by the card alone (chip_smoke.host_device_us: calls
queued behind a sleeping kernel). Prints us a call by kind and shape
(dtype, V, H, D) and, per variant, the sums over a forward and over a step
of each kind under `ell_plan`'s own split and under the fastest split of
each shape, and the split that is fastest over the calls of each kind and
width. Each kind is its own kernel, so the best pair of one kind does not
depend on the others'. Needs a card and nvcc.
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
# the source's (loads, blocks) constants: the forward's, the gradients'
PAIRS = (("kLoadsInFlight", "kMinBlocks"),
         ("kGradLoadsInFlight", "kGradMinBlocks"))
LINE = "constexpr int {} = {};"
BOUNDS = "__launch_bounds__(stinet::kThreads, {})"


def committed(src, name):
    """The value the committed source gives the constant `name`."""
    head = LINE.format(name, "")[:-1]
    start = src.index(head) + len(head)
    return int(src[start:src.index(";", start)])


def variant_source(src, loads, blocks):
    out = src
    for loads_name, blocks_name in PAIRS:
        out = out.replace(LINE.format(loads_name, committed(src, loads_name)),
                          LINE.format(loads_name, loads))
        if blocks:
            out = out.replace(
                LINE.format(blocks_name, committed(src, blocks_name)),
                LINE.format(blocks_name, blocks))
        else:
            out = out.replace(BOUNDS.format(blocks_name),
                              "__launch_bounds__(stinet::kThreads)")
        cs.check(out.count(LINE.format(loads_name, loads)) == 1
                 and (blocks == 0) == (BOUNDS.format(blocks_name) not in out),
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
            elif "_rows" in kernel and ("Used" in line or "spill" in line):
                cs.say("sweep", f"loads {key[0]}, blocks {key[1]}: "
                       f"{kernel}: {line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(str(out_dir / f"ell_L{key[0]}_B{key[1]}.so"))
        for name, types in argtypes.items():
            getattr(lib, name).argtypes = types
            getattr(lib, name).restype = ctypes.c_int
        libs[key] = lib
    return libs


def captured_calls(torch):
    """{(kind, dtype, V, H, D): [tensors, count]}: one call of each distinct
    shape among the K1 forward calls of a flagship f32 forward and the K1
    forward, dp and dq calls of a bf16 train step, with its tensors in the
    C launcher's order (the forward's mean degree, or None for a null
    pointer, after deg), and how often the path makes it."""
    f32, step = cs.capture_k1_calls(torch)
    shapes = collections.OrderedDict()
    for kind, calls in (("sum", list(f32) + list(step["k1"])),
                        ("dp", step["k1dp"]), ("dq", step["k1dq"])):
        for args in calls:
            rows = args[0]
            key = (kind, str(rows.dtype).split(".")[-1], *rows.shape,
                   slots_of(kind, args))
            shapes.setdefault(key, [args, 0])[1] += 1
    return shapes


def slots_of(kind, args):
    """D, the slots a row of the call's index table (nbr, or dq's rev)."""
    return args[3 if kind == "dq" else 2].shape[1]


def plain_of(kind, args):
    from stinet_tpu_torch.ops import ell
    return {"sum": ell.ell_edge_conv_sum_plain,
            "dp": ell.ell_edge_conv_dp_plain,
            "dq": ell.ell_edge_conv_dq_plain}[kind](*args)


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
    for shape, (args, _) in shapes.items():
        kind, rows, d = shape[0], args[0], shape[-1]
        want = plain_of(kind, args)
        view = torch.int16 if rows.dtype == torch.bfloat16 else torch.int32
        v, h = rows.shape
        aligned = all(t.data_ptr() % 16 == 0 for t in args
                      if t is not None and t.dim() == 2
                      and t.dtype == rows.dtype)
        for key, lib in libs.items():
            fn = getattr(lib, ell.launcher_name(kind, rows.dtype))
            per = times[key].setdefault(shape, {})
            for groups in GROUPS:
                try:
                    plan = ell.ell_plan(v, h, rows.dtype, aligned, groups,
                                        kind)
                except ValueError:
                    continue
                out = torch.empty_like(rows)

                def call(fn=fn, plan=plan, out=out):
                    rc = fn(*[0 if t is None else t.data_ptr()
                              for t in args], out.data_ptr(),
                            v, h, d, *ell._plan_args(plan), dev.index,
                            _cuda.stream_of(dev))
                    cs.check(rc == 0, f"{key} {shape}: cudaError {rc}")

                call()
                torch.cuda.synchronize()
                cs.check(torch.equal(out.view(view), want.view(view)),
                         f"variant {key}, {groups} groups, {shape}: not "
                         "the plain version's bits")
                per[groups] = cs.host_device_us(torch, call)[2]
    own = {s: ell.ell_plan(s[2], s[3], getattr(torch, s[1]),
                           kind=s[0]).groups for s in shapes}
    totals = (("f32 forward", "sum", "float32"),
              ("bf16 step", "sum", "bfloat16"),
              ("bf16 step dp", "dp", "bfloat16"),
              ("bf16 step dq", "dq", "bfloat16"))
    cs.say("sweep", "us a call by the card alone, by kind and shape (dtype V "
           "H D) x calls, each split as groups:us; * ell_plan's split")
    for key, per in times.items():
        sums = {}
        for label, pick in (("ell_plan's split", lambda s, t: t[own[s]]),
                            ("fastest split", lambda s, t: min(t.values()))):
            sums[label] = {name: sum(pick(s, t) * shapes[s][1]
                                     for s, t in per.items()
                                     if s[:2] == (kind, dt)) / 1e3
                           for name, kind, dt in totals}
        cs.say("sweep", f"loads {key[0]}, blocks {key[1]}: " + "; ".join(
            f"{label} " + ", ".join(f"{name} {ms:.4f} ms"
                                    for name, ms in v.items())
            for label, v in sums.items()))
        # ell_plan takes one split a width: the fastest, summed over the
        # calls of that kind, dtype and width
        splits = []
        for width in dict.fromkeys(s[:4] for s in per):
            on = [s for s in per if s[:4] == width]
            common = set.intersection(*(set(per[s]) for s in on))
            best = min(common, key=lambda g: sum(per[s][g] * shapes[s][1]
                                                 for s in on))
            splits.append(f"{' '.join(map(str, width))} {best}"
                          f"{'*' if best == own[on[0]] else ''}")
        cs.say("sweep", "  fastest split a width, groups: "
               + ", ".join(splits))
        cs.say("sweep", "  " + "; ".join(
            f"{' '.join(map(str, s))} x{shapes[s][1]} " + " ".join(
                f"{g}{'*' if g == own[s] else ''}:{t:.1f}"
                for g, t in per[s].items()) for s in per))
    cs.say("sweep", f"on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
