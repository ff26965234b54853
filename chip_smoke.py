#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printed as it ends; any failure raises and exits nonzero:

1. device record: torch and CUDA versions, the card, its power limit
   (`nvidia-smi`), whether nvcc and triton are present;
2. build: compiles the port's CUDA kernels (stinet_tpu_torch/ops/cuda/*.cu)
   from this checkout, all sources in parallel;
3. kernels: every kernel launch of one flagship forward, replayed on the
   inputs the forward gave it, held against the kernel's plain torch
   version (K1 bit for bit, K2 within K2_RTOL/K2_ATOL) and timed beside it
   (median of REPS CUDA-event timings of INNER back-to-back calls, after
   WARMUP calls), with the least
   time the card could take (bytes over 3.35 TB/s or f32 operations over
   67 TFLOP/s, the larger);
4. the slice: `SceneInpainter.predict` on the flagship scene (V=65536) and
   model (ngf=64, 9 bottleneck blocks, random weights from seed 0) on the
   kernel path, with the kernels' launch counts read around that one call;
   the output checked (shape, finite, tanh range), held against the plain
   path on the card (PATH_TOL) and, on a small scene, against the plain
   path on the CPU; then timed end to end and split into its phases (host
   build, host-to-device copy, forward, copy back).

The last two lines are the kernel record and the result, one JSON object
each. Without a CUDA card the script exits nonzero and prints no result.
"""
import json
import statistics
import subprocess
import sys
import time

SMALL_VERTICES = 4096      # the scene held against the CPU plain path
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
K2_RTOL, K2_ATOL = 1e-5, 1e-5   # reduction order differs from torch's
PATH_TOL = 1e-3             # flagship output, kernel path vs plain path
SMALL_TOL = 1e-4            # small scene, card kernel path vs CPU plain
WARMUP, REPS, INNER = 5, 25, 10
PREDICT_REPS = 10


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def median_ms(torch, fn, reps=REPS, inner=INNER, warmup=WARMUP):
    """Median over `reps` of the device time of `inner` back-to-back calls
    of fn() by CUDA events, divided by `inner` (the events' own overhead
    spreads over the calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes, flops):
    """(ms, "bytes" | "operations"): the least time for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_record(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    from stinet_tpu_torch.ops import _cuda
    try:
        nvcc = subprocess.run([_cuda.nvcc_path(), "--version"],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip().splitlines()[-1]
    except RuntimeError as e:   # reported here; the build phase fails on it
        nvcc = f"absent ({e})"
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    say("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    say("device", f"nvcc: {nvcc}; triton: {triton_version}")
    print(card, flush=True)   # nvidia-smi: name, power limit
    return card


def build_kernels():
    from stinet_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    logs = _cuda.build()
    secs = time.perf_counter() - t0
    for name in _cuda.SOURCES:
        _cuda.library(name)
    say("build", f"{len(logs)} of {len(_cuda.SOURCES)} sources compiled "
        f"in {secs:.2f} s ({', '.join(_cuda.SOURCES)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("build", f"{name}: {line.strip()}")


def capture_kernel_inputs(server, graph):
    """Run one plain forward with hooks that record what each kernel of the
    path would be given: (p, q, nbr, ell_degree) per EdgeConv aggregation,
    (x, level) per instance norm."""
    from stinet_tpu_torch.models.stinet import EdgeConvFilter, GraphNormLayer
    k1, k2, handles = [], [], []

    def on_filter(mod, args):
        x, edges = args[0], args[1]
        p, q = mod.projections(x)
        deg = edges.degree if edges.ell_degree is None else edges.ell_degree
        k1.append((p, q, edges.nbr, deg))

    def on_norm(mod, args):
        if mod.norm_type == "instance":
            k2.append((args[0], args[1]))

    for m in server.model.modules():
        if isinstance(m, EdgeConvFilter):
            handles.append(m.register_forward_pre_hook(on_filter))
        elif isinstance(m, GraphNormLayer):
            handles.append(m.register_forward_pre_hook(on_norm))
    try:
        server.forward(graph)
    finally:
        for h in handles:
            h.remove()
    return k1, k2


def check_k1(torch, calls):
    from stinet_tpu_torch.ops.ell import (
        ell_edge_conv_sum_kernel, ell_edge_conv_sum_plain)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    err, kinds = 0.0, set()
    for i, (p, q, nbr, deg) in enumerate(calls):
        check(nbr is not None, f"K1 call {i}: edge set has no ELL table")
        got = ell_edge_conv_sum_kernel(p, q, nbr, deg)
        want = ell_edge_conv_sum_plain(p, q, nbr, deg)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        check(same, f"K1 call {i} {tuple(nbr.shape)}x{p.shape[1]}: kernel "
              "and plain version differ")
        err = max(err, (got - want).abs().max().item())
        ms = median_ms(torch, lambda: ell_edge_conv_sum_kernel(p, q, nbr, deg))
        plain = median_ms(torch,
                          lambda: ell_edge_conv_sum_plain(p, q, nbr, deg))
        v, h = p.shape
        # what this call's data needs: deg and out for every row, the live
        # slots of nbr, p of each row with an edge, q of each sender once
        live = torch.arange(nbr.shape[1], device=deg.device) < deg[:, None]
        slots = int(live.sum())
        senders = int(torch.unique(nbr[live]).numel())
        receivers = int(torch.count_nonzero(deg))
        nbytes = 4 * (v + v * h + slots + h * (receivers + senders))
        b_ms, b_by = bound(nbytes, 3 * h * slots)
        kinds.add(b_by)
        tot["ms"] += ms
        tot["plain_ms"] += plain
        tot["bound_ms"] += b_ms
        say("K1", f"call {i:2d} V={v} H={h} D={nbr.shape[1]}: bitwise equal; "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), {nbytes / ms / 1e6:.0f} GB/s")
    return dict(tot, max_abs_err=err, library_ms=None,
                bound_by="bytes" if kinds == {"bytes"} else "operations")


def check_k2(torch, calls):
    import torch.nn.functional as F
    from stinet_tpu_torch.ops.norms import (
        masked_instance_norm_kernel, masked_instance_norm_plain)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    err, kinds = 0.0, set()
    for i, (x, level) in enumerate(calls):
        nv = level.num_vertices
        got = masked_instance_norm_kernel(x, nv)
        want = masked_instance_norm_plain(x, level.graph_id, 1, nv)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        err = max(err, e)
        check(torch.allclose(got, want, rtol=K2_RTOL, atol=K2_ATOL),
              f"K2 call {i} {tuple(x.shape)}: max |diff| {e:.3e} exceeds "
              f"rtol {K2_RTOL} / atol {K2_ATOL}")
        n = int(nv)
        check(torch.all(got[n:] == 0).item(), f"K2 call {i}: pad rows not 0")
        ms = median_ms(torch, lambda: masked_instance_norm_kernel(x, nv))
        plain = median_ms(torch, lambda: masked_instance_norm_plain(
            x, level.graph_id, 1, nv))
        xv = x[:n]
        lib = median_ms(torch, lambda: F.batch_norm(
            xv, None, None, training=True, eps=1e-5))
        v, c = x.shape
        # the valid rows of x read once, every row of out written once
        b_ms, b_by = bound(4 * c * (n + v), 7 * n * c)
        kinds.add(b_by)
        for k, val in (("ms", ms), ("plain_ms", plain), ("bound_ms", b_ms),
                       ("library_ms", lib)):
            tot[k] += val
        say("K2", f"call {i:2d} V={v} C={c} valid={n}: max |diff| {e:.3e}; "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, batch_norm "
            f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(tot, max_abs_err=err,
                bound_by="bytes" if kinds == {"bytes"} else "operations")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    card = device_record(torch)
    build_kernels()

    from stinet_tpu_torch.models.factory import FLAGSHIP, define_G
    from stinet_tpu_torch.ops.ell import ell_edge_conv_sum_kernel
    from stinet_tpu_torch.ops.norms import masked_instance_norm_kernel
    from stinet_tpu_torch.serving import SceneInpainter
    from stinet_tpu_torch.utils.synthetic import (
        FLAGSHIP_SCENE, synthetic_scene)

    t0 = time.perf_counter()
    scene = synthetic_scene(**FLAGSHIP_SCENE)
    model = define_G(**FLAGSHIP, generator=torch.Generator().manual_seed(0))
    weights = model.state_dict()
    server = SceneInpainter(model, weights, device="cuda")
    plain_server = SceneInpainter(model, weights, device="cuda",
                                  impl="plain")
    graph = server.place(server.build(scene))
    say("setup", f"scene, model and graph ready in "
        f"{time.perf_counter() - t0:.2f} s; level V_pad "
        f"{[lv.num_padded_vertices for lv in graph.levels]}")

    k1_calls, k2_calls = capture_kernel_inputs(plain_server, graph)
    k1 = check_k1(torch, k1_calls)
    k2 = check_k2(torch, k2_calls)
    say("kernels", f"K1 {len(k1_calls)} calls bitwise equal; K2 "
        f"{len(k2_calls)} calls, max |diff| {k2['max_abs_err']:.3e}")

    # --- the slice: one predict on the kernel path, counted
    ell_edge_conv_sum_kernel.launches = 0
    masked_instance_norm_kernel.launches = 0
    out = server.predict(scene)
    launches = {"ell_edge_conv_sum": ell_edge_conv_sum_kernel.launches,
                "masked_instance_norm": masked_instance_norm_kernel.launches}
    check(launches["ell_edge_conv_sum"] == len(k1_calls) > 0,
          f"K1 launched {launches['ell_edge_conv_sum']} times on the main "
          f"path, expected {len(k1_calls)}")
    check(launches["masked_instance_norm"] == len(k2_calls) > 0,
          f"K2 launched {launches['masked_instance_norm']} times on the "
          f"main path, expected {len(k2_calls)}")
    nv = FLAGSHIP_SCENE["num_vertices"]
    check(out.shape == (nv, 3), f"shape {out.shape}")
    check(bool(torch.isfinite(torch.from_numpy(out)).all()), "non-finite")
    check(float(abs(out).max()) <= 1.0, "output outside the tanh range")
    plain_out = plain_server.predict(scene)
    path_err = float(abs(out - plain_out).max())
    check(path_err <= PATH_TOL, f"kernel path vs plain path: max |diff| "
          f"{path_err:.3e} > {PATH_TOL}")
    say("slice", f"predict {list(out.shape)} finite in [-1, 1]; launches "
        f"{launches}; kernel vs plain path max |diff| {path_err:.3e}")

    small = synthetic_scene(**dict(FLAGSHIP_SCENE,
                                     num_vertices=SMALL_VERTICES))
    cpu_model = define_G(**FLAGSHIP)
    cpu_out = SceneInpainter(cpu_model, weights, device="cpu").predict(small)
    small_err = float(abs(server.predict(small) - cpu_out).max())
    check(small_err <= SMALL_TOL, f"small scene, card vs CPU plain: max "
          f"|diff| {small_err:.3e} > {SMALL_TOL}")
    say("slice", f"small scene V={SMALL_VERTICES}: card kernel path vs CPU "
        f"plain path "
        f"max |diff| {small_err:.3e}")

    # --- timing: end-to-end predict (host build + copy + forward + copy
    # back) by the host clock; then the same steps one by one, each run
    # to its end, so the phases of one request are read in one loop; and
    # the device forward by CUDA events
    for _ in range(2):
        server.predict(scene)
    e2e = []
    for _ in range(PREDICT_REPS):
        t = time.perf_counter()
        server.predict(scene)
        e2e.append((time.perf_counter() - t) * 1e3)
    phases = {"build": [], "place": [], "forward": [], "copy back": []}
    for _ in range(PREDICT_REPS):
        t0 = time.perf_counter()
        host = server.build(scene)
        t1 = time.perf_counter()
        placed = server.place(host)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dev_out = server.forward(placed)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        dev_out[:nv].cpu().numpy()
        t4 = time.perf_counter()
        for k, a, b in (("build", t0, t1), ("place", t1, t2),
                        ("forward", t2, t3), ("copy back", t3, t4)):
            phases[k].append((b - a) * 1e3)
    fwd_ms = median_ms(torch, lambda: server.forward(graph), reps=20,
                       inner=1)
    plain_fwd_ms = median_ms(torch, lambda: plain_server.forward(graph),
                             reps=20, inner=1)
    ms = statistics.median(e2e)
    split = ", ".join(f"{k} {statistics.median(v):.2f}"
                      for k, v in phases.items())
    say("slice", f"predict {ms:.2f} ms/scene = "
        f"{nv / ms * 1e3:.0f} vertices/s end to end; by phase, median ms "
        f"of {PREDICT_REPS}: {split}; device forward {fwd_ms:.3f} ms "
        f"kernel path, {plain_fwd_ms:.3f} ms plain path; on {card}")

    kernels = [
        dict(name="ell_edge_conv_sum", route="cuda",
             source="stinet_tpu_torch/ops/cuda/ell_edge_conv.cu",
             replaces="stinet_tpu/ops/pallas/gather_pipeline.py:102",
             launches=launches["ell_edge_conv_sum"], **k1),
        dict(name="masked_instance_norm", route="cuda",
             source="stinet_tpu_torch/ops/cuda/instance_norm.cu",
             replaces="stinet_tpu/ops/pallas/instance_norm.py:77",
             launches=launches["masked_instance_norm"], **k2),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kd[k] for k in keys}
                                  for kd in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
