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
   67 TFLOP/s, the larger); for K2 also, here and in phases 6 and 9: every
   call run twice gives the same bits, the device launches of one call
   counted in a profiler window (K2_DEVICE_LAUNCHES) with each launch's
   device time there, a distinct shape a call, and a call's time
   split into host (the wall time of ENQUEUES calls enqueued with no
   synchronisation, a call), events (the CUDA-event time of the same
   calls) and device alone (the CUDA-event time of QUEUED calls queued
   behind a sleeping kernel), each distinct shape timed once, the library
   call's split beside it, and the host cost of the wrapper's steps;
4. the serving slice: `SceneInpainter.predict` on the flagship scene
   (V=65536) and model (ngf=64, 9 bottleneck blocks, random weights from
   seed 0) on the kernel path, with the kernels' launch counts read around
   that one call; the output checked (shape, finite, tanh range), held
   against the plain path on the card (PATH_TOL) and, on a small scene,
   against the plain path on the CPU; then timed end to end and split into
   its phases (host build, host-to-device copy, forward, copy back);
5. the windowed build: the flagship scene built with windowed=True (scipy
   RCM), each edge set's V_pad, width, slots and halo, and which convs of a
   forward dispatch the windowed kernels (K3); the band of every K3 table
   checked on the card;
6. the train kernels: one plain-path forward and backward of the bf16
   config's model records the inputs of every K3a (relu, step), K3c, bf16
   K1, K1 dp, K1 dq and K2 call; each kernel is held against its plain
   version on them (bit for bit; K2 within K2_RTOL/K2_ATOL) and timed
   beside it and beside its bound, each K3 call also beside K1's kernel on
   the same banded inputs (K3's bound counts each gathered row once, as
   K1's does; the bytes it stages per tile are printed beside it);
7. the train slice: `make_inpainting_steps` with the bf16 config's model
   (full width and depth), optimizer and loss, STEPS steps on the kernel
   path and STEPS on the plain path from the same weights, on the windowed
   flagship scene; losses finite, each within TRAIN_TOL of the plain
   path's, parameters finite and moved, the launches of one step equal to
   the calls phase 6 recorded (checkpointed blocks run their forward
   twice); one step on a small scene against the CPU plain path
   (SMALL_TRAIN_TOL); then ms/step by CUDA events, split into forward,
   backward and optimizer, and the peak device memory of a step;
8. serving-windowed: the flagship f32 server with windowed=True on phase
   5's build; every K3b call of one plain-path forward held bit for bit
   against its plain version and against f32 K1 on the same inputs, each
   of the three timed, with K3b's bound; the K3b launches of one predict
   equal to the convs the dispatch sends to it (at least 1); the output
   (in the scene's vertex order) within PATH_TOL of phase 4's and of the
   windowed plain path; ms/scene split into phases;
9. serving-batched: `predict_batch` at B = BATCH (flagship scenes of seeds
   0..B-1) stacked and concatenated, each scene within PATH_TOL of its own
   forward; every multi-graph K2 call of the concatenated forward within
   K2_RTOL/K2_ATOL of its plain version, timed beside `F.instance_norm` on
   the [B, C, V/B] view of the valid rows; ms per batch and ms/scene in
   both layouts, and one scene's forward as a view of the stack, copied,
   and placed alone; then `predict_stream` over STREAM scenes, in order
   and each within PATH_TOL of its own forward, with its ms/scene over the
   whole stream and after the first result, and `stream_stats()`.

The last two lines are the kernel record and the result, one JSON object
each. Without a CUDA card the script exits nonzero and prints no result.
"""
import contextlib
import copy
import json
import pathlib
import statistics
import subprocess
import sys
import time

SMALL_VERTICES = 4096      # the scene held against the CPU plain path
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
K2_RTOL, K2_ATOL = 1e-5, 1e-5   # reduction order differs from torch's
K2_DEVICE_LAUNCHES = 2      # statistics, then normalization
ENQUEUES = 300              # calls of the host/device split of a K2 call
QUEUED = 200                # calls queued behind a sleeping kernel
SLEEP_CYCLES = 100_000_000  # that kernel's clock cycles, about 50 ms
PROFILE_PADS = (0.3, 2.0, 6.0)   # idle seconds each side of a profiler window
PATH_TOL = 1e-3             # flagship output, kernel path vs plain path
SMALL_TOL = 1e-4            # small scene, card kernel path vs CPU plain
WARMUP, REPS, INNER = 5, 25, 10
PREDICT_REPS = 10
BF16_CONFIG = ("experiments/3d_inpainting/config/"
               "config_stinet_surfacetextureinpainting_bf16.json")
STEPS = 5                   # train steps per path
STEP_REPS = 10              # timed train steps
TRAIN_TOL = 1e-3            # each step's loss, kernel path vs plain path
SMALL_TRAIN_TOL = 1e-2      # small scene, card kernel path vs CPU plain
MIN_K3_CONVS = 5            # windowed convs per flagship bf16 forward
WINDOWED_REPS = 3           # timed windowed predicts (the RCM build is slow)
BATCH = 4                   # scenes in a predict_batch
BATCH_REPS = 2              # timed predict_batch calls per layout
STREAM = 8                  # scenes in the predict_stream run


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


def device_kernels(torch, fn, expected):
    """(name, device microseconds) of the kernels one call of fn() runs on
    the card, in launch order, from a profiler window around the call
    (copies and memsets left out). The window is padded with idle time on
    both sides: the profiler drops device events that its clocks place
    outside the window, and the host's and the card's clocks drift apart
    over a run. A window that recorded another number of kernels than
    `expected` (some dropped, or all) is taken again with more padding; the
    last window's kernels are returned, whatever their number."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for pad in PROFILE_PADS:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        found = [e for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and not e.name.lower().startswith(("memcpy", "memset"))]
        if len(found) == expected:
            break
        say("profiler", f"a window padded with {pad} s recorded "
            f"{len(found)} of {expected} kernels")
    found.sort(key=lambda e: e.time_range.start)
    return [(e.name.split("<")[0].split("::")[-1], e.time_range.elapsed_us())
            for e in found]


def host_device_us(torch, fn):
    """(host, events, device) microseconds a call of fn(). host: the wall
    time of ENQUEUES calls enqueued with no synchronisation between them;
    events: the CUDA-event time of the same calls, which is what a caller
    in a loop gets, the slower of host and device; device: the CUDA-event
    time of QUEUED calls enqueued while a sleeping kernel holds the stream,
    so that the card runs them back to back with no wait for the host."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(ENQUEUES):
        fn()
    end.record()
    host = (time.perf_counter() - t0) / ENQUEUES * 1e6
    end.synchronize()
    events = start.elapsed_time(end) / ENQUEUES * 1e3
    gate = torch.cuda.Event()
    torch.cuda._sleep(SLEEP_CYCLES)
    gate.record()
    start.record()
    for _ in range(QUEUED):
        fn()
    end.record()
    check(not gate.query(), "the sleeping kernel ended before the host had "
          f"enqueued {QUEUED} calls: no device-only time")
    end.synchronize()
    return host, events, start.elapsed_time(end) / QUEUED * 1e3


def k2_use_record(torch, phase, use, calls, library):
    """One use of K2. `calls`: its kernel calls on the path's inputs, as
    (shape key, function of no argument); `library`: the library call on
    the same rows, one function a call. Every call twice gives the same
    bits; a call's device launches, counted in a profiler window over one
    call of each distinct shape, are K2_DEVICE_LAUNCHES, and each launch's
    device time there is printed; and a call's time split into host and
    device (`host_device_us`), summed over the calls, the library's beside
    it. A call's time follows from its shape, so each distinct shape is
    timed once and counted as often as it occurs."""
    for i, (_, fn) in enumerate(calls):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"K2 {use} call {i}: two runs on the same inputs differ")
    first, count = {}, {}
    for i, (key, _) in enumerate(calls):
        first.setdefault(key, i)
        count[key] = count.get(key, 0) + 1
    launches = device_kernels(
        torch, lambda: [calls[i][1]() for i in first.values()],
        K2_DEVICE_LAUNCHES * len(first))
    check(len(launches) == K2_DEVICE_LAUNCHES * len(first),
          f"K2 {use}: {len(launches)} device launches in {len(first)} calls "
          f"({launches}), expected {K2_DEVICE_LAUNCHES} a call")
    names = [n for n, _ in launches[:K2_DEVICE_LAUNCHES]]
    per_shape = {k: launches[j * K2_DEVICE_LAUNCHES:
                             (j + 1) * K2_DEVICE_LAUNCHES]
                 for j, k in enumerate(first)}
    check(all([n for n, _ in ls] == names for ls in per_shape.values()),
          f"K2 {use}: the calls do not launch the same kernels: {launches}")

    def split_of(fns):
        split = {k: host_device_us(torch, fns[i]) for k, i in first.items()}
        return split, ", ".join(
            f"{name} {sum(split[k][i] * count[k] for k in split):.1f} us"
            for i, name in enumerate(("host", "events", "device alone")))

    split, text = split_of([fn for _, fn in calls])
    say(phase, f"K2 {use}: {len(names)} device launches a call "
        f"({', '.join(names)}); "
        f"{len(calls)} calls run twice, same bits; summed over the calls "
        f"({ENQUEUES} enqueues with no synchronisation, then {QUEUED} "
        f"queued behind a sleeping kernel, once a distinct shape): {text}; "
        f"the library call on the same rows: {split_of(library)[1]}; by "
        "shape (V, C, valid, graphs), host / device alone: " + ", ".join(
            f"{k} x{count[k]} {t[0]:.1f} / {t[2]:.1f} us"
            for k, t in split.items())
        + "; each launch of one call in the profiler window, us: "
        + ", ".join(f"{k} " + " ".join(f"{n} {t:.1f}" for n, t in ls)
                    for k, ls in per_shape.items()))


def k2_wrapper_costs(torch, x, nv):
    """Host microseconds of one K2 wrapper call on `x` and of its steps,
    each timed alone over ENQUEUES repeats: the tensor check, the two
    allocations and the stream lookup; the rest of the call is the ctypes
    call that launches both kernels."""
    from stinet_tpu_torch.ops import _cuda, norms
    dev = x.device
    size = norms.scratch_floats(x.shape[0], x.shape[1], 1)

    def us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ENQUEUES):
            fn()
        t = (time.perf_counter() - t0) / ENQUEUES * 1e6
        torch.cuda.synchronize()
        return t

    costs = {
        "check_tensor": us(lambda: _cuda.check_tensor(
            "x", x, torch.float32, 2, dev)),
        "scratch and out (torch.empty)": us(lambda: (
            torch.empty(size, dtype=torch.float32, device=dev),
            torch.empty_like(x))),
        "stream lookup": us(lambda: _cuda.stream_of(dev)),
        "whole call": us(lambda: norms.masked_instance_norm_kernel(x, nv)),
    }
    costs["the rest (the ctypes call with both launches)"] = (
        2 * costs["whole call"] - sum(costs.values()))
    costs["a stream lookup through torch.cuda.current_stream, for "
          "comparison"] = us(
              lambda: torch.cuda.current_stream(dev).cuda_stream)
    say("K2", f"host cost of the wrapper's steps on {tuple(x.shape)}, us a "
        "call: " + ", ".join(f"{k} {v:.2f}" for k, v in costs.items()))


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
    k2_use_record(
        torch, "K2", "single graph, flagship forward",
        [((*x.shape, int(lv.num_vertices), 1),
          lambda x=x, lv=lv: masked_instance_norm_kernel(x, lv.num_vertices))
         for x, lv in calls],
        [lambda xv=x[:int(lv.num_vertices)]: F.batch_norm(
            xv, None, None, training=True, eps=1e-5) for x, lv in calls])
    small = min(calls, key=lambda c: c[0].numel())
    k2_wrapper_costs(torch, small[0], small[1].num_vertices)
    return dict(tot, max_abs_err=err,
                bound_by="bytes" if kinds == {"bytes"} else "operations")


def time_predict(torch, server, scene, reps):
    """`server.predict(scene)` end to end by the host clock (host build,
    copy, forward, copy back; median of `reps` after 2 warm calls), then
    the same steps one by one, each run to its end, so the phases of one
    request are read in one loop. Returns (ms, "phase ms, ...")."""
    nv = scene.num_vertices[0]
    for _ in range(2):
        server.predict(scene)
    e2e = []
    for _ in range(reps):
        t = time.perf_counter()
        server.predict(scene)
        e2e.append((time.perf_counter() - t) * 1e3)
    phases = {"build": [], "place": [], "forward": [], "copy back": []}
    for _ in range(reps):
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
    return statistics.median(e2e), ", ".join(
        f"{k} {statistics.median(v):.2f}" for k, v in phases.items())


# --- the bf16 windowed train path -----------------------------------------

def conv_uses(model):
    """(level, dilation or None, H) of every EdgeConv of one forward, in the
    model's order: H = 2 * out_features is the width of its P and Q."""
    L = model.n_levels
    uses = [(0, None, 2 * b.first_filter.out_features)
            for b in model.input_blocks]
    uses += [(i + 1, None, 2 * b.first_filter.out_features)
             for i, b in enumerate(model.encoder_blocks)]
    uses += [(L, d if d > 1 else None, 2 * b.first_filter.out_features)
             for d, b in zip(model.dilations, model.bottleneck_blocks)]
    uses += [(L - i - 1, None, 2 * b.first_filter.out_features)
             for i, b in enumerate(model.decoder_blocks)]
    uses += [(0, None, 2 * b.first_filter.out_features)
             for b in model.output_blocks]
    return uses


def windowed_convs(torch, phase, model, host, dtype):
    """How many convs of one forward of `model` on the host graph `host`
    the dispatch sends to the windowed kernels, for rows of `dtype`; each
    conv's edge set and route printed."""
    from stinet_tpu_torch.ops.message_passing import windowed_kernel_applies
    k3 = 0
    for level, dist, h in conv_uses(model):
        lv = host.levels[level]
        e = lv.edges if dist is None else lv.dilated[dist]
        v = lv.num_padded_vertices
        meta = torch.empty(v, h, dtype=dtype, device="meta")
        uses_k3 = e.nbr is not None and windowed_kernel_applies(meta, e.halo)
        k3 += uses_k3
        say(phase, f"level {level} {'dil ' + str(dist) if dist else 'base'}"
            f": V_pad={v} H={h} D={None if e.nbr is None else e.nbr.shape[1]}"
            f" halo={e.halo} -> {'K3 (windowed)' if uses_k3 else 'K1 (ELL)'}")
    return k3


def windowed_build(torch, scene, model):
    """Phase 5: the windowed flagship graph, placed on the card, with the
    K3 dispatch of each conv printed; returns the host and the placed
    graph."""
    from stinet_tpu_torch.graph.build import build_hierarchical_graph
    from stinet_tpu_torch.ops.windowed import band_violations, default_tile
    from stinet_tpu_torch.serving import PackedPlacer
    t0 = time.perf_counter()
    host = build_hierarchical_graph([scene], geometric=True, windowed=True)
    secs = time.perf_counter() - t0
    k3 = windowed_convs(torch, "windowed", model, host, torch.bfloat16)
    check(k3 >= MIN_K3_CONVS, f"{k3} convs per forward take the windowed "
          f"kernels, expected at least {MIN_K3_CONVS}")
    graph = PackedPlacer(next(model.parameters()).device)(host)
    for lv in graph.levels:
        for e in (lv.edges, *lv.dilated.values()):
            if e.halo is None or e.nbr is None:
                continue
            tile = default_tile(e.nbr.shape[0])
            bad = (band_violations(e.nbr, e.ell_degree, e.halo, tile)
                   + band_violations(e.rev_dst, e.out_degree, e.halo, tile))
            check(bad == 0, f"{bad} live slots outside their tile's window "
                  f"(V={e.nbr.shape[0]}, halo={e.halo})")
    say("windowed", f"host build {secs * 1e3:.1f} ms (scipy RCM); "
        f"{k3} of {len(conv_uses(model))} convs per forward on K3; every K3 "
        "table within its band")
    return host, graph


@contextlib.contextmanager
def record_calls(targets):
    """Swap each module function named in `targets` ({key: (module,
    name)}) for a wrapper that records its arguments; yields {key: [args,
    ...]}."""
    calls = {k: [] for k in targets}
    saved = []
    for key, (mod, name) in targets.items():
        fn = getattr(mod, name)

        def wrapper(*args, _fn=fn, _key=key):
            calls[_key].append(args)
            return _fn(*args)

        saved.append((mod, name, fn))
        setattr(mod, name, wrapper)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def capture_train_calls(torch, model, graph, cfg):
    """Phase 6, first half: one plain-path train step of a copy of `model`
    with the plain functions of every kernel on the path recorded."""
    from stinet_tpu_torch.ops import ell, norms, windowed
    from stinet_tpu_torch.trainers import graph_common as gc
    model = copy.deepcopy(model)
    opt, lr = gc.build_optimizer(model.parameters(), cfg["optimizer"])
    step, _ = gc.make_inpainting_steps(
        model, opt, cfg["trainer"]["use_mask_weighted_loss"], impl="plain")
    targets = {"k3a": (windowed, "windowed_edge_conv_sum"),
               "k3c": (windowed, "windowed_dq"),
               "k1": (ell, "ell_edge_conv_sum_plain"),
               "k1dp": (ell, "ell_edge_conv_dp_plain"),
               "k1dq": (ell, "ell_edge_conv_dq_plain"),
               "k2": (norms, "masked_instance_norm_plain")}
    with record_calls(targets) as calls:
        step(graph, lr)
        torch.cuda.synchronize()
    return calls


def _live(idx, count):
    """[V, D] bool: the live slots (slot < count) of an index table."""
    import torch
    cols = torch.arange(idx.shape[1], device=idx.device)
    return cols[None, :] < count[:, None]


def _slot_bytes(idx, count, es, h, reads_local):
    """Bytes an ELL slot loop's data needs: count and out of every row, the
    live slots of idx, `reads_local` local rows of each row with a slot,
    and each gathered row once."""
    import torch
    live = _live(idx, count)
    slots = int(live.sum())
    gathered = int(torch.unique(idx[live]).numel())
    rows = int(torch.count_nonzero(count))
    v = idx.shape[0]
    return (4 * v + es * v * h + 4 * slots
            + es * h * (reads_local * rows + gathered)), slots


def _dq_bytes(rev, dout, es, h):
    """Bytes the sender-side gradient's data needs: as `_slot_bytes` with q
    of each sender with a slot, and g and p of each referenced receiver
    (two gathered rows) once."""
    import torch
    nbytes, slots = _slot_bytes(rev, dout, es, h, 1)
    receivers = int(torch.unique(rev[_live(rev, dout)]).numel())
    return nbytes + es * h * receivers, slots


def _staged_bytes(v, h, es, halo, tile, windows):
    """Bytes a windowed kernel stages into shared memory: every tile's
    window rows, `windows` arrays of them. Printed beside the bound, which
    counts each gathered row once."""
    from stinet_tpu_torch.ops.windowed import window_geometry
    _, w = window_geometry(v, tile, halo)
    return (v // tile) * w * h * es * windows


def check_train_kernels(torch, calls):
    """Phase 6, second half: every recorded call on the kernel and on the
    plain version (bitwise; K2 within K2_RTOL/K2_ATOL), timed, with its
    bound; each K3 call also timed with K1's kernel on the same banded
    inputs, each K2 call with `F.batch_norm`."""
    import torch.nn.functional as F
    from stinet_tpu_torch.ops import ell, norms, windowed
    rows = {}

    def run(key, label, kernel, plain, nbytes, flops, ab=None, tol=None,
            lib=None):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{label}: kernel gives {got.dtype} {tuple(got.shape)}, plain "
              f"version {want.dtype} {tuple(want.shape)}")
        if tol is None:
            view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
            check(torch.equal(got.view(view), want.view(view)),
                  f"{label}: kernel and plain version differ")
            err, verdict = 0.0, "bitwise equal"
        else:
            err = (got - want).abs().max().item()
            check(torch.allclose(got, want, rtol=tol[0], atol=tol[1]),
                  f"{label}: max |diff| {err:.3e} exceeds rtol {tol[0]} / "
                  f"atol {tol[1]}")
            verdict = f"max |diff| {err:.3e}"
        ms = median_ms(torch, kernel)
        plain_ms = median_ms(torch, plain)
        b_ms, b_by = bound(nbytes, flops)
        r = rows.setdefault(key, dict(
            ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
            library_ms=None if lib is None else 0.0, kinds=set(), calls=0,
            ab_ms=0.0))
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += b_ms
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["kinds"].add(b_by)
        r["calls"] += 1
        extra = ""
        if ab is not None:
            ab_ms = median_ms(torch, ab)
            r["ab_ms"] += ab_ms
            extra = f"; K1 on the same inputs {ab_ms:.4f} ms"
        if lib is not None:
            lib_ms = median_ms(torch, lib)
            r["library_ms"] += lib_ms
            extra = f"; batch_norm {lib_ms:.4f} ms"
        say("train-kernels", f"{label}: {verdict}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}){extra}")

    for i, (p, q, nbr, deg, halo, tile, mode, _) in enumerate(calls["k3a"]):
        v, h = p.shape
        nbytes, slots = _slot_bytes(nbr, deg, 2, h, 1)
        staged = _staged_bytes(v, h, 2, halo, tile, 1)
        ones = torch.ones_like(p)
        run("k3a", f"K3a {mode} {i:2d} V={v} H={h} D={nbr.shape[1]} "
            f"halo={halo} tile={tile} staged {staged / 1e6:.1f} MB",
            lambda: windowed.windowed_edge_conv_sum_kernel(
                p, q, nbr, deg, halo, tile, mode),
            lambda: windowed.windowed_edge_conv_sum_plain(p, q, nbr, deg,
                                                          mode),
            nbytes, 4 * h * slots,
            ab=(lambda: ell.ell_edge_conv_sum_kernel(p, q, nbr, deg))
            if mode == "relu" else
            (lambda: ell.ell_edge_conv_dp_kernel(p, q, nbr, deg, ones)))
    for i, (q, g, p, rev, dout, halo, tile, _) in enumerate(calls["k3c"]):
        v, h = q.shape
        nbytes, slots = _dq_bytes(rev, dout, 2, h)
        staged = _staged_bytes(v, h, 2, halo, tile, 2)
        run("k3c", f"K3c {i:2d} V={v} H={h} D={rev.shape[1]} halo={halo} "
            f"tile={tile} staged {staged / 1e6:.1f} MB",
            lambda: windowed.windowed_dq_kernel(q, g, p, rev, dout, halo,
                                                tile),
            lambda: ell.ell_edge_conv_dq_plain(q, g, p, rev, dout),
            nbytes, 4 * h * slots,
            ab=lambda: ell.ell_edge_conv_dq_kernel(q, g, p, rev, dout))
    for i, (p, q, nbr, deg) in enumerate(calls["k1"]):
        v, h = p.shape
        nbytes, slots = _slot_bytes(nbr, deg, p.element_size(), h, 1)
        run("k1", f"K1 {p.dtype} {i:2d} V={v} H={h} D={nbr.shape[1]}",
            lambda: ell.ell_edge_conv_sum_kernel(p, q, nbr, deg),
            lambda: ell.ell_edge_conv_sum_plain(p, q, nbr, deg),
            nbytes, 4 * h * slots)
    for i, (p, q, nbr, deg, g) in enumerate(calls["k1dp"]):
        v, h = p.shape
        nbytes, slots = _slot_bytes(nbr, deg, p.element_size(), h, 2)
        run("k1dp", f"K1 dp {i:2d} V={v} H={h} D={nbr.shape[1]}",
            lambda: ell.ell_edge_conv_dp_kernel(p, q, nbr, deg, g),
            lambda: ell.ell_edge_conv_dp_plain(p, q, nbr, deg, g),
            nbytes, 4 * h * slots)
    for i, (q, g, p, rev, dout) in enumerate(calls["k1dq"]):
        v, h = q.shape
        nbytes, slots = _dq_bytes(rev, dout, q.element_size(), h)
        run("k1dq", f"K1 dq {i:2d} V={v} H={h} D={rev.shape[1]}",
            lambda: ell.ell_edge_conv_dq_kernel(q, g, p, rev, dout),
            lambda: ell.ell_edge_conv_dq_plain(q, g, p, rev, dout),
            nbytes, 4 * h * slots)
    for i, (x, _, _, nv, eps) in enumerate(calls["k2"]):
        v, c = x.shape
        n = int(nv)
        # the valid rows of x read once, every row of out written once
        run("k2", f"K2 {i:2d} V={v} C={c} valid={n}",
            lambda: norms.masked_instance_norm_kernel(x, nv, eps),
            lambda: norms.masked_instance_norm_plain(x, None, 1, nv, eps),
            4 * c * (n + v), 7 * n * c, tol=(K2_RTOL, K2_ATOL),
            lib=lambda: F.batch_norm(x[:n], None, None, training=True,
                                     eps=eps))
    k2_use_record(
        torch, "train-kernels", "bf16 train step",
        [((*x.shape, int(nv), 1),
          lambda x=x, nv=nv, eps=eps: norms.masked_instance_norm_kernel(
              x, nv, eps)) for x, _, _, nv, eps in calls["k2"]],
        [lambda xv=x[:int(nv)], eps=eps: F.batch_norm(
            xv, None, None, training=True, eps=eps)
         for x, _, _, nv, eps in calls["k2"]])
    for r in rows.values():
        r["bound_by"] = ("bytes" if r.pop("kinds") == {"bytes"}
                         else "operations")
    return rows


def train_slice(torch, card, model, graph, cfg, captured):
    """Phase 7: the bf16 train steps on the kernel and the plain path, the
    launch counts of one step, the small-scene check against the CPU, and
    the timings. Returns the launch counts of the kernel path's STEPS
    steps."""
    from stinet_tpu_torch.graph.build import build_hierarchical_graph
    from stinet_tpu_torch.ops import ell, norms, windowed
    from stinet_tpu_torch.serving import PackedPlacer
    from stinet_tpu_torch.trainers import graph_common as gc
    from stinet_tpu_torch.utils.synthetic import (
        FLAGSHIP_SCENE, synthetic_scene)
    counters = {"k3a": windowed.windowed_edge_conv_sum_kernel,
                "k3c": windowed.windowed_dq_kernel,
                "k1": ell.ell_edge_conv_sum_kernel,
                "k1dp": ell.ell_edge_conv_dp_kernel,
                "k1dq": ell.ell_edge_conv_dq_kernel,
                "k2": norms.masked_instance_norm_kernel}
    weighted = cfg["trainer"]["use_mask_weighted_loss"]
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def stepper(dev, impl=None):
        m = copy.deepcopy(model).to(dev)
        m.load_state_dict(start)
        opt, base_lr = gc.build_optimizer(m.parameters(), cfg["optimizer"])
        lr = gc.step_lr(base_lr, cfg["lr_scheduler"])(1)
        step, _ = gc.make_inpainting_steps(m, opt, weighted, impl=impl)
        return m, opt, lr, step

    dev = next(model.parameters()).device
    kmodel, kopt, lr, kstep = stepper(dev)
    for fn in counters.values():
        fn.launches = 0
    losses = [float(kstep(graph, lr)["loss"])]
    one_step = {k: fn.launches for k, fn in counters.items()}
    want = {k: len(v) for k, v in captured.items()}
    check(one_step == want, f"launches in one step {one_step} differ from "
          f"the calls recorded on the plain path {want}")
    losses += [float(kstep(graph, lr)["loss"]) for _ in range(STEPS - 1)]
    launches = {k: fn.launches for k, fn in counters.items()}
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the train path never launched: {launches}")
    _, _, _, pstep = stepper(dev, impl="plain")
    plain = [float(pstep(graph, lr)["loss"]) for _ in range(STEPS)]
    check(all(map(lambda x: x == x and abs(x) < float("inf"),
                  losses + plain)), f"non-finite loss: {losses} / {plain}")
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    rel = max(rels)
    check(rel <= TRAIN_TOL, f"losses {losses} vs plain path {plain}: "
          f"relative {rel:.3e} > {TRAIN_TOL}")
    moved = 0
    for k, v in kmodel.state_dict().items():
        check(bool(torch.isfinite(v).all()), f"parameter {k} not finite")
        moved += not torch.equal(v, start[k])
    check(moved == len(start), f"only {moved} of {len(start)} parameter "
          "tensors moved")
    say("train", f"{STEPS} steps, kernel path losses "
        f"{[round(x, 6) for x in losses]}; plain path "
        f"{[round(x, 6) for x in plain]}; relative "
        f"{', '.join(f'{x:.2e}' for x in rels)}; "
        f"launches per step {one_step}")

    small = build_hierarchical_graph(
        [synthetic_scene(**dict(FLAGSHIP_SCENE,
                                num_vertices=SMALL_VERTICES))],
        geometric=True, windowed=True)
    _, _, _, card_step = stepper(dev)
    card_loss = float(card_step(PackedPlacer(dev)(small), lr)["loss"])
    _, _, _, cpu_step = stepper(torch.device("cpu"))
    cpu_loss = float(cpu_step(small, lr)["loss"])
    rel_small = abs(card_loss - cpu_loss) / abs(cpu_loss)
    check(rel_small <= SMALL_TRAIN_TOL, f"small scene, card {card_loss} vs "
          f"CPU {cpu_loss}: relative {rel_small:.3e} > {SMALL_TRAIN_TOL}")
    say("train", f"small scene V={SMALL_VERTICES}: card kernel path loss "
        f"{card_loss:.6f}, CPU plain path {cpu_loss:.6f}, relative "
        f"{rel_small:.3e}")

    # timings: the step as a whole, then the same step split by events
    def timed(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    step_ms = statistics.median(
        [timed(lambda: kstep(graph, lr)) for _ in range(STEP_REPS)])
    plain_ms = statistics.median(
        [timed(lambda: pstep(graph, lr)) for _ in range(3)])
    split = {"forward": [], "backward": [], "optimizer": []}
    vmask = gc.vertex_mask(graph)
    from stinet_tpu_torch.serving import full_f32_matmuls
    for _ in range(STEP_REPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with full_f32_matmuls():
            ev[0].record()
            kopt.zero_grad(set_to_none=True)
            loss, _ = gc.inpainting_loss(kmodel(graph), graph.color,
                                         graph.mask, vmask, weighted)
            ev[1].record()
            loss.backward()
            ev[2].record()
            kopt.step()
            ev[3].record()
        ev[3].synchronize()
        for k, a, b in (("forward", 0, 1), ("backward", 1, 2),
                        ("optimizer", 2, 3)):
            split[k].append(ev[a].elapsed_time(ev[b]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kstep(graph, lr)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    nv = FLAGSHIP_SCENE["num_vertices"]
    say("train", f"train step {step_ms:.2f} ms/step = {nv / step_ms * 1e3:.0f}"
        f" vertices/s (median of {STEP_REPS}, CUDA events); plain path "
        f"{plain_ms:.2f} ms/step; split, median ms: " + ", ".join(
            f"{k} {statistics.median(v):.2f}" for k, v in split.items())
        + f"; peak memory {peak:.2f} GiB; on {card}")
    return launches


# --- windowed f32 and batched serving ----------------------------------------

def _counters():
    """Launch counters of the kernels on the f32 serving paths: (wrapper,
    its counter attribute); the K2 wrapper counts its one-graph and its
    multi-graph launches apart."""
    from stinet_tpu_torch.ops import ell, norms, windowed
    k2 = norms.masked_instance_norm_kernel
    return {"k3b": (windowed.windowed_edge_conv_sum_f32_kernel, "launches"),
            "k1": (ell.ell_edge_conv_sum_kernel, "launches"),
            "k2": (k2, "launches"),
            "k2mg": (k2, "multigraph_launches")}


def _zero(counters):
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def _read(counters):
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def serving_windowed(torch, card, scene, whost, weights, ref_out):
    """Phase 8: the flagship f32 server with windowed=True. Every K3b call
    of one plain-path forward is recorded and held bitwise against its
    plain version and against f32 K1 on the same inputs, each timed; one
    predict on the kernel path, counted; its output against the
    non-windowed kernel path's (`ref_out`) and against the
    windowed plain path; then ms/scene by phase. Returns (server, K3b row,
    launches of the predict)."""
    from stinet_tpu_torch.graph.build import windowed_layout
    from stinet_tpu_torch.models.factory import FLAGSHIP, define_G
    from stinet_tpu_torch.ops import ell, windowed
    from stinet_tpu_torch.serving import SceneInpainter, _scene_order
    model = define_G(**FLAGSHIP)
    server = SceneInpainter(model, weights, windowed=True, device="cuda")
    plain = SceneInpainter(model, weights, windowed=True, device="cuda",
                           impl="plain")
    host = server._normalize_widths(whost)    # phase 5's windowed build
    graph = server.place(host)
    dispatched = windowed_convs(torch, "serving-windowed", model, host,
                                torch.float32)
    with record_calls({"k3b": (windowed, "windowed_edge_conv_sum_f32")}) \
            as calls:
        plain_dev = plain.forward(graph)
    calls = calls["k3b"]
    check(len(calls) == dispatched >= 1, f"{len(calls)} K3b calls recorded "
          f"in one forward, the dispatch sends {dispatched} convs")
    row = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, k1_ms=0.0,
               max_abs_err=0.0, library_ms=None, kinds=set())
    for i, (p, q, nbr, deg, halo, tile, _) in enumerate(calls):
        v, h = p.shape
        got = windowed.windowed_edge_conv_sum_f32_kernel(p, q, nbr, deg,
                                                         halo, tile)
        want = windowed.windowed_edge_conv_sum_f32(p, q, nbr, deg, halo,
                                                   tile, impl="plain")
        k1 = ell.ell_edge_conv_sum_kernel(p, q, nbr, deg)
        torch.cuda.synchronize()
        for other, what in ((want, "its plain version"), (k1, "f32 K1")):
            check(torch.equal(got.view(torch.int32), other.view(torch.int32)),
                  f"K3b call {i} V={v} H={h}: kernel and {what} differ")
        ms = median_ms(torch, lambda: windowed.
                       windowed_edge_conv_sum_f32_kernel(p, q, nbr, deg,
                                                         halo, tile))
        plain_ms = median_ms(torch, lambda: windowed.
                             windowed_edge_conv_sum_f32(p, q, nbr, deg, halo,
                                                        tile, impl="plain"))
        k1_ms = median_ms(torch, lambda: ell.ell_edge_conv_sum_kernel(
            p, q, nbr, deg))
        nbytes, slots = _slot_bytes(nbr, deg, 4, h, 1)
        b_ms, b_by = bound(nbytes, 3 * h * slots)
        staged = _staged_bytes(v, h, 4, halo, tile, 1)
        for k, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                       ("k1_ms", k1_ms)):
            row[k] += val
        row["kinds"].add(b_by)
        say("serving-windowed", f"K3b call {i} V={v} H={h} D={nbr.shape[1]} "
            f"halo={halo} tile={tile} staged {staged / 1e6:.1f} MB: bitwise "
            f"equal to its plain version and to f32 K1; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, K1 on the same inputs {k1_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
    row["bound_by"] = "bytes" if row.pop("kinds") == {"bytes"} else \
        "operations"

    counters = _counters()
    _zero(counters)
    out = server.predict(scene)
    launches = _read(counters)
    check(launches["k3b"] == dispatched,
          f"K3b launched {launches['k3b']} times in one predict, the "
          f"dispatch sends {dispatched} convs")
    check(launches["k1"] > 0 and launches["k2"] > 0,
          f"a kernel of the windowed forward never launched: {launches}")
    nv = scene.num_vertices[0]
    check(out.shape == (nv, 3), f"shape {out.shape}")
    check(bool(torch.isfinite(torch.from_numpy(out)).all()), "non-finite")
    check(float(abs(out).max()) <= 1.0, "output outside the tanh range")
    ref_err = float(abs(out - ref_out).max())
    plain_out = _scene_order(plain_dev[:nv].cpu().numpy(),
                             windowed_layout(scene)[1])
    plain_err = float(abs(out - plain_out).max())
    check(ref_err <= PATH_TOL and plain_err <= PATH_TOL,
          f"windowed predict vs non-windowed kernel path {ref_err:.3e}, vs "
          f"windowed plain path {plain_err:.3e}: over {PATH_TOL}")
    say("serving-windowed", f"predict {list(out.shape)} finite in [-1, 1]; "
        f"launches {launches}; max |diff| against the non-windowed kernel "
        f"path {ref_err:.3e}, against the windowed plain path "
        f"{plain_err:.3e}")
    ms, split = time_predict(torch, server, scene, WINDOWED_REPS)
    fwd_ms = median_ms(torch, lambda: server.forward(graph), reps=10,
                       inner=1)
    say("serving-windowed", f"predict {ms:.2f} ms/scene end to end; by "
        f"phase, median ms of {WINDOWED_REPS}: {split}; device forward "
        f"{fwd_ms:.3f} ms; K3b {row['ms']:.4f} ms a forward against K1 on "
        f"the same inputs {row['k1_ms']:.4f} ms; on {card}")
    return server, row, launches


def _equal_sizes_view(x, graph_id, num_graphs, nv):
    """The valid rows of a batch of equal-size graphs as [G, C, n], the
    layout `F.instance_norm` takes (None when the sizes differ)."""
    import torch
    sizes = torch.bincount(graph_id[:nv].to(torch.int64),
                           minlength=num_graphs).tolist()
    if len(set(sizes)) != 1:
        return None
    return x[:nv].view(num_graphs, sizes[0], -1).permute(0, 2, 1).contiguous()


def check_multigraph_k2(torch, calls):
    """Every recorded multi-graph K2 call on the kernel and on the plain
    version (K2_RTOL/K2_ATOL), timed with its bound and beside
    `F.instance_norm` on the [B, C, V/B] view of the valid rows."""
    import torch.nn.functional as F
    from stinet_tpu_torch.ops import norms
    row = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               max_abs_err=0.0, kinds=set())
    for i, (x, gid, ng, nv, eps) in enumerate(calls):
        v, c = x.shape
        n = int(nv)
        got = norms.masked_instance_norm_kernel(x, nv, eps, gid, ng)
        want = norms.masked_instance_norm_plain(x, gid, ng, nv, eps)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=K2_RTOL, atol=K2_ATOL),
              f"multi-graph K2 call {i} {tuple(x.shape)} G={ng}: max |diff| "
              f"{err:.3e} exceeds rtol {K2_RTOL} / atol {K2_ATOL}")
        check(torch.all(got[n:] == 0).item(), f"multi-graph K2 call {i}: "
              "pad rows not 0")
        xv = _equal_sizes_view(x, gid, ng, n)
        check(xv is not None, f"multi-graph K2 call {i}: graphs of unequal "
              "sizes, no [B, C, V/B] view")
        ms = median_ms(torch, lambda: norms.masked_instance_norm_kernel(
            x, nv, eps, gid, ng))
        plain_ms = median_ms(torch, lambda: norms.masked_instance_norm_plain(
            x, gid, ng, nv, eps))
        lib = median_ms(torch, lambda: F.instance_norm(xv, eps=eps))
        # the valid rows of x read once, every row of out written once
        b_ms, b_by = bound(4 * c * (n + v), 7 * n * c)
        for k, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                       ("library_ms", lib)):
            row[k] += val
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["kinds"].add(b_by)
        say("serving-batched", f"multi-graph K2 call {i:2d} V={v} C={c} "
            f"G={ng} valid={n}: max |diff| {err:.3e}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, instance_norm {lib:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
    k2_use_record(
        torch, "serving-batched", f"G graphs, B={BATCH} concatenated forward",
        [((*x.shape, int(nv), ng),
          lambda x=x, gid=gid, ng=ng, nv=nv, eps=eps:
          norms.masked_instance_norm_kernel(x, nv, eps, gid, ng))
         for x, gid, ng, nv, eps in calls],
        [lambda xv=_equal_sizes_view(x, gid, ng, int(nv)), eps=eps:
         F.instance_norm(xv, eps=eps) for x, gid, ng, nv, eps in calls])
    row["bound_by"] = "bytes" if row.pop("kinds") == {"bytes"} else \
        "operations"
    return row


def serving_batched(torch, card, server, scene, first):
    """Phase 9: predict_batch at B = BATCH (flagship scenes of seeds 0..B-1,
    one size, so one stacked layout) on the windowed f32 server, stacked
    and concatenated, each scene against its own forward; every
    multi-graph K2 call of the concatenated forward held against its
    plain version and timed; then predict_stream over STREAM scenes.
    `first` is seed 0's (host graph, level-0 order), from phase 5's build.
    Returns (multi-graph K2 row, launches of the concatenated batch)."""
    import concurrent.futures
    from stinet_tpu_torch.graph.hierarchy import map_tensors, scene_of
    from stinet_tpu_torch.ops import norms
    from stinet_tpu_torch.serving import SceneInpainter, _scene_order
    from stinet_tpu_torch.utils.synthetic import (
        FLAGSHIP_SCENE, synthetic_scene)
    scenes = [scene] + [synthetic_scene(**dict(FLAGSHIP_SCENE, seed=s))
                        for s in range(1, STREAM)]
    nv = scene.num_vertices[0]
    # every scene's host graph built once, in the build's vertex order
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        built = [first] + list(ex.map(server._build_scene, scenes[1:]))
    build_s = time.perf_counter() - t0
    hosts = [h for h, _ in built]
    singles = [_scene_order(server.forward(server.place(h))[:nv].cpu()
                            .numpy(), order) for h, order in built]
    batch = scenes[:BATCH]

    def agree(outs, count, label):
        errs = [float(abs(a - b).max()) for a, b in zip(outs, singles)]
        check(len(outs) == count and max(errs) <= PATH_TOL,
              f"{label}: {len(outs)} outputs for {count} scenes, max |diff| "
              f"against single-scene forwards {errs}")
        return max(errs)

    counters = _counters()
    results = {}
    for layout, stacked in (("stacked", True), ("concatenated", False)):
        _zero(counters)
        outs = server.predict_batch(batch, stacked=stacked)
        launches = _read(counters)
        err = agree(outs, BATCH, f"{layout} batch")
        e2e = []
        for _ in range(BATCH_REPS):
            t = time.perf_counter()
            server.predict_batch(batch, stacked=stacked)
            e2e.append((time.perf_counter() - t) * 1e3)
        results[layout] = (statistics.median(e2e), launches, err)
    check(results["stacked"][1]["k2mg"] == 0 and
          results["stacked"][1]["k2"] > 0,
          f"the stacked layout runs single-graph norms: "
          f"{results['stacked'][1]}")

    # device forwards of both layouts, from the host graphs built above
    st_graph = server.place(server._stack(hosts[:BATCH]))
    st_fwd = median_ms(torch, lambda: server.forward_stacked(st_graph),
                       reps=5, inner=1)
    # one scene three ways: a view of the stack, the same leaves copied to
    # fresh (aligned) tensors, and the scene placed alone
    first = scene_of(st_graph, 0)
    cloned = map_tensors(first, lambda t: t.clone())
    alone = server.place(hosts[0])
    one_ms = {k: median_ms(torch, lambda g=g: server.forward(g), reps=5,
                           inner=1)
              for k, g in (("stack view", first), ("copied", cloned),
                           ("placed alone", alone))}
    say("serving-batched", "device forward of scene 0, ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in one_ms.items()))
    cc_graph = server.place(server._host_graph(batch))
    cc_fwd = median_ms(torch, lambda: server.forward(cc_graph), reps=5,
                       inner=1)
    plain = SceneInpainter(server.model, server.model.state_dict(),
                           windowed=True, device="cuda", impl="plain")
    with record_calls({"k2": (norms, "masked_instance_norm_plain")}) as calls:
        plain.forward(cc_graph)
    calls = [c for c in calls["k2"] if c[2] > 1]
    concat_launches = results["concatenated"][1]
    check(concat_launches["k2mg"] == len(calls) > 0,
          f"multi-graph K2 launched {concat_launches['k2mg']} times in the "
          f"concatenated batch, {len(calls)} calls recorded on the plain "
          "path")
    row = check_multigraph_k2(torch, calls)
    for layout, (ms, launches, err) in results.items():
        fwd = st_fwd if layout == "stacked" else cc_fwd
        say("serving-batched", f"B={BATCH} {layout}: {ms:.2f} ms a batch = "
            f"{ms / BATCH:.2f} ms/scene end to end (median of {BATCH_REPS}); "
            f"device forward {fwd:.3f} ms a batch = {fwd / BATCH:.3f} "
            f"ms/scene; launches {launches}; max |diff| against single-scene "
            f"forwards {err:.3e}")

    # predict_stream: in order, each scene against its own forward
    yields, outs = [], []
    t0 = time.perf_counter()
    for out in server.predict_stream(scenes):
        outs.append(out)
        yields.append(time.perf_counter())
    err = agree(outs, STREAM, "predict_stream")
    whole = (yields[-1] - t0) / len(yields) * 1e3
    after = (yields[-1] - yields[0]) / (len(yields) - 1) * 1e3
    say("serving-batched", f"predict_stream over {len(scenes)} scenes: "
        f"{whole:.2f} ms/scene over the whole stream, {after:.2f} ms/scene "
        f"after the first result; stream_stats {server.stream_stats()}; "
        f"max |diff| "
        f"against single-scene forwards {err:.3e}; host builds of "
        f"{len(scenes) - 1} scenes on 4 threads {build_s:.2f} s; on {card}")
    return row, concat_launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = device_record(torch)
    build_kernels()

    from stinet_tpu_torch.graph.build import windowed_layout
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

    ms, split = time_predict(torch, server, scene, PREDICT_REPS)
    fwd_ms = median_ms(torch, lambda: server.forward(graph), reps=20,
                       inner=1)
    plain_fwd_ms = median_ms(torch, lambda: plain_server.forward(graph),
                             reps=20, inner=1)
    say("slice", f"predict {ms:.2f} ms/scene = "
        f"{nv / ms * 1e3:.0f} vertices/s end to end; by phase, median ms "
        f"of {PREDICT_REPS}: {split}; device forward {fwd_ms:.3f} ms "
        f"kernel path, {plain_fwd_ms:.3f} ms plain path; on {card}")

    # --- the bf16 windowed train path
    cfg = json.loads(pathlib.Path(BF16_CONFIG).read_text())
    del server, plain_server, graph
    train_model = define_G(**cfg["archs"]["SurfaceTextureInpaintingNet"][
        "args"], generator=torch.Generator().manual_seed(0)).cuda()
    whost, wgraph = windowed_build(torch, scene, train_model)
    captured = capture_train_calls(torch, train_model, wgraph, cfg)
    say("train-kernels", "calls recorded in one plain-path step: "
        + ", ".join(f"{k} {len(v)}" for k, v in captured.items()))
    train_rows = check_train_kernels(torch, captured)
    for key, r in train_rows.items():
        say("train-kernels", f"{key}: {r['calls']} calls, kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms"
            + (f", K1 on the same inputs {r['ab_ms']:.4f} ms"
               if key in ("k3a", "k3c") else ""))
    train_launches = train_slice(torch, card, train_model, wgraph, cfg,
                                 captured)

    # --- windowed f32 and batched serving
    del train_model, wgraph, captured
    wserver, k3b, w_launches = serving_windowed(torch, card, scene, whost,
                                                weights, out)
    k2mg, b_launches = serving_batched(
        torch, card, wserver, scene,
        (wserver._normalize_widths(whost), windowed_layout(scene)[1]))

    cu = "stinet_tpu_torch/ops/cuda/"
    kernels = [
        dict(name="ell_edge_conv_sum", route="cuda",
             source=cu + "ell_edge_conv.cu",
             replaces="stinet_tpu/ops/pallas/gather_pipeline.py:102",
             launches=launches["ell_edge_conv_sum"], **k1),
        dict(name="masked_instance_norm", route="cuda",
             source=cu + "instance_norm.cu",
             replaces="stinet_tpu/ops/pallas/instance_norm.py:77",
             launches=launches["masked_instance_norm"], **k2),
    ]
    for key, name, src, replaces in (
            ("k1", "ell_edge_conv_sum_bf16", "ell_edge_conv.cu",
             "stinet_tpu/ops/pallas/gather_pipeline.py:102"),
            ("k1dp", "ell_edge_conv_dp", "ell_edge_conv.cu",
             "stinet_tpu/ops/ell.py:100"),
            ("k1dq", "ell_edge_conv_dq", "ell_edge_conv.cu",
             "stinet_tpu/ops/ell.py:100"),
            ("k3a", "windowed_edge_conv_sum", "windowed_edge_conv.cu",
             "stinet_tpu/ops/pallas/onehot_gather.py:252"),
            ("k3c", "windowed_dq", "windowed_edge_conv.cu",
             "stinet_tpu/ops/pallas/onehot_gather.py:307"),
            ("k2", "masked_instance_norm_train_step", "instance_norm.cu",
             "stinet_tpu/ops/pallas/instance_norm.py:77")):
        kernels.append(dict(name=name, route="cuda", source=cu + src,
                            replaces=replaces,
                            launches=train_launches[key], **train_rows[key]))
    kernels += [
        dict(name="windowed_edge_conv_sum_f32", route="cuda",
             source=cu + "windowed_edge_conv.cu",
             replaces="stinet_tpu/ops/pallas/onehot_gather.py:291",
             launches=w_launches["k3b"], **k3b),
        dict(name="masked_instance_norm_multigraph", route="cuda",
             source=cu + "instance_norm.cu",
             replaces="stinet_tpu/ops/pallas/instance_norm.py:77",
             launches=b_launches["k2mg"], **k2mg)]
    say("done", f"every phase passed in {time.perf_counter() - t_start:.1f} "
        f"s, the kernels' build included, on {card}")
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
