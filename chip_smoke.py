#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printed as it ends; any failure raises and exits nonzero:

1. device record: torch and CUDA versions, the card, its power limit
   (`nvidia-smi`), whether nvcc and triton are present;
2. build: compiles the port's CUDA kernels (stinet_tpu_torch/ops/cuda/*.cu)
   from this checkout, all sources in parallel;
2b. host-build: the native host graph builder (stinet_tpu_torch/graph/
   native, g++ at first use) against the numpy path (STINET_NATIVE_BUILD=0,
   scipy's RCM) on the flagship scene, in this process: the first windowed
   build of the process each way, the median of HOST_BUILD_REPS plain and
   windowed builds each way (and native on one build thread), the plain
   graphs leaf for leaf equal and the windowed tables of both paths equal
   on one native-RCM order, and the share of a windowed build spent in the
   native calls. Every later phase that builds (4, 5, 8, 9, 10) checks
   that the native builder was called;
3. kernels: every kernel launch of one flagship forward, replayed on the
   inputs the forward gave it, held against the kernel's plain torch
   version (K1 bit for bit, K2 within K2_RTOL/K2_ATOL) and timed beside it
   (median of REPS CUDA-event timings of INNER back-to-back calls, after
   WARMUP calls), with the least
   time the card could take (bytes over 3.35 TB/s or f32 operations over
   67 TFLOP/s, the larger); for K1 also, here and in phase 6 (there for
   its forward, dp and dq): a call's host and card-alone time (as for K2
   below), the launch's plan (ops/ell.py:ell_plan, checked against what
   the library launched) and the other split of the rows into one or two
   groups, bitwise and timed beside it; for K2 also, here and in phases 6
   and 10: every
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
   its phases (host build, host-to-device copy, forward, copy back), with
   the native builder and again with the numpy one;
5. the windowed build: the flagship scene built with windowed=True (native
   RCM), each edge set's V_pad, width, slots and halo, and which convs of a
   forward dispatch the windowed kernels (K3); the band of every K3 table
   checked on the card;
6. the train kernels: one plain-path forward and backward of the bf16
   config's model records the inputs of every K3a (relu, step), K3c, bf16
   K1, K1 dp, K1 dq and K2 call; each kernel is held against its plain
   version on them (bit for bit; K2 within K2_RTOL/K2_ATOL) and timed
   beside it and beside its bound, each K3 call also beside K1's kernel on
   the same banded inputs (K3's bound counts each gathered row once, as
   K1's does), and both again by the card alone (calls queued behind a
   sleeping kernel, as for K2: back to back, a call that costs the host
   more than the card times the host); each K3 line prints the live slots
   a row and the launch's plan (strips, stage, ring and buffer rows,
   channel slice, TMA or ordinary loads, checked against what the library
   launched) with the bytes it copies into shared memory beside a per-tile
   design's;
7. the train slice: `make_inpainting_steps` with the bf16 config's model
   (full width and depth), optimizer and loss, STEPS steps on the kernel
   path and STEPS on the plain path from the same weights, on the windowed
   flagship scene; losses finite, each within TRAIN_TOL of the plain
   path's, parameters finite and moved, the launches of one step equal to
   the calls phase 6 recorded (checkpointed blocks run their forward
   twice); one step on a small scene against the CPU plain path
   (SMALL_TRAIN_TOL); then ms/step by CUDA events, split into forward,
   backward and optimizer, and the peak device memory of a step; then
   the step with another thread looping on windowed builds, on the
   native RCM alone and on a Python loop (what the trainer's loader
   thread does to the step);
8. trainer: the port's CLI (`stinet_tpu_torch.train.main`) on 3 flagship
   scenes (seeds 0-2: 2 train, 1 val) written in the ScanNet loader's
   format to a temporary directory. The loader alone builds the train set
   once with the native builder and once with the numpy one (its build ms,
   no step running). The production bf16 config
   (windowed, full width and depth; data roots and save_dir repointed,
   TRAINER_EPOCHS epochs, a checkpoint every epoch) trains with the
   kernels' launch counts zeroed before and read after: each kernel of the
   bf16 path launched, each step's launches equal to the calls a
   plain-path trainer's step records on the same batch, the first loss
   within TRAIN_TOL of that trainer's, every loss finite, the last epoch's
   mean train loss below the first's, the checkpoints written; then its
   ms/step by its own clock, the loader's build ms a batch, each step's
   wait on `iter_placed`, the step by CUDA events and peak memory; the
   same run again on the numpy builder, for the same readings. It
   resumes from the last checkpoint for one more epoch (parameters and
   Adam state bitwise the file's before the first step), evaluates
   model_best (`-e valid`) and serves it with `from_checkpoint`, within
   PATH_TOL of a server of the trainer's own weights. Last, the f32
   reference config at `--bs 2` with accumulation F32_ACCUMULATE for
   F32_EPOCHS epochs (one optimizer step): f32 K1, dp, dq and multi-graph
   K2 launched and held per step as above, with the same readings;
8b. segmentation: the CLI trains the shipped segmentation config
   (SingleConvMeshNet at its full width, f32; torch ops only, no kernel of
   its own) for SEG_EPOCHS epochs on 2 training crops and 1 uncropped val
   scene (`synthetic_scene(65536, levels=4)`, seeds 0-2, labels over 0..20
   from a seeded numpy generator): the model's parameters and buffers on
   the card, every epoch's losses finite, the full-scene IoU computed,
   every masked batch norm's running statistics one update from its first
   forward each step (the checkpointed blocks' recomputed forwards leave
   them alone), the checkpoints written; one step from the trainer's
   weights on the card against the same step on the CPU (loss, logits and
   running statistics within SEG_TOL; the confusion matrices equal but
   for vertices whose top two logits lie within twice the logits' largest
   difference); then the trainer's ms/step, the loader's build ms, the
   wait on `iter_placed`, a bare step by CUDA events split into forward,
   backward and optimizer with peak memory, the eval step, and a traced
   step (device busy ms, launches, idle share, top 8 ops); a resume for
   one more epoch (state and Adam state bitwise the file's) and
   `-e valid`; the phase's wall time;
8c. inpainting2d: the CLI trains the hermetic 2D config (STINet with
   edgeconv over 128 x 128 image grid graphs, ngf 64, 9 blocks, f32, B=4;
   LPIPS every batch and FID on random features) with the cuts listed in
   `inpainting2d_phase`: INP2D_EPOCHS epochs of 8 steps on 32 synthesized
   textures, FID at the last one: the kernels' launch counts zeroed
   before and read after (f32 K1, dp, dq and multi-graph K2 in training,
   single-graph K2 in validation), each step's launches equal to the calls
   a plain-path trainer's step records on the same batch, the first loss
   within TRAIN_TOL of that trainer's, every loss and LPIPS finite, both
   FIDs finite, the checkpoints written; on one full-width train batch
   and one val image from the trainer's weights, every K1, dp, dq and K2
   call of a plain-path forward, backward and eval step held against its
   kernel on the same inputs (K1, dp and dq bit for bit, K2 of 4 graphs
   and of one within K2_RTOL/K2_ATOL), and the kernel path's loss and
   gradients against the plain path's (TRAIN_TOL; all gradients as one
   vector within INP2D_GRAD_TOL in L2); LPIPS and InceptionV3 on the card
   (TF32 off) against the CPU within PERCEPTUAL_TOL; then the trainer's
   ms/step, the loader's ms a batch, the wait on `iter_placed`, the FID
   passes split into eval and Inception forwards against the host's
   statistics and sqrtm, a bare step split into forward, backward and
   optimizer with peak memory and LPIPS's time beside it, eval ms/image,
   and a traced step (busy ms, launches, idle share, top 8 ops); a resume
   for one more epoch (parameters and Adam state bitwise the file's) and
   `-e valid`; the phase's wall time;
8d. inpainting2d-resnet: the CLI trains the hermetic 2D config with
   `archs.Resnet2D` enabled at its shipped width (ngf 64, 9 blocks, f32,
   B=4 128 x 128 images; cuDNN convolutions, no kernel of the port's own)
   and `use_gan` (the PatchGAN discriminator, ndf 64, 5 layers), with
   `inpainting2d`'s cuts: both models on the card, no graph kernel
   launched, every loss, GAN loss, accuracy and LPIPS finite, both FIDs
   finite, the checkpoints holding "2d" and "discriminator"; one GAN step
   and one plain 2d step from the trainer's weights on the card against
   the CPU, in f32 and in f64 (every metric within RESNET_TOL relative;
   G's and D's gradients each within RESNET_TOL of their L2 norm in f64,
   their f32 distance printed); the trainer's clock, the
   loader's ms, the wait on `iter_placed`, the FID split, a bare GAN step
   by CUDA events split into G forward, D forward and backward, D
   optimizer, G loss and backward, G optimizer, with peak memory and a
   traced GAN step, a bare plain 2d step beside it, eval ms/image; a
   resume (both models and Adam states bitwise the file's) and `-e
   valid`; then `metrics/fid_cli.py` on the card from gz UV maps and .npz
   statistics; the phase's wall time;
9. serving-windowed: the flagship f32 server with windowed=True on phase
   5's build; every K3b call of one plain-path forward held bit for bit
   against its plain version and against f32 K1 on the same inputs, each
   of the three timed, with K3b's bound and plan and the device-alone
   times, as in phase 6; the K3b launches of one predict equal to the
   convs the dispatch sends to it (at least 1); the output
   (in the scene's vertex order) within PATH_TOL of phase 4's and of the
   windowed plain path; ms/scene split into phases, with the native
   builder and again with the numpy one;
10. serving-batched: `predict_batch` at B = BATCH (flagship scenes of seeds
   0..B-1) stacked and concatenated, each scene within PATH_TOL of its own
   forward; every multi-graph K2 call of the concatenated forward within
   K2_RTOL/K2_ATOL of its plain version, timed beside `F.instance_norm` on
   the [B, C, V/B] view of the valid rows; ms per batch and ms/scene in
   both layouts, and one scene's forward as a view of the stack, copied,
   and placed alone; then `predict_stream` over STREAM scenes, in order
   and each within PATH_TOL of its own forward, with its ms/scene over the
   whole stream and after the first result, and `stream_stats()`.

11. reference-checkpoint: the flagship's weights (seed 0) saved in the
   reference's two checkpoint layouts (`{"state_dicts": {"graph": sd}}`
   and `{"state_dict": sd}`) and read back by `load_reference_state_dict`
   into a fresh model served on the card: the served weights bitwise the
   source's, each predict within REF_TOL of the source model's (the
   forward's scatter adds are atomic on the card, so two predicts of one
   server differ in the last bits; that difference is printed) and within
   SMALL_TOL of the CPU on the small scene, K1 and K2 launched as often
   as in the flagship's predict;
12. sageconv: the flagship with `filter_type="sageconvtransinv"`, f32:
   `predict` through the server (the served graph keeps the COO lists
   the filters read), K1 and K3 not launched and K2 as in the flagship's
   predict; the small scene against the CPU (SMALL_TOL); VARIANT_STEPS
   bare steps of `make_inpainting_steps` on the kernel and on the plain
   path, each step's launches equal to the calls a plain-path step
   records, losses within TRAIN_TOL; one forward and backward on the small
   scene, card against CPU, in f64 (the card's plain path; the kernels
   take f32 and bf16) within GRAD64_TOL and in f32 (distance printed);
   device forward ms, step ms and peak memory;
13. label-embedding: the same for the flagship with `use_label_embedding`
   (21 classes, 12 dims, the shipped configs' values) on the scenes with
   seeded labels (a quarter of them 0): the served graph keeps the labels,
   and K1 and K2 launch as in the flagship's predict;
14. trainer-stacked: the CLI trains the bf16 config with
   `stacked_batching` at `train_batch_size` 2 on phase 8's scenes
   (TRAINER_EPOCHS steps of two stacked scenes): each kernel of the bf16
   path launched, each step's launches equal to the calls of a plain-path
   stacked step on its batch, the first loss within TRAIN_TOL of that
   step's; the trainer's clock, the loader's ms, the wait, the step by
   CUDA events and peak memory;
15. preprocess: two rooms of PREP_VERTICES source vertices
   (utils/synthetic_sensor.py:room_mesh, the terrain scaled to 8 m x 8 m,
   seeds 0 and 1) written as the ScanNet scans of a train and a val scene,
   then the port's preprocessing CLI in subprocesses at its defaults
   (`graphs --jobs PREP_JOBS`, `crops`, `masks --crops`): each
   subcommand's seconds, the crops and masks written, the decimator's
   native calls in each `graphs` worker; the bf16 config trained on the
   output for PREP_EPOCHS epochs through the trainer's CLI (K3a, K3c, K1
   and K2 launched, each step's launches equal to a plain-path step's
   calls; the trainer's readings as in phase 8); every crop of the train
   scene read and built by the ScanNet loader with no_train_cropped false;
   the flagship served on the val scene the loader reads (K1 and K2 as in
   phase 4's predict; ms/scene by phase);
16. texture-optimization: a TEX_VERTICES room and TEX_FRAMES frames of
   640 x 480 z-buffered by the native rasterizer from seeded cameras above
   it, colored by a smooth field, poses perturbed by 0.01 rad and 0.01 m on
   frames 1..: `estimate_vertex_colors` on the card against the CPU on
   TEX_CPU_FRAMES frames (visibility flips counted, colors within
   TEX_TOL where the tests agree), `rigid_optimize` for TEX_ITERS
   iterations at TEX_LR (the residual falls, frame 0 anchored, peak
   memory), an iteration by CUDA events and a traced iteration (busy ms,
   launches, idle share, top ops);
17. serving-hostile: the flagship f32 `predict` on
   `hostile_scene(HOSTILE_VERTICES, kind)` for the sphere and the terrain,
   plain and windowed: ms/scene by phase, the host build's share, the K1,
   K3b and K2 launches, windowed within PATH_TOL of plain;
18. partitioned: `predict_partitioned` of the flagship on an in-process
   mesh of PART_COUNTS partitions on the card, the terrain and the sphere
   of phase 17 in f32 and the terrain in bf16 (the flagship's synthetic
   scene is refused by the children cap, as in JAX): K1's launches
   counted around one call, every K1 call of a plain-path call replayed
   on the kernel bitwise (q of more rows than p), the output within
   PART_RTOL / PART_ATOL of `predict` (bf16: PART_BF16_MEAN_TOL and
   PART_BF16_MAX_TOL), ms end to end and by step with the host partition
   build's share, the device forward and its K1 calls, beside `predict`;
19. export: `SceneInpainter.export` of the flagship, plain and windowed,
   reloaded by `utils/model_io.load_serving`: launches as the server's
   forward, output bitwise its, export and load seconds, a call's time.

The last two lines are the kernel record (a row for K1 on phase 18's
halo layout at P = 4 besides phase 3's; K3 rows also carry
`k1_same_inputs_ms`, K1's time on the same inputs; K1 and K3 rows
`device_ms`, the card-alone time, and `host_us`, the host's time a call)
and the result, one JSON object each. Without a CUDA card the script exits
nonzero and prints no result.

    python3 chip_smoke.py --k1-only [--tree DIR]

builds the kernels and runs only phase 3's K1 forward calls and phase 6's
K1 forward, dp and dq calls, held and timed as above, and prints their sums
as one JSON line; with --tree, on the stinet_tpu_torch package of the
checkout DIR (an A/B of two versions of the kernels, each in its own
process, by this script's code).
"""
import contextlib
import copy
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time
import types

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
WINDOWED_REPS = 3           # timed windowed predicts a builder (numpy is slow)
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
        kernel = "?"
        for line in log.splitlines():
            # the mangled name after the file's hash, up to the parameters
            entry = re.search(r"entry function '\w*?_cu_\w{8}\d+(\w+?)"
                              r"(?:EE?v|E\d)", line)
            if entry:
                kernel = entry.group(1)   # e.g. ell_fwd_rowsIfLb1ELi4E
            elif "registers" in line or "spill" in line:
                say("build", f"{name}: {kernel}: {line.strip()}")


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


# K1's launcher of each kind of row sum (ops/ell.py), with a plan
K1_LAUNCHERS = {"sum": "launch_sum", "dp": "launch_dp", "dq": "launch_dq"}


def k1_plan_note(torch, kind, args, want):
    """The plan of K1's last launch of `kind` ("sum" the forward, "dp",
    "dq"; ops/ell.py:ell_plan), checked against what the library launched,
    and the rows split into half or twice its groups, where the plan
    allows, held bitwise against `want` and timed, back to back and by the
    card alone: what ell_plan's choice of groups rests on. `args`: the
    launcher's tensors (the forward's p, q, nbr, deg). A package from
    before the plans of that kind (--tree) has none to print."""
    from stinet_tpu_torch.ops import ell
    launch = getattr(ell, K1_LAUNCHERS[kind], None)
    if launch is None or (kind != "sum" and not hasattr(ell, "KINDS")):
        return f"no {kind} plan in this package"
    kw = {} if kind == "sum" else {"kind": kind}
    rows = args[0]
    v, h = rows.shape
    plan = ell.ell_plan(v, h, rows.dtype, **kw)
    got = ell.last_launch(**kw)
    launched = dict(lanes=plan.lanes, chunks=plan.chunks, groups=plan.groups,
                    blocks=plan.blocks, threads=ell.THREADS,
                    vector=int(plan.vector))
    check(got == launched, f"the library launched {got}, ell_plan gives "
          f"{launched} ({kind})")
    text = (f"plan {plan.lanes} lanes x {plan.chunks} chunks, {plan.groups} "
            f"group(s) a row, {plan.blocks} blocks of "
            f"{plan.rows_per_block:g} rows, "
            f"{'16-byte' if plan.vector else 'element'} loads")
    for groups in (plan.groups // 2, 2 * plan.groups):
        if groups == 0:
            continue
        try:
            other = ell.ell_plan(v, h, rows.dtype, groups=groups, **kw)
        except ValueError:
            continue
        out = launch(other, *args)
        torch.cuda.synchronize()
        view = torch.int16 if out.dtype == torch.bfloat16 else torch.int32
        check(torch.equal(out.view(view), want.view(view)),
              f"K1 {kind} split into {groups} groups and the plain version "
              "differ")
        ms = median_ms(torch, lambda o=other: launch(o, *args))
        _, _, dev = host_device_us(torch, lambda o=other: launch(o, *args))
        text += (f"; {groups} group(s) x {other.chunks} chunks: bitwise, "
                 f"{ms:.4f} ms, device alone {dev:.1f} us")
    return text


def k1_wrapper_costs(torch, p, q, nbr, deg):
    """Host microseconds of one K1 wrapper call on these tensors, of the
    autograd Function's call that predict makes around it, and of the
    wrapper's steps, each the median of 5 loops of ENQUEUES repeats: the
    row and table checks, the allocation, the stream lookup, the plan
    (`ell_plan`, cached
    per shape) and the launcher (cached per dtype), beside the per-call
    lookup the cache replaced (the library, then an f-string getattr); the
    rest of the call is the ctypes call with the launch. A package without
    this one's cached launcher lookup (--tree) gets the whole call only."""
    from stinet_tpu_torch.ops import _cuda, ell
    dev = p.device
    v, h = p.shape

    def us(fn):
        fn()
        torch.cuda.synchronize()
        loops = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(ENQUEUES):
                fn()
            loops.append((time.perf_counter() - t0) / ENQUEUES * 1e6)
            torch.cuda.synchronize()
        return statistics.median(loops)

    whole = us(lambda: ell.ell_edge_conv_sum_kernel(p, q, nbr, deg))
    with torch.inference_mode():
        entry = us(lambda: ell.ell_edge_conv_sum(p, q, nbr, deg))
    costs = {}
    if hasattr(ell, "_launcher"):
        costs = {
            "row checks": us(lambda: (
                _cuda.check_tensor("p", p, p.dtype, 2, dev),
                _cuda.check_tensor("q", q, p.dtype, 2, dev))),
            "table check": us(lambda: ell._check_table(nbr, deg, v, dev)),
            "out (torch.empty_like)": us(lambda: torch.empty_like(p)),
            "stream lookup": us(lambda: _cuda.stream_of(dev)),
            "plan and launcher lookups, cached": us(lambda: (
                ell.ell_plan(v, h, p.dtype, True, 0, "sum"),
                ell._launcher("sum", p.dtype)))}
        costs["the rest (pointers, the ctypes call with the launch)"] = (
            whole - sum(costs.values()))
        costs["the per-call lookup it replaced"] = us(lambda: getattr(
            _cuda.library("ell_edge_conv"),
            f"ell_edge_conv_sum_fwd_{ell._DTYPES[p.dtype]}"))
        # the Function's step that sends an export trace to the custom op
        # (ops/library.py), paid by every eager call around the wrapper
        costs["the Function's export check (torch.compiler.is_exporting)"] \
            = us(torch.compiler.is_exporting)
    say("K1", f"host cost of a wrapper call on {tuple(p.shape)} "
        f"{p.dtype}, us: whole call {whole:.2f}, through the autograd "
        f"Function as predict calls it (ell_edge_conv_sum, inference mode) "
        f"{entry:.2f}" + "".join(
            f", {k} {val:.2f}" for k, val in costs.items()))
    return whole


def check_k1(torch, calls):
    """Phase 3's K1 calls: each bitwise its plain version, timed back to
    back, split into host and card alone (`host_device_us`), with its
    bound and plan."""
    from stinet_tpu_torch.ops.ell import (
        ell_edge_conv_sum_kernel, ell_edge_conv_sum_plain)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, device_ms=0.0,
               host_us=0.0)
    err, kinds = 0.0, set()
    for i, (p, q, nbr, deg) in enumerate(calls):
        check(nbr is not None, f"K1 call {i}: edge set has no ELL table")
        got = ell_edge_conv_sum_kernel(p, q, nbr, deg)
        want = ell_edge_conv_sum_plain(p, q, nbr, deg)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        check(same, f"K1 call {i} {tuple(nbr.shape)}x{p.shape[1]}: kernel "
              "and plain version differ")
        note = k1_plan_note(torch, "sum", (p, q, nbr, deg), want)
        err = max(err, (got - want).abs().max().item())
        ms = median_ms(torch, lambda: ell_edge_conv_sum_kernel(p, q, nbr, deg))
        plain = median_ms(torch,
                          lambda: ell_edge_conv_sum_plain(p, q, nbr, deg))
        host, _, dev = host_device_us(
            torch, lambda: ell_edge_conv_sum_kernel(p, q, nbr, deg))
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
        for k, val in (("ms", ms), ("plain_ms", plain), ("bound_ms", b_ms),
                       ("device_ms", dev / 1e3), ("host_us", host)):
            tot[k] += val
        say("K1", f"call {i:2d} V={v} H={h} D={nbr.shape[1]} live slots a "
            f"row {slots / max(receivers, 1):.2f}: bitwise equal; kernel "
            f"{ms:.4f} ms, device alone {dev:.1f} us, host {host:.1f} us a "
            f"call, plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{nbytes / ms / 1e6:.0f} GB/s; {note}")
    tot["host_us"] /= max(len(calls), 1)
    small = min(calls, key=lambda c: c[0].numel())
    k1_wrapper_costs(torch, *small)
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


# --- the host graph build, native and numpy ---------------------------------

HOST_BUILD_REPS = 5         # timed builds a way in the host-build phase


@contextlib.contextmanager
def env(**values):
    """Environment variables set for the block (None: unset), then put
    back: STINET_NATIVE_BUILD=0 takes the numpy builder, and
    STINET_BUILD_WORKERS the build's thread count."""
    import os
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def native_calls():
    """The native builder's calls so far, all entry points."""
    from stinet_tpu_torch.graph import native
    return sum(native.calls.values())


def check_native(phase, before):
    """Check that the native builder was called since `before` (a
    native_calls() reading); returns how many times."""
    n = native_calls() - before
    check(n > 0, f"{phase}: the host build made no native call")
    return n


def same_graphs(torch, a, b):
    from stinet_tpu_torch.graph.hierarchy import tensor_leaves, tree_structure
    return tree_structure(a) == tree_structure(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(tensor_leaves(a), tensor_leaves(b)))


def host_build_phase(torch, card):
    """Phase host-build: the flagship scene built plain and windowed, by
    the native builder and by the numpy path (STINET_NATIVE_BUILD=0,
    scipy's RCM), in this process. The first windowed build of the process
    each way, then the median of HOST_BUILD_REPS builds each way and, on
    the native path, with one build thread (STINET_BUILD_WORKERS=1); the
    plain builds held leaf for leaf, and the windowed tables of both paths
    on the one native-RCM order; the share of a one-thread windowed build
    spent in the native calls (the binding's functions, timed)."""
    from stinet_tpu_torch.graph import build as B
    from stinet_tpu_torch.graph import native
    from stinet_tpu_torch.utils.synthetic import (
        FLAGSHIP_SCENE, synthetic_scene)
    t0 = time.perf_counter()
    native.get_lib()
    lib_s = time.perf_counter() - t0
    scene = synthetic_scene(**FLAGSHIP_SCENE)

    def build(windowed, s=scene):
        t = time.perf_counter()
        g = B.build_hierarchical_graph([s], geometric=True,
                                       windowed=windowed)
        return (time.perf_counter() - t) * 1e3, g

    first = {}
    for way, flag in (("native", None), ("numpy", 0)):
        with env(STINET_NATIVE_BUILD=flag):
            first[way] = build(True)[0]
    med, graphs = {}, {}
    for windowed in (False, True):
        for way, values in (("native", {}),
                            ("native 1 thread", {"STINET_BUILD_WORKERS": 1}),
                            ("numpy", {"STINET_NATIVE_BUILD": 0})):
            with env(**values):
                runs = [build(windowed) for _ in range(HOST_BUILD_REPS)]
            med[(windowed, way)] = statistics.median(r[0] for r in runs)
            graphs[(windowed, way)] = runs[-1][1]
    check(same_graphs(torch, graphs[(False, "native")],
                      graphs[(False, "numpy")]),
          "plain build: the native and numpy graphs differ")
    banded, _ = B.windowed_layout(scene)
    with env(STINET_NATIVE_BUILD=0):
        np_tables = build(True, banded)[1]
    check(same_graphs(torch, build(True, banded)[1], np_tables),
          "windowed build on one RCM order: native and numpy tables differ")

    spent = [0.0]

    def timed(fn):
        def run(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[0] += time.perf_counter() - t
        return run

    names = ("build_edge_set_tables", "build_children_table", "rcm_order")
    saved = {n: getattr(native, n) for n in names}
    for n, fn in saved.items():
        setattr(native, n, timed(fn))
    try:
        with env(STINET_BUILD_WORKERS=1):
            walls = [build(True)[0] for _ in range(HOST_BUILD_REPS)]
    finally:
        for n, fn in saved.items():
            setattr(native, n, fn)
    share = spent[0] * 1e3 / sum(walls)
    for windowed in (False, True):
        say("host-build", f"{'windowed' if windowed else 'plain'} build, "
            f"median ms of {HOST_BUILD_REPS}: native "
            f"{med[(windowed, 'native')]:.2f}, native on 1 thread "
            f"{med[(windowed, 'native 1 thread')]:.2f}, numpy "
            f"{med[(windowed, 'numpy')]:.2f}")
    say("host-build", f"g++ build and load of the native library "
        f"{lib_s:.2f} s; first windowed build of the process: native "
        f"{first['native']:.2f} ms, numpy (first scipy RCM) "
        f"{first['numpy']:.2f} ms; a windowed build on 1 thread "
        f"{statistics.median(walls):.2f} ms, {share * 100:.1f}% of it in the "
        f"native calls; plain graphs leaf for leaf equal, windowed tables "
        f"equal on one RCM order; calls {native.calls}; on {card}")


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
    before = native_calls()
    host = build_hierarchical_graph([scene], geometric=True, windowed=True)
    secs = time.perf_counter() - t0
    n_native = check_native("windowed", before)
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
    say("windowed", f"host build {secs * 1e3:.1f} ms (native, "
        f"{n_native} calls, RCM included); "
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


def train_targets():
    """The plain functions of every kernel on the train path, for
    `record_calls`: {key: (module, name)}."""
    from stinet_tpu_torch.ops import ell, norms, windowed
    return {"k3a": (windowed, "windowed_edge_conv_sum"),
            "k3c": (windowed, "windowed_dq"),
            "k1": (ell, "ell_edge_conv_sum_plain"),
            "k1dp": (ell, "ell_edge_conv_dp_plain"),
            "k1dq": (ell, "ell_edge_conv_dq_plain"),
            "k2": (norms, "masked_instance_norm_plain")}


def capture_train_calls(torch, model, graph, cfg):
    """Phase 6, first half: one plain-path train step of a copy of `model`
    with the plain functions of every kernel on the path recorded."""
    from stinet_tpu_torch.trainers import graph_common as gc
    model = copy.deepcopy(model)
    opt, lr = gc.build_optimizer(model.parameters(), cfg["optimizer"])
    step, _ = gc.make_inpainting_steps(
        model, opt, cfg["trainer"]["use_mask_weighted_loss"], impl="plain")
    with record_calls(train_targets()) as calls:
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


def plan_note(rows, halo, tile, arrays, slots):
    """The launch plan of a windowed kernel on `rows` (ops/windowed.py:
    window_plan), checked against what the library launched last, and the
    bytes it copies into shared memory a call beside what a design that
    stages every tile's window anew would copy."""
    from stinet_tpu_torch.ops import windowed
    plan = windowed.launch_plan(rows, halo, tile, arrays, slots)
    got = windowed.last_launch()
    keys = ("strips", "cs", "sub", "ring", "bufs", "buf_rows", "smem")
    check(all(got[k] == getattr(plan, k) for k in keys),
          f"the library launched {got}, window_plan gives {plan}")
    # the main path's rows are contiguous fresh tensors: TMA fills the ring
    check(got["tma"] == 1, f"a main-path call ({tuple(rows.shape)} rows) "
          "filled the ring by ordinary loads, not TMA")
    return (f"plan {plan.strips} strips x {plan.strip_tiles} tiles x "
            f"{plan.slices} slices of {plan.cs}, stages of {plan.sub} rows, "
            f"ring {plan.ring} rows, {plan.bufs} buffers of "
            f"{plan.buf_rows} rows, {plan.smem} B, TMA; rings take in "
            f"{plan.staged_bytes() / 1e6:.1f} MB a call (per-tile design "
            f"{plan.per_tile_staged_bytes() / 1e6:.1f} MB), buffers "
            f"{plan.own_row_bytes() / 1e6:.1f} MB")


def check_train_kernels(torch, calls):
    """Phase 6, second half: every recorded call on the kernel and on the
    plain version (bitwise; K2 within K2_RTOL/K2_ATOL), timed, with its
    bound; each K3 call also timed with K1's kernel on the same banded
    inputs, each K2 call with `F.batch_norm`."""
    import torch.nn.functional as F
    from stinet_tpu_torch.ops import ell, norms, windowed
    rows = {}

    def run(key, label, kernel, plain, nbytes, flops, ab=None, tol=None,
            lib=None, note=None, alone=False):
        got = kernel()
        want = plain()
        if note is not None:
            label = f"{label}; {note(want)}"
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
            ab_ms=0.0, device_ms=0.0, k1_device_ms=0.0, host_us=0.0))
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += b_ms
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["kinds"].add(b_by)
        r["calls"] += 1
        extra = ""
        if ab is not None or alone:
            # back-to-back calls time the host where a call's host cost is
            # the larger; queued behind a sleeping kernel, the card alone
            host, _, dev = host_device_us(torch, kernel)
            r["device_ms"] += dev / 1e3
            r["host_us"] += host
            extra = f"; device alone {dev:.1f} us; host {host:.1f} us a call"
        if ab is not None:
            ab_ms = median_ms(torch, ab)
            r["ab_ms"] += ab_ms
            _, _, ab_dev = host_device_us(torch, ab)
            r["k1_device_ms"] += ab_dev / 1e3
            extra += (f"; K1 on the same inputs {ab_ms:.4f} ms, device alone "
                      f"{ab_dev:.1f} us")
        if lib is not None:
            lib_ms = median_ms(torch, lib)
            r["library_ms"] += lib_ms
            extra = f"; batch_norm {lib_ms:.4f} ms"
        say("train-kernels", f"{label}: {verdict}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}){extra}")

    for i, (p, q, nbr, deg, halo, tile, mode, _) in enumerate(calls["k3a"]):
        v, h = p.shape
        nbytes, slots = _slot_bytes(nbr, deg, 2, h, 1)
        ones = torch.ones_like(p)
        run("k3a", f"K3a {mode} {i:2d} V={v} H={h} D={nbr.shape[1]} "
            f"halo={halo} tile={tile} live slots a row "
            f"{slots / max(int(torch.count_nonzero(deg)), 1):.2f}",
            lambda: windowed.windowed_edge_conv_sum_kernel(
                p, q, nbr, deg, halo, tile, mode),
            lambda: windowed.windowed_edge_conv_sum_plain(p, q, nbr, deg,
                                                          mode),
            nbytes, 4 * h * slots,
            ab=(lambda: ell.ell_edge_conv_sum_kernel(p, q, nbr, deg))
            if mode == "relu" else
            (lambda: ell.ell_edge_conv_dp_kernel(p, q, nbr, deg, ones)),
            note=lambda _: plan_note(q, halo, tile, 1, nbr.shape[1]))
    for i, (q, g, p, rev, dout, halo, tile, _) in enumerate(calls["k3c"]):
        v, h = q.shape
        nbytes, slots = _dq_bytes(rev, dout, 2, h)
        run("k3c", f"K3c {i:2d} V={v} H={h} D={rev.shape[1]} halo={halo} "
            f"tile={tile} live slots a row "
            f"{slots / max(int(torch.count_nonzero(dout)), 1):.2f}",
            lambda: windowed.windowed_dq_kernel(q, g, p, rev, dout, halo,
                                                tile),
            lambda: ell.ell_edge_conv_dq_plain(q, g, p, rev, dout),
            nbytes, 4 * h * slots,
            ab=lambda: ell.ell_edge_conv_dq_kernel(q, g, p, rev, dout),
            note=lambda _: plan_note(g, halo, tile, 2, rev.shape[1]))
    for i, (p, q, nbr, deg) in enumerate(calls["k1"]):
        v, h = p.shape
        nbytes, slots = _slot_bytes(nbr, deg, p.element_size(), h, 1)
        run("k1", f"K1 {p.dtype} {i:2d} V={v} H={h} D={nbr.shape[1]} live "
            f"slots a row {slots / max(int(torch.count_nonzero(deg)), 1):.2f}",
            lambda: ell.ell_edge_conv_sum_kernel(p, q, nbr, deg),
            lambda: ell.ell_edge_conv_sum_plain(p, q, nbr, deg),
            nbytes, 4 * h * slots, alone=True,
            note=lambda want: k1_plan_note(torch, "sum", (p, q, nbr, deg),
                                           want))
    for i, (p, q, nbr, deg, g) in enumerate(calls["k1dp"]):
        v, h = p.shape
        nbytes, slots = _slot_bytes(nbr, deg, p.element_size(), h, 2)
        run("k1dp", f"K1 dp {i:2d} V={v} H={h} D={nbr.shape[1]} live slots "
            f"a row {slots / max(int(torch.count_nonzero(deg)), 1):.2f}",
            lambda: ell.ell_edge_conv_dp_kernel(p, q, nbr, deg, g),
            lambda: ell.ell_edge_conv_dp_plain(p, q, nbr, deg, g),
            nbytes, 4 * h * slots, alone=True,
            note=lambda want: k1_plan_note(torch, "dp", (p, q, nbr, deg, g),
                                           want))
    for i, (q, g, p, rev, dout) in enumerate(calls["k1dq"]):
        v, h = q.shape
        nbytes, slots = _dq_bytes(rev, dout, q.element_size(), h)
        run("k1dq", f"K1 dq {i:2d} V={v} H={h} D={rev.shape[1]} live slots "
            f"a row {slots / max(int(torch.count_nonzero(dout)), 1):.2f}",
            lambda: ell.ell_edge_conv_dq_kernel(q, g, p, rev, dout),
            lambda: ell.ell_edge_conv_dq_plain(q, g, p, rev, dout),
            nbytes, 4 * h * slots, alone=True,
            note=lambda want: k1_plan_note(torch, "dq", (q, g, p, rev, dout),
                                           want))
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
    if calls["k2"]:
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
        r["host_us"] /= r["calls"]
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

    # the step with other host work on another thread, as the trainer's
    # loader runs beside it: a whole windowed build (its numpy glue holds
    # the interpreter lock), the native RCM alone (C with the lock
    # released) and a Python loop (the lock only)
    from stinet_tpu_torch.graph import native
    from stinet_tpu_torch.graph.build import build_hierarchical_graph
    from stinet_tpu_torch.utils.synthetic import synthetic_scene
    scene = synthetic_scene(**FLAGSHIP_SCENE)
    edges0 = scene.level_edges[0]

    def step():
        return timed(lambda: kstep(graph, lr))

    beside = step_beside(step, {
        "nothing": None,
        "windowed builds": lambda: build_hierarchical_graph(
            [scene], geometric=True, windowed=True),
        "native RCM calls": lambda: native.rcm_order(
            edges0, scene.num_vertices[0])}, STEP_REPS)
    # a step takes seconds beside a Python loop: 2 of them
    beside.update(step_beside(step, {"a Python loop": lambda: sum(
        i * i for i in range(200_000))}, 2))
    say("train", "train step by CUDA events, median ms, with another "
        "thread looping on: " + ", ".join(
            f"{k} {ms:.2f} ({n} done in {reps} steps)"
            for k, (ms, n, reps) in beside.items()) + f"; on {card}")
    return launches


def step_beside(step, loads, reps):
    """{name: (median ms of `reps` calls of `step`, loads done, reps)} with
    `loads[name]` called in a loop on another thread meanwhile (None: no
    thread)."""
    import threading
    out = {}
    for name, load in loads.items():
        stop, done = threading.Event(), [0]

        def loop(load=load, done=done, stop=stop):
            while not stop.is_set():
                load()
                done[0] += 1

        th = threading.Thread(target=loop, daemon=True) if load else None
        if th:
            th.start()
        try:
            out[name] = (statistics.median(step() for _ in range(reps)),
                         done[0], reps)
        finally:
            stop.set()
            if th:
                th.join()
    return out


# --- the trainer and its CLI -------------------------------------------------

TRAINER_EPOCHS = 3          # epochs of the bf16 run (2 train scenes each)
F32_EPOCHS = 2              # the f32 run at --bs 2: one step an epoch
F32_ACCUMULATE = 2          # its num_cumulated_train_batches
REF_CONFIG = ("experiments/3d_inpainting/config/"
              "config_stinet_surfacetextureinpainting.json")


def _train_counters():
    """The launch counters of the train path's kernels: {key: (wrapper,
    counter attribute)}; keys as in capture_train_calls, K2's multi-graph
    launches apart."""
    from stinet_tpu_torch.ops import ell, norms, windowed
    k2 = norms.masked_instance_norm_kernel
    return {"k3a": (windowed.windowed_edge_conv_sum_kernel, "launches"),
            "k3c": (windowed.windowed_dq_kernel, "launches"),
            "k1": (ell.ell_edge_conv_sum_kernel, "launches"),
            "k1dp": (ell.ell_edge_conv_dp_kernel, "launches"),
            "k1dq": (ell.ell_edge_conv_dq_kernel, "launches"),
            "k2": (k2, "launches"), "k2mg": (k2, "multigraph_launches")}


class StepProbe:
    """Stands in for a trainer's train step: runs it, and records each
    call's kernel launches, a copy of its graph, its loss, its time by CUDA
    events and the accumulation's mini-step after it. On its first call it
    may hold the model and optimizer bitwise against a checkpoint file.
    Every other attribute is the step's."""

    def __init__(self, torch, step, model, optimizer, expect=None):
        self._torch, self._step = torch, step
        self._model, self._optimizer, self._expect = model, optimizer, expect
        self.launches, self.graphs, self.losses = [], [], []
        self.events, self.mini_steps = [], []

    def __getattr__(self, name):
        return getattr(self._step, name)

    def __call__(self, graph, lr):
        torch = self._torch
        from stinet_tpu_torch.graph.hierarchy import map_tensors
        if self._expect is not None:
            self._check_against(self._expect)
            self._expect = None
        self.graphs.append(map_tensors(graph, lambda t: t.clone()))
        counters = _train_counters()
        before = _read(counters)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        metrics = self._step(graph, lr)
        ev[1].record()
        after = _read(counters)
        self.launches.append({k: after[k] - before[k] for k in after})
        self.losses.append(metrics["loss"].detach())
        self.events.append(ev)
        self.mini_steps.append(self._step.mini_step)
        return metrics

    def _parts(self):
        """{checkpoint key: (model, optimizer)} the resume check reads."""
        return {"graph": (self._model, self._optimizer)}

    def _check_against(self, path):
        """The models' parameters and the optimizers' states bitwise those
        of the checkpoint file at `path`."""
        torch = self._torch
        from stinet_tpu_torch.core.checkpoint import load_checkpoint
        sds, opts, _, _ = load_checkpoint(path)
        for key, (model, optimizer) in self._parts().items():
            for k, v in model.state_dict().items():
                check(torch.equal(v.cpu(), sds[key][k]),
                      f"resumed {key} parameter {k} differs from {path}")
            got = optimizer.state_dict()["state"]
            want = opts[key]["state"]
            check(sorted(got) == sorted(want) and len(want) > 0,
                  f"resumed {key} optimizer state holds {len(got)} "
                  f"entries, the file {len(want)}")
            for i, st in want.items():
                for k, v in st.items():
                    check(torch.equal(got[i][k].cpu(), v),
                          f"resumed {key} Adam state {i}/{k} differs from "
                          f"{path}")

    def step_ms(self):
        return [a.elapsed_time(b) for a, b in self.events]


@contextlib.contextmanager
def probed_trainer(torch, expect=None):
    """While open, every Inpainting3DTrainer built takes a StepProbe for
    its train step, concatenated or stacked (yielded, in order of
    construction) and keeps a copy of its weights at each `model_best`
    save (`best_weights`)."""
    from stinet_tpu_torch.trainers import inpainting3d
    probes, best = [], {}
    makers = {name: getattr(inpainting3d, name) for name in (
        "make_inpainting_steps", "make_stacked_inpainting_steps")}
    save_best = inpainting3d.Inpainting3DTrainer._save_best

    def probed(make):
        def make_probed(model, optimizer, *args, **kw):
            step, eval_step = make(model, optimizer, *args, **kw)
            probes.append(StepProbe(torch, step, model, optimizer, expect))
            return probes[-1], eval_step
        return make_probed

    def save_best_kept(self, epoch):
        save_best(self, epoch)
        best.update(epoch=epoch, weights={
            k: v.detach().clone() for k, v in self.model.state_dict().items()})

    for name, make in makers.items():
        setattr(inpainting3d, name, probed(make))
    inpainting3d.Inpainting3DTrainer._save_best = save_best_kept
    try:
        yield probes, best
    finally:
        for name, make in makers.items():
            setattr(inpainting3d, name, make)
        inpainting3d.Inpainting3DTrainer._save_best = save_best


def write_trainer_scenes(root):
    """Loader-format flagship scenes (seeds 0-2) under the port's split
    lists' first names: 2 train scenes, 1 val scene. Returns the data
    roots and the val scene."""
    from stinet_tpu_torch.data.scannet import (
        SCANNET_TRAIN_FILE, SCANNET_VAL_FILE, read_split)
    from stinet_tpu_torch.utils.synthetic import (
        FLAGSHIP_SCENE, synthetic_scene, write_loader_scene)
    roots, seed = {}, 0
    for split, names in (("train", read_split(SCANNET_TRAIN_FILE)[:2]),
                         ("val", read_split(SCANNET_VAL_FILE)[:1])):
        roots[split] = str(root / split)
        for name in names:
            scene = synthetic_scene(**dict(FLAGSHIP_SCENE, seed=seed))
            write_loader_scene(roots[split], name, scene)
            seed += 1
    return roots, scene


def trainer_config(path, roots, save_dir, source, epochs, **loader_args):
    """A copy of the config file `source` with the data roots and save_dir
    repointed, `epochs` epochs, a checkpoint every epoch and `loader_args`
    set; written to `path`. Returns it."""
    cfg = json.loads(pathlib.Path(source).read_text())
    cfg["data_loader"]["args"].update(train_root_dir=roots["train"],
                                      val_root_dir=roots["val"],
                                      **loader_args)
    cfg["trainer"].update(save_dir=str(save_dir), epochs=epochs,
                          save_period=1)
    pathlib.Path(path).write_text(json.dumps(cfg))
    return cfg


def check_trainer_launches(torch, cfg, probe, device, trainer_cls=None):
    """Each train step's kernel launches equal the kernel calls a plain-path
    trainer's step (same config, same initial weights; an
    Inpainting3DTrainer unless `trainer_cls`) records on the same batch;
    returns the plain trainer's loss on the first batch."""
    from stinet_tpu_torch.core.config import ConfigParser
    from stinet_tpu_torch.trainers.inpainting3d import Inpainting3DTrainer
    plain = (trainer_cls or Inpainting3DTrainer)(
        ConfigParser(copy.deepcopy(cfg), dry_run=True), device=device,
        impl="plain")
    lr = plain.lr_fn(1)
    first = None
    for i, (graph, launched) in enumerate(zip(probe.graphs, probe.launches)):
        with record_calls(train_targets()) as calls:
            loss = float(plain._train_step(graph, lr)["loss"])
            torch.cuda.synchronize()
        first = loss if first is None else first
        want = {k: len(v) for k, v in calls.items()}
        got = dict(launched)
        got["k2"] += got.pop("k2mg")
        check(got == want, f"step {i}: launches {got} differ from the calls "
              f"a plain-path step records on its batch {want}")
    return first


def trainer_readings(phase, trainer, probe, card):
    """Print the run's trainer clock, loader build, placement wait, step
    time and peak memory, each with the card."""
    import torch
    per_epoch = [t["train_s"] * 1e3 / t["steps"]
                 for t in trainer.epoch_timings]
    waits = [w for t in trainer.epoch_timings for w in t["wait_ms"]]
    build = trainer.data_loader.train_loader.build_ms
    step = probe.step_ms()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fmt = ", ".join
    say(phase, f"trainer clock: ms/step by epoch (train loop time over "
        f"steps) {fmt(f'{x:.2f}' for x in per_epoch)}; on {card}")
    say(phase, f"loader build ms per train batch (prefetch thread) "
        f"{fmt(f'{x:.2f}' for x in build)}, median "
        f"{statistics.median(build):.2f}; on {card}")
    say(phase, "wait on iter_placed ms per step "
        f"{fmt(f'{x:.2f}' for x in waits)}, median "
        f"{statistics.median(waits):.2f}; on {card}")
    say(phase, f"step ms by CUDA events {fmt(f'{x:.2f}' for x in step)}, "
        f"median {statistics.median(step):.2f}; on {card}")
    say(phase, f"peak device memory {peak:.2f} GiB; on {card}")


def trainer_phase(torch, card):
    """The trainer phase: the port's CLI trains the production bf16 config
    (full width and depth, windowed) on fabricated flagship scenes, resumes
    it, evaluates it and serves its model_best; then trains the f32
    reference config at --bs 2 with gradient accumulation."""
    import os
    import tempfile
    from stinet_tpu_torch import train as cli
    from stinet_tpu_torch.serving import SceneInpainter
    from stinet_tpu_torch.models.factory import define_G
    counters = _train_counters()
    os.environ["STINET_DISABLE_GIT_TAG"] = "1"   # the runs tag no commit
    with tempfile.TemporaryDirectory(prefix="stinet_trainer_") as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        roots, val_scene = write_trainer_scenes(tmp)
        cfg = trainer_config(tmp / "bf16.json", roots, tmp / "saved",
                             BF16_CONFIG, TRAINER_EPOCHS)
        say("trainer", f"3 flagship scenes written in "
            f"{time.perf_counter() - t0:.1f} s; bf16 config: data roots and "
            f"save_dir repointed, epochs {TRAINER_EPOCHS}, save_period 1; "
            f"lr {cfg['optimizer']['args']['lr']}, the config's")

        # --- the loader alone, then the bf16 run
        from stinet_tpu_torch.data.scannet import ScanNetGraphColorDataLoader
        for way, flag in (("native", None), ("numpy", 0)):
            with env(STINET_NATIVE_BUILD=flag):
                alone = ScanNetGraphColorDataLoader(
                    cfg["data_loader"]["args"])
                for _ in alone.train_loader:
                    pass
            say("trainer", f"the loader alone, {way} builder (its prefetch "
                "thread, no step running): build ms per train batch "
                + ", ".join(f"{x:.2f}" for x in alone.train_loader.build_ms)
                + f"; on {card}")
            del alone
        _zero(counters)
        before = native_calls()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with probed_trainer(torch) as (probes, best):
            trainer = cli.main(["-c", str(tmp / "bf16.json"), "-d", "cuda",
                                "-n", "bf16"])
        launches = _read(counters)
        n_native = check_native("trainer", before)
        probe = probes[0]
        check(all(launches[k] > 0 for k in ("k3a", "k3c", "k1", "k1dp",
                                            "k1dq", "k2")),
              f"a kernel of the bf16 train path never launched: {launches}")
        losses = [float(x) for x in probe.losses]
        steps = len(losses)
        check(steps == 2 * TRAINER_EPOCHS, f"{steps} train steps")
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        first_epoch, last_epoch = (statistics.mean(losses[:2]),
                                   statistics.mean(losses[-2:]))
        check(last_epoch < first_epoch, f"epoch-mean train loss "
              f"{last_epoch} in the last epoch, {first_epoch} in the first")
        plain_first = check_trainer_launches(torch, cfg, probe, "cuda")
        rel = abs(losses[0] - plain_first) / abs(plain_first)
        check(rel <= TRAIN_TOL, f"first loss {losses[0]} vs the plain-path "
              f"trainer's {plain_first}: relative {rel:.3e} > {TRAIN_TOL}")
        run = trainer.checkpoint_dir
        names = [f"checkpoint-epoch{e}.ckpt"
                 for e in range(1, TRAINER_EPOCHS + 1)] + ["model_best.ckpt"]
        for name in names:
            for f in (run / name, run / (name + ".meta.json")):
                check(f.exists(), f"{f} was not written")
        say("trainer", f"bf16 run: {steps} steps, losses "
            f"{[round(x, 6) for x in losses]}; epoch-mean train loss "
            f"{first_epoch:.6f} -> {last_epoch:.6f}; first loss "
            f"{losses[0]:.6f} against the plain-path trainer's "
            f"{plain_first:.6f} (relative {rel:.2e}); native build calls "
            f"{n_native}; launches in the run {launches}; per step {probe.launches[0]}, each step equal to "
            f"the plain path's recorded calls; model_best at epoch "
            f"{best['epoch']}; {', '.join(names)} written")
        trainer_readings("trainer", trainer, probe, card)
        del trainer, probes

        # the same run on the numpy builder, for its readings
        with env(STINET_NATIVE_BUILD=0), probed_trainer(torch) as (probes, _):
            trainer = cli.main(["-c", str(tmp / "bf16.json"), "-d", "cuda",
                                "-n", "bf16-numpy"])
        trainer_readings("trainer-numpy", trainer, probes[0], card)
        del trainer, probes

        # --- resume from the last checkpoint for one more epoch
        last = run / f"checkpoint-epoch{TRAINER_EPOCHS}.ckpt"
        trainer_config(tmp / "bf16_more.json", roots, tmp / "saved",
                       BF16_CONFIG, TRAINER_EPOCHS + 1)
        with probed_trainer(torch, expect=last) as (probes, _):
            resumed = cli.main(["-c", str(tmp / "bf16_more.json"), "-r",
                                str(last), "-d", "cuda", "-n", "resume"])
        epochs = [t["epoch"] for t in resumed.epoch_timings]
        check(epochs == [TRAINER_EPOCHS + 1], f"resumed epochs {epochs}")
        check(all(math.isfinite(float(x)) for x in probes[0].losses),
              "non-finite resumed loss")
        say("trainer", f"resume from {last.name}: epoch {epochs[0]} ran; "
            "parameters and Adam state bitwise the file's before its first "
            f"step; losses {[round(float(x), 6) for x in probes[0].losses]}")
        del resumed, probes

        # --- eval mode and serving from model_best
        best_path = run / "model_best.ckpt"
        evaluator = cli.main(["-r", str(best_path), "-e", "valid", "-d",
                              "cuda", "-n", "eval"])
        result = evaluator.valid_metrics.result()
        check(all(math.isfinite(v) for v in result.values()),
              f"eval metrics {result}")
        say("trainer", "eval -e valid -r model_best.ckpt: " + ", ".join(
            f"{k} {v:.6f}" for k, v in result.items()))
        del evaluator
        args = cfg["archs"]["SurfaceTextureInpaintingNet"]["args"]
        served = SceneInpainter.from_checkpoint(best_path, val_scene,
                                                device="cuda", windowed=True)
        direct = SceneInpainter(define_G(**args), best["weights"],
                                device="cuda", windowed=True)
        out = served.predict(val_scene)
        err = float(abs(out - direct.predict(val_scene)).max())
        check(out.shape == (val_scene.num_vertices[0], 3), f"{out.shape}")
        check(err <= PATH_TOL, f"from_checkpoint vs the trainer's weights: "
              f"max |diff| {err:.3e} > {PATH_TOL}")
        say("trainer", f"from_checkpoint(model_best) serves the flagship "
            f"scene windowed, {list(out.shape)}; against a server of the "
            f"trainer's in-memory weights max |diff| {err:.3e}")
        del served, direct

        # --- the f32 reference config at --bs 2 with accumulation
        f32 = trainer_config(tmp / "f32.json", roots, tmp / "saved",
                             REF_CONFIG, F32_EPOCHS,
                             num_cumulated_train_batches=F32_ACCUMULATE)
        _zero(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with probed_trainer(torch) as (probes, _):
            trainer = cli.main(["-c", str(tmp / "f32.json"), "-d", "cuda",
                                "-n", "f32", "--bs", "2"])
        launches = _read(counters)
        probe = probes[0]
        check(all(launches[k] > 0 for k in ("k1", "k1dp", "k1dq", "k2",
                                            "k2mg")),
              f"a kernel of the f32 train path never launched: {launches}")
        check(launches["k3a"] == launches["k3c"] == 0,
              f"windowed kernels on the f32 ELL path: {launches}")
        check(probe.mini_steps == [1, 0], f"accumulation mini-steps "
              f"{probe.mini_steps}, expected [1, 0]")
        check_trainer_launches(torch, f32, probe, "cuda")
        losses = [float(x) for x in probe.losses]
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        say("trainer", f"f32 run at --bs 2, accumulation "
            f"{F32_ACCUMULATE} (one optimizer step, after the second "
            f"epoch's batch), full depth: losses "
            f"{[round(x, 6) for x in losses]}; launches {launches}; per step "
            f"{probe.launches}, equal to the plain path's recorded calls")
        trainer_readings("trainer-f32", trainer, probe, card)


# --- the segmentation workload -----------------------------------------------

SEG_CONFIG = ("experiments/semantic_segmentation/config/"
              "config_scmnet_segmentation.json")
SEG_EPOCHS = 3              # epochs of the segmentation run (2 crops each)
SEG_SCENE = dict(num_vertices=65536, levels=4, dilation_dists=())
SEG_TOL = 1e-3              # card vs CPU step: loss, logits, statistics
SEG_STATS_TOL = 1e-6        # a running statistic against its one update
SEG_STEP_REPS = 5           # timed bare steps, traced steps, eval calls


def write_segmentation_scenes(root):
    """Label scenes at ScanNet crop scale (`SEG_SCENE`, seeds 0-2) with
    `labels_0` over 0..20 from a seeded numpy generator: 2 training crops
    (`<train scene>_0`; a crop stores no original-mesh trace, so its
    traces_l maps level l to l + 1) and 1 val scene, uncropped (traces_0
    maps its original vertices to level 0). Returns the data roots."""
    import numpy as np
    from stinet_tpu_torch.data.scannet import (
        SCANNET_TRAIN_FILE, SCANNET_VAL_FILE, read_split)
    from stinet_tpu_torch.utils.synthetic import (
        synthetic_scene, write_loader_scene)
    roots, seed = {}, 0
    for split, names in (("train", read_split(SCANNET_TRAIN_FILE)[:2]),
                         ("val", read_split(SCANNET_VAL_FILE)[:1])):
        roots[split] = str(root / split)
        for name in names:
            crop = split == "train"
            name = f"{name}_0" if crop else name
            write_loader_scene(roots[split], name, synthetic_scene(
                **dict(SEG_SCENE, seed=seed)))
            path = pathlib.Path(roots[split]) / "graphs" / f"{name}.npz"
            arrays = dict(np.load(path))
            levels = int(arrays["num_levels"])
            if crop:
                for l in range(levels - 1):
                    arrays[f"traces_{l}"] = arrays[f"traces_{l + 1}"]
                del arrays[f"traces_{levels - 1}"]
            arrays["labels_0"] = np.random.default_rng(100 + seed).integers(
                0, 21, size=len(arrays["vertices_0"]))
            np.savez(path, **arrays)
            seed += 1
    return roots


class SegStepProbe:
    """Stands in for a segmentation trainer's train step: runs it, and
    records each call's loss and time by CUDA events, and checks that
    every masked batch norm moved its running statistics once, by one
    update from the statistics of the call's first forward (the backward
    recomputes the checkpointed blocks; their norms must not move again).
    On its first call it may hold the model and optimizer bitwise against
    a checkpoint file. Every other attribute is the step's."""

    def __init__(self, torch, step, model, optimizer, expect=None):
        from stinet_tpu_torch.models.singleconvmeshnet import (
            _MaskedEdgeBatchNorm)
        from stinet_tpu_torch.models.stinet import is_recomputing
        self._torch, self._step = torch, step
        self._model, self._optimizer, self._expect = model, optimizer, expect
        self.losses, self.events, self.recomputed = [], [], []
        self._norms = {n: m for n, m in model.named_modules()
                       if isinstance(m, _MaskedEdgeBatchNorm)}
        self._seen = {}

        def hook(module, args, _out, name=None):
            if not module.training:
                return
            if is_recomputing():
                self._seen[name][1] += 1
                return
            m, mask = args
            with torch.no_grad():
                w = mask[:, None]
                n = torch.clamp(mask.sum(), min=1.0)
                mean = (m * w).sum(0) / n
                var = (((m - mean) * w) ** 2).sum(0) / n
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
            self._seen[name][0].append((mean, unbiased))

        self._hooks = [mod.register_forward_hook(
            lambda mod, a, o, name=name: hook(mod, a, o, name))
            for name, mod in self._norms.items()]

    def remove_hooks(self):
        for h in self._hooks:
            h.remove()

    def __getattr__(self, name):
        return getattr(self._step, name)

    def __call__(self, graph, lr):
        torch = self._torch
        if self._expect is not None:
            self._check_against(self._expect)
            self._expect = None
        old = {n: (m.running_mean.clone(), m.running_var.clone())
               for n, m in self._norms.items()}
        self._seen = {n: [[], 0] for n in self._norms}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        metrics, conf = self._step(graph, lr)
        ev[1].record()
        step = len(self.losses)
        for n, m in self._norms.items():
            firsts, again = self._seen[n]
            check(len(firsts) == 1, f"step {step}: {n} normalized "
                  f"{len(firsts)} first forwards")
            (mean, var), k = firsts[0], m.momentum
            for got, was, stat in ((m.running_mean, old[n][0], mean),
                                   (m.running_var, old[n][1], var)):
                want = (1 - k) * was + k * stat
                err = float((got - want).abs().max())
                check(err <= SEG_STATS_TOL * (1 + float(want.abs().max())),
                      f"step {step}: {n}'s running statistics are not one "
                      f"update from its first forward: max |diff| {err}")
        self.recomputed.append(sum(v[1] for v in self._seen.values()))
        self.losses.append(metrics["loss"].detach())
        self.events.append(ev)
        return metrics, conf

    def _check_against(self, path):
        """The model's state (buffers included) and the optimizer's state
        bitwise those of the checkpoint file at `path`."""
        torch = self._torch
        from stinet_tpu_torch.core.checkpoint import load_checkpoint
        sds, opts, _, _ = load_checkpoint(path)
        for k, v in self._model.state_dict().items():
            check(torch.equal(v.cpu(), sds["seg"][k]),
                  f"resumed state {k} differs from {path}")
        got = self._optimizer.state_dict()["state"]
        want = opts["seg"]["state"]
        check(sorted(got) == sorted(want) and len(want) > 0,
              f"resumed optimizer state holds {len(got)} entries, the file "
              f"{len(want)}")
        for i, st in want.items():
            for k, v in st.items():
                check(torch.equal(got[i][k].cpu(), v),
                      f"resumed Adam state {i}/{k} differs from {path}")

    def step_ms(self):
        return [a.elapsed_time(b) for a, b in self.events]


@contextlib.contextmanager
def probed_steps(torch, trainer_cls, factory, probe_cls, expect=None):
    """While open, every `trainer_cls` built takes a `probe_cls` for the
    train step that `factory` (a step maker in the trainer's module) makes,
    and each `_train_epoch` log is kept: yields (probes, logs)."""
    module = sys.modules[trainer_cls.__module__]
    probes, logs = [], []
    make = getattr(module, factory)
    epoch = trainer_cls._train_epoch

    def make_probed(model, optimizer, *args, **kw):
        step, eval_step = make(model, optimizer, *args, **kw)
        probes.append(probe_cls(torch, step, model, optimizer, expect))
        return probes[-1], eval_step

    def epoch_kept(self, e):
        logs.append(epoch(self, e))
        return logs[-1]

    setattr(module, factory, make_probed)
    trainer_cls._train_epoch = epoch_kept
    try:
        yield probes, logs
    finally:
        setattr(module, factory, make)
        trainer_cls._train_epoch = epoch


def probed_segmentation(torch, expect=None):
    """`probed_steps` for GraphSegmentationTrainer's SegStepProbe."""
    from stinet_tpu_torch.trainers.segmentation import (
        GraphSegmentationTrainer)
    return probed_steps(torch, GraphSegmentationTrainer,
                        "make_segmentation_steps", SegStepProbe, expect)


def seg_card_against_cpu(torch, trainer, graph):
    """One train step from the trainer's weights on `graph` (host tensors)
    on the card and on the CPU, each with a fresh Adam: the loss, the
    logits, the confusion matrix and the new running statistics. Returns
    a summary line."""
    from stinet_tpu_torch.models.singleconvmeshnet import SingleConvMeshNet
    from stinet_tpu_torch.trainers.segmentation import (
        make_segmentation_steps)
    from stinet_tpu_torch.trainers.graph_common import build_optimizer
    args = trainer.config["archs"]["SingleConvMeshNet"]["args"]
    weights = {k: v.detach().cpu().clone()
               for k, v in trainer.model.state_dict().items()}
    runs = {}
    for device in ("cuda", "cpu"):
        model = SingleConvMeshNet(**args).to(device)
        model.load_state_dict(weights)
        logits = []
        model.register_forward_hook(
            lambda m, a, out: logits.append(out.detach().cpu()))
        opt, lr = build_optimizer(model.parameters(),
                                  trainer.config["optimizer"])
        step, _ = make_segmentation_steps(
            model, opt, trainer.class_weights.to(device),
            trainer.num_classes)
        t0 = time.perf_counter()
        metrics, conf = step(graph.to(device), lr)
        loss = float(metrics["loss"])
        runs[device] = dict(
            loss=loss, logits=logits[0], conf=conf.cpu(),
            s=time.perf_counter() - t0,
            stats={k: v.detach().cpu() for k, v in model.state_dict().items()
                   if "running" in k})
    card, cpu = runs["cuda"], runs["cpu"]
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    check(loss_rel <= SEG_TOL, f"card loss {card['loss']} vs CPU "
          f"{cpu['loss']}: relative {loss_rel:.3e} > {SEG_TOL}")
    nv = int(graph.levels[0].num_vertices)
    scale = float(cpu["logits"][:nv].abs().max())
    logit_err = float((card["logits"][:nv] - cpu["logits"][:nv]).abs().max())
    check(logit_err <= SEG_TOL * scale, f"card logits vs CPU: max |diff| "
          f"{logit_err:.3e} > {SEG_TOL} x {scale:.3f}")
    # a vertex can take the other class only where its top two logits lie
    # within twice the largest logit difference of each other
    top2 = cpu["logits"][:nv].topk(2, dim=-1).values
    close = int(((top2[:, 0] - top2[:, 1]) <= 2 * logit_err).sum())
    moved = int((card["conf"] - cpu["conf"]).abs().sum()) // 2
    check(moved <= close, f"confusion matrices differ by {moved} vertices; "
          f"{close} have top two logits within {2 * logit_err:.3e}")
    stat_err = max(float((card["stats"][k] - v).abs().max())
                   for k, v in cpu["stats"].items())
    stat_scale = max(float(v.abs().max()) for v in cpu["stats"].values())
    check(stat_err <= SEG_TOL * stat_scale, f"running statistics card vs "
          f"CPU: max |diff| {stat_err:.3e} > {SEG_TOL} x {stat_scale:.3f}")
    return (f"card vs CPU, one step from the trainer's weights: loss "
            f"{card['loss']:.6f} vs {cpu['loss']:.6f} (relative "
            f"{loss_rel:.2e}); logits max |diff| {logit_err:.3e} of "
            f"{scale:.3f}; confusion matrices apart by {moved} vertices "
            f"({close} with top two logits within twice that); running "
            f"statistics "
            f"max |diff| {stat_err:.3e} of {stat_scale:.3f}; tolerance "
            f"{SEG_TOL} relative; CPU step {cpu['s']:.1f} s")


def bare_step(torch, phase, trainer, graph, card, unit="scene", per=1):
    """The trainer's model and optimizer on one placed graph: a train step
    by CUDA events split into forward, backward and optimizer, its peak
    device memory, the eval step (ms a `unit`, `per` of them a graph), and
    one traced step (`traced_steps`). Returns the median step ms."""
    from stinet_tpu_torch.serving import full_f32_matmuls
    step = trainer._train_step
    step = getattr(step, "_step", step)
    model, opt = trainer.model, trainer.optimizer

    def parts():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        model.train()
        with full_f32_matmuls():
            opt.zero_grad(set_to_none=True)
            ev[0].record()
            loss, _ = step.loss_of(graph)
            ev[1].record()
            loss.backward()
            ev[2].record()
            opt.step()
            ev[3].record()
        return ev

    split, peak = timed_parts(torch, parts)
    total = [sum(x) for x in zip(*split)]
    eval_ms = median_ms(torch, lambda: trainer._eval_step(graph),
                        reps=SEG_STEP_REPS, inner=1, warmup=1) / per
    med = statistics.median
    say(phase, f"bare train step by CUDA events, median of "
        f"{SEG_STEP_REPS}: {med(total):.2f} ms = forward {med(split[0]):.2f}"
        f" + backward {med(split[1]):.2f} + optimizer {med(split[2]):.2f};"
        f" peak device memory {peak:.2f} GiB; eval step {eval_ms:.2f} "
        f"ms/{unit}; on {card}")
    traced_steps(torch, phase, parts, card, "train step")
    return med(total)


def timed_parts(torch, parts):
    """Run `parts` (one step, recording CUDA events between its parts) 2
    times untimed, then SEG_STEP_REPS times: (per part, the ms of each
    run; the peak device memory of those runs in GiB)."""
    for _ in range(2):
        parts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = [parts() for _ in range(SEG_STEP_REPS)]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return ([[ev[i].elapsed_time(ev[i + 1]) for ev in runs]
             for i in range(len(runs[0]) - 1)], peak)


def traced_steps(torch, phase, step, card, what):
    """SEG_STEP_REPS calls of `step` untimed by CUDA events, then the same
    traced (torch.profiler): device busy ms, launches, idle share and the
    top 8 ops by device time, a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from stinet_tpu_torch.utils.profile_forward import _self_device_us

    def steps():
        for _ in range(SEG_STEP_REPS):
            step()

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    steps()
    end.record()
    end.synchronize()
    wall = start.elapsed_time(end) / SEG_STEP_REPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(_self_device_us(e) for e in kernels) / 1e3 / SEG_STEP_REPS
    check(busy > 0, "the profiler recorded no device time")
    launches = sum(e.count for e in kernels) / SEG_STEP_REPS
    say(phase, f"traced {what} ({SEG_STEP_REPS} calls): "
        f"{busy:.3f} ms device busy, {launches:.0f} kernel launches, idle "
        f"share {max(0.0, 1 - busy / wall):.1%} of the untraced "
        f"{wall:.3f} ms; on {card}")
    for e in sorted(kernels, key=_self_device_us, reverse=True)[:8]:
        ms = _self_device_us(e) / 1e3 / SEG_STEP_REPS
        say(phase, f"  top {ms:8.3f} ms x{e.count // SEG_STEP_REPS:4d}"
            f"  {e.key[:100]}")


def segmentation_phase(torch, card):
    """The segmentation phase: the port's CLI trains the shipped
    segmentation config (full width) on fabricated label scenes, resumes
    it and evaluates it; one step is held against the CPU."""
    import os
    import tempfile
    from stinet_tpu_torch import train as cli
    from stinet_tpu_torch.graph.build import build_hierarchical_graph
    os.environ["STINET_DISABLE_GIT_TAG"] = "1"
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="stinet_seg_") as tmp:
        tmp = pathlib.Path(tmp)
        roots = write_segmentation_scenes(tmp)
        cfg = trainer_config(tmp / "seg.json", roots, tmp / "saved",
                             SEG_CONFIG, SEG_EPOCHS)
        args = cfg["archs"]["SingleConvMeshNet"]["args"]
        say("segmentation", f"3 label scenes written ({SEG_SCENE}; 2 "
            f"crops, 1 full val scene) in {time.perf_counter() - t_phase:.1f}"
            f" s; {SEG_CONFIG}: filter_sizes {args['filter_sizes']}, "
            f"{args['num_propagation_steps']} steps a block, end_level "
            f"{cfg['data_loader']['args']['end_level']}; data roots and "
            f"save_dir repointed, epochs {SEG_EPOCHS}, save_period 1")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with probed_segmentation(torch) as (probes, logs):
            trainer = cli.main(["-c", str(tmp / "seg.json"), "-d", "cuda",
                                "-n", "seg"])
        probe = probes[0]
        tensors = list(trainer.model.parameters()) + list(
            trainer.model.buffers())
        check(all(t.is_cuda for t in tensors),
              "a parameter or buffer of the model is not on the card")
        losses = [float(x) for x in probe.losses]
        check(len(losses) == 2 * SEG_EPOCHS, f"{len(losses)} train steps")
        check(len(logs) == SEG_EPOCHS, f"{len(logs)} epoch logs")
        for log in logs:
            for k in ("loss", "val_loss"):
                check(math.isfinite(log[k]), f"epoch log {k} {log[k]}")
            check("val_full_scene_mean_iou" in log,
                  f"no full-scene IoU in the epoch log {sorted(log)}")
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        check(min(probe.recomputed) > 0, "no checkpointed block recomputed")
        run = trainer.checkpoint_dir
        for e in range(1, SEG_EPOCHS + 1):
            check((run / f"checkpoint-epoch{e}.ckpt").exists(),
                  f"checkpoint-epoch{e}.ckpt was not written")
        check((run / "model_best.ckpt").exists(), "no model_best.ckpt")
        probe.remove_hooks()
        say("segmentation", f"CLI run: {len(losses)} steps, losses "
            f"{[round(x, 6) for x in losses]}; every norm's running "
            f"statistics one update a step ({probe.recomputed[0]} recomputed"
            " norm calls a step left them alone); epoch logs "
            + "; ".join(", ".join(f"{k} {log[k]:.4f}" for k in (
                "loss", "mean_iou", "val_loss", "val_mean_iou",
                "val_full_scene_mean_iou")) for log in logs))
        trainer_readings("segmentation", trainer, probe, card)

        sample = trainer.data_loader.train_dataset[0]
        graph = build_hierarchical_graph(
            [sample], pad_multiple=trainer.data_loader.train_loader
            .pad_multiple, geometric=True)
        say("segmentation", seg_card_against_cpu(torch, trainer, graph))
        bare_step(torch, "segmentation", trainer, graph.to("cuda"), card)
        del trainer, probes

        last = run / f"checkpoint-epoch{SEG_EPOCHS}.ckpt"
        trainer_config(tmp / "seg_more.json", roots, tmp / "saved",
                       SEG_CONFIG, SEG_EPOCHS + 1)
        with probed_segmentation(torch, expect=last) as (probes, logs):
            resumed = cli.main(["-c", str(tmp / "seg_more.json"), "-r",
                                str(last), "-d", "cuda", "-n", "resume"])
        epochs = [t["epoch"] for t in resumed.epoch_timings]
        check(epochs == [SEG_EPOCHS + 1], f"resumed epochs {epochs}")
        check(all(math.isfinite(float(x)) for x in probes[0].losses),
              "non-finite resumed loss")
        probes[0].remove_hooks()
        say("segmentation", f"resume from {last.name}: epoch {epochs[0]} "
            "ran; state and Adam state bitwise the file's before its first "
            f"step; losses {[round(float(x), 6) for x in probes[0].losses]}")
        del resumed, probes

        t0 = time.perf_counter()
        evaluator = cli.main(["-r", str(run / "model_best.ckpt"), "-e",
                              "valid", "-d", "cuda", "-n", "eval"])
        eval_s = time.perf_counter() - t0
        result = evaluator.valid_metrics.result()
        check(all(math.isfinite(v) for v in result.values()),
              f"eval metrics {result}")
        say("segmentation", f"-e valid -r model_best.ckpt: {result}; "
            f"{eval_s:.2f} s for {len(evaluator.data_loader.val_dataset)} "
            f"scene(s), the trainer's construction included")
        del evaluator
    say("segmentation", f"phase wall time {time.perf_counter() - t_phase:.1f}"
        f" s; on {card}")


# --- the 2D texture-inpainting workload, graph branch -------------------------

INP2D_CONFIG = ("experiments/2d_inpainting/config/"
                "config_stinet_imageinpainting_hermetic.json")
INP2D_EPOCHS = 2            # epochs of the 2D run (the config: 2000)
INP2D_FID_EVERY = 2         # its epochs_per_fid (the config: 5)
PERCEPTUAL_TOL = 1e-4       # LPIPS and InceptionV3, card vs CPU, relative
INP2D_GRAD_TOL = 1e-3       # all gradients, kernel vs plain path, L2 relative


def probed_2d(torch, expect=None):
    """`probed_steps` for Inpainting2DTrainer's StepProbe."""
    from stinet_tpu_torch.trainers.inpainting2d import Inpainting2DTrainer
    return probed_steps(torch, Inpainting2DTrainer, "make_inpainting2d_steps",
                        StepProbe, expect)


def grads_2d(torch, trainer, graph, vgraph=None, impl=None):
    """One forward and backward of the trainer's loss on the placed batch
    `graph` by a copy of the trainer's model on `impl`'s path, then one
    eval step on the val batch `vgraph` where one is given: (loss,
    {parameter name: gradient})."""
    from stinet_tpu_torch.serving import full_f32_matmuls
    from stinet_tpu_torch.trainers.inpainting2d import make_inpainting2d_steps
    model = copy.deepcopy(trainer.model)
    for p in model.parameters():
        p.grad = None
    step, eval_step = make_inpainting2d_steps(
        model, None, trainer.img_size,
        tv_weight=(trainer.total_variation_weight
                   if trainer.use_total_variation else None),
        vgg=trainer.vgg_loss,
        vgg_weights=(trainer.vgg_content_weight, trainer.vgg_style_weight),
        impl=impl)
    model.train()
    with full_f32_matmuls():
        loss, _ = step.loss_of(graph)
        loss.backward()
    if vgraph is not None:
        eval_step(vgraph)
    torch.cuda.synchronize()
    return float(loss.detach()), {n: p.grad
                                  for n, p in model.named_parameters()}


def check_2d_grads(kernel, plain):
    """The kernel path's loss and gradients (`grads_2d`) against the plain
    path's, from the same weights on the same batch: the loss within
    TRAIN_TOL, every parameter's gradient taken together as one vector
    within INP2D_GRAD_TOL of its L2 norm. Element by element the paths
    part by more: an f32 relu or max pool within rounding of a tie sends
    an element's gradient the other way, and a bias ahead of an instance
    norm has a gradient of rounding size (the norm cancels it). Returns a
    summary line."""
    (k_loss, k_grads), (p_loss, p_grads) = kernel, plain
    rel = abs(k_loss - p_loss) / abs(p_loss)
    check(rel <= TRAIN_TOL, f"kernel path loss {k_loss} vs plain path "
          f"{p_loss}: relative {rel:.3e} > {TRAIN_TOL}")
    check(sorted(k_grads) == sorted(p_grads)
          and all(g is not None for g in p_grads.values())
          and all(g is not None for g in k_grads.values()),
          "a parameter has no gradient on one of the paths")
    diff = math.sqrt(sum(float((k_grads[k] - g).double().norm()) ** 2
                         for k, g in p_grads.items()))
    norm = math.sqrt(sum(float(g.double().norm()) ** 2
                         for g in p_grads.values()))
    check(diff <= INP2D_GRAD_TOL * norm, f"gradients, kernel vs plain "
          f"path: L2 of the difference {diff:.3e} > {INP2D_GRAD_TOL} x "
          f"{norm:.3e}")
    per = [float((k_grads[k] - g).abs().max())
           / max(float(g.abs().max()), 1e-30) for k, g in p_grads.items()]
    return (f"one forward and backward from the trainer's weights, kernel "
            f"vs plain path: loss {k_loss:.6f} vs {p_loss:.6f} (relative "
            f"{rel:.2e}); the {len(per)} parameters' gradients as one "
            f"vector apart by {diff / norm:.3e} of its L2 norm (tolerance "
            f"{INP2D_GRAD_TOL}); per parameter, max |diff| over the largest"
            f" element: median {statistics.median(per):.3e}")


def check_2d_kernels(torch, calls, num_graphs):
    """Every K1, dp, dq and K2 call recorded on the plain path of
    `grads_2d` (`record_calls(train_targets())`), on its kernel and on its
    plain version with the same inputs: K1, dp and dq bit for bit, K2
    within K2_RTOL/K2_ATOL with its pad rows 0, both as the train step
    calls it (`num_graphs` graphs) and as the eval step does (one).
    Returns a summary line."""
    from stinet_tpu_torch.ops import ell, norms
    check(not calls["k3a"] and not calls["k3c"],
          "windowed kernel calls on the 2D path")
    shapes = {}
    for key, kernel, plain in (
            ("k1", ell.ell_edge_conv_sum_kernel, ell.ell_edge_conv_sum_plain),
            ("k1dp", ell.ell_edge_conv_dp_kernel, ell.ell_edge_conv_dp_plain),
            ("k1dq", ell.ell_edge_conv_dq_kernel, ell.ell_edge_conv_dq_plain)):
        check(len(calls[key]) > 0, f"no {key} call on the 2D path")
        for i, args in enumerate(calls[key]):
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            (v, h), d = args[0].shape, args[3 if key == "k1dq" else 2].shape[1]
            check(got.dtype == want.dtype == torch.float32
                  and torch.equal(got.view(torch.int32),
                                  want.view(torch.int32)),
                  f"2D {key} call {i} V={v} H={h} D={d}: kernel and plain "
                  "version differ")
            shapes.setdefault(key, set()).add((v, h, d))
    graphs, err = {}, 0.0
    for i, (x, gid, ng, nv, eps) in enumerate(calls["k2"]):
        ng, n = int(ng), int(nv)
        got = norms.masked_instance_norm_kernel(
            x, nv, eps, gid if ng > 1 else None, ng)
        want = norms.masked_instance_norm_plain(x, gid, ng, nv, eps)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=K2_RTOL, atol=K2_ATOL),
              f"2D K2 call {i} {tuple(x.shape)} G={ng}: max |diff| {e:.3e} "
              f"exceeds rtol {K2_RTOL} / atol {K2_ATOL}")
        check(torch.all(got[n:] == 0).item(), f"2D K2 call {i}: pad rows "
              "not 0")
        err = max(err, e)
        graphs[ng] = graphs.get(ng, 0) + 1
    check(sorted(graphs) == sorted({1, num_graphs}),
          f"K2 calls by graphs a call {graphs}: the train step's have "
          f"{num_graphs}, the eval step's 1")
    return ("plain-path train step (forward and backward) and eval step, "
            "each kernel call held against its plain version on the same "
            "inputs: " + "; ".join(
                f"{key} {len(calls[key])} calls bitwise at (V, H, D) "
                f"{sorted(shapes[key])}" for key in ("k1", "k1dp", "k1dq"))
            + f"; K2 {len(calls['k2'])} calls ({graphs[num_graphs]} of "
            f"{num_graphs} graphs, {graphs[1]} of one) within rtol "
            f"{K2_RTOL} / atol {K2_ATOL}, max |diff| {err:.3e}")


def perceptual_card_against_cpu(torch, trainer, graph, card):
    """The trainer's LPIPS and InceptionV3 on the card (TF32 off) against
    copies of them on the CPU, on the same images (a batch's ground truth
    and a shifted copy): relative error of the distances and of the pool3
    features over their largest. Also the LPIPS call's time by CUDA
    events. Returns the LPIPS ms."""
    from stinet_tpu_torch.serving import full_f32_matmuls
    n = graph.num_graphs
    gt = trainer._images(graph.color, n)
    other = torch.roll(gt, shifts=7, dims=2)
    with full_f32_matmuls(), torch.no_grad():
        check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
        card_d = trainer.lpips(gt, other).cpu()
        card_f = trainer.inception(gt / 2.0 + 0.5).cpu()
        lpips_ms = median_ms(torch, lambda: trainer.lpips(gt, other),
                             reps=SEG_STEP_REPS, inner=1, warmup=1)
    cpu_d = copy.deepcopy(trainer.lpips).cpu()(gt.cpu(), other.cpu())
    with torch.no_grad():
        cpu_f = copy.deepcopy(trainer.inception).cpu()(gt.cpu() / 2 + 0.5)
    d_err = float(((card_d - cpu_d).abs() / cpu_d.abs()).max())
    f_err = float((card_f - cpu_f).abs().max() / cpu_f.abs().max())
    check(d_err <= PERCEPTUAL_TOL and f_err <= PERCEPTUAL_TOL,
          f"perceptual nets, card vs CPU: LPIPS relative {d_err:.3e}, "
          f"Inception {f_err:.3e} of the largest feature > {PERCEPTUAL_TOL}")
    say("inpainting2d", f"card vs CPU on {n} images: LPIPS "
        f"{[round(float(x), 6) for x in card_d]} relative {d_err:.3e}; "
        f"InceptionV3 pool3 {list(card_f.shape)} max |diff| {f_err:.3e} of "
        f"the largest; TF32 off (cuDNN and matmuls); LPIPS call "
        f"{lpips_ms:.3f} ms by CUDA events on {card}")
    return lpips_ms


def inpainting2d_phase(torch, card):
    """The 2D phase: the port's CLI trains the hermetic 2D config (STINet
    over image grid graphs, full width) with LPIPS and FID on random
    features, resumes it and evaluates it.

    Cuts, against the shipped hermetic config: `root_dir` an empty
    temporary directory, so the loader synthesizes 32 train textures (8
    steps an epoch at B=4) and 8 val textures; `save_dir` repointed;
    INP2D_EPOCHS epochs, then one more resumed (the config: 2000);
    `epochs_per_fid` INP2D_FID_EVERY (the config: 5), so FID runs once,
    at the last epoch, for train and val; a checkpoint every epoch;
    `tensorboard` as the config sets it, as in phase 8."""
    import os
    import tempfile
    from stinet_tpu_torch import train as cli
    from stinet_tpu_torch.trainers.inpainting2d import Inpainting2DTrainer
    os.environ["STINET_DISABLE_GIT_TAG"] = "1"
    t_phase = time.perf_counter()
    counters = _train_counters()
    with tempfile.TemporaryDirectory(prefix="stinet_2d_") as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "textures").mkdir()
        cfg = json.loads(pathlib.Path(INP2D_CONFIG).read_text())
        cfg["data_loader"]["args"]["root_dir"] = str(tmp / "textures")
        cfg["trainer"].update(save_dir=str(tmp / "saved"),
                              epochs=INP2D_EPOCHS, save_period=1,
                              epochs_per_fid=INP2D_FID_EVERY)
        (tmp / "2d.json").write_text(json.dumps(cfg))
        args = cfg["archs"]["SurfaceTextureInpaintingNet"]["args"]
        dl = cfg["data_loader"]["args"]
        say("inpainting2d", f"{INP2D_CONFIG}: ngf {args['ngf']}, "
            f"{args['n_blocks']} blocks, {args['filter_type']}, img_size "
            f"{dl['img_size']}, end_level {dl['end_level']}, batch "
            f"{dl['train_batch_size']}; root_dir empty (synthesized "
            f"textures), save_dir repointed, epochs {INP2D_EPOCHS}, "
            f"epochs_per_fid {INP2D_FID_EVERY}, save_period 1")

        _zero(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with probed_2d(torch) as (probes, logs):
            trainer = cli.main(["-c", str(tmp / "2d.json"), "-d", "cuda",
                                "-n", "2d"])
        launches = _read(counters)
        probe = probes[0]
        # before the plain-path trainer below raises the peak
        trainer_readings("inpainting2d", trainer, probe, card)
        check(all(launches[k] > 0 for k in ("k1", "k1dp", "k1dq", "k2mg",
                                            "k2")),
              f"a kernel of the 2D path never launched: {launches}")
        check(launches["k3a"] == launches["k3c"] == 0,
              f"windowed kernels on the 2D path: {launches}")
        losses = [float(x) for x in probe.losses]
        steps_a_epoch = len(trainer.data_loader.train_loader)
        check(len(losses) == INP2D_EPOCHS * steps_a_epoch,
              f"{len(losses)} train steps")
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        tag = trainer.lpips_tag
        for log in logs:
            for k in ("loss", tag, "val_loss", "val_" + tag):
                check(math.isfinite(log[k]), f"epoch log {k} {log[k]}")
        for k in ("train_fid_random_features", "val_fid_random_features"):
            check(math.isfinite(logs[-1].get(k, math.nan)),
                  f"epoch {INP2D_EPOCHS} {k}: {logs[-1].get(k)}")
        plain_first = check_trainer_launches(torch, cfg, probe, "cuda",
                                             Inpainting2DTrainer)
        rel = abs(losses[0] - plain_first) / abs(plain_first)
        check(rel <= TRAIN_TOL, f"first loss {losses[0]} vs the plain-path "
              f"trainer's {plain_first}: relative {rel:.3e} > {TRAIN_TOL}")
        run = trainer.checkpoint_dir
        names = [f"checkpoint-epoch{e}.ckpt"
                 for e in range(1, INP2D_EPOCHS + 1)] + ["model_best.ckpt"]
        for name in names:
            for f in (run / name, run / (name + ".meta.json")):
                check(f.exists(), f"{f} was not written")
        say("inpainting2d", f"CLI run: {len(losses)} steps, losses "
            f"{[round(x, 6) for x in losses]}; first loss against the "
            f"plain-path trainer's {plain_first:.6f} (relative {rel:.2e}); "
            f"launches in the run (train, FID and validation) {launches}; "
            f"per step {probe.launches[0]}, each step equal to the plain "
            f"path's recorded calls; {', '.join(names)} written; epoch logs "
            + "; ".join(", ".join(f"{k} {log[k]:.6g}" for k in log
                                  if k != "lr") for log in logs))
        for t in trainer.fid_timings:
            say("inpainting2d", f"FID epoch {t['epoch']} {t['split']}: "
                f"{t['features_s']:.3f} s eval steps and InceptionV3 "
                f"forwards to the host copy, {t['distance_s']:.3f} s host "
                f"statistics and sqrtm (scipy, 2048 x 2048); on {card}")

        graph, _ = next(iter(trainer.data_loader.train_loader))
        graph = graph.to("cuda")
        vgraph = next(iter(trainer.data_loader.val_loader))[0].to("cuda")
        with record_calls(train_targets()) as calls:
            plain = grads_2d(torch, trainer, graph, vgraph, impl="plain")
        say("inpainting2d", check_2d_kernels(torch, calls, graph.num_graphs))
        del calls
        say("inpainting2d", check_2d_grads(
            grads_2d(torch, trainer, graph), plain))
        lpips_ms = perceptual_card_against_cpu(torch, trainer, graph, card)
        step_ms = bare_step(torch, "inpainting2d", trainer, graph, card,
                            unit="image (a batch of 4)", per=graph.num_graphs)
        eval_ms = median_ms(torch, lambda: trainer._eval_step(vgraph),
                            reps=SEG_STEP_REPS, inner=1, warmup=1)
        say("inpainting2d", f"LPIPS {lpips_ms:.3f} ms against the bare "
            f"step's {step_ms:.2f} ms ({lpips_ms / step_ms:.1%}; the step "
            f"computes it under no_grad after the backward); eval "
            f"{eval_ms:.2f} ms/image (a val batch of 1, LPIPS included); "
            f"on {card}")
        del trainer, probes

        last = run / f"checkpoint-epoch{INP2D_EPOCHS}.ckpt"
        cfg["trainer"]["epochs"] = INP2D_EPOCHS + 1
        (tmp / "2d_more.json").write_text(json.dumps(cfg))
        with probed_2d(torch, expect=last) as (probes, _):
            resumed = cli.main(["-c", str(tmp / "2d_more.json"), "-r",
                                str(last), "-d", "cuda", "-n", "resume"])
        epochs = [t["epoch"] for t in resumed.epoch_timings]
        check(epochs == [INP2D_EPOCHS + 1], f"resumed epochs {epochs}")
        check(all(math.isfinite(float(x)) for x in probes[0].losses),
              "non-finite resumed loss")
        say("inpainting2d", f"resume from {last.name}: epoch {epochs[0]} "
            "ran; parameters and Adam state bitwise the file's before its "
            f"first step; losses "
            f"{[round(float(x), 6) for x in probes[0].losses]}")
        del resumed, probes

        t0 = time.perf_counter()
        evaluator = cli.main(["-r", str(run / "model_best.ckpt"), "-e",
                              "valid", "-d", "cuda", "-n", "eval"])
        eval_s = time.perf_counter() - t0
        result = evaluator.valid_metrics.result()
        check(all(math.isfinite(v) for v in result.values()),
              f"eval metrics {result}")
        say("inpainting2d", f"-e valid -r model_best.ckpt: {result}; "
            f"{eval_s:.2f} s for {len(evaluator.data_loader.val_dataset)} "
            f"images, the trainer's construction included")
        del evaluator
    say("inpainting2d", f"phase wall time "
        f"{time.perf_counter() - t_phase:.1f} s; on {card}")


# --- the 2D workload's Resnet2D branch with its PatchGAN ---------------------

RESNET_TOL = 1e-4           # card vs CPU: losses relative, gradients in L2
FID_CLI_DIMS = 4            # pool3 features the fid_cli check keeps (under
                            # its 8 samples, so the covariance is full rank)


class ResnetStepProbe(StepProbe):
    """StepProbe of the 2d branch's step: its resume check also reads the
    discriminator and its Adam state, where the step has them."""

    def _parts(self):
        parts = {"2d": (self._model, self._optimizer)}
        if getattr(self._step, "disc", None) is not None:
            parts["discriminator"] = (self._step.disc,
                                      self._step.disc_optimizer)
        return parts


def probed_resnet2d(torch, expect=None):
    """`probed_steps` for the 2d branch's ResnetStepProbe."""
    from stinet_tpu_torch.trainers.inpainting2d import Inpainting2DTrainer
    return probed_steps(torch, Inpainting2DTrainer, "make_resnet2d_steps",
                        ResnetStepProbe, expect)


def resnet_steps_on(torch, trainer, graph, device, gan, dtype):
    """One step of the trainer's 2d branch from copies of its weights on
    `device` in `dtype` (a fresh Adam for each model), the GAN step or the
    plain 2d step: (metrics, {"G": gradients, "D": gradients}), the
    gradients f64 on the host; LPIPS and VGG left out."""
    from stinet_tpu_torch.graph.hierarchy import map_tensors
    from stinet_tpu_torch.trainers.graph_common import (
        build_optimizer, host_metrics)
    from stinet_tpu_torch.trainers.inpainting2d import make_resnet2d_steps
    cfg = trainer.config["optimizer"]
    model = copy.deepcopy(trainer.model).to(device, dtype)
    opt, lr = build_optimizer(model.parameters(), cfg)
    disc = dopt = None
    if gan:
        disc = copy.deepcopy(trainer.disc).to(device, dtype)
        dopt, _ = build_optimizer(disc.parameters(), cfg)
    step, _ = make_resnet2d_steps(
        model, opt, trainer.img_size,
        tv_weight=(trainer.total_variation_weight
                   if trainer.use_total_variation else None),
        disc=disc, disc_optimizer=dopt, gan_mode=trainer.gan_mode,
        gan_loss_weight=trainer.gan_loss_weight)
    graph = map_tensors(graph.to(device), lambda t: t.to(dtype)
                        if t.is_floating_point() else t)
    metrics = host_metrics(step(graph, lr))
    grads = {"G": {k: p.grad.detach().cpu().double()
                   for k, p in model.named_parameters()}}
    if gan:
        grads["D"] = {k: p.grad.detach().cpu().double()
                      for k, p in disc.named_parameters()}
    return metrics, grads


def resnet_card_against_cpu(torch, trainer, graph):
    """One GAN step and one plain 2d step from the trainer's weights on the
    card and on the CPU (TF32 off), in f32 and in f64: every metric within
    RESNET_TOL relative in both; G's and D's gradients, each taken as one
    vector, within RESNET_TOL of its L2 norm in f64. In f32 their distance
    is printed: a max pool's near tie or a relu argument within rounding
    of 0 may route a gradient element otherwise on the other device, as
    the f32 card tests found (PERF.md, PR 11); in f64 none does. Returns
    a summary line."""
    t0 = time.perf_counter()
    lines = []
    for dtype in (torch.float32, torch.float64):
        for gan in (True, False):
            what = f"{'GAN' if gan else 'plain 2d'} step {str(dtype)[6:]}"
            (card_m, card_g), (cpu_m, cpu_g) = (
                resnet_steps_on(torch, trainer, graph, d, gan, dtype)
                for d in ("cuda", "cpu"))
            check(sorted(card_m) == sorted(cpu_m), f"metric keys {card_m}")
            rel = {k: abs(card_m[k] - v) / max(abs(v), 1e-30)
                   for k, v in cpu_m.items() if v != 0 or card_m[k] != 0}
            worst = max(rel, key=rel.get)
            check(rel[worst] <= RESNET_TOL, f"{what} {worst}: card "
                  f"{card_m[worst]} vs CPU {cpu_m[worst]}, relative "
                  f"{rel[worst]:.3e} > {RESNET_TOL}")
            parts = []
            for net, want in cpu_g.items():
                got = card_g[net]
                check(sorted(got) == sorted(want), f"{net} gradient keys")
                diff = math.sqrt(sum(float((got[k] - g).norm()) ** 2
                                     for k, g in want.items()))
                norm = math.sqrt(sum(float(g.norm()) ** 2
                                     for g in want.values()))
                check(norm > 0 and (dtype == torch.float32
                                    or diff <= RESNET_TOL * norm),
                      f"{what}, {net}'s gradients card vs CPU: L2 of the "
                      f"difference {diff:.3e} > {RESNET_TOL} x {norm:.3e}")
                parts.append(f"{net} {len(want)} gradients {diff / norm:.3e} "
                             "of their L2 norm apart")
            lines.append(
                f"{what}: loss {card_m['loss']:.6f} vs {cpu_m['loss']:.6f}"
                + (f", loss_D_fake {card_m['loss_D_fake']:.6f}, loss_D_real "
                   f"{card_m['loss_D_real']:.6f}, loss_G "
                   f"{card_m['loss_G']:.6f}" if gan else "")
                + f"; largest metric difference {worst} {rel[worst]:.2e} "
                f"relative; " + ", ".join(parts))
    return (f"card vs CPU from the trainer's weights (TF32 off, tolerance "
            f"{RESNET_TOL}; gradients held in f64): " + "; ".join(lines)
            + f"; {time.perf_counter() - t0:.1f} s with the CPU steps")


def bare_gan_step(torch, trainer, graph, card):
    """The trainer's GAN step on one placed batch by CUDA events, split
    into the generator's forward, the discriminator's forward and
    backward, its optimizer step, the generator's loss (the updated
    discriminator's forward) and backward, and its optimizer step; peak
    device memory; one traced step. Returns the median step ms."""
    from stinet_tpu_torch.serving import full_f32_matmuls
    from stinet_tpu_torch.trainers.graph_common import set_lr
    step = trainer._train_step
    step = getattr(step, "_step", step)
    model, opt = trainer.model, trainer.optimizer
    disc, dopt = trainer.disc, trainer.disc_optimizer
    lr = trainer.lr_fn(1)

    def parts():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        model.train()
        disc.train()
        with full_f32_matmuls():
            opt.zero_grad(set_to_none=True)
            ev[0].record()
            fake, color, prior = step.generate(graph)
            ev[1].record()
            disc.requires_grad_(True)
            dopt.zero_grad(set_to_none=True)
            step.disc_loss(fake, color, prior)[0].backward()
            ev[2].record()
            set_lr(dopt, lr)
            dopt.step()
            ev[3].record()
            step.gen_loss(fake, color, prior)[0].backward()
            ev[4].record()
            set_lr(opt, lr)
            opt.step()
            ev[5].record()
        return ev

    split, peak = timed_parts(torch, parts)
    total = [sum(x) for x in zip(*split)]
    med = statistics.median
    names = ("G forward", "D forward and backward", "D optimizer",
             "G loss (D forward) and backward", "G optimizer")
    say("inpainting2d-resnet", f"bare GAN step by CUDA events, median of "
        f"{SEG_STEP_REPS}: {med(total):.2f} ms = " + " + ".join(
            f"{n} {med(x):.2f}" for n, x in zip(names, split))
        + f"; peak device memory {peak:.2f} GiB; on {card}")
    traced_steps(torch, "inpainting2d-resnet", parts, card, "GAN step")
    return med(total)


def fid_cli_on_card(torch, tmp, card):
    """The FID command line's card path without PIL: gz UV maps through a
    toy renderer into InceptionV3 on the card (its first FID_CLI_DIMS
    pool3 features) against .npz statistics, and `main` on two .npz
    files. Returns a summary line."""
    import gzip
    import numpy as np
    from stinet_tpu_torch.metrics import fid_cli
    from stinet_tpu_torch.metrics.fid import FIDScoreCumulative
    rng = np.random.default_rng(0)
    uv_dir = tmp / "uv"
    uv_dir.mkdir()
    for i in range(8):
        with gzip.open(uv_dir / f"{i}.gz", "wb") as f:
            f.write(rng.uniform(0, 1, (32, 32, 2)).astype(
                np.float32).tobytes())
    features = fid_cli.inception_features(torch.device("cuda"))
    fid = FIDScoreCumulative(
        feature_fn=lambda imgs: features(imgs)[:, :FID_CLI_DIMS])
    a = rng.normal(size=(FID_CLI_DIMS, FID_CLI_DIMS)) * 0.1
    for name, mu in (("truth", 0.0), ("other", 0.1)):
        np.savez(tmp / f"{name}.npz", mu=np.full(FID_CLI_DIMS, mu),
                 sigma=a @ a.T)
    t0 = time.perf_counter()
    value = fid_cli.fid_given_path_and_model(
        str(tmp / "truth.npz"), str(uv_dir),
        lambda uv: np.concatenate([uv, uv[..., :1]], axis=-1), (32, 32), fid,
        batch_size=4, scale_size=48)
    secs = time.perf_counter() - t0
    check(math.isfinite(value), f"fid_given_path_and_model: {value}")
    npz = fid_cli.main([str(tmp / "truth.npz"), str(tmp / "other.npz")])
    check(abs(npz - 0.1 ** 2 * FID_CLI_DIMS) <= 1e-9,
          f"fid_cli main on two .npz files: {npz}, expected "
          f"{0.1 ** 2 * FID_CLI_DIMS}")
    return (f"fid_cli: 8 gz UV maps (32 px, scaled to 48) through "
            f"InceptionV3 on the card against .npz statistics, "
            f"{FID_CLI_DIMS} features: FID {value:.6g} in {secs:.2f} s; "
            f"main on two .npz files {npz:.6g}; on {card}")


def inpainting2d_resnet_phase(torch, card):
    """The 2D workload's Resnet2D branch with its PatchGAN: the port's CLI
    trains the hermetic 2D config with `archs.Resnet2D` enabled (its
    shipped width: ngf 64, 9 blocks, instance norm, max pooling, dilation
    order 1), `SurfaceTextureInpaintingNet` disabled and `trainer.use_gan`
    on (the discriminator at the trainer's defaults: ndf 64, 5 layers),
    LPIPS and FID on random features; resumes it and evaluates it.

    Cuts, against the shipped hermetic config, as phase `inpainting2d`'s:
    `root_dir` an empty temporary directory, so the loader synthesizes 32
    train textures (8 steps an epoch at B=4) and 8 val textures;
    `save_dir` repointed; INP2D_EPOCHS epochs, then one more resumed (the
    config: 2000); `epochs_per_fid` INP2D_FID_EVERY (the config: 5), so
    FID runs once, at the last epoch, for train and val; a checkpoint
    every epoch. The config is written to the temporary directory; the
    files under experiments/ stay as they are."""
    import os
    import tempfile
    from stinet_tpu_torch import train as cli
    phase = "inpainting2d-resnet"
    os.environ["STINET_DISABLE_GIT_TAG"] = "1"
    t_phase = time.perf_counter()
    counters = _train_counters()
    with tempfile.TemporaryDirectory(prefix="stinet_2d_resnet_") as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "textures").mkdir()
        cfg = json.loads(pathlib.Path(INP2D_CONFIG).read_text())
        cfg["archs"]["SurfaceTextureInpaintingNet"]["enabled"] = False
        cfg["archs"]["Resnet2D"]["enabled"] = True
        cfg["data_loader"]["args"]["root_dir"] = str(tmp / "textures")
        cfg["trainer"].update(save_dir=str(tmp / "saved"),
                              epochs=INP2D_EPOCHS, save_period=1,
                              epochs_per_fid=INP2D_FID_EVERY, use_gan=True)
        (tmp / "2d.json").write_text(json.dumps(cfg))
        args = cfg["archs"]["Resnet2D"]["args"]
        dl = cfg["data_loader"]["args"]
        say(phase, f"{INP2D_CONFIG} with archs.Resnet2D enabled: ngf "
            f"{args['ngf']}, {args['n_blocks']} blocks, {args['norm']} "
            f"norm, {args['pooling_type']} pooling, dilation order "
            f"{args['dilation_order']}; use_gan ({cfg['trainer']['gan_mode']},"
            f" weight {cfg['trainer']['gan_loss_weight']}); img_size "
            f"{dl['img_size']}, batch {dl['train_batch_size']}; root_dir "
            f"empty (synthesized textures), save_dir repointed, epochs "
            f"{INP2D_EPOCHS}, epochs_per_fid {INP2D_FID_EVERY}, save_period 1")

        _zero(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with probed_resnet2d(torch) as (probes, logs):
            trainer = cli.main(["-c", str(tmp / "2d.json"), "-d", "cuda",
                                "-n", "resnet"])
        launches = _read(counters)
        probe = probes[0]
        trainer_readings(phase, trainer, probe, card)
        check(trainer.branch == "2d" and trainer.disc is not None,
              "the trainer did not take the 2d branch with the GAN")
        for name, net in (("G", trainer.model), ("D", trainer.disc)):
            check(all(p.is_cuda for p in net.parameters()),
                  f"{name}'s parameters are not all on the card")
        check(not any(launches.values()), f"a graph kernel launched on the "
              f"Resnet2D path: {launches}")
        losses = [float(x) for x in probe.losses]
        steps_a_epoch = len(trainer.data_loader.train_loader)
        check(len(losses) == INP2D_EPOCHS * steps_a_epoch,
              f"{len(losses)} train steps")
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        tag = trainer.lpips_tag
        for log in logs:
            for k in ("loss", "loss_D_fake", "loss_D_real", "loss_G",
                      "accuracy_D_fake", "accuracy_D_real", tag, "val_loss",
                      "val_" + tag):
                check(math.isfinite(log[k]), f"epoch log {k} {log[k]}")
        for k in ("train_fid_random_features", "val_fid_random_features"):
            check(math.isfinite(logs[-1].get(k, math.nan)),
                  f"epoch {INP2D_EPOCHS} {k}: {logs[-1].get(k)}")
        run = trainer.checkpoint_dir
        names = [f"checkpoint-epoch{e}.ckpt"
                 for e in range(1, INP2D_EPOCHS + 1)] + ["model_best.ckpt"]
        from stinet_tpu_torch.core.checkpoint import load_checkpoint
        for name in names:
            for f in (run / name, run / (name + ".meta.json")):
                check(f.exists(), f"{f} was not written")
            sds, opts, _, _ = load_checkpoint(run / name)
            check(sorted(sds) == sorted(opts) == ["2d", "discriminator"],
                  f"{name} holds {sorted(sds)}")
        say(phase, f"CLI run: {len(losses)} GAN steps, losses "
            f"{[round(x, 6) for x in losses]}; graph kernel launches in the "
            f"run (train, FID and validation) {launches}; "
            f"{', '.join(names)} written, each with 2d and discriminator; "
            "epoch logs " + "; ".join(
                ", ".join(f"{k} {log[k]:.6g}" for k in log if k != "lr")
                for log in logs))
        for t in trainer.fid_timings:
            say(phase, f"FID epoch {t['epoch']} {t['split']}: "
                f"{t['features_s']:.3f} s eval steps and InceptionV3 "
                f"forwards to the host copy, {t['distance_s']:.3f} s host "
                f"statistics and sqrtm (scipy, 2048 x 2048); on {card}")

        graph, _ = next(iter(trainer.data_loader.train_loader))
        say(phase, resnet_card_against_cpu(torch, trainer, graph))
        graph = graph.to("cuda")
        gan_ms = bare_gan_step(torch, trainer, graph, card)
        from stinet_tpu_torch.trainers.inpainting2d import (
            make_resnet2d_steps)
        plain, _ = make_resnet2d_steps(trainer.model, trainer.optimizer,
                                       trainer.img_size)
        step_ms = bare_step(torch, phase, types.SimpleNamespace(
            _train_step=plain, model=trainer.model,
            optimizer=trainer.optimizer, _eval_step=trainer._eval_step),
            graph, card, unit="image (a batch of 4)", per=graph.num_graphs)
        vgraph = next(iter(trainer.data_loader.val_loader))[0].to("cuda")
        eval_ms = median_ms(torch, lambda: trainer._eval_step(vgraph),
                            reps=SEG_STEP_REPS, inner=1, warmup=1)
        say(phase, f"GAN step {gan_ms:.2f} ms against the plain 2d step's "
            f"{step_ms:.2f} ms; eval {eval_ms:.2f} ms/image (a val batch of "
            f"1, LPIPS included); on {card}")
        del trainer, probes, plain

        last = run / f"checkpoint-epoch{INP2D_EPOCHS}.ckpt"
        cfg["trainer"]["epochs"] = INP2D_EPOCHS + 1
        (tmp / "2d_more.json").write_text(json.dumps(cfg))
        with probed_resnet2d(torch, expect=last) as (probes, _):
            resumed = cli.main(["-c", str(tmp / "2d_more.json"), "-r",
                                str(last), "-d", "cuda", "-n", "resume"])
        epochs = [t["epoch"] for t in resumed.epoch_timings]
        check(epochs == [INP2D_EPOCHS + 1], f"resumed epochs {epochs}")
        check(all(math.isfinite(float(x)) for x in probes[0].losses),
              "non-finite resumed loss")
        say(phase, f"resume from {last.name}: epoch {epochs[0]} ran; both "
            "models and both Adam states bitwise the file's before its "
            f"first step; losses "
            f"{[round(float(x), 6) for x in probes[0].losses]}")
        del resumed, probes

        t0 = time.perf_counter()
        evaluator = cli.main(["-r", str(run / "model_best.ckpt"), "-e",
                              "valid", "-d", "cuda", "-n", "eval"])
        eval_s = time.perf_counter() - t0
        result = evaluator.valid_metrics.result()
        check(all(math.isfinite(v) for v in result.values()),
              f"eval metrics {result}")
        say(phase, f"-e valid -r model_best.ckpt: {result}; {eval_s:.2f} s "
            f"for {len(evaluator.data_loader.val_dataset)} images, the "
            "trainer's construction included")
        del evaluator
        say(phase, fid_cli_on_card(torch, tmp, card))
    say(phase, f"phase wall time {time.perf_counter() - t_phase:.1f} s; on "
        f"{card}")


# --- the rest of the STINet model: reference checkpoints, SageConv, labels --

VARIANT_STEPS = 3           # bare train steps of a model variant per path
VARIANT_REPS = 5            # timed steps and forwards of a variant
GRAD64_TOL = 1e-10          # f64 gradients card vs CPU, of their L2 norm
REF_TOL = 1e-5              # a loaded checkpoint's predict vs its source's
NUM_CLASSES, NUM_EMBEDDING = 21, 12   # the shipped 3D configs' values


def ev_ms(torch, fn):
    """CUDA-event ms of one call of fn()."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def labelled_scene(scene, seed=0):
    """`scene` with seeded labels over 0..NUM_CLASSES-1, a quarter of them
    0 (the padding label)."""
    import dataclasses
    import numpy as np
    rng = np.random.default_rng(seed)
    n = scene.num_vertices[0]
    labels = rng.integers(1, NUM_CLASSES, size=n)
    labels[rng.permutation(n)[:n // 4]] = 0
    return dataclasses.replace(scene, labels=labels)


def serve_counted(torch, server, scene):
    """server.predict(scene) with every kernel's launch count zeroed just
    before and read just after: (output, {key: launches})."""
    counters = dict(_train_counters(), **_counters())
    _zero(counters)
    out = server.predict(scene)
    return out, _read(counters)


def check_output(out, n, what):
    import numpy as np
    check(out.shape == (n, 3), f"{what}: shape {out.shape}")
    check(bool(np.isfinite(out).all()), f"{what}: non-finite output")
    check(float(abs(out).max()) <= 1.0, f"{what}: output outside the tanh "
          "range")


def reference_checkpoint_phase(torch, card, scene, flagship):
    """Phase 11: the flagship's weights saved in the reference's two
    checkpoint layouts, read by `load_reference_state_dict`, served: the
    served weights bitwise the source model's, each output within REF_TOL
    of the source model's predict (the forward's scatter adds are atomic
    on the card, so two predicts of one server differ in the last bits;
    that difference is printed), within SMALL_TOL of the CPU on the small
    scene; the launches of one predict the flagship's."""
    import tempfile
    from stinet_tpu_torch.models.factory import FLAGSHIP, define_G
    from stinet_tpu_torch.serving import SceneInpainter
    from stinet_tpu_torch.utils.convert_reference_checkpoint import (
        load_reference_state_dict)
    from stinet_tpu_torch.utils.synthetic import (
        FLAGSHIP_SCENE, synthetic_scene)
    phase = "reference-checkpoint"
    t0 = time.perf_counter()
    model = define_G(**FLAGSHIP, generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    source = SceneInpainter(model, sd, device="cuda")
    want = source.predict(scene)
    again = float(abs(source.predict(scene) - want).max())
    small = synthetic_scene(**dict(FLAGSHIP_SCENE,
                                   num_vertices=SMALL_VERTICES))
    cpu_small = SceneInpainter(define_G(**FLAGSHIP), sd,
                               device="cpu").predict(small)
    with tempfile.TemporaryDirectory(prefix="stinet_ref_") as tmp:
        for layout, ckpt in (
                ("state_dicts", {"archs": {"graph": "SurfaceTexture"
                                           "InpaintingNet"},
                                 "state_dicts": {"graph": sd}}),
                ("state_dict", {"state_dict": sd})):
            path = pathlib.Path(tmp) / f"{layout}.pth"
            torch.save(ckpt, path)
            loaded = load_reference_state_dict(path)
            check(sorted(loaded) == sorted(sd), f"{layout}: keys differ")
            server = SceneInpainter(define_G(**FLAGSHIP), loaded,
                                    device="cuda")
            out, launches = serve_counted(torch, server, scene)
            check(launches["k1"] == flagship["k1"] and
                  launches["k2"] == flagship["k2"],
                  f"{layout}: launches {launches}, the flagship's forward "
                  f"{flagship}")
            check_output(out, scene.num_vertices[0], layout)
            served = server.model.state_dict()
            check(all(torch.equal(served[k].cpu(), v) for k, v in sd.items()),
                  f"{layout}: served weights differ from the source's")
            src_err = float(abs(out - want).max())
            check(src_err <= REF_TOL, f"{layout}: predict vs the source "
                  f"model's max |diff| {src_err:.3e} > {REF_TOL}")
            err = float(abs(server.predict(small) - cpu_small).max())
            check(err <= SMALL_TOL, f"{layout}: small scene card vs CPU "
                  f"max |diff| {err:.3e} > {SMALL_TOL}")
            say(phase, f"{layout} layout, {path.stat().st_size / 2**20:.1f} "
                f"MiB, {len(loaded)} tensors loaded strict, bitwise the "
                f"source's: predict {list(out.shape)} against the source "
                f"model's max |diff| {src_err:.3e} (the source's two "
                f"predicts {again:.3e}); small scene "
                f"V={SMALL_VERTICES} card vs CPU max |diff| {err:.3e}; "
                f"launches K1 {launches['k1']}, K2 {launches['k2']}")
    say(phase, f"phase wall time {time.perf_counter() - t0:.1f} s; on {card}")


def variant_grads(torch, model, graph, device, dtype, impl):
    """(loss, {name: f64 host gradient}) of one forward and backward of the
    inpainting loss, from a copy of `model` on `device` in `dtype`."""
    from stinet_tpu_torch.graph.hierarchy import map_tensors
    from stinet_tpu_torch.serving import full_f32_matmuls
    from stinet_tpu_torch.trainers import graph_common as gc
    m = copy.deepcopy(model).to(device, dtype).train()
    g = map_tensors(graph.to(device), lambda t: t.to(dtype)
                    if t.is_floating_point() else t)
    with full_f32_matmuls():
        loss, _ = gc.inpainting_loss(m(g, impl=impl), g.color, g.mask,
                                     gc.vertex_mask(g), True)
        loss.backward()
    return loss.item(), {k: p.grad.detach().cpu().double()
                         for k, p in m.named_parameters()}


def variant_card_against_cpu(torch, model, small):
    """One forward and backward on the small scene, card against CPU: in
    f64 (the plain path on the card: the kernels take f32 and bf16) the
    loss within GRAD64_TOL relative and the gradients, as one vector,
    within GRAD64_TOL of their L2 norm; in f32 on the kernel path the
    distances are printed (a relu argument within rounding of 0 may route
    a gradient otherwise on the other device, PERF.md §6)."""
    parts = []
    for dtype, impl in ((torch.float64, "plain"), (torch.float32, None)):
        (lc, gc_), (lh, gh) = (
            variant_grads(torch, model, small, d, dtype, i)
            for d, i in (("cuda", impl), ("cpu", None)))
        diff = math.sqrt(sum(float((gc_[k] - g).norm()) ** 2
                             for k, g in gh.items()))
        norm = math.sqrt(sum(float(g.norm()) ** 2 for g in gh.values()))
        rel = abs(lc - lh) / abs(lh)
        if dtype == torch.float64:
            check(rel <= GRAD64_TOL and diff <= GRAD64_TOL * norm,
                  f"f64 card vs CPU: loss {lc} vs {lh}, gradients "
                  f"{diff:.3e} apart, norm {norm:.3e}")
        parts.append(f"{str(dtype)[6:]}: loss relative {rel:.2e}, "
                     f"{len(gh)} gradients {diff / norm:.3e} of their L2 "
                     "norm apart")
    return "; ".join(parts)


def variant_phase(torch, card, phase, args, scene, small, flagship):
    """Phases 12 and 13: a model variant of the flagship (`args`), served
    through `SceneInpainter` (the launches of one predict against the
    flagship's, `flagship`, or against none of K1 and K3 for SageConv) and
    trained by bare steps of `make_inpainting_steps` (each step's launches
    equal to the calls a plain-path step records; losses within TRAIN_TOL
    of the plain path's); card against CPU on the small scene (forward
    within SMALL_TOL; f64 gradients, `variant_card_against_cpu`); device
    forward ms, step ms and peak memory."""
    from stinet_tpu_torch.graph.build import build_hierarchical_graph
    from stinet_tpu_torch.models.factory import define_G
    from stinet_tpu_torch.serving import PackedPlacer, SceneInpainter
    from stinet_tpu_torch.trainers import graph_common as gc
    t0 = time.perf_counter()
    cfg = json.loads(pathlib.Path(REF_CONFIG).read_text())
    model = define_G(**args, generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    server = SceneInpainter(model, sd, device="cuda")
    placed = server.place(server.build(scene))
    # the COO lists of the edge sets with ELL tables, and the labels
    kept = [e.src is not None for lv in placed.levels
            for e in (lv.edges, *lv.dilated.values()) if e.nbr is not None]
    check(kept and all(k == model.reads_coo for k in kept) and
          (placed.labels is not None) == model.reads_labels,
          f"served graph: COO lists of ELL edge sets kept {kept}, labels "
          f"{placed.labels is not None}; the model reads COO "
          f"{model.reads_coo}, labels {model.reads_labels}")
    out, launches = serve_counted(torch, server, scene)
    check_output(out, scene.num_vertices[0], phase)
    if model.reads_coo:
        want = dict(k1=0, k3a=0, k3b=0, k3c=0, k2=flagship["k2"])
    else:
        want = dict(k1=flagship["k1"], k2=flagship["k2"])
    got = {k: launches[k] for k in want}
    check(got == want, f"launches of one predict {got}, expected {want}")
    cpu_out = SceneInpainter(define_G(**args), sd, device="cpu").predict(
        small)
    small_err = float(abs(server.predict(small) - cpu_out).max())
    check(small_err <= SMALL_TOL, f"small scene card vs CPU max |diff| "
          f"{small_err:.3e} > {SMALL_TOL}")
    fwd_ms = median_ms(torch, lambda: server.forward(placed),
                       reps=VARIANT_REPS, inner=1)
    say(phase, f"predict {list(out.shape)} finite in [-1, 1]; launches "
        f"{ {k: v for k, v in launches.items() if v} }; served graph keeps "
        f"COO {model.reads_coo}, labels {model.reads_labels}; small scene "
        f"V={SMALL_VERTICES} card vs CPU max |diff| {small_err:.3e}; device "
        f"forward {fwd_ms:.3f} ms; on {card}")
    del server, placed

    # bare train steps, kernel path against plain path
    dev = torch.device("cuda")
    graph = PackedPlacer(dev)(build_hierarchical_graph([scene],
                                                       geometric=True))
    weighted = cfg["trainer"]["use_mask_weighted_loss"]
    calls = capture_train_calls(torch, model.to(dev), graph, cfg)
    want = {k: len(v) for k, v in calls.items()}

    def stepper(impl=None):
        m = copy.deepcopy(model).to(dev)
        m.load_state_dict(sd)
        opt, lr = gc.build_optimizer(m.parameters(), cfg["optimizer"])
        step, _ = gc.make_inpainting_steps(m, opt, weighted, impl=impl)
        return step, lr

    kstep, lr = stepper()
    counters = _train_counters()
    _zero(counters)
    losses = [float(kstep(graph, lr)["loss"])]
    one = _read(counters)
    one["k2"] += one.pop("k2mg")
    check(one == want, f"launches of one step {one}, the plain path "
          f"records {want}")
    losses += [float(kstep(graph, lr)["loss"])
               for _ in range(VARIANT_STEPS - 1)]
    pstep, _ = stepper("plain")
    plain = [float(pstep(graph, lr)["loss"]) for _ in range(VARIANT_STEPS)]
    check(all(math.isfinite(x) for x in losses + plain),
          f"losses {losses} / {plain}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
    check(rel <= TRAIN_TOL, f"losses {losses} vs plain path {plain}: "
          f"relative {rel:.3e} > {TRAIN_TOL}")
    step_ms = statistics.median(ev_ms(torch, lambda: kstep(graph, lr))
                                for _ in range(VARIANT_REPS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kstep(graph, lr)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(phase, f"{VARIANT_STEPS} bare steps, losses "
        f"{[round(x, 6) for x in losses]}, plain path "
        f"{[round(x, 6) for x in plain]} (relative {rel:.2e}); launches a "
        f"step {one}, equal to the plain path's recorded calls; step "
        f"{step_ms:.2f} ms (median of {VARIANT_REPS}, CUDA events); peak "
        f"{peak:.2f} GiB; on {card}")
    small_graph = build_hierarchical_graph([small], geometric=True)
    say(phase, "small scene card vs CPU, one forward and backward: "
        + variant_card_against_cpu(torch, model.cpu(), small_graph))
    say(phase, f"phase wall time {time.perf_counter() - t0:.1f} s; on {card}")


def rest_of_the_model(torch, card, scene, flagship):
    """Phases 11-14: the reference's checkpoints, the SageConv and
    label-embedded flagships, and stacked training. `flagship`: the K1 and
    K2 launches of one flagship forward."""
    from stinet_tpu_torch.models.factory import FLAGSHIP
    from stinet_tpu_torch.utils.synthetic import (
        FLAGSHIP_SCENE, synthetic_scene)
    small = synthetic_scene(**dict(FLAGSHIP_SCENE,
                                   num_vertices=SMALL_VERTICES))
    reference_checkpoint_phase(torch, card, scene, flagship)
    variant_phase(torch, card, "sageconv",
                  dict(FLAGSHIP, filter_type="sageconvtransinv"),
                  scene, small, flagship)
    variant_phase(torch, card, "label-embedding", dict(
        FLAGSHIP, use_label_embedding=True, num_classes=NUM_CLASSES,
        num_embedding=NUM_EMBEDDING),
        labelled_scene(scene), labelled_scene(small), flagship)
    trainer_stacked_phase(torch, card)


def trainer_stacked_phase(torch, card):
    """Phase 14: the CLI trains the bf16 config with `stacked_batching` at
    `train_batch_size` 2 on the trainer phase's scenes (2 train scenes, so
    one stacked step an epoch, TRAINER_EPOCHS epochs): each kernel of the
    bf16 path launched, each step's launches equal to the calls of a
    plain-path stacked step on the same batch (two scenes' worth), the
    first loss within TRAIN_TOL of that step's; the trainer's clock and
    readings."""
    import os
    import tempfile
    from stinet_tpu_torch import train as cli
    phase = "trainer-stacked"
    counters = _train_counters()
    os.environ["STINET_DISABLE_GIT_TAG"] = "1"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="stinet_stacked_") as tmp:
        tmp = pathlib.Path(tmp)
        roots, _ = write_trainer_scenes(tmp)
        cfg = trainer_config(tmp / "stacked.json", roots, tmp / "saved",
                             BF16_CONFIG, TRAINER_EPOCHS,
                             stacked_batching=True, train_batch_size=2)
        _zero(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with probed_trainer(torch) as (probes, _):
            trainer = cli.main(["-c", str(tmp / "stacked.json"), "-d",
                                "cuda", "-n", "stacked"])
        launches = _read(counters)
        probe = probes[0]
        check(trainer._stacked, "the trainer did not take the stacked "
              "layout")
        check(all(launches[k] > 0 for k in ("k3a", "k3c", "k1", "k1dp",
                                            "k1dq", "k2")),
              f"a kernel of the bf16 train path never launched: {launches}")
        losses = [float(x) for x in probe.losses]
        check(len(losses) == TRAINER_EPOCHS and all(
            math.isfinite(x) for x in losses), f"losses {losses}")
        check(all(g.x.shape[0] == 2 for g in probe.graphs),
              "a train batch is not two stacked scenes")
        plain_first = check_trainer_launches(torch, cfg, probe, "cuda")
        rel = abs(losses[0] - plain_first) / abs(plain_first)
        check(rel <= TRAIN_TOL, f"first loss {losses[0]} vs the plain-path "
              f"trainer's {plain_first}: relative {rel:.3e} > {TRAIN_TOL}")
        val = trainer.valid_metrics.result()
        check(math.isfinite(val["loss"]), f"val loss {val['loss']}")
        say(phase, f"bf16 config, stacked_batching, train_batch_size 2: "
            f"{len(losses)} steps, losses {[round(x, 6) for x in losses]}; "
            f"first loss against the plain-path trainer's {plain_first:.6f} "
            f"(relative {rel:.2e}); launches in the run {launches}; per "
            f"step {probe.launches[0]} (two scenes), equal to the plain "
            f"path's recorded calls; val loss {val['loss']:.6f}")
        trainer_readings(phase, trainer, probe, card)
    say(phase, f"phase wall time {time.perf_counter() - t0:.1f} s; on {card}")


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
    """Phase 9: the flagship f32 server with windowed=True. Every K3b call
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
    row = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, k1_same_inputs_ms=0.0,
               device_ms=0.0, k1_device_ms=0.0,
               max_abs_err=0.0, library_ms=None, kinds=set())
    for i, (p, q, nbr, deg, halo, tile, _) in enumerate(calls):
        v, h = p.shape
        got = windowed.windowed_edge_conv_sum_f32_kernel(p, q, nbr, deg,
                                                         halo, tile)
        note = plan_note(q, halo, tile, 1, nbr.shape[1])
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
        host, _, dev = host_device_us(torch, lambda: windowed.
                                      windowed_edge_conv_sum_f32_kernel(
                                          p, q, nbr, deg, halo, tile))
        _, _, k1_dev = host_device_us(
            torch, lambda: ell.ell_edge_conv_sum_kernel(p, q, nbr, deg))
        nbytes, slots = _slot_bytes(nbr, deg, 4, h, 1)
        b_ms, b_by = bound(nbytes, 3 * h * slots)
        for k, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                       ("k1_same_inputs_ms", k1_ms), ("device_ms", dev / 1e3),
                       ("k1_device_ms", k1_dev / 1e3)):
            row[k] += val
        row["kinds"].add(b_by)
        say("serving-windowed", f"K3b call {i} V={v} H={h} D={nbr.shape[1]} "
            f"halo={halo} tile={tile} live slots a row "
            f"{slots / max(int(torch.count_nonzero(deg)), 1):.2f}; {note}: "
            f"bitwise "
            f"equal to its plain version and to f32 K1; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, K1 on the same inputs {k1_ms:.4f} ms, "
            f"device alone {dev:.1f} us, K1 {k1_dev:.1f} us, host {host:.1f} "
            f"us a call, "
            f"bound {b_ms:.4f} ms ({b_by})")
    row["bound_by"] = "bytes" if row.pop("kinds") == {"bytes"} else \
        "operations"

    counters = _counters()
    _zero(counters)
    before = native_calls()
    out = server.predict(scene)
    n_native = check_native("serving-windowed", before)
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
        f"launches {launches}; native build calls {n_native}; max |diff| "
        f"against the non-windowed kernel "
        f"path {ref_err:.3e}, against the windowed plain path "
        f"{plain_err:.3e}")
    ms, split = time_predict(torch, server, scene, WINDOWED_REPS)
    with env(STINET_NATIVE_BUILD=0):
        np_ms, np_split = time_predict(torch, server, scene, WINDOWED_REPS)
    fwd_ms = median_ms(torch, lambda: server.forward(graph), reps=10,
                       inner=1)
    say("serving-windowed", f"predict {ms:.2f} ms/scene end to end; by "
        f"phase, median ms of {WINDOWED_REPS}: {split}; device forward "
        f"{fwd_ms:.3f} ms; K3b {row['ms']:.4f} ms a forward against K1 on "
        f"the same inputs {row['k1_same_inputs_ms']:.4f} ms (device alone "
        f"{row['device_ms']:.4f} against {row['k1_device_ms']:.4f}); on "
        f"{card}")
    say("serving-windowed", f"the same with the numpy builder "
        f"(STINET_NATIVE_BUILD=0, scipy RCM): predict {np_ms:.2f} ms/scene "
        f"end to end; by phase: {np_split}")
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
    """Phase 10: predict_batch at B = BATCH (flagship scenes of seeds 0..B-1,
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
        before = native_calls()
        outs = server.predict_batch(batch, stacked=stacked)
        check_native(f"serving-batched {layout}", before)
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
    before = native_calls()
    t0 = time.perf_counter()
    for out in server.predict_stream(scenes):
        outs.append(out)
        yields.append(time.perf_counter())
    n_native = check_native("serving-batched predict_stream", before)
    err = agree(outs, STREAM, "predict_stream")
    whole = (yields[-1] - t0) / len(yields) * 1e3
    after = (yields[-1] - yields[0]) / (len(yields) - 1) * 1e3
    say("serving-batched", f"predict_stream over {len(scenes)} scenes: "
        f"{whole:.2f} ms/scene over the whole stream, {after:.2f} ms/scene "
        f"after the first result; native build calls {n_native}; "
        f"stream_stats {server.stream_stats()}; "
        f"max |diff| "
        f"against single-scene forwards {err:.3e}; host builds of "
        f"{len(scenes) - 1} scenes on 4 threads {build_s:.2f} s; on {card}")
    return row, concat_launches


# --- the offline preprocessing, texture optimization, hostile scenes ---------

PREP_VERTICES = 65536       # source vertices of each preprocessed room
PREP_EPOCHS = 2             # epochs of the bf16 run on the preprocessed scenes
PREP_JOBS = 2               # `graphs --jobs`: one process a scene
TEX_VERTICES = 65536        # the texture-optimized room
TEX_FRAMES = 100            # a 1000-frame sequence at --stride 10
TEX_WIDTH, TEX_HEIGHT = 640, 480
TEX_CPU_FRAMES = 8          # frames held against the CPU
TEX_TOL = 1e-4              # estimated colors, card vs CPU (absolute)
TEX_FLIP_SHARE = 1e-4       # visibility flips allowed, card vs CPU
TEX_ITERS, TEX_LR = 50, 1e-4
TEX_STEP_REPS = 10          # timed rigid iterations
HOSTILE_VERTICES = 65536
HOSTILE_REPS = 5            # timed predicts a scene and layout


def run_cli(phase, *argv):
    """`python -m stinet_tpu_torch.preprocessing.cli <argv>`, as a user
    runs it, in its own process: (its standard output, seconds)."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "stinet_tpu_torch.preprocessing.cli",
         *argv], capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    check(res.returncode == 0 and "FAILED" not in res.stdout,
          f"{phase}: preprocessing {argv[0]} failed "
          f"(rc {res.returncode}):\n{res.stdout}\n{res.stderr[-4000:]}")
    return res.stdout, secs


def preprocess_phase(torch, card, flagship):
    """Phase 15: two rooms (terrain_mesh(PREP_VERTICES, 0 and 1) scaled to
    8 m x 8 m, seeded colors) written as ScanNet scans of a train and a
    val scene, through the port's CLI at its defaults (`graphs --jobs
    PREP_JOBS`, `crops`, `masks --crops`); the bf16 config trained on the
    result through the trainer's CLI, every crop read by the ScanNet loader
    (no_train_cropped false), and the flagship served on the val scene the
    loader reads. `flagship`: the K1 and K2 launches of one flagship
    predict."""
    import ast
    import os
    import tempfile
    import numpy as np
    from stinet_tpu_torch import train as cli
    from stinet_tpu_torch.data.scannet import (
        SCANNET_TRAIN_FILE, SCANNET_VAL_FILE, ScanNetGraphColorDataLoader,
        ScanNetGraphColorDataSet, read_split)
    from stinet_tpu_torch.graph.build import build_hierarchical_graph
    from stinet_tpu_torch.models.factory import FLAGSHIP, define_G
    from stinet_tpu_torch.ops.message_passing import HALO_CAPS
    from stinet_tpu_torch.preprocessing.plyio import write_ply
    from stinet_tpu_torch.serving import SceneInpainter
    from stinet_tpu_torch.utils.synthetic_sensor import room_mesh
    phase = "preprocess"
    t_phase = time.perf_counter()
    os.environ["STINET_DISABLE_GIT_TAG"] = "1"
    with tempfile.TemporaryDirectory(prefix="stinet_preprocess_") as tmp:
        tmp = pathlib.Path(tmp)
        scans, out, crops = tmp / "scans", tmp / "graph_levels", tmp / "crops"
        names = [read_split(SCANNET_TRAIN_FILE)[0],
                 read_split(SCANNET_VAL_FILE)[0]]
        t0 = time.perf_counter()
        for seed, name in enumerate(names):
            v, f, colors = room_mesh(PREP_VERTICES, seed)
            (scans / name).mkdir(parents=True)
            write_ply(str(scans / name / f"{name}_vh_clean_2.ply"), v, f,
                      colors)
        say(phase, f"2 rooms of {PREP_VERTICES} vertices, {len(f)} faces, "
            f"8 m x 8 m ({', '.join(names)}) written as ScanNet plys in "
            f"{time.perf_counter() - t0:.1f} s")

        text, secs = run_cli(phase, "graphs", "--scans", str(scans),
                             "--out", str(out), "--jobs", str(PREP_JOBS))
        calls = [ast.literal_eval(m) for m in re.findall(
            r"native calls: decimator (\{.*?\})", text)]
        check(len(calls) == 2 and all(c.get("qem_decimate", 0) >= 2
                                      for c in calls),
              f"{phase}: graphs made no native decimation: {text}")
        z = np.load(out / "graphs" / f"{names[1]}.npz")
        sizes = [z[f"vertices_{l}"].shape[0] for l in range(3)]
        say(phase, f"graphs --jobs {PREP_JOBS} (defaults: --level-params "
            f"100 30 30, --dilations 2 4 6 8 16): {secs:.1f} s for 2 "
            f"scenes; val level sizes {sizes}; per scene "
            + "; ".join(line.split(" in ", 1)[1]
                        for line in text.splitlines()
                        if line.startswith("wrote")))
        text, secs = run_cli(phase, "crops", "--graphs", str(out), "--out",
                             str(crops))
        n_crops = len(list((crops / "graphs").glob("*.npz")))
        check(n_crops > 0, f"{phase}: no crop written: {text}")
        say(phase, f"crops (block 3.0 m, stride 1.5 m): {secs:.1f} s, "
            f"{n_crops} crops ({text.strip().replace(chr(10), '; ')})")
        text, secs = run_cli(phase, "masks", "--graphs", str(out), "--out",
                             str(out), "--crops", str(crops))
        mask_root = out / "masks" / "rad_16"
        n_scene = sum(len(list((mask_root / n).glob("*.npz")))
                      for n in names)
        n_crop = sum(len(list(d.glob("*.npz"))) for d in mask_root.iterdir()
                     if d.name not in names)
        check(n_scene == 32 and n_crop > 0,
              f"{phase}: masks wrote {n_scene} scene and {n_crop} crop "
              f"masks: {text}")
        say(phase, f"masks (rad_16, radius 16, 16 a scene): {secs:.1f} s, "
            f"{n_scene} scene masks and {n_crop} projected into crops")

        # --- the bf16 config trained on the preprocessed scenes
        roots = {"train": str(out), "val": str(out)}
        cfg = trainer_config(tmp / "bf16.json", roots, tmp / "saved",
                             BF16_CONFIG, PREP_EPOCHS)
        counters = _train_counters()
        _zero(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with probed_trainer(torch) as (probes, _):
            trainer = cli.main(["-c", str(tmp / "bf16.json"), "-d", "cuda",
                                "-n", "preprocessed"])
        launches = _read(counters)
        probe = probes[0]
        # K3a and K3c launch only where a level's band fits the windowed
        # dispatch's caps (ops/message_passing.py:HALO_CAPS), which a room
        # of this size need not do: read here, and held per step to the
        # calls of a plain-path step below
        check(all(launches[k] > 0 for k in ("k1", "k1dp", "k1dq", "k2")),
              f"{phase}: a kernel of the bf16 train path never launched: "
              f"{launches}")
        losses = [float(x) for x in probe.losses]
        check(len(losses) == PREP_EPOCHS and all(
            math.isfinite(x) for x in losses), f"{phase}: losses {losses}")
        check_trainer_launches(torch, cfg, probe, "cuda")
        train_scene = ScanNetGraphColorDataSet(str(out), "rad_16", 3,
                                               is_train=True)[0]
        halos = [lv.edges.halo for lv in build_hierarchical_graph(
            [train_scene], windowed=True).levels]
        say(phase, f"bf16 config through the trainer's CLI on the "
            f"preprocessed train scene, {PREP_EPOCHS} epochs: losses "
            f"{[round(x, 6) for x in losses]}; launches {launches}, each "
            "step equal to the calls a plain-path step records on its "
            f"batch; the scene's windowed halos by level {halos} (caps "
            f"{HALO_CAPS})")
        trainer_readings(phase, trainer, probe, card)
        del trainer, probes, probe

        # --- every crop through the ScanNet loader
        crop_root = tmp / "crop_root"
        crop_root.mkdir()
        (crop_root / "graphs").symlink_to(crops / "graphs")
        (crop_root / "masks").symlink_to(out / "masks")
        # every mask id the masks subcommand wrote (the config's
        # num_train_masks 1 would skip the crops without mask 0)
        args = copy.deepcopy(cfg["data_loader"]["args"])
        args.update(train_root_dir=str(crop_root), no_train_cropped=False,
                    num_train_masks=16)
        t0 = time.perf_counter()
        loader = ScanNetGraphColorDataLoader(args)
        n_train = len(loader.train_loader.dataset)
        batches = sum(1 for _ in loader.train_loader)
        n_written = len(list((crops / "graphs").glob(f"{names[0]}_*")))
        n_masked = len(list(mask_root.glob(f"{names[0]}_*")))
        check(batches == n_train == n_masked - 1, f"{phase}: the crop "
              f"loader gave {batches} batches of {n_train} crops, of "
              f"{n_masked} with masks")
        say(phase, f"the ScanNet loader (no_train_cropped false, 16 mask "
            f"ids) read and built {n_train} crops of the train scene's "
            f"{n_masked} with masks (of {n_written} written; the loader's "
            "seeded subsample leaves one a scene out, as the reference's) in "
            f"{time.perf_counter() - t0:.1f} s, windowed; build ms a crop "
            f"median {statistics.median(loader.train_loader.build_ms):.2f}")
        del loader

        # --- the flagship served on the val scene the loader reads
        scene = ScanNetGraphColorDataSet(str(out), "rad_16", 3,
                                         is_train=False)[0]
        model = define_G(**FLAGSHIP,
                         generator=torch.Generator().manual_seed(0))
        server = SceneInpainter(model, model.state_dict(), device="cuda")
        pred, got = serve_counted(torch, server, scene)
        n = scene.num_vertices[0]
        check_output(pred, n, phase)
        check(got["k1"] == flagship["k1"] and got["k2"] == flagship["k2"],
              f"{phase}: predict launched K1 {got['k1']} and K2 "
              f"{got['k2']} times, the flagship's predict {flagship}")
        ms, split = time_predict(torch, server, scene, PREDICT_REPS)
        say(phase, f"SceneInpainter.predict on the preprocessed val scene "
            f"{scene.num_vertices}: finite in [-1, 1], K1 {got['k1']} and "
            f"K2 {got['k2']} launches; {ms:.2f} ms/scene end to end, by "
            f"phase: {split}; on {card}")
    say(phase, f"phase wall time {time.perf_counter() - t_phase:.1f} s")


def texture_phase(torch, card):
    """Phase 16: texture-map optimization on the card: a TEX_VERTICES room,
    TEX_FRAMES look-down frames of TEX_WIDTH x TEX_HEIGHT z-buffered by the
    native rasterizer and colored by a smooth field, poses perturbed by
    0.01 rad and 0.01 m on frames 1..; estimate_vertex_colors on the card
    against the CPU on TEX_CPU_FRAMES frames, then rigid_optimize for
    TEX_ITERS iterations, timed."""
    import numpy as np
    from stinet_tpu_torch.preprocessing import native as decimator
    from stinet_tpu_torch.preprocessing import texture_optimization as tex
    from stinet_tpu_torch.utils.synthetic_sensor import (
        SCANNET_INTRINSICS, look_down_poses, perturb_poses, room_mesh,
        sensor_frames)
    phase = "texture-optimization"
    t_phase = time.perf_counter()
    intr, w, h = SCANNET_INTRINSICS, TEX_WIDTH, TEX_HEIGHT
    t0 = time.perf_counter()
    v, f, _ = room_mesh(TEX_VERTICES, seed=2)
    poses = look_down_poses(TEX_FRAMES, seed=2)
    before = decimator.calls.get("rasterize_depth", 0)
    colors, depths = sensor_frames(v, f, poses, intr, w, h)
    check(decimator.calls["rasterize_depth"] - before == TEX_FRAMES,
          f"{phase}: the frames were not rasterized natively")
    noisy = perturb_poses(poses, 0.01, 0.01, seed=3)
    say(phase, f"{TEX_FRAMES} frames of {w} x {h} of a {len(v)}-vertex room "
        f"rendered on the host in {time.perf_counter() - t0:.1f} s; "
        f"{(depths > 0).mean():.1%} of pixels covered; colors "
        f"{colors.nbytes / 1e6:.0f} MB, depths {depths.nbytes / 1e6:.0f} MB")

    k = TEX_CPU_FRAMES
    zero = np.zeros((k, 6), np.float32)
    with torch.no_grad():
        got_c, got_w = tex.estimate_vertex_colors(
            *tex._tensors("cuda", v, noisy[:k], zero), intr,
            *tex._tensors("cuda", colors[:k], depths[:k]), w, h)
        want_c, want_w = tex.estimate_vertex_colors(
            *tex._tensors("cpu", v, noisy[:k], zero), intr,
            *tex._tensors("cpu", colors[:k], depths[:k]), w, h)
    flips = int((got_w.cpu() != want_w).sum())
    agree = (got_w.cpu() == want_w).all(0)
    err = float((got_c.cpu()[agree] - want_c[agree]).abs().max())
    check(flips <= TEX_FLIP_SHARE * want_w.numel(),
          f"{phase}: {flips} visibility flips, card vs CPU")
    check(err <= TEX_TOL, f"{phase}: colors, card vs CPU, max |diff| "
          f"{err:.3e} > {TEX_TOL}")
    say(phase, f"estimate_vertex_colors on {k} frames, card vs CPU: "
        f"{flips} of {want_w.numel()} visibility tests flip; colors of the "
        f"{int(agree.sum())} vertices whose tests agree max |diff| "
        f"{err:.3e}; {int((want_w.sum(0) > 0).sum())} vertices seen")

    tv, tp, tc, td = tex._tensors("cuda", v, noisy, colors, depths)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vcol, deltas, hist = tex.rigid_optimize(tv, tp, intr, tc, td, w, h,
                                            iters=TEX_ITERS, lr=TEX_LR)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(x) for x in hist) and hist[-1] < hist[0],
          f"{phase}: residual {hist[0]} -> {hist[-1]}")
    check(bool(np.isfinite(vcol).all()) and not deltas[0].any(),
          f"{phase}: colors finite and frame 0 anchored")
    say(phase, f"rigid_optimize {TEX_ITERS} iterations at lr {TEX_LR}, "
        f"F={TEX_FRAMES}, V={len(v)}: residual {hist[0]:.6e} -> "
        f"{hist[-1]:.6e}; largest delta {np.abs(deltas).max():.3e}; "
        f"{secs:.2f} s by the host clock (a sync each iteration); peak "
        f"device memory {peak:.2f} GiB; on {card}")

    step, _ = tex.make_rigid_step(tv, tp, intr, tc, td, w, h, lr=TEX_LR)
    for _ in range(2):
        step()
    times = [ev_ms(torch, step) for _ in range(TEX_STEP_REPS)]
    say(phase, f"a rigid iteration by CUDA events, median of "
        f"{TEX_STEP_REPS}: {statistics.median(times):.3f} ms "
        f"({', '.join(f'{x:.3f}' for x in times)}); on {card}")
    traced_steps(torch, phase, step, card, "rigid iteration")
    say(phase, f"phase wall time {time.perf_counter() - t_phase:.1f} s")


def serving_hostile(torch, card, model, weights):
    """Phase 17: the flagship f32 `predict` on hostile_scene(
    HOSTILE_VERTICES, kind) for the sphere and the terrain, plain (K1) and
    windowed (K3b): ms/scene, the host build's share, launches."""
    from stinet_tpu_torch.serving import SceneInpainter
    from stinet_tpu_torch.utils.hostile import hostile_scene
    phase = "serving-hostile"
    servers = {"plain": SceneInpainter(model, weights, device="cuda"),
               "windowed": SceneInpainter(model, weights, device="cuda",
                                          windowed=True)}
    scenes = {}
    for kind in ("sphere", "terrain"):
        t0 = time.perf_counter()
        scene = scenes[kind] = hostile_scene(HOSTILE_VERTICES, kind)
        halos = [lv.edges.halo
                 for lv in servers["windowed"].build(scene).levels]
        say(phase, f"hostile_scene({HOSTILE_VERTICES}, {kind!r}) built in "
            f"{time.perf_counter() - t0:.1f} s: level sizes "
            f"{scene.num_vertices}, windowed halos by level {halos}")
        outs = {}
        for layout, server in servers.items():
            outs[layout], got = serve_counted(torch, server, scene)
            check_output(outs[layout], scene.num_vertices[0],
                         f"{phase} {kind} {layout}")
            # the windowed dispatch may send every conv of a scene whose
            # band it cannot hold to K1: read here, not required
            check(got["k2"] > 0 and got["k1"] + got["k3b"] > 0 and (
                layout == "windowed" or got["k3b"] == 0),
                f"{phase} {kind} {layout}: launches {got}")
            ms, split = time_predict(torch, server, scene, HOSTILE_REPS)
            build = float(split.split(",")[0].split()[1])
            say(phase, f"{kind} {layout}: {ms:.2f} ms/scene end to end, "
                f"host build {build / ms:.1%} of it; by phase: {split}; "
                f"launches K1 {got['k1']}, K3b {got['k3b']}, K2 "
                f"{got['k2']}; on {card}")
        err = float(abs(outs["plain"] - outs["windowed"]).max())
        check(err <= PATH_TOL, f"{phase} {kind}: windowed vs plain max "
              f"|diff| {err:.3e} > {PATH_TOL}")
        say(phase, f"{kind}: windowed against plain max |diff| {err:.3e}")
    return scenes


# --- graph-partition serving on an in-process mesh --------------------------

PART_COUNTS = (1, 2, 4)     # partitions of the in-process mesh
PART_RTOL, PART_ATOL = 1e-4, 1e-5   # f32 partitioned vs predict (JAX's)
# bf16 partitioned vs bf16 predict: both round every op to bf16, in other
# orders (the norm's sums, the slots of a row), amplified through 15 blocks;
# flagship width at 4096 vertices on the CPU: mean 0.012, max 0.091
PART_BF16_MEAN_TOL, PART_BF16_MAX_TOL = 0.03, 0.25
PART_REPS = 5               # timed predict_partitioned calls a P


def k1_call_bound(torch, p, q, nbr, deg):
    """(bytes, operations) one K1 forward call's data needs: deg and out
    for every row, the live slots of nbr, p of each row with an edge, q of
    each sender once."""
    v, h = p.shape
    es = p.element_size()
    live = torch.arange(nbr.shape[1], device=deg.device) < deg[:, None]
    slots = int(live.sum())
    senders = int(torch.unique(nbr[live]).numel())
    receivers = int(torch.count_nonzero(deg))
    return (4 * (v + slots) + es * (v * h + h * (receivers + senders)),
            3 * h * slots)


def time_partitioned(torch, server, scene, reps):
    """`server.predict_partitioned(scene)` end to end by the host clock
    (median of `reps` after a warm call), then its steps one by one, each
    run to its end: host partition build, place, forward (all partitions,
    gathered), copy back and reorder. Returns (ms, {step: ms})."""
    server.predict_partitioned(scene)
    e2e = []
    for _ in range(reps):
        t = time.perf_counter()
        server.predict_partitioned(scene)
        e2e.append((time.perf_counter() - t) * 1e3)
    steps = {"partition build": [], "place": [], "forward": [],
             "copy back": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        pg, info = server.build_partitioned(scene)
        t1 = time.perf_counter()
        graphs = server.place_partitioned(pg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = server.forward_partitioned(graphs)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.cpu().numpy()[info.new_id[0]]
        t4 = time.perf_counter()
        for k, a, b in (("partition build", t0, t1), ("place", t1, t2),
                        ("forward", t2, t3), ("copy back", t3, t4)):
            steps[k].append((b - a) * 1e3)
    return statistics.median(e2e), {k: statistics.median(v)
                                    for k, v in steps.items()}


def partitioned_phase(torch, card, model, weights, scenes, flagship_scene):
    """Phase 18: `SceneInpainter.predict_partitioned` of the flagship f32
    model on an in-process mesh of 1, 2 and 4 partitions on the card (the
    terrain, and the sphere, whose vertex order makes every hop's halo wide),
    then the bf16 model on the terrain. For each P: the K1 calls of one
    plain-path call recorded; the kernel path's launches counted around one
    call (K1 = the recorded calls, q of more rows than p at P > 1; K2 and K3
    none: the partitioned norm is summed across partitions); every recorded
    call replayed on K1, bitwise its plain version, and timed; the output
    within PART_RTOL / PART_ATOL of `predict`; ms end to end with the
    host partition build's share, the device forward by CUDA events, beside
    `predict`'s. The flagship's synthetic scene is refused (a level-0
    cluster of more than 128 children), as the JAX package refuses it.
    Returns the kernels-line row of K1 on the halo layout (P = 4, terrain)."""
    import numpy as np
    from stinet_tpu_torch.graph.partition import partition_hierarchy
    from stinet_tpu_torch.models.factory import FLAGSHIP, define_G
    from stinet_tpu_torch.ops import ell
    from stinet_tpu_torch.parallel.mesh import make_mesh
    from stinet_tpu_torch.serving import SceneInpainter
    phase = "partitioned"
    t_phase = time.perf_counter()
    try:
        partition_hierarchy(flagship_scene, 2)
        raise RuntimeError("the flagship scene partitioned; expected the "
                           "children cap to refuse it")
    except ValueError as e:
        say(phase, f"flagship synthetic scene refused, as JAX's: {e}")
    counters = dict(_train_counters(), **_counters())
    row = None
    for dtype in (None, torch.bfloat16):
        m = model if dtype is None else define_G(
            **FLAGSHIP, dtype=dtype, generator=torch.Generator().manual_seed(0))
        tag = "f32" if dtype is None else "bf16"
        plain = SceneInpainter(m, weights, device="cuda")
        kinds = ("terrain", "sphere") if dtype is None else ("terrain",)
        for kind in kinds:
            scene = scenes[kind]
            ref = plain.predict(scene)
            p_ms, p_split = time_predict(torch, plain, scene, PART_REPS)
            say(phase, f"{kind} {tag}: predict {p_ms:.2f} ms/scene "
                f"({p_split}); on {card}")
            for n_parts in PART_COUNTS:
                if kind == "sphere" and n_parts == 1:
                    continue
                mesh = make_mesh(n_parts, "cuda")
                server = SceneInpainter(m, weights, device="cuda", mesh=mesh)
                recorder = SceneInpainter(m, weights, device="cuda",
                                          mesh=mesh, impl="plain")
                with record_calls({"k1": (ell, "ell_edge_conv_sum_plain")}
                                  ) as calls:
                    recorder.predict_partitioned(scene)
                    torch.cuda.synchronize()
                k1_calls = calls["k1"]
                _zero(counters)
                out = server.predict_partitioned(scene)
                got = _read(counters)
                check(got["k1"] == len(k1_calls) > 0 and got["k1"] % n_parts
                      == 0, f"{phase} {kind} {tag} P={n_parts}: K1 launched "
                      f"{got['k1']} times, {len(k1_calls)} calls recorded")
                check(all(v == 0 for k, v in got.items() if k != "k1"),
                      f"{phase} {kind} {tag} P={n_parts}: launches {got}")
                ragged = [c for c in k1_calls if c[1].shape[0] > c[0].shape[0]]
                check(n_parts == 1 or len(ragged) == len(k1_calls),
                      f"{phase}: {len(k1_calls) - len(ragged)} K1 calls at "
                      f"P={n_parts} with q no longer than p")
                err = 0.0
                for i, (p, q, nbr, deg) in enumerate(k1_calls):
                    a = ell.ell_edge_conv_sum_kernel(p, q, nbr, deg)
                    b = ell.ell_edge_conv_sum_plain(p, q, nbr, deg)
                    torch.cuda.synchronize()
                    err = max(err, float((a.float() - b.float()).abs().max()))
                    view = torch.int16 if a.dtype == torch.bfloat16 \
                        else torch.int32
                    check(torch.equal(a.view(view), b.view(view)),
                          f"{phase} {kind} {tag} P={n_parts}: K1 call {i} "
                          f"p {tuple(p.shape)} q {tuple(q.shape)} differs "
                          "from its plain version")
                check_output(out, scene.num_vertices[0],
                             f"{phase} {kind} {tag} P={n_parts}")
                diff = np.abs(out - ref)
                if dtype is None:
                    worst = float((diff / (PART_ATOL + PART_RTOL
                                           * np.abs(ref))).max())
                    check(worst <= 1.0, f"{phase} {kind} P={n_parts}: max "
                          f"|diff| {diff.max():.3e} beyond rtol {PART_RTOL} "
                          f"atol {PART_ATOL} of predict ({worst:.2f}x)")
                    agree = (f"within rtol {PART_RTOL} atol {PART_ATOL} of "
                             f"predict (max |diff| {diff.max():.3e}, "
                             f"{worst:.2f} of the tolerance)")
                else:
                    check(diff.mean() <= PART_BF16_MEAN_TOL
                          and diff.max() <= PART_BF16_MAX_TOL,
                          f"{phase} {kind} bf16 P={n_parts}: |diff| mean "
                          f"{diff.mean():.3e} max {diff.max():.3e} against "
                          f"bf16 predict")
                    agree = (f"against bf16 predict |diff| mean "
                             f"{diff.mean():.3e} (<= {PART_BF16_MEAN_TOL}), "
                             f"max {diff.max():.3e} (<= {PART_BF16_MAX_TOL})")
                ms, split = time_partitioned(torch, server, scene, PART_REPS)
                graphs = server.place_partitioned(
                    server.build_partitioned(scene)[0])
                fwd = median_ms(torch,
                                lambda: server.forward_partitioned(graphs),
                                reps=10, inner=1)
                k1_ms = median_ms(torch, lambda: [
                    ell.ell_edge_conv_sum_kernel(*c) for c in k1_calls],
                    reps=10, inner=1)
                halo = [c[1].shape[0] - c[0].shape[0] for c in k1_calls]
                say(phase, f"{kind} {tag} P={n_parts}: K1 {got['k1']} "
                    f"launches, each call bitwise its plain version, q rows "
                    f"beyond p's {min(halo)}-{max(halo)}; {agree}; "
                    f"{ms:.2f} ms/scene end to end (predict {p_ms:.2f}), "
                    f"host partition build {split['partition build']:.2f} ms "
                    f"= {split['partition build'] / ms:.1%}; by step: "
                    + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
                    + f"; device forward {fwd:.3f} ms, its K1 calls "
                    f"{k1_ms:.3f} ms; on {card}")
                if dtype is None and kind == "terrain" and n_parts == 4:
                    plain_ms = median_ms(torch, lambda: [
                        ell.ell_edge_conv_sum_plain(*c) for c in k1_calls],
                        reps=5, inner=1)
                    nbytes = ops = 0
                    for c in k1_calls:
                        b_, o_ = k1_call_bound(torch, *c)
                        nbytes, ops = nbytes + b_, ops + o_
                    b_ms, b_by = bound(nbytes, ops)
                    row = dict(launches=got["k1"], max_abs_err=err, ms=k1_ms,
                               plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=None)
                del server, recorder, graphs, k1_calls
    say(phase, f"phase wall time {time.perf_counter() - t_phase:.1f} s")
    return row


@contextlib.contextmanager
def deterministic(torch):
    """torch's deterministic algorithms for the block (the spill's
    `index_add_` then sums in one order, so two forwards give the same
    bits; an op without a deterministic version warns), then the process's
    setting as it was."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def export_phase(torch, card, model, weights, scene):
    """Phase 19: `SceneInpainter.export` of the flagship f32 server, plain
    (K1 and K2 enter the program as the custom ops of ops/library.py) and
    windowed (K3b too), reloaded by `utils/model_io.load_serving` and
    called on the placed graph: the exported forward's launches counted
    around one call (each kernel as often as in the server's forward), its
    output bitwise the server's forward on the same graph (torch's
    deterministic algorithms on for both), the export's and the load's
    seconds, a call's device time beside the server's forward."""
    import tempfile
    from stinet_tpu_torch.serving import SceneInpainter
    from stinet_tpu_torch.utils.model_io import load_serving
    phase = "export"
    counters = dict(_train_counters(), **_counters())
    with tempfile.TemporaryDirectory() as tmp:
        for layout in ("plain", "windowed"):
            server = SceneInpainter(model, weights, device="cuda",
                                    windowed=layout == "windowed")
            t0 = time.perf_counter()
            path = server.export(scene, f"{tmp}/{layout}.pt2")
            t1 = time.perf_counter()
            fn = load_serving(path)
            t2 = time.perf_counter()
            graph = server.place(server._build_scene(scene)[0])
            with deterministic(torch):
                _zero(counters)
                want = server.forward(graph)
                torch.cuda.synchronize()
                expect = _read(counters)
                _zero(counters)
                got = fn(graph)
                torch.cuda.synchronize()
                launched = _read(counters)
                again = server.forward(graph)
            check(launched == expect and launched["k1"] + launched["k3b"]
                  > 0 and launched["k2"] > 0,
                  f"{phase} {layout}: the exported forward launched "
                  f"{launched}, the server's forward {expect}")
            check(torch.equal(want, again), f"{phase} {layout}: two "
                  "forwards differ under deterministic algorithms")
            err = float((got - want).abs().max())
            check(torch.equal(got, want), f"{phase} {layout}: the exported "
                  f"forward differs from the server's (max |diff| {err:.3e})")
            ms = median_ms(torch, lambda: fn(graph), reps=10, inner=1)
            fwd = median_ms(torch, lambda: server.forward(graph), reps=10,
                            inner=1)
            say(phase, f"flagship {layout}: exported in {t1 - t0:.1f} s, "
                f"loaded in {t2 - t1:.1f} s; launches {launched}, as the "
                f"server's forward; output bitwise the server's forward; a "
                f"call {ms:.3f} ms, the server's forward {fwd:.3f} ms; on "
                f"{card}")


def capture_k1_calls(torch):
    """The K1 calls of one flagship f32 forward (phase 3's) and of one bf16
    train step (phase 6's), recorded on the plain path: (f32 forward calls,
    a list of (p, q, nbr, deg); {"k1", "k1dp", "k1dq": the step's forward,
    dp and dq calls})."""
    from stinet_tpu_torch.models.factory import FLAGSHIP, define_G
    from stinet_tpu_torch.serving import SceneInpainter
    from stinet_tpu_torch.utils.synthetic import (
        FLAGSHIP_SCENE, synthetic_scene)
    scene = synthetic_scene(**FLAGSHIP_SCENE)
    model = define_G(**FLAGSHIP, generator=torch.Generator().manual_seed(0))
    plain = SceneInpainter(model, model.state_dict(), device="cuda",
                           impl="plain")
    f32, _ = capture_kernel_inputs(plain, plain.place(plain.build(scene)))
    cfg = json.loads(pathlib.Path(BF16_CONFIG).read_text())
    train_model = define_G(**cfg["archs"]["SurfaceTextureInpaintingNet"][
        "args"], generator=torch.Generator().manual_seed(0)).cuda()
    _, wgraph = windowed_build(torch, scene, train_model)
    step = capture_train_calls(torch, train_model, wgraph, cfg)
    return f32, {k: step[k] for k in ("k1", "k1dp", "k1dq")}


def k1_only(torch, card):
    """--k1-only: phase 3's f32 K1 forward calls and phase 6's bf16 K1
    forward, dp and dq calls alone, each held bitwise against its plain
    version and timed as in the full run (back to back, host, card alone,
    bound, plan); one JSON line of the sums. With --tree, on another
    checkout's package, so that two versions of the kernels are timed by
    the same code in one process each."""
    import stinet_tpu_torch
    say("k1-only", "package "
        f"{pathlib.Path(stinet_tpu_torch.__file__).resolve().parent}")
    f32_calls, step_calls = capture_k1_calls(torch)
    f32 = check_k1(torch, f32_calls)
    step = check_train_kernels(torch, dict(step_calls, k3a=[], k3c=[], k2=[]))
    sums = {"f32": f32, "bf16": step["k1"], "dp": step["k1dp"],
            "dq": step["k1dq"]}
    for name, row in (("f32 forward", f32), ("bf16 train step", sums["bf16"]),
                      ("dp of the bf16 train step", sums["dp"]),
                      ("dq of the bf16 train step", sums["dq"])):
        say("k1-only", f"K1 {name}: kernel {row['ms']:.4f} ms, device alone "
            f"{row['device_ms']:.4f} ms, host {row['host_us']:.1f} us a "
            f"call, bound {row['bound_ms']:.4f} ms; on {card}")
    print(json.dumps({"k1": sums}), flush=True)
    return 0


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k1-only", action="store_true",
                    help="time the K1 forward, dp and dq calls of phases 3 "
                    "and 6 only")
    ap.add_argument("--tree", help="with --k1-only: the checkout whose "
                    "stinet_tpu_torch package to time (default: this one)")
    args = ap.parse_args(argv)
    if args.tree and not args.k1_only:
        ap.error("--tree goes with --k1-only")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    if args.tree:
        sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
    t_start = time.perf_counter()
    card = device_record(torch)
    build_kernels()
    if args.k1_only:
        return k1_only(torch, card)
    host_build_phase(torch, card)

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
    before = native_calls()
    out = server.predict(scene)
    n_native = check_native("slice", before)
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
        f"{launches}; native build calls {n_native}; kernel vs plain path "
        f"max |diff| {path_err:.3e}")

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
    with env(STINET_NATIVE_BUILD=0):
        np_ms, np_split = time_predict(torch, server, scene, PREDICT_REPS)
    fwd_ms = median_ms(torch, lambda: server.forward(graph), reps=20,
                       inner=1)
    plain_fwd_ms = median_ms(torch, lambda: plain_server.forward(graph),
                             reps=20, inner=1)
    say("slice", f"predict {ms:.2f} ms/scene = "
        f"{nv / ms * 1e3:.0f} vertices/s end to end; by phase, median ms "
        f"of {PREDICT_REPS}: {split}; device forward {fwd_ms:.3f} ms "
        f"kernel path, {plain_fwd_ms:.3f} ms plain path; on {card}")
    say("slice", f"the same with the numpy builder (STINET_NATIVE_BUILD=0): "
        f"predict {np_ms:.2f} ms/scene end to end; by phase: {np_split}")

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
            + (f", K1 on the same inputs {r['ab_ms']:.4f} ms; device alone "
               f"{r['device_ms']:.4f} ms against K1's {r['k1_device_ms']:.4f}"
               if key in ("k3a", "k3c") else "")
            + (f"; device alone {r['device_ms']:.4f} ms, host "
               f"{r['host_us']:.1f} us a call"
               if key in ("k1", "k1dp", "k1dq") else ""))
    train_launches = train_slice(torch, card, train_model, wgraph, cfg,
                                 captured)

    # --- the trainer and its CLI
    del train_model, wgraph, captured
    trainer_phase(torch, card)
    segmentation_phase(torch, card)
    inpainting2d_phase(torch, card)
    inpainting2d_resnet_phase(torch, card)

    # --- windowed f32 and batched serving
    wserver, k3b, w_launches = serving_windowed(torch, card, scene, whost,
                                                weights, out)
    k2mg, b_launches = serving_batched(
        torch, card, wserver, scene,
        (wserver._normalize_widths(whost), windowed_layout(scene)[1]))
    del wserver

    # --- the rest of the model: reference checkpoints, SageConv, labels,
    # stacked training
    flagship = {"k1": launches["ell_edge_conv_sum"],
                "k2": launches["masked_instance_norm"]}
    rest_of_the_model(torch, card, scene, flagship)

    # --- the offline preprocessing, texture optimization, hostile scenes
    preprocess_phase(torch, card, flagship)
    texture_phase(torch, card)
    hostile = serving_hostile(torch, card, model, weights)

    # --- graph-partition serving: predict_partitioned on an in-process mesh
    part_row = partitioned_phase(torch, card, model, weights, hostile, scene)
    # --- the forward exported with torch.export and reloaded
    export_phase(torch, card, model, weights, scene)

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
        row = dict(train_rows[key])
        if key in ("k3a", "k3c"):
            row["k1_same_inputs_ms"] = row["ab_ms"]
        elif key in ("k1", "k1dp", "k1dq"):
            del row["k1_device_ms"]
        else:
            del row["device_ms"], row["k1_device_ms"], row["host_us"]
        kernels.append(dict(name=name, route="cuda", source=cu + src,
                            replaces=replaces,
                            launches=train_launches[key], **row))
    kernels += [
        dict(name="windowed_edge_conv_sum_f32", route="cuda",
             source=cu + "windowed_edge_conv.cu",
             replaces="stinet_tpu/ops/pallas/onehot_gather.py:291",
             launches=w_launches["k3b"], **k3b),
        dict(name="masked_instance_norm_multigraph", route="cuda",
             source=cu + "instance_norm.cu",
             replaces="stinet_tpu/ops/pallas/instance_norm.py:77",
             launches=b_launches["k2mg"], **k2mg),
        dict(name="ell_edge_conv_sum_partitioned", route="cuda",
             source=cu + "ell_edge_conv.cu",
             replaces="stinet_tpu/ops/pallas/gather_pipeline.py:102",
             **part_row)]
    say("done", f"every phase passed in {time.perf_counter() - t_start:.1f} "
        f"s, the kernels' build included, on {card}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "k1_same_inputs_ms", "device_ms", "k1_device_ms", "host_us")
    print(json.dumps({"kernels": [{k: kd[k] for k in keys if k in kd}
                                  for kd in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
