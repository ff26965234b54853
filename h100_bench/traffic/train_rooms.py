"""Training on rooms as the CLI writes them, the path a user runs: the
rooms are written at set-up into the run's TMPDIR, then epoch after epoch
the loader (`ScanNetGraphColorDataLoader` over those files: reads,
transforms, the windowed build on its prefetch thread), `iter_placed`
(pack and copy on a side stream) and the train step, as
`Inpainting3DTrainer._train_epoch` drives them, with validation and
checkpoints off.

Set-up builds the one model, optimizer and step, and drives them through
their first steps (the comparison's) by the window's own call and feed,
then to the end of the first epoch; the window then goes on with the same
objects and the same feed. The rate
is optimizer steps (batch 1) over the window's time, the window made of
whole epochs (it ends at the first epoch's end after `seconds`, so every
seed's window steps on each room equally often); each step's wait for
its batch and its host time (the step ends in the host sync of its
metrics, as the trainer's does) are kept for the per-layer metrics.

With `--trace 0` the window runs under a profiler that records the
card's activity alone (no host ops), and the end-to-end metric is the
card's busy time (the union of every kernel, copy and set) over the
window's steps: device ms a scene, which the host's speed does not move.
With `--trace 1` the window runs unprofiled, and its rate (steps over the
window's time) is a per-layer metric, beside a traced epoch.
"""
import collections
import contextlib
import json
import os
import resource
import shutil
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchlib import counts, trace, weights
from reference import training_ref
from traffic import rooms as room_gen

# the numbers compared, each with a limit of its own in the cell's file
NUMBERS = ("loss_gap", "out_gap", "grad_gap", "grad_gap_median",
           "change_gap", "change_gap_median")


class Feed:
    """(graph, names) batches on the device, epoch after epoch, each epoch
    a fresh `iter_placed` over the loader, as the trainer's epochs are."""

    def __init__(self, loader, device):
        self.loader, self.device, self.it = loader, device, None

    def __next__(self):
        from stinet_tpu_torch.trainers.graph_common import iter_placed
        while True:
            if self.it is None:
                self.it = iter_placed(self.loader, self.device)
            try:
                return next(self.it)
            except StopIteration:
                self.it = None

    def close(self):
        if self.it is not None:
            self.it.close()
            self.it = None


def write_rooms(ctx, root):
    """Write the mix's rooms under scene names of the training split;
    returns {name: (level sizes, edge counts, coarsest dilated counts)}."""
    from stinet_tpu_torch.data.scannet import SCANNET_TRAIN_FILE, read_split
    r = ctx.mix["rooms"]
    sizes = room_gen.room_sizes(r["count"], r["min_vertices"],
                                r["max_vertices"])
    names = read_split(SCANNET_TRAIN_FILE)[:len(sizes)]
    L = r["levels"] - 1

    def one(k):
        room = room_gen.make_room(sizes[k], ctx.seed, k, levels=r["levels"],
                                  decimation=r["decimation"],
                                  dilation_dists=r["dilations"],
                                  dilation_levels=r.get("dilation_levels"))
        sub = room_gen.make_submission(room, ctx.seed, k)
        room_gen.write_room(root, names[k], room, sub)
        return names[k], (room.num_vertices, [e.shape[1] for e in room.edges],
                          {d: e.shape[1] for d, e in
                           room.dilated.get(L, {}).items()})

    order = sorted(range(len(sizes)), key=lambda k: -sizes[k])
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return dict(ex.map(one, order))


def _leaf_norms(ts):
    return {k: float(v.double().norm()) for k, v in ts.items()}


def leaf_gaps(got: dict, want: dict, counted) -> dict:
    """{leaf: the gap between the program's and the reference's norm of
    the leaf over the larger of the reference's norm of that leaf and of
    the median leaf}, over the counted leaves."""
    med = float(np.median([want[k] for k in counted]))
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in counted}


def aligned(out, x, ref_x):
    """The rows of `out` (in the order of the rows `x` of the program's
    input) in the order of the reference's input rows `ref_x`: rows are
    matched by their positions (columns 6:9), which no two vertices
    share."""
    def order(a):
        a = a.cpu().numpy() if torch.is_tensor(a) else a
        return np.lexsort((a[:, 8], a[:, 7], a[:, 6]))
    mine, theirs = order(x), order(ref_x)
    rows = np.empty_like(mine)
    rows[theirs] = mine
    return out[torch.as_tensor(rows, device=out.device)]


def compare(W0, losses, g1, W3, ref, out1=None, ref_x=None):
    """{number: reading} of a run against the reference's first steps:
    the widest relative gap of a step's loss; the relative L2 gap of the
    first step's output rows (out1: the program's output and input rows);
    of the first gradient's and
    the change's leaf norms, the worst leaf and the median leaf (the worst
    leaf swings with one small leaf's rounding; the median is steady from
    seed to seed); and the leaves left out."""
    ref_losses, ref_g1, ref_W3, ref_out = ref
    if out1 is None:
        out_gap = 0.0
    else:
        got = aligned(out1[0], out1[1], ref_x).float()
        out_gap = float((got - ref_out).norm() / ref_out.norm())
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    rg = _leaf_norms(ref_g1)
    med = float(np.median(list(rg.values())))
    # leaves whose gradient is nought to rounding in the reference (a bias
    # before an affine-free norm) move under Adam by round-off alone
    counted = [k for k, v in rg.items() if v >= 1e-3 * med]
    grad = leaf_gaps(_leaf_norms(g1), rg, counted)
    change = leaf_gaps(
        _leaf_norms({k: W3[k].float() - W0[k].float() for k in W0}),
        _leaf_norms({k: ref_W3[k].float() - W0[k].float() for k in W0}),
        counted)
    worst_g, worst_c = max(grad, key=grad.get), max(change, key=change.get)
    return {"loss_gap": loss_gap, "out_gap": out_gap,
            "grad_gap": grad[worst_g],
            "grad_gap_median": float(np.median(list(grad.values()))),
            "change_gap": change[worst_c],
            "change_gap_median": float(np.median(list(change.values()))),
            "worst_leaves": [worst_g, worst_c],
            "left_out": sorted(set(rg) - set(counted))}


def host_line(epoch_ends, rooms, waits, step_ms, ru0, ru1):
    """One line on standard error of how steady the host was inside the
    window: each epoch's seconds, the spread of one room's wait and of
    its step from epoch to epoch (the median over the rooms of the
    quartile distance over the median), and the process's CPU seconds
    over the window."""
    def spread(values):
        by_room = collections.defaultdict(list)
        for r, v in zip(rooms, values):
            by_room[r].append(v)
        shares = []
        for vs in by_room.values():
            if len(vs) >= 2:
                q = statistics.quantiles(vs, n=4)
                shares.append((q[2] - q[0]) / statistics.median(vs))
        return 100.0 * statistics.median(shares) if shares else float("nan")
    epochs = [round(float(e), 3) for e in np.diff([0.0] + epoch_ends)]
    print(f"[train] host: epochs {epochs} s; a room's wait spreads "
          f"{spread(waits):.1f}% and its step {spread(step_ms):.1f}% from "
          f"epoch to epoch; cpu user {ru1.ru_utime - ru0.ru_utime:.2f} s, "
          f"sys {ru1.ru_stime - ru0.ru_stime:.2f} s",
          file=sys.stderr, flush=True)


def run(ctx):
    from stinet_tpu_torch.data.scannet import ScanNetGraphColorDataLoader
    from stinet_tpu_torch.models.factory import define_G
    from stinet_tpu_torch.ops import _cuda
    from stinet_tpu_torch.trainers import graph_common as gc
    if ctx.device.type == "cuda":
        _cuda.build()
    cfg = ctx.config["config"]
    root = tempfile.mkdtemp(prefix="h100_bench_rooms_",
                            dir=os.environ.get("TMPDIR"))
    try:
        return _run(ctx, cfg, root, ScanNetGraphColorDataLoader, define_G, gc)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(ctx, cfg, root, Loader, define_G, gc):
    shapes = write_rooms(ctx, root)
    dl_args = dict(cfg["data_loader"]["args"], train_root_dir=root,
                   val_root_dir=root)
    loader_seed = ctx.seed % (1 << 31)
    loader = Loader(dl_args, seed=loader_seed).train_loader
    W0 = weights.make(ctx.args, ctx.seed, ctx.device)
    model = define_G(**ctx.args).to(ctx.device)
    model.load_state_dict(W0)
    opt, base_lr = gc.build_optimizer(model.parameters(), cfg["optimizer"])
    lr = gc.step_lr(base_lr, cfg.get("lr_scheduler", {}))(1)
    step, _ = gc.make_inpainting_steps(
        model, opt, cfg["trainer"].get("use_mask_weighted_loss", False))
    feed = Feed(loader, ctx.device)
    beta1 = opt.param_groups[0]["betas"][0]
    named = dict(model.named_parameters())

    # the comparison's first steps, by the window's call and feed
    first_names, losses, g1 = [], [], None
    for k in range(ctx.mix["compared_steps"]):
        graph, names = next(feed)
        if k == 0:      # the program's first output, with its input rows
            kept = []
            hook = model.register_forward_hook(
                lambda m, inp, out: kept.append(out.detach().float()))
        losses.append(gc.host_metrics(step(graph, lr))["loss"])
        first_names += list(names)
        if k == 0:
            hook.remove()
            nv0 = int(graph.levels[0].num_vertices)
            out1 = (kept[0][:nv0].clone(), graph.x[:nv0].cpu().numpy())
            g1 = {n: opt.state[p]["exp_avg"].detach().clone() / (1 - beta1)
                  if p in opt.state else torch.zeros_like(p)
                  for n, p in named.items()}
    W3 = {n: p.detach().clone() for n, p in named.items()}
    # the rest of the first epoch, so that the window starts at an epoch's
    # start: a window of whole epochs begun mid-epoch would hold another
    # mix of room sizes on each seed
    per_epoch = len(loader)
    for _ in range(-ctx.mix["compared_steps"] % per_epoch):
        graph, names = next(feed)
        gc.host_metrics(step(graph, lr))
    setup_s = time.perf_counter() - ctx.setup_t0

    flops = {n: 3.0 * counts.forward_flops(ctx.args, *s)
             for n, s in shapes.items()}
    waits, step_ms, done_flops, epoch_ends, rooms = [], [], 0.0, [], []
    on_card = trace.Summary()
    profiled = (trace.Session(on_card, device_only=True)
                if not ctx.trace and ctx.device.type == "cuda"
                else contextlib.nullcontext())
    with profiled:
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = t_end = time.perf_counter()
        # whole epochs: every window steps on each room equally often
        while t_end - t0 < ctx.seconds or len(step_ms) % per_epoch:
            a = time.perf_counter()
            graph, names = next(feed)
            b = time.perf_counter()
            gc.host_metrics(step(graph, lr))
            t_end = time.perf_counter()
            waits.append((b - a) * 1e3)
            step_ms.append((t_end - b) * 1e3)
            rooms.append(names[0])
            done_flops += sum(flops[n] for n in names)
            if len(step_ms) % per_epoch == 0:
                epoch_ends.append(t_end - t0)
        window = t_end - t0
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
    device_ms = (1e3 * on_card.busy_s / len(step_ms) if on_card.busy_s > 0
                 else None)
    busy = (f", profiled: the card busy {device_ms!r} ms a step"
            if device_ms else "")
    print(f"[train] {len(step_ms)} steps in {window:.3f} s{busy}; mean "
          f"wait {np.mean(waits):.1f} ms, mean step {np.mean(step_ms):.1f} "
          f"ms", flush=True)
    host_line(epoch_ends, rooms, waits, step_ms, ru0, ru1)
    facts = {"window_s": window, "steps": len(step_ms), "wait_ms": waits,
             "step_ms": step_ms, "flops": done_flops,
             "dtype": ctx.args.get("dtype") or "float32"}

    summary = None
    if ctx.trace:
        summary = trace.Summary()
        bounds = collections.Counter()
        with trace.OpRanges() as ops:
            for _ in range(ctx.mix["trace_steps"]):
                with trace.Session(summary):
                    with trace.span("train.wait"):
                        graph, names = next(feed)
                    with trace.span("train.step"):
                        gc.host_metrics(step(graph, lr))
                for n, s in ops.bounds().items():
                    bounds[n] += s
        summary.items = ctx.mix["trace_steps"]
        facts.update(trace=summary, bounds=dict(bounds))
    peak = (torch.cuda.max_memory_allocated() if ctx.device.type == "cuda"
            else 0)
    feed.close()
    del feed, graph, step, opt, model, named
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    checks, calibration = reference_checks(ctx, cfg, root, loader_seed,
                                           shapes, W0, losses, g1, W3, lr,
                                           first_names, out1)
    out = dict(setup_s=setup_s, attempted=len(step_ms), failed=0,
               e2e={"train_device_ms_per_scene": device_ms},
               facts=facts, checks=checks, memory_peak_bytes=peak,
               summary=summary)
    if ctx.calibrate:
        out["calibration"] = calibration
    return out


def reference_checks(ctx, cfg, root, loader_seed, shapes, W0, losses, g1,
                     W3, lr, first_names, out1):
    dl = cfg["data_loader"]["args"]
    names = sorted(shapes)
    order = training_ref.schedule(names, loader_seed, 0)
    steps = len(losses)
    coarse = sorted({int(d) for d in ctx.args["dilations"] if int(d) > 1})
    samples = [training_ref.load_sample(
        root, names[i], i, loader_seed, 0, dl["train_transform"],
        dl["end_level"], coarse) for i in order[:steps]]
    # the scenes the program stepped on are the schedule's
    stepped_other = int([names[i] for i in order[:steps]] != first_names)
    ref = training_ref.train(W0, ctx.args, samples, lr, ctx.device)
    ref_x = samples[0][4]
    got = compare(W0, losses, g1, W3, ref, out1, ref_x)
    # a number with no limit in the cell's file is read but not compared
    # (it had no upper reading: see PERF.md)
    checks = [("scenes_out_of_schedule", stepped_other, 0)] + [
        (k, got[k], ctx.limits[k]) for k in NUMBERS if k in ctx.limits]
    print(f"[train] readings {json.dumps({k: got[k] for k in NUMBERS})}",
          flush=True)
    print(f"[train] leaves left out by the reference's gradient: "
          f"{got['left_out']}; worst leaves (gradient, change): "
          f"{got['worst_leaves']}", flush=True)
    calibration = None
    if ctx.calibrate:
        calibration = {"program": [got[k] for k in NUMBERS]}
        for label, kw in (("control_fp8", dict(precision="fp8")),
                          ("fault_half_batch", dict(half=True))):
            a_losses, a_g1, a_W3, a_out = training_ref.train(
                W0, ctx.args, samples, lr, ctx.device, **kw)
            alt = compare(W0, a_losses, a_g1, a_W3, ref, (a_out, ref_x),
                          ref_x)
            calibration[label] = [alt[k] for k in NUMBERS]
            calibration[label + "_worst_leaves"] = alt["worst_leaves"]
    return checks, calibration
