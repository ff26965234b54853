"""Where the device time of one flagship forward, or train step, goes.

    python -m stinet_tpu_torch.utils.profile_forward [--impl plain]
        [--train] [--reps 5]

Builds the flagship scene and model (the ones chip_smoke.py drives): the
f32 serving forward, or with --train the bf16 windowed train step of the
production bf16 config. Places the graph on the card, warms up, times
`--reps` runs with CUDA events (no profiler), then traces `--reps` more
with torch.profiler. Prints, per run: the untraced wall time, the device
busy time of the traced runs (the sum of kernel durations: one stream, so
kernels do not overlap), the idle share (1 - busy / untraced wall: tracing
slows the host's launches, so the traced window's own wall time overstates
it), the number of kernel launches, and the busy time split by kind of
kernel and by the top kernels. Needs a CUDA card; fails if the profiler
records no device time.
"""
import argparse
import collections
import json
import pathlib
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# kernel-name fragments -> kind, first match wins
KINDS = (("ell_fwd", "K1 edge-conv sum"),
         ("ell_receiver", "K1 bf16 sum / dp"), ("ell_sender", "K1 dq"),
         ("windowed_receiver", "K3a windowed sum"),
         ("windowed_sender", "K3c windowed dq"),
         ("multi_tensor", "optimizer"),
         ("instance_norm_stats", "K2 instance norm"),
         ("instance_norm_apply", "K2 instance norm"),
         ("gemm", "matmul"), ("cutlass", "matmul"), ("sm90_", "matmul"),
         ("index", "gather / scatter"), ("scatter", "gather / scatter"),
         ("gather", "gather / scatter"), ("reduce", "reductions"))


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for frag, k in KINDS if frag in low), "elementwise/other")


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise AttributeError("profiler event has no device time field")


BF16_CONFIG = (pathlib.Path(__file__).resolve().parents[2] / "experiments"
               / "3d_inpainting" / "config"
               / "config_stinet_surfacetextureinpainting_bf16.json")


def serving_forward(impl):
    """One f32 serving forward on the flagship graph."""
    from stinet_tpu_torch.models.factory import FLAGSHIP, define_G
    from stinet_tpu_torch.serving import SceneInpainter
    from stinet_tpu_torch.utils.synthetic import (
        FLAGSHIP_SCENE, synthetic_scene)
    model = define_G(**FLAGSHIP, generator=torch.Generator().manual_seed(0))
    server = SceneInpainter(model, model.state_dict(), device="cuda",
                            impl=impl)
    graph = server.place(server.build(synthetic_scene(**FLAGSHIP_SCENE)))
    return lambda: server.forward(graph)


def train_step(impl):
    """One bf16 train step of the production bf16 config on the windowed
    flagship graph."""
    from stinet_tpu_torch.graph.build import build_hierarchical_graph
    from stinet_tpu_torch.models.factory import define_G
    from stinet_tpu_torch.serving import PackedPlacer
    from stinet_tpu_torch.trainers import graph_common as gc
    from stinet_tpu_torch.utils.synthetic import (
        FLAGSHIP_SCENE, synthetic_scene)
    cfg = json.loads(BF16_CONFIG.read_text())
    model = define_G(**cfg["archs"]["SurfaceTextureInpaintingNet"]["args"],
                     generator=torch.Generator().manual_seed(0)).cuda()
    graph = PackedPlacer(torch.device("cuda", torch.cuda.current_device()))(
        build_hierarchical_graph([synthetic_scene(**FLAGSHIP_SCENE)],
                                 geometric=True, windowed=True))
    opt, base_lr = gc.build_optimizer(model.parameters(), cfg["optimizer"])
    lr = gc.step_lr(base_lr, cfg["lr_scheduler"])(1)
    step, _ = gc.make_inpainting_steps(
        model, opt, cfg["trainer"]["use_mask_weighted_loss"], impl=impl)
    return lambda: step(graph, lr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("kernel", "plain"), default="kernel",
                    help="the CUDA kernels, or their plain torch versions")
    ap.add_argument("--train", action="store_true",
                    help="the bf16 train step instead of the serving forward")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_forward: needs a CUDA card", file=sys.stderr)
        return 1

    impl = None if args.impl == "kernel" else "plain"
    run = train_step(impl) if args.train else serving_forward(impl)
    for _ in range(3):
        run()
    torch.cuda.synchronize()

    def wall_ms():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    wall = wall_ms()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_wall = wall_ms()

    # device events, less the ranges of user annotations (the optimizer
    # marks its step on the device timeline): kernels only
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(_self_device_us(e) for e in kernels) / 1e3 / args.reps
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    launches = sum(e.count for e in kernels) / args.reps
    by_kind = collections.Counter()
    for e in kernels:
        by_kind[kind_of(e.key)] += _self_device_us(e) / 1e3 / args.reps

    card = torch.cuda.get_device_name(0)
    what = "train step" if args.train else "forward"
    print(f"[profile] impl={args.impl} on {card}: {wall:.3f} ms wall per "
          f"{what} untraced ({traced_wall:.3f} ms traced), {busy:.3f} ms "
          f"device busy, idle share {max(0.0, 1 - busy / wall):.1%}, "
          f"{launches:.0f} kernel launches")
    for kind, ms in by_kind.most_common():
        print(f"[profile]   {kind:20s} {ms:8.3f} ms  {ms / busy:6.1%}")
    top = sorted(kernels, key=_self_device_us, reverse=True)[:12]
    for e in top:
        ms = _self_device_us(e) / 1e3 / args.reps
        print(f"[profile]   top {ms:8.3f} ms x{e.count // args.reps:3d}  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
