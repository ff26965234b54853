"""Where the device time of one flagship forward goes.

    python -m stinet_tpu_torch.utils.profile_forward [--impl plain] [--reps 5]

Builds the flagship scene and model (the ones chip_smoke.py drives), places
the graph on the card, warms up, times `--reps` forwards with CUDA events
(no profiler), then traces `--reps` more with torch.profiler. Prints, per
forward: the untraced wall time, the device busy time of the traced
forwards (the sum of kernel durations: one stream, so kernels do not
overlap), the idle share (1 - busy / untraced wall: tracing slows the
host's launches, so the traced window's own wall time overstates it), the
number of kernel launches, and the busy time split by kind of kernel and by
the top kernels. Needs a CUDA card; fails if the profiler records no device
time.
"""
import argparse
import collections
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# kernel-name fragments -> kind, first match wins
KINDS = (("ell_fwd", "K1 edge-conv sum"),
         ("column_partials", "K2 instance norm"),
         ("finalize", "K2 instance norm"),
         ("normalize_rows", "K2 instance norm"),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("kernel", "plain"), default="kernel",
                    help="the CUDA kernels, or their plain torch versions")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_forward: needs a CUDA card", file=sys.stderr)
        return 1

    from stinet_tpu_torch.models.factory import FLAGSHIP, define_G
    from stinet_tpu_torch.serving import SceneInpainter
    from stinet_tpu_torch.utils.synthetic import (
        FLAGSHIP_SCENE, synthetic_scene)

    model = define_G(**FLAGSHIP, generator=torch.Generator().manual_seed(0))
    server = SceneInpainter(model, model.state_dict(), device="cuda",
                            impl=None if args.impl == "kernel" else "plain")
    graph = server.place(server.build(synthetic_scene(**FLAGSHIP_SCENE)))
    for _ in range(3):
        server.forward(graph)
    torch.cuda.synchronize()

    def wall_ms():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            server.forward(graph)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    wall = wall_ms()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_wall = wall_ms()

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(_self_device_us(e) for e in kernels) / 1e3 / args.reps
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    launches = sum(e.count for e in kernels) / args.reps
    by_kind = collections.Counter()
    for e in kernels:
        by_kind[kind_of(e.key)] += _self_device_us(e) / 1e3 / args.reps

    card = torch.cuda.get_device_name(0)
    print(f"[profile] impl={args.impl} on {card}: {wall:.3f} ms wall per "
          f"forward untraced ({traced_wall:.3f} ms traced), {busy:.3f} ms "
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
