"""Preprocessing CLI — one scene per invocation with --number selecting from
the scan directory, or a process-pool fan-out over all scenes (replaces the
reference's `xargs -P` shell fan-out, scripts/generate_graph_levels.sh:27).

  python -m stinet_tpu_torch.preprocessing.cli graphs --scans <dir> \
      --out <dir> --level-params 100 30 30 --dilations 2 4 6 8 16 \
      [--number N | --jobs J]
  python -m stinet_tpu_torch.preprocessing.cli crops --graphs <dir> \
      --out <dir>
  python -m stinet_tpu_torch.preprocessing.cli masks --graphs <dir> \
      --out <dir> --mask-name rad_16 --radius 16 [--crops <crops dir>]
  python -m stinet_tpu_torch.preprocessing.cli observer-masks \
      --graphs <dir> --scans <dir> --poses <dir> --out <dir>

`--scans` holds `<scene>/<scene>_vh_clean_2.ply` (or `*.ply`); the loaders
select scenes by the names in `data/meta/scannet/scannetv2_*.txt`. Every
subcommand runs on the host (numpy, scipy and the native decimator) and
touches no CUDA. `graphs` fans out over `--jobs` processes that are
spawned, never forked: a fork of a process that has initialised CUDA, or
that runs threads (torch's and JAX's pools), is not safe.

The subcommands, their flags and defaults, and the files they write are
the JAX package's (`stinet_tpu/preprocessing/cli.py`), but the `graphs`
worker is a module-level function, so the pool can pickle it: the JAX
CLI's worker is local to `cmd_graphs`, and its pool fails on more than one
scene.
"""
import argparse
import functools
import glob
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor


def _scene_plys(scans_dir):
    plys = sorted(glob.glob(os.path.join(
        scans_dir, "*", "*_vh_clean_2.ply")))
    if not plys:
        plys = sorted(glob.glob(os.path.join(scans_dir, "*.ply")))
    return plys


def _graphs_one(ply, out_dir, level_params, dilations, dilation_levels, rcm):
    """The `graphs` worker: one scene, its failure printed, not raised. It
    prints the scene's seconds and the native libraries' calls."""
    from stinet_tpu_torch.graph import native as graph_native
    from stinet_tpu_torch.preprocessing import native
    from stinet_tpu_torch.preprocessing.graph_levels import process_scene
    native.reset_calls()
    graph_native.reset_calls()
    t0 = time.perf_counter()
    try:
        out = process_scene(ply, out_dir, level_params,
                            dilation_dists=dilations,
                            dilation_levels=dilation_levels, rcm=rcm)
        print(f"wrote {out} in {time.perf_counter() - t0:.2f} s; native "
              f"calls: decimator {dict(native.calls)}, graph builder "
              f"{dict(graph_native.calls)}", flush=True)
    except Exception as e:  # per-scene crash tolerance
        print(f"FAILED {ply}: {e}", flush=True)


def cmd_graphs(args):
    plys = _scene_plys(args.scans)
    if args.number is not None:
        plys = [plys[args.number]]
    run = functools.partial(
        _graphs_one, out_dir=args.out, level_params=args.level_params,
        dilations=args.dilations,
        dilation_levels=args.dilation_levels or (), rcm=args.rcm)

    if args.jobs > 1 and len(plys) > 1:
        # build the native libraries once, before the fan-out, so the
        # workers load them and none compiles
        from stinet_tpu_torch.graph import native as graph_native
        from stinet_tpu_torch.preprocessing import native
        native.get_lib()
        if graph_native.available():
            graph_native.get_lib()
        with ProcessPoolExecutor(
                max_workers=args.jobs,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(run, plys))
    else:
        for ply in plys:
            run(ply)


def cmd_crops(args):
    from stinet_tpu_torch.preprocessing.crops import (
        MIN_COARSE_VERTICES, process_scene_crops)
    min_coarse = (MIN_COARSE_VERTICES if args.min_coarse is None
                  else args.min_coarse)
    for path in sorted(glob.glob(os.path.join(args.graphs, "graphs",
                                              "*.npz"))):
        written = process_scene_crops(
            path, args.out, block_size=args.block_size, stride=args.stride,
            num_levels=args.num_levels, dilation_dists=args.dilations,
            min_coarse_vertices=min_coarse)
        print(f"{os.path.basename(path)}: {len(written)} crops", flush=True)


def cmd_masks(args):
    from stinet_tpu_torch.preprocessing.masks import generate_masks_for_scene
    for path in sorted(glob.glob(os.path.join(args.graphs, "graphs",
                                              "*.npz"))):
        scene = os.path.basename(path).replace(".npz", "")
        # project each scene mask into the scene's crop graphs via the
        # vertex-index channel (reference approve_and_write_out_mask,
        # observed_texture_map_generation.py:616-650)
        crop_paths = sorted(glob.glob(os.path.join(
            args.crops, "graphs", f"{scene}_*.npz"))) if args.crops else ()
        written = generate_masks_for_scene(
            path, os.path.join(args.out, "masks"), args.mask_name,
            num_masks=args.num_masks, radius=args.radius,
            frac_masked=args.frac_masked, seed=args.seed,
            crop_graph_paths=crop_paths)
        print(f"{os.path.basename(path)}: {len(written)} masks"
              + (f" (projected into {len(crop_paths)} crops)"
                 if crop_paths else ""), flush=True)


def cmd_observer_masks(args):
    """Observers-mode masks (reference subparser `observers`,
    observed_texture_map_generation.py:715-733): needs the original mesh
    plys (--scans) and per-scene ScanNet pose dirs (--poses/<scene>/*.txt)."""
    from stinet_tpu_torch.preprocessing.masks import (
        generate_observer_masks_for_scene, load_scannet_poses)
    from stinet_tpu_torch.preprocessing.plyio import read_ply
    fx, fy, cx, cy = [float(t) for t in args.intrinsics.split(",")]
    w, h = [int(t) for t in args.img_wh.split(",")]
    for path in sorted(glob.glob(os.path.join(args.graphs, "graphs",
                                              "*.npz"))):
        scene = os.path.basename(path).replace(".npz", "")
        plys = glob.glob(os.path.join(args.scans, scene, "*.ply")) or \
            glob.glob(os.path.join(args.scans, f"{scene}.ply"))
        pose_dir = os.path.join(args.poses, scene)
        if not plys or not os.path.isdir(pose_dir):
            print(f"{scene}: missing mesh or poses, skipped", flush=True)
            continue
        mesh = read_ply(plys[0])
        verts, faces = mesh["vertices"], mesh["faces"]
        poses = load_scannet_poses(pose_dir)
        written = generate_observer_masks_for_scene(
            path, verts, faces, poses, os.path.join(args.out, "masks"),
            args.mask_name, intrinsics=(fx, fy, cx, cy), width=w, height=h,
            num_masks=args.num_masks, min_views=args.min_views,
            pose_fraction=args.pose_fraction, seed=args.seed)
        print(f"{scene}: {len(written)} observer masks", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("graphs")
    g.add_argument("--scans", required=True)
    g.add_argument("--out", required=True)
    g.add_argument("--level-params", nargs="+", default=["100", "30", "30"])
    g.add_argument("--dilations", nargs="+", type=int,
                   default=[2, 4, 6, 8, 16])
    g.add_argument("--dilation-levels", nargs="+", type=int, default=None)
    g.add_argument("--number", type=int, default=None)
    g.add_argument("--jobs", type=int, default=max(os.cpu_count() - 2, 1))
    # store scenes RCM-bandwidth-ordered: windowed training/serving builds
    # then skip their per-sample reorder (graph/build.py:_is_banded).
    # Opt-in: masks/crops generated from a previous run apply positionally
    # (vertex_mask rows), so re-running `graphs` with a different ordering
    # silently corrupts them — regenerate masks/crops after switching.
    g.add_argument("--rcm", action="store_true", default=False)
    g.add_argument("--no-rcm", dest="rcm", action="store_false")
    g.set_defaults(fn=cmd_graphs)

    c = sub.add_parser("crops")
    c.add_argument("--graphs", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--block-size", type=float, default=3.0)
    c.add_argument("--stride", type=float, default=1.5)
    c.add_argument("--num-levels", type=int, default=3)
    c.add_argument("--min-coarse", type=int, default=None,
                   help="reject crops with fewer coarsest-level vertices "
                        "(default: crops.MIN_COARSE_VERTICES)")
    c.add_argument("--dilations", nargs="+", type=int,
                   default=[2, 4, 6, 8, 16])
    c.set_defaults(fn=cmd_crops)

    m = sub.add_parser("masks")
    m.add_argument("--graphs", required=True)
    m.add_argument("--out", required=True)
    m.add_argument("--mask-name", default="rad_16")
    m.add_argument("--num-masks", type=int, default=16)
    m.add_argument("--radius", type=int, default=16)
    m.add_argument("--frac-masked", type=float, default=0.2)
    m.add_argument("--seed", type=int, default=0)
    m.add_argument("--crops", default=None,
                   help="crops output dir: project each scene mask into "
                        "that scene's crop graphs (<scene>_<i>.npz)")
    m.set_defaults(fn=cmd_masks)

    o = sub.add_parser("observer-masks")
    o.add_argument("--graphs", required=True)
    o.add_argument("--scans", required=True)
    o.add_argument("--poses", required=True)
    o.add_argument("--out", required=True)
    o.add_argument("--mask-name", default="observers")
    o.add_argument("--num-masks", type=int, default=16)
    o.add_argument("--min-views", type=int, default=1)
    o.add_argument("--pose-fraction", type=float, default=0.25)
    o.add_argument("--intrinsics", default="577.87,577.87,319.5,239.5")
    o.add_argument("--img-wh", default="640,480")
    o.add_argument("--seed", type=int, default=0)
    o.set_defaults(fn=cmd_observer_masks)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
