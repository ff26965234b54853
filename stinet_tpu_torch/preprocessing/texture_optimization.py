"""Texture-map optimization: recover per-vertex mesh colors from RGB-D
frames + camera trajectory, with optional rigid pose refinement.

Capability parity with the reference's standalone open3d demo
(preprocessing/texture_map_optimization.py:136-146 there), which calls
`o3d.pipelines.color_map.run_non_rigid_optimizer(..., maximum_iteration=0)`
— i.e. performs the initial visibility-weighted color projection — on one
hard-coded ScanNet scene and writes `out.ply`. A port of the JAX package's
`preprocessing/texture_optimization.py` to torch ops with autograd:

  * projection, bilinear sampling and visibility run on all frames in one
    batched pass, `[F, V]`, on the device the tensors are on;
  * `estimate_vertex_colors` is the reference's 0-iteration behavior:
    visibility-masked average of sampled frame colors per vertex;
  * `rigid_optimize` implements the ColorMapOptimization rigid stage
    (Zhou & Koltun 2014, what `run_rigid_optimizer` does): alternate
    closed-form color re-estimation with Adam refinement of per-frame
    se(3) pose deltas against the photometric residual.

Visibility follows the depth-consistency test the open3d pipeline uses:
a vertex is visible in a frame iff its projected depth agrees with the
bilinearly-sampled depth image within a tolerance. The in-frame and depth
tests are boolean and carry no gradient. (The native z-buffer rasterizer
in preprocessing/native covers the no-depth-image case via
masks.pose_visibility.)

Every product of 3-vectors and 3 x 3 matrices is written out as
elementwise products and sums, so no matmul runs in TF32 on the card.

CLI (ScanNet sensor layout, same directory convention as the reference):
    python -m stinet_tpu_torch.preprocessing.texture_optimization \\
        --path data/sensor_data/scene0000_00 --scene scene0000_00 \\
        --stride 10 --rigid-iters 50 --out out.ply [-d cpu]
Without `-d` it runs on the card, and exits with `resolve_device`'s error
where there is none.
"""
import os

import numpy as np
import torch


def _tensors(device, *arrays):
    """Each array as a float32 tensor on `device`."""
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


def _device_of(*arrays):
    """The device of the first tensor among `arrays`, else the CPU."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _mm3(a, b):
    """a @ b over the last two axes, for [..., 3, 3] operands."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _mv3(a, x):
    """a @ x for [..., 3, 3] and [..., 3]."""
    return (a * x[..., None, :]).sum(-1)


def _se3_apply(pose, delta, pts):
    """Apply exp(delta) * pose to [V, 3] points. delta = [wx wy wz tx ty tz]
    (small-angle Rodrigues; exact enough for refinement steps). pose
    [..., 4, 4] and delta [..., 6] may carry leading frame axes; returns
    [..., V, 3]."""
    w, t = delta[..., :3], delta[..., 3:]
    theta = torch.sqrt((w * w).sum(-1) + 1e-12)
    k = w / theta[..., None]
    zero = torch.zeros_like(k[..., 0])
    kx = torch.stack([
        torch.stack([zero, -k[..., 2], k[..., 1]], -1),
        torch.stack([k[..., 2], zero, -k[..., 0]], -1),
        torch.stack([-k[..., 1], k[..., 0], zero], -1)], -2)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    dr = (eye + torch.sin(theta)[..., None, None] * kx
          + (1 - torch.cos(theta))[..., None, None] * _mm3(kx, kx))
    r = _mm3(dr, pose[..., :3, :3])
    tt = _mv3(dr, pose[..., :3, 3]) + t
    # pts @ r.T + tt
    r = r[..., None, :, :]
    return (pts[:, 0:1] * r[..., 0] + pts[:, 1:2] * r[..., 1]
            + pts[:, 2:3] * r[..., 2] + tt[..., None, :])


def _project(cam_pts, intr, width, height):
    """[..., V, 3] camera-space points -> (uv [..., V, 2], z [..., V],
    in_frame [..., V])."""
    fx, fy, cx, cy = intr
    z = cam_pts[..., 2]
    zc = torch.clamp_min(z, 1e-9)
    u = cam_pts[..., 0] / zc * fx + cx
    v = cam_pts[..., 1] / zc * fy + cy
    ok = ((z > 1e-6) & (u >= 0) & (u <= width - 1) & (v >= 0)
          & (v <= height - 1))
    return torch.stack([u, v], -1), z, ok


def _bilinear(img, uv):
    """Sample [..., H, W, C] at [..., V, 2] (u, v) pixel coords: the four
    neighbours read as rows of the flattened image. As in the JAX package,
    u and v are clipped to `w - 1 - 1e-6` (in float32, for W above about
    16, that is w - 1 itself, where the right neighbour has weight 0), and
    a flat index past the image's end reads its last pixel (XLA's clamped
    gather)."""
    h, w, c = img.shape[-3:]
    u = torch.clamp(uv[..., 0], 0, w - 1.0 - 1e-6)
    v = torch.clamp(uv[..., 1], 0, h - 1.0 - 1e-6)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    flat = img.reshape(*img.shape[:-3], h * w, c)
    base = v0.long() * w + u0.long()

    def at(offset):
        idx = torch.clamp(base + offset, max=h * w - 1)
        return torch.gather(flat, -2, idx[..., None].expand(
            *idx.shape, c))

    return ((1 - du) * (1 - dv) * at(0) + du * (1 - dv) * at(1)
            + (1 - du) * dv * at(w) + du * dv * at(w + 1))


def _frame_samples(vertices, pose, delta, intr, color, depth, width, height,
                   depth_rel_eps=0.03, depth_abs_eps=0.02):
    """Frames: (sampled colors [..., V, 3], visibility weight [..., V]);
    pose, delta, color [..., H, W, 3] and depth [..., H, W] share their
    leading frame axes."""
    cam = _se3_apply(pose, delta, vertices)
    uv, z, ok = _project(cam, intr, width, height)
    col = _bilinear(color, uv)
    d = _bilinear(depth[..., None], uv)[..., 0]
    vis = ok & (d > 1e-6) & ((d - z).abs()
                             <= depth_rel_eps * torch.clamp_min(d, 1e-6)
                             + depth_abs_eps)
    return col, vis.to(col.dtype)


def estimate_vertex_colors(vertices, poses, deltas, intr, colors, depths,
                           width, height):
    """Visibility-weighted mean of sampled frame colors — the reference's
    maximum_iteration=0 color projection. All frames in one batched pass.
    Returns (colors [V, 3], weights [F, V])."""
    cols, ws = _frame_samples(vertices, poses, deltas, intr, colors, depths,
                              width, height)           # [F,V,3], [F,V]
    wsum = torch.clamp_min(ws.sum(0), 1e-6)[:, None]
    return (cols * ws[..., None]).sum(0) / wsum, ws


def photometric_residual(vertices, poses, deltas, intr, colors, depths,
                         width, height, c_est):
    """The rigid stage's objective: the visibility-weighted squared
    difference between each frame's sampled colors and `c_est` [V, 3],
    summed over frames and divided by the weights' sum (at least 1e-6)."""
    col, w = _frame_samples(vertices, poses, deltas, intr, colors, depths,
                            width, height)
    r = (w[..., None] * (col - c_est) ** 2).sum((1, 2))
    return r.sum() / torch.clamp_min(w.sum(1).sum(), 1e-6)


def make_rigid_step(vertices, poses, intr, colors, depths, width, height,
                    lr=1e-4, anchor_first=True):
    """(step, deltas): `step()` runs one iteration of `rigid_optimize` on
    the tensors' device (the first tensor among the arrays; numpy arrays go
    to the CPU) and returns its residual, before the update, as a 0-d
    tensor; `deltas` [F, 6] is the pose deltas' leaf tensor."""
    device = _device_of(vertices, poses, colors, depths)
    vertices, poses, colors, depths = _tensors(device, vertices, poses,
                                               colors, depths)
    f = poses.shape[0]
    deltas = torch.zeros((f, 6), dtype=torch.float32, device=device,
                         requires_grad=True)
    gauge = ((torch.arange(f, device=device) > 0).to(torch.float32)[:, None]
             if anchor_first
             else torch.ones((f, 1), dtype=torch.float32, device=device))
    # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8, no amsgrad
    opt = torch.optim.Adam([deltas], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step():
        # the color estimate enters the residual as a constant
        with torch.no_grad():
            c_est, _ = estimate_vertex_colors(vertices, poses, deltas, intr,
                                              colors, depths, width, height)
        loss = photometric_residual(vertices, poses, deltas, intr, colors,
                                    depths, width, height, c_est)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        # frame 0's gradient is masked, so its Adam moments stay 0 and its
        # update is exactly 0: the JAX package's `upd * gauge` changes
        # nothing more
        deltas.grad.mul_(gauge)
        opt.step()
        return loss.detach()

    return step, deltas


def rigid_optimize(vertices, poses, intr, colors, depths, width, height,
                   iters=50, lr=1e-4, anchor_first=True):
    """Alternating rigid color-map optimization on the tensors' device:
      repeat: C <- visibility-weighted color estimate (closed form)
              deltas <- Adam step on sum_f ||sample_f(C) - frame colors||^2
    `anchor_first` pins frame 0's pose (gauge: a global rigid transform of
    all poses leaves the residual invariant but moves the texture).
    Returns (vertex_colors [V, 3], deltas [F, 6], per-iter residuals), the
    arrays as numpy."""
    device = _device_of(vertices, poses, colors, depths)
    vertices, poses, colors, depths = _tensors(device, vertices, poses,
                                               colors, depths)
    step, deltas = make_rigid_step(vertices, poses, intr, colors, depths,
                                   width, height, lr, anchor_first)
    hist = [float(step()) for _ in range(iters)]
    with torch.no_grad():
        c_final, _ = estimate_vertex_colors(vertices, poses, deltas, intr,
                                            colors, depths, width, height)
    return (c_final.cpu().numpy(), deltas.detach().cpu().numpy(), hist)


# --------------------------------------------------------------------------
# ScanNet sensor-directory CLI (reference layout, texture_map_optimization
# .py:60-125: color/*.jpg, depth/*.png (mm), pose/*.txt c2w,
# intrinsic/intrinsic_color.txt)
# --------------------------------------------------------------------------

def load_sensor_scene(path, stride=10, height=480, width=640):
    from PIL import Image
    import glob
    import re

    def by_frame_id(pattern):
        out = {}
        for p in glob.glob(os.path.join(path, pattern)):
            m = re.findall(r"\d+", os.path.basename(p))
            if m:
                out[int(m[-1])] = p
        return out

    # key the three streams by extracted frame id and pair over the
    # intersection: positional zipping of independent globs silently
    # mis-pairs every frame after a single missing file in one directory
    colors_by_id = by_frame_id("color/*.jpg")
    depths_by_id = by_frame_id("depth/*.png")
    poses_by_id = by_frame_id("pose/*.txt")
    ids = sorted(set(colors_by_id) & set(depths_by_id)
                 & set(poses_by_id))[::stride]
    assert ids, f"no complete color/depth/pose frame triples under {path}"
    color_files = [colors_by_id[i] for i in ids]
    depth_files = [depths_by_id[i] for i in ids]
    pose_files = [poses_by_id[i] for i in ids]

    ic = np.loadtxt(os.path.join(path, "intrinsic", "intrinsic_color.txt"))
    first = Image.open(color_files[0])
    ow, oh = first.size
    intr = (ic[0, 0] * width / ow, ic[1, 1] * height / oh,
            width / 2.0 - 0.5, height / 2.0 - 0.5)  # reference :105-108

    colors, depths, poses = [], [], []
    for cf, df, pf in zip(color_files, depth_files, pose_files):
        c2w = np.loadtxt(pf).reshape(4, 4)
        if not np.isfinite(c2w).all():
            continue
        col = np.asarray(Image.open(cf).convert("RGB")
                         .resize((width, height))) / 255.0
        dep = np.asarray(Image.open(df).resize((width, height),
                                               Image.NEAREST), np.float64)
        dep[dep == 65535] = 0  # reference :89
        colors.append(col.astype(np.float32))
        depths.append((dep / 1000.0).astype(np.float32))  # mm -> m
        poses.append(np.linalg.inv(c2w).astype(np.float32))
    return (np.stack(colors), np.stack(depths), np.stack(poses), intr,
            width, height)


def main(argv=None):
    import argparse
    from stinet_tpu_torch.preprocessing.plyio import read_ply, write_ply
    from stinet_tpu_torch.serving import resolve_device
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--path", required=True)
    ap.add_argument("--scene", required=True)
    ap.add_argument("--stride", type=int, default=10)
    ap.add_argument("--rigid-iters", type=int, default=0,
                    help="0 = reference-parity pure projection")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--out", default="out.ply")
    ap.add_argument("-d", "--device", default="cuda",
                    help="cpu, cuda or cuda:N (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    mesh_path = os.path.join(args.path, f"{args.scene}_vh_clean_2.ply")
    mesh = read_ply(mesh_path)
    verts, faces = mesh["vertices"], mesh.get("faces")
    colors, depths, poses, intr, w, h = load_sensor_scene(
        args.path, args.stride, args.height, args.width)
    print(f"{len(poses)} frames, {len(verts)} vertices")
    tv, tp, tc, td = _tensors(device, verts, poses, colors, depths)

    if args.rigid_iters > 0:
        vcol, deltas, hist = rigid_optimize(
            tv, tp, intr, tc, td, w, h, iters=args.rigid_iters, lr=args.lr)
        print(f"residual {hist[0]:.6f} -> {hist[-1]:.6f}")
    else:
        with torch.no_grad():
            vcol, _ = estimate_vertex_colors(
                tv, tp, torch.zeros((len(poses), 6), dtype=torch.float32,
                                    device=device), intr, tc, td, w, h)
        vcol = vcol.cpu().numpy()

    out = os.path.join(args.path, args.out)
    write_ply(out, verts, faces, np.clip(vcol, 0, 1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
