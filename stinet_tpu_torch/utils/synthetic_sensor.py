"""Synthetic rooms and RGB-D sensor streams, made from a seed, for driving
the preprocessing and texture-map optimization without ScanNet data.

`room_mesh` is the hostile terrain (utils/hostile.py) scaled as a whole
into a room of `size` m x `size` m, so the crop grid's default block of 3 m
at a stride of 1.5 m cuts a room's worth of crops from it. `look_down_poses`
places cameras above the room, looking down; `sensor_frames` renders each
camera's depth with the native z-buffer rasterizer and colors each pixel by
a smooth field at the world point the pixel sees, in the sampling
convention of preprocessing/texture_optimization.py (pixel (x, y) holds the
surface at u = x, v = y).
"""
import numpy as np

from stinet_tpu_torch.preprocessing import native
from stinet_tpu_torch.utils.hostile import terrain_mesh

# ScanNet's color intrinsics at 640 x 480 (fx, fy, cx, cy), the defaults
# of preprocessing/masks.py's observer masks
SCANNET_INTRINSICS = (577.87, 577.87, 319.5, 239.5)


def room_mesh(num_vertices: int, seed: int = 0, size: float = 8.0):
    """(vertices [N, 3] f64, faces [F, 3] i64, colors [N, 3] in [0, 1]):
    `terrain_mesh(num_vertices, seed)` scaled uniformly so its xy extent is
    `size` m, with seeded per-vertex colors."""
    v, f = terrain_mesh(num_vertices, seed)
    v = v * (size / float(np.ptp(v[:, :2], axis=0).max()))
    v[:, :2] -= v[:, :2].min(0)
    colors = np.random.default_rng(seed + 1).uniform(0, 1, (len(v), 3))
    return v, f, colors


def color_field(points: np.ndarray) -> np.ndarray:
    """A smooth RGB field in [0, 1] over world points [..., 3]."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return np.stack([0.5 + 0.4 * np.sin(0.9 * x + 0.3 * y),
                     0.5 + 0.4 * np.cos(0.7 * y - 0.2 * x),
                     0.5 + 0.2 * np.sin(0.5 * (x + y)) + 0.2 * np.cos(z)],
                    -1)


def look_down_poses(num: int, size: float = 8.0, height: float = 3.0,
                    tilt: float = 0.15, seed: int = 0) -> np.ndarray:
    """[num, 4, 4] world-to-camera poses of cameras at `height` m above
    seeded points of the room, looking down (camera +z along world -z),
    each tilted by up to `tilt` rad."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((num, 4, 4))
    for i in range(num):
        eye = np.array([*rng.uniform(0.15 * size, 0.85 * size, 2), height])
        a = rng.uniform(-tilt, tilt, 3)
        r = _rotation(a) @ np.diag([1.0, -1.0, -1.0])
        poses[i, :3, :3] = r
        poses[i, :3, 3] = -r @ eye
        poses[i, 3, 3] = 1.0
    return poses


def perturb_poses(poses: np.ndarray, rot: float, trans: float,
                  seed: int = 0) -> np.ndarray:
    """A copy of `poses` with frames 1.. rotated by a seeded rotation of
    `rot` rad and moved by `trans` m (frame 0, the gauge anchor, kept)."""
    rng = np.random.default_rng(seed)
    out = np.array(poses, np.float64)
    for i in range(1, len(out)):
        axis = rng.normal(size=3)
        out[i, :3, :3] = (_rotation(rot * axis / np.linalg.norm(axis))
                          @ out[i, :3, :3])
        step = rng.normal(size=3)
        out[i, :3, 3] += trans * step / np.linalg.norm(step)
    return out


def _rotation(w):
    """Rodrigues' rotation of the rotation vector w."""
    theta = float(np.linalg.norm(w))
    if theta == 0.0:
        return np.eye(3)
    k = np.asarray(w) / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


def sensor_frames(vertices, faces, poses, intr=SCANNET_INTRINSICS,
                  width: int = 640, height: int = 480):
    """(colors [F, H, W, 3] f32, depths [F, H, W] f32 in m, 0 where no
    surface): each pose's z-buffer by `native.rasterize_depth`, and the
    color field at the world point each covered pixel sees."""
    fx, fy, cx, cy = intr
    xs, ys = np.meshgrid(np.arange(width, dtype=np.float64),
                         np.arange(height, dtype=np.float64))
    colors = np.zeros((len(poses), height, width, 3), np.float32)
    depths = np.zeros((len(poses), height, width), np.float32)
    for i, pose in enumerate(poses):
        r, t = pose[:3, :3], pose[:3, 3]
        cam = vertices @ r.T + t
        z = cam[:, 2]
        zc = np.maximum(z, 1e-9)
        # the rasterizer samples pixel x at x + 0.5: shift by half a pixel
        # so that pixel x holds the surface at u = x
        pts = np.stack([cam[:, 0] / zc * fx + cx + 0.5,
                        cam[:, 1] / zc * fy + cy + 0.5, z], 1)
        zbuf = native.rasterize_depth(pts, faces, width, height)
        hit = np.isfinite(zbuf)
        d = np.where(hit, zbuf, 0.0)
        cam_px = np.stack([(xs - cx) / fx * d, (ys - cy) / fy * d, d], -1)
        world = (cam_px - t) @ r
        colors[i] = np.where(hit[..., None], color_field(world), 0.0)
        depths[i] = d
    return colors, depths
