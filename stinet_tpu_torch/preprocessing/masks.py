"""Geodesic-disk mask generation — capability parity with the `circles` mode
of the reference's preprocessing/observed_texture_map_generation.py:570-650:
random seed vertices grow BFS disks of hop radius R over the level-0 mesh
adjacency; the stored mask value is max(radius - hopdist, existing) i.e. the
hop distance from the nearest observed vertex; disks are added until the
masked fraction is reached; masks under a minimum fraction are rejected;
per-graph masks are projected through the original-vertex-index channel
(vertices_0[:, 9]). A copy of the JAX package's `preprocessing/masks.py`
over the port's native libraries: the two write the same masks."""
import os
from typing import Sequence

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

from stinet_tpu_torch.graph import native as _graph_native
from stinet_tpu_torch.preprocessing import native


def _adjacency(edges: np.ndarray, num_vertices: int) -> csr_matrix:
    return csr_matrix(
        (np.ones(edges.shape[1], np.int8), (edges[0], edges[1])),
        shape=(num_vertices, num_vertices))


def bfs_hop_distances(edges: np.ndarray, num_vertices: int,
                      seeds: np.ndarray, limit: float):
    adj = edges if isinstance(edges, csr_matrix) \
        else _adjacency(edges, num_vertices)
    return dijkstra(adj, directed=False, unweighted=True, indices=seeds,
                    limit=limit)


def circle_mask(edges, num_vertices: int, radius: int,
                frac_masked: float, rng: np.random.Generator,
                max_iters: int = 10000) -> np.ndarray:
    """Vertex mask: 0 = observed, >0 = hop distance from nearest observed.

    `edges` may be a [2, E] COO array, a prebuilt csr_matrix adjacency, or
    a native `graph.native.Adjacency` — callers drawing many disks (one
    BFS per seed) should prebuild one of the latter. The native handle is
    the fast path: its bounded BFS touches only the disk and keeps the
    masked count incrementally (O(disk) per seed vs scipy dijkstra's O(N)
    per-call dist array), producing bit-identical masks (same rng draws,
    same hop metric)."""
    if isinstance(edges, _graph_native.Adjacency):
        mask = np.zeros(num_vertices, np.float32)
        target = frac_masked * num_vertices
        masked = 0
        for _ in range(max_iters):
            if masked >= target:
                break
            seed = int(rng.integers(0, num_vertices))
            masked += edges.disk_update(seed, radius, mask)
        return mask
    adj = edges if isinstance(edges, csr_matrix) \
        else _adjacency(edges, num_vertices)
    mask = np.zeros(num_vertices, np.float32)
    target = frac_masked * num_vertices
    for _ in range(max_iters):
        if (mask > 0).sum() >= target:
            break
        seed = int(rng.integers(0, num_vertices))
        dist = bfs_hop_distances(adj, num_vertices,
                                 np.array([seed]), radius)[0]
        reach = np.isfinite(dist)
        update = np.zeros(num_vertices, np.float32)
        update[reach] = radius - dist[reach]
        mask = np.maximum(mask, update)
    return mask


def project_mask_to_graph(scene_mask: np.ndarray,
                          graph_npz_path: str) -> np.ndarray:
    """Project a full-scene vertex mask into a (possibly cropped) graph file
    via the original-index channel (reference approve_and_write_out_mask,
    observed_texture_map_generation.py:616-650)."""
    z = np.load(graph_npz_path)
    orig_idx = np.rint(z["vertices_0"][:, 9]).astype(np.int64)
    return scene_mask[np.clip(orig_idx, 0, len(scene_mask) - 1)]


def generate_masks_for_scene(scene_graph_path: str, mask_root: str,
                             mask_name: str, num_masks: int = 16,
                             radius: int = 16, frac_masked: float = 0.2,
                             min_frac: float = 0.02, seed: int = 0,
                             crop_graph_paths: Sequence[str] = ()):
    """Write masks/<mask_name>/<scene>/<i>.npz{vertex_mask} for the scene
    graph and project into crop graphs when given."""
    z = np.load(scene_graph_path)
    nv = z["vertices_0"].shape[0]
    # one adjacency for all masks' disks (native bounded-BFS handle when
    # available; scipy CSR otherwise)
    adj = (_graph_native.Adjacency(z["edges_0"], nv)
           if _graph_native.available() else _adjacency(z["edges_0"], nv))
    scene = os.path.basename(scene_graph_path).replace(".npz", "")
    rng = np.random.default_rng(seed)

    written = []
    mask_id = 0
    attempts = 0
    while mask_id < num_masks and attempts < num_masks * 4:
        attempts += 1
        mask = circle_mask(adj, nv, radius, frac_masked, rng)
        if (mask > 0).sum() < min_frac * nv:
            continue
        out_dir = os.path.join(mask_root, mask_name, scene)
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, f"{mask_id}.npz"), vertex_mask=mask)
        written.append(os.path.join(out_dir, f"{mask_id}.npz"))
        for crop_path in crop_graph_paths:
            crop_mask = project_mask_to_graph(mask, crop_path)
            if (crop_mask > 0).sum() < min_frac * len(crop_mask):
                continue
            crop = os.path.basename(crop_path).replace(".npz", "")
            cdir = os.path.join(mask_root, mask_name, crop)
            os.makedirs(cdir, exist_ok=True)
            np.savez(os.path.join(cdir, f"{mask_id}.npz"),
                     vertex_mask=crop_mask)
        mask_id += 1
    return written


# ---------------------------------------------------------------------------
# Observers-mode masks (reference observed_texture_map_generation.py:159-267,
# inert there because the pytorch3d imports are commented out :17-40): render
# the mesh from camera poses, count per-vertex observing poses, and mask the
# vertices seen by fewer than `min_views` poses of a random pose subset.
# The renderer is the native z-buffer rasterizer (preprocessing/native).
# ---------------------------------------------------------------------------

def pose_visibility(vertices: np.ndarray, faces: np.ndarray,
                    world_to_cam: np.ndarray, intrinsics,
                    width: int, height: int,
                    depth_eps: float = 1e-3,
                    depth_rel_eps: float = 0.01) -> np.ndarray:
    """[N] bool: vertex visible from one camera (pinhole projection + mesh
    z-buffer occlusion test). `intrinsics` = (fx, fy, cx, cy)."""
    w2c = np.asarray(world_to_cam, np.float64)
    cam = vertices @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    fx, fy, cx, cy = intrinsics
    zc = np.maximum(z, 1e-9)
    px = cam[:, 0] / zc * fx + cx
    py = cam[:, 1] / zc * fy + cy
    zbuf = native.rasterize_depth(np.stack([px, py, z], 1), faces,
                                  width, height)
    xi = np.floor(px).astype(np.int64)
    yi = np.floor(py).astype(np.int64)
    in_frame = ((z > 0) & (xi >= 0) & (xi < width)
                & (yi >= 0) & (yi < height))
    vis = np.zeros(len(vertices), bool)
    idx = np.flatnonzero(in_frame)
    front = zbuf[yi[idx], xi[idx]]
    vis[idx] = z[idx] <= front * (1.0 + depth_rel_eps) + depth_eps
    return vis


def observers_mask(vertices: np.ndarray, faces: np.ndarray,
                   poses, intrinsics, width: int, height: int,
                   min_views: int = 1, pose_fraction: float = 0.5,
                   rng=None) -> np.ndarray:
    """[N] float mask: 1.0 where the vertex is observed by fewer than
    `min_views` cameras of a random `pose_fraction` subset of `poses`
    (world-to-camera 4x4s), 0.0 elsewhere — the reference's observers-mode
    semantics. Binary values (the loader treats >0 as masked)."""
    rng = np.random.default_rng() if rng is None else rng
    k = max(int(round(len(poses) * pose_fraction)), 1)
    sel = rng.choice(len(poses), size=k, replace=False)
    counts = np.zeros(len(vertices), np.int64)
    for i in sel:
        counts += pose_visibility(vertices, faces, poses[i], intrinsics,
                                  width, height)
    return (counts < min_views).astype(np.float32)


def load_scannet_poses(poses_dir: str):
    """Read ScanNet-style pose files (<poses_dir>/<i>.txt, 4x4
    camera-to-world) and return world-to-camera matrices."""
    import glob
    files = sorted(glob.glob(os.path.join(poses_dir, "*.txt")),
                   key=lambda p: int(os.path.splitext(
                       os.path.basename(p))[0]))
    poses = []
    for p in files:
        c2w = np.loadtxt(p).reshape(4, 4)
        if not np.isfinite(c2w).all():
            continue  # ScanNet has occasional -inf poses
        poses.append(np.linalg.inv(c2w))
    return poses


def generate_observer_masks_for_scene(
        scene_graph_path: str, mesh_vertices: np.ndarray,
        mesh_faces: np.ndarray, poses, mask_root: str, mask_name: str,
        intrinsics=(577.87, 577.87, 319.5, 239.5), width: int = 640,
        height: int = 480, num_masks: int = 16, min_views: int = 1,
        pose_fraction: float = 0.25, min_frac: float = 0.02,
        max_frac: float = 0.9, seed: int = 0,
        crop_graph_paths: Sequence[str] = ()):
    """Observers-mode masks (reference observed_texture_map_generation.py
    process_frame_observers): each mask draws a fresh random pose subset;
    under-/over-masked draws are rejected like the circles mode. Masks are
    computed on the ORIGINAL mesh vertices and projected into graph/crop
    files via the original-index channel."""
    scene = os.path.basename(scene_graph_path).replace(".npz", "")
    rng = np.random.default_rng(seed)
    written = []
    mask_id, attempts = 0, 0
    while mask_id < num_masks and attempts < num_masks * 4:
        attempts += 1
        scene_mask = observers_mask(
            mesh_vertices, mesh_faces, poses, intrinsics, width, height,
            min_views=min_views, pose_fraction=pose_fraction, rng=rng)
        frac = (scene_mask > 0).mean()
        if frac < min_frac or frac > max_frac:
            continue
        mask = project_mask_to_graph(scene_mask, scene_graph_path)
        if (mask > 0).sum() < min_frac * len(mask):
            continue
        out_dir = os.path.join(mask_root, mask_name, scene)
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, f"{mask_id}.npz"), vertex_mask=mask)
        written.append(os.path.join(out_dir, f"{mask_id}.npz"))
        for crop_path in crop_graph_paths:
            crop_mask = project_mask_to_graph(scene_mask, crop_path)
            if (crop_mask > 0).sum() < min_frac * len(crop_mask):
                continue
            crop = os.path.basename(crop_path).replace(".npz", "")
            cdir = os.path.join(mask_root, mask_name, crop)
            os.makedirs(cdir, exist_ok=True)
            np.savez(os.path.join(cdir, f"{mask_id}.npz"),
                     vertex_mask=crop_mask)
        mask_id += 1
    return written
