"""Training-crop generation — capability parity with the reference's
preprocessing/crop_training_samples.py (and a copy of the JAX package's
`preprocessing/crops.py`, numpy only): slide a
block_size x block_size (x infinite height) window at `stride` over each
scene; per level keep vertices in the AABB, keep only internal edges,
re-filter vertices to edge endpoints, remap ids, crop dilated edge sets,
repair traces whose representative fell outside the crop by nearest-neighbor
re-targeting, and reject crops with too few coarsest-level vertices."""
import os
from typing import Dict, List, Sequence

import numpy as np
from scipy.spatial import cKDTree

MIN_COARSE_VERTICES = 50


def get_sampling_positions(positions: np.ndarray, block_size: float,
                           stride: float) -> List[np.ndarray]:
    mn, mx = positions.min(0), positions.max(0)
    xs = np.arange(mn[0], max(mx[0] - block_size, mn[0]) + stride, stride)
    ys = np.arange(mn[1], max(mx[1] - block_size, mn[1]) + stride, stride)
    return [np.array([x, y]) for x in xs for y in ys]


def _crop_level(nv, edges, internal):
    """Keep `internal` edges, drop isolated vertices, remap ids.
    Returns (vert_idx_kept, remapped_edges, old_to_new)."""
    e = edges[:, internal]
    used = np.zeros(nv, bool)
    used[e.reshape(-1)] = True
    kept = np.nonzero(used)[0]
    old_to_new = np.full(nv, -1, np.int64)
    old_to_new[kept] = np.arange(len(kept))
    return kept, old_to_new[e], old_to_new


def _edge_bounds(verts, edges):
    """Per-edge xy bounding boxes ([E] exlo/exhi/eylo/eyhi), precomputed
    once per scene so each crop position tests edges with four vectorized
    compares instead of two V-sized mask gathers (the gathers dominated
    process_scene_crops: ~0.3 s/position at ScanNet scale)."""
    x0, x1 = verts[edges[0], 0], verts[edges[1], 0]
    y0, y1 = verts[edges[0], 1], verts[edges[1], 1]
    return (np.minimum(x0, x1), np.maximum(x0, x1),
            np.minimum(y0, y1), np.maximum(y0, y1))


def crop_scene(scene_npz: Dict[str, np.ndarray], origin_xy: np.ndarray,
               block_size: float, num_levels: int,
               dilation_dists: Sequence[int] = (),
               min_coarse_vertices: int = MIN_COARSE_VERTICES,
               edge_bounds=None):
    """Produce one crop dict (same npz schema as graph_levels) or None.
    `edge_bounds` (per-level `_edge_bounds` tuples) amortizes the edge box
    tests across the crop grid; computed on the fly when absent."""
    out = {"num_levels": num_levels,
           "dilation_dists": np.asarray(list(dilation_dists), np.int64)}
    if "rcm_ordered" in scene_npz:
        # crop relabeling keeps relative vertex order (kept ids ascend), so
        # a bandwidth-ordered scene yields bandwidth-ordered crops
        out["rcm_ordered"] = scene_npz["rcm_ordered"]
    kept_per_level = []
    maps = []
    ox, oy = float(origin_xy[0]), float(origin_xy[1])
    for l in range(num_levels):
        verts = scene_npz[f"vertices_{l}"]
        edges = scene_npz[f"edges_{l}"]
        exlo, exhi, eylo, eyhi = (edge_bounds[l] if edge_bounds is not None
                                  else _edge_bounds(verts, edges))
        # both endpoints inside the box <=> the edge bbox is inside it
        internal = ((exlo >= ox) & (exhi <= ox + block_size)
                    & (eylo >= oy) & (eyhi <= oy + block_size))
        kept, e, old_to_new = _crop_level(len(verts), edges, internal)
        if len(kept) == 0:
            return None
        out[f"vertices_{l}"] = verts[kept]
        out[f"edges_{l}"] = e
        if f"labels_{l}" in scene_npz:
            out[f"labels_{l}"] = scene_npz[f"labels_{l}"][kept]
        for d in dilation_dists:
            key = f"dil_{d}_edges_{l}"
            if key in scene_npz and scene_npz[key].size:
                de = scene_npz[key]
                inside = (old_to_new[de[0]] >= 0) & (old_to_new[de[1]] >= 0)
                out[key] = (np.stack([old_to_new[de[0, inside]],
                                      old_to_new[de[1, inside]]])
                            if inside.any() else np.zeros((2, 0), np.int64))
        kept_per_level.append(kept)
        maps.append(old_to_new)

    if len(kept_per_level[-1]) < min_coarse_vertices:
        return None

    # Trace repair: crop traces_l (level l-1 -> level l, l >= 1); when the
    # representative fell outside the crop, re-target to the nearest kept
    # coarse vertex (reference crop_training_samples.py:141-192). Note the
    # crop convention: traces_0 (original -> level 0) is dropped, and crop
    # trace index l-1 maps level l-1 -> level l.
    for l in range(1, num_levels):
        trace = scene_npz[f"traces_{l}"]
        fine_kept = kept_per_level[l - 1]
        coarse_map = maps[l]
        coarse_kept = kept_per_level[l]
        tr = coarse_map[trace[fine_kept]]
        missing = tr < 0
        if missing.any():
            coarse_pos = scene_npz[f"vertices_{l}"][coarse_kept, 0:3]
            fine_pos = scene_npz[f"vertices_{l - 1}"][fine_kept, 0:3]
            tree = cKDTree(coarse_pos)
            _, nn = tree.query(fine_pos[missing], k=1)
            tr[missing] = nn
        if tr.min() < 0:
            raise ValueError("CROP GRAPH LEVEL ERROR: unrepaired trace")
        out[f"traces_{l - 1}"] = tr.astype(np.int64)
    return out


def process_scene_crops(scene_graph_path: str, out_dir: str,
                        block_size: float = 3.0, stride: float = 1.5,
                        num_levels: int = 3,
                        dilation_dists: Sequence[int] = (),
                        min_coarse_vertices: int = MIN_COARSE_VERTICES
                        ) -> List[str]:
    z = dict(np.load(scene_graph_path))
    scene = os.path.basename(scene_graph_path).replace(".npz", "")
    os.makedirs(os.path.join(out_dir, "graphs"), exist_ok=True)
    positions = get_sampling_positions(z["vertices_0"][:, 0:2],
                                       block_size, stride)
    bounds = [_edge_bounds(z[f"vertices_{l}"], z[f"edges_{l}"])
              for l in range(num_levels)]
    written = []
    for i, origin in enumerate(positions):
        try:
            crop = crop_scene(z, origin, block_size, num_levels,
                              dilation_dists, min_coarse_vertices,
                              edge_bounds=bounds)
        except ValueError:
            continue
        if crop is None:
            continue
        path = os.path.join(out_dir, "graphs", f"{scene}_{i}.npz")
        np.savez_compressed(path, **crop)
        written.append(path)
    return written
