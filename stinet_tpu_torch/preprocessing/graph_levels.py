"""Graph hierarchy generation — capability parity with the reference's
preprocessing/graph_level_generation.py: per scene, read the
mesh, compute vertex normals, build level-0 edges from faces, then per level
either QEM-decimate (numeric level param = percentage of vertices to keep) or
vertex-cluster (param like '0.02v' = voxel size) via the native decimator,
transfer colors/normals/labels to coarse levels by nearest neighbor, compute
dilated edge sets, and write one npz per scene.

Differences from the reference: the decimators run in-process through
ctypes (no PLY / CSV round-trips, no BallTree trace reconstruction — traces
come from the collapse bookkeeping directly), normals are computed with
vectorized numpy instead of open3d, and output is npz (the loaders also
accept reference .pt files). A copy of the JAX package's
`preprocessing/graph_levels.py` over the port's native libraries: the two
write the same arrays.
"""
import os
from typing import Optional, Sequence

import numpy as np
from scipy.spatial import cKDTree

from stinet_tpu_torch.graph import native as _graph_native
from stinet_tpu_torch.graph.build import rcm_perm
from stinet_tpu_torch.preprocessing import native
from stinet_tpu_torch.preprocessing.dilation import (
    compute_all_node_dilated_edges)
from stinet_tpu_torch.preprocessing.plyio import read_ply


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    v = vertices
    fn = np.cross(v[faces[:, 1]] - v[faces[:, 0]],
                  v[faces[:, 2]] - v[faces[:, 0]])
    normals = np.zeros_like(v)
    for k in range(3):
        np.add.at(normals, faces[:, k], fn)
    n = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(n, 1e-12)


def edges_from_faces(faces: np.ndarray) -> np.ndarray:
    """Directed [2, E] edge list (both directions, no self loops, deduped) —
    reference edges_from_faces (graph_level_generation.py:119-132). The
    native hash-dedup twin (graph/native) preserves this path's exact
    first-occurrence edge order; STINET_NATIVE_BUILD=0 forces numpy."""
    if len(faces) and _graph_native.available():
        return _graph_native.edges_from_faces(faces, int(faces.max()) + 1)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]], axis=0)
    e = np.concatenate([e, e[:, ::-1]], axis=0)
    e = e[e[:, 0] != e[:, 1]]
    nv = int(faces.max()) + 1 if len(faces) else 0
    key = e[:, 0].astype(np.int64) * nv + e[:, 1]
    _, uniq = np.unique(key, return_index=True)
    return e[np.sort(uniq)].T.astype(np.int64)


def transfer_attributes(src_pos, src_attrs, dst_pos):
    """NN transfer of per-vertex attributes (reference get_color_and_labels,
    graph_level_generation.py:98-116)."""
    tree = cKDTree(src_pos)
    _, idx = tree.query(dst_pos, k=1)
    return [a[idx] for a in src_attrs]


def decimate_level(vertices, faces, level_param):
    """One decimation step: numeric param -> QEM keep param% of vertices;
    'Xv' param -> vertex clustering with voxel size X. param == 100 is the
    identity level (reference extract_plain_mesh)."""
    if isinstance(level_param, str) and level_param.endswith("v"):
        cell = float(level_param[:-1])
        return native.cluster_decimate(vertices, faces, cell)
    ratio = float(level_param)
    if ratio >= 100:
        return (vertices.copy(), faces.copy(),
                np.arange(len(vertices), dtype=np.int64))
    target = max(int(len(vertices) * ratio / 100.0), 4)
    return native.qem_decimate(vertices, faces, target)


def _rcm_relabel_levels(out: dict) -> dict:
    """Offline RCM pass: permute every level's vertices to bandwidth order
    (graph/native rcm_order) so windowed training/serving builds skip their
    per-sample reorder (build.py:_is_banded). Pure relabeling — vertex rows,
    edge ids, traces and dilated edges are rewritten consistently. The
    index channel (vertices[:, 9]) is re-stamped to the NEW ids: its
    invariant is "this vertex's index in the full-scene level array"
    (crop/mask projection reads it, crops.py/masks.py), which the
    relabeling must keep true."""
    L = int(out["num_levels"])
    perms, invs = [], []
    for l in range(L):
        order, inv = rcm_perm(out[f"edges_{l}"],
                              out[f"vertices_{l}"].shape[0])
        perms.append(order)
        invs.append(inv)
    for l in range(L):
        v = out[f"vertices_{l}"][perms[l]]
        v[:, 9] = np.arange(len(v), dtype=v.dtype)
        out[f"vertices_{l}"] = v
        out[f"edges_{l}"] = invs[l][out[f"edges_{l}"]]
        if f"labels_{l}" in out:
            out[f"labels_{l}"] = out[f"labels_{l}"][perms[l]]
        for key in list(out):
            if key.startswith("dil_") and key.endswith(f"_edges_{l}") \
                    and out[key].size:
                out[key] = invs[l][out[key]]
        # traces_0: original mesh -> level 0 (values relabel only);
        # traces_l (l>=1): level l-1 -> level l (rows follow level l-1's
        # permutation, values relabel into level l's new ids)
        tr = out[f"traces_{l}"]
        if l == 0:
            out["traces_0"] = invs[0][tr]
        else:
            out[f"traces_{l}"] = invs[l][tr][perms[l - 1]]
    return out


def build_scene_levels(vertices: np.ndarray, faces: np.ndarray,
                       colors: Optional[np.ndarray],
                       labels: Optional[np.ndarray],
                       level_params: Sequence,
                       dilation_dists: Sequence[int] = (),
                       dilation_levels: Sequence[int] = (),
                       rcm: bool = False) -> dict:
    """Produce the npz-able dict for one scene.

    level_params follows the reference convention ("100 30 30 30"): the first
    param produces level 0 from the original mesh, each subsequent one the
    next level. traces_0 maps original vertices -> level 0; traces_l maps
    level l-1 -> level l. With `rcm`, vertices are stored in RCM bandwidth
    order (windowed builds then skip their per-sample reorder).
    """
    if colors is None:
        colors = np.zeros((len(vertices), 3), np.float64)
    orig_pos = vertices.copy()
    orig_colors = colors
    orig_labels = labels

    out = {"num_levels": len(level_params),
           "dilation_dists": np.asarray(list(dilation_dists), np.int64)}
    cur_v, cur_f = vertices, faces

    for l, param in enumerate(level_params):
        new_v, new_f, trace = decimate_level(cur_v, cur_f, param)
        # attribute transfer from the ORIGINAL mesh by nearest neighbor
        attrs = [orig_colors] + ([orig_labels] if orig_labels is not None
                                 else [])
        moved = transfer_attributes(orig_pos, attrs, new_v)
        col = moved[0]
        normals = vertex_normals(new_v, new_f) if len(new_f) else \
            np.zeros_like(new_v)
        verts10 = np.concatenate(
            [new_v, col, normals,
             np.arange(len(new_v), dtype=np.float64)[:, None]],
            axis=1).astype(np.float32)
        edges = edges_from_faces(new_f) if len(new_f) else \
            np.zeros((2, 0), np.int64)

        out[f"vertices_{l}"] = verts10
        out[f"edges_{l}"] = edges
        out[f"traces_{l}"] = trace.astype(np.int64)
        if orig_labels is not None:
            out[f"labels_{l}"] = moved[1].astype(np.int32)

        if dilation_dists and (not dilation_levels or l in dilation_levels):
            dil = compute_all_node_dilated_edges(
                edges, new_v, normals, dilation_dists)
            for d, e in zip(sorted(dilation_dists), dil):
                out[f"dil_{d}_edges_{l}"] = e.astype(np.int64)

        cur_v, cur_f = new_v, new_f

    if rcm:
        out = _rcm_relabel_levels(out)
        # loaders propagate this into RawHierarchy.banded so windowed
        # builds skip their per-sample reorder without re-deriving it
        out["rcm_ordered"] = np.int64(1)
    return out


def process_scene(ply_path: str, out_dir: str, level_params: Sequence,
                  dilation_dists: Sequence[int] = (2, 4, 6, 8, 16),
                  dilation_levels: Sequence[int] = (),
                  labels: Optional[np.ndarray] = None,
                  rcm: bool = False) -> str:
    mesh = read_ply(ply_path)
    scene = os.path.basename(ply_path).replace("_vh_clean_2.ply", "") \
        .replace(".ply", "")
    data = build_scene_levels(
        mesh["vertices"], mesh["faces"], mesh.get("colors"), labels,
        level_params, dilation_dists, dilation_levels, rcm=rcm)
    os.makedirs(os.path.join(out_dir, "graphs"), exist_ok=True)
    out_path = os.path.join(out_dir, "graphs", scene + ".npz")
    np.savez_compressed(out_path, **data)
    return out_path
