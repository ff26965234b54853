"""Dilated edge-set computation — capability parity with the reference's
preprocessing/graph_dilation.py:50-137, vectorized. A copy of the JAX
package's `preprocessing/dilation.py` (numpy only): the two give the same
edges in the same order.

For every vertex c and each of its one-hop neighbors, a walk proceeds
outward; at each step the next vertex is the neighbor of the current one
(excluding the previous vertex and c's one-hop set) whose direction, after
projection into the current vertex's tangent plane, is most aligned with the
travel direction (cosine similarity >= 0). Edges (walk_vertex -> c) are
recorded at the requested dilation distances.

Differences from the reference (documented, behavior-equivalent on its own
dil_test fixture): the tangent-plane projection uses the standard formula
u - n*dot(u, n) for unit normals (the reference divides by |n||u| —
graph_dilation.py:28-29 — which coincides for the unit vectors it is fed);
ties in the similarity argmax may resolve to a different neighbor. The walk
itself is O(V*deg*max_dil) fully vectorized numpy instead of a python loop
per vertex.
"""
from typing import List, Sequence

import numpy as np


def build_csr(edges: np.ndarray, num_vertices: int):
    """edges [2, E] directed (src -> dst meaning dst adjacency? here we use
    out-neighbors of each vertex: adjacency[v] = {u : (v, u) in E}). The
    reference builds adj_lists[edge[0]].append(edge[1])."""
    src, dst = edges[0], edges[1]
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    keep = np.ones(len(src), bool)  # coalesce duplicates
    keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
    src, dst = src[keep], dst[keep]
    indptr = np.zeros(num_vertices + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, dst.astype(np.int64)


def _neighbor_matrix(indptr, indices, num_vertices):
    deg = np.diff(indptr)
    max_deg = int(deg.max()) if len(deg) else 0
    nbr = np.full((num_vertices, max_deg), -1, np.int64)
    rows = np.repeat(np.arange(num_vertices), deg)
    cols = np.concatenate([np.arange(d) for d in deg]) if num_vertices else \
        np.zeros(0, np.int64)
    nbr[rows, cols] = indices
    return nbr, deg


def _project(n, u):
    """u - n * dot(u, n): tangent-plane projection for unit normals."""
    return u - n * np.sum(u * n, axis=-1, keepdims=True)


def compute_all_node_dilated_edges(
        edges: np.ndarray, positions: np.ndarray, normals: np.ndarray,
        dilations: Sequence[int]) -> List[np.ndarray]:
    """Returns one [2, E_d] edge array (src=dilated vertex, dst=center) per
    requested dilation distance."""
    dilations = sorted(int(d) for d in dilations)
    v = positions.shape[0]
    pos = positions.astype(np.float64)
    nrm = normals.astype(np.float64)
    nn = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm / np.maximum(nn, 1e-12)

    indptr, indices = build_csr(edges, v)
    nbr, deg = _neighbor_matrix(indptr, indices, v)
    if nbr.size == 0:
        return [np.zeros((2, 0), np.int64) for _ in dilations]
    max_deg = nbr.shape[1]

    # membership keys for "candidate in one_hop(center)" tests
    adj_keys = np.sort(indices + indptr_to_rows(indptr, v) * v)

    # fronts: one per directed edge (center, one-hop neighbor)
    center = np.repeat(np.arange(v), deg)
    cur = indices.copy()
    keep = cur != center
    center, cur = center[keep], cur[keep]
    last = center.copy()
    direction = pos[cur] - pos[center]
    alive = np.ones(len(center), bool)

    results = {d: [] for d in dilations}
    max_dil = max(dilations)
    for current_dilation in range(2, max_dil + 1):
        if not alive.any():
            break
        idx = np.nonzero(alive)[0]
        c_cur, c_center, c_last = cur[idx], center[idx], last[idx]
        cand = nbr[c_cur]                      # [K, D]
        valid = cand >= 0
        valid &= cand != c_last[:, None]
        # exclude candidates in one_hop(center) — includes center itself
        keys = c_center[:, None] * v + np.where(cand >= 0, cand, 0)
        pos_in = np.searchsorted(adj_keys, keys)
        member = (pos_in < len(adj_keys)) & (
            adj_keys[np.minimum(pos_in, len(adj_keys) - 1)] == keys)
        valid &= ~member

        n_cur = nrm[c_cur]                     # [K, 3]
        d_proj = _project(n_cur, direction[idx])
        nb_dir = pos[np.where(cand >= 0, cand, 0)] - pos[c_cur][:, None]
        nb_proj = nb_dir - n_cur[:, None] * np.sum(
            nb_dir * n_cur[:, None], axis=-1, keepdims=True)
        num = np.sum(nb_proj * d_proj[:, None], axis=-1)
        den = (np.linalg.norm(nb_proj, axis=-1)
               * np.linalg.norm(d_proj, axis=-1)[:, None])
        sim = np.where(den > 1e-12, num / np.maximum(den, 1e-12), -np.inf)
        sim = np.where(valid, sim, -np.inf)
        # The reference updates on `similarity >= max_similarity`
        # (graph_dilation.py:121), so ties resolve to the LAST neighbor in
        # (ascending) adjacency order — argmax over the reversed axis.
        best = sim.shape[1] - 1 - np.argmax(sim[:, ::-1], axis=1)
        best_sim = sim[np.arange(len(idx)), best]
        ok = best_sim >= 0.0
        best_vertex = cand[np.arange(len(idx)), best]

        # fronts with no valid continuation die
        alive[idx[~ok]] = False
        idx = idx[ok]
        if len(idx) == 0:
            continue
        nxt = best_vertex[ok]
        if current_dilation in results:
            results[current_dilation].append(
                np.stack([nxt, center[idx]]))
        # advance
        last[idx] = cur[idx]
        cur[idx] = nxt
        new_dir = _project(nrm[nxt], direction[idx])
        nn2 = np.linalg.norm(new_dir, axis=1, keepdims=True)
        direction[idx] = new_dir / np.maximum(nn2, 1e-12)

    out = []
    for d in dilations:
        if results[d]:
            e = np.concatenate(results[d], axis=1)
            # coalesce duplicates
            key = e[0] * v + e[1]
            _, uniq = np.unique(key, return_index=True)
            out.append(e[:, np.sort(uniq)])
        else:
            out.append(np.zeros((2, 0), np.int64))
    return out


def indptr_to_rows(indptr, num_vertices):
    return np.repeat(np.arange(num_vertices), np.diff(indptr))
