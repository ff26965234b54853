"""ScanNet 3D surface texture inpainting data pipeline.

A copy of `stinet_tpu/data/scannet.py` (which imports no JAX), building
through the port's `graph/build.py`, so its batches equal the JAX
package's leaf for leaf. As the reference's ScanNetGraphColorDataLoader:
per-scene graph hierarchies plus per-scene mask sets on disk, a random mask
id drawn per fetch, color normalized to [-1,1], 10-channel inputs
[color*mask_bool | normals | positions | mask_bool], per-level edge sets,
trace maps and dilated edge sets, a train/val scene-leak check, and the
canonical scannetv2 split lists (`meta/scannet/*.txt`).

On-disk format: one `<scene>.npz` per scene under `graphs/` containing
  vertices_{l} [V_l, 10] (pos 0:3 | color 3:6 | normals 6:9 | orig index 9),
  edges_{l} [2, E_l], traces_{l} [V_{l-1}] (l >= 1),
  dil_{dist}_edges_{l} [2, E], num_levels, dilation_dists.
Reference-produced torch `.pt` graph dicts are also accepted.

Masks live in `masks/<mask_name>/<scene>/<i>.npz{vertex_mask}` as the
reference writes them.

With `stacked_batching`, every batch is a stacked graph (graph/build.py
`build_stacked_graph`: each scene its own padded graph, every tensor with a
leading scene axis) at one layout frozen for the run. One process: there is
no multi-host split of the data.
"""
import glob
import hashlib
import os
import random as _random
import time
from typing import Dict, List

import numpy as np

from stinet_tpu_torch.core.registry import DATALOADERS
from stinet_tpu_torch.data.prefetch import PrefetchIterator
from stinet_tpu_torch.data.transforms import compose
from stinet_tpu_torch.graph.build import (
    RawHierarchy, build_hierarchical_graph, build_stacked_graph,
    freeze_stacked_signature)

_META = os.path.join(os.path.dirname(__file__), "meta", "scannet")
SCANNET_TRAIN_FILE = os.path.join(_META, "scannetv2_train.txt")
SCANNET_VAL_FILE = os.path.join(_META, "scannetv2_val.txt")
SCANNET_TEST_FILE = os.path.join(_META, "scannetv2_test.txt")


def read_split(path: str) -> List[str]:
    with open(path) as f:
        return f.read().splitlines()


def compare_train_val(train_names, val_names, train_cropped=False):
    """Train/val leakage assertion (reference utils/unit_tests.py:12-23)."""
    if train_cropped:
        train_scenes = {str(n).rsplit("_", 1)[0] for n in train_names}
    else:
        train_scenes = set(map(str, train_names))
    overlap = train_scenes & set(map(str, val_names))
    assert not overlap, f"train/val scene leak: {sorted(overlap)[:5]}"


def load_scene_npz(path: str, end_level: int):
    """Load a preprocessed scene graph (npz format above)."""
    z = np.load(path, allow_pickle=False)
    levels = int(z["num_levels"])
    L = min(levels, end_level)
    vertices = [z[f"vertices_{l}"] for l in range(L)]
    edges = [z[f"edges_{l}"].astype(np.int64) for l in range(L)]
    # full scenes carry num_levels traces (original->0 at index 0); crop
    # npz drop the original-mesh trace and store num_levels-1 (crops.py
    # trace convention, reference scannetcolorgraph_dataloader.py:123-129)
    traces = [z[f"traces_{l}"].astype(np.int64) for l in range(L)
              if f"traces_{l}" in z]
    dil_dists = list(z["dilation_dists"]) if "dilation_dists" in z else []
    dilated = {}
    for l in range(L):
        per_level = {}
        for i, d in enumerate(dil_dists):
            key = f"dil_{int(d)}_edges_{l}"
            if key in z and z[key].size > 0:
                per_level[int(d)] = z[key].astype(np.int64)
            elif i > 0 and int(dil_dists[i - 1]) in per_level:
                # empty dilated set (small crops): fall back to the
                # previous dilation distance, matching the reference
                # (scannetcolorgraph_dataloader.py:138-144) and the .pt
                # loader below
                per_level[int(d)] = per_level[int(dil_dists[i - 1])]
        if per_level:
            dilated[l] = per_level
    banded = bool(z["rcm_ordered"]) if "rcm_ordered" in z else False
    return vertices, edges, traces, dilated, \
        [int(d) for d in dil_dists], banded


def load_scene_pt(path: str, end_level: int):
    """Load a reference-format torch .pt scene graph (drop-in data compat)."""
    import torch
    saved = torch.load(path, map_location="cpu", weights_only=False)
    vertices = [v.numpy() for v in saved["vertices"][:end_level]]
    edges = [e.numpy().T.astype(np.int64) if e.shape[1] == 2 else
             e.numpy().astype(np.int64) for e in saved["edges"][:end_level]]
    traces = [t.numpy().astype(np.int64)
              for t in saved["traces"][:end_level]]
    dilated, dists = {}, []
    if "dilated_edges" in saved and saved.get("dilation_dists") is not None:
        dists = [int(d) for d in saved["dilation_dists"]]
        for l, de in enumerate(saved["dilated_edges"][:end_level]):
            if de is None:
                continue
            per_level = {}
            for i, d in enumerate(dists):
                if len(de[i]) > 0:
                    e = de[i].numpy()
                    per_level[d] = (e.T if e.shape[1] == 2 else e).astype(
                        np.int64)
                elif i > 0 and dists[i - 1] in per_level:
                    # fall back to the previous dilation distance
                    # (reference scannetcolorgraph_dataloader.py:138-144)
                    per_level[d] = per_level[dists[i - 1]]
            if per_level:
                dilated[l] = per_level
    return vertices, edges, traces, dilated, dists, False


class ScanNetGraphColorDataSet:
    def __init__(self, root_dir: str, mask_name: str, end_level: int,
                 is_train: bool, enabled_mask_ids=None, transform=None,
                 no_train_cropped: bool = True, num_crops_per_scene: int = -1,
                 max_num_scenes: int = -1, used_repeated_reconsts: bool = True,
                 benchmark: bool = False, seed: int = 0):
        self._root_dir = root_dir
        self._mask_name = mask_name
        self._end_level = end_level
        self._is_train = is_train
        self._no_train_cropped = no_train_cropped
        self._num_crops_per_scene = num_crops_per_scene
        self._transform = transform
        # Per-sample randomness (mask pick, transforms) is STATELESS:
        # keyed by (seed, epoch, index) instead of a sequential stream, so
        # a sample's augmentation does not depend on the order samples are
        # read in, and it equals the JAX loader's draw for draw. Loaders
        # advance the epoch via set_epoch.
        self._seed = seed
        self._epoch = 0

        split_file = (SCANNET_TRAIN_FILE if is_train else
                      (SCANNET_TEST_FILE if benchmark else SCANNET_VAL_FILE))
        approved = set(read_split(split_file))
        if not used_repeated_reconsts:
            approved = {x for x in approved
                        if int(x.split("_")[1]) == 0}

        mask_root = os.path.join(root_dir, "masks", mask_name)
        dirs = []
        if is_train and not no_train_cropped:
            per_scene: Dict[str, List[str]] = {}
            for x in glob.glob(os.path.join(mask_root, "*")):
                scene = os.path.basename(x).rsplit("_", 1)[0]
                if scene in approved:
                    per_scene.setdefault(scene, []).append(x)
            # Deterministic per-scene crop subsample, seeded by SHA1 of the
            # scene name (reference scannet_dataset.py:45-60).
            for scene, paths in per_scene.items():
                paths.sort()
                sd = int(hashlib.sha1(scene.encode()).hexdigest(), 16) % 10**8
                idx = np.arange(0, len(paths) - 1, dtype=int)
                _random.Random(sd).shuffle(idx)
                k = (min(num_crops_per_scene, len(paths))
                     if num_crops_per_scene >= 0 else len(paths))
                dirs += [paths[i] for i in idx[:k]]
        else:
            dirs = [x for x in glob.glob(os.path.join(mask_root, "*"))
                    if os.path.basename(x) in approved]
        dirs = sorted(dirs)
        if max_num_scenes >= 0:
            dirs = dirs[:max_num_scenes]

        self.index2filenames: List[str] = []
        self.index2maskfiles: List[Dict[int, str]] = []
        for d in dirs:
            masks = {}
            for f in sorted(glob.glob(os.path.join(d, "*.npz"))):
                mid = int(os.path.basename(f).split(".")[0])
                if enabled_mask_ids is None or mid in set(
                        int(i) for i in enabled_mask_ids):
                    masks[mid] = f
            if masks:
                self.index2filenames.append(os.path.basename(d))
                self.index2maskfiles.append(masks)

    def __len__(self):
        return len(self.index2filenames)

    def _load_graph(self, scene: str):
        npz = os.path.join(self._root_dir, "graphs", scene + ".npz")
        pt = os.path.join(self._root_dir, "graphs", scene + ".pt")
        if os.path.exists(npz):
            return load_scene_npz(npz, self._end_level)
        return load_scene_pt(pt, self._end_level)

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def _sample_rng(self, index: int):
        return np.random.default_rng(
            (int(self._seed), int(self._epoch), int(index)))

    def __getitem__(self, index: int) -> RawHierarchy:
        rng = self._sample_rng(index)
        scene = self.index2filenames[index]
        mask_files = self.index2maskfiles[index]
        mask_path = mask_files[
            list(mask_files)[int(rng.integers(0, len(mask_files)))]]

        (vertices, edges, traces, dilated, dists,
         banded) = self._load_graph(scene)
        # vertex layout: 0:3 pos, 3:6 color, 6:9 normals
        # (reference scannetcolorgraph_dataloader.py:91)
        v0 = vertices[0].astype(np.float32)
        pos, color, normals = v0[:, 0:3], v0[:, 3:6], v0[:, 6:9]
        color = color * 2.0 - 1.0  # [-1,1] (reference :95)

        with open(mask_path, "rb") as f:
            mask = np.load(f, allow_pickle=True)["vertex_mask"]
        mask = mask.astype(np.float32)[:, None]
        mask_bool = (mask == 0).astype(np.float32)

        x = np.concatenate(
            [color * mask_bool, normals, pos, mask_bool], axis=-1)

        # Full-mesh trace lists carry the original-mesh trace at position 0;
        # crops don't (reference scannetcolorgraph_dataloader.py:123-129).
        if self._is_train and not self._no_train_cropped:
            use_traces = traces[:self._end_level - 1]
        else:
            use_traces = traces[1:self._end_level]

        num_vertices = [v0.shape[0]]
        for t in use_traces:
            num_vertices.append(int(t.max()) + 1)

        sample = RawHierarchy(
            x=x.astype(np.float32), color=color.astype(np.float32),
            mask=mask, num_vertices=num_vertices,
            level_edges=[e for e in edges],
            traces=[t for t in use_traces],
            dilated=dilated, name=scene, banded=banded)
        if self._transform is not None:
            sample = self._transform(sample, rng)
        return sample


class _SceneLoader:
    """Yields (HierarchicalGraph, names) built on a prefetch thread; buckets
    vertex/edge counts geometrically so arbitrary scene sizes land on a
    short ladder of shapes. `build_ms` holds the host time of each batch
    (sample loads, transforms and the graph build), in order.

    With `stacked`, every batch is a stacked graph at the layout
    (`signature`: vertex buckets and table widths) that
    `freeze_stacked_signature` takes from `signature_samples` evenly spaced
    scenes at construction; a short last batch repeats its first scenes to
    keep [B, ...]. The construction's reads draw from the per-sample
    generators, which are stateless, so the batches are unchanged."""

    def __init__(self, dataset, batch_size, shuffle, seed=0,
                 pad_multiple=512, windowed=False, stacked=False,
                 signature_samples=8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self.pad_multiple = pad_multiple
        # RCM bandwidth ordering + banded ELL tables, which the windowed
        # kernels take (config key "windowed_graphs")
        self.windowed = windowed
        self.stacked = stacked
        self._epoch = 0
        self.build_ms: List[float] = []
        self.signature = None
        if stacked and len(dataset):
            k = min(signature_samples, len(dataset))
            sel = np.linspace(0, len(dataset) - 1, k).astype(int)
            self.signature = freeze_stacked_signature(
                [dataset[int(i)] for i in sel], pad_multiple=pad_multiple,
                geometric=True, windowed=windowed)

    def __len__(self):
        return max(len(self.dataset) // self.batch_size, 1) \
            if len(self.dataset) else 0

    def _produce(self):
        # advance the dataset's stateless per-sample RNG key space (one
        # "epoch" per full iteration, counting the trainer's probe)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        for b in range(len(self)):
            t0 = time.perf_counter()
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if self.stacked and len(sel) < self.batch_size:
                sel = np.concatenate([sel, sel[:self.batch_size - len(sel)]])
            samples = [self.dataset[int(i)] for i in sel]
            if self.stacked:
                graph, _ = build_stacked_graph(
                    samples, v_buckets=self.signature[0],
                    widths=self.signature[1], pad_multiple=self.pad_multiple,
                    geometric=True, windowed=self.windowed)
            else:
                graph = build_hierarchical_graph(
                    samples, pad_multiple=self.pad_multiple, geometric=True,
                    windowed=self.windowed)
            self.build_ms.append((time.perf_counter() - t0) * 1e3)
            yield graph, [s.name for s in samples]

    def skip_epoch(self):
        """Advance the epoch key and the shuffle stream as one full
        iteration does, without loading or building anything."""
        self._epoch += 1
        if self.shuffle:
            self._rng.shuffle(np.arange(len(self.dataset)))

    def __iter__(self):
        # overlap disk reads + padding with the device's work
        return iter(PrefetchIterator(self._produce(), buffer_size=2))


@DATALOADERS.register("ScanNetGraphColorDataLoader")
class ScanNetGraphColorDataLoader:
    def __init__(self, config, multi_gpu=False, seed=0):
        c = dict(config)
        self.config = c
        train_tf = compose(c.get("train_transform"))
        valid_tf = compose(c.get("valid_transform"))

        self.train_dataset = ScanNetGraphColorDataSet(
            c["train_root_dir"], c["mask_name"], c["end_level"],
            is_train=True,
            enabled_mask_ids=np.arange(0, c.get("num_train_masks", 1)),
            transform=train_tf,
            no_train_cropped=c.get("no_train_cropped", True),
            num_crops_per_scene=c.get("num_crops_per_train_scene", -1),
            max_num_scenes=c.get("max_num_train_scenes", -1),
            used_repeated_reconsts=c.get("train_use_repeated_reconsts", True),
            seed=seed)
        self.val_dataset = ScanNetGraphColorDataSet(
            c["val_root_dir"], c["mask_name"], c["end_level"],
            is_train=False,
            enabled_mask_ids=np.arange(0, c.get("num_val_masks", 1)),
            transform=valid_tf,
            no_train_cropped=c.get("no_train_cropped", True),
            num_crops_per_scene=c.get("num_crops_per_val_scene", -1),
            max_num_scenes=c.get("max_num_val_scenes", -1),
            used_repeated_reconsts=c.get("val_use_repeated_reconsts", True),
            seed=seed + 1)

        compare_train_val(self.train_dataset.index2filenames,
                          self.val_dataset.index2filenames,
                          train_cropped=not c.get("no_train_cropped", True))

        windowed = bool(c.get("windowed_graphs", False))
        self.stacked = bool(c.get("stacked_batching", False))
        self.train_loader = _SceneLoader(
            self.train_dataset, c["train_batch_size"], shuffle=True,
            seed=seed, windowed=windowed, stacked=self.stacked)
        self.val_loader = _SceneLoader(
            self.val_dataset, c["test_batch_size"], shuffle=False,
            windowed=windowed, stacked=self.stacked)

    def get_mesh(self, scene_name):
        """Original full-resolution scan mesh for visualization (reference
        scannetcolorgraph_dataloader.py:240-243); requires open3d and the
        raw `<scene>_vh_clean_2.ply` next to the graphs dir."""
        import open3d as o3d
        root = self.config.get(
            "original_meshes_dir",
            os.path.join(self.config["val_root_dir"], "scans"))
        path = os.path.join(root, scene_name,
                            f"{scene_name}_vh_clean_2.ply")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"original scan mesh not found: {path} (set "
                "data_loader.args.original_meshes_dir)")
        return o3d.io.read_triangle_mesh(path)
