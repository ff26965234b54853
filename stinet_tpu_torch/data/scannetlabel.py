"""ScanNet semantic segmentation data pipeline (21 classes).

A copy of `stinet_tpu/data/scannetlabel.py` (which imports no JAX),
building through the port's `_SceneLoader`, so its batches equal the JAX
package's leaf for leaf. As the reference's ScanNetGraphDataLoader:
9-channel inputs [color | normals | positions], level-0 labels
(`labels_0` in the scene's npz; zeros where there are none), the class
names, the precomputed -log-frequency class weights and the NYU40 colour
map, and for validation the original-mesh trace (`original_index_traces`),
so coarse predictions can be projected back to the full-resolution
vertices (reference segmentation_trainer.py:93,223).

Training crops (`<scene>_<crop>.npz`) store no original-mesh trace, so
their traces are used from index 0; full scenes carry it at index 0, and
it is kept aside. Transform randomness is stateless, keyed by (seed,
epoch, index). One process: stacked batching is not ported yet.
"""
import glob
import os
from typing import List

import numpy as np

from stinet_tpu_torch.core.registry import DATALOADERS
from stinet_tpu_torch.data.scannet import (
    SCANNET_TRAIN_FILE, SCANNET_VAL_FILE, _SceneLoader, compare_train_val,
    load_scene_npz, load_scene_pt, read_split)
from stinet_tpu_torch.data.transforms import compose
from stinet_tpu_torch.graph.build import RawHierarchy

CLASS_LABELS = [
    "none", "wall", "floor", "cabinet", "bed", "chair", "sofa", "table",
    "door", "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture"]

# -log class frequency weights (the reference's
# scannetlabelgraph_dataloader.py:116-136 hard-codes these for 21 classes)
CLASS_WEIGHTS = np.array([
    0.0, 3.5664, 3.7036, 4.4132, 4.6194, 4.2835, 4.7932, 4.4806, 4.3851,
    4.8602, 4.8350, 5.2639, 5.3004, 4.9824, 5.0312, 5.4714, 5.3965, 5.5818,
    5.5201, 5.5736, 4.5723], dtype=np.float32)

VALID_CLASS_IDS = list(range(1, 21))

SCANNET_COLOR_MAP = {
    0: (0, 0, 0), 1: (174, 199, 232), 2: (152, 223, 138), 3: (31, 119, 180),
    4: (255, 187, 120), 5: (188, 189, 34), 6: (140, 86, 75),
    7: (255, 152, 150), 8: (214, 39, 40), 9: (197, 176, 213),
    10: (148, 103, 189), 11: (196, 156, 148), 12: (23, 190, 207),
    13: (247, 182, 210), 14: (219, 219, 141), 15: (255, 127, 14),
    16: (158, 218, 229), 17: (44, 160, 44), 18: (112, 128, 144),
    19: (227, 119, 194), 20: (82, 84, 163)}


class ScanNetLabelDataSet:
    def __init__(self, root_dir: str, end_level: int, is_train: bool,
                 transform=None, no_train_cropped: bool = False,
                 max_num_scenes: int = -1, seed: int = 0):
        self._root_dir = root_dir
        self._end_level = end_level
        self._is_train = is_train
        self._no_train_cropped = no_train_cropped
        self._transform = transform
        self._seed = seed
        self._epoch = 0

        approved = set(read_split(
            SCANNET_TRAIN_FILE if is_train else SCANNET_VAL_FILE))
        paths = sorted(glob.glob(os.path.join(root_dir, "graphs", "*")))
        names = []
        for p in paths:
            base = os.path.basename(p).replace(".npz", "").replace(".pt", "")
            scene = base.rsplit("_", 1)[0] if (
                is_train and not no_train_cropped) else base
            if scene in approved:
                names.append(base)
        if max_num_scenes >= 0:
            names = names[:max_num_scenes]
        self.index2filenames: List[str] = names

    def __len__(self):
        return len(self.index2filenames)

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def _sample_rng(self, index: int):
        return np.random.default_rng(
            (int(self._seed), int(self._epoch), int(index)))

    def _load_graph(self, scene):
        npz = os.path.join(self._root_dir, "graphs", scene + ".npz")
        if os.path.exists(npz):
            return load_scene_npz(npz, self._end_level), npz
        return load_scene_pt(
            os.path.join(self._root_dir, "graphs", scene + ".pt"),
            self._end_level), None

    def __getitem__(self, index: int) -> RawHierarchy:
        scene = self.index2filenames[index]
        (vertices, edges, traces, dilated, _, banded), npz_path = \
            self._load_graph(scene)
        v0 = vertices[0].astype(np.float32)
        pos, color, normals = v0[:, 0:3], v0[:, 3:6], v0[:, 6:9]
        x = np.concatenate([color, normals, pos], axis=-1)

        labels = None
        if npz_path is not None:
            z = np.load(npz_path)
            if "labels_0" in z:
                labels = z["labels_0"].astype(np.int32)
        if labels is None:
            labels = np.zeros(v0.shape[0], np.int32)

        if self._is_train and not self._no_train_cropped:
            use_traces = traces[:self._end_level - 1]
            original_trace = None
        else:
            use_traces = traces[1:self._end_level]
            original_trace = traces[0] if traces else None

        num_vertices = [v0.shape[0]]
        for t in use_traces:
            num_vertices.append(int(t.max()) + 1)

        sample = RawHierarchy(
            x=x.astype(np.float32),
            color=color.astype(np.float32),
            mask=np.zeros((v0.shape[0], 1), np.float32),
            num_vertices=num_vertices,
            level_edges=[e for e in edges],
            traces=[t for t in use_traces],
            dilated=dilated, labels=labels, name=scene, banded=banded)
        sample.original_index_traces = original_trace
        if self._transform is not None:
            sample = self._transform(sample, self._sample_rng(index))
        return sample


@DATALOADERS.register("ScanNetGraphDataLoader")
class ScanNetGraphDataLoader:
    num_classes = 21
    class_labels = CLASS_LABELS
    class_weights = CLASS_WEIGHTS
    color_map = SCANNET_COLOR_MAP

    def __init__(self, config, multi_gpu=False, seed=0):
        c = dict(config)
        self.config = c
        if c.get("stacked_batching", False):
            raise NotImplementedError(
                "stacked_batching is not ported yet (ROADMAP.md, Queue 1 "
                "item 5: stacked training)")
        train_tf = compose(c.get("train_transform"))
        valid_tf = compose(c.get("valid_transform"))
        self.train_dataset = ScanNetLabelDataSet(
            c["train_root_dir"], c["end_level"], is_train=True,
            transform=train_tf,
            no_train_cropped=c.get("no_train_cropped", False),
            max_num_scenes=c.get("max_num_train_scenes", -1), seed=seed)
        self.val_dataset = ScanNetLabelDataSet(
            c["val_root_dir"], c["end_level"], is_train=False,
            transform=valid_tf, no_train_cropped=True,
            max_num_scenes=c.get("max_num_val_scenes", -1), seed=seed + 1)
        compare_train_val(self.train_dataset.index2filenames,
                          self.val_dataset.index2filenames,
                          train_cropped=not c.get("no_train_cropped", False))
        windowed = bool(c.get("windowed_graphs", False))
        self.train_loader = _SceneLoader(
            self.train_dataset, c["train_batch_size"], shuffle=True,
            seed=seed, windowed=windowed)
        self.val_loader = _SceneLoader(
            self.val_dataset, c["test_batch_size"], shuffle=False,
            windowed=windowed)
