"""ScanNet label utilities, a copy of `stinet_tpu/utils/scannet_utils.py`
(the reference's scannet_utils.py and the label remap of its
graph_level_generation.py:26-47): NYU40 raw ids -> the 21-class training
space (0 = unannotated, ignored), class names, valid ids, the NYU40 colour
palette, and per-vertex labels from a ScanNet scene's aggregation and
segmentation JSON and the label-map TSV."""
import csv
import json

import numpy as np

CLASS_LABELS = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture"]
NO_CLASS_ID = np.array([0])
VALID_CLASS_IDS = np.array(
    [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])

# NYU40 raw label id -> 21-class training id (0 stays "unannotated")
SCANNET_CLASS_REMAP = np.zeros(41, dtype=np.int64)
for _new, _raw in enumerate(VALID_CLASS_IDS, start=1):
    SCANNET_CLASS_REMAP[_raw] = _new

NYU40_COLOR_PALETTE = np.array([
    (0, 0, 0), (174, 199, 232), (152, 223, 138), (31, 119, 180),
    (255, 187, 120), (188, 189, 34), (140, 86, 75), (255, 152, 150),
    (214, 39, 40), (197, 176, 213), (148, 103, 189), (196, 156, 148),
    (23, 190, 207), (178, 76, 76), (247, 182, 210), (66, 188, 102),
    (219, 219, 141), (140, 57, 197), (202, 185, 52), (51, 176, 203),
    (200, 54, 131), (92, 193, 61), (78, 71, 183), (172, 114, 82),
    (255, 127, 14), (91, 163, 138), (153, 98, 156), (140, 153, 101),
    (158, 218, 229), (100, 125, 154), (178, 127, 135), (120, 185, 128),
    (146, 111, 194), (44, 160, 44), (112, 128, 144), (96, 207, 209),
    (227, 119, 194), (213, 92, 176), (94, 106, 211), (82, 84, 163),
    (100, 85, 144)])


def remap_labels(raw_labels: np.ndarray) -> np.ndarray:
    """NYU40 raw ids -> 21-class ids; out-of-range / corrupted ids -> 0
    (the reference clamps corrupted labels,
    graph_level_generation.py:345-349)."""
    raw = np.asarray(raw_labels, dtype=np.int64)
    raw = np.where((raw < 0) | (raw >= len(SCANNET_CLASS_REMAP)), 0, raw)
    return SCANNET_CLASS_REMAP[raw]


def read_label_map(tsv_file: str, label_from="raw_category",
                   label_to="nyu40id"):
    """scannetv2-labels.combined.tsv -> {raw_category: nyu40id}."""
    mapping = {}
    with open(tsv_file) as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            mapping[row[label_from]] = int(row[label_to])
    return mapping


def read_vertex_labels(agg_file: str, segs_file: str, label_map,
                       num_vertices: int) -> np.ndarray:
    """Per-vertex NYU40 labels from a scene's .aggregation.json +
    _vh_clean_2.0.010000.segs.json (reference scannet_utils.py:65-120)."""
    with open(segs_file) as f:
        seg_indices = np.asarray(json.load(f)["segIndices"])
    labels = np.zeros(num_vertices, dtype=np.int64)
    with open(agg_file) as f:
        for group in json.load(f)["segGroups"]:
            nyu_id = label_map.get(group["label"], 0)
            for seg in group["segments"]:
                labels[seg_indices == seg] = nyu_id
    return labels
