"""The generated rooms: their sizes and shape, that they load through the
program's loader, and that the reference's reading of a room file is the
loader's sample."""
import numpy as np
import pytest

from reference import training_ref
from traffic import rooms

TRANSFORMS = [
    {"type": "CoordsNormalization", "args": {"max_sizes": [1.5, 1.5, 1.5]}},
    {"type": "RandomLinearTransformation", "args": {"flip": True}},
    {"type": "RandomRotation", "args": {}},
]


def test_sizes_are_fixed_log_uniform_quantiles():
    s = rooms.room_sizes(16, 2 ** 15, 2 ** 18)
    assert s == sorted(s) and len(s) == 16
    assert 2 ** 15 < s[0] < s[-1] < 2 ** 18
    ratios = np.diff(np.log(s))
    assert np.allclose(ratios, np.log(8) / 16, atol=1e-3)


def test_room_shape_and_seed():
    a = rooms.make_room(2000, 3, 0)
    b = rooms.make_room(2000, 3, 0)
    c = rooms.make_room(2000, 4, 0)
    assert a.num_vertices == [2000, 600, 180]
    assert sorted(a.dilated) == [0, 1, 2]
    assert all(sorted(d) == [2, 4, 6, 8, 16] for d in a.dilated.values())
    assert all(np.array_equal(x, y) for x, y in zip(a.edges, b.edges))
    assert not np.array_equal(a.edges[0], c.edges[0])
    for l, t in enumerate(a.traces):      # surjective traces
        assert len(np.unique(t)) == a.num_vertices[l + 1]
    deg = np.bincount(a.edges[0][1], minlength=2000)
    assert deg.min() >= 1 and 5 < deg.mean() < 7
    coarse = rooms.make_room(2000, 3, 0, dilation_levels=[2])
    assert sorted(coarse.dilated) == [2]
    s = rooms.make_submission(a, 3, 7)
    assert s.x.shape == (2000, 10) and s.x.dtype == np.float32
    assert 0.2 < (s.mask > 0).mean() < 0.3 and s.mask.max() <= 15
    assert not np.array_equal(s.color, rooms.make_submission(a, 3, 8).color)


def _write(root, n=2):
    from stinet_tpu_torch.data.scannet import SCANNET_TRAIN_FILE, read_split
    names = read_split(SCANNET_TRAIN_FILE)[:n]
    for k, name in enumerate(names):
        room = rooms.make_room(700 + 300 * k, 9, k)
        rooms.write_room(str(root), name, room,
                         rooms.make_submission(room, 9, k))
    return sorted(names)


def test_rooms_load_through_the_programs_loader(tmp_path):
    from stinet_tpu_torch.data.scannet import ScanNetGraphColorDataLoader
    names = _write(tmp_path)
    cfg = {"train_root_dir": str(tmp_path), "val_root_dir": str(tmp_path),
           "mask_name": "rad_16", "end_level": 3, "train_batch_size": 1,
           "test_batch_size": 1, "train_transform": TRANSFORMS,
           "windowed_graphs": True}
    dl = ScanNetGraphColorDataLoader(cfg, seed=21)
    assert dl.train_dataset.index2filenames == names
    batches = list(dl.train_loader)
    assert len(batches) == 2
    graph, got = batches[0]
    assert len(graph.levels) == 3 and sorted(graph.levels[2].dilated) == \
        [2, 4, 6, 8, 16]


@pytest.mark.parametrize("index", [0, 1])
def test_reference_reads_the_loaders_sample(tmp_path, index):
    from stinet_tpu_torch.data.scannet import ScanNetGraphColorDataSet
    from stinet_tpu_torch.data.transforms import compose
    names = _write(tmp_path)
    ds = ScanNetGraphColorDataSet(str(tmp_path), "rad_16", 3, True,
                                  enabled_mask_ids=np.arange(1),
                                  transform=compose(TRANSFORMS), seed=21)
    ds.set_epoch(2)
    want = ds[index]
    nv, edges, traces, dil, x, color, mask = training_ref.load_sample(
        str(tmp_path), names[index], index, 21, 2, TRANSFORMS, 3, (2, 4))
    assert nv == list(want.num_vertices)
    np.testing.assert_array_equal(x, want.x)
    np.testing.assert_array_equal(color, want.color)
    np.testing.assert_array_equal(mask, want.mask)
    for a, b in zip(edges, want.level_edges):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(traces, want.traces):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dil[4], want.dilated[2][4])
