"""The port's preprocessing (stinet_tpu_torch/preprocessing) against the JAX
package's, bitwise: the native decimators and rasterizer, the dilated edge
walk, the scene hierarchies with and without RCM order, crops, circle and
observer masks with their projection into crops, the ply reader and
writer, and the whole CLI (graphs, crops, masks, observer-masks) on two
small scenes, read back through both ScanNet loaders."""
import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from stinet_tpu.data import scannet as jax_scannet
from stinet_tpu.data import scannetlabel as jax_scannetlabel
from stinet_tpu.graph.build import build_hierarchical_graph as jax_build
from stinet_tpu.preprocessing import cli as jax_cli
from stinet_tpu.preprocessing import crops as jax_crops
from stinet_tpu.preprocessing import dilation as jax_dilation
from stinet_tpu.preprocessing import graph_levels as jax_levels
from stinet_tpu.preprocessing import masks as jax_masks
from stinet_tpu.preprocessing import native as jax_native
from stinet_tpu.preprocessing import plyio as jax_plyio
from stinet_tpu.utils.hostile import terrain_mesh as jax_terrain_mesh
from stinet_tpu_torch.data import scannet as port_scannet
from stinet_tpu_torch.data import scannetlabel as port_scannetlabel
from stinet_tpu_torch.graph.build import build_hierarchical_graph
from stinet_tpu_torch.preprocessing import cli as port_cli
from stinet_tpu_torch.preprocessing import crops as port_crops
from stinet_tpu_torch.preprocessing import dilation as port_dilation
from stinet_tpu_torch.preprocessing import graph_levels as port_levels
from stinet_tpu_torch.preprocessing import masks as port_masks
from stinet_tpu_torch.preprocessing import native as port_native
from stinet_tpu_torch.preprocessing import plyio as port_plyio
from stinet_tpu_torch.utils.hostile import terrain_mesh
from test_preprocessing import grid_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = port_scannet.read_split(port_scannet.SCANNET_TRAIN_FILE)[0]
VAL = port_scannet.read_split(port_scannet.SCANNET_VAL_FILE)[0]


def assert_same_arrays(got, want):
    """Two tuples, lists or dicts of arrays, equal array for array."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same_arrays(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_same_arrays(a, b)
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)


def assert_same_npz(a, b):
    za, zb = np.load(a), np.load(b)
    assert_same_arrays(dict(za), dict(zb))


def assert_same_raw(got, want, skip=()):
    """Two RawHierarchy samples, field for field (but `skip`)."""
    for f in dataclasses.fields(want):
        if f.name in skip:
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, (str, bool)) or w is None:
            assert g == w, f.name
        elif isinstance(w, list) and w and isinstance(w[0], int):
            assert g == w, f.name
        else:
            assert_same_arrays(g, w)


# --- the native library ------------------------------------------------------

DECIMATIONS = [
    ("qem", "grid", 100), ("qem", "grid", 12), ("qem", "terrain", 400),
    ("qem", "terrain", 40), ("cluster", "grid", 2.0),
    ("cluster", "terrain", 3.0)]


def _mesh(kind):
    if kind == "grid":
        return grid_mesh(20, noise=0.35, rng=np.random.default_rng(0))
    return terrain_mesh(1500, seed=2)


@pytest.mark.parametrize("how,kind,param", DECIMATIONS)
def test_decimation_equals_jax(how, kind, param):
    v, f = _mesh(kind)
    fn = f"{how}_decimate"
    port_native.reset_calls()
    got = getattr(port_native, fn)(v, f, param)
    assert port_native.calls == {fn: 1}
    assert_same_arrays(got, getattr(jax_native, fn)(v, f, param))


def test_decimation_of_isolated_vertices_equals_jax():
    v, f = terrain_mesh(1500, seed=2)
    v = np.vstack([v, [[500.0, 500.0, 500.0]],
                   [v[0] + np.array([0.01, 0.0, 0.0])]])
    assert_same_arrays(port_native.qem_decimate(v, f, 400),
                       jax_native.qem_decimate(v, f, 400))


@pytest.mark.parametrize("fn,param", [("qem_decimate", 400),
                                      ("cluster_decimate", 2.0)])
def test_out_of_range_faces_raise_as_in_jax(fn, param):
    v, f = terrain_mesh(1500, seed=2)
    bad = f.copy()
    bad[0, 0] = 10 ** 6
    for mod in (port_native, jax_native):
        with pytest.raises(ValueError, match="out of range"):
            getattr(mod, fn)(v, bad, param)


def test_rasterize_depth_equals_jax():
    """A terrain seen from above, with a corrupt face (skipped by both)
    and faces behind the camera."""
    v, f = terrain_mesh(1600, seed=1)
    w, h = 96, 64
    z = 50.0 - v[:, 2]
    z[:40] = -1.0
    pts = np.stack([v[:, 0] * w / 40.0, v[:, 1] * h / 40.0, z], 1)
    bad = f.copy()
    bad[3, 1] = -7
    for faces in (f, bad):
        got = port_native.rasterize_depth(pts, faces, w, h)
        assert np.isfinite(got).any()
        assert_same_arrays(got, jax_native.rasterize_depth(pts, faces, w, h))


def test_decimator_builds_the_ports_own_source():
    root = os.path.join(ROOT, "stinet_tpu_torch")
    assert str(port_native.SRC) == os.path.join(
        root, "preprocessing", "native", "decimator.cpp")
    assert str(port_native.lib_path().parent) == os.path.join(root,
                                                               "_build")
    assert port_native.GXX_FLAGS == ("-O3", "-shared", "-fPIC",
                                     "-std=c++17")
    port_native.get_lib()
    assert port_native.lib_path().exists()


def test_failed_decimator_compile_raises(tmp_path, monkeypatch):
    bad = tmp_path / "decimator.cpp"
    bad.write_text(port_native.SRC.read_text() + "\nint broken( {\n")
    monkeypatch.setattr(port_native, "SRC", bad)
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(port_native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g[+][+] failed.*error"):
        port_native.qem_decimate(*grid_mesh(5), 10)
    assert not list((tmp_path / "build").glob("*"))


# --- dilation, hierarchies, crops --------------------------------------------

@pytest.mark.parametrize("kind", ["grid", "terrain"])
def test_dilated_edges_equal_jax(kind):
    if kind == "grid":
        v, f = grid_mesh(12, noise=0.02, rng=np.random.default_rng(0))
        v[:, 0:2] += np.random.default_rng(1).uniform(-0.2, 0.2,
                                                      (len(v), 2))
    else:
        v, f = terrain_mesh(900, seed=4)
    edges = port_levels.edges_from_faces(f)
    normals = port_levels.vertex_normals(v, f)
    assert_same_arrays(edges, jax_levels.edges_from_faces(f))
    assert_same_arrays(normals, jax_levels.vertex_normals(v, f))
    dils = [2, 4, 6, 8, 16]
    assert_same_arrays(
        port_dilation.compute_all_node_dilated_edges(edges, v, normals,
                                                     dils),
        jax_dilation.compute_all_node_dilated_edges(edges, v, normals, dils))


@pytest.mark.parametrize("rcm", [False, True])
def test_scene_levels_equal_jax(rcm):
    v, f = terrain_mesh(2500, seed=3)
    rng = np.random.default_rng(0)
    colors = rng.uniform(0, 1, (len(v), 3))
    labels = rng.integers(0, 21, len(v))
    args = (v, f, colors, labels, ["100", "30", "2v"], [2, 4], [1, 2])
    got = port_levels.build_scene_levels(*args, rcm=rcm)
    assert_same_arrays(got, jax_levels.build_scene_levels(*args, rcm=rcm))
    assert ("rcm_ordered" in got) == rcm


@pytest.fixture(scope="module")
def scene_npz(tmp_path_factory):
    """One RCM-ordered scene file, written by the JAX package."""
    d = tmp_path_factory.mktemp("scene")
    v, f = terrain_mesh(3600, seed=5)
    v[:, :2] *= 8.0 / 60.0          # a room of 8 m x 8 m
    colors = np.random.default_rng(1).uniform(0, 1, (len(v), 3))
    data = jax_levels.build_scene_levels(
        v, f, colors, None, ["100", "30", "30"], [2, 4, 6, 8, 16],
        rcm=True)
    os.makedirs(d / "graphs")
    path = str(d / "graphs" / f"{VAL}.npz")
    np.savez_compressed(path, **data)
    return path, v, f


def test_scene_crops_equal_jax(tmp_path, scene_npz):
    path = scene_npz[0]
    kw = dict(block_size=3.0, stride=1.5, num_levels=3,
              dilation_dists=[2, 4, 6, 8, 16], min_coarse_vertices=20)
    got = port_crops.process_scene_crops(path, str(tmp_path / "port"), **kw)
    want = jax_crops.process_scene_crops(path, str(tmp_path / "jax"), **kw)
    assert len(got) > 4
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        assert_same_npz(a, b)


# --- masks -------------------------------------------------------------------

def _mask_files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(
        os.path.join(root, "**", "*.npz"), recursive=True))


def assert_same_trees(a, b):
    files = _mask_files(a)
    assert files and files == _mask_files(b)
    for rel in files:
        assert_same_npz(os.path.join(a, rel), os.path.join(b, rel))


@pytest.mark.parametrize("builder", ["native", "scipy"])
def test_circle_masks_equal_jax(tmp_path, scene_npz, monkeypatch, builder):
    """generate_masks_for_scene, projected into the scene's crops, on the
    native bounded BFS and on scipy's (STINET_NATIVE_BUILD=0, both
    packages)."""
    path = scene_npz[0]
    crops = port_crops.process_scene_crops(
        path, str(tmp_path / "crops"), min_coarse_vertices=20)
    if builder == "scipy":
        monkeypatch.setenv("STINET_NATIVE_BUILD", "0")
    kw = dict(num_masks=4, radius=6, frac_masked=0.2, seed=3,
              crop_graph_paths=crops)
    got = port_masks.generate_masks_for_scene(
        path, str(tmp_path / "port"), "rad_6", **kw)
    jax_masks.generate_masks_for_scene(path, str(tmp_path / "jax"),
                                       "rad_6", **kw)
    assert len(got) == 4
    assert_same_trees(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_circle_mask_equals_jax_on_each_adjacency():
    v, f = grid_mesh(14)
    edges = port_levels.edges_from_faces(f)
    from stinet_tpu.graph import native as jax_graph_native
    from stinet_tpu_torch.graph import native as port_graph_native
    for port_adj, jax_adj in (
            (edges, edges),
            (port_graph_native.Adjacency(edges, len(v)),
             jax_graph_native.Adjacency(edges, len(v)))):
        got = port_masks.circle_mask(port_adj, len(v), 4, 0.3,
                                     np.random.default_rng(7))
        want = jax_masks.circle_mask(jax_adj, len(v), 4, 0.3,
                                     np.random.default_rng(7))
        assert_same_arrays(got, want)


def _look_down_poses(n, room=8.0, height=6.0, seed=0):
    """World-to-camera 4x4s of cameras above the room looking down."""
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        eye = np.array([*rng.uniform(0, room, 2), height])
        r = np.diag([1.0, -1.0, -1.0])       # camera z points down
        pose = np.eye(4)
        pose[:3, :3] = r
        pose[:3, 3] = -r @ eye
        poses.append(pose)
    return poses


def test_observer_masks_equal_jax(tmp_path, scene_npz):
    path, v, f = scene_npz
    crops = port_crops.process_scene_crops(
        path, str(tmp_path / "crops"), min_coarse_vertices=20)
    poses = _look_down_poses(8)
    intr = (80.0, 80.0, 47.5, 31.5)
    vis = port_masks.pose_visibility(v, f, poses[0], intr, 96, 64)
    assert vis.any() and not vis.all()
    assert_same_arrays(vis, jax_masks.pose_visibility(v, f, poses[0], intr,
                                                      96, 64))
    kw = dict(intrinsics=intr, width=96, height=64, num_masks=3,
              pose_fraction=0.5, seed=2, crop_graph_paths=crops)
    got = port_masks.generate_observer_masks_for_scene(
        path, v, f, poses, str(tmp_path / "port"), "observers", **kw)
    jax_masks.generate_observer_masks_for_scene(
        path, v, f, poses, str(tmp_path / "jax"), "observers", **kw)
    assert got
    assert_same_trees(str(tmp_path / "port"), str(tmp_path / "jax"))


# --- ply ---------------------------------------------------------------------

@pytest.mark.parametrize("binary", [True, False])
def test_ply_round_trip_equals_jax(tmp_path, binary):
    v, f = grid_mesh(6)
    colors = np.random.default_rng(0).uniform(0, 1, (len(v), 3))
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    port_plyio.write_ply(a, v, f, colors, binary=binary)
    jax_plyio.write_ply(b, v, f, colors, binary=binary)
    assert open(a, "rb").read() == open(b, "rb").read()
    got = port_plyio.read_ply(a)
    assert_same_arrays(got, jax_plyio.read_ply(a))
    np.testing.assert_allclose(got["vertices"], v, atol=1e-5)
    np.testing.assert_array_equal(got["faces"], f)


# --- the command line --------------------------------------------------------

def _write_scans(root):
    """Two small rooms in ScanNet's layout, one train and one val scene."""
    for seed, name in enumerate((TRAIN, VAL)):
        v, f = jax_terrain_mesh(3600, seed=seed)
        v[:, :2] *= 8.0 / 60.0
        colors = np.random.default_rng(seed).uniform(0, 1, (len(v), 3))
        os.makedirs(os.path.join(root, name))
        port_plyio.write_ply(
            os.path.join(root, name, f"{name}_vh_clean_2.ply"), v, f,
            colors)
        poses = _look_down_poses(6, seed=seed)
        os.makedirs(os.path.join(root, "poses", name))
        for i, p in enumerate(poses):
            np.savetxt(os.path.join(root, "poses", name, f"{i}.txt"),
                       np.linalg.inv(p))


def _jax_cli(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["cli", *argv])
    jax_cli.main()


@pytest.fixture(scope="module")
def cli_outputs(tmp_path_factory):
    """The whole CLI in both packages: `graphs` at --jobs 2 in the port (a
    process pool over both scenes, run as its own command) and at --jobs 1
    in the JAX package (whose pool cannot pickle its worker), then crops,
    masks into the crops, and observer masks."""
    tmp = tmp_path_factory.mktemp("cli")
    scans = str(tmp / "scans")
    _write_scans(scans)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for pkg in ("port", "jax"):
            graphs, crops = str(tmp / pkg / "graphs"), str(tmp / pkg / "crops")
            if pkg == "port":
                res = subprocess.run(
                    [sys.executable, "-m",
                     "stinet_tpu_torch.preprocessing.cli", "graphs",
                     "--scans", scans, "--out", graphs, "--jobs", "2"],
                    cwd=ROOT, capture_output=True, text=True, timeout=300)
                assert res.returncode == 0, res.stderr
                assert res.stdout.count("wrote") == 2, res.stdout
                run = port_cli.main
            else:
                _jax_cli(["graphs", "--scans", scans, "--out", graphs,
                          "--jobs", "1"], mp)
                run = lambda argv: _jax_cli(argv, mp)  # noqa: E731
            run(["crops", "--graphs", graphs, "--out", crops,
                 "--min-coarse", "20"])
            run(["masks", "--graphs", graphs, "--out", graphs,
                 "--crops", crops, "--num-masks", "3", "--radius", "6"])
            run(["observer-masks", "--graphs", graphs, "--scans", scans,
                 "--poses", os.path.join(scans, "poses"), "--out", graphs,
                 "--num-masks", "2", "--pose-fraction", "0.5",
                 "--intrinsics", "80,80,47.5,31.5", "--img-wh", "96,64"])
            out[pkg] = graphs, crops
    finally:
        mp.undo()
    return out


def test_cli_writes_what_jax_writes(cli_outputs):
    (pg, pc), (jg, jc) = cli_outputs["port"], cli_outputs["jax"]
    for a, b in ((pg, jg), (pc, jc)):
        files = _mask_files(a)
        assert files == _mask_files(b)
        for rel in files:
            assert_same_npz(os.path.join(a, rel), os.path.join(b, rel))
    names = _mask_files(pg)
    assert f"graphs/{TRAIN}.npz" in names and f"graphs/{VAL}.npz" in names
    assert any(n.startswith(f"masks/rad_16/{TRAIN}_") for n in names)
    assert any(n.startswith(f"masks/observers/{VAL}/") for n in names)


@pytest.mark.parametrize("cropped", [False, True])
def test_loaders_read_the_cli_output_alike(cli_outputs, cropped):
    """The port's ScanNet loader reads the port's files into the samples
    JAX's loader reads from JAX's: the full scenes, and the training crops
    (no_train_cropped false, the crops' graphs beside the masks), each of
    which the port builds. The level sizes are the files' vertex counts;
    JAX's loader counts a crop's coarse level as its trace's max + 1, one
    short on some crops (test_crop_level_sizes_come_from_the_vertex_arrays
    below)."""
    samples, roots = {}, {}
    for pkg, mod in (("port", port_scannet), ("jax", jax_scannet)):
        graphs, crops = cli_outputs[pkg]
        root = graphs
        if cropped:
            root = os.path.join(os.path.dirname(graphs), "crop_root")
            if not os.path.isdir(root):
                os.makedirs(root)
                os.symlink(os.path.join(crops, "graphs"),
                           os.path.join(root, "graphs"))
                os.symlink(os.path.join(graphs, "masks"),
                           os.path.join(root, "masks"))
        ds = mod.ScanNetGraphColorDataSet(
            root, "rad_16", 3, is_train=True, no_train_cropped=not cropped)
        samples[pkg] = [ds[i] for i in range(len(ds))]
        roots[pkg] = root
    assert len(samples["port"]) == len(samples["jax"]) > 0
    if cropped:
        assert len(samples["port"]) > 1
    for got, want in zip(samples["port"], samples["jax"]):
        assert_same_raw(got, want, skip=("num_vertices",))
        z = np.load(os.path.join(roots["port"], "graphs", got.name + ".npz"))
        assert got.num_vertices == [len(z[f"vertices_{l}"])
                                    for l in range(3)]
        if not cropped:
            assert got.num_vertices == want.num_vertices
        build_hierarchical_graph([got])


def _crop_missing_its_last_coarse_vertex(root, scene_npz):
    """A training crop of the module's scene whose level-0 trace reaches
    every level-1 vertex but the last (as crops.py writes them where the
    fine vertices of that coarse vertex fell outside the crop), with a
    mask set, twice: `<root>/graphs/<TRAIN>_{0,1}.npz` (the colour
    loader's seeded crop subsample leaves one crop of a scene out)."""
    crop = port_crops.crop_scene(dict(np.load(scene_npz[0])),
                                 np.array([2.0, 2.0]), 3.0, 3,
                                 min_coarse_vertices=5)
    last = len(crop["vertices_1"]) - 1
    tr = crop["traces_0"]
    tr[tr == last] = 0
    assert tr.max() + 1 < len(crop["vertices_1"])
    os.makedirs(os.path.join(root, "graphs"))
    for name in (f"{TRAIN}_0", f"{TRAIN}_1"):
        np.savez(os.path.join(root, "graphs", f"{name}.npz"), **crop)
        os.makedirs(os.path.join(root, "masks", "rad_16", name))
        np.savez(os.path.join(root, "masks", "rad_16", name, "0.npz"),
                 vertex_mask=np.zeros(len(crop["vertices_0"]), np.float32))
    return crop


@pytest.mark.parametrize("loader", ["colour", "label"])
def test_crop_level_sizes_come_from_the_vertex_arrays(tmp_path, scene_npz,
                                                      loader):
    """A coarse level's size is its vertex array's, not its trace's max + 1:
    the JAX loaders count the latter, one short on such a crop, and JAX's
    build then fails; the port's loaders read the crop and build it."""
    crop = _crop_missing_its_last_coarse_vertex(str(tmp_path), scene_npz)
    sizes = [len(crop[f"vertices_{l}"]) for l in range(3)]
    if loader == "colour":
        port = port_scannet.ScanNetGraphColorDataSet(
            str(tmp_path), "rad_16", 3, is_train=True, no_train_cropped=False)
        ref = jax_scannet.ScanNetGraphColorDataSet(
            str(tmp_path), "rad_16", 3, is_train=True, no_train_cropped=False)
    else:
        port = port_scannetlabel.ScanNetLabelDataSet(str(tmp_path), 3, True)
        ref = jax_scannetlabel.ScanNetLabelDataSet(str(tmp_path), 3, True)
    got = port[0]
    assert got.num_vertices == sizes
    build_hierarchical_graph([got])
    want = ref[0]
    assert want.num_vertices == [sizes[0], sizes[1] - 1, sizes[2]]
    with pytest.raises(ValueError, match="broadcast"):
        jax_build([want])
