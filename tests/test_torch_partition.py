"""Graph-partition serving in the port (stinet_tpu_torch/graph/partition.py,
parallel/{halo,mesh,sharded_block,sharded_stinet}.py and
`SceneInpainter.predict_partitioned` / `mesh=`) against the JAX package, on
the CPU.

- `partition_hierarchy` and `build_halo_plan` equal JAX's leaf for leaf,
  bitwise, at 2, 4 and 8 parts, with the layout invariants of
  tests/test_sharded_stinet.py;
- `predict_partitioned` on an in-process mesh of 2 and 4 partitions is
  within rtol 1e-4, atol 1e-5 of JAX's single-device `model.apply` on the
  same scene and weights in f32 (JAX's own tolerance for its sharded
  forward, tests/test_sharded_stinet.py:74: the partitioned ELL tables
  order a row's slots otherwise and the norm sums partials in partition
  order); in bf16 within BF16_TOL (every conv, norm input and block output
  rounds to 8 bits of mantissa, in another order than JAX's: the port's
  single-device bf16 `predict` is 0.024 from JAX's on this scene already);
- a gloo process mesh of 2 ranks gives the in-process mesh's bits, and its
  `predict_batch` (a share a rank) the plain server's.

JAX compiles: the f32 and the bf16 forward, one each (the weights come from
the port's model through JAX's own reference-checkpoint converter, so JAX
initialises nothing).
"""
import dataclasses
import os
import socket
import tempfile
import time

import jax
import numpy as np
import pytest
import torch

from stinet_tpu.graph.build import build_hierarchical_graph as jax_build
from stinet_tpu.graph.partition import (
    partition_hierarchy as jax_partition_hierarchy)
from stinet_tpu.models.factory import define_G as jax_define_G
from stinet_tpu.parallel.halo import build_halo_plan as jax_build_halo_plan
from stinet_tpu.utils.convert_reference_checkpoint import (
    convert_stinet_state_dict)
from stinet_tpu.utils.synthetic import synthetic_scene as jax_scene
from stinet_tpu_torch.graph.partition import (
    PartitionedGraph, _partition_ell, partition_hierarchy, shard)
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.parallel.halo import build_halo_plan, halo_exchange
from stinet_tpu_torch.parallel.mesh import InProcessMesh, make_mesh
from stinet_tpu_torch.parallel.sharded_stinet import place_partitioned
from stinet_tpu_torch.serving import PackedPlacer, SceneInpainter
from stinet_tpu_torch.utils.synthetic import synthetic_scene

RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 5e-2     # max |diff| of tanh outputs, bf16 against JAX's bf16
SCENE = dict(num_vertices=600, levels=3, seed=3, dilation_dists=(2, 4))
TINY = dict(input_nc=10, output_nc=3, ngf=8, n_blocks=3, dilations=[1, 2, 4],
            norm="instance", pooling_type="max", n_levels=2,
            n_repeated_io_convs=1, filter_type="edgeconvtransinv")
SPAWN_TIMEOUT = 240


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's intra-op pool at one thread while this module runs (under
    pytest-xdist every worker's default pool takes all the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same_tree(got, want, path="graph"):
    """Two partitioned layouts equal leaf for leaf, bitwise, dtypes too."""
    if dataclasses.is_dataclass(want):
        assert dataclasses.is_dataclass(got), path
        names = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == names, path
        for n in names:
            assert_same_tree(getattr(got, n), getattr(want, n), f"{path}.{n}")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}[{k}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same_tree(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_partition_matches_jax(n_parts):
    got, got_info = partition_hierarchy(synthetic_scene(**SCENE), n_parts)
    want, want_info = jax_partition_hierarchy(jax_scene(**SCENE), n_parts)
    assert_same_tree(got, want)
    assert_same_tree(got_info.new_id, want_info.new_id, "new_id")
    assert_same_tree(got_info.counts, want_info.counts, "counts")


@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_halo_plan_matches_jax(n_parts):
    """On a table with senders from every partition, pads at each row's own
    trash row as `_partition_ell` writes them."""
    rng = np.random.default_rng(n_parts)
    v_pad = 64 * n_parts
    nbr = rng.integers(0, v_pad, (v_pad, 5))
    nbr[rng.random(nbr.shape) < 0.2] = 0
    got = build_halo_plan(nbr, v_pad, n_parts)
    want = jax_build_halo_plan(nbr, v_pad, n_parts)
    assert got.halo_width == want.halo_width
    for a, b in ((got.send_idx, want.send_idx), (got.nbr_halo,
                                                  want.nbr_halo)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="do not divide"):
        build_halo_plan(nbr, v_pad - 1, n_parts)


@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_partition_layout_invariants(n_parts):
    """tests/test_sharded_stinet.py:38-59 on the port's layout."""
    scene = synthetic_scene(**SCENE)
    pg, info = partition_hierarchy(scene, n_parts)
    L = len(scene.num_vertices)
    for l in range(L):
        vp = pg.vp[l]
        nid = info.new_id[l]
        # bijective into per-part ranges, valid rows are per-shard prefixes
        assert len(np.unique(nid)) == len(nid) == scene.num_vertices[l]
        part_of = nid // vp
        rank = nid % vp
        for p in range(n_parts):
            c = int(info.counts[l][p])
            assert sorted(rank[part_of == p]) == list(range(c))
        vm = np.asarray(pg.levels[l].vmask)
        assert vm.sum() == scene.num_vertices[l]
        assert (vm[nid] == 1.0).all()
    # traces stay within the owner shard (local ids in range)
    for l in range(L - 1):
        tr = np.asarray(pg.traces[l])
        assert tr.min() >= 0 and tr.max() < pg.vp[l + 1]


def test_partition_refuses_what_the_layout_cannot_hold():
    scene = synthetic_scene(**SCENE)
    with pytest.raises(ValueError, match="max in-degree"):
        partition_hierarchy(scene, 2, max_degree=3)
    with pytest.raises(ValueError, match="children tables"):
        partition_hierarchy(scene, 2, max_children=2)


@pytest.mark.parametrize("n_parts", [1, 2, 4])
def test_halo_exchange_delivers_every_referenced_sender(n_parts):
    """On an in-process mesh, with q row i holding the partitioned-global
    id i, each partition's extended rows read through its local-plus-halo
    table give the global sender of every valid slot, as the partitioned
    ELL table before the halo rewrite (`_partition_ell`) holds it."""
    scene = synthetic_scene(**SCENE)
    pg, info = partition_hierarchy(scene, n_parts)
    mesh = InProcessMesh(n_parts, "cpu")
    for l, lv in enumerate(pg.levels):
        raw = {0: scene.level_edges[l], **scene.dilated.get(l, {})}
        for d, es in [(0, lv.edges), *lv.dilated.items()]:
            v_tot = es.degree.shape[0]
            vp = v_tot // n_parts
            e = np.asarray(raw[d], dtype=np.int64)
            nbr, _ = _partition_ell(info.new_id[l][e[0]], info.new_id[l][e[1]],
                                    v_tot, vp, n_parts, 96)
            q = torch.arange(v_tot, dtype=torch.float32)[:, None].repeat(1, 3)
            locs = [shard(es, p, n_parts) for p in range(n_parts)]
            ext = halo_exchange(
                [q[p * vp:(p + 1) * vp] for p in range(n_parts)],
                [torch.from_numpy(loc.send_idx[0]) for loc in locs], mesh)
            for p, (loc, x) in enumerate(zip(locs, ext)):
                got = x[torch.from_numpy(loc.nbr_halo).long()][..., 0]
                live = (np.arange(loc.nbr_halo.shape[1])[None, :]
                        < loc.degree[:, None])
                np.testing.assert_array_equal(
                    got.numpy()[live], nbr[p * vp:(p + 1) * vp][live])


# --- the partitioned forward against JAX's single-device forward ----------

@pytest.fixture(scope="module")
def weights():
    """The tiny model's seeded weights, and JAX's params of the same
    weights through JAX's own reference-checkpoint converter."""
    model = define_G(**TINY, generator=torch.Generator().manual_seed(1))
    sd = model.state_dict()
    params, _ = convert_stinet_state_dict(sd)
    return sd, params


def _jax_forward(params, dtype):
    model = jax_define_G(**TINY, dtype=dtype)
    graph = jax_build([jax_scene(**SCENE)])
    out = jax.jit(model.apply)({"params": params}, graph)
    return np.asarray(out, dtype=np.float32)[:SCENE["num_vertices"]]


@pytest.fixture(scope="module")
def jax_f32(weights):
    return _jax_forward(weights[1], "float32")


@pytest.mark.parametrize("n_parts", [2, 4])
def test_predict_partitioned_matches_jax(weights, jax_f32, n_parts):
    server = SceneInpainter(define_G(**TINY), weights[0], device="cpu",
                            mesh=make_mesh(n_parts, "cpu"))
    got = server.predict_partitioned(synthetic_scene(**SCENE))
    assert got.shape == jax_f32.shape == (SCENE["num_vertices"], 3)
    np.testing.assert_allclose(got, jax_f32, rtol=RTOL, atol=ATOL)
    # the mesh server's plain requests stay the plain server's
    plain = SceneInpainter(define_G(**TINY), weights[0], device="cpu")
    scene = synthetic_scene(**SCENE)
    np.testing.assert_array_equal(server.predict(scene), plain.predict(scene))


def test_predict_partitioned_bf16_matches_jax(weights):
    server = SceneInpainter(define_G(**TINY, dtype=torch.bfloat16),
                            weights[0], device="cpu",
                            mesh=make_mesh(2, "cpu"))
    got = server.predict_partitioned(synthetic_scene(**SCENE))
    want = _jax_forward(weights[1], "bfloat16")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)


def test_predict_partitioned_refusals(weights):
    scene = synthetic_scene(**SCENE)
    with pytest.raises(ValueError, match="requires mesh"):
        SceneInpainter(define_G(**TINY), weights[0],
                       device="cpu").predict_partitioned(scene)
    batch = define_G(**dict(TINY, norm="batch"))
    with pytest.raises(ValueError, match="instance norm only"):
        SceneInpainter(batch, batch.state_dict(), device="cpu",
                       mesh=make_mesh(2, "cpu")).predict_partitioned(scene)
    sage = define_G(**dict(TINY, filter_type="sageconv"))
    with pytest.raises(ValueError, match="EdgeConv filters only"):
        SceneInpainter(sage, sage.state_dict(), device="cpu",
                       mesh=make_mesh(2, "cpu")).predict_partitioned(scene)
    emb = define_G(**TINY, use_label_embedding=True, num_classes=4,
                   num_embedding=2)
    with pytest.raises(NotImplementedError, match="label embedding"):
        SceneInpainter(emb, emb.state_dict(), device="cpu",
                       mesh=make_mesh(2, "cpu")).predict_partitioned(scene)
    with pytest.raises(RuntimeError, match="initialised"):
        make_mesh(2, "cpu", processes=True)


def test_in_process_mesh_predict_batch_is_the_plain_servers(weights):
    scenes = [synthetic_scene(**dict(SCENE, seed=s)) for s in range(3)]
    mesh_server = SceneInpainter(define_G(**TINY), weights[0], device="cpu",
                                 mesh=make_mesh(2, "cpu"))
    plain = SceneInpainter(define_G(**TINY), weights[0], device="cpu")
    for stacked in (True, False):
        for a, b in zip(mesh_server.predict_batch(scenes, stacked=stacked),
                        plain.predict_batch(scenes, stacked=stacked)):
            np.testing.assert_array_equal(a, b)


def test_place_partitioned_cuts_equal_shards(weights):
    pg, _ = partition_hierarchy(synthetic_scene(**SCENE), 4)
    placed = place_partitioned(InProcessMesh(4, "cpu"), pg,
                               PackedPlacer(torch.device("cpu")))
    assert len(placed) == 4
    for p, g in enumerate(placed):
        assert isinstance(g, PartitionedGraph)
        assert g.x.shape[0] == pg.vp[0]
        assert g.levels[0].edges.send_idx.shape[0] == 1
        assert torch.equal(g.levels[1].edges.nbr_halo, torch.from_numpy(
            shard(pg, p, 4).levels[1].edges.nbr_halo))


# --- a gloo process mesh of 2 ranks ----------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo_rank(rank, world, port, out_dir):
    """One rank of the process mesh: predict_partitioned on the scene, and
    predict_batch over 3 scenes (a share a rank); rank 0 saves both."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        model = define_G(**TINY, generator=torch.Generator().manual_seed(1))
        server = SceneInpainter(model, model.state_dict(), device="cpu",
                                mesh=make_mesh(world, "cpu", processes=True))
        out = server.predict_partitioned(synthetic_scene(**SCENE))
        scenes = [synthetic_scene(**dict(SCENE, seed=s)) for s in range(3)]
        batch = server.predict_batch(scenes)
        if rank == 0:
            np.savez(os.path.join(out_dir, "rank0.npz"), out=out,
                     **{f"b{i}": b for i, b in enumerate(batch)})
        dist.barrier()
    finally:
        dist.destroy_process_group()


def test_gloo_process_mesh_equals_in_process_mesh(weights):
    world = 2
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.spawn(
            _gloo_rank, args=(world, _free_port(), tmp), nprocs=world,
            join=False)
        deadline = time.monotonic() + SPAWN_TIMEOUT
        try:
            while not ctx.join(timeout=5):
                assert time.monotonic() < deadline, "gloo ranks timed out"
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        got = dict(np.load(os.path.join(tmp, "rank0.npz")))
    scene = synthetic_scene(**SCENE)
    server = SceneInpainter(define_G(**TINY), weights[0], device="cpu",
                            mesh=make_mesh(world, "cpu"))
    np.testing.assert_array_equal(got["out"],
                                  server.predict_partitioned(scene))
    scenes = [synthetic_scene(**dict(SCENE, seed=s)) for s in range(3)]
    plain = SceneInpainter(define_G(**TINY), weights[0], device="cpu")
    for i, want in enumerate(plain.predict_batch(scenes)):
        np.testing.assert_array_equal(got[f"b{i}"], want)
