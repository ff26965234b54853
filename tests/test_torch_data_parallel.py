"""Data-parallel training across processes in the port (stinet_tpu_torch/
parallel/data_parallel.py, the stacked steps with a data mesh in
trainers/graph_common.py, the loader's per-rank slice in data/scannet.py),
on the CPU.

- The stacked 3D trainer under 2 gloo ranks (global B = 2, one scene a
  rank, accumulation 2, SGD with momentum as JAX's
  tests/_mp_stacked_driver.py, 2 epochs) against one process on the same
  global batches: the two ranks sum the gradients, n and the metrics in
  another order than one process accumulates them, so the epoch losses
  agree within rtol 1e-5 (JAX's stacked bound) and the weights within
  rtol 1e-4, atol 1e-6 (tests/test_torch_stacked.py's); both ranks end
  on the same weights bitwise, and each rank's batches hold its one scene.
- `make_sharded_train_step` over 2 ranks (`place_graph` cuts the rank's
  scene of a global stacked batch) against one process: loss within rtol
  1e-6, weights after one SGD step within rtol 1e-5, atol 1e-7; a
  concatenated batch raises NotImplementedError on both ranks.
- The port's step against JAX's `data_parallel.make_sharded_train_step`
  on its 8-device CPU mesh, from JAX's initial weights converted: the loss
  within rtol 1e-5, the weights after one Adam(amsgrad) step within JAX's
  own tolerance for its sharded step (rtol 1e-2, atol 2.5e-3: at Adam's
  first step an element whose gradient lies within rounding of 0 moves by
  about lr either way; tests/test_parallel.py:66-69).
- Rank 0 and rank 1 of 2 (the process index and count patched in both
  packages): the ScanNet loader's stacked batches equal JAX's local
  batches leaf for leaf, the val set's tail repeat included.
- One process asked for `n_gpu` 2 gets no mesh and a warning naming
  torchrun.

JAX compiles: one (the sharded train step).
"""
import copy
import logging

import numpy as np
import pytest
import torch

from stinet_tpu_torch.core.config import ConfigParser
from stinet_tpu_torch.data.scannet import (
    SCANNET_TRAIN_FILE, SCANNET_VAL_FILE, read_split)
from stinet_tpu_torch.graph.build import (
    build_hierarchical_graph, build_stacked_graph)
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.parallel.data_parallel import make_sharded_train_step
from stinet_tpu_torch.parallel.mesh import ProcessMesh
from stinet_tpu_torch.trainers import graph_common as gc
from stinet_tpu_torch.trainers.inpainting3d import Inpainting3DTrainer
from stinet_tpu_torch.utils.synthetic import synthetic_scene
from test_torch_multihost import run_gloo
from test_train_e2e import make_3d_config, write_fake_scene

TINY = dict(input_nc=10, output_nc=3, ngf=8, n_blocks=2, dilations=[1, 2],
            norm="instance", pooling_type="max", n_levels=2,
            n_repeated_io_convs=1, filter_type="edgeconvtransinv")
SGD = {"type": "SGD", "args": {"lr": 1e-2, "momentum": 0.9}}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("scenes")
    rng = np.random.default_rng(0)
    out = {}
    for split, names in (("train", read_split(SCANNET_TRAIN_FILE)[:4]),
                         ("val", read_split(SCANNET_VAL_FILE)[:2])):
        out[split] = str(base / split)
        for name in names:
            write_fake_scene(out[split], name, rng)
    return out


def _config(tmp, roots):
    cfg = make_3d_config(tmp, roots["train"], roots["val"])
    cfg["data_loader"]["args"].update(train_batch_size=2, test_batch_size=2,
                                      stacked_batching=True)
    cfg["trainer"]["epochs"] = 2
    cfg["optimizer"] = copy.deepcopy(SGD)
    return cfg


def _trainer_run(cfg):
    trainer = Inpainting3DTrainer(ConfigParser(cfg, dry_run=True),
                                  device="cpu")
    seen = []
    step = trainer._train_step

    def recorded(graph, lr):
        seen.append(int(graph.x.shape[0]))
        return step(graph, lr)

    trainer._train_step = recorded
    logs = []
    for epoch in (1, 2):
        logs.append(trainer._train_epoch(epoch))
    return {"logs": logs, "seen": seen,
            "state": {k: v.clone() for k, v in
                      trainer.model.state_dict().items()},
            "mesh": None if trainer._mesh is None else trainer._mesh.n_parts}


def _scenes():
    return [synthetic_scene(num_vertices=n, levels=3, seed=s,
                            dilation_dists=(2,))
            for s, n in ((0, 700), (1, 500))]


def _dp_step(mesh):
    """One SGD step of make_sharded_train_step on the global stacked batch
    of `_scenes()`: (loss, state dict after)."""
    model = define_G(**TINY, generator=torch.Generator().manual_seed(3))
    opt, lr = gc.build_optimizer(model.parameters(),
                                 {"type": "SGD", "args": {"lr": 0.1}})
    step, place_state, place_graph, jit_step = make_sharded_train_step(
        model, opt, mesh, use_mask_weighted=True)
    assert jit_step() is step
    place_state()
    graph, _ = build_stacked_graph(_scenes(), pad_multiple=128)
    local = place_graph(graph)
    metrics = step(local, lr)
    return (float(metrics["loss"]), int(local.x.shape[0]),
            {k: v.clone() for k, v in model.state_dict().items()})


def _dp_rank(rank, world, cfg):
    out = {"trainer": _trainer_run(cfg)}
    mesh = ProcessMesh("cpu")
    out["dp"] = _dp_step(mesh)
    try:
        gc.place_graph_on_mesh(mesh, build_hierarchical_graph(_scenes()))
        out["concatenated"] = None
    except NotImplementedError as e:
        out["concatenated"] = str(e)
    return out


def test_two_gloo_ranks_follow_one_process(tmp_path, roots):
    cfg = _config(tmp_path, roots)
    ranks = run_gloo(_dp_rank, 2, copy.deepcopy(cfg))
    want = _trainer_run(copy.deepcopy(cfg))
    assert want["mesh"] is None and want["seen"] == [2] * 4
    for r in ranks:
        got = r["trainer"]
        assert got["mesh"] == 2 and got["seen"] == [1] * 4
        for g, w in zip(got["logs"], want["logs"]):
            for k in ("loss", "val_loss", "l1", "val_psnr"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                           err_msg=k)
        for k, v in want["state"].items():
            np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        assert "single-process only" in r["concatenated"]
    for k, v in ranks[0]["trainer"]["state"].items():
        assert torch.equal(v, ranks[1]["trainer"]["state"][k]), k
    assert not torch.equal(want["state"]["final_linear2.weight"],
                           Inpainting3DTrainer(
                               ConfigParser(copy.deepcopy(cfg),
                                            dry_run=True),
                               device="cpu").model.final_linear2.weight)

    loss, rows, state = _dp_step(None)
    assert rows == 2
    for r in ranks:
        g_loss, g_rows, g_state = r["dp"]
        assert g_rows == 1
        np.testing.assert_allclose(g_loss, loss, rtol=1e-6)
        for k, v in state.items():
            np.testing.assert_allclose(g_state[k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_step_matches_jax_sharded_step():
    import jax
    import jax.numpy as jnp
    from stinet_tpu.graph import build_hierarchical_graph as jax_build
    from stinet_tpu.models.factory import define_G as jax_define_G
    from stinet_tpu.parallel.data_parallel import (
        make_sharded_train_step as jax_step)
    from stinet_tpu.parallel.mesh import make_mesh
    from stinet_tpu.trainers.graph_common import (
        build_optimizer as jax_optimizer)
    from stinet_tpu.utils.synthetic import synthetic_scene as jax_scene
    from stinet_tpu_torch.utils.convert import state_dict_from_jax_params

    kw = dict(num_vertices=1024, levels=3, seed=0, dilation_dists=(2,))
    graph = jax_build([jax_scene(**kw)], pad_multiple=1024)
    model = jax_define_G(**dict(TINY, ngf=16))
    params = model.init(jax.random.key(0), graph)["params"]
    cfg = {"type": "Adam", "args": {"lr": 1e-3, "amsgrad": True}}
    tx, lr = jax_optimizer(cfg)
    start = state_dict_from_jax_params(params)

    mesh = make_mesh(jax.device_count())
    _, place_state, place_graph, jit_step = jax_step(
        model, tx, mesh, use_mask_weighted=True)
    sp, so, _, _ = place_state(jax.tree.map(jnp.copy, params),
                               tx.init(params))
    new_params, _, metrics = jit_step(sp, so)(sp, so, place_graph(graph),
                                              jnp.float32(lr))
    want = state_dict_from_jax_params(jax.device_get(new_params))

    port = define_G(**dict(TINY, ngf=16))
    port.load_state_dict(start)
    opt, port_lr = gc.build_optimizer(port.parameters(), cfg)
    step, place_state, place_graph, _ = make_sharded_train_step(
        port, opt, None, use_mask_weighted=True)
    place_state()
    stacked, _ = build_stacked_graph([synthetic_scene(**kw)],
                                     pad_multiple=1024)
    got = step(place_graph(stacked), port_lr)
    np.testing.assert_allclose(float(got["loss"]),
                               float(np.asarray(metrics["loss"])),
                               rtol=1e-5)
    new = port.state_dict()
    assert sorted(new) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(new[k].numpy(), v.numpy(), rtol=1e-2,
                                   atol=2.5e-3, err_msg=k)


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_batches_are_jax_local_batches(tmp_path, roots, monkeypatch,
                                           rank):
    """Rank `rank` of 2 (both packages' process index and count patched,
    the width merge the identity, as with equal datasets): the ScanNet
    loader forces the stacked layout, and two epochs of its train batches
    (global 2: one scene a rank) and val batches (global 4 over 2 scenes:
    the tail repeated, two a rank) equal JAX's local batches leaf for leaf,
    with the same names."""
    from stinet_tpu.data import scannet as jax_scannet
    from stinet_tpu.parallel import multihost as jax_multihost
    from stinet_tpu_torch.data import scannet as port_scannet
    from stinet_tpu_torch.parallel import multihost
    from test_torch_graph import assert_same_tree
    for mod in (jax_multihost, multihost):
        monkeypatch.setattr(mod, "process_index", lambda: rank)
        monkeypatch.setattr(mod, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "merge_widths_across_hosts", dict)
    args = make_3d_config(tmp_path, roots["train"], roots["val"])[
        "data_loader"]["args"]
    args.update(train_batch_size=2, test_batch_size=4)
    want = jax_scannet.ScanNetGraphColorDataLoader(copy.deepcopy(args),
                                                   seed=5)
    got = port_scannet.ScanNetGraphColorDataLoader(copy.deepcopy(args),
                                                   seed=5)
    assert got.stacked and want.stacked
    for _ in range(2):
        for name, local in (("train_loader", 1), ("val_loader", 2)):
            pairs = list(zip(getattr(got, name), getattr(want, name),
                             strict=True))
            assert len(pairs) == (2 if name == "train_loader" else 1)
            for (pg, pnames), (jg, jnames) in pairs:
                assert pnames == jnames and len(pnames) == local
                assert_same_tree(pg, jg)


def test_one_process_asked_for_cards_gets_no_mesh(caplog):
    logger = logging.getLogger("test_torch_data_parallel")
    with caplog.at_level(logging.WARNING, logger=logger.name):
        assert gc.maybe_data_mesh({"n_gpu": 2}, "cpu", logger) is None
    assert "torch.distributed.run" in caplog.text
    assert gc.maybe_data_mesh({"n_gpu": 1}, "cpu", logger) is None
    g = build_hierarchical_graph(_scenes())
    assert gc.place_graph_on_mesh(None, g, "cpu") is not None
    assert gc.place_stacked(None, build_stacked_graph(_scenes())[0],
                            "cpu").x.shape[0] == 2
