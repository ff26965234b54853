"""Tensor parallelism at a model axis of 2 in the port (stinet_tpu_torch/
parallel/tensor_parallel.py, the (data, model) grid of parallel/mesh.py:
ProcessMesh, `make_sharded_train_step` over it), on the CPU.

The flagship's filter at ngf 64 (2 blocks, 2 levels, so every EdgeConv's
hidden width 2H is 128 or more and its first linear splits) on a global
stacked batch of 2 scenes, from JAX's initial weights: 2 gloo ranks (data
1 x model 2) and 4 (data 2 x model 2) take one Adam(amsgrad) step, and
JAX's `make_sharded_train_step` takes it on the conftest's 8 virtual CPU
devices at `model_parallel=2` on the same scenes concatenated. Checked:

- the loss within rtol 1e-5 of JAX's, and the same on every rank;
- the gradients before Adam, made whole (`tensor_parallel.whole`), taken
  together as one vector: within 1e-4 of their L2 norm of the port's
  step in one process on the same batch (GRAD_TOL of tests/test_torch_
  sage.py; measured 3.1e-5: the split sums lin2's products and the
  input's gradient in another order, and this model amplifies f32
  rounding through its relu and max-pool routes), and no farther from
  JAX's than that one-process step is, plus 1e-4. The 1e-5 asked of JAX's
  gradients does not hold for the one-process step either: at ngf 64 its
  gradients are 8.6e-4 of their norm from JAX's here (2.5e-4 from JAX
  init key 1), against the 1e-4 those tests hold at narrower widths; the
  gap is the port's at any model axis, not tensor parallelism's, and it
  is open (ROADMAP.md, Queue 3);
- the whole weights after the step within JAX's own tolerance for its
  sharded step (tests/test_parallel.py: rtol 1e-2, atol 2.5e-3; Adam's
  first update is about lr * sign(gradient));
- every parameter a model rank does not split bitwise equal on the model
  ranks of a data index, the split ones' slices different.

The layout rules and the mesh's grid are checked in one process and under
4 ranks. JAX compiles: two (the sharded step and its gradient).
"""
import math
import types

import numpy as np
import pytest
import torch

from stinet_tpu_torch.graph.build import build_stacked_graph
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.parallel import tensor_parallel
from stinet_tpu_torch.parallel.data_parallel import make_sharded_train_step
from stinet_tpu_torch.parallel.mesh import make_mesh
from stinet_tpu_torch.parallel.multihost import make_global_mesh
from stinet_tpu_torch.trainers import graph_common as gc
from stinet_tpu_torch.utils.synthetic import synthetic_scene
from test_torch_multihost import run_gloo

ARCH = dict(input_nc=10, output_nc=3, ngf=64, n_blocks=2, dilations=[1, 2],
            norm="instance", pooling_type="max", n_levels=2,
            n_repeated_io_convs=1, filter_type="edgeconvtransinv")
ADAM = {"type": "Adam", "args": {"lr": 1e-3, "amsgrad": True}}
SCENES = ((0, 700), (1, 500))       # (seed, vertices) of the global batch
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _scenes():
    return [synthetic_scene(num_vertices=n, levels=3, seed=s,
                            dilation_dists=(2,)) for s, n in SCENES]


def _tp_rank(rank, world, model_parallel, start):
    """One Adam step of `make_sharded_train_step` on a grid of world /
    model_parallel data ranks by model_parallel model ranks, from the
    state dict `start`."""
    model = define_G(**ARCH)
    model.load_state_dict(start)
    opt, lr = gc.build_optimizer(model.parameters(), ADAM)
    mesh = make_global_mesh(model_parallel, device="cpu")
    step, place_state, place_graph, _ = make_sharded_train_step(
        model, opt, mesh, use_mask_weighted=True)
    place_state()
    stacked, _ = build_stacked_graph(_scenes(), pad_multiple=1024)
    local = place_graph(stacked)
    loss = float(step(local, lr)["loss"])
    grads = {k: p.grad for k, p in model.named_parameters()}
    sharded = [n for n, m in model.named_modules()
               if isinstance(m, tensor_parallel.TensorParallelEdgeConv)]
    return dict(
        loss=loss, data_rank=mesh.rank, model_rank=mesh.model_rank,
        scenes=int(local.x.shape[0]), sharded=sharded,
        hidden=[model.get_submodule(n).hidden for n in sharded],
        local={k: v.clone() for k, v in model.state_dict().items()},
        grads={k: v.clone() for k, v in
               tensor_parallel.whole(model, grads).items()},
        state={k: v.clone() for k, v in tensor_parallel.whole(
            model, model.state_dict()).items()})


@pytest.fixture(scope="module")
def jax_step():
    """JAX's sharded step at model_parallel=2 on the 8 virtual devices:
    (initial state dict, loss, gradients, weights after the step), the
    last two as port state dicts."""
    import jax
    import jax.numpy as jnp
    from stinet_tpu.graph import build_hierarchical_graph as jax_build
    from stinet_tpu.models.factory import define_G as jax_define_G
    from stinet_tpu.parallel.data_parallel import (
        make_sharded_train_step as jax_make_step)
    from stinet_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from stinet_tpu.trainers.graph_common import (
        build_optimizer as jax_optimizer, inpainting_loss)
    from stinet_tpu.utils.synthetic import synthetic_scene as jax_scene
    from stinet_tpu_torch.utils.convert import state_dict_from_jax_params

    graph = jax_build([jax_scene(num_vertices=n, levels=3, seed=s,
                                 dilation_dists=(2,)) for s, n in SCENES],
                      pad_multiple=1024)
    model = jax_define_G(**ARCH)
    params = jax.jit(model.init)(jax.random.key(0), graph)["params"]
    tx, lr = jax_optimizer(ADAM)
    start = state_dict_from_jax_params(params)
    mesh = jax_make_mesh(jax.device_count(), model_parallel=2)
    _, place_state, place_graph, jit_step = jax_make_step(
        model, tx, mesh, use_mask_weighted=True)
    sp, so, _, _ = place_state(jax.tree.map(jnp.copy, params),
                               tx.init(params))
    sg = place_graph(graph)

    def loss_fn(p, g):
        out = model.apply({"params": p}, g, train=True)
        return inpainting_loss(out, g.color, g.mask,
                               g.levels[0].vertex_mask(), True)[0]
    grads = jax.jit(jax.grad(loss_fn))(sp, sg)
    new_params, _, metrics = jit_step(sp, so)(sp, so, sg, jnp.float32(lr))
    return (start, float(np.asarray(metrics["loss"])),
            state_dict_from_jax_params(jax.device_get(grads)),
            state_dict_from_jax_params(jax.device_get(new_params)))


def _l2(tensors):
    return math.sqrt(sum(float(t.double().norm()) ** 2 for t in tensors))


@pytest.fixture(scope="module")
def one_process(jax_step):
    """The port's step in one process (no mesh) from JAX's weights on the
    same global batch: its gradients."""
    model = define_G(**ARCH)
    model.load_state_dict(jax_step[0])
    opt, lr = gc.build_optimizer(model.parameters(), ADAM)
    step, _, place_graph, _ = make_sharded_train_step(
        model, opt, None, use_mask_weighted=True)
    stacked, _ = build_stacked_graph(_scenes(), pad_multiple=1024)
    step(place_graph(stacked), lr)
    return {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("world", [2, 4], ids=["model2", "data2xmodel2"])
def test_step_matches_jax_at_model_axis_2(jax_step, one_process, world):
    start, want_loss, want_grads, want_state = jax_step
    norm = _l2(want_grads.values())
    gap = _l2(one_process[k] - g for k, g in want_grads.items())
    ranks = run_gloo(_tp_rank, world, 2, start)
    assert [(r["data_rank"], r["model_rank"]) for r in ranks] == [
        (d, m) for d in range(world // 2) for m in range(2)]
    # every EdgeConv filter of the model splits at ngf 64
    filters = [n for n, m in define_G(**ARCH).named_modules()
               if type(m) is tensor_parallel.EdgeConvFilter]
    for r in ranks:
        assert r["scenes"] == 2 // (world // 2)
        assert r["sharded"] == filters
        np.testing.assert_allclose(r["loss"], want_loss, rtol=1e-5)
        assert sorted(r["grads"]) == sorted(want_grads)
        assert _l2(r["grads"][k] - g for k, g in one_process.items()) \
            <= GRAD_TOL * _l2(one_process.values())
        assert _l2(r["grads"][k] - g for k, g in want_grads.items()) \
            <= gap + GRAD_TOL * norm
        for k, v in want_state.items():
            np.testing.assert_allclose(r["state"][k].numpy(), v.numpy(),
                                       rtol=1e-2, atol=2.5e-3, err_msg=k)
    for a, b in zip(ranks[0::2], ranks[1::2]):
        assert a["data_rank"] == b["data_rank"] and a["loss"] == b["loss"]
        sliced = {f"{n}.{k}" for n in a["sharded"]
                  for k, _ in tensor_parallel._SLICED}
        assert a["hidden"] != b["hidden"]
        for k, v in a["local"].items():
            if k in sliced:
                assert v.shape == b["local"][k].shape
                assert not torch.equal(v, b["local"][k]), k
            else:
                assert torch.equal(v, b["local"][k]), k


def _grid_rank(rank, world):
    mesh = make_mesh(2, "cpu", processes=True, model_parallel=2)
    t = torch.full((1,), float(rank + 1))
    mesh.all_reduce_(t)
    m = torch.full((1,), float(rank + 1))
    mesh.model_all_reduce_(m)
    b = torch.full((1,), float(rank))
    mesh.broadcast_(b, 1)
    return dict(rank=mesh.rank, model_rank=mesh.model_rank,
                n_parts=mesh.n_parts, data_sum=float(t), model_sum=float(m),
                broadcast=float(b),
                objects=mesh.all_gather_object(rank))


def test_grid_groups_follow_jax_reshape():
    """4 ranks at a model axis of 2: rank r is data r // 2, model r % 2;
    the data collectives run among one model index, the model sum among
    one data index."""
    got = run_gloo(_grid_rank, 4)
    assert [(g["rank"], g["model_rank"], g["n_parts"]) for g in got] == [
        (0, 0, 2), (0, 1, 2), (1, 0, 2), (1, 1, 2)]
    assert [g["data_sum"] for g in got] == [4.0, 6.0, 4.0, 6.0]
    assert [g["model_sum"] for g in got] == [3.0, 3.0, 7.0, 7.0]
    assert [g["broadcast"] for g in got] == [2.0, 3.0, 2.0, 3.0]
    assert [g["objects"] for g in got] == [[0, 2], [1, 3], [0, 2], [1, 3]]


def test_one_process_has_no_model_axis():
    """An in-process mesh takes no model axis, and at a model axis of 1
    shard_model leaves a model whole."""
    with pytest.raises(ValueError, match="process mesh"):
        make_mesh(2, "cpu", model_parallel=2)
    model = define_G(**ARCH)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grid = types.SimpleNamespace(_dist=None, model_parallel=1, model_rank=0)
    assert tensor_parallel.shard_model(model, grid) == []
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not any(isinstance(m, tensor_parallel.TensorParallelEdgeConv)
                   for m in model.modules())
