"""Partitioned (halo) training in the port (stinet_tpu_torch/parallel/
sharded_stinet.py:make_sharded_train_step, the backward of parallel/
halo.py and of the meshes' collectives, K1's dp and dq on ragged rows in
ops/ell.py), on the CPU.

- The plain dp and dq on ragged rows (q of Vp + S*W rows, more than p and
  g) are bitwise the VJP of JAX's ops/ell.py:ell_edge_conv_sum, in f32 and
  bf16 at several halo widths, and the kernels' wrappers take that layout
  (their row checks; the kernels themselves run in tests/test_torch_cuda.py).
- The halo exchange's backward is the transpose of its gathers: the
  gradient of q through every partition's extended rows equals the
  gradient through the global table (within rtol 1e-6: the scatter-adds
  sum in another order), pad slots adding nothing.
- On the in-process mesh at P = 1, 2 and 4, the loss and every gradient
  against JAX's single-device `value_and_grad` of the same model (weights
  carried by JAX's reference converter) on the hostile terrain: loss
  within rtol 1e-5, gradients within rtol 5e-4, atol 2e-4 (JAX's own
  tolerances for its sharded backward, tests/test_sharded_stinet.py:98-107).
- 2 gloo ranks (a process mesh) give the in-process mesh's loss bitwise
  and its gradients and one SGD step within rtol 1e-6, atol 1e-9 (both
  sum the same two partitions' shares, in another association).

JAX compiles: the forward and backward of the f32 model, and one ELL VJP a
dtype.
"""
import numpy as np
import pytest
import torch

from stinet_tpu_torch.graph.partition import (
    _partition_ell, partition_hierarchy, shard)
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.ops import ell
from stinet_tpu_torch.parallel.halo import halo_exchange
from stinet_tpu_torch.parallel.mesh import InProcessMesh, make_mesh
from stinet_tpu_torch.parallel.sharded_stinet import (
    make_sharded_train_step, place_partitioned)
from stinet_tpu_torch.serving import PackedPlacer
from stinet_tpu_torch.utils.hostile import hostile_scene
from test_torch_multihost import run_gloo

TINY = dict(input_nc=10, output_nc=3, ngf=8, n_blocks=3, dilations=[1, 2, 4],
            norm="instance", pooling_type="max", n_levels=2,
            n_repeated_io_convs=1, filter_type="edgeconvtransinv")
TERRAIN = dict(num_vertices=3000, kind="terrain", seed=0)
RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 5e-4, 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ragged(rng, vp, halo, h, d, dtype):
    """p, g [vp, h]; q [vp + halo, h]; nbr [vp, d] over q's rows; its
    reverse tables over q's rows (pads at receiver 0)."""
    vq = vp + halo
    p = rng.normal(size=(vp, h)).astype(np.float32)
    q = rng.normal(size=(vq, h)).astype(np.float32)
    g = rng.normal(size=(vp, h)).astype(np.float32)
    nbr = rng.integers(0, vq, size=(vp, d)).astype(np.int32)
    deg = rng.integers(0, d + 1, size=vp)
    rev = [[] for _ in range(vq)]
    for v in range(vp):
        for s in nbr[v, :deg[v]]:
            rev[s].append(v)
    dr = max(1, max(len(r) for r in rev))
    rev_dst = np.zeros((vq, dr), np.int32)
    for s, r in enumerate(rev):
        rev_dst[s, :len(r)] = r
    out_deg = np.asarray([len(r) for r in rev], np.float32)
    cast = (lambda a: torch.from_numpy(a).to(dtype))
    return (cast(p), cast(q), torch.from_numpy(nbr),
            torch.from_numpy(deg.astype(np.float32)), torch.from_numpy(rev_dst),
            torch.from_numpy(out_deg), cast(g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("halo", [1, 37, 300])
def test_dp_dq_on_ragged_rows_are_jax_vjp(dtype, halo, monkeypatch):
    import jax
    import jax.numpy as jnp
    from stinet_tpu.ops.ell import ell_edge_conv_sum as jax_sum
    rng = np.random.default_rng(halo)
    p, q, nbr, deg, rev, out_deg, g = _ragged(rng, 200, halo, 24, 6, dtype)
    dp = ell.ell_edge_conv_dp_plain(p, q, nbr, deg, g)
    dq = ell.ell_edge_conv_dq_plain(q, g, p, rev, out_deg)
    assert dp.shape == p.shape and dq.shape == q.shape
    jt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(jt)

    tables = [jnp.asarray(t.numpy()) for t in (nbr, rev, deg, out_deg)]
    _, vjp = jax.vjp(lambda a, b: jax_sum(a, b, *tables), j(p), j(q))
    want_dp, want_dq = vjp(j(g))
    for got, want in ((dp, want_dp), (dq, want_dq)):
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the kernels' wrappers take the layout and refuse other ragged rows
    # (their shape checks; the device check is the card's, and passes here)
    monkeypatch.setattr(ell._cuda, "check_tensor", lambda *a: None)
    ell._check_rows(("p", "q", "g"), (p, q, g), p.device, ragged=("q",))
    ell._check_rows(("q", "g", "p"), (q, g, p), q.device, ragged=("q",))
    with pytest.raises(ValueError):
        ell._check_rows(("p", "q", "g"), (p, q, g[1:]), p.device,
                        ragged=("q",))
    with pytest.raises(ValueError):
        ell._check_rows(("p", "q", "g"), (p, q[:, 1:], g), p.device,
                        ragged=("q",))
    with pytest.raises(ValueError):
        ell._check_rows(("p", "q", "g"), (p, q, g), p.device)


@pytest.fixture(scope="module")
def terrain():
    return hostile_scene(**TERRAIN)


@pytest.mark.parametrize("n_parts", [2, 4])
def test_halo_exchange_backward_is_the_transpose(terrain, n_parts):
    pg, info = partition_hierarchy(terrain, n_parts)
    mesh = InProcessMesh(n_parts, "cpu")
    es = pg.levels[0].edges
    v_tot = es.degree.shape[0]
    vp = v_tot // n_parts
    e = np.asarray(terrain.level_edges[0], dtype=np.int64)
    nbr, _ = _partition_ell(info.new_id[0][e[0]], info.new_id[0][e[1]],
                            v_tot, vp, n_parts, 96)
    rng = np.random.default_rng(n_parts)
    q = torch.from_numpy(rng.normal(size=(v_tot, 5)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(v_tot, nbr.shape[1], 5))
                         .astype(np.float32))
    live = torch.from_numpy(np.arange(nbr.shape[1])[None, :]
                            < es.degree[:, None])[..., None]
    q1 = q.clone().requires_grad_()
    locs = [shard(es, p, n_parts) for p in range(n_parts)]
    ext = halo_exchange([q1[p * vp:(p + 1) * vp] for p in range(n_parts)],
                        [torch.from_numpy(loc.send_idx[0]) for loc in locs],
                        mesh)
    loss = sum((x[torch.from_numpy(loc.nbr_halo).long()]
                * c[p * vp:(p + 1) * vp] * live[p * vp:(p + 1) * vp]).sum()
               for p, (loc, x) in enumerate(zip(locs, ext)))
    loss.backward()
    q2 = q.clone().requires_grad_()
    (q2[torch.from_numpy(nbr).long()] * c * live).sum().backward()
    np.testing.assert_allclose(q1.grad.numpy(), q2.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture(scope="module")
def jax_value_and_grad(terrain):
    """JAX's single-device loss and gradients (port layout) of the tiny
    model on the terrain, from the port's seeded weights."""
    import jax
    from stinet_tpu.graph.build import build_hierarchical_graph as jax_build
    from stinet_tpu.models.factory import define_G as jax_define_G
    from stinet_tpu.trainers.graph_common import inpainting_loss
    from stinet_tpu.utils.convert_reference_checkpoint import (
        convert_stinet_state_dict)
    from stinet_tpu.utils.hostile import hostile_scene as jax_hostile
    from stinet_tpu_torch.utils.convert import state_dict_from_jax_params
    params, _ = convert_stinet_state_dict(_model().state_dict())
    model = jax_define_G(**TINY)
    g = jax_build([jax_hostile(**TERRAIN)])

    def loss_fn(p):
        out = model.apply({"params": p}, g)
        return inpainting_loss(out, g.color, g.mask,
                               g.levels[0].vertex_mask(), True)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), state_dict_from_jax_params(jax.device_get(grads))


def _model():
    return define_G(**TINY, generator=torch.Generator().manual_seed(1))


def _grads(mesh, scene, lr=0.0):
    """(loss, {name: grad}, state after one SGD step at lr) of the
    partitioned step on `mesh`."""
    model = _model()
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    step, loss_fn = make_sharded_train_step(mesh, model, opt)
    pg, _ = partition_hierarchy(scene, mesh.n_parts)
    graphs = place_partitioned(mesh, pg, PackedPlacer(torch.device("cpu")))
    loss = step(graphs, 0.5)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return loss, grads, {k: v.clone() for k, v in
                         model.state_dict().items()}


@pytest.mark.parametrize("n_parts", [1, 2, 4])
def test_in_process_mesh_matches_jax_value_and_grad(terrain,
                                                    jax_value_and_grad,
                                                    n_parts):
    want_loss, want = jax_value_and_grad
    loss, grads, _ = _grads(make_mesh(n_parts, "cpu"), terrain)
    np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL)
    assert sorted(grads) == sorted(k for k in want if k in grads)
    assert len(grads) == len([k for k in want
                              if not k.endswith(("running_mean",
                                                 "running_var",
                                                 "num_batches_tracked"))])
    for k, v in grads.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def _gloo_rank(rank, world):
    from stinet_tpu_torch.parallel.mesh import ProcessMesh
    return _grads(ProcessMesh("cpu"), hostile_scene(**TERRAIN), lr=0.1)


def test_gloo_process_mesh_equals_in_process_mesh(terrain):
    ranks = run_gloo(_gloo_rank, 2)
    loss, grads, state = _grads(make_mesh(2, "cpu"), terrain, lr=0.1)
    for r_loss, r_grads, r_state in ranks:
        assert torch.equal(r_loss, loss)
        for k, v in grads.items():
            np.testing.assert_allclose(r_grads[k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
        for k, v in state.items():
            np.testing.assert_allclose(r_state[k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
    for k, v in ranks[0][2].items():
        assert torch.equal(v, ranks[1][2][k]), k
