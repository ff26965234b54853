"""The port's texture-map optimization
(stinet_tpu_torch/preprocessing/texture_optimization.py) against the JAX
package's on the CPU, on the scene of tests/test_texture_optimization.py: a
colored plane seen by four cameras, frames splatted from a denser copy."""
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stinet_tpu.preprocessing import (  # noqa: E402
    texture_optimization as jax_tex)
from stinet_tpu_torch.preprocessing import (  # noqa: E402
    texture_optimization as port_tex)
from test_texture_optimization import (  # noqa: E402
    H, INTR, W, _grid_mesh, _render, _scene)

COLOR_TOL = 1e-5        # estimated colors, port against JAX (absolute)
GRAD_TOL = 1e-4         # the residual's gradient, relative to its norm
RESIDUAL_RTOL = 1e-4    # rigid_optimize's residual history
DELTA_TOL = 1e-6        # rigid_optimize's deltas after ITERS steps: LR / 100
ITERS, LR = 10, 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """torch's intra-op pool at one thread (under xdist the workers' default
    pools oversubscribe the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _noisy_scene():
    """The scene with pose noise on frames 1..3 (frame 0 is the anchor)."""
    verts, true_cols, poses, colors, depths = _scene()
    rng = np.random.default_rng(0)
    noisy = poses.copy()
    for i in range(1, len(poses)):
        dr = rng.normal(0, 0.03, 3)
        kx = np.array([[0, -dr[2], dr[1]], [dr[2], 0, -dr[0]],
                       [-dr[1], dr[0], 0]])
        noisy[i, :3, :3] = (np.eye(3) + kx) @ noisy[i, :3, :3]
        noisy[i, :3, 3] += rng.normal(0, 0.03, 3)
    return verts, noisy, colors, depths


def _deltas(f, seed=3):
    return np.random.default_rng(seed).normal(0, 0.01, (f, 6)).astype(
        np.float32)


@pytest.mark.parametrize("moved", [False, True])
def test_estimate_vertex_colors_equals_jax(moved):
    verts, poses, colors, depths = _noisy_scene()
    deltas = (_deltas(len(poses)) if moved
              else np.zeros((len(poses), 6), np.float32))
    got, gw = port_tex.estimate_vertex_colors(
        *port_tex._tensors("cpu", verts, poses, deltas), INTR,
        *port_tex._tensors("cpu", colors, depths), W, H)
    want, ww = jax_tex.estimate_vertex_colors(
        jnp.asarray(verts), jnp.asarray(poses), jnp.asarray(deltas), INTR,
        jnp.asarray(colors), jnp.asarray(depths), W, H)
    assert gw.shape == (len(poses), len(verts))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
    assert gw.sum() > 0.5 * gw.numel()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=COLOR_TOL)


def _jax_residual(verts, poses, intr, colors, depths, c_est):
    """rigid_optimize's residual as the JAX package writes it (c_est a
    constant of the differentiation)."""
    def residual(deltas):
        def one(pose, delta, color, depth):
            col, w = jax_tex._frame_samples(verts, pose, delta, intr, color,
                                            depth, W, H)
            return jnp.sum(w[:, None] * (col - c_est) ** 2), jnp.sum(w)
        r, w = jax.vmap(one)(poses, deltas, colors, depths)
        return jnp.sum(r) / jnp.maximum(jnp.sum(w), 1e-6)
    return residual


def test_residual_gradient_equals_jax():
    """The gradient of the first rigid step (c_est detached, frame 0
    masked) against jax.grad of the JAX package's residual."""
    verts, poses, colors, depths = _noisy_scene()
    step, deltas = port_tex.make_rigid_step(verts, poses, INTR, colors,
                                            depths, W, H, lr=LR)
    loss = float(step())
    got = deltas.grad.numpy()

    j = [jnp.asarray(a) for a in (verts, poses, colors, depths)]
    zero = jnp.zeros((len(poses), 6), jnp.float32)
    c_est, _ = jax_tex.estimate_vertex_colors(j[0], j[1], zero, INTR, j[2],
                                              j[3], W, H)
    residual = _jax_residual(j[0], j[1], INTR, j[2], j[3], c_est)
    want_loss, want = jax.value_and_grad(residual)(zero)
    want = np.asarray(want) * (np.arange(len(poses)) > 0)[:, None]
    assert np.abs(loss - float(want_loss)) <= RESIDUAL_RTOL * abs(loss)
    assert not got[0].any()
    assert np.linalg.norm(want) > 0
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= GRAD_TOL, err


def test_rigid_optimize_equals_jax():
    """ITERS steps at lr 1e-4 (Adam's first steps move each delta by about
    lr x sign(g), so a larger rate magnifies rounding into sign flips):
    the residual history within RESIDUAL_RTOL, the deltas within
    DELTA_TOL, the final colors within COLOR_TOL."""
    verts, poses, colors, depths = _noisy_scene()
    got = port_tex.rigid_optimize(verts, poses, INTR, colors, depths, W, H,
                                  iters=ITERS, lr=LR)
    want = jax_tex.rigid_optimize(verts, poses, INTR, colors, depths, W, H,
                                  iters=ITERS, lr=LR)
    np.testing.assert_allclose(got[2], want[2], rtol=RESIDUAL_RTOL)
    assert got[2][-1] < got[2][0]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=DELTA_TOL)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=COLOR_TOL)
    assert np.abs(got[1][1:]).max() > 0.5 * LR


def test_anchor_frame_delta_is_exactly_zero():
    verts, poses, colors, depths = _noisy_scene()
    _, deltas, _ = port_tex.rigid_optimize(verts, poses, INTR, colors,
                                           depths, W, H, iters=5, lr=1e-3)
    assert (deltas[0] == 0).all()
    assert (deltas[1:] != 0).any()
    _, free, _ = port_tex.rigid_optimize(verts, poses, INTR, colors, depths,
                                         W, H, iters=2, lr=1e-3,
                                         anchor_first=False)
    assert (free[0] != 0).any()


def _sensor_dir(root, scene="scene0000_00"):
    """A ScanNet sensor directory of the test scene: color/<i>.jpg,
    depth/<i>.png in mm, pose/<i>.txt camera-to-world, the intrinsics and
    the mesh."""
    from PIL import Image
    from stinet_tpu_torch.preprocessing.plyio import write_ply
    dense_v, dense_c = _grid_mesh(48)
    verts, _, poses, _, _ = _scene()
    for d in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(os.path.join(root, d))
    k = np.eye(4)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = INTR
    np.savetxt(os.path.join(root, "intrinsic", "intrinsic_color.txt"), k)
    for i, pose in enumerate(poses):
        color, depth = _render(dense_v, dense_c, pose)
        Image.fromarray((color * 255).astype(np.uint8)).save(
            os.path.join(root, "color", f"{i}.jpg"), quality=95)
        Image.fromarray((depth * 1000).astype(np.uint16)).save(
            os.path.join(root, "depth", f"{i}.png"))
        np.savetxt(os.path.join(root, "pose", f"{i}.txt"),
                   np.linalg.inv(pose))
    faces = np.array([[0, 1, 12], [1, 13, 12]])
    write_ply(os.path.join(root, f"{scene}_vh_clean_2.ply"), verts, faces)
    return ["--path", str(root), "--scene", scene, "--stride", "1",
            "--height", str(H), "--width", str(W)]


@pytest.mark.parametrize("iters", [0, 3])
def test_main_on_the_cpu_writes_what_jax_writes(tmp_path, monkeypatch,
                                                iters):
    """The same ply, colors included: equal at 0 iterations, within one
    step of 255 after 3 rigid iterations."""
    import sys
    from stinet_tpu.preprocessing.plyio import read_ply
    argv = _sensor_dir(tmp_path) + ["--rigid-iters", str(iters)]
    port_tex.main(argv + ["-d", "cpu", "--out", "port.ply"])
    monkeypatch.setattr(sys, "argv", ["texture_optimization"])
    jax_tex.main(argv + ["--out", "jax.ply"])
    got = read_ply(str(tmp_path / "port.ply"))
    want = read_ply(str(tmp_path / "jax.ply"))
    np.testing.assert_array_equal(got["vertices"], want["vertices"])
    np.testing.assert_array_equal(got["faces"], want["faces"])
    assert got["colors"].max() > 0
    if iters == 0:
        np.testing.assert_array_equal(got["colors"], want["colors"])
    else:
        assert np.abs(got["colors"] - want["colors"]).max() <= 1 / 255 + 1e-9


def test_main_without_a_device_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_tex.main(["--path", str(tmp_path), "--scene", "s"])
