"""The port's loader of the reference's own `.pth` checkpoints
(utils/convert_reference_checkpoint.py `load_reference_state_dict`) on the
reference-format scene and checkpoint that tests/test_reference_parity_psnr
.py fabricates (its writers, its CFG, its seed: the `rng` fixture), on the
CPU:

- both layouts the reference saves (`state_dicts[model_key]` and
  `state_dict`) load one to one with `strict=True`, and the port's model
  on the reference scene is within +-0.1 dB PSNR and 5e-3 max |diff| of
  the literal f64 reference forward (`torch_reference_forward`), the JAX
  test's bounds, and within 1e-5 of the JAX model on the JAX converter's
  parameters (the frameworks sum in other orders);
- `SceneInpainter(model, state_dict)` serves the loaded weights;
- a state dict with a key missing, or with an extra one, is refused.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stinet_tpu.graph.build import RawHierarchy as JaxRawHierarchy
from stinet_tpu.graph.build import build_hierarchical_graph as jax_build
from stinet_tpu.models.stinet import SurfaceTextureInpaintingNet as JaxNet
from stinet_tpu.utils.convert_reference_checkpoint import (
    convert_stinet_state_dict)
from stinet_tpu_torch.data.scannet import load_scene_pt
from stinet_tpu_torch.graph.build import (
    RawHierarchy, build_hierarchical_graph)
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.serving import SceneInpainter
from stinet_tpu_torch.utils.convert_reference_checkpoint import (
    load_reference_state_dict)
from test_reference_parity_psnr import (
    CFG, make_reference_checkpoint, psnr, torch_reference_forward,
    write_reference_pt)

JAX_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _reference_case(tmp_path, rng, layout):
    """The JAX test's scene and checkpoint, drawn in its order from `rng`:
    (scene arrays, RawHierarchy kwargs, state dict, checkpoint path)."""
    pt_path = str(tmp_path / "scene0000_00.pt")
    write_reference_pt(pt_path, rng)
    vertices, edges, traces, dilated, _, _ = load_scene_pt(pt_path, 3)
    v0 = vertices[0].astype(np.float32)
    pos, color, normals = v0[:, 0:3], v0[:, 3:6], v0[:, 6:9]
    color = color * 2.0 - 1.0
    nv0 = len(v0)
    mask = np.zeros((nv0, 1), np.float32)
    sel = rng.choice(nv0, nv0 // 4, replace=False)
    mask[sel, 0] = rng.integers(1, 8, size=len(sel))
    mask_bool = (mask == 0).astype(np.float32)
    x = np.concatenate([color * mask_bool, normals, pos, mask_bool], 1)
    sd = make_reference_checkpoint(rng)
    ckpt = str(tmp_path / "model_best.pth")
    torch.save({"state_dicts": {"graph": sd}} if layout == "state_dicts"
               else {"state_dict": sd}, ckpt)
    nv = [len(v) for v in vertices]
    raw = dict(x=x, color=color.astype(np.float32), mask=mask,
               num_vertices=nv, level_edges=edges, traces=traces,
               dilated={2: dilated[2]}, name="scene0000_00")
    return (x, color, mask, edges, traces, dilated, nv), raw, sd, ckpt


@pytest.mark.parametrize("layout", ["state_dicts", "state_dict"])
def test_reference_checkpoint_psnr_parity(tmp_path, rng, layout):
    (x, color, mask, edges, traces, dilated, nv), raw, sd, ckpt = \
        _reference_case(tmp_path, rng, layout)
    out_ref = torch_reference_forward(sd, x, edges, traces, dilated, nv)

    loaded = load_reference_state_dict(ckpt)
    assert sorted(loaded) == sorted(sd)
    model = define_G(**CFG)
    model.load_state_dict(loaded, strict=True)
    graph = build_hierarchical_graph([RawHierarchy(**raw)])
    with torch.inference_mode():
        out = model.eval()(graph).numpy()[:nv[0]]

    p_ref = psnr(np.where(mask > 0, out_ref, color), color)
    p_port = psnr(np.where(mask > 0, out, color), color)
    assert abs(p_port - p_ref) < 0.1, (p_port, p_ref)
    assert np.abs(out - out_ref).max() < 5e-3

    params, _ = convert_stinet_state_dict(sd)
    out_jax = np.asarray(JaxNet(**CFG).apply(
        {"params": jax.tree.map(jnp.asarray, params)},
        jax_build([JaxRawHierarchy(**raw)])))[:nv[0]]
    np.testing.assert_allclose(out, out_jax, rtol=0, atol=JAX_TOL)

    served = SceneInpainter(define_G(**CFG), loaded, device="cpu")
    np.testing.assert_allclose(served.predict(RawHierarchy(**raw)), out,
                               rtol=0, atol=JAX_TOL)


def test_model_key_and_strict_loading(tmp_path, rng):
    sd = make_reference_checkpoint(rng)
    path = tmp_path / "two.pth"
    torch.save({"state_dicts": {"graph": sd, "other": {}}}, path)
    assert load_reference_state_dict(path, model_key="other") == {}
    model = define_G(**CFG)
    missing = dict(load_reference_state_dict(path))
    missing.pop("final_linear2.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(missing, strict=True)
    extra = dict(load_reference_state_dict(path))
    extra["bottleneck_blocks.0.first_norm.weight"] = torch.ones(32)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        model.load_state_dict(extra, strict=True)
    with pytest.raises(RuntimeError):
        SceneInpainter(define_G(**CFG), missing, device="cpu")
