"""The port's perceptual metrics and losses (stinet_tpu_torch/metrics/
fid.py, metrics/lpips.py, models/inception.py, models/vgg.py,
ops/resize.py, and the converters in utils/convert.py) against the JAX
package's, on the CPU, with the same numpy inputs and the same weights.

Weights come from one seeded torch state dict in the layouts the
reference's packages use (pytorch-fid's InceptionV3, torchvision's
alexnet.features and lpips' heads); the JAX side reads it through its own
converters (`convert_torch_state_dict`, `convert_torch_lpips`), the port
loads it as it is. JAX's InceptionV3 is jitted (its eager init takes a
minute here) and never initialized: its variables are the converted ones.

Tolerances:
- FID: each function on the same float64 activations within 1e-10
  relative (the same numpy and scipy calls);
- the bilinear resize to 299, upsampling 128 -> 299 and downsampling
  320 -> 299: its weights bitwise JAX's, its product within 2e-7 of the
  exact float64 one, and within 2e-6 / 2e-5 of `jax.image.resize`, whose
  own product is that far from the exact one;
- InceptionV3 pool3 features: within 1e-5 of the largest feature (f32
  convolutions, 94 of them, summed in another order), at 75 x 75 without
  the resize and at 32 -> 299 with it;
- LPIPS: within 1e-5 relative (f32), with and without the heads;
- resize_right's weight matrices: bitwise, compared in float64; the
  resize within 1e-6 (f32 products);
- VGGLoss: content and style within 1e-5 relative, and their gradient
  with respect to the prediction within 1e-4 of its largest (f32 through
  10 convolutions, the resize and the Gram matrices);
- the converters: the round trip torch -> JAX -> port is bitwise, and so
  is torch -> the JAX package's `.msgpack` -> port.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import linalg

from stinet_tpu.metrics import fid as jax_fid
from stinet_tpu.metrics.lpips import (
    LPIPS as JaxLPIPS, convert_torch_lpips, random_lpips as jax_random_lpips)
from stinet_tpu.models.inception import (
    InceptionV3 as JaxInceptionV3, convert_torch_state_dict)
from stinet_tpu.models.vgg import VGGLoss as JaxVGGLoss, convert_torch_vgg16
from stinet_tpu.utils.convert_perceptual_weights import _save as jax_save
from stinet_tpu.ops import resize as jax_resize
from stinet_tpu_torch.metrics import fid
from stinet_tpu_torch.metrics.lpips import (
    LPIPS, lpips_from_file, lpips_from_state_dict, random_lpips)
from stinet_tpu_torch.models.inception import (
    InceptionV3, _resize_weights, inception_from_file,
    load_inception_weights, resize_bilinear)
from stinet_tpu_torch.models.vgg import (
    VGGLoss, random_vgg, vgg_from_file, vgg_from_state_dict)
from stinet_tpu_torch.ops import resize
from stinet_tpu_torch.serving import full_f32_matmuls
from stinet_tpu_torch.utils.convert import (
    inception_state_dict_from_jax_variables,
    lpips_state_dict_from_jax_variables, vgg_state_dict_from_jax_params)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's intra-op pool at one thread while this module runs: under
    pytest-xdist every worker's default pool takes all the cores, and the
    spinning pools slow each other tenfold (the trainer test: 225 s among
    six workers, 20 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- Stage 0: TF32 off for cuDNN convolutions -------------------------------

def test_full_f32_matmuls_turns_cudnn_tf32_off_and_restores_it():
    saved = torch.backends.cudnn.allow_tf32
    try:
        for before in (True, False):
            torch.backends.cudnn.allow_tf32 = before
            with full_f32_matmuls():
                assert not torch.backends.cudnn.allow_tf32
                assert not torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.allow_tf32 is before
    finally:
        torch.backends.cudnn.allow_tf32 = saved


# --- FID ---------------------------------------------------------------------

def _acts(seed, n, d, shift=0.0):
    return np.random.default_rng(seed).normal(size=(n, d)) * 1.3 + shift


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def test_fid_functions_match_jax():
    a1, a2 = _acts(1, 64, 8), _acts(2, 64, 8, 0.2)
    m1, c1 = fid.calculate_activation_statistics(a1)
    jm1, jc1 = jax_fid.calculate_activation_statistics(a1)
    np.testing.assert_array_equal(m1, jm1)
    np.testing.assert_array_equal(c1, jc1)
    m2, c2 = fid.calculate_activation_statistics(a2)
    prod = c1 @ c2
    np.testing.assert_allclose(fid._sqrtm(prod), jax_fid._sqrtm(prod),
                               rtol=1e-10)
    got = fid.calculate_frechet_distance(m1, c1, m2, c2)
    want = jax_fid.calculate_frechet_distance(m1, c1, m2, c2)
    assert _rel(got, want) <= 1e-10
    # the analytic value of test_fid_golden
    assert _rel(fid.calculate_frechet_distance(
        np.zeros(2), np.diag([1.0, 4.0]), np.array([1.0, 2.0]),
        np.diag([9.0, 16.0])), 13.0) <= 1e-10


@pytest.mark.parametrize("flaky", [False, True])
def test_fid_singular_product_and_eps_retry_match_jax(monkeypatch, flaky):
    """Rank-deficient covariances (fewer samples than dimensions, as the
    2D trainer's) without a LinAlgWarning; and, with the first sqrtm made
    non-finite, the eps-on-the-diagonal retry on both sides."""
    a1, a2 = _acts(11, 4, 16), _acts(12, 4, 16)
    m1, c1 = fid.calculate_activation_statistics(a1)
    m2, c2 = fid.calculate_activation_statistics(a2)
    calls = []
    if flaky:
        real = linalg.sqrtm

        def flaky_sqrtm(a, *args, **kw):
            calls.append(1)
            if len(calls) % 2 == 1:
                return np.full_like(np.asarray(a, dtype=float), np.nan)
            return real(a, *args, **kw)
        monkeypatch.setattr(fid.linalg, "sqrtm", flaky_sqrtm)
    with warnings.catch_warnings():
        warnings.simplefilter("error", linalg.LinAlgWarning)
        got = fid.calculate_frechet_distance(m1, c1, m2, c2)
        want = jax_fid.calculate_frechet_distance(m1, c1, m2, c2)
    assert len(calls) == (4 if flaky else 0)    # both sides retried
    assert np.isfinite(got) and _rel(got, want) <= 1e-10


def test_fid_sessions_match_jax():
    """FIDScoreCumulative: sessions, frozen statistics, and images through
    a feature function that returns an f32 tensor, which the port keeps as
    float64 (the JAX side is given the same float64 values)."""
    port = fid.FIDScoreCumulative(
        feature_fn=lambda x: torch.as_tensor(x, dtype=torch.float32) * 2)
    ref = jax_fid.FIDScoreCumulative(
        feature_fn=lambda x: np.asarray(x, np.float32).astype(np.float64)
        * 2)
    for i, key in enumerate(("gt", "gt", "pred", "pred", "pred")):
        x = _acts(20 + i, 5, 6, 0.1 * i).astype(np.float32)
        port.add_images(key, x)
        ref.add_images(key, x)
    assert port.num_samples("pred") == ref.num_samples("pred") == 15
    port.freeze_statistics("gt")
    ref.freeze_statistics("gt")
    assert port.num_samples("gt") == 0
    assert _rel(port.fid_between("gt", "pred"),
                ref.fid_between("gt", "pred")) <= 1e-10
    port.add_activations("gt2", _acts(30, 9, 6))
    ref.add_activations("gt2", _acts(30, 9, 6))
    port.reset("pred")
    ref.reset("pred")
    port.add_activations("pred", _acts(31, 9, 6))
    ref.add_activations("pred", _acts(31, 9, 6))
    assert _rel(port.fid_between("gt2", "pred"),
                ref.fid_between("gt2", "pred")) <= 1e-10


# --- InceptionV3 -------------------------------------------------------------

def inception_state_dict(seed=3):
    """A pytorch-fid keyed InceptionV3 state dict (He-scaled convolutions,
    batch norms near identity, and a classifier the loaders ignore)."""
    gen = torch.Generator().manual_seed(seed)
    sd = InceptionV3(generator=gen).state_dict()
    out = {}
    for k, v in sd.items():
        if k.endswith("conv.weight"):
            v = torch.randn(v.shape, generator=gen) * (
                2.0 / v[0].numel()) ** 0.5
        elif k.endswith(("bn.weight", "bn.running_var")):
            v = 0.9 + 0.2 * torch.rand(v.shape, generator=gen)
        elif k.endswith(("bn.bias", "bn.running_mean")):
            v = 0.05 * torch.randn(v.shape, generator=gen)
        out[k] = v
    out["fc.weight"] = torch.randn(1008, 2048, generator=gen)
    out["fc.bias"] = torch.randn(1008, generator=gen)
    return out


@pytest.fixture(scope="module")
def inception_weights():
    sd = inception_state_dict()
    return sd, convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()})


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("src,jax_err", [(128, 2e-6), (320, 2e-5)])
def test_resize_matches_jax_image_resize(src, jax_err):
    """The weights are JAX's bit for bit; the port's product of them is
    within 2e-7 of the exact float64 one, JAX's own within 1.9e-6
    (upsampling) and 1.7e-5 (downsampling), so the two agree within
    JAX's error."""
    from jax._src.image import scale as jax_scale
    x = _images(4, (2, src, src, 3))
    weights = np.asarray(jax_scale.compute_weight_mat(
        src, 299, 299 / src, 0.0,
        jax_scale._kernels[jax_scale.ResizeMethod.LINEAR], True))
    np.testing.assert_array_equal(_resize_weights(src, 299), weights.T)
    exact = np.einsum("hn,bhwc,wm->bnmc", weights.astype(np.float64),
                      x.astype(np.float64), weights.astype(np.float64),
                      optimize=True)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                       method="bilinear"))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, exact, rtol=0, atol=2e-7)
    np.testing.assert_allclose(got, want, rtol=0, atol=jax_err)


@pytest.mark.parametrize("size,resize", [(75, False), (32, True)])
def test_inception_matches_jax(inception_weights, size, resize):
    sd, variables = inception_weights
    x = _images(5, (2, size, size, 3))
    jax_model = JaxInceptionV3(resize_input=resize)
    want = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(x)))
    model = load_inception_weights(InceptionV3(resize_input=resize), sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    scale = np.abs(want).max()
    assert scale > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_inception_loaders(tmp_path, inception_weights):
    """The converter's round trip is bitwise; a file loads, `fc.*` ignored;
    a stray key raises; the JAX package's `.msgpack` loads bitwise the
    `.pth` it was converted from."""
    sd, variables = inception_weights
    back = inception_state_dict_from_jax_variables(
        jax.tree.map(np.asarray, variables))
    want = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert torch.equal(back[k], v), k
    path = tmp_path / "inception.pt"
    torch.save(sd, path)
    model = inception_from_file(str(path))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(KeyError, match="unexpected"):
        load_inception_weights(InceptionV3(), dict(want, stray=sd["fc.bias"]))
    with pytest.raises(ValueError, match="Mixed_5b/bogus"):
        inception_state_dict_from_jax_variables({"params": {"Mixed_5b": {
            "bogus": np.zeros(3)}}, "batch_stats": {}})
    # the JAX package's converted file, written by its own `_save`
    msgpack = tmp_path / "inception.msgpack"
    jax_save(convert_torch_state_dict(sd), str(msgpack))
    for k, v in inception_from_file(str(msgpack)).state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


# --- LPIPS -------------------------------------------------------------------

def lpips_state_dicts(seed=1):
    """(torchvision alexnet.features state dict under `features.N.*`,
    lpips head weights under `lin{i}.model.1.weight`)."""
    gen = torch.Generator().manual_seed(seed)
    alex = {f"features.{k}": v for k, v in
            random_lpips(gen).alex.features.state_dict().items()}
    for k in alex:
        if k.endswith("bias"):
            alex[k] = 0.1 * torch.randn(alex[k].shape, generator=gen)
    heads = {f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1),
                                                  generator=gen) - 0.2
             for i, c in enumerate((64, 192, 384, 256, 256))}
    return alex, heads


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("heads", [False, True])
def test_lpips_matches_jax(size, heads):
    alex, lins = lpips_state_dicts()
    rng = np.random.default_rng(size)
    x = rng.uniform(-1, 1, (3, size, size, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.3, x.shape), -1, 1).astype(np.float32)
    np_alex = {k: v.numpy() for k, v in alex.items()}
    np_lins = {k: v.numpy() for k, v in lins.items()} if heads else None
    variables, jlins = convert_torch_lpips(np_alex, np_lins)
    want = np.asarray(JaxLPIPS(variables, jlins)(jnp.asarray(x),
                                                 jnp.asarray(y)))
    model = lpips_from_state_dict(dict(alex, **(lins if heads else {})))
    assert model.has_lins == heads
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (3,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_lpips_key_layouts_converters_and_refusals(tmp_path):
    """Every torch layout `convert_torch_lpips` reads gives one model; the
    port's own state dict and JAX's random features carry across; small
    images and a missing conv are refused; the JAX package's `.msgpack`
    loads bitwise the torch weights it was converted from."""
    alex, lins = lpips_state_dicts()
    want = lpips_from_state_dict(dict(alex, **lins)).state_dict()
    bare = {k[len("features."):]: v for k, v in alex.items()}
    sliced = {}
    for k, v in bare.items():
        ti = int(k.split(".")[0])
        sliced[f"net.slice{(0, 3, 6, 8, 10).index(ti) + 1}.{k}"] = v
    path = tmp_path / "lpips.pt"
    torch.save({"alex": alex, "lins": lins}, path)
    for model in (lpips_from_state_dict(dict(bare, **lins)),
                  lpips_from_state_dict(dict(sliced, **lins)),
                  lpips_from_state_dict(want), lpips_from_file(str(path))):
        got = model.state_dict()
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k

    ref = jax_random_lpips(img_size=32)
    port = lpips_from_state_dict(lpips_state_dict_from_jax_variables(
        jax.tree.map(np.asarray, ref.variables)))
    x = _images(6, (2, 32, 32, 3)) * 2 - 1
    y = _images(7, (2, 32, 32, 3)) * 2 - 1
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref(jnp.asarray(x),
                                                   jnp.asarray(y))),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="LPIPS entry 'fc'"):
        lpips_state_dict_from_jax_variables({"params": {"fc": {}}})
    with pytest.raises(ValueError, match=">= 32px"):
        LPIPS()(torch.zeros(1, 31, 40, 3), torch.zeros(1, 31, 40, 3))
    with pytest.raises(KeyError, match="conv 0"):
        lpips_from_state_dict({})
    # the JAX package's converted files (with and without the heads),
    # written by its own `_save` as its converter's `main` writes them
    for heads in (lins, None):
        variables, jlins = convert_torch_lpips(
            {k: v.numpy() for k, v in alex.items()},
            heads and {k: v.numpy() for k, v in heads.items()})
        msgpack = tmp_path / "lpips.msgpack"
        jax_save({"variables": variables,
                  "lins": [np.asarray(w) for w in (jlins or [])]},
                 str(msgpack))
        src = lpips_from_state_dict(dict(alex, **(heads or {})))
        got = lpips_from_file(str(msgpack))
        assert got.has_lins == (heads is not None)
        assert sorted(got.state_dict()) == sorted(src.state_dict())
        for k, v in src.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k


# --- resize_right and the VGG16 loss ----------------------------------------

@pytest.mark.parametrize("method", ["cubic", "linear"])
@pytest.mark.parametrize("n_in,n_out", [(128, 224), (32, 224), (40, 224),
                                        (300, 224), (224, 224), (7, 3)])
def test_resize_matrices_match_jax_bitwise(n_in, n_out, method):
    got = resize.resize_matrix(n_in, n_out, method)
    want = jax_resize.resize_matrix(n_in, n_out, method)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.astype(np.float64),
                                  want.astype(np.float64))


def test_resize_image_matches_jax():
    x = _images(8, (2, 40, 24, 3))
    want = np.asarray(jax_resize.resize_image(jnp.asarray(x), (64, 48)))
    got = resize.resize_image(torch.from_numpy(x), (64, 48)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        resize.resize_image(torch.from_numpy(x[0]), (64, 48)).numpy(),
        want[0], rtol=0, atol=1e-6)


def vgg_state_dict(seed=4):
    """A torchvision vgg16.features state dict up to relu4_3, under
    `features.N.*` (He-scaled weights, small biases)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in random_vgg(gen).state_dict().items():
        if k.endswith("weight"):
            v = torch.randn(v.shape, generator=gen) * (2.0 / v[0].numel()
                                                       ) ** 0.5
        else:
            v = 0.05 * torch.randn(v.shape, generator=gen)
        out[k] = v
    return out


def test_vgg_loss_matches_jax():
    sd = vgg_state_dict()
    rng = np.random.default_rng(9)
    pred = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.3, pred.shape), -1,
                     1).astype(np.float32)
    ref = JaxVGGLoss(convert_torch_vgg16({k: v.numpy()
                                          for k, v in sd.items()}),
                     resize_to=64)

    def jax_total(p):
        c, st = ref(p, jnp.asarray(target))
        return c + st, (c, st)

    (_, (want_c, want_s)), want_g = jax.value_and_grad(
        jax_total, has_aux=True)(jnp.asarray(pred))
    loss = VGGLoss(vgg_from_state_dict(sd), resize_to=64)
    p = torch.from_numpy(pred).requires_grad_(True)
    content, style = loss(p, torch.from_numpy(target))
    (content + style).backward()
    assert not any(q.requires_grad for q in loss.parameters())
    np.testing.assert_allclose(content.item(), float(want_c), rtol=1e-5)
    np.testing.assert_allclose(style.item(), float(want_s), rtol=1e-5)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(p.grad.numpy(), want_g, rtol=0,
                               atol=1e-4 * np.abs(want_g).max())


def test_vgg_loaders(tmp_path):
    sd = vgg_state_dict()
    bare = {k[len("features."):]: v for k, v in sd.items()}
    path = tmp_path / "vgg.pt"
    torch.save(dict(bare, **{"28.weight": torch.zeros(1)}), path)
    for vgg in (vgg_from_state_dict(sd), vgg_from_file(str(path))):
        got = vgg.state_dict()
        assert sorted(got) == sorted(sd)
        for k, v in sd.items():
            assert torch.equal(got[k], v), k
    with pytest.raises(KeyError, match="index 0"):
        vgg_from_state_dict({})
    # the JAX package's converted file, written by its own `_save`
    msgpack = tmp_path / "vgg.msgpack"
    jax_save(convert_torch_vgg16({k: v.numpy() for k, v in sd.items()}),
             str(msgpack))
    got = vgg_from_file(str(msgpack)).state_dict()
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    with pytest.raises(ValueError, match="VGG16 entry 'fc'"):
        vgg_state_dict_from_jax_params({"params": {"fc": {}}})
