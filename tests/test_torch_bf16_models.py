"""bfloat16 outside STINet: the port's Resnet2D, the GAN zoo's
discriminators (define_D's "basic", "n_layers", "pixel") and generators,
and SingleConvMeshNet with a bf16 compute dtype, against the JAX
package's modules with `dtype=bfloat16`, on the CPU, on the same numpy
inputs and weights; then a bf16 GAN step of the 2D trainer and a bf16
segmentation step against the JAX trainers' losses.

Tolerances, of bf16's size (its unit roundoff is 2^-8 = 3.9e-3):
- a forward against JAX's module applied op by op: the output within 1e-2
  of JAX's in L2, relative (measured: bitwise, but for a convolution
  whose f32 sum lands on a rounding tie in one library and not in the
  other, which the norms after it amplify); the output's dtype JAX's;
- SingleConvMeshNet in train mode with its backward: the logits within
  1e-2 relative, the parameters' gradients taken together as one vector
  within 5e-2 of its L2 norm (JAX's gradient is jitted, and XLA keeps
  some bf16 intermediates in f32 there), the running statistics within
  1e-4;
- a train step against the JAX trainer (jitted, as it trains): each step's
  loss within rtol 1e-2.
"""
import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stinet_tpu.core.config import ConfigParser as JaxConfigParser
from stinet_tpu.core.registry import TRAINERS as JAX_TRAINERS
from stinet_tpu.models import gan_networks as jax_gan
from stinet_tpu.models import resnet2d as jax_resnet2d
from stinet_tpu.models import singleconvmeshnet as jax_scm
from stinet_tpu.models.factory import define_D as jax_define_D
from stinet_tpu.models.factory import define_G as jax_define_G
import stinet_tpu.trainers  # noqa: F401
from stinet_tpu_torch.core.config import ConfigParser
from stinet_tpu_torch.models import gan_networks, resnet2d
from stinet_tpu_torch.models import singleconvmeshnet as scm
from stinet_tpu_torch.models.factory import define_D, define_G
from stinet_tpu_torch.trainers.inpainting2d import Inpainting2DTrainer
from stinet_tpu_torch.trainers.segmentation import GraphSegmentationTrainer
from stinet_tpu_torch.utils.convert import (
    resnet2d_state_dict_from_jax_params, seg_state_dict_from_jax_params)
from test_torch_gan import _config as gan_config
from test_torch_gan import _record as record_2d
from test_torch_resnet2d import image, jax_variables, nchw
from test_torch_segmentation import (  # noqa: F401  (fixtures)
    ARCH, _config as seg_config, _jax_run, _random_variables,
    _record as record_seg, graphs, roots, t)

BF16 = torch.bfloat16
FWD_TOL = 1e-2
GRAD_TOL = 5e-2
STEP_RTOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's intra-op pool at one thread while this module runs (under
    pytest-xdist every worker's default pool takes all the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def check_bf16_module(jax_module, port, x):
    """JAX's module (dtype bf16) and the port's with JAX's weights on x
    [B, H, W, C] in eval mode: a bf16 output within FWD_TOL."""
    v = jax_variables(jax_module, x)
    want = jax_module.apply(v, x)
    port.load_state_dict(resnet2d_state_dict_from_jax_params(
        v["params"], v.get("batch_stats")))
    port.eval()
    assert all(p.dtype == torch.float32 for p in port.parameters())
    with torch.no_grad():
        got = port(nchw(x)).permute(0, 2, 3, 1)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    assert got.shape == want.shape
    assert rel_l2(got.float(), want.astype(jnp.float32)) <= FWD_TOL


BF16_CASES = {
    # norm, padding, pooling and io field: each knob's bf16 path once
    "resnet2d-instance-max": (
        lambda d: jax_resnet2d.Resnet2D(
            4, ngf=8, n_blocks=3, norm="instance", pooling_type="max",
            dilation_order=1, io_receptive_field_type="normal", dtype=d),
        lambda d: resnet2d.Resnet2D(
            4, ngf=8, n_blocks=3, norm="instance", pooling_type="max",
            dilation_order=1, io_receptive_field_type="normal", dtype=d),
        (2, 16, 4)),
    "resnet2d-instance-stride-zero": (
        lambda d: jax_resnet2d.Resnet2D(
            4, ngf=8, n_blocks=2, norm="instance", pooling_type="stride",
            padding_type="zero", dtype=d),
        lambda d: resnet2d.Resnet2D(
            4, ngf=8, n_blocks=2, norm="instance", pooling_type="stride",
            padding_type="zero", dtype=d),
        (2, 16, 4)),
    "resnet2d-batch-mean-replicate": (
        lambda d: jax_resnet2d.Resnet2D(
            4, ngf=8, n_blocks=2, norm="batch", pooling_type="mean",
            padding_type="replicate", n_repeated_io_convs=2, dtype=d),
        lambda d: resnet2d.Resnet2D(
            4, ngf=8, n_blocks=2, norm="batch", pooling_type="mean",
            padding_type="replicate", n_repeated_io_convs=2, dtype=d),
        (2, 16, 4)),
    "resnet_generator": (
        lambda d: jax_gan.ResnetGenerator(4, 3, ngf=8, n_blocks=2,
                                          norm="instance", dtype=d),
        lambda d: gan_networks.ResnetGenerator(4, 3, ngf=8, n_blocks=2,
                                               norm="instance", dtype=d),
        (2, 16, 4)),
    "unet_generator": (
        lambda d: jax_gan.UnetGenerator(4, 3, num_downs=4, ngf=8,
                                        norm="instance", dtype=d),
        lambda d: gan_networks.UnetGenerator(4, 3, num_downs=4, ngf=8,
                                             norm="instance", dtype=d),
        (2, 32, 4)),
}


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_module_matches_jax(case):
    make_jax, make_port, shape = BF16_CASES[case]
    check_bf16_module(make_jax(jnp.bfloat16), make_port(BF16), image(*shape))


@pytest.mark.parametrize("net_d,norm", [("basic", "batch"),
                                        ("n_layers", "instance"),
                                        ("pixel", "instance")])
def test_bf16_discriminators_match_jax(net_d, norm):
    """define_D with dtype "bfloat16" in both packages (the 2D trainer's
    discriminator is n_layers with instance norm)."""
    args = dict(input_nc=7, ndf=8, netD=net_d, n_layers_D=3, norm=norm,
                dtype="bfloat16")
    check_bf16_module(jax_define_D(**args), define_D(**args), image(2, 32, 7))


def test_define_g_builds_a_bf16_resnet2d():
    """The shipped conv2d generator's args with dtype "bfloat16" (ngf cut
    to 8) through both factories."""
    args = dict(input_nc=4, output_nc=3, ngf=8, n_blocks=4, norm="instance",
                dilation_order=1, pooling_type="max",
                io_receptive_field_type="normal", filter_type="conv2d",
                dtype="bfloat16")
    port = define_G(**args, generator=torch.Generator().manual_seed(0))
    assert isinstance(port, resnet2d.Resnet2D) and port.dtype == BF16
    check_bf16_module(jax_define_G(**args), port, image(1, 32, 4))


# --- SingleConvMeshNet -------------------------------------------------------

def test_bf16_singleconvmeshnet_eval_matches_jax(graphs):
    """Eval mode: the f32 edge convolutions, the bf16 head (its batch norm
    on the running statistics returns f32), bf16 logits."""
    jg, pg = graphs
    jm = jax_scm.SingleConvMeshNet(**ARCH, dtype="bfloat16")
    params, stats = _random_variables(
        jax.jit(jm.init)(jax.random.key(0), jg), 3)
    want = jax.jit(lambda p: jm.apply({"params": p, "batch_stats": stats},
                                      jg, train=False))(params)
    model = scm.SingleConvMeshNet(**ARCH, dtype="bfloat16")
    model.load_state_dict(seg_state_dict_from_jax_params(params, stats))
    model.eval()
    with torch.no_grad():
        got = model(pg)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    assert rel_l2(got.float(), want.astype(jnp.float32)) <= FWD_TOL


def test_bf16_singleconvmeshnet_train_matches_jax(graphs):
    """A train forward and its backward: logits, the parameters' gradients
    (f32), and the running statistics, the head's from bf16 statistics."""
    jg, pg = graphs
    jm = jax_scm.SingleConvMeshNet(**ARCH, dtype="bfloat16")
    params, stats = _random_variables(
        jax.jit(jm.init)(jax.random.key(0), jg))
    r = np.random.default_rng(2).normal(
        size=(pg.x.shape[0], 21)).astype(np.float32)

    def apply(prm, x, train):
        out, upd = jm.apply({"params": prm, "batch_stats": stats},
                            jg.replace(x=x), train=True,
                            mutable=["batch_stats"])
        return out.astype(jnp.float32), upd["batch_stats"]
    want, grads, new_stats = _jax_run(apply, params, np.asarray(jg.x), r,
                                      True)
    model = scm.SingleConvMeshNet(**ARCH, dtype=BF16)
    model.load_state_dict(seg_state_dict_from_jax_params(params, stats))
    model.train()
    got = model(pg)
    assert got.dtype == BF16
    (got.float() * t(r)).sum().backward()
    assert rel_l2(got.detach().float(), want) <= FWD_TOL
    want_sd = seg_state_dict_from_jax_params(grads[0], new_stats)
    diff = norm = 0.0
    for k, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, k
        diff += float((p.grad - want_sd[k]).double().norm()) ** 2
        norm += float(want_sd[k].double().norm()) ** 2
    assert math.sqrt(diff) <= GRAD_TOL * math.sqrt(norm)
    for k, b in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(b.numpy(), want_sd[k].numpy(),
                                       rtol=0, atol=1e-4, err_msg=k)


# --- train steps against the JAX trainers -----------------------------------

def test_bf16_gan_step_matches_jax(tmp_path):
    """The 2D trainer's GAN branch with a bf16 Resnet2D (the discriminator
    f32, as both trainers build it): one epoch's steps from JAX's weights
    on the same batches, each loss within STEP_RTOL."""
    cfg = gan_config(tmp_path, gan=True, epochs=1)
    cfg["archs"]["Resnet2D"]["args"]["dtype"] = "bfloat16"
    cfg["trainer"]["use_lpips"] = False
    want_trainer = JAX_TRAINERS.get("Inpainting2DTrainer")(
        JaxConfigParser(copy.deepcopy(cfg), dry_run=True))
    trainer = Inpainting2DTrainer(
        ConfigParser(copy.deepcopy(cfg), dry_run=True), device="cpu")
    assert trainer.model.dtype == BF16 and trainer.disc.dtype is None
    trainer.model.load_state_dict(resnet2d_state_dict_from_jax_params(
        want_trainer.state.params))
    trainer.disc.load_state_dict(resnet2d_state_dict_from_jax_params(
        want_trainer.disc_state.params))
    want_rec = record_2d(want_trainer, "_gan_step", 2)
    rec = record_2d(trainer, "_train_step", 0)
    want, got = want_trainer._train_epoch(1), trainer._train_epoch(1)
    assert len(rec["loss"]) == len(want_rec["loss"]) == 4
    assert rec["mask"] == want_rec["mask"]
    np.testing.assert_allclose(rec["loss"], want_rec["loss"],
                               rtol=STEP_RTOL)
    for k in ("loss", "loss_D_fake", "loss_D_real", "loss_G", "val_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=STEP_RTOL,
                                   err_msg=k)


def test_bf16_segmentation_step_matches_jax(tmp_path, roots):
    """The segmentation trainer with a bf16 SingleConvMeshNet (the
    config's arch args carry "dtype"): one epoch's steps from JAX's weights
    and statistics, each loss within STEP_RTOL."""
    cfg = seg_config(tmp_path, roots, epochs=1)
    cfg["archs"]["SingleConvMeshNet"]["args"]["dtype"] = "bfloat16"
    want_trainer = JAX_TRAINERS.get("GraphSegmentationTrainer")(
        JaxConfigParser(copy.deepcopy(cfg), dry_run=True))
    trainer = GraphSegmentationTrainer(
        ConfigParser(copy.deepcopy(cfg), dry_run=True), device="cpu")
    assert trainer.model.dtype == BF16
    trainer.model.load_state_dict(seg_state_dict_from_jax_params(
        want_trainer.state.params, want_trainer.state.batch_stats))
    want_rec = record_seg(want_trainer, jax_side=True)
    rec = record_seg(trainer, jax_side=False)
    want, got = want_trainer._train_epoch(1), trainer._train_epoch(1)
    assert len(rec["loss"]) == len(want_rec["loss"]) == 4
    np.testing.assert_allclose(rec["loss"], want_rec["loss"],
                               rtol=STEP_RTOL)
    for k in ("loss", "val_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=STEP_RTOL,
                                   err_msg=k)
