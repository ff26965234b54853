"""The port's conv2d models and GAN losses (stinet_tpu_torch/models/
resnet2d.py, models/gan_networks.py, factory.define_G / define_D, and
utils/convert.py:resnet2d_state_dict_from_jax_params) against the JAX
package's, on the CPU, on the same numpy inputs and weights.

Tolerances:
- every module's output, with JAX's weights carried by the converter:
  within 1e-5 of JAX's (f32 convolutions summed in another order), NHWC
  in JAX and NCHW here; batch norm's running statistics after a training
  forward within 1e-6 (flax's update takes the BIASED batch variance);
- gan_loss and the gradient penalty: within 1e-6 relative;
- the lr schedules: equal to 1e-12.

The JAX modules are applied op by op on parameters drawn with numpy in
the shapes `jax.eval_shape` gives: no JAX compile, a few seconds a file.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stinet_tpu.models import gan_networks as jax_gan
from stinet_tpu.models import resnet2d as jax_resnet2d
from stinet_tpu.models.factory import define_D as jax_define_D
from stinet_tpu.models.factory import define_G as jax_define_G
from stinet_tpu_torch.models import gan_networks, resnet2d
from stinet_tpu_torch.models.factory import (
    count_parameters, define_D, define_G)
from stinet_tpu_torch.utils.convert import (
    resnet2d_state_dict_from_jax_params)

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's intra-op pool at one thread while this module runs (under
    pytest-xdist every worker's default pool takes all the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_variables(module, x, seed=0):
    """Random variables of a flax module in the shapes its init gives:
    kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2), batch norm scales
    about 1, running means about 0 and variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), x)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0, 1 / math.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif name == "scale":
            v = 1 + rng.normal(0, 0.1, s.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.normal(0, 0.1, s.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def check_module(jax_module, port, x, train=False):
    """JAX's module and the port's with JAX's weights on x [B, H, W, C];
    in train mode also the running statistics after the forward."""
    v = jax_variables(jax_module, x)
    stats = v.get("batch_stats")
    if train:
        want, upd = jax_module.apply(v, x, train=True,
                                     mutable=["batch_stats"])
    else:
        want = jax_module.apply(v, x)
    port.load_state_dict(resnet2d_state_dict_from_jax_params(
        v["params"], stats))
    port.train(train)
    with torch.no_grad():
        got = port(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    if train:
        old = resnet2d_state_dict_from_jax_params(v["params"], stats)
        new = resnet2d_state_dict_from_jax_params(v["params"],
                                                  upd["batch_stats"])
        running = [k for k in new if "running" in k]
        assert running
        for k in running:
            got_k = port.state_dict()[k].numpy()
            np.testing.assert_allclose(got_k, new[k].numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)
            assert not np.allclose(got_k, old[k].numpy()), k
    return v


def image(b, s, c, seed=0):
    return np.random.default_rng(seed).normal(size=(b, s, s, c)).astype(
        np.float32)


# --- Resnet2D ----------------------------------------------------------------

# norm (batch in train or eval mode), padding, pooling, io field, repeated
# io convs, dilation order: every value of each knob at least once
RESNET2D_CASES = {
    "instance-reflect-stride-large": dict(
        norm="instance", padding_type="reflect", pooling_type="stride",
        io_receptive_field_type="large", n_repeated_io_convs=1,
        dilation_order=0),
    "batch_train-replicate-max-normal": dict(
        norm="batch", padding_type="replicate", pooling_type="max",
        io_receptive_field_type="normal", n_repeated_io_convs=2,
        dilation_order=1),
    "batch_eval-zero-mean-large": dict(
        norm="batch", padding_type="zero", pooling_type="mean",
        io_receptive_field_type="large", n_repeated_io_convs=1,
        dilation_order=1),
    "none-reflect-max-normal": dict(
        norm="none", padding_type="reflect", pooling_type="max",
        io_receptive_field_type="normal", n_repeated_io_convs=2,
        dilation_order=0),
    "instance-zero-stride-normal": dict(
        norm="instance", padding_type="zero", pooling_type="stride",
        io_receptive_field_type="normal", n_repeated_io_convs=2,
        dilation_order=1),
    "instance-replicate-mean-large_dropout_eval": dict(
        norm="instance", padding_type="replicate", pooling_type="mean",
        io_receptive_field_type="large", n_repeated_io_convs=1,
        dilation_order=1, use_dropout=True),
}


@pytest.mark.parametrize("case", sorted(RESNET2D_CASES))
def test_resnet2d_matches_jax(case):
    """Resnet2D (ngf 8, 3 blocks, 2 levels) on B=2 16 x 16 images; the
    dilated blocks' reflect pads (up to 2) stay under the 4 x 4
    bottleneck."""
    args = dict(input_nc=4, output_nc=3, ngf=8, n_blocks=3, n_levels=2,
                **RESNET2D_CASES[case])
    check_module(jax_resnet2d.Resnet2D(**args), resnet2d.Resnet2D(**args),
                 image(2, 16, 4), train=case.startswith("batch_train"))


def test_resnet2d_backward_matches_jax():
    """The gradient of sum(out * r) with respect to the input and every
    parameter (instance norm, stride pooling, transposed convolutions):
    the input's within 1e-5 of its largest element, the parameters' taken
    together as one vector within 1e-5 of its L2 norm (a bias ahead of an
    instance norm has a gradient of rounding size: the norm cancels it)."""
    args = dict(input_nc=4, output_nc=3, ngf=8, n_blocks=2, n_levels=2,
                norm="instance", pooling_type="stride", dilation_order=1)
    jm, port = jax_resnet2d.Resnet2D(**args), resnet2d.Resnet2D(**args)
    x, r = image(2, 16, 4), image(2, 16, 3, seed=1)
    v = jax_variables(jm, x)
    gx, gp = jax.jit(jax.grad(
        lambda x, p: jnp.sum(jm.apply({"params": p}, x) * r),
        argnums=(0, 1)))(x, v["params"])
    port.load_state_dict(resnet2d_state_dict_from_jax_params(v["params"]))
    xt = nchw(x).requires_grad_(True)
    (port(xt) * nchw(r)).sum().backward()
    want_x = nchw(np.asarray(gx))
    assert float((xt.grad - want_x).abs().max()) <= 1e-5 * float(
        want_x.abs().max())
    want = resnet2d_state_dict_from_jax_params(gp)
    got = {k: p.grad for k, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    diff = math.sqrt(sum(float((got[k] - g).double().norm()) ** 2
                         for k, g in want.items()))
    norm = math.sqrt(sum(float(g.double().norm()) ** 2
                         for g in want.values()))
    assert diff <= 1e-5 * norm, (diff, norm)


def test_define_g_builds_resnet2d_as_jax_does():
    """The shipped 2D configs' Resnet2D block through both factories
    (ngf cut to 8): the same layers and parameter count; a bf16 dtype
    gives the same f32 parameters and a bf16 compute dtype."""
    args = dict(input_nc=4, output_nc=3, ngf=8, n_blocks=9, norm="instance",
                use_dropout=False, init_type="normal", init_gain=0.02,
                dilation_order=1, pooling_type="max",
                io_receptive_field_type="normal", n_levels=2,
                n_repeated_io_convs=1, filter_type="conv2d")
    port = define_G(**args, generator=torch.Generator().manual_seed(0))
    assert isinstance(port, resnet2d.Resnet2D)
    x = image(1, 32, 4)
    jm = jax_define_G(**args)
    v = check_module(jm, port, x)
    assert count_parameters(port) == sum(
        a.size for a in jax.tree.leaves(v["params"]))
    dilations = [b.fconvs[0].convs[0].dilation for b in port.blocks]
    assert dilations == [(1, 1)] * 8 + [(2, 2)]
    bf16 = define_G(**dict(args, dtype="bfloat16"))
    assert bf16.dtype == torch.bfloat16
    assert count_parameters(bf16) == count_parameters(port)
    assert all(p.dtype == torch.float32 for p in bf16.parameters())


def test_weights_follow_the_torch_linear_law():
    """Weights drawn from the generator: U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    the same draw for the same seed, zero biases."""
    def make(seed):
        return resnet2d.Resnet2D(4, ngf=8, n_blocks=2,
                                 generator=torch.Generator().manual_seed(
                                     seed))
    a, b, c = make(0), make(0), make(1)
    for (k, p), q, o in zip(a.state_dict().items(), b.parameters(),
                            c.parameters()):
        assert torch.equal(p, q), k
        if k.endswith("bias"):
            assert not p.any(), k
            continue
        fan_in = p[0].numel() if "tconvs" not in k else \
            p.shape[0] * p[0, 0].numel()
        bound = 1 / math.sqrt(fan_in)
        assert float(p.abs().max()) <= bound
        assert float(p.abs().max()) > 0.8 * bound, k
        assert not torch.equal(p, o), k


# --- the GAN zoo -------------------------------------------------------------

GAN_CASES = {
    "resnet_generator": (
        lambda: jax_gan.ResnetGenerator(4, 3, ngf=8, n_blocks=2,
                                        norm="instance"),
        lambda: gan_networks.ResnetGenerator(4, 3, ngf=8, n_blocks=2,
                                             norm="instance"),
        (2, 16, 4), False),
    "resnet_generator_batch_train_replicate": (
        lambda: jax_gan.ResnetGenerator(4, 3, ngf=8, n_blocks=1,
                                        padding_type="replicate"),
        lambda: gan_networks.ResnetGenerator(4, 3, ngf=8, n_blocks=1,
                                             padding_type="replicate"),
        (2, 16, 4), True),
    "unet_generator_batch_eval_dropout": (
        lambda: jax_gan.UnetGenerator(4, 3, num_downs=4, ngf=8,
                                      use_dropout=True),
        lambda: gan_networks.UnetGenerator(4, 3, num_downs=4, ngf=8,
                                           use_dropout=True),
        (2, 32, 4), False),
    "unet_generator_instance": (
        lambda: jax_gan.UnetGenerator(4, 3, num_downs=5, ngf=4,
                                      norm="instance"),
        lambda: gan_networks.UnetGenerator(4, 3, num_downs=5, ngf=4,
                                           norm="instance"),
        (2, 64, 4), False),
    "nlayer_discriminator_2": (
        lambda: jax_gan.NLayerDiscriminator(7, ndf=8, n_layers=2,
                                            norm="instance"),
        lambda: gan_networks.NLayerDiscriminator(7, ndf=8, n_layers=2,
                                                 norm="instance"),
        (2, 32, 7), False),
    "nlayer_discriminator_5": (
        lambda: jax_gan.NLayerDiscriminator(7, ndf=4, n_layers=5,
                                            norm="instance"),
        lambda: gan_networks.NLayerDiscriminator(7, ndf=4, n_layers=5,
                                                 norm="instance"),
        (1, 96, 7), False),
    "nlayer_discriminator_batch_train": (
        lambda: jax_gan.NLayerDiscriminator(7, ndf=8, n_layers=2),
        lambda: gan_networks.NLayerDiscriminator(7, ndf=8, n_layers=2),
        (2, 32, 7), True),
    "pixel_discriminator_batch_eval": (
        lambda: jax_gan.PixelDiscriminator(7, ndf=8),
        lambda: gan_networks.PixelDiscriminator(7, ndf=8),
        (2, 16, 7), False),
}


@pytest.mark.parametrize("case", sorted(GAN_CASES))
def test_gan_zoo_matches_jax(case):
    make_jax, make_port, (b, s, c), train = GAN_CASES[case]
    check_module(make_jax(), make_port(), image(b, s, c), train=train)


@pytest.mark.parametrize("net_d", ["basic", "n_layers", "pixel"])
def test_define_d_builds_what_jax_builds(net_d):
    args = dict(input_nc=7, ndf=8, netD=net_d, n_layers_D=2,
                norm="instance")
    port = define_D(**args, generator=torch.Generator().manual_seed(1))
    jm = jax_define_D(**args)
    assert type(port).__name__ == type(jm).__name__
    assert len(port.convs) == {"basic": 5, "n_layers": 4, "pixel": 3}[net_d]
    check_module(jm, port, image(1, 32, 7))
    with pytest.raises(NotImplementedError, match="not recognized"):
        define_D(7, 8, "global")


# --- the converter -----------------------------------------------------------

def test_converter_takes_every_leaf_once_and_refuses_the_rest():
    """Every JAX leaf, batch statistics included, lands in exactly one
    port key, and load_state_dict (strict) takes them all; an unknown
    module, an unknown leaf, a batch norm without statistics and
    statistics without a batch norm each raise."""
    args = dict(input_nc=4, ngf=8, n_blocks=2, norm="batch",
                pooling_type="stride", n_repeated_io_convs=2)
    x = image(1, 16, 4)
    v = jax_variables(jax_resnet2d.Resnet2D(**args), x)
    params, stats = v["params"], v["batch_stats"]
    sd = resnet2d_state_dict_from_jax_params(params, stats)
    n_leaves = len(jax.tree.leaves(params)) + len(jax.tree.leaves(stats))
    assert len(sd) == n_leaves
    resnet2d.Resnet2D(**args).load_state_dict(sd)
    assert "tconvs.1.weight" in sd and "blocks.1.norms.0.running_var" in sd

    def raises(p, s, match):
        with pytest.raises(ValueError, match=match):
            resnet2d_state_dict_from_jax_params(p, s)

    raises(dict(params, Dense_0={"kernel": np.zeros((2, 2))}), stats,
           "no port layer for Dense_0")
    raises(dict(params, Conv_0=dict(params["Conv_0"],
                                    scale=np.zeros(2))), stats,
           "unexpected conv leaf convs.0/scale")
    raises(params, {k: s for k, s in stats.items() if k != "Norm2D_1"},
           "batch norm norms.1")
    raises(params, dict(stats, Norm2D_9={"BatchNorm_0": stats["Norm2D_0"][
        "BatchNorm_0"]}), "batch_stats without a port layer")
    raises(params, dict(stats, extra=np.zeros(2)),
           "batch_stats without a port layer")


# --- losses and schedules ----------------------------------------------------

@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgangp"])
def test_gan_loss_matches_jax(mode, real):
    pred = np.random.default_rng(3).normal(0, 3, (2, 1, 6, 6)).astype(
        np.float32)
    want = float(jax_gan.gan_loss(pred, real, mode))
    got = float(gan_networks.gan_loss(torch.from_numpy(pred), real, mode))
    assert abs(got - want) <= 1e-6 * abs(want)
    with pytest.raises(NotImplementedError):
        gan_networks.gan_loss(torch.from_numpy(pred), real, "hinge")


@pytest.mark.parametrize("gp_type", ["real", "fake", "mixed"])
def test_gradient_penalty_matches_jax(gp_type):
    """"real" and "fake" against JAX's penalty; "mixed" against JAX's
    formula at the port's interpolation (JAX's at gp_type "real" on it),
    alpha drawn from the port's generator. The port's penalty is
    differentiable in the discriminator's parameters."""
    jm = jax_gan.NLayerDiscriminator(7, ndf=8, n_layers=2, norm="instance")
    port = gan_networks.NLayerDiscriminator(7, ndf=8, n_layers=2,
                                            norm="instance")
    real, fake = image(3, 32, 7, seed=1), image(3, 32, 7, seed=2)
    v = jax_variables(jm, real)
    port.load_state_dict(resnet2d_state_dict_from_jax_params(v["params"]))
    got = gan_networks.cal_gradient_penalty(
        port, nchw(real), nchw(fake), torch.Generator().manual_seed(5),
        gp_type=gp_type, constant=0.5)
    if gp_type == "mixed":
        alpha = torch.rand((3, 1, 1, 1), generator=torch.Generator(
            ).manual_seed(5)).numpy()
        real, gp_type = alpha * real + (1 - alpha) * fake, "real"
    want = float(jax_gan.cal_gradient_penalty(
        lambda p, x: jm.apply({"params": p}, x), v["params"], real, fake,
        jax.random.key(0), constant=0.5, gp_type=gp_type))
    assert abs(got.item() - want) <= 1e-5 * abs(want)
    got.backward()
    assert float(port.convs[0].weight.grad.abs().sum()) > 0


@pytest.mark.parametrize("policy,args", [
    ("linear", {"n_epochs": 30, "n_epochs_decay": 50}),
    ("step", {"step_size": 7, "gamma": 0.5}),
    ("step", {"lr_decay_iters": 11}),
    ("cosine", {"n_epochs": 40}),
    ("plateau", {})])
def test_scheduler_matches_jax(policy, args):
    got = gan_networks.get_scheduler(policy, args)
    want = jax_gan.get_scheduler(policy, args)
    if policy == "plateau":
        values = [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.7,
                  0.8, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8]
        lrs = []
        for val in values:
            got.observe(val)
            want.observe(val)
            lrs.append(got(0))
            assert lrs[-1] == pytest.approx(want(0), abs=1e-12)
        assert min(lrs) < 1.0
        return
    for epoch in range(120):
        assert got(epoch) == pytest.approx(want(epoch), abs=1e-12), epoch
    with pytest.raises(NotImplementedError):
        gan_networks.get_scheduler("warmup", {})
