"""Generator and discriminator factories with the config surface of the
reference's define_G / define_D (and of `stinet_tpu/models/factory.py`):
`filter_type="conv2d"` builds the 2D workload's Resnet2D, any other the
STINet; `define_D` builds the PatchGAN zoo's discriminators. Knobs of the
reference's torch setup that the JAX models also ignore (init type and
gain, GPU ids; dropout on STINet) are accepted so a config's archs section
passes unchanged. `dtype` ("bfloat16" / "float32" as JSON configs spell
them) is every model's compute dtype (parameters stay f32), and the
checkpointing knobs place `torch.utils.checkpoint` as the JAX model places
`nn.remat`."""
from typing import Optional

import torch

# The flagship 3D inpainting generator (the reference's
# config_stinet_surfacetextureinpainting.json archs args; the JAX package's
# __graft_entry__.py:_flagship_model)
FLAGSHIP = dict(input_nc=10, output_nc=3, ngf=64,
                filter_type="edgeconvtransinv", norm="instance", n_blocks=9,
                dilations=[1, 1, 1, 2, 4, 8, 16, 1, 1], n_levels=2,
                n_repeated_io_convs=1, pooling_type="max")


def define_G(input_nc, output_nc, ngf, filter_type, norm="batch",
             dilation_order=0, use_dropout=False, n_blocks=6, n_levels=2,
             n_repeated_io_convs=1, init_type="normal", pooling_type="stride",
             io_receptive_field_type="large", checkpoint_bottleneck=False,
             num_blocks_per_uncheckpointed_block=1, use_label_embedding=False,
             num_classes=None, num_embedding=None, dilations=None,
             init_gain=0.02, gpu_ids=(), dtype=None, remat_io_blocks=True,
             generator: Optional[torch.Generator] = None):
    """Build the generator named by `filter_type`; its weights are drawn
    from `generator` (torch.Generator() when None)."""
    if filter_type == "conv2d":
        from stinet_tpu_torch.models.resnet2d import Resnet2D
        return Resnet2D(
            input_nc=input_nc, output_nc=output_nc, ngf=ngf, norm=norm,
            use_dropout=use_dropout, n_blocks=n_blocks, n_levels=n_levels,
            dilation_order=dilation_order,
            n_repeated_io_convs=n_repeated_io_convs,
            pooling_type=pooling_type,
            io_receptive_field_type=io_receptive_field_type,
            dtype=resolve_dtype(dtype), generator=generator)
    from stinet_tpu_torch.models.stinet import SurfaceTextureInpaintingNet
    return SurfaceTextureInpaintingNet(
        input_nc=input_nc, output_nc=output_nc, ngf=ngf,
        filter_type=filter_type, norm=norm, n_blocks=n_blocks,
        n_levels=n_levels, n_repeated_io_convs=n_repeated_io_convs,
        pooling_type=pooling_type, dilations=dilations,
        checkpoint_bottleneck=checkpoint_bottleneck,
        num_blocks_per_uncheckpointed_block=(
            num_blocks_per_uncheckpointed_block),
        remat_io_blocks=remat_io_blocks,
        use_label_embedding=use_label_embedding, num_classes=num_classes,
        num_embedding=num_embedding, dtype=resolve_dtype(dtype),
        generator=generator)


def define_D(input_nc, ndf, netD, n_layers_D=3, norm="batch",
             init_type="normal", init_gain=0.02, gpu_ids=(), dtype=None,
             generator: Optional[torch.Generator] = None):
    """The discriminator named by `netD`: "basic" (a 3-layer PatchGAN),
    "n_layers" (`n_layers_D` layers) or "pixel"; weights from
    `generator`."""
    from stinet_tpu_torch.models.gan_networks import (
        NLayerDiscriminator, PixelDiscriminator)
    dtype = resolve_dtype(dtype)
    if netD in ("basic", "n_layers"):
        return NLayerDiscriminator(
            input_nc=input_nc, ndf=ndf,
            n_layers=3 if netD == "basic" else n_layers_D, norm=norm,
            dtype=dtype, generator=generator)
    if netD == "pixel":
        return PixelDiscriminator(input_nc=input_nc, ndf=ndf, norm=norm,
                                  dtype=dtype, generator=generator)
    raise NotImplementedError(
        f"Discriminator model name {netD!r} is not recognized")


def count_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def resolve_dtype(dtype) -> Optional[torch.dtype]:
    """The compute dtype of a config: None for f32, torch.bfloat16 for
    "bfloat16" / "bf16"."""
    if dtype in (None, "float32", "f32", torch.float32):
        return None
    if dtype in ("bfloat16", "bf16", torch.bfloat16):
        return torch.bfloat16
    raise NotImplementedError(f"dtype {dtype!r}: float32 and bfloat16 are "
                              "ported")


def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX applies it to an array of `dtype`: it takes
    the array's dtype, so against a bf16 array it is rounded to bf16 first
    (torch would apply it in f32)."""
    if dtype == torch.bfloat16:
        return float(torch.tensor(value, dtype=dtype))
    return value
