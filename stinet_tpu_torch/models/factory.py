"""Generator factory with the config surface of the reference define_G
(and of `stinet_tpu/models/factory.py`). Only the STINet branch is ported.
Knobs that only shape training or the reference's torch setup (init type
and gain, GPU ids, checkpointing, remat, dropout) are accepted so a config's
archs section passes unchanged, and have no effect on inference."""
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
        raise NotImplementedError("the 2D Resnet generator is not ported yet")
    if use_label_embedding:
        raise NotImplementedError("label embedding is not ported yet")
    if dtype not in (None, "float32", "f32", torch.float32):
        raise NotImplementedError(f"dtype {dtype!r}: only float32 is ported")
    from stinet_tpu_torch.models.stinet import SurfaceTextureInpaintingNet
    return SurfaceTextureInpaintingNet(
        input_nc=input_nc, output_nc=output_nc, ngf=ngf,
        filter_type=filter_type, norm=norm, n_blocks=n_blocks,
        n_levels=n_levels, n_repeated_io_convs=n_repeated_io_convs,
        pooling_type=pooling_type, dilations=dilations, generator=generator)
