"""Read the reference's own STINet checkpoints (`.pth`).

The reference saves `{"archs", "state_dicts": {"graph": state_dict}, ...}`
(a trainer's checkpoint) or `{"state_dict": state_dict}`, and
`load_reference_state_dict` returns that state dict as it is, read as
`stinet_tpu/utils/convert_reference_checkpoint.py` reads it. The port's
parameter names are the reference's (`input_blocks.0.first_filter.nn.0
.weight`, `bottleneck_blocks.3.first_norm.module.running_mean`, ...), so
the state dict loads one to one, with `load_state_dict(strict=True)`:
nothing is renamed, and a missing or an unexpected key raises. To serve
it:

    model = define_G(**archs_args)
    server = SceneInpainter(model, load_reference_state_dict(path))
    colors = server.predict(scene)
"""
import torch


def load_reference_state_dict(path, model_key: str = "graph"):
    """The state dict of model `model_key` in the reference checkpoint at
    `path`: `ckpt["state_dicts"][model_key]` where the file has
    `state_dicts`, else `ckpt["state_dict"]`; CPU tensors. The file is a
    pickle (`weights_only=False`, as the reference's own loader reads it):
    load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dicts" in ckpt:
        return ckpt["state_dicts"][model_key]
    return ckpt["state_dict"]
