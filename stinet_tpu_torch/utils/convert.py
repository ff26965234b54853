"""Carry STINet weights from the JAX package to the port.

`state_dict_from_jax_params` is the inverse of the JAX package's
`convert_stinet_state_dict` (stinet_tpu/utils/convert_reference_checkpoint
.py): it turns Flax params (a nested dict of arrays) into the port's state
dict, whose keys are the reference checkpoint's. Flax Dense kernels are
[in, out]; torch weights are [out, in], so every kernel is transposed.

  <b>_{i}/first_filter/lin1_kernel   -> <b>s.{i}.first_filter.nn.0.weight
  <b>_{i}/first_filter/lin1_bias     -> <b>s.{i}.first_filter.nn.0.bias
  <b>_{i}/first_filter/lin2/kernel   -> <b>s.{i}.first_filter.nn.2.weight
  <b>_{i}/first_filter/lin2/bias     -> <b>s.{i}.first_filter.nn.2.bias
  <b>_{i}/shortcut/{kernel,bias}     -> <b>s.{i}.shortcut.{weight,bias}
  final_linear{1,2}/{kernel,bias}    -> final_linear{1,2}.{weight,bias}

with <b> one of input_block, encoder_block, bottleneck_block, decoder_block,
output_block.

Only the parameters of the ported layers convert (instance norm has none);
anything else raises rather than being dropped.
"""
from typing import Dict

import numpy as np
import torch

_BLOCKS = {"input_block": "input_blocks", "encoder_block": "encoder_blocks",
           "bottleneck_block": "bottleneck_blocks",
           "decoder_block": "decoder_blocks", "output_block": "output_blocks"}


def _tensor(a, transpose: bool) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))


def _dense(prefix: str, leaves: Dict, out: Dict) -> None:
    for name, val in leaves.items():
        if name == "kernel":
            out[f"{prefix}.weight"] = _tensor(val, True)
        elif name == "bias":
            out[f"{prefix}.bias"] = _tensor(val, False)
        else:
            raise ValueError(f"unexpected Dense leaf {prefix}/{name}")


def state_dict_from_jax_params(params) -> Dict[str, torch.Tensor]:
    """Flax params of a `stinet_tpu` SurfaceTextureInpaintingNet -> the
    port's state dict (CPU float32 tensors)."""
    out = {}
    for top, sub in params.items():
        if top in ("final_linear1", "final_linear2"):
            _dense(top, sub, out)
            continue
        kind, _, idx = top.rpartition("_")
        if kind not in _BLOCKS or not idx.isdigit():
            raise ValueError(f"no port layer for params entry {top!r}")
        prefix = f"{_BLOCKS[kind]}.{idx}"
        for name, leaves in sub.items():
            if name == "shortcut":
                _dense(f"{prefix}.shortcut", leaves, out)
            elif name == "first_filter":
                ff = f"{prefix}.first_filter.nn"
                for leaf, val in leaves.items():
                    if leaf == "lin1_kernel":
                        out[f"{ff}.0.weight"] = _tensor(val, True)
                    elif leaf == "lin1_bias":
                        out[f"{ff}.0.bias"] = _tensor(val, False)
                    elif leaf == "lin2":
                        _dense(f"{ff}.2", val, out)
                    else:
                        raise ValueError(f"unexpected filter leaf "
                                         f"{top}/first_filter/{leaf}")
            else:
                raise ValueError(f"no port layer for {top}/{name}")
    return out
