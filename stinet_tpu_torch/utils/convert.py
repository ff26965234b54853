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
output_block. The norms (`<n>` = <b>s.{i}.first_norm or final_norm1; the
JAX model's own names, stinet_tpu/models/stinet.py:71-86):

  graph: <N>/{weight,bias,mean_scale} -> <n>.{weight,bias,mean_scale}
  batch: <N>/scale                    -> <n>.module.weight
         <N>/bias                     -> <n>.module.bias
         batch_stats <N>/{mean,var}   -> <n>.module.running_{mean,var}

and every batch norm gets `<n>.module.num_batches_tracked` = 0 (JAX keeps
no count; with a fixed momentum nothing reads it). Instance norm has no
parameters. Anything else raises rather than being dropped.
"""
from typing import Dict

import numpy as np
import torch

_BLOCKS = {"input_block": "input_blocks", "encoder_block": "encoder_blocks",
           "bottleneck_block": "bottleneck_blocks",
           "decoder_block": "decoder_blocks", "output_block": "output_blocks"}


def _tensor(a, transpose: bool) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    return torch.tensor(np.ascontiguousarray(a.T if transpose else a))


def _dense(prefix: str, leaves: Dict, out: Dict) -> None:
    for name, val in leaves.items():
        if name == "kernel":
            out[f"{prefix}.weight"] = _tensor(val, True)
        elif name == "bias":
            out[f"{prefix}.bias"] = _tensor(val, False)
        else:
            raise ValueError(f"unexpected Dense leaf {prefix}/{name}")


def _norm(prefix: str, leaves: Dict, stats: Dict, out: Dict) -> None:
    if "scale" in leaves:   # batch norm: PyG's wrapper keeps `module`
        m = f"{prefix}.module"
        if "mean" not in stats or "var" not in stats:
            raise ValueError(f"batch norm {prefix} needs its batch_stats")
        names = {"scale": f"{m}.weight", "bias": f"{m}.bias"}
        out[f"{m}.running_mean"] = _tensor(stats["mean"], False)
        out[f"{m}.running_var"] = _tensor(stats["var"], False)
        out[f"{m}.num_batches_tracked"] = torch.tensor(0)
    else:
        names = {k: f"{prefix}.{k}" for k in ("weight", "bias", "mean_scale")}
    for name, val in leaves.items():
        if name not in names:
            raise ValueError(f"unexpected norm leaf {prefix}/{name}")
        out[names[name]] = _tensor(val, False)


def state_dict_from_jax_params(params, batch_stats=None
                               ) -> Dict[str, torch.Tensor]:
    """Flax params (and, for norm="batch", the `batch_stats` collection) of
    a `stinet_tpu` SurfaceTextureInpaintingNet -> the port's state dict
    (CPU tensors, float32 but for the batch counts)."""
    batch_stats = batch_stats or {}
    out = {}
    for top, sub in params.items():
        if top in ("final_linear1", "final_linear2"):
            _dense(top, sub, out)
            continue
        if top == "final_norm1":
            _norm(top, sub, batch_stats.get(top, {}), out)
            continue
        kind, _, idx = top.rpartition("_")
        if kind not in _BLOCKS or not idx.isdigit():
            raise ValueError(f"no port layer for params entry {top!r}")
        prefix = f"{_BLOCKS[kind]}.{idx}"
        for name, leaves in sub.items():
            if name == "shortcut":
                _dense(f"{prefix}.shortcut", leaves, out)
            elif name == "first_norm":
                _norm(f"{prefix}.first_norm", leaves,
                      batch_stats.get(top, {}).get(name, {}), out)
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
