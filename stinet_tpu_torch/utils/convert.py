"""Carry model weights from the JAX package to the port: STINet's
(`state_dict_from_jax_params`), SingleConvMeshNet's
(`seg_state_dict_from_jax_params`), Resnet2D's and the GAN zoo's
(`resnet2d_state_dict_from_jax_params`), and the 2D trainer's perceptual
nets' (`inception_state_dict_from_jax_variables`,
`lpips_state_dict_from_jax_variables`), so the port runs the random
features a JAX trainer drew under `allow_random_features`.

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


def seg_state_dict_from_jax_params(params, batch_stats
                                   ) -> Dict[str, torch.Tensor]:
    """Flax params and batch_stats of a `stinet_tpu` SingleConvMeshNet ->
    the port's state dict (models/singleconvmeshnet.py), CPU f32 tensors.
    The module paths are the same on both sides; the leaves map as

      <blk>/filter_{i}/lin{1,2}_kernel       -> <blk>.filter_{i}.lin{1,2}.weight
      <blk>/filter_{i}/bn{1,2}/{scale,bias}  -> ...bn{1,2}.{weight,bias}
      batch_stats <...>/bn{1,2}/{mean,var}   -> ...bn{1,2}.running_{mean,var}
      head_lin{1,2}/{kernel,bias}            -> head_lin{1,2}.{weight,bias}
      head_bn/{scale,bias}, batch_stats head_bn/{mean,var}
                                             -> head_bn.{weight,bias,
                                                running_mean,running_var}

    with <blk> one of left_{l}, right_{l}; kernels are transposed. Anything
    else raises rather than being dropped."""
    out = {}

    def bn(prefix, leaves, stats):
        names = {"scale": "weight", "bias": "bias"}
        for leaf, val in leaves.items():
            if leaf not in names:
                raise ValueError(f"unexpected batch norm leaf "
                                 f"{prefix}/{leaf}")
            out[f"{prefix}.{names[leaf]}"] = _tensor(val, False)
        if set(stats) != {"mean", "var"}:
            raise ValueError(f"batch norm {prefix} needs its batch_stats "
                             f"mean and var, got {sorted(stats)}")
        out[f"{prefix}.running_mean"] = _tensor(stats["mean"], False)
        out[f"{prefix}.running_var"] = _tensor(stats["var"], False)

    for top, sub in params.items():
        if top in ("head_lin1", "head_lin2"):
            _dense(top, sub, out)
        elif top == "head_bn":
            bn(top, sub, batch_stats.get(top, {}))
        elif top.rpartition("_")[0] in ("left", "right") \
                and top.rpartition("_")[2].isdigit():
            for filt, leaves in sub.items():
                kind, _, i = filt.rpartition("_")
                if kind != "filter" or not i.isdigit():
                    raise ValueError(f"no port layer for {top}/{filt}")
                prefix = f"{top}.{filt}"
                stats = batch_stats.get(top, {}).get(filt, {})
                for leaf, val in leaves.items():
                    if leaf in ("lin1_kernel", "lin2_kernel"):
                        out[f"{prefix}.{leaf[:4]}.weight"] = _tensor(val,
                                                                     True)
                    elif leaf in ("bn1", "bn2"):
                        bn(f"{prefix}.{leaf}", val, stats.get(leaf, {}))
                    else:
                        raise ValueError(f"unexpected filter leaf "
                                         f"{top}/{filt}/{leaf}")
        else:
            raise ValueError(f"no port layer for params entry {top!r}")
    return out


def _hwio_to_oihw(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(
        np.asarray(a, dtype=np.float32).transpose(3, 2, 0, 1)))


def inception_state_dict_from_jax_variables(variables
                                            ) -> Dict[str, torch.Tensor]:
    """Flax variables ({"params", "batch_stats"}) of the JAX package's FID
    InceptionV3 -> the port's state dict (models/inception.py, pytorch-fid
    keys), the inverse of the JAX package's `convert_torch_state_dict`:

      <path>/Conv_0/kernel          -> <path>.conv.weight (HWIO -> OIHW)
      <path>/BatchNorm_0/scale      -> <path>.bn.weight
      <path>/BatchNorm_0/bias       -> <path>.bn.bias
      batch_stats <path>/BatchNorm_0/{mean,var}
                                    -> <path>.bn.running_{mean,var}

    with <path> the module path joined by dots (Conv2d_1a_3x3,
    Mixed_5b.branch1x1, ...), and every `<path>.bn.num_batches_tracked`
    0. Anything else raises rather than being dropped."""
    out = {}

    def walk(tree, path, stats):
        for name, sub in tree.items():
            if name == "Conv_0":
                if set(sub) != {"kernel"}:
                    raise ValueError(f"unexpected conv leaves {path}: "
                                     f"{sorted(sub)}")
                out[f"{path}.conv.weight"] = _hwio_to_oihw(sub["kernel"])
            elif name == "BatchNorm_0":
                st = stats.get(name, {})
                if set(sub) != {"scale", "bias"} or set(st) != {"mean",
                                                                "var"}:
                    raise ValueError(f"unexpected batch norm leaves {path}: "
                                     f"{sorted(sub)}, stats {sorted(st)}")
                out[f"{path}.bn.weight"] = _tensor(sub["scale"], False)
                out[f"{path}.bn.bias"] = _tensor(sub["bias"], False)
                out[f"{path}.bn.running_mean"] = _tensor(st["mean"], False)
                out[f"{path}.bn.running_var"] = _tensor(st["var"], False)
                out[f"{path}.bn.num_batches_tracked"] = torch.tensor(0)
            elif isinstance(sub, dict):
                walk(sub, f"{path}.{name}" if path else name,
                     stats.get(name, {}))
            else:
                raise ValueError(f"unexpected InceptionV3 leaf "
                                 f"{path}/{name}")

    walk(variables["params"], "", variables.get("batch_stats", {}))
    return out


def lpips_state_dict_from_jax_variables(variables, lins=None
                                        ) -> Dict[str, torch.Tensor]:
    """Flax variables of the JAX package's LPIPS AlexNet trunk (and its
    list of head weights, or None) -> the port's LPIPS state dict
    (metrics/lpips.py):

      conv_{i}/kernel  -> alex.features.{0,3,6,8,10}[i].weight (HWIO -> OIHW)
      conv_{i}/bias    -> alex.features.{...}[i].bias
      lins[i]          -> lin{i}

    Anything else raises rather than being dropped."""
    from stinet_tpu_torch.metrics.lpips import _TORCH_IDX
    out = {}
    for name, leaves in variables["params"].items():
        kind, _, i = name.rpartition("_")
        if kind != "conv" or not i.isdigit() or int(i) >= len(_TORCH_IDX) \
                or set(leaves) != {"kernel", "bias"}:
            raise ValueError(f"no port layer for LPIPS entry {name!r}")
        ti = _TORCH_IDX[int(i)]
        out[f"alex.features.{ti}.weight"] = _hwio_to_oihw(leaves["kernel"])
        out[f"alex.features.{ti}.bias"] = _tensor(leaves["bias"], False)
    for i, w in enumerate(lins or ()):
        out[f"lin{i}"] = _tensor(np.asarray(w).reshape(-1), False)
    return out


# flax's auto-name prefix -> the port's list of that kind of layer
# (models/resnet2d.py)
_CONV2D_LISTS = {"Conv": "convs", "ConvTranspose": "tconvs",
                 "ForwardConv": "fconvs", "Norm2D": "norms",
                 "ResnetBlock2D": "blocks"}


def resnet2d_state_dict_from_jax_params(params, batch_stats=None
                                        ) -> Dict[str, torch.Tensor]:
    """Flax params (and, for norm="batch", the `batch_stats` collection)
    of a `stinet_tpu` Resnet2D, ResnetGenerator, UnetGenerator,
    NLayerDiscriminator or PixelDiscriminator -> the port's state dict
    (models/resnet2d.py, models/gan_networks.py), CPU f32 tensors. Module
    paths map by kind and index (`Conv_k` -> `convs.k`, ...), and the
    leaves as

      Conv_k/kernel           -> convs.k.weight (HWIO -> OIHW)
      ConvTranspose_k/kernel  -> tconvs.k.weight (flipped in space, HWIO ->
                                 IOHW: flax's transposed convolution does
                                 not flip its kernel, torch's does)
      */bias                  -> *.bias
      Norm2D_k/BatchNorm_0/{scale,bias}
                              -> norms.k.{weight,bias}
      batch_stats Norm2D_k/BatchNorm_0/{mean,var}
                              -> norms.k.running_{mean,var}

    Every leaf, batch statistics included, is taken exactly once;
    anything else raises rather than being dropped."""
    batch_stats = batch_stats or {}
    out, stats_used = {}, set()

    def conv(path, leaves, transposed):
        for leaf, val in leaves.items():
            if leaf == "bias":
                out[f"{path}.bias"] = _tensor(val, False)
            elif leaf == "kernel" and transposed:
                k = np.asarray(val, dtype=np.float32)[::-1, ::-1]
                out[f"{path}.weight"] = torch.tensor(
                    np.ascontiguousarray(k.transpose(2, 3, 0, 1)))
            elif leaf == "kernel":
                out[f"{path}.weight"] = _hwio_to_oihw(val)
            else:
                raise ValueError(f"unexpected conv leaf {path}/{leaf}")

    def walk(tree, stats, names, path):
        for name, sub in tree.items():
            kind, _, i = name.rpartition("_")
            if kind not in _CONV2D_LISTS or not i.isdigit():
                raise ValueError(
                    f"no port layer for {'/'.join(names + [name])}")
            port = f"{path}{_CONV2D_LISTS[kind]}.{i}"
            st = stats.get(name, {})
            if kind in ("Conv", "ConvTranspose"):
                conv(port, sub, kind == "ConvTranspose")
            elif kind == "Norm2D":
                bn, bn_st = sub.get("BatchNorm_0", {}), st.get(
                    "BatchNorm_0", {})
                if set(sub) != {"BatchNorm_0"} or set(bn) != {
                        "scale", "bias"} or set(bn_st) != {"mean", "var"}:
                    raise ValueError(f"batch norm {port}: params "
                                     f"{sorted(sub)} {sorted(bn)}, stats "
                                     f"{sorted(bn_st)}")
                out[f"{port}.weight"] = _tensor(bn["scale"], False)
                out[f"{port}.bias"] = _tensor(bn["bias"], False)
                out[f"{port}.running_mean"] = _tensor(bn_st["mean"], False)
                out[f"{port}.running_var"] = _tensor(bn_st["var"], False)
                stats_used.add(tuple(names + [name]))
            else:
                walk(sub, st, names + [name], port + ".")

    walk(params, batch_stats, [], "")

    def norm_paths(tree, names):
        for name, sub in tree.items():
            if name == "BatchNorm_0":
                yield tuple(names)
            elif hasattr(sub, "items"):
                yield from norm_paths(sub, names + [name])
            else:
                yield tuple(names + [name])

    extra = set(norm_paths(batch_stats, [])) - stats_used
    if extra:
        raise ValueError(f"batch_stats without a port layer: {sorted(extra)}")
    return out
