"""Weights into the port: from JAX variable trees and reference checkpoints.

``from_jax_variables`` maps the JAX package's ``{"params",
"batch_stats"}`` trees (as numpy) onto the port's state_dict:

* conv kernels HWIO -> OIHW and DHWIO -> OIDHW;
* the transposed 3D conv: flax keeps (D, H, W, in, out) with the
  spatial dims mirrored (the inverse of
  ``nerfdet_tpu/utils/weight_convert.py:convert_neck3d``), torch
  (in, out, D, H, W);
* dense kernels (in, out) -> (out, in);
* the 3D neck's BatchNorm scale/bias + running mean/var;
* the backbone's FrozenAffine scale/bias as they are (the JAX package
  already holds its frozen norms folded);
* for VoteNet, every dense layer and BatchNorm under its own flax path
  (``backbone/sa{i}/mlp/fc{j}``, ``bbox_head/vote_module/bn{i}``, ...),
  the port's module names being the flax names;
* the Swin backbone under its flax names too (``nn/swin.py``): the patch
  embedding's kernel HWIO -> OIHW, dense kernels transposed, each
  LayerNorm's scale and bias as weight and bias, the relative position
  bias tables as they are;
* in volume mode (a tree without ``mapping``, which only image mode
  calls) its ``mean_mapping`` / ``cov_mapping`` (1x1x1 convs); a tree
  with both, as ``convert_reference_checkpoint`` writes one, is an
  image-mode model's;
* the indoor ImVoxelNet (a tree without ``nerf_mlp``): the Atlas neck
  (``neck_3d/model/...``, ``out_conv_{i}``, ``out_norm_{i}``) under its
  flax names, every conv DHWIO -> OIDHW with its bias, every BatchNorm
  with its statistics; the V1 head's towers (``reg_convs/conv_{i}``,
  ``norm_{i}``) likewise; the fast neck and the heads' convs and
  ``scales`` as NeRF-Det's.

Every mapping of ``from_jax_variables`` is a permutation (a transpose, a
spatial flip) or a copy, so a JAX gradient tree, given as ``params``
with zero ``batch_stats``, maps onto the port's gradients the same way
(``tests/test_torch_train.py`` compares the train steps' gradients so).

``from_reference_state_dict`` takes a reference NeRF-Det state_dict,
whose keys the port's module names follow, and folds the backbone's
frozen BatchNorms into scale/bias the same way.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(_np32(x), order="C", copy=True))


def conv_weight(kernel) -> torch.Tensor:
    """HWIO -> OIHW, DHWIO -> OIDHW."""
    k = _np32(kernel)
    nd = k.ndim - 2
    return _t(np.transpose(k, (nd + 1, nd) + tuple(range(nd))))


def conv_transpose3d_weight(kernel) -> torch.Tensor:
    """flax ConvTranspose (D, H, W, in, out), spatially mirrored ->
    torch ConvTranspose3d (in, out, D, H, W)."""
    k = _np32(kernel)[::-1, ::-1, ::-1]
    return _t(np.transpose(k, (3, 4, 0, 1, 2)))


def linear_weight(kernel) -> torch.Tensor:
    return _t(_np32(kernel).T)


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    """Frozen BatchNorm -> (scale, bias), float32 numpy."""
    gamma, beta, mean, var = (_np32(a) for a in (gamma, beta, mean, var))
    scale = gamma / np.sqrt(var + eps)
    return scale, beta - mean * scale


def _bn(out: Dict, key: str, params: Mapping, stats: Mapping) -> None:
    out[f"{key}.weight"] = _t(params["scale"])
    out[f"{key}.bias"] = _t(params["bias"])
    out[f"{key}.running_mean"] = _t(stats["mean"])
    out[f"{key}.running_var"] = _t(stats["var"])
    out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _affine(out: Dict, key: str, params: Mapping) -> None:
    out[f"{key}.scale"] = _t(params["scale"])
    out[f"{key}.bias"] = _t(params["bias"])


def _conv(out: Dict, key: str, params: Mapping) -> None:
    out[f"{key}.weight"] = conv_weight(params["kernel"])
    if "bias" in params:
        out[f"{key}.bias"] = _t(params["bias"])


def _linear(out: Dict, key: str, params: Mapping) -> None:
    out[f"{key}.weight"] = linear_weight(params["kernel"])
    if "bias" in params:
        out[f"{key}.bias"] = _t(params["bias"])


def _backbone(out: Dict, p: Mapping) -> None:
    _conv(out, "backbone.conv1", p["conv1"])
    _affine(out, "backbone.bn1", p["bn1"])
    for name, blk in p.items():
        if not name.startswith("layer"):
            continue
        stage, b = name[len("layer"):].split("_")
        pre = f"backbone.layer{stage}.{b}"
        for j in (1, 2, 3):
            _conv(out, f"{pre}.conv{j}", blk[f"conv{j}"])
            _affine(out, f"{pre}.bn{j}", blk[f"bn{j}"])
        if "downsample_conv" in blk:
            _conv(out, f"{pre}.downsample.0", blk["downsample_conv"])
            _affine(out, f"{pre}.downsample.1", blk["downsample_bn"])


def _neck3d(out: Dict, p: Mapping, s: Mapping) -> None:
    for name, blk in p.items():
        kind, rest = name.split("_", 1)
        st = s[name]
        if kind == "down":
            i, b = rest.split("_")
            pre = f"neck_3d.down_layer_{i}.{b}"
            for j in (1, 2):
                _conv(out, f"{pre}.conv{j}", blk[f"conv{j}"])
                _bn(out, f"{pre}.norm{j}", blk[f"norm{j}"], st[f"norm{j}"])
            if "downsample_conv" in blk:
                _conv(out, f"{pre}.downsample.0", blk["downsample_conv"])
                _bn(out, f"{pre}.downsample.1", blk["downsample_norm"],
                    st["downsample_norm"])
        elif kind == "up":
            pre = f"neck_3d.up_block_{rest}"
            out[f"{pre}.0.weight"] = conv_transpose3d_weight(
                blk["up_conv"]["kernel"])
            _bn(out, f"{pre}.1", blk["up_norm"], st["up_norm"])
            _conv(out, f"{pre}.3", blk["conv"])
            _bn(out, f"{pre}.4", blk["norm"], st["norm"])
        else:
            pre = f"neck_3d.out_block_{rest}"
            _conv(out, f"{pre}.0", blk["conv"])
            _bn(out, f"{pre}.1", blk["norm"], st["norm"])


def _swin_tree(out: Dict, prefix: str, p: Mapping) -> None:
    """The Swin backbone's flax tree under its own names: a node with a
    4-d ``kernel`` is the patch embedding (a conv), with a 2-d one a
    Dense, with a ``scale`` a LayerNorm."""
    for name, sub in p.items():
        key = f"{prefix}.{name}"
        if not hasattr(sub, "items"):  # relative_position_bias_table
            out[key] = _t(sub)
        elif "kernel" in sub:
            (_conv if np.ndim(sub["kernel"]) == 4 else _linear)(out, key, sub)
        elif "scale" in sub:
            out[f"{key}.weight"] = _t(sub["scale"])
            out[f"{key}.bias"] = _t(sub["bias"])
        else:
            _swin_tree(out, key, sub)


def _mlp(out: Dict, key: str, p: Mapping) -> None:
    for name, layer in p.items():
        if name == "output":
            _linear(out, f"{key}.output_layer", layer)
        else:
            i = name[len("hidden_"):]
            _linear(out, f"{key}.hidden_layers.{i}", layer)


def _layer_bn_tree(out: Dict, prefix: str, p: Mapping, s: Mapping,
                   layer=_linear) -> None:
    """Layers and BatchNorms of a flax tree under their own path: a node
    with a ``kernel`` is a ``layer`` (``_linear`` for Dense, ``_conv`` for
    convs), one with batch statistics a BatchNorm."""
    for name, sub in p.items():
        key = f"{prefix}.{name}"
        if "kernel" in sub:
            layer(out, key, sub)
        elif "mean" in s.get(name, {}):
            _bn(out, key, sub, s[name])
        else:
            _layer_bn_tree(out, key, sub, s.get(name, {}), layer)


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX NerfDet, IndoorImVoxelNet or VoteNet ``{"params",
    "batch_stats"}`` -> the port's state_dict (float32 CPU tensors)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    if "sa0" in params["backbone"]:  # VoteNet: PointNet++ levels
        for name in ("backbone", "bbox_head"):
            _layer_bn_tree(out, name, params[name], stats.get(name, {}))
        return out
    if "patch_embed" in params["backbone"]:
        _swin_tree(out, "backbone", params["backbone"])
    else:
        _backbone(out, params["backbone"])
    for name, layer in params["neck"].items():
        kind, i = name.rsplit("_", 1)
        group = "lateral_convs" if kind == "lateral" else "fpn_convs"
        _conv(out, f"neck.{group}.{i}.conv", layer)
    if "model" in params["neck_3d"]:  # the Atlas neck
        _layer_bn_tree(out, "neck_3d", params["neck_3d"], stats["neck_3d"],
                       _conv)
    else:
        _neck3d(out, params["neck_3d"], stats["neck_3d"])
    head = params["bbox_head"]
    for name in ("centerness_conv", "reg_conv", "cls_conv"):
        _conv(out, f"bbox_head.{name}", head[name])
    for name in ("reg_convs", "cls_convs"):  # the V1 head's towers
        if name in head:
            _layer_bn_tree(out, f"bbox_head.{name}", head[name],
                           stats["bbox_head"][name], _conv)
    for i, s in enumerate(_np32(head["scales"])):
        out[f"bbox_head.scales.{i}.scale"] = torch.tensor(float(s))
    if "nerf_mlp" not in params:  # the indoor ImVoxelNet
        return out
    for name, sub in params["nerf_mlp"]["mlp"].items():
        _mlp(out, f"nerf_mlp.mlp.{name}", sub)
    if "mapping" in params:  # image mode: volume mode never calls it
        _linear(out, "mapping.0", params["mapping"])
    else:  # volume mode: its init holds the 1x1x1 volume mappings
        for name in ("mean_mapping", "cov_mapping"):
            _conv(out, f"{name}.0", params[name])
    return out


def from_reference_state_dict(state: Mapping) -> Dict[str, torch.Tensor]:
    """Reference NeRF-Det state_dict -> the port's keys: the backbone's
    frozen BatchNorms fold into FrozenAffine scale/bias; every other
    tensor is kept under its own key (the caller drops the reference's
    modules the port does not have)."""
    out: Dict[str, torch.Tensor] = {}
    frozen = {k[:-len(".running_mean")] for k in state
              if k.startswith("backbone.") and k.endswith(".running_mean")}
    for k, v in state.items():
        prefix, _, leaf = k.rpartition(".")
        if prefix in frozen:
            if leaf == "weight":
                scale, bias = fold_bn(state[f"{prefix}.weight"],
                                      state[f"{prefix}.bias"],
                                      state[f"{prefix}.running_mean"],
                                      state[f"{prefix}.running_var"])
                out[f"{prefix}.scale"] = _t(scale)
                out[f"{prefix}.bias"] = _t(bias)
            continue
        out[k] = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
    return out


def load_reference_state_dict(model: torch.nn.Module, state: Mapping) -> None:
    """Load a reference state_dict into the port's model; keys of
    modules the port does not build (the volume-mode mappings in image
    mode, ``mapping`` in volume mode, the reference's unused towers) are
    dropped, and every key the model has must be present. A model with
    the Swin backbone is refused: the JAX package's
    ``convert_reference_checkpoint`` converts ResNet backbones only."""
    from ..nn.swin import SwinTransformer

    if isinstance(getattr(model, "backbone", None), SwinTransformer):
        raise NotImplementedError(
            "reference checkpoints with the Swin backbone are not converted "
            "(the JAX package's convert_reference_checkpoint reads ResNet "
            "backbones only)")
    converted = from_reference_state_dict(state)
    own = model.state_dict()
    model.load_state_dict({k: v for k, v in converted.items() if k in own},
                          strict=True)
