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
  already holds its frozen norms folded).

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


def _mlp(out: Dict, key: str, p: Mapping) -> None:
    for name, layer in p.items():
        if name == "output":
            _linear(out, f"{key}.output_layer", layer)
        else:
            i = name[len("hidden_"):]
            _linear(out, f"{key}.hidden_layers.{i}", layer)


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX NerfDet ``{"params", "batch_stats"}`` -> the port's
    state_dict (float32 CPU tensors)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    _backbone(out, params["backbone"])
    for name, layer in params["neck"].items():
        kind, i = name.rsplit("_", 1)
        group = "lateral_convs" if kind == "lateral" else "fpn_convs"
        _conv(out, f"neck.{group}.{i}.conv", layer)
    _neck3d(out, params["neck_3d"], stats["neck_3d"])
    head = params["bbox_head"]
    for name in ("centerness_conv", "reg_conv", "cls_conv"):
        _conv(out, f"bbox_head.{name}", head[name])
    for i, s in enumerate(_np32(head["scales"])):
        out[f"bbox_head.scales.{i}.scale"] = torch.tensor(float(s))
    for name, sub in params["nerf_mlp"]["mlp"].items():
        _mlp(out, f"nerf_mlp.mlp.{name}", sub)
    _linear(out, "mapping.0", params["mapping"])
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
    modules the port does not build (the volume-mode mappings, the
    reference's unused towers) are dropped, and every key the model has
    must be present."""
    converted = from_reference_state_dict(state)
    own = model.state_dict()
    model.load_state_dict({k: v for k, v in converted.items() if k in own},
                          strict=True)
