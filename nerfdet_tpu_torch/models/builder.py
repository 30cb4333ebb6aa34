"""Build the port's models from a config's ``model`` dict.

Port of ``nerfdet_tpu/models/builder.py`` for the two ported types:
``"nerfdet"`` (``_build_nerfdet``) and ``"VoteNet"``
(``_build_votenet``). The config's ``pretrained='torchvision://...'`` is
not read: that is a download; weights come from a seed or a checkpoint.
"""

from __future__ import annotations

import torch
from torch import nn

from .nerfdet import NerfDet, SceneMeta
from .votenet import SCANNET_MEAN_SIZES, VoteNet


def _build_nerfdet(cfg: dict, meta: SceneMeta = None,
                   compute_dtype=torch.float32) -> NerfDet:
    backbone = cfg["backbone"]
    if backbone.get("type", "ResNet") != "ResNet":
        raise NotImplementedError("only the ResNet backbone is ported")
    if cfg.get("nerf_mode", "image") != "image":
        raise NotImplementedError("only the image nerf_mode is ported")
    if cfg.get("volume_type", "mean") != "mean":
        raise NotImplementedError("only the 'mean' volume_type is ported")
    neck, neck_3d, head = cfg["neck"], cfg["neck_3d"], cfg["bbox_head"]
    return NerfDet(
        backbone_depth=backbone.get("depth", 50),
        fpn_in_channels=tuple(neck["in_channels"]),
        fpn_out_channels=neck["out_channels"],
        neck3d_out_channels=neck_3d["out_channels"],
        neck3d_n_blocks=tuple(neck_3d["n_blocks"]),
        n_classes=head["n_classes"],
        head_n_reg_outs=head["n_reg_outs"],
        n_scales=head["n_scales"],
        head_limit=head.get("limit", 27),
        head_centerness_topk=head.get("centerness_topk", 18),
        n_voxels=tuple(cfg["n_voxels"]),
        voxel_size=tuple(cfg["voxel_size"]),
        near_far_range=tuple(cfg["near_far_range"]),
        n_samples=cfg.get("N_samples", 64),
        n_rand=cfg.get("N_rand", 2048),
        squeeze_scale=cfg.get("squeeze_scale", 4),
        nerf_density=cfg.get("nerf_density", False),
        meta=meta or SceneMeta(),
        compute_dtype=compute_dtype,
    )


def _build_votenet(cfg: dict, meta: SceneMeta = None,
                   compute_dtype=torch.float32) -> VoteNet:
    """Point-cloud VoteNet; ``meta`` is not used. The IoU loss weight
    belongs to training and is not read. It computes in float32 only."""
    if compute_dtype != torch.float32:
        raise NotImplementedError("VoteNet computes in float32 only")
    head = cfg.get("bbox_head", {})
    coder = head.get("bbox_coder", {})
    return VoteNet(
        num_classes=head.get("num_classes", 18),
        num_dir_bins=coder.get("num_dir_bins", 1),
        with_rot=coder.get("with_rot", False),
        mean_sizes=tuple(tuple(m) for m in coder.get(
            "mean_sizes", SCANNET_MEAN_SIZES)),
        num_proposal=head.get("num_proposal", 256),
        backbone_cfg=cfg.get("backbone_cfg"),
    )


_BUILDERS = {"nerfdet": _build_nerfdet, "VoteNet": _build_votenet}


def build_model(cfg: dict, meta: SceneMeta = None,
                compute_dtype=torch.float32) -> nn.Module:
    """The model of ``cfg`` computing in ``compute_dtype`` (float32, or
    bfloat16 for NeRF-Det: the JAX package's ``--bf16`` path); its
    parameters are float32 either way."""
    builder = _BUILDERS.get(cfg["type"])
    if builder is None:
        raise NotImplementedError(
            f"model type {cfg['type']!r} is not ported; ported: "
            f"{sorted(_BUILDERS)}")
    return builder(cfg, meta, compute_dtype)
