"""Build the port's NeRF-Det from a config's ``model`` dict.

Port of ``nerfdet_tpu/models/builder.py:_build_nerfdet`` (NeRF-Det
only). The config's ``pretrained='torchvision://...'`` is not read: that
is a download; weights come from a seed or a checkpoint.
"""

from __future__ import annotations

from .nerfdet import NerfDet, SceneMeta


def build_model(cfg: dict, meta: SceneMeta = None) -> NerfDet:
    if cfg["type"] != "nerfdet":
        raise NotImplementedError(
            f"model type {cfg['type']!r} is not ported; only 'nerfdet' is")
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
        n_voxels=tuple(cfg["n_voxels"]),
        voxel_size=tuple(cfg["voxel_size"]),
        squeeze_scale=cfg.get("squeeze_scale", 4),
        nerf_density=cfg.get("nerf_density", False),
        meta=meta or SceneMeta(),
    )
