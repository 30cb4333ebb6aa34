"""Build the port's models from a config's ``model`` dict.

Port of ``nerfdet_tpu/models/builder.py`` for the ported types:
``"nerfdet"`` (``_build_nerfdet``), ``"VoteNet"`` (``_build_votenet``),
``"imvoxelnet"`` (the NeRF-Det graph with ``nerf_density`` off,
``_build_imvoxelnet``) and ``"ImVoxelNet"`` with an indoor 3D neck
(``_build_imvoxelnet_ref``): with a NeRF key the NeRF-Det graph (the
fast_cov family), without one the indoor ImVoxelNet
(``models/imvoxelnet_indoor.py``, the SUN RGB-D configs' yawed heads
too). The outdoor ImVoxelNet, the layout head and training the SUN RGB-D
heads are refused by name.
The config's ``pretrained`` is not read: that is a download; weights come
from a seed or a checkpoint. Keys the JAX builder reads nowhere
(``pc_supervise``, ``overfit_nerfmlp``, ``nerf_sample_view``, ...) stay
unread here too.
"""

from __future__ import annotations

import torch
from torch import nn

from .imvoxelnet_indoor import (INDOOR_NECKS, build_imvoxelnet_indoor,
                                indoor_refusal)
from .nerfdet import NerfDet, SceneMeta
from .votenet import SCANNET_MEAN_SIZES, VoteNet


# the SwinTransformer keys the JAX builder passes on
SWIN_KEYS = ("embed_dims", "patch_size", "window_size", "mlp_ratio",
             "depths", "num_heads", "out_indices", "qkv_bias")


def _build_nerfdet(cfg: dict, meta: SceneMeta = None,
                   compute_dtype=torch.float32) -> NerfDet:
    backbone = cfg["backbone"]
    btype = backbone.get("type", "ResNet")
    swin_cfg = None
    if btype == "SwinTransformer":
        swin_cfg = {k: tuple(v) if isinstance(v, list) else v
                    for k, v in backbone.items() if k in SWIN_KEYS}
    neck, neck_3d, head = cfg["neck"], cfg["neck_3d"], cfg["bbox_head"]
    return NerfDet(
        backbone_type=btype,
        backbone_cfg=swin_cfg,
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
        nerf_mode=cfg.get("nerf_mode", "image"),
        volume_type=cfg.get("volume_type", "mean"),
        **({"aabb": tuple(tuple(x) for x in cfg["aabb"])}
           if "aabb" in cfg else {}),
        # JAX's data path ships the host rgb sums and ray stream for the
        # nerfdet type only (nerfdet_tpu/data/dataset.py, the *_spec_from
        # _config functions): the ImVoxelNet-typed configs keep them on
        # the device
        host_streams=cfg["type"] == "nerfdet",
        meta=meta or SceneMeta(),
        compute_dtype=compute_dtype,
    )


NERF_KEYS = ("volume_type", "nerf_mode", "nerf_density", "N_samples")


def _neck3d_type(cfg: dict) -> str:
    return cfg.get("neck_3d", {}).get("type", "KittiImVoxelNeck")


def routes_to_nerfdet(cfg: dict) -> bool:
    """Whether the model config builds the NeRF-Det graph: the
    ``nerfdet`` and ``imvoxelnet`` types, or JAX's ``ImVoxelNet`` rule:
    an indoor 3D neck (``ImVoxelNeck``, ``FastIndoorImVoxelNeck``) with
    any NeRF key (the 56 fast_cov configs)."""
    if cfg["type"] in ("nerfdet", "imvoxelnet"):
        return True
    return (cfg["type"] == "ImVoxelNet" and _neck3d_type(cfg) in INDOOR_NECKS
            and any(k in cfg for k in NERF_KEYS))


def unported_refusal(cfg: dict):
    """Why the port cannot build, evaluate and train the model config,
    naming its ROADMAP item, or None: the types it has no builder for,
    the outdoor ImVoxelNet, the indoor one's layout head."""
    if cfg["type"] not in _BUILDERS:
        return (f"model type {cfg['type']!r} is not ported; ported: "
                f"{sorted(_BUILDERS)}")
    if cfg["type"] != "ImVoxelNet" or routes_to_nerfdet(cfg):
        return None
    if _neck3d_type(cfg) not in INDOOR_NECKS:
        return (f"the outdoor ImVoxelNet (3D neck {_neck3d_type(cfg)!r}) is "
                f"not ported yet: ROADMAP §1 item 3 (after the SUN RGB-D "
                f"configs)")
    return indoor_refusal(cfg)


def _build_imvoxelnet(cfg: dict, meta: SceneMeta = None,
                      compute_dtype=torch.float32) -> NerfDet:
    """The lowercase ``imvoxelnet`` type: the NeRF-Det graph without the
    NeRF density (JAX's ``_build_imvoxelnet``)."""
    return _build_nerfdet(dict(cfg, nerf_density=False), meta, compute_dtype)


def _build_imvoxelnet_ref(cfg: dict, meta: SceneMeta = None,
                          compute_dtype=torch.float32) -> nn.Module:
    """The ``ImVoxelNet`` type, routed as JAX routes it: the NeRF-keyed
    indoor configs (``routes_to_nerfdet``) build the NeRF-Det graph, the
    other indoor ones the indoor ImVoxelNet; the rest raise
    (``unported_refusal``)."""
    if routes_to_nerfdet(cfg):
        return _build_nerfdet(cfg, meta, compute_dtype)
    refusal = unported_refusal(cfg)
    if refusal is not None:
        raise NotImplementedError(refusal)
    return build_imvoxelnet_indoor(cfg, meta, compute_dtype)


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


_BUILDERS = {"nerfdet": _build_nerfdet, "VoteNet": _build_votenet,
             "imvoxelnet": _build_imvoxelnet,
             "ImVoxelNet": _build_imvoxelnet_ref}


def build_model(cfg: dict, meta: SceneMeta = None,
                compute_dtype=torch.float32) -> nn.Module:
    """The model of ``cfg`` computing in ``compute_dtype`` (float32, or
    bfloat16 for NeRF-Det and the indoor ImVoxelNet: the JAX package's
    ``--bf16`` path); its parameters are float32 either way."""
    if cfg["type"] not in _BUILDERS:
        raise NotImplementedError(unported_refusal(cfg))
    return _BUILDERS[cfg["type"]](cfg, meta, compute_dtype)
