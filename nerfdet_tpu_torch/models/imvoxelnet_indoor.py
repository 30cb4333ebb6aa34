"""The indoor ImVoxelNet for one scene: multi-view RGB detection without
the NeRF branch.

Port of ``nerfdet_tpu/models/imvoxelnet_indoor.py`` (``IndoorImVoxelNet``,
``build_imvoxelnet_indoor``): ResNet + FPN over the views, the
back-projected plain-mean volume (K1 without a mapped or rgb stream,
gated by the sensed depth for ``use_depth``), the Atlas neck
(``nn/imvoxel_necks.ImVoxelNeck``) or the fast neck
(``nn/neck3d.FastIndoorImVoxelNeck``), and the V1 head
(``nn/heads_v1.ImVoxelHeadV1``) or the V2 head
(``nn/heads.ScanNetImVoxelHeadV2``), each yawed for SUN RGB-D (the
``SunRgbd*`` head types: ``yaw``, seven regression outputs, decoded to
yawed boxes; one view a scene). The scene contract is NeRF-Det's
(``models/nerfdet.py``): imgs (V, Hp, Wp, 3) normalized, intrinsic (4,
4), extrinsics (V, 4, 4), origin (3,), optionally depth (V, H, W);
public methods take and return channels-last tensors without a batch
dimension. In train mode the 3D neck's and head's BatchNorms normalize
by the scene's statistics and update their running ones. ``view_group``
shards the views over ranks as NeRF-Det's (the fusion's sums summed over
the group).

Not ported, refused by name: the layout head (``head_2d``, the
total-SUN RGB-D mode), ROADMAP §1 item 3.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.fpn import FPN
from ..nn.heads import ScanNetImVoxelHeadV2
from ..nn.heads_v1 import ImVoxelHeadV1
from ..nn.imvoxel_necks import ImVoxelNeck
from ..nn.neck3d import BatchNorm3d, FastIndoorImVoxelNeck
from ..nn.resnet import ResNet
from ..ops.voxel import compute_projection, fused_mean_cov, get_points
from .nerfdet import SceneMeta

INF = 1e8
LAYOUT_REFUSAL = (
    "the layout head (head_2d, the total-SUN RGB-D configs) is not ported "
    "yet: ROADMAP §1 item 3 (the SUN RGB-D total-scene configs)")
INDOOR_NECKS = ("ImVoxelNeck", "FastIndoorImVoxelNeck")


class IndoorImVoxelNet(nn.Module):
    # what api.device_batch / train_batch ask of a detector: no density
    # volume, no render branch, no host streams
    nerf_density = False
    nerf_mode = None
    host_streams = False

    def __init__(self, backbone_depth: int = 50,
                 fpn_in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 fpn_out_channels: int = 64, neck3d: Optional[Dict] = None,
                 head_type: str = "ScanNetImVoxelHead", n_classes: int = 18,
                 head_n_channels: int = 64, head_n_convs: int = 0,
                 head_n_reg_outs: int = 6, head_limit: int = 27,
                 head_centerness_topk: int = 18,
                 regress_ranges: Sequence[Tuple[float, float]] = (
                     (-1.0, 0.75), (0.75, 1.5), (1.5, INF)),
                 with_layout: bool = False,
                 n_voxels: Tuple[int, int, int] = (80, 80, 32),
                 voxel_size: Tuple[float, float, float] = (0.08, 0.08, 0.08),
                 meta: SceneMeta = SceneMeta(ori_shape=(968, 1296),
                                             img_shape=(480, 640),
                                             pad_shape=(480, 640)),
                 compute_dtype=torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"compute_dtype must be float32 or bfloat16, "
                            f"got {compute_dtype}")
        if with_layout:
            raise NotImplementedError(LAYOUT_REFUSAL)
        n3 = dict(neck3d or {})
        n3_type = n3.get("type", "ImVoxelNeck")
        self.compute_dtype = dt = compute_dtype
        self.head_type = head_type
        self.n_classes = n_classes
        self.head_limit = head_limit
        self.head_centerness_topk = head_centerness_topk
        self.regress_ranges = tuple(tuple(float(x) for x in r)
                                    for r in regress_ranges)
        self.yaw = head_type.startswith("SunRgbd")  # JAX's ``yaw``
        self.n_voxels = tuple(n_voxels)
        self.voxel_size = tuple(voxel_size)
        self.meta = meta
        self.backbone = ResNet(depth=backbone_depth,
                               out_indices=tuple(range(len(fpn_in_channels))),
                               dtype=dt)
        self.neck = FPN(fpn_in_channels, fpn_out_channels, dt)
        if n3_type == "FastIndoorImVoxelNeck":
            n_blocks = tuple(n3.get("n_blocks", (1, 1, 1)))
            self.n_scales = len(n_blocks)
            self.neck_3d = FastIndoorImVoxelNeck(
                fpn_out_channels, n3.get("out_channels", 128), n_blocks, dt)
            head_in = n3.get("out_channels", 128)
        else:
            up = tuple(n3.get("up_layers", (3, 2, 1)))
            self.n_scales = len(up)
            self.neck_3d = ImVoxelNeck(
                tuple(n3.get("channels", (64, 128, 256, 512))),
                n3.get("out_channels", 64),
                tuple(n3.get("down_layers", (1, 2, 3, 4))), up,
                n3.get("conditional", False), dt)
            head_in = n3.get("out_channels", 64)
        if head_type.endswith("V2"):
            self.bbox_head = ScanNetImVoxelHeadV2(
                n_classes, head_n_channels, head_n_reg_outs, self.n_scales,
                dt)
        else:
            self.bbox_head = ImVoxelHeadV1(
                head_in, n_classes, head_n_channels, head_n_convs,
                head_n_reg_outs, self.regress_ranges, self.yaw, dt)

    @property
    def uses_v1_head(self) -> bool:
        """JAX's ``train/step._uses_v1_head``: the regress-range head."""
        return not self.head_type.endswith("V2")

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights after the JAX package's initializers:
        lecun-normal convs (std 1/sqrt(fan_in)), normal(0.01) head convs
        with the focal prior on the class bias, identity norms but the
        Atlas blocks' zero ``bn2`` scales, zero biases. Call it while the
        model is on the CPU."""
        for name, m in self.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
                w = m.weight
                if isinstance(m, nn.ConvTranspose3d):
                    fan_in = w.shape[0] * w[0, 0].numel()
                else:
                    fan_in = w[0].numel()
                std = 0.01 if name.startswith("bbox_head.") else fan_in ** -0.5
                nn.init.normal_(w, 0.0, std, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm3d):
                m.reset_parameters()
        if isinstance(self.neck_3d, ImVoxelNeck):
            self.neck_3d.zero_residual_scales()
        self.bbox_head.cls_conv.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def extract_2d(self, imgs: torch.Tensor):
        """(V, Hp, Wp, 3) normalized images -> (the stride-4 FPN maps (V,
        Hp/4, Wp/4, C), the backbone's last stage NCHW, which the layout
        head would read)."""
        feats = self.backbone(imgs.permute(0, 3, 1, 2))
        return self.neck(feats, num_outs=1)[0].permute(0, 2, 3, 1), feats[-1]

    def build_volume(self, features, intrinsic, extrinsics, origin,
                     depth=None, view_group=None):
        """Project and mean-fuse (K1, no mapped stream): the volume (nx,
        ny, nz, C), 0 where no view sees a voxel, and the view counts (nx,
        ny, nz). ``depth`` (V, H, W) gates each (voxel, view) pair to
        within one z-voxel of the sensed depth; ``view_group`` as
        NeRF-Det's."""
        dev = features.device
        h_img, w_img = self.meta.img_shape
        stride = self.meta.pad_shape[1] // features.shape[2]
        ratio = self.meta.ori_shape[0] / (h_img / stride)
        projection = compute_projection(intrinsic, extrinsics, ratio, dev)
        pts_flat = get_points(self.n_voxels, self.voxel_size, origin,
                              dev).reshape(-1, 3)
        mean, _, count = fused_mean_cov(
            features, pts_flat, projection,
            image_hw=(h_img // stride, w_img // stride), depth=depth,
            voxel_size_z=self.voxel_size[-1], view_group=view_group)
        volume = torch.where(count[:, None] > 0, mean, torch.zeros_like(mean))
        nx, ny, nz = self.n_voxels
        return volume.reshape(nx, ny, nz, -1), count.reshape(nx, ny, nz)

    def detect(self, volume) -> List[Tuple[torch.Tensor, ...]]:
        """3D neck + head: per scale (centerness, bbox_pred, cls_score),
        each (nx_s, ny_s, nz_s, ch), finest first."""
        outs = self.bbox_head(self.neck_3d(volume.permute(3, 0, 1, 2)[None]))
        return [tuple(t[0].permute(1, 2, 3, 0) for t in o) for o in outs]

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                view_group=None, n_ray_shards: int = 1):
        """One scene -> (head_outs, valid, None): NeRF-Det's call (the
        generator and the ray shards, which only a render reads, are not
        used), the third output the layout head's, which is not ported."""
        del generator, n_ray_shards
        features, _ = self.extract_2d(batch["imgs"])
        volume, valid = self.build_volume(
            features, batch["intrinsic"], batch["extrinsics"],
            batch["origin"], depth=batch.get("depth"), view_group=view_group)
        return self.detect(volume), valid, None

    def mlvl_points(self, origin) -> List[torch.Tensor]:
        """Per-scale voxel-center grids, finest (the full volume) first,
        each (P, 3)."""
        dev = next(self.parameters()).device
        pts = []
        for i in range(self.n_scales):
            n_vox = tuple(v // (2 ** i) for v in self.n_voxels)
            size = tuple(s * (2 ** i) for s in self.voxel_size)
            pts.append(get_points(n_vox, size, origin, dev).reshape(-1, 3))
        return pts


def indoor_refusal(cfg: dict) -> Optional[str]:
    """Why an indoor ``ImVoxelNet`` model config is not ported (the layout
    head), or None."""
    if cfg.get("head_2d") is not None:
        return LAYOUT_REFUSAL
    return None


def build_imvoxelnet_indoor(cfg: dict, meta: Optional[SceneMeta] = None,
                            compute_dtype=torch.float32) -> IndoorImVoxelNet:
    """A ``configs/imvoxelnet/imvoxelnet_scannet.py``-schema model dict ->
    ``IndoorImVoxelNet``, with JAX's defaults. ``meta`` where given (the
    test pipeline's, as ``api.init_detector`` passes it), else the model
    dict's ``meta`` (JAX reads it only then)."""
    bb, nk = cfg.get("backbone", {}), cfg.get("neck", {})
    hd, h2 = cfg["bbox_head"], cfg.get("head_2d")
    m = cfg.get("meta", {})
    scene_meta = meta or SceneMeta(
        ori_shape=tuple(m.get("ori_shape", (968, 1296))),
        img_shape=tuple(m.get("img_shape", (480, 640))),
        pad_shape=tuple(m.get("pad_shape", (480, 640))))
    return IndoorImVoxelNet(
        backbone_depth=bb.get("depth", 50),
        fpn_in_channels=tuple(nk.get("in_channels", (256, 512, 1024, 2048))),
        fpn_out_channels=nk.get("out_channels", 64),
        neck3d=dict(cfg.get("neck_3d", {})),
        head_type=hd.get("type", "ScanNetImVoxelHead"),
        n_classes=hd["n_classes"],
        head_n_channels=hd.get("n_channels", 64),
        head_n_convs=hd.get("n_convs", 0),
        head_n_reg_outs=hd.get("n_reg_outs", 6),
        head_limit=hd.get("limit", 27),
        head_centerness_topk=hd.get("centerness_topk", 18),
        regress_ranges=tuple(tuple(r) for r in hd.get(
            "regress_ranges", ((-1.0, 0.75), (0.75, 1.5), (1.5, INF)))),
        with_layout=h2 is not None,
        n_voxels=tuple(cfg["n_voxels"]),
        voxel_size=tuple(cfg["voxel_size"]),
        meta=scene_meta,
        compute_dtype=compute_dtype)
