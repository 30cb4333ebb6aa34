"""NeRF-Det detection inference for one scene.

Port of the detection path of ``nerfdet_tpu/models/nerfdet.py``:
ResNet + FPN over the views, projection and view-streaming mean/variance
fusion (K1) with the nerf_density global volume, the density MLP's
alpha modulation, the 3D neck and the head. Public methods take and
return channels-last tensors without a batch dimension, like the JAX
package; the modules inside run NCHW / NCDHW. The render branch is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..nn.fpn import FPN
from ..nn.heads import ScanNetImVoxelHeadV2
from ..nn.neck3d import FastIndoorImVoxelNeck
from ..nn.nerf_mlp import VanillaNeRFRadianceField
from ..nn.resnet import ResNet
from ..ops.voxel import compute_projection, fused_mean_cov, get_points


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Image geometry of a dataset: ``img_shape`` is the resized
    (pre-pad) size used for intrinsic rescaling and validity bounds,
    ``pad_shape`` the tensor size."""

    ori_shape: Tuple[int, int] = (968, 1296)
    img_shape: Tuple[int, int] = (239, 320)
    pad_shape: Tuple[int, int] = (240, 320)


class NerfDet(nn.Module):
    def __init__(self, backbone_depth: int = 50,
                 fpn_in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 fpn_out_channels: int = 256,
                 neck3d_out_channels: int = 128,
                 neck3d_n_blocks: Sequence[int] = (1, 1, 1),
                 n_classes: int = 18, head_n_reg_outs: int = 6,
                 n_scales: int = 3,
                 n_voxels: Tuple[int, int, int] = (40, 40, 16),
                 voxel_size: Tuple[float, float, float] = (0.16, 0.16, 0.2),
                 squeeze_scale: int = 4, nerf_density: bool = True,
                 meta: SceneMeta = SceneMeta()):
        super().__init__()
        self.n_classes = n_classes
        self.n_scales = n_scales
        self.n_voxels = tuple(n_voxels)
        self.voxel_size = tuple(voxel_size)
        self.nerf_density = nerf_density
        self.meta = meta
        self.backbone = ResNet(depth=backbone_depth,
                               out_indices=tuple(range(len(fpn_in_channels))))
        self.neck = FPN(fpn_in_channels, fpn_out_channels)
        self.neck_3d = FastIndoorImVoxelNeck(
            fpn_out_channels, neck3d_out_channels, neck3d_n_blocks)
        self.bbox_head = ScanNetImVoxelHeadV2(
            n_classes, neck3d_out_channels, head_n_reg_outs, n_scales)
        nerf_feature_dim = fpn_out_channels // squeeze_scale
        # rgb mean + var add 3 + 3 to the global volume's width
        self.nerf_mlp = VanillaNeRFRadianceField(
            net_depth=4, net_width=256, skip_layer=3,
            feature_dim=nerf_feature_dim + 6, net_depth_condition=1,
            net_width_condition=128)
        self.mapping = nn.Sequential(
            nn.Linear(fpn_out_channels, nerf_feature_dim // 2))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights after the JAX package's initializers:
        lecun-normal convs and dense layers (std 1/sqrt(fan_in)),
        xavier-uniform NeRF MLP, normal(0.01) head convs with the focal
        prior on the class bias, identity norms, zero biases. Call it
        while the model is on the CPU."""
        for name, m in self.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d,
                              nn.Linear)):
                w = m.weight
                if isinstance(m, nn.ConvTranspose3d):
                    fan_in = w.shape[0] * w[0, 0].numel()
                else:
                    fan_in = w[0].numel()
                if name.startswith("nerf_mlp."):
                    bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
                    nn.init.uniform_(w, -bound, bound, generator=generator)
                elif name.startswith("bbox_head."):
                    nn.init.normal_(w, 0.0, 0.01, generator=generator)
                else:
                    nn.init.normal_(w, 0.0, fan_in ** -0.5,
                                    generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm3d):
                m.reset_parameters()
        self.bbox_head.cls_conv.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def extract_2d(self, imgs: torch.Tensor) -> torch.Tensor:
        """(V, Hp, Wp, 3) normalized images -> (V, Hp/4, Wp/4, C)."""
        feats = self.backbone(imgs.permute(0, 3, 1, 2))
        return self.neck(feats, num_outs=1)[0].permute(0, 2, 3, 1)

    def build_volume(self, features, intrinsic, extrinsics, origin,
                     rgb_stats=None) -> Dict:
        """Project, fuse and density-modulate the volume.

        ``rgb_stats`` are the host rgb sums
        (``data/rgb_stats.host_rgb_stats``) the density path needs.
        Returns det_volume (nx, ny, nz, C) and valid (nx, ny, nz), the
        observing-view counts.
        """
        dev = features.device
        h_img, w_img = self.meta.img_shape
        stride = self.meta.pad_shape[1] // features.shape[2]
        ratio = self.meta.ori_shape[0] / (h_img / stride)
        projection = compute_projection(intrinsic, extrinsics, ratio, dev)
        pts_flat = get_points(self.n_voxels, self.voxel_size, origin,
                              dev).reshape(-1, 3)
        feat_hw = (h_img // stride, w_img // stride)

        if self.nerf_density:
            if rgb_stats is None:
                raise NotImplementedError(
                    "the in-scan rgb stream is not yet ported; pass the "
                    "host rgb sums (rgb_s1, rgb_s2)")
            lin = self.mapping[0]
            mean, _, count, g_mean, g_cov = fused_mean_cov(
                features, pts_flat, projection, image_hw=feat_hw,
                mapped_kernel=lin.weight.t(), mapped_bias=lin.bias,
                precomputed_extra=rgb_stats)
            density = self.nerf_mlp.query_density(
                pts_flat, torch.cat([g_mean, g_cov], dim=-1))
            det_volume = (1.0 - torch.exp(-density)) * mean
        else:
            det_volume, _, count = fused_mean_cov(
                features, pts_flat, projection, image_hw=feat_hw)
        observed = count[:, None] > 0
        det_volume = torch.where(observed, det_volume,
                                 torch.zeros_like(det_volume))
        nx, ny, nz = self.n_voxels
        return dict(det_volume=det_volume.reshape(nx, ny, nz, -1),
                    valid=count.reshape(nx, ny, nz))

    def detect(self, det_volume) -> List[Tuple[torch.Tensor, ...]]:
        """3D neck + head: per scale (centerness, bbox_pred, cls_score),
        each (nx_s, ny_s, nz_s, ch)."""
        x = det_volume.permute(3, 0, 1, 2)[None]
        outs = self.bbox_head(self.neck_3d(x))
        return [tuple(t[0].permute(1, 2, 3, 0) for t in o) for o in outs]

    def forward(self, batch: Dict[str, torch.Tensor]):
        """One scene: ``batch`` holds imgs (V, Hp, Wp, 3), intrinsic
        (4, 4), extrinsics (V, 4, 4), origin (3,) and, for the density
        path, rgb_s1/rgb_s2 (N, 3). Returns (head_outs, valid)."""
        features = self.extract_2d(batch["imgs"])
        rgb_stats = ((batch["rgb_s1"], batch["rgb_s2"])
                     if "rgb_s1" in batch else None)
        vol = self.build_volume(features, batch["intrinsic"],
                                batch["extrinsics"], batch["origin"],
                                rgb_stats=rgb_stats)
        return self.detect(vol["det_volume"]), vol["valid"]

    def mlvl_points(self, origin) -> List[torch.Tensor]:
        """Per-scale voxel-center grids, each (P, 3)."""
        dev = self.mapping[0].weight.device
        pts = []
        for i in range(self.n_scales):
            n_vox = tuple(v // (2 ** i) for v in self.n_voxels)
            size = tuple(s * (2 ** i) for s in self.voxel_size)
            pts.append(get_points(n_vox, size, origin, dev).reshape(-1, 3))
        return pts
