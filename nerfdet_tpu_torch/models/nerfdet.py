"""NeRF-Det for one scene: detection and novel-view rendering, for
inference and joint training.

Port of ``nerfdet_tpu/models/nerfdet.py``. Detection: ResNet + FPN over
the views, projection and view-streaming mean/variance fusion (K1) with
the nerf_density global volume (its rgb stream the host's sums or, for a
scene with a depth map, gathered by the rgb-stream kernel), the density
MLP's alpha modulation, the 3D neck and the head. A scene's depth map
(the depth_sp configs) gates every (voxel, view) pair by depth. Rendering (image mode, evenly spaced samples):
the ``mapping`` of the cropped stride-4 maps, the view-streaming ray
sampler (K2), the NeRF MLP and alpha compositing, in ray chunks. Public
methods take and return channels-last tensors without a batch
dimension, like the JAX package; the modules inside run NCHW / NCDHW.
In train mode (``model.train()``) the forward is the JAX ``train=True``
graph: the 3D neck's BatchNorm normalizes by the scene's statistics and
updates its running ones; the batch's rays are rendered at the host's
stratified depths (``z_vals``) with K2 in its training form (the host
rgb sums), or, without ``z_vals``, at depths jittered on the device. The
gradient reaches the FPN and ``mapping`` through K1's backward and
through K2's.

``compute_dtype`` is the JAX model's: at bfloat16 every module computes
in bfloat16 with float32 parameters (``nn/compute.py``), the feature maps
reach K1 and K2 in bfloat16 (K1's mapped stream keeps the float32
``mapping`` parameters, as JAX reads them raw), the images are rounded
to bfloat16 where the device samples them, and the casts sit where the
JAX model puts them: the density query's points and global volume, the
radiance field's points, view directions and features. The volume the
3D neck reads is float32 (bfloat16 alpha times the float32 mean), the
head's outputs and the rendered rgb bfloat16, the rendered depth and the
losses float32, as JAX's type promotion gives them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.compute import linear
from ..nn.fpn import FPN
from ..nn.heads import ScanNetImVoxelHeadV2
from ..nn.neck3d import FastIndoorImVoxelNeck
from ..nn.nerf_mlp import VanillaNeRFRadianceField
from ..nn.resnet import ResNet
from ..ops import render as render_ops
from ..ops.render import view_projection
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
                 n_scales: int = 3, head_limit: int = 27,
                 head_centerness_topk: int = 18,
                 n_voxels: Tuple[int, int, int] = (40, 40, 16),
                 voxel_size: Tuple[float, float, float] = (0.16, 0.16, 0.2),
                 near_far_range: Tuple[float, float] = (0.2, 8.0),
                 n_samples: int = 64, n_rand: int = 2048,
                 squeeze_scale: int = 4, nerf_density: bool = True,
                 meta: SceneMeta = SceneMeta(),
                 compute_dtype=torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"compute_dtype must be float32 or bfloat16, "
                            f"got {compute_dtype}")
        self.compute_dtype = dt = compute_dtype
        self.n_classes = n_classes
        self.n_scales = n_scales
        self.head_limit = head_limit
        self.head_centerness_topk = head_centerness_topk
        self.n_voxels = tuple(n_voxels)
        self.voxel_size = tuple(voxel_size)
        self.near_far_range = tuple(near_far_range)
        self.n_samples = n_samples
        self.n_rand = n_rand
        self.nerf_density = nerf_density
        self.meta = meta
        self.backbone = ResNet(depth=backbone_depth,
                               out_indices=tuple(range(len(fpn_in_channels))),
                               dtype=dt)
        self.neck = FPN(fpn_in_channels, fpn_out_channels, dt)
        self.neck_3d = FastIndoorImVoxelNeck(
            fpn_out_channels, neck3d_out_channels, neck3d_n_blocks, dt)
        self.bbox_head = ScanNetImVoxelHeadV2(
            n_classes, neck3d_out_channels, head_n_reg_outs, n_scales, dt)
        nerf_feature_dim = fpn_out_channels // squeeze_scale
        # rgb mean + var add 3 + 3 to the global volume's width
        self.nerf_mlp = VanillaNeRFRadianceField(
            net_depth=4, net_width=256, skip_layer=3,
            feature_dim=nerf_feature_dim + 6, net_depth_condition=1,
            net_width_condition=128, dtype=dt)
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
                     rgb_stats=None, denorm_images=None,
                     depth=None) -> Dict:
        """Project, fuse and density-modulate the volume.

        ``depth`` (V, H, W), where given, gates every (voxel, view) pair
        by the sensed depth. The density path's rgb stream comes from the
        host rgb sums ``rgb_stats`` (``data/rgb_stats.host_rgb_stats``)
        where they are given and the scene has no depth, else from the
        (V, Hp, Wp, 3) ``denorm_images`` on the device (``rgb_carry``), as
        the JAX model chooses. Returns det_volume (nx, ny, nz, C) and valid
        (nx, ny, nz), the observing-view counts.
        """
        dev = features.device
        h_img, w_img = self.meta.img_shape
        stride = self.meta.pad_shape[1] // features.shape[2]
        ratio = self.meta.ori_shape[0] / (h_img / stride)
        projection = compute_projection(intrinsic, extrinsics, ratio, dev)
        pts_flat = get_points(self.n_voxels, self.voxel_size, origin,
                              dev).reshape(-1, 3)
        feat_hw = (h_img // stride, w_img // stride)
        gate = dict(depth=depth, voxel_size_z=self.voxel_size[-1],
                    image_hw=feat_hw)

        if self.nerf_density:
            lin = self.mapping[0]
            if rgb_stats is not None and depth is None:
                rgb = dict(precomputed_extra=rgb_stats)
            elif denorm_images is None:
                raise ValueError("the density path needs the host rgb sums "
                                 "or, with a depth map, denorm_images")
            else:
                rgb = dict(extra_features=denorm_images.to(
                               self.compute_dtype),
                           extra_projection=compute_projection(
                               intrinsic, extrinsics,
                               self.meta.ori_shape[0] / h_img, dev),
                           extra_image_hw=(h_img, w_img))
            mean, _, count, g_mean, g_cov = fused_mean_cov(
                features, pts_flat, projection,
                mapped_kernel=lin.weight.t(), mapped_bias=lin.bias,
                **gate, **rgb)
            density = self.nerf_mlp.query_density(
                pts_flat, torch.cat([g_mean, g_cov], dim=-1))
            det_volume = (1.0 - torch.exp(-density)) * mean
        else:
            det_volume, _, count = fused_mean_cov(features, pts_flat,
                                                  projection, **gate)
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

    # ------------------------------------------------------------------
    # the render branch (image mode)
    # ------------------------------------------------------------------

    def render_featmaps(self, features) -> torch.Tensor:
        """``mapping`` of the stride-4 maps cropped to (img_h // 4,
        img_w // 4): the pixels are normalized by ``img_shape``, so the
        renderer samples the cropped extent, not the padded one."""
        stride = self.meta.pad_shape[1] // features.shape[2]
        fh = self.meta.img_shape[0] // stride
        fw = self.meta.img_shape[1] // stride
        return linear(self.mapping[0], features[:, :fh, :fw],
                      self.compute_dtype)

    def render_projection(self, intrinsic, extrinsics, device):
        """(V, 4, 4) ``K4 @ pose`` with the intrinsic scaled from
        ``ori_shape`` to ``img_shape``."""
        ratio = self.meta.ori_shape[0] / self.meta.img_shape[0]
        return view_projection(intrinsic, extrinsics, ratio, device)

    def _render_chunk(self, ray_o, ray_d, imgs_denorm, proj, featmaps,
                      **kw):
        if imgs_denorm is not None:
            imgs_denorm = imgs_denorm.to(self.compute_dtype)
        return render_ops.render_rays_chunk(
            ray_o, ray_d, self.nerf_mlp, near_far=self.near_far_range,
            n_samples=self.n_samples, images=imgs_denorm, proj=proj,
            img_hw=self.meta.img_shape, featmaps=featmaps, **kw)

    def render(self, ray_o, ray_d, features, imgs_denorm, intrinsic,
               extrinsics, det: bool = True,
               generator: Optional[torch.Generator] = None, z_vals=None,
               precomputed_rgb=None) -> Dict[str, torch.Tensor]:
        """Render a bundle of rays (R, 3): rgb (R, 3), depth (R,) and the
        ray mask (R,). ``features`` are the stride-4 FPN maps,
        ``imgs_denorm`` the (V, Hp, Wp, 3) denormalized views (unused
        with ``precomputed_rgb``, the host rgb sums and count). The
        samples lie at ``z_vals`` (R, S) where given, else evenly spaced
        (``det``) or jittered from ``generator``."""
        proj = self.render_projection(intrinsic, extrinsics, ray_o.device)
        return self._render_chunk(ray_o, ray_d, imgs_denorm, proj,
                                  self.render_featmaps(features), det=det,
                                  generator=generator, z_vals=z_vals,
                                  precomputed_rgb=precomputed_rgb)

    @torch.inference_mode()
    def render_full(self, batch: Dict, chunk: int = 2048):
        """Test-time rendering, without autograd, of every ray of
        ``batch['ray_o'/'ray_d']`` ((T, R, 3) per target view or flat
        (N, 3)) in chunks of ``chunk``: the rays are padded by repeating
        the first ones, and the output cut back. Returns rgb (N, 3) and
        depth (N,)."""
        features = self.extract_2d(batch["imgs"])
        featmaps = self.render_featmaps(features)
        ray_o = batch["ray_o"].reshape(-1, 3)
        ray_d = batch["ray_d"].reshape(-1, 3)
        n = ray_o.shape[0]
        pad = (-n) % chunk
        if pad:
            ray_o = torch.cat([ray_o, ray_o[:pad]])
            ray_d = torch.cat([ray_d, ray_d[:pad]])
        proj = self.render_projection(batch["intrinsic"], batch["extrinsics"],
                                      ray_o.device)
        images = batch["denorm_images"].to(self.compute_dtype)
        outs = render_ops.render_rays_full(
            ray_o, ray_d, chunk, lambda ro, rd: self._render_chunk(
                ro, rd, images, proj, featmaps))
        return outs["rgb"][:n], outs["depth"][:n]

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """One scene: ``batch`` holds imgs (V, Hp, Wp, 3), intrinsic
        (4, 4), extrinsics (V, 4, 4), origin (3,), for the density path
        rgb_s1/rgb_s2 (N, 3) or denorm_images (V, Hp, Wp, 3), optionally
        the depth maps depth (V, H, W) (the rgb stream then comes from
        denorm_images, see ``build_volume``), and optionally a ray bundle
        ray_o/ray_d (R, 3) with denorm_images or the host ray stream
        (``data/ray_stats.RAY_STREAM_KEYS``: z_vals and the rgb sums).
        Returns (head_outs, valid, render_out), render_out None without
        rays. The rays' samples are evenly spaced in eval mode and, in
        train mode without ``z_vals``, jittered from ``generator``."""
        features = self.extract_2d(batch["imgs"])
        rgb_stats = ((batch["rgb_s1"], batch["rgb_s2"])
                     if "rgb_s1" in batch else None)
        vol = self.build_volume(features, batch["intrinsic"],
                                batch["extrinsics"], batch["origin"],
                                rgb_stats=rgb_stats,
                                denorm_images=batch.get("denorm_images"),
                                depth=batch.get("depth"))
        render_out = None
        if "ray_o" in batch:
            host = (tuple(batch[k] for k in ("ray_s1u", "ray_s2u",
                                             "ray_s1m", "ray_cnt"))
                    if "ray_s1u" in batch else None)
            render_out = self.render(
                batch["ray_o"], batch["ray_d"], features,
                batch.get("denorm_images"), batch["intrinsic"],
                batch["extrinsics"], det=not self.training,
                generator=generator, z_vals=batch.get("z_vals"),
                precomputed_rgb=host)
        return self.detect(vol["det_volume"]), vol["valid"], render_out

    def mlvl_points(self, origin) -> List[torch.Tensor]:
        """Per-scale voxel-center grids, each (P, 3)."""
        dev = self.mapping[0].weight.device
        pts = []
        for i in range(self.n_scales):
            n_vox = tuple(v // (2 ** i) for v in self.n_voxels)
            size = tuple(s * (2 ** i) for s in self.voxel_size)
            pts.append(get_points(n_vox, size, origin, dev).reshape(-1, 3))
        return pts
