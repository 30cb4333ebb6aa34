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

The fast_cov family's options (the ``ImVoxelNet``-typed configs):
``volume_type`` picks the statistic the 3D neck reads (``mean``, ``cov``
= exp(-variance), or ``cov_w_mean`` = mean * cov); ``backbone_type``
"SwinTransformer" takes ``nn/swin.py`` in place of the ResNet;
``nerf_mode`` "volume" renders from the fused mean and cov volumes
(``mean_mapping`` / ``cov_mapping``, 1x1x1 convs, sampled trilinearly
in ``aabb``) with ``nerf_density`` off; ``host_streams`` False says the
data path ships neither the host rgb sums nor the ray stream (the
ImVoxelNet type's, as JAX's dataset specs), so ``api`` sends the
images to the device for both.

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

Views sharded over ranks (JAX's ``view_axis``, the 2-D data x views
sharding): with a ``view_group`` the view-led inputs (imgs,
denorm_images, extrinsics, depth) are this rank's views, the fusion's
and the render's view statistics are summed over the group, and the
volume, the density modulation, the 3D neck and the head run the same on
every rank of the group. With ``n_ray_shards`` > 1 each rank renders its
own slice of the rays after the view statistics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.compute import conv, linear
from ..nn.fpn import FPN
from ..nn.heads import ScanNetImVoxelHeadV2
from ..nn.neck3d import FastIndoorImVoxelNeck
from ..nn.nerf_mlp import VanillaNeRFRadianceField
from ..nn.resnet import ResNet
from ..nn.swin import SwinTransformer, WindowAttention
from ..ops import render as render_ops
from ..ops.render import view_projection
from ..ops.voxel import compute_projection, fused_mean_cov, get_points


VOLUME_TYPES = ("mean", "cov", "cov_w_mean")

# nerfdet_tpu/models/nerfdet.py shares one radiance field between the
# density query ([g_mean, g_cov]: nerf_feature_dim + 6 wide) and the
# volume-mode render ([mean_pts, cov_pts]: nerf_feature_dim wide); flax
# fixes the first layer's width at its first call, so JAX's init fails
# (ScopeParamShapeError at nerf_mlp/mlp/base/hidden_0)
VOLUME_DENSITY_FAULT = (
    "nerf_mode='volume' with nerf_density=True does not run in the JAX "
    "package (its density query and its volume-mode render share one "
    "NeRF MLP at two input widths: ScopeParamShapeError at "
    "nerf_mlp/mlp/base/hidden_0), so the port has nothing to hold it "
    "to; set model.nerf_density=False (ROADMAP §1 item 2.2)")
VOLUME_MESH_VIEWS = (
    "volume mode with the views sharded (--mesh-views) is not ported: "
    "JAX sums the view counts of the volume-mode render over the views "
    "axis (ROADMAP §1 item 2.2)")


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
                 compute_dtype=torch.float32,
                 backbone_type: str = "ResNet", backbone_cfg=None,
                 nerf_mode: str = "image", volume_type: str = "mean",
                 aabb=((-2.7, -2.7, -0.78), (3.7, 3.7, 1.78)),
                 host_streams: bool = True):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"compute_dtype must be float32 or bfloat16, "
                            f"got {compute_dtype}")
        if volume_type not in VOLUME_TYPES:
            raise ValueError(f"volume_type must be one of {VOLUME_TYPES}, "
                             f"got {volume_type!r}")
        if nerf_mode not in ("image", "volume"):
            raise ValueError(f"nerf_mode must be 'image' or 'volume', got "
                             f"{nerf_mode!r}")
        if nerf_mode == "volume" and nerf_density:
            raise NotImplementedError(VOLUME_DENSITY_FAULT)
        if backbone_type not in ("ResNet", "SwinTransformer"):
            raise NotImplementedError(
                f"backbone {backbone_type!r} is not ported (ResNet, "
                f"SwinTransformer)")
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
        self.nerf_mode = nerf_mode
        self.volume_type = volume_type
        self.aabb = tuple(tuple(float(a) for a in b) for b in aabb)
        self.host_streams = host_streams
        self.meta = meta
        if backbone_type == "SwinTransformer":
            self.backbone = SwinTransformer(dtype=dt, **(backbone_cfg or {}))
        else:
            self.backbone = ResNet(
                depth=backbone_depth,
                out_indices=tuple(range(len(fpn_in_channels))), dtype=dt)
        self.neck = FPN(fpn_in_channels, fpn_out_channels, dt)
        self.neck_3d = FastIndoorImVoxelNeck(
            fpn_out_channels, neck3d_out_channels, neck3d_n_blocks, dt)
        self.bbox_head = ScanNetImVoxelHeadV2(
            n_classes, neck3d_out_channels, head_n_reg_outs, n_scales, dt)
        nerf_feature_dim = fpn_out_channels // squeeze_scale
        half = nerf_feature_dim // 2
        # image mode: [rgb, mapped] means and covs, rgb adding 3 + 3 to
        # the width; volume mode: the mean and cov volumes mapped to half
        # the width each (flax infers the width at its first call)
        self.nerf_mlp = VanillaNeRFRadianceField(
            net_depth=4, net_width=256, skip_layer=3,
            feature_dim=nerf_feature_dim + (6 if nerf_mode == "image" else 0),
            net_depth_condition=1, net_width_condition=128, dtype=dt)
        if nerf_mode == "image":
            self.mapping = nn.Sequential(nn.Linear(fpn_out_channels, half))
        else:
            self.mean_mapping = nn.Sequential(
                nn.Conv3d(fpn_out_channels, half, 1))
            self.cov_mapping = nn.Sequential(
                nn.Conv3d(fpn_out_channels, half, 1))

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
            elif isinstance(m, (nn.BatchNorm3d, nn.LayerNorm)):
                m.reset_parameters()
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table,
                                      std=0.02, a=-0.04, b=0.04,
                                      generator=generator)
        self.bbox_head.cls_conv.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def extract_2d(self, imgs: torch.Tensor) -> torch.Tensor:
        """(V, Hp, Wp, 3) normalized images -> (V, Hp/4, Wp/4, C)."""
        if isinstance(self.backbone, SwinTransformer):  # channels last
            feats = [f.permute(0, 3, 1, 2) for f in self.backbone(imgs)]
        else:
            feats = self.backbone(imgs.permute(0, 3, 1, 2))
        return self.neck(feats, num_outs=1)[0].permute(0, 2, 3, 1)

    def build_volume(self, features, intrinsic, extrinsics, origin,
                     rgb_stats=None, denorm_images=None,
                     depth=None, view_group=None) -> Dict:
        """Project, fuse and density-modulate the volume.

        ``depth`` (V, H, W), where given, gates every (voxel, view) pair
        by the sensed depth. The density path's rgb stream comes from the
        host rgb sums ``rgb_stats`` (``data/rgb_stats.host_rgb_stats``)
        where they are given and the scene has no depth, else from the
        (V, Hp, Wp, 3) ``denorm_images`` on the device (``rgb_carry``), as
        the JAX model chooses. ``view_group``: the views are this rank's
        share, the fusion's sums summed over the group (``fused_mean_cov``).
        ``volume_type`` picks the statistic the 3D neck reads: the mean,
        the cov (exp(-variance)) or mean * cov, before the density
        modulation and the observed mask. Returns det_volume (nx, ny, nz,
        C), valid (nx, ny, nz), the observing-view counts, and the fused
        mean and cov (nx, ny, nz, C).
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
                    image_hw=feat_hw, view_group=view_group)

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
            mean, cov, count, g_mean, g_cov = fused_mean_cov(
                features, pts_flat, projection,
                mapped_kernel=lin.weight.t(), mapped_bias=lin.bias,
                **gate, **rgb)
        else:
            mean, cov, count = fused_mean_cov(features, pts_flat,
                                              projection, **gate)
        det_volume = (mean if self.volume_type == "mean" else
                      cov if self.volume_type == "cov" else mean * cov)
        if self.nerf_density:
            density = self.nerf_mlp.query_density(
                pts_flat, torch.cat([g_mean, g_cov], dim=-1))
            det_volume = (1.0 - torch.exp(-density)) * det_volume
        observed = count[:, None] > 0
        det_volume = torch.where(observed, det_volume,
                                 torch.zeros_like(det_volume))
        nx, ny, nz = self.n_voxels
        return dict(det_volume=det_volume.reshape(nx, ny, nz, -1),
                    valid=count.reshape(nx, ny, nz),
                    mean=mean.reshape(nx, ny, nz, -1),
                    cov=cov.reshape(nx, ny, nz, -1))

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

    def render_volumes(self, vol) -> Tuple[torch.Tensor, torch.Tensor]:
        """Volume mode: ``mean_mapping`` and ``cov_mapping`` (1x1x1
        convs) of ``build_volume``'s fused mean and cov, each (nx, ny,
        nz, nerf_feature_dim / 2)."""
        def mapped(layer, x):
            y = conv(layer[0], x.permute(3, 0, 1, 2)[None],
                     self.compute_dtype)
            return y[0].permute(1, 2, 3, 0)
        return (mapped(self.mean_mapping, vol["mean"]),
                mapped(self.cov_mapping, vol["cov"]))

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
               precomputed_rgb=None, view_group=None,
               n_ray_shards: int = 1,
               volumes=None) -> Dict[str, torch.Tensor]:
        """Render a bundle of rays (R, 3): rgb (R, 3), depth (R,) and the
        ray mask (R,). ``features`` are the stride-4 FPN maps,
        ``imgs_denorm`` the (V, Hp, Wp, 3) denormalized views (unused
        with ``precomputed_rgb``, the host rgb sums and count). The
        samples lie at ``z_vals`` (R, S) where given, else evenly spaced
        (``det``) or jittered from ``generator``. ``view_group`` and
        ``n_ray_shards``: ``render_ops.render_rays_chunk``'s (the outputs
        are then this rank's R / n rays). Volume mode samples
        ``volumes``, the ``render_volumes`` pair, instead of the views
        (``features`` and ``imgs_denorm`` are then unused)."""
        proj = self.render_projection(intrinsic, extrinsics, ray_o.device)
        if self.nerf_mode == "volume":
            if view_group is not None:
                raise NotImplementedError(VOLUME_MESH_VIEWS)
            return self._render_chunk(ray_o, ray_d, None, proj, None,
                                      det=det, generator=generator,
                                      z_vals=z_vals, volumes=volumes,
                                      aabb=self.aabb)
        return self._render_chunk(ray_o, ray_d, imgs_denorm, proj,
                                  self.render_featmaps(features), det=det,
                                  generator=generator, z_vals=z_vals,
                                  precomputed_rgb=precomputed_rgb,
                                  view_group=view_group,
                                  n_ray_shards=n_ray_shards)

    @torch.inference_mode()
    def render_full(self, batch: Dict, chunk: int = 2048):
        """Test-time rendering, without autograd, of every ray of
        ``batch['ray_o'/'ray_d']`` ((T, R, 3) per target view or flat
        (N, 3)) in chunks of ``chunk``: the rays are padded by repeating
        the first ones, and the output cut back. Returns rgb (N, 3) and
        depth (N,)."""
        features = self.extract_2d(batch["imgs"])
        ray_o = batch["ray_o"].reshape(-1, 3)
        ray_d = batch["ray_d"].reshape(-1, 3)
        n = ray_o.shape[0]
        pad = (-n) % chunk
        if pad:
            ray_o = torch.cat([ray_o, ray_o[:pad]])
            ray_d = torch.cat([ray_d, ray_d[:pad]])
        proj = self.render_projection(batch["intrinsic"], batch["extrinsics"],
                                      ray_o.device)
        if self.nerf_mode == "volume":
            vol = self.build_volume(features, batch["intrinsic"],
                                    batch["extrinsics"], batch["origin"],
                                    depth=batch.get("depth"))
            volumes = self.render_volumes(vol)

            def chunk_fn(ro, rd):
                return self._render_chunk(ro, rd, None, proj, None,
                                          volumes=volumes, aabb=self.aabb)
        else:
            featmaps = self.render_featmaps(features)
            images = batch["denorm_images"].to(self.compute_dtype)

            def chunk_fn(ro, rd):
                return self._render_chunk(ro, rd, images, proj, featmaps)
        outs = render_ops.render_rays_full(ray_o, ray_d, chunk, chunk_fn)
        return outs["rgb"][:n], outs["depth"][:n]

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                view_group=None, n_ray_shards: int = 1):
        """One scene: ``batch`` holds imgs (V, Hp, Wp, 3), intrinsic
        (4, 4), extrinsics (V, 4, 4), origin (3,), for the density path
        rgb_s1/rgb_s2 (N, 3) or denorm_images (V, Hp, Wp, 3), optionally
        the depth maps depth (V, H, W) (the rgb stream then comes from
        denorm_images, see ``build_volume``), and optionally a ray bundle
        ray_o/ray_d (R, 3) with denorm_images or the host ray stream
        (``data/ray_stats.RAY_STREAM_KEYS``: z_vals and the rgb sums).
        Returns (head_outs, valid, render_out), render_out None without
        rays. The rays' samples are evenly spaced in eval mode and, in
        train mode without ``z_vals``, jittered from ``generator``.
        ``view_group``: the view-led inputs are this rank's views of the
        scene (the host rgb sums, the ray stream and the rays hold every
        view and ray); ``n_ray_shards`` > 1: render_out is this rank's
        slice of the rays (``render``)."""
        features = self.extract_2d(batch["imgs"])
        rgb_stats = ((batch["rgb_s1"], batch["rgb_s2"])
                     if "rgb_s1" in batch else None)
        vol = self.build_volume(features, batch["intrinsic"],
                                batch["extrinsics"], batch["origin"],
                                rgb_stats=rgb_stats,
                                denorm_images=batch.get("denorm_images"),
                                depth=batch.get("depth"),
                                view_group=view_group)
        render_out = None
        if "ray_o" in batch:
            host = (tuple(batch[k] for k in ("ray_s1u", "ray_s2u",
                                             "ray_s1m", "ray_cnt"))
                    if "ray_s1u" in batch else None)
            volumes = (self.render_volumes(vol)
                       if self.nerf_mode == "volume" else None)
            render_out = self.render(
                batch["ray_o"], batch["ray_d"], features,
                batch.get("denorm_images"), batch["intrinsic"],
                batch["extrinsics"], det=not self.training,
                generator=generator, z_vals=batch.get("z_vals"),
                precomputed_rgb=host, view_group=view_group,
                n_ray_shards=n_ray_shards, volumes=volumes)
        return self.detect(vol["det_volume"]), vol["valid"], render_out

    def mlvl_points(self, origin) -> List[torch.Tensor]:
        """Per-scale voxel-center grids, each (P, 3)."""
        dev = next(self.parameters()).device
        pts = []
        for i in range(self.n_scales):
            n_vox = tuple(v // (2 ** i) for v in self.n_voxels)
            size = tuple(s * (2 ** i) for s in self.voxel_size)
            pts.append(get_points(n_vox, size, origin, dev).reshape(-1, 3))
        return pts
