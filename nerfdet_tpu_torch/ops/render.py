"""Ray sampling, view-streaming sample statistics, volume rendering.

Port of the renderer of ``nerfdet_tpu/ops/render.py``: image mode, and
volume mode (``volume_sampling``: the field's features sampled from the
fused volumes, no view loop, no kernel: JAX computes it outside any
Pallas kernel too). In image mode every ray sample point projects into
every source view, where it samples the denormalized image (3 channels)
and the mapped feature map (C channels) bilinearly; the view loop keeps
only running sums, so the (rays, samples, views, 3 + C) tensor never
exists. The carry and its
epilogue (masked mean, variance over all views, ``exp(-var)``, the
two-view mask) are one hand-written CUDA kernel, K2
(``csrc/streaming_sample_mean_var.cu``): the sums stay in registers.
In training the rgb sums come from the host (``data/ray_stats.py``) and
K2 samples only the feature maps. K2 is differentiable in the feature
maps: its backward is the hand-written CUDA kernel
``csrc/streaming_sample_mean_var_backward.cu``, the transpose of the
bilinear taps as a deterministic scatter (pairs sorted by their window
with a counting sort by hand, ``csrc/counting_sort.cuh``).

Exactness: the projection sums its four products in a fixed order with
separately rounded operations, every scalar is a float32 value, and the
bilinear taps add in a fixed order (``ops/grid_sample.py``). The plain
version and K2 follow the same order, so the view masks (a hard
threshold on the projected pixel) agree between them bit for bit.

bfloat16 (the JAX ``--bf16`` path): the feature maps and images may be
bfloat16 (both, in the eval form). The taps round as JAX's (see
``ops/grid_sample.py``: bfloat16 weights for the features, float32 ones
for the rgb, each tap sum rounded to bfloat16); the sums stay float32.
The backward then rounds as XLA's CPU backend runs JAX's transpose
(``ops/bf16.py``): each (point, view)'s float32 cotangent df to
bfloat16, each tap's ``df * w`` to bfloat16, the window sums in point
order and the four windows of a texel in the order tap 2, 3, 1, 0, each
add rounded to bfloat16.

Views sharded over ranks (the JAX function's ``axis_name``, the 2-D
data x views sharding): each rank holds some of a scene's views. K2's
sums form (the same kernel without its epilogue) gives the rank's raw
sums, which are summed over the views group; the epilogue then runs in
torch at the scene's view count. K2's backward takes that view count
apart from its maps' own (``n_views``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel import dist as pdist
from . import cuda_build
from .bf16 import bf16_round, scatter_add_bf16
from .grid_sample import (_window, grid_sample_2d_packed, grid_sample_3d,
                          pack_bilinear)
from .voxel import _SMEM_OPTIN, _host, _ptrs, _stream


def view_projection(intrinsic, extrinsics, ratio: float,
                    device="cpu") -> torch.Tensor:
    """Per-view ``K4 @ pose``, (V, 4, 4) float32.

    The intrinsic goes into a 4x4 identity and its first two rows are
    divided by ``ratio`` (original height / image height). Computed on
    the host in numpy float32, the four products of each entry summed in
    a fixed order, then moved to ``device``."""
    intr, poses = _host(intrinsic), _host(extrinsics)
    intr4 = np.eye(4, dtype=np.float32)
    intr4[:intr.shape[0], :intr.shape[1]] = intr
    intr4[:2] /= np.float32(ratio)
    proj = intr4[None, :, 0, None] * poses[:, None, 0, :]
    for j in (1, 2, 3):
        proj = proj + intr4[None, :, j, None] * poses[:, None, j, :]
    return torch.from_numpy(np.ascontiguousarray(proj, np.float32)).to(device)


def sample_along_camera_ray(ray_o, ray_d, near: float, far: float,
                            n_samples: int, det: bool = True,
                            generator: Optional[torch.Generator] = None):
    """Depths along each ray in [near, far] and their points. ``det``:
    the evenly spaced depths; otherwise each is drawn uniformly inside its
    stratum (between the midpoints to its neighbours) from ``generator``
    (on the rays' device). Returns (pts (R, S, 3), z_vals (R, S))."""
    r = ray_d.shape[0]
    step = (far - near) / (n_samples - 1)
    z = near + step * torch.arange(n_samples, dtype=torch.float32,
                                   device=ray_d.device)
    z_vals = z[None].expand(r, n_samples)
    if not det:
        mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        upper = torch.cat([mids, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], mids], dim=-1)
        t = torch.rand(z_vals.shape, generator=generator,
                       device=ray_d.device)
        z_vals = lower + (upper - lower) * t
    return points_at(ray_o, ray_d, z_vals), z_vals


def points_at(ray_o, ray_d, z_vals):
    """The sample points (R, S, 3) at depths ``z_vals`` (R, S)."""
    return z_vals[..., None] * ray_d[:, None, :] + ray_o[:, None, :]


def project_to_views(pts, proj):
    """Project (..., 3) world points into each view of ``proj`` (V, 4, 4).

    Each row is ``((p0*x + p1*y) + p2*z) + p3``; z is clamped to >= 1e-8
    before the divide and pixels to +-1e6. Returns pixels (V, ..., 2)
    and in_front (V, ...)."""
    shape = pts.shape[:-1]
    xyz = pts.reshape(-1, 3)
    x, y, z = xyz[None, :, 0], xyz[None, :, 1], xyz[None, :, 2]

    def row(i):
        p = proj[:, i, :, None]  # (V, 4, 1)
        return ((p[:, 0] * x + p[:, 1] * y) + p[:, 2] * z) + p[:, 3]

    cx, cy, cz = row(0), row(1), row(2)
    zc = torch.clamp(cz, min=1e-8)
    px = torch.clamp(cx / zc, -1e6, 1e6)
    py = torch.clamp(cy / zc, -1e6, 1e6)
    v = proj.shape[0]
    return (torch.stack([px, py], dim=-1).reshape((v,) + shape + (2,)),
            (cz > 0).reshape((v,) + shape))


def _scale(size: int, img: int) -> float:
    """Pixel -> map coordinate scale ``(size - 1) / (img - 1)`` as a
    float32 value: the projection lives at the image size, a map is
    sampled in its own extent (the images padded, the feature maps
    cropped)."""
    return float(np.float32((size - 1.0) / (img - 1.0)))


def ray_view_carry_plain(pts, images, featmaps, proj, img_hw):
    """K2's carry in plain PyTorch: the sums before the epilogue.

    Args:
        pts: (R, S, 3) float32 sample points.
        images: (V, IH, IW, 3) float32 or bfloat16 denormalized views
            (padded), or None for the feature channels alone (the
            training form, whose rgb sums come from the host).
        featmaps: (V, FH, FW, C) float32 or bfloat16 mapped feature maps
            (cropped).
        proj: (V, 4, 4) float32 ``K4 @ pose`` (``view_projection``).
        img_hw: (h, w) the projection's image size.

    Returns (s1u, s2u, s1m) (R, S, 3 + C), or (R, S, C) without images,
    and cnt (R, S, 1), float32, accumulated in view order: per view the
    point's bilinear sample f ([rgb, features]) adds to ``s1u += f`` and
    ``s2u += f*f`` whatever the view sees; ``s1m += f*m`` and ``cnt += m``
    only where the pixel is inside ``img_hw`` and the point in front of
    the camera (m).
    """
    h, w = img_hw
    r, s, _ = pts.shape
    xyz = pts.reshape(-1, 3)
    fh, fw = featmaps.shape[1:3]
    fsx, fsy = _scale(fw, w), _scale(fh, h)
    c = featmaps.shape[-1] + (0 if images is None else 3)
    s1u = torch.zeros((r * s, c), dtype=torch.float32, device=pts.device)
    s2u, s1m = torch.zeros_like(s1u), torch.zeros_like(s1u)
    cnt = torch.zeros((r * s, 1), dtype=torch.float32, device=pts.device)
    for i in range(featmaps.shape[0]):
        px, py, m = _view_pixels(xyz, proj[i:i + 1], img_hw)
        f = grid_sample_2d_packed(pack_bilinear(featmaps[i]), px * fsx,
                                  py * fsy)
        if images is not None:
            ih, iw = images.shape[1:3]
            f = torch.cat([grid_sample_2d_packed(
                pack_bilinear(images[i]), px * _scale(iw, w),
                py * _scale(ih, h), f32_taps=True), f], dim=-1)
        s1u = s1u + f
        s2u = s2u + f * f
        s1m = s1m + f * m
        cnt = cnt + m
    return (s1u.reshape(r, s, c), s2u.reshape(r, s, c),
            s1m.reshape(r, s, c), cnt.reshape(r, s, 1))


def _view_pixels(xyz, proj_v, img_hw):
    """One view's pixels px, py (N,) of the points ``xyz`` (N, 3) and its
    mask m (N, 1): inside ``img_hw`` and in front of the camera."""
    h, w = img_hw
    pix, in_front = project_to_views(xyz, proj_v)
    px, py = pix[0, :, 0], pix[0, :, 1]
    inbound = (px <= w - 1.0) & (px >= 0) & (py <= h - 1.0) & (py >= 0)
    return px, py, (inbound & in_front[0]).float()[:, None]


def sample_stats(s1u, s2u, s1m, cnt, n_views: int):
    """The plain epilogue of ``ray_view_carry_plain``: (globalfeat (R, S,
    2(3 + C)), pixel_mask (R, S)).

    mean = s1m / (cnt + 1e-8); the variance sums over ALL views,
    ``(s2u - 2*mean*s1u + V*mean^2) / (cnt + 1e-8)``; globalfeat is
    [mean, exp(-var)]; pixel_mask is cnt > 1."""
    denom = cnt + 1e-8
    mean = s1m / denom
    var = (s2u - 2.0 * mean * s1u + n_views * mean * mean) / denom
    return torch.cat([mean, torch.exp(-var)], dim=-1), cnt[..., 0] > 1


def _carry_with_host_rgb(pts, images, proj, img_hw, featmaps,
                         precomputed_rgb):
    """The plain carry of either form: with ``precomputed_rgb`` (the host
    rgb sums (s1u, s2u, s1m) (R, S, 3) and cnt (R, S, 1),
    ``data/ray_stats.host_ray_rgb_stats``) the feature sums with the host
    rgb sums in front of them and the host count; otherwise the carry
    with the images."""
    if precomputed_rgb is None:
        return ray_view_carry_plain(pts, images, featmaps, proj, img_hw)
    feat = ray_view_carry_plain(pts, None, featmaps, proj, img_hw)
    host = [t.float() for t in precomputed_rgb]
    return tuple(torch.cat([hr, fr], dim=-1)
                 for hr, fr in zip(host[:3], feat[:3])) + (host[3],)


def streaming_sample_mean_var_plain(pts, images, proj, img_hw, featmaps,
                                    precomputed_rgb=None, view_group=None):
    """Plain PyTorch version of K2 (same signature and results): the
    carry ``ray_view_carry_plain`` (in the training form only over the
    feature maps, the host rgb sums and count in front), then its
    epilogue ``sample_stats``. With a ``view_group`` the carry's sums
    (``streaming_sample_sums_plain``) are summed over the group first and
    the epilogue takes the scene's view count (``_global_stats``), all of
    it differentiable by torch autograd."""
    if view_group is not None:
        sums = streaming_sample_sums_plain(pts, images, proj, img_hw,
                                           featmaps, precomputed_rgb
                                           is not None)
        return _global_stats(sums, precomputed_rgb, view_group,
                             featmaps)[:2]
    carry = _carry_with_host_rgb(pts, images, proj, img_hw, featmaps,
                                 precomputed_rgb)
    return sample_stats(*carry, featmaps.shape[0])


def streaming_sample_mean_var(pts, images, proj, img_hw, featmaps,
                              precomputed_rgb=None, view_group=None):
    """K2: per-view sampling with masked mean / exp(-var) over views.
    Returns (globalfeat (R, S, 2(3 + C)), pixel_mask (R, S)); see
    ``streaming_sample_mean_var_plain``.

    ``view_group``: the process group over which the scene's views are
    sharded (``images``, ``featmaps`` and ``proj`` hold this rank's
    views, as many on every rank). K2's sums form then gives this rank's
    sums, they are summed over the group and the epilogue runs at the
    scene's view count; the results are the global ones on every rank.
    Its backward sums the cotangent over the group and runs K2's backward
    on this rank's maps at the scene's view count (``_ShardedK2``).

    Two forms: the eval form samples the images' rgb in the kernel; the
    training form takes ``precomputed_rgb``, the host rgb sums and count
    (``data/ray_stats.host_ray_rgb_stats``), samples only the feature
    maps and takes the count from the host (``images`` is then unused).
    Differentiable in ``featmaps`` (float32 or bfloat16, the gradient in
    their dtype), in both forms; the points, images, projections and host
    sums take no gradient.

    A CPU tensor takes the plain version forward and
    ``streaming_sample_mean_var_backward_plain`` backward. A CUDA tensor
    launches the fused kernel and, for the gradient, K2's backward kernel
    (``streaming_sample_mean_var_backward``), or raises where a kernel
    does not take the input.
    """
    if featmaps.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K2 takes float32 or bfloat16 maps, got "
                        f"{featmaps.dtype}")
    host = tuple(precomputed_rgb) if precomputed_rgb is not None else ()
    grad = torch.is_grad_enabled() and featmaps.requires_grad
    if view_group is not None:
        if not grad:
            return _sharded_stats(pts, images, proj, img_hw, featmaps,
                                  host or None, view_group)[:2]
        return _ShardedK2.apply(pts, images, proj, img_hw, featmaps,
                                view_group, *host)
    if not grad:
        return _k2_forward(pts, images, proj, img_hw, featmaps,
                           precomputed_rgb, False)[:2]
    return _StreamingSampleMeanVar.apply(pts, images, proj, img_hw,
                                         featmaps, *host)


streaming_sample_mean_var.launches = 0


def _k2_forward(pts, images, proj, img_hw, featmaps, precomputed_rgb,
                for_grad: bool):
    """K2 by device: (globalfeat, pixel_mask, s1u, cnt), the last two
    being the feature channels' unmasked sums (R, S, C) and the count the
    statistics used (R, S, 1); on the card None unless ``for_grad``. A
    CUDA launch is counted."""
    if pts.device.type == "cpu":
        carry = _carry_with_host_rgb(pts, images, proj, img_hw, featmaps,
                                     precomputed_rgb)
        gf, mask = sample_stats(*carry, featmaps.shape[0])
        c = featmaps.shape[-1]
        return gf, mask, carry[0][..., -c:], carry[3]
    out = _k2_launch(pts, images, proj, img_hw, featmaps, precomputed_rgb,
                     for_grad)
    streaming_sample_mean_var.launches += 1
    return out


class _StreamingSampleMeanVar(torch.autograd.Function):
    """K2 forward and backward, dispatched by device. The forward saves
    globalfeat (its mean and exp(-var) are the backward's residuals), the
    feature channels' unmasked sums s1u and the count; the backward
    recomputes each (point, view)'s bilinear sample from the maps."""

    @staticmethod
    def forward(ctx, pts, images, proj, img_hw, featmaps, *host):
        gf, mask, s1u, cnt = _k2_forward(pts, images, proj, img_hw,
                                         featmaps, host or None, True)
        ctx.mark_non_differentiable(mask)
        ctx.img_hw = img_hw
        ctx.save_for_backward(pts, proj, featmaps, gf, s1u, cnt)
        return gf, mask

    @staticmethod
    def backward(ctx, g, _):
        pts, proj, featmaps, gf, s1u, cnt = ctx.saved_tensors
        d_feats = streaming_sample_mean_var_backward(
            pts, proj, ctx.img_hw, featmaps, g, gf, s1u, cnt)
        return (None, None, None, None, d_feats) + (None,) * (
            len(ctx.needs_input_grad) - 5)


def streaming_sample_sums_plain(pts, images, proj, img_hw, featmaps,
                                host: bool = False):
    """Plain PyTorch version of K2's sums form (same signature and
    results as ``streaming_sample_sums``): ``ray_view_carry_plain`` over
    the views given, (s1u, s2u, s1m) (R, S, 3 + C) and cnt (R, S, 1); with
    ``host`` (the training form, whose rgb sums and count come from the
    host over every view) the feature channels' (R, S, C) and cnt None."""
    if host:
        return ray_view_carry_plain(pts, None, featmaps, proj, img_hw)[:3] + (
            None,)
    return ray_view_carry_plain(pts, images, featmaps, proj, img_hw)


def streaming_sample_sums(pts, images, proj, img_hw, featmaps,
                          host: bool = False):
    """K2's sums form: K2's carry over the views given, without its
    epilogue (see ``streaming_sample_sums_plain``), for a rank that holds
    some of a scene's views. Not differentiable (``_ShardedK2`` is).

    A CPU tensor takes the plain version. A CUDA tensor launches the sums
    form of ``csrc/streaming_sample_mean_var.cu`` (counted), or raises
    where it does not take the input."""
    if pts.device.type == "cpu":
        return streaming_sample_sums_plain(pts, images, proj, img_hw,
                                           featmaps, host)
    out = _sums_launch(pts, images, proj, img_hw, featmaps, host)
    streaming_sample_sums.launches += 1
    return out


streaming_sample_sums.launches = 0


def _sums_launch(pts, images, proj, img_hw, featmaps, host: bool = False):
    """Check and launch K2's sums form on the card; the launch is not
    counted."""
    if host:
        images = None
    _check_k2(pts, images, proj, featmaps, None)
    if not host and images is None:
        raise ValueError("K2's eval form needs the images")
    r, s, _ = pts.shape
    v, fh, fw, c = featmaps.shape
    dev = pts.device
    cso = c if host else 3 + c
    s1u, s2u, s1m = (torch.empty((r, s, cso), dtype=torch.float32,
                                 device=dev) for _ in range(3))
    cnt = None if host else torch.empty((r, s, 1), dtype=torch.float32,
                                        device=dev)
    if r * s == 0:
        return s1u, s2u, s1m, cnt
    h, w = img_hw
    ih, iw, sx, sy = _image_scales(images, img_hw)
    with torch.cuda.device(dev):  # the launch acts on the current device
        err = _lib().streaming_sample_mean_var_sums(
            pts.data_ptr(), None if images is None else images.data_ptr(),
            featmaps.data_ptr(), proj.data_ptr(), int(host),
            *_ptrs(s1u, s2u, s1m, cnt), r * s, v, ih, iw, fh, fw, c, h, w,
            sx, sy, _scale(fw, w), _scale(fh, h), _bf16(featmaps),
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"streaming_sample_mean_var sums launch failed: "
                           f"cudaError {err}")
    return s1u, s2u, s1m, cnt


def _global_stats(sums, host, group, featmaps):
    """A rank's sums (s1u, s2u, s1m, cnt or None in the training form)
    on its ``featmaps`` summed over ``group`` in one all-reduce
    (``dist.all_reduce_sum``, differentiable), the host rgb sums and
    count (global already) in front in the training form, then
    ``sample_stats`` at the scene's view count (as many views on every
    rank). Returns (globalfeat, pixel_mask, s1u, cnt): s1u the feature
    channels' global sums, cnt the global count."""
    summed = pdist.all_reduce_sum(*(t for t in sums if t is not None),
                                  group=group)
    s1u, s2u, s1m = summed[:3]
    if host is not None:
        hs = [t.float() for t in host]
        s1u, s2u, s1m = (torch.cat([a, b], dim=-1)
                         for a, b in zip(hs[:3], (s1u, s2u, s1m)))
        cnt = hs[3]
    else:
        cnt = summed[3]
    gf, mask = sample_stats(s1u, s2u, s1m, cnt,
                            featmaps.shape[0] * pdist.world(group))
    return gf, mask, s1u[..., -featmaps.shape[-1]:], cnt


@torch.no_grad()
def _sharded_stats(pts, images, proj, img_hw, featmaps, host, group):
    """The views-sharded K2 forward: this rank's sums
    (``streaming_sample_sums``), then ``_global_stats``. Returns
    (globalfeat, pixel_mask, s1u, cnt) as ``_k2_forward`` does with
    ``for_grad``, every one global."""
    sums = streaming_sample_sums(pts, images, proj, img_hw, featmaps,
                                 host is not None)
    gf, mask, s1u, cnt = _global_stats(sums, host, group, featmaps)
    return gf, mask, s1u.contiguous(), cnt.contiguous()


class _ShardedK2(torch.autograd.Function):
    """K2 with the views sharded over a group. Forward:
    ``_sharded_stats``. Backward: the cotangent of globalfeat summed over
    the group (with the rays sharded after the aggregation, each rank's is
    non-zero on its own rays only), then K2's backward on this rank's maps
    with the global residuals and view count. The statistics' backward is
    linear in the cotangent and its residuals are the same on every rank,
    so this is the transpose of the sum over the group that JAX's psum
    gives."""

    @staticmethod
    def forward(ctx, pts, images, proj, img_hw, featmaps, group, *host):
        gf, mask, s1u, cnt = _sharded_stats(pts, images, proj, img_hw,
                                            featmaps, host or None, group)
        ctx.mark_non_differentiable(mask)
        ctx.img_hw, ctx.group = img_hw, group
        ctx.save_for_backward(pts, proj, featmaps, gf, s1u, cnt)
        return gf, mask

    @staticmethod
    def backward(ctx, g, _):
        pts, proj, featmaps, gf, s1u, cnt = ctx.saved_tensors
        g = g.float().contiguous().clone()
        pdist.all_reduce_sum_([g], ctx.group)
        d_feats = streaming_sample_mean_var_backward(
            pts, proj, ctx.img_hw, featmaps, g, gf, s1u, cnt,
            n_views=featmaps.shape[0] * pdist.world(ctx.group))
        return (None, None, None, None, d_feats, None) + (None,) * (
            len(ctx.needs_input_grad) - 6)


def _point_cotangents(g, gf, s1u, cnt, n_views: int):
    """The cotangents of the feature channels' sums, each (N, C): d s1u,
    d s2u and d s1m from g, the cotangent of globalfeat (N, 2(3 + C)),
    the forward's globalfeat (mean, exp(-var)), s1u and cnt. With d = cnt
    + 1e-8 and g_var = -g_e exp(-var):

        d s1m = (g_mean + g_var (2 V mean - 2 s1u) / d) / d
        d s2u = g_var / d          d s1u = -2 mean g_var / d
    """
    c = s1u.shape[-1]
    cs = gf.shape[-1] // 2
    g, gf = g.reshape(-1, 2 * cs).float(), gf.reshape(-1, 2 * cs)
    g_mean, g_e = g[:, cs - c:cs], g[:, 2 * cs - c:]
    mean, e = gf[:, cs - c:cs], gf[:, 2 * cs - c:]
    s1u = s1u.reshape(-1, c)
    d = cnt.reshape(-1, 1) + 1e-8
    g_var = -(g_e * e)
    slope = (2.0 * n_views) * mean - 2.0 * s1u
    d_s1m = (g_mean + (g_var * slope) / d) / d
    return ((-2.0 * mean) * g_var) / d, g_var / d, d_s1m


@torch.no_grad()
def streaming_sample_mean_var_backward_plain(pts, proj, img_hw, featmaps, g,
                                             globalfeat, s1u, cnt,
                                             n_views=None):
    """Plain PyTorch version of K2's backward (same signature and result
    as ``streaming_sample_mean_var_backward``): d featmaps (V, FH, FW, C).

    Per point the cotangents of the sums (``_point_cotangents``), then
    per (point, view), with f the bilinear sample recomputed from the map
    and m the view's mask, ``df = d s1u + 2 f d s2u + m d s1m``, and
    ``df * w_k`` goes to each tap k of the point's window
    (``index_add_``, in point order), a tap past the right or bottom edge
    dropped (the transpose of ``pack_bilinear``'s zero pad). On bfloat16
    maps the result is bfloat16, rounded as the module docstring says
    (``_backward_plain_bf16``).
    """
    if featmaps.dtype == torch.bfloat16:
        return _backward_plain_bf16(pts, proj, img_hw, featmaps, g,
                                    globalfeat, s1u, cnt, n_views)
    v, fh, fw, c = featmaps.shape
    h, w = img_hw
    xyz = pts.reshape(-1, 3)
    d_s1u, d_s2u, d_s1m = _point_cotangents(g, globalfeat, s1u, cnt,
                                            n_views or v)
    fsx, fsy = _scale(fw, w), _scale(fh, h)
    out = torch.zeros((v, fh * fw, c), dtype=torch.float32,
                      device=featmaps.device)
    for i in range(v):
        px, py, m = _view_pixels(xyz, proj[i:i + 1], img_hw)
        px, py = px * fsx, py * fsy
        f = grid_sample_2d_packed(pack_bilinear(featmaps[i]), px, py)
        df = (d_s1u + (2.0 * f) * d_s2u) + m * d_s1m
        sx, wx0, wx1 = _window(px, fw)
        sy, wy0, wy1 = _window(py, fh)
        x0, y0 = sx.long(), sy.long()
        for dy, dx, wk in ((0, 0, wy0 * wx0), (0, 1, wy0 * wx1),
                           (1, 0, wy1 * wx0), (1, 1, wy1 * wx1)):
            keep = (x0 + dx < fw) & (y0 + dy < fh)
            lin = ((y0 + dy) * fw + x0 + dx)[keep]
            out[i].index_add_(0, lin, (df * wk[:, None])[keep])
    return out.reshape(v, fh, fw, c)


def _backward_plain_bf16(pts, proj, img_hw, featmaps, g, globalfeat, s1u,
                         cnt, n_views=None):
    """``streaming_sample_mean_var_backward_plain`` on bfloat16 maps: per
    (point, view) df in float32 as there, rounded to bfloat16; each tap's
    ``df * w_k`` (w_k the forward's bfloat16 weight) rounded and added
    to its window in point order (``scatter_add_bf16``; a pair whose four
    weights are 0 adds zeros and is left out); then each texel the sum
    of its four windows' taps in the order 2, 3, 1, 0 (the transpose of
    ``pack_bilinear``), each add rounded."""
    v, fh, fw, c = featmaps.shape
    xyz = pts.reshape(-1, 3)
    cot = _point_cotangents(g, globalfeat, s1u, cnt, n_views or v)
    win = torch.empty((v, fh, fw, 4, c), dtype=torch.float32,
                      device=featmaps.device)
    for i in range(v):
        df, wgt, lin, kept = _view_pairs_bf16(xyz, proj[i:i + 1], img_hw,
                                              featmaps[i], *cot)
        rows = (df[:, None, :] * wgt[:, :, None]).reshape(-1, 4 * c)
        win[i] = scatter_add_bf16(fh * fw, lin[kept],
                                  rows[kept]).reshape(fh, fw, 4, c)
    return _texels(win, torch.bfloat16)


def _view_pairs_bf16(xyz, proj_v, img_hw, feat_v, d_s1u, d_s2u, d_s1m):
    """One view's (point, view) pairs on bfloat16 maps: df (N, C) float32
    holding bfloat16 values, ``bf16((d s1u + (2 f) d s2u) + m d s1m)``
    with f the forward's bfloat16 sample and m the view's mask; the four
    bfloat16 tap weights (N, 4) as float32 (00, 01, 10, 11); the window's
    start texel (N,) int64; and the pairs kept (N,), a weight non-zero."""
    fh, fw = feat_v.shape[:2]
    px, py, m = _view_pixels(xyz, proj_v, img_hw)
    px, py = px * _scale(fw, img_hw[1]), py * _scale(fh, img_hw[0])
    f = grid_sample_2d_packed(pack_bilinear(feat_v), px, py)
    df = bf16_round((d_s1u + (2.0 * f) * d_s2u) + m * d_s1m)
    sx, wx0, wx1 = _window(px, fw)
    sy, wy0, wy1 = _window(py, fh)
    wgt = bf16_round(torch.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0,
                                  wy1 * wx1], -1))
    return df, wgt, sy.long() * fw + sx.long(), (wgt != 0).any(-1)


def _texels(win, dtype):
    """d featmaps (V, FH, FW, C) in ``dtype`` from the windows' tap sums
    ``win`` (V, FH, FW, 4, C) float32: each texel the sum of the four
    windows that hold it, a tap past the right or bottom edge dropped (the
    transpose of ``pack_bilinear``'s zero pad); in the order 00, 01, 10,
    11 for float32, in the order 10, 11, 01, 00 for bfloat16 with each
    add rounded."""
    v, fh, fw, _, c = win.shape
    pad = torch.zeros((v, fh + 1, fw + 1, 4, c), dtype=torch.float32,
                      device=win.device)
    pad[:, 1:, 1:] = win
    t00, t01 = pad[:, 1:, 1:, 0], pad[:, 1:, :-1, 1]
    t10, t11 = pad[:, :-1, 1:, 2], pad[:, :-1, :-1, 3]
    if dtype == torch.bfloat16:
        acc = bf16_round(bf16_round(t10 + t11) + t01)
        return bf16_round(acc + t00).to(torch.bfloat16)
    return ((t00 + t01) + t10) + t11


def streaming_sample_mean_var_backward(pts, proj, img_hw, featmaps, g,
                                       globalfeat, s1u, cnt, n_views=None):
    """K2's backward: d featmaps (V, FH, FW, C) from g, the cotangent of
    globalfeat (R, S, 2(3 + C)), given the forward's globalfeat, the
    feature channels' unmasked sums s1u (R, S, C) and the count its
    statistics used (R, S, 1). Either form's: the backward reads only the
    feature channels. ``n_views`` is the V of the statistics, V itself
    where None; more where the maps are this rank's share of a scene's
    views (``_ShardedK2``).

    A CPU tensor takes the plain version. A CUDA tensor launches the
    backward kernel (``csrc/streaming_sample_mean_var_backward.cu``), or
    raises where it does not take the input.
    """
    if featmaps.device.type == "cpu":
        return streaming_sample_mean_var_backward_plain(
            pts, proj, img_hw, featmaps, g, globalfeat, s1u, cnt, n_views)
    out = _backward_launch(pts, proj, img_hw, featmaps, g, globalfeat, s1u,
                           cnt, n_views)
    streaming_sample_mean_var_backward.launches += 1
    return out


streaming_sample_mean_var_backward.launches = 0


def _check_k2(pts, images, proj, featmaps, host):
    """Checks K2's inputs on the card (``images`` None in the training
    form, where ``host`` holds the four host sums)."""
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    if featmaps.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K2 takes float32 or bfloat16 maps, got "
                        f"{featmaps.dtype}")
    if images is not None and images.dtype != featmaps.dtype:
        raise TypeError(f"K2 takes images of the maps' dtype "
                        f"{featmaps.dtype}, got {images.dtype}")
    named = [("pts", pts), ("featmaps", featmaps), ("proj", proj)]
    named += [("images", images)] if images is not None else []
    named += list(zip(("s1u", "s2u", "s1m", "cnt"), host or ()))
    for name, t in named:
        if t.dtype != torch.float32 and name not in ("featmaps", "images"):
            raise TypeError(f"K2 takes float32 {name}, got {t.dtype}")
        if t.device != pts.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {pts.device}")
    r, s, _ = pts.shape
    v, _, _, c = featmaps.shape
    if (pts.shape[2] != 3 or proj.shape != (v, 4, 4)
            or (images is not None and (images.shape[3] != 3
                                        or images.shape[0] != v))):
        raise ValueError("K2 needs pts (R, S, 3), images (V, H, W, 3), "
                         "featmaps (V, h, w, C) and proj (V, 4, 4)")
    if host is not None and [tuple(t.shape) for t in host] != [
            (r, s, 3)] * 3 + [(r, s, 1)]:
        raise ValueError("the host rgb sums must be (R, S, 3) x 3 and the "
                         "count (R, S, 1)")
    if not 1 <= c <= 32:
        raise ValueError(f"K2 takes 1 to 32 feature channels, got {c}")


def _k2_launch(pts, images, proj, img_hw, featmaps, precomputed_rgb=None,
               for_grad: bool = False):
    """Check and launch K2 on the card; the launch is not counted.
    Returns (globalfeat, pixel_mask, s1u, cnt): with ``for_grad`` the
    kernel also writes the feature channels' unmasked sums s1u (R, S, C)
    and, in the eval form, its count (the training form's is the host
    one); otherwise both are None."""
    host = (None if precomputed_rgb is None
            else [t.contiguous() for t in precomputed_rgb])
    if host is not None:
        images = None
    _check_k2(pts, images, proj, featmaps, host)
    r, s, _ = pts.shape
    v, fh, fw, c = featmaps.shape
    dev = pts.device
    gf = torch.empty((r, s, 2 * (3 + c)), dtype=torch.float32, device=dev)
    mask = torch.empty((r, s), dtype=torch.bool, device=dev)
    s1u = cnt = None
    if for_grad:
        s1u = torch.empty((r, s, c), dtype=torch.float32, device=dev)
        cnt = (host[3] if host is not None else
               torch.empty((r, s, 1), dtype=torch.float32, device=dev))
    n = r * s
    if n == 0:
        return gf, mask, s1u, cnt
    h, w = img_hw
    ih, iw, sx, sy = _image_scales(images, img_hw)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    with torch.cuda.device(dev):  # the launch acts on the current device
        err = lib.streaming_sample_mean_var(
            pts.data_ptr(), ptr(images), featmaps.data_ptr(),
            proj.data_ptr(), *(ptr(t) for t in host or (None,) * 4),
            gf.data_ptr(),
            mask.data_ptr(), ptr(s1u),
            ptr(cnt if host is None else None), n, v, ih, iw, fh, fw, c,
            h, w, sx, sy, _scale(fw, w), _scale(fh, h), _bf16(featmaps),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"streaming_sample_mean_var kernel launch "
                           f"failed: cudaError {err}")
    return gf, mask, s1u, cnt


def _image_scales(images, img_hw):
    """(IH, IW, sx, sy): the images' size and the scale of the
    projection's pixels into them; zeros without images (the training
    form)."""
    if images is None:
        return 0, 0, 0.0, 0.0
    ih, iw = images.shape[1:3]
    return ih, iw, _scale(iw, img_hw[1]), _scale(ih, img_hw[0])


def _lib():
    lib = cuda_build.load("streaming_sample_mean_var")
    fn = lib.streaming_sample_mean_var
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 12 + [i] * 9 + [f] * 4 + [i, p]
        fn.restype = ctypes.c_int
        sums = lib.streaming_sample_mean_var_sums
        sums.argtypes = [p] * 4 + [i] + [p] * 4 + [i] * 9 + [f] * 4 + [i, p]
        sums.restype = ctypes.c_int
    return lib


def _backward_launch(pts, proj, img_hw, featmaps, g, globalfeat, s1u, cnt,
                     n_views=None):
    """Check and launch K2's backward; returns d featmaps. Pass 0
    (``_backward_keys``) keys each (point, view) pair by its feature
    window and writes the points' cotangents; the index preparation
    (``_window_order_launch``, a counting sort by hand) lists each
    window's kept pairs in point order; pass 1 (``_window_sums``) sums
    each window's pairs, pass 2 (``_unpack``) unpacks the windows into
    texels. On bfloat16 maps, rounding as ``_backward_plain_bf16`` does:
    pass 0 writes only the keys; the index preparation
    (``_window_rank_launch``) gives each kept pair's slot in that order;
    pass 1a (``_pair_df``) forms each kept pair's df once, at its slot;
    pass 1b (``_window_sums_bf16``) sums each window's slots; pass 2 as
    above. The launch is not counted."""
    _check_k2(pts, None, proj, featmaps, None)
    r, s, _ = pts.shape
    v, fh, fw, c = featmaps.shape
    n, cs, dev = r * s, 3 + c, pts.device
    for name, t, shape in (("g", g, (r, s, 2 * cs)),
                           ("globalfeat", globalfeat, (r, s, 2 * cs)),
                           ("s1u", s1u, (r, s, c)), ("cnt", cnt, (r, s, 1))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != dev):
            raise ValueError(f"{name} must be a float32 {shape} tensor on "
                             f"{dev}")
    if v * n >= 2 ** 31 or v * fh * fw * 4 * c >= 2 ** 31:
        raise ValueError("K2's backward indexes pairs and texels in int32")
    if 4 * (fh * fw + 1) > _SMEM_OPTIN:
        raise ValueError(f"K2's backward keeps a map's {fh * fw} windows in "
                         f"shared memory: at most {_SMEM_OPTIN // 4 - 1}")
    if n == 0:
        return torch.zeros_like(featmaps)
    g, globalfeat, s1u, cnt = (t.contiguous() for t in (g, globalfeat, s1u,
                                                          cnt))
    keys, coef = _backward_keys(pts, proj, img_hw, featmaps, g, globalfeat,
                                s1u, cnt, n_views)
    if featmaps.dtype == torch.bfloat16:
        rank, off = _window_rank_launch(keys, fh * fw)
        df, wts = _pair_df(pts, proj, img_hw, featmaps, g, globalfeat, s1u,
                           cnt, rank, n_views)
        packed = _window_sums_bf16(df, wts, off, featmaps)
    else:
        order, off = _window_order_launch(keys, fh * fw)
        packed = _window_sums(pts, proj, img_hw, featmaps, coef, order, off)
    return _unpack(packed, off, featmaps)


def _backward_keys(pts, proj, img_hw, featmaps, g, globalfeat, s1u, cnt,
                   n_views=None):
    """K2's backward pass 0 on checked, contiguous inputs: the pairs'
    keys (V, N) int32 and, on float32 maps, the points' cotangents coef
    (N, 3, C), rows (d s1u + d s1m, d s1u, d s2u), at the statistics' view
    count ``n_views`` (V where None); None on bfloat16 maps, whose pass 1a
    forms them (``backward_keys_plain`` is the twin)."""
    r, s, _ = pts.shape
    v, fh, fw, c = featmaps.shape
    n, dev = r * s, pts.device
    keys = torch.empty((v, n), dtype=torch.int32, device=dev)
    coef = (None if featmaps.dtype == torch.bfloat16 else
            torch.empty((n, 3, c), dtype=torch.float32, device=dev))
    with torch.cuda.device(dev):  # the launches act on the current device
        err = _backward_lib().streaming_sample_mean_var_backward_keys(
            *_ptrs(pts, proj, g, globalfeat, s1u, cnt, keys, coef), n, v,
            n_views or v, fh, fw, c, *img_hw, _scale(fw, img_hw[1]),
            _scale(fh, img_hw[0]), _stream(dev))
    if err != 0:
        raise RuntimeError(f"streaming_sample_mean_var backward pass 0 "
                           f"launch failed: cudaError {err}")
    return keys, coef


def _window_order_launch(keys, hw: int, rank: bool = False):
    """K2's backward index preparation on the card, a stable counting
    sort of each view's pairs by window: ``window_order``'s (order, off),
    ``order``'s entries past ``off[-1]`` unspecified; with ``rank``
    ``window_rank``'s (rank, off) instead, the dropped pairs' entries
    unspecified."""
    v, n = keys.shape
    dev = keys.device
    lib = _backward_lib()
    tiles = -(-n // lib.streaming_sample_mean_var_backward_tile())
    if v * (tiles + 1) * hw >= 2 ** 31:
        raise ValueError("K2's backward indexes its tiles' bins in int32")
    # the tiles' histograms, then each view's bin totals
    hist = torch.empty((v * (tiles + 1), hw), dtype=torch.int32, device=dev)
    kept = torch.empty((v, tiles), dtype=torch.int32, device=dev)
    out = torch.empty((v * n,), dtype=torch.int32, device=dev)
    off = torch.empty((v * hw + 1,), dtype=torch.int32, device=dev)
    sort = (lib.streaming_sample_mean_var_backward_rank if rank else
            lib.streaming_sample_mean_var_backward_order)
    with torch.cuda.device(dev):  # the launches act on the current device
        err = sort(*_ptrs(keys, hist, kept, out, off), n, v, hw,
                   _stream(dev))
    if err != 0:
        raise RuntimeError(f"streaming_sample_mean_var backward index "
                           f"preparation failed: cudaError {err}")
    return out, off


def _window_rank_launch(keys, hw: int):
    """K2's backward index preparation for bfloat16 maps on the card:
    ``window_rank``'s (rank, off), the dropped pairs' ranks
    unspecified."""
    return _window_order_launch(keys, hw, rank=True)


def _pair_df(pts, proj, img_hw, featmaps, g, globalfeat, s1u, cnt, rank,
             n_views=None):
    """K2's backward pass 1a on bfloat16 maps, on checked, contiguous
    inputs: each kept pair's df and four tap weights at its slot
    ``rank[v N + n]``, df (V N, C) and wts (V N, 4) bfloat16, the slots
    past the kept pairs unwritten, the statistics at ``n_views`` (V where
    None; ``pair_df_plain`` is the twin)."""
    r, s, _ = pts.shape
    v, fh, fw, c = featmaps.shape
    n, dev = r * s, pts.device
    # 8 values past the last slot: pass 1b copies whole 16-byte chunks
    df = torch.empty((v * n * c + 8,), dtype=torch.bfloat16,
                     device=dev)[:v * n * c].view(v * n, c)
    wts = torch.empty((v * n, 4), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):  # the launch acts on the current device
        err = _backward_lib().streaming_sample_mean_var_backward_pairs(
            *_ptrs(pts, proj, featmaps, g, globalfeat, s1u, cnt, rank, df,
                   wts), n, v, n_views or v, fh, fw, c, *img_hw,
            _scale(fw, img_hw[1]), _scale(fh, img_hw[0]), _stream(dev))
    if err != 0:
        raise RuntimeError(f"streaming_sample_mean_var backward pass 1a "
                           f"launch failed: cudaError {err}")
    return df, wts


def _window_sums_bf16(df, wts, off, featmaps):
    """K2's backward pass 1b on bfloat16 maps: packed (V FH FW, 4, C)
    bfloat16, each window's four taps' sums over its slots in order, each
    tap and each add rounded; a window that holds no pair is left
    unwritten (``window_sums_bf16_plain`` is the twin). ``df`` is
    ``_pair_df``'s: its storage holds 8 values past its last slot."""
    v, fh, fw, c = featmaps.shape
    dev = featmaps.device
    packed = torch.empty((v * fh * fw, 4, c), dtype=torch.bfloat16,
                         device=dev)
    with torch.cuda.device(dev):  # the launch acts on the current device
        err = _backward_lib().streaming_sample_mean_var_backward_windows_bf16(
            *_ptrs(df, wts, off, packed), v * fh * fw, c, df.shape[0],
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"streaming_sample_mean_var backward pass 1b "
                           f"launch failed: cudaError {err}")
    return packed


def _window_sums(pts, proj, img_hw, featmaps, coef, order, off):
    """K2's backward pass 1 on float32 maps: packed (V FH FW, 4, C)
    float32, each window's four taps' sums over its pairs in point order;
    a window that holds no pair is left unwritten."""
    v, fh, fw, c = featmaps.shape
    n, dev = coef.shape[0], pts.device
    packed = torch.empty((v * fh * fw, 4, c), dtype=torch.float32,
                         device=dev)
    with torch.cuda.device(dev):  # the launch acts on the current device
        err = _backward_lib().streaming_sample_mean_var_backward_windows(
            *_ptrs(pts, proj, featmaps, coef, order, off, packed), n, v, fh,
            fw, c, *img_hw, _scale(fw, img_hw[1]), _scale(fh, img_hw[0]),
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"streaming_sample_mean_var backward pass 1 "
                           f"launch failed: cudaError {err}")
    return packed


def _unpack(packed, off, featmaps):
    """K2's backward pass 2: d featmaps, in the maps' dtype, from the
    packed windows (in the maps' dtype too; ``unpack_plain`` is the
    twin)."""
    v, fh, fw, c = featmaps.shape
    dev = featmaps.device
    d_feats = torch.empty_like(featmaps)
    with torch.cuda.device(dev):  # the launch acts on the current device
        err = _backward_lib().streaming_sample_mean_var_backward_unpack(
            *_ptrs(packed, off, d_feats), v, fh, fw, c, _bf16(featmaps),
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"streaming_sample_mean_var backward pass 2 "
                           f"launch failed: cudaError {err}")
    return d_feats


def _bf16(featmaps) -> int:
    return int(featmaps.dtype == torch.bfloat16)


def window_order_plain(keys, n_windows: int):
    """Plain version of K2's backward index preparation (same signature
    as ``window_order``): the pairs sorted stably by key, ``order`` (V N)
    int32 (the dropped pairs, keyed ``n_windows``, last), and ``off``
    (n_windows + 1) int32, where each window's pairs start in ``order``;
    window k has ``off[k + 1] - off[k]`` of them, in ascending pair (so
    point) order."""
    sorted_keys, order = torch.sort(keys.reshape(-1), stable=True)
    bounds = torch.arange(n_windows + 1, dtype=torch.int32,
                          device=keys.device)
    off = torch.searchsorted(sorted_keys, bounds, out_int32=True)
    return order.to(torch.int32), off


def window_order(keys, n_windows: int):
    """The inverse index of K2's backward from the pairs' keys (V, N):
    (order, off) as ``window_order_plain`` gives them, except that on the
    card ``order``'s entries past ``off[-1]`` (the dropped pairs') are
    unspecified. A CPU tensor takes the plain version; a CUDA tensor the
    counting sort of ``csrc/counting_sort.cuh``."""
    if keys.device.type == "cpu":
        return window_order_plain(keys, n_windows)
    return _window_order_launch(keys.contiguous(),
                                n_windows // keys.shape[0])


def window_rank_plain(keys, n_windows: int):
    """Plain version of K2's backward index preparation for bfloat16 maps
    (same signature as ``window_rank``): ``rank`` (V N) int32, the slot
    of each kept pair in ``window_order_plain``'s order (its inverse), -1
    for a dropped pair, and ``off`` as there."""
    order, off = window_order_plain(keys, n_windows)
    kept = int(off[-1])
    rank = torch.full((order.numel(),), -1, dtype=torch.int32,
                      device=keys.device)
    rank[order[:kept].long()] = torch.arange(kept, dtype=torch.int32,
                                             device=keys.device)
    return rank, off


def window_rank(keys, n_windows: int):
    """Each kept pair's slot in K2's backward window order from the
    pairs' keys (V, N): (rank, off) as ``window_rank_plain`` gives them,
    except that on the card a dropped pair's rank is unspecified. A CPU
    tensor takes the plain version; a CUDA tensor the counting sort of
    ``csrc/counting_sort.cuh``."""
    if keys.device.type == "cpu":
        return window_rank_plain(keys, n_windows)
    return _window_rank_launch(keys.contiguous(),
                               n_windows // keys.shape[0])


@torch.no_grad()
def backward_keys_plain(pts, proj, img_hw, featmaps, g, globalfeat, s1u,
                        cnt, n_views=None):
    """Plain twin of ``_backward_keys``: each (point n, view v) pair's
    key (V, N) int32, v FH FW + its feature window's start texel, or V FH
    FW where its four tap weights are 0; and on float32 maps the points'
    cotangents (N, 3, C), rows (d s1u + d s1m, d s1u, d s2u), at the
    statistics' view count ``n_views`` (V where None), None on bfloat16
    maps."""
    v, fh, fw, c = featmaps.shape
    xyz = pts.reshape(-1, 3)
    keys = []
    for i in range(v):
        px, py, _ = _view_pixels(xyz, proj[i:i + 1], img_hw)
        sx, wx0, wx1 = _window(px * _scale(fw, img_hw[1]), fw)
        sy, wy0, wy1 = _window(py * _scale(fh, img_hw[0]), fh)
        zero = ((wy0 * wx0 == 0) & (wy0 * wx1 == 0) & (wy1 * wx0 == 0)
                & (wy1 * wx1 == 0))
        keys.append(torch.where(zero, v * fh * fw, i * fh * fw
                                + sy.long() * fw + sx.long()))
    keys = torch.stack(keys).to(torch.int32)
    if featmaps.dtype == torch.bfloat16:
        return keys, None
    d_s1u, d_s2u, d_s1m = _point_cotangents(g, globalfeat, s1u, cnt,
                                            n_views or v)
    return keys, torch.stack([d_s1u + d_s1m, d_s1u, d_s2u], 1)


@torch.no_grad()
def pair_df_plain(pts, proj, img_hw, featmaps, g, globalfeat, s1u, cnt,
                  rank, n_views=None):
    """Plain twin of ``_pair_df``: (df (V N, C), wts (V N, 4)), bfloat16,
    each kept pair's df and tap weights (``_view_pairs_bf16``) at its
    slot ``rank[v N + n]``, zeros past the kept pairs; the statistics at
    ``n_views`` (V where None)."""
    v, fh, fw, c = featmaps.shape
    xyz = pts.reshape(-1, 3)
    n = xyz.shape[0]
    cot = _point_cotangents(g, globalfeat, s1u, cnt, n_views or v)
    df = torch.zeros((v * n, c), dtype=torch.float32, device=pts.device)
    wts = torch.zeros((v * n, 4), dtype=torch.float32, device=pts.device)
    for i in range(v):
        d, wgt, _, kept = _view_pairs_bf16(xyz, proj[i:i + 1], img_hw,
                                           featmaps[i], *cot)
        slot = rank[i * n:(i + 1) * n][kept].long()
        df[slot], wts[slot] = d[kept], wgt[kept]
    return df.to(torch.bfloat16), wts.to(torch.bfloat16)


@torch.no_grad()
def window_sums_bf16_plain(df, wts, off, featmaps):
    """Plain twin of ``_window_sums_bf16``: packed (V FH FW, 4, C)
    bfloat16, window k the sums of ``df[j] * wts[j, tap]`` over its slots
    j in [off[k], off[k + 1]) in order, each product and each add rounded
    to bfloat16 (``scatter_add_bf16``); zeros where a window holds no
    pair."""
    c = featmaps.shape[-1]
    n_win = off.numel() - 1
    kept = int(off[-1])
    win = torch.repeat_interleave(torch.arange(n_win, device=off.device),
                                  (off[1:] - off[:-1]).long())
    rows = (df[:kept].float()[:, None, :]
            * wts[:kept].float()[:, :, None]).reshape(kept, 4 * c)
    return scatter_add_bf16(n_win, win, rows).reshape(
        n_win, 4, c).to(torch.bfloat16)


@torch.no_grad()
def unpack_plain(packed, off, featmaps):
    """Plain twin of ``_unpack``: d featmaps in the maps' dtype from the
    packed windows (V FH FW, 4, C), reading only the windows that hold a
    pair (``_texels``' order)."""
    v, fh, fw, c = featmaps.shape
    held = (off[1:] > off[:-1])[:, None, None]
    win = torch.where(held, packed.float(), 0.0)
    return _texels(win.reshape(v, fh, fw, 4, c), featmaps.dtype)


def _backward_lib():
    lib = cuda_build.load("streaming_sample_mean_var_backward")
    keys = lib.streaming_sample_mean_var_backward_keys
    if keys.argtypes is None:  # pointers must not pass as 32-bit ints
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        keys.argtypes = [p] * 8 + [i] * 8 + [f] * 2 + [p]
        keys.restype = ctypes.c_int
        lib.streaming_sample_mean_var_backward_tile.argtypes = []
        lib.streaming_sample_mean_var_backward_tile.restype = ctypes.c_int
        for name in ("order", "rank"):
            sort = getattr(lib, f"streaming_sample_mean_var_backward_{name}")
            sort.argtypes = [p] * 5 + [i] * 3 + [p]
            sort.restype = ctypes.c_int
        windows = lib.streaming_sample_mean_var_backward_windows
        windows.argtypes = [p] * 7 + [i] * 7 + [f] * 2 + [p]
        windows.restype = ctypes.c_int
        pairs = lib.streaming_sample_mean_var_backward_pairs
        pairs.argtypes = [p] * 10 + [i] * 8 + [f] * 2 + [p]
        pairs.restype = ctypes.c_int
        windows_bf16 = lib.streaming_sample_mean_var_backward_windows_bf16
        windows_bf16.argtypes = [p] * 4 + [i] * 3 + [p]
        windows_bf16.restype = ctypes.c_int
        unpack = lib.streaming_sample_mean_var_backward_unpack
        unpack.argtypes = [p] * 3 + [i] * 5 + [p]
        unpack.restype = ctypes.c_int
    return lib


def raw2outputs(raw, z_vals, mask) -> Dict[str, torch.Tensor]:
    """Alpha compositing of (R, S, 4) [rgb, sigma] along each ray: rgb
    (R, 3), depth (R,) clamped to the sampled range, and the ray mask
    (R,), set where more than 8 samples are seen by at least two views
    (``mask`` (R, S)). The JAX version also returns the per-sample
    weights, alpha and transmittance, which nothing reads."""
    rgb = raw[:, :, :3]
    sigma = raw[:, :, 3]
    alpha = 1.0 - torch.exp(-sigma)
    t = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)[:, :-1]
    t = torch.cat([torch.ones_like(t[:, :1]), t], dim=-1)
    weights = alpha * t
    rgb_map = torch.sum(weights[..., None] * rgb, dim=1)
    ray_mask = mask.float().sum(dim=1) > 8
    depth_map = torch.sum(weights * z_vals, dim=-1) / (
        torch.sum(weights, dim=-1) + 1e-8)
    depth_map = torch.clamp(depth_map, z_vals.min(), z_vals.max())
    return dict(rgb=rgb_map, depth=depth_map, mask=ray_mask)


def volume_sampling(pts, volume, aabb):
    """Trilinear lookup of an (nx, ny, nz, C) volume at the points (...,
    3), normalized by the box ``aabb`` ((x0, y0, z0), (x1, y1, z1)) to
    [-1, 1] and sampled with border padding, each world axis on its own
    voxel axis. Returns the features (..., C) and ``inbound`` (...,):
    the point lies strictly inside the box."""
    lo = torch.tensor(aabb[0], dtype=torch.float32, device=pts.device)
    hi = torch.tensor(aabb[1], dtype=torch.float32, device=pts.device)
    norm = (pts - lo) / (hi - lo) * 2.0 - 1.0
    inbound = torch.all((norm > -1) & (norm < 1), dim=-1)
    nx, ny, nz = volume.shape[:3]
    ix = (norm[..., 0] + 1.0) / 2.0 * (nx - 1)
    iy = (norm[..., 1] + 1.0) / 2.0 * (ny - 1)
    iz = (norm[..., 2] + 1.0) / 2.0 * (nz - 1)
    # (D, H, W) = (nx, ny, nz): px indexes W = z, pz indexes D = x
    return grid_sample_3d(volume, iz, iy, ix, padding="border"), inbound


def _volume_mode(pts, proj, img_hw, volumes, aabb):
    """The volume-mode render's field inputs: the mapped mean and cov
    volumes sampled at the points, the two-view mask from the projection
    alone (JAX samples the images there and drops them) and ``inbound``
    (the density is zeroed outside the box)."""
    mean_pts, inbound = volume_sampling(pts, volumes[0], aabb)
    cov_pts, _ = volume_sampling(pts, volumes[1], aabb)
    pixels, in_front = project_to_views(pts, proj)
    px, py = pixels[..., 0], pixels[..., 1]
    h, w = img_hw
    seen = (px <= w - 1.0) & (px >= 0) & (py <= h - 1.0) & (py >= 0)
    count = (seen & in_front).float().sum(dim=0)
    return torch.cat([mean_pts, cov_pts], dim=-1), count > 1, inbound


def render_rays_chunk(ray_o, ray_d, mlp_fn: Callable, *,
                      near_far: Tuple[float, float], n_samples: int,
                      images, proj, img_hw, featmaps, det: bool = True,
                      generator: Optional[torch.Generator] = None,
                      z_vals=None, precomputed_rgb=None, view_group=None,
                      n_ray_shards: int = 1, volumes=None,
                      aabb=None) -> Dict:
    """Render one chunk of rays in image mode, or in volume mode where
    ``volumes`` (the mapped mean and cov volumes, each (nx, ny, nz, C'))
    are given: the field's features are then those volumes sampled
    trilinearly in the box ``aabb`` (``volume_sampling``) and its density
    is zeroed outside it; ``images`` and ``featmaps`` are not read, and
    the views are not sharded (``NerfDet.render`` refuses a group).

    ``mlp_fn(pts, viewdirs, features) -> (rgb, sigma)`` is the radiance
    field. The samples: at ``z_vals`` (R, S) where given (the host's
    stratified depths), else ``sample_along_camera_ray`` (evenly spaced
    if ``det``, else jittered from ``generator``); the view statistics
    (K2, in its training form with ``precomputed_rgb``) as the field's
    features, then compositing (``raw2outputs``).

    ``view_group``: the images, maps and projections are this rank's
    views of the scene, and the statistics are summed over the group
    (``streaming_sample_mean_var``). With ``n_ray_shards`` > 1 the rank
    then keeps its contiguous R / n slice of the rays (the rank's place
    in the group), and the outputs are that slice's. The samples are
    drawn for every ray first, so nothing depends on the shard count."""
    if z_vals is not None:
        pts = points_at(ray_o, ray_d, z_vals)
    else:
        pts, z_vals = sample_along_camera_ray(
            ray_o, ray_d, near_far[0], near_far[1], n_samples, det=det,
            generator=generator)
    if volumes is not None:
        globalfeat, pixel_mask, inbound = _volume_mode(pts, proj, img_hw,
                                                       volumes, aabb)
        rgb_pts, density_pts = mlp_fn(pts, ray_d, globalfeat)
        density_pts = density_pts * inbound[..., None]
        return raw2outputs(torch.cat([rgb_pts, density_pts], dim=-1),
                           z_vals, pixel_mask)
    globalfeat, pixel_mask = streaming_sample_mean_var(
        pts, images, proj, img_hw, featmaps, precomputed_rgb, view_group)
    if n_ray_shards > 1:
        if view_group is None:
            raise ValueError("sharding the rays needs the views group")
        r = ray_d.shape[0]
        if r % n_ray_shards:
            raise ValueError(f"{r} rays do not split over {n_ray_shards} "
                             f"shards")
        part = r // n_ray_shards
        lo = pdist.rank(view_group) * part
        pts, z_vals, globalfeat, pixel_mask, ray_d = (
            t[lo:lo + part] for t in (pts, z_vals, globalfeat, pixel_mask,
                                      ray_d))
    rgb_pts, density_pts = mlp_fn(pts, ray_d, globalfeat)
    return raw2outputs(torch.cat([rgb_pts, density_pts], dim=-1), z_vals,
                       pixel_mask)


def render_rays_full(ray_o, ray_d, chunk: int, render_fn: Callable):
    """Full-image rendering as a loop over ray chunks.

    ``ray_o``/``ray_d``: (N, 3) with N a multiple of ``chunk`` (pad
    upstream). ``render_fn(ray_o_chunk, ray_d_chunk) -> dict`` with at
    least rgb and depth. Returns rgb (N, 3) and depth (N,)."""
    n = ray_o.shape[0]
    if n % chunk:
        raise ValueError("pad rays to a multiple of the chunk size")
    outs = [render_fn(ray_o[i:i + chunk], ray_d[i:i + chunk])
            for i in range(0, n, chunk)]
    return {"rgb": torch.cat([o["rgb"] for o in outs]),
            "depth": torch.cat([o["depth"] for o in outs])}
