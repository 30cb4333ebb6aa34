"""Ray sampling, view-streaming sample statistics, volume rendering.

Port of the image-mode renderer of ``nerfdet_tpu/ops/render.py``. Every
ray sample point projects into every source view, where it samples the
denormalized image (3 channels) and the mapped feature map (C channels)
bilinearly; the view loop keeps only running sums, so the
(rays, samples, views, 3 + C) tensor never exists. The carry and its
epilogue (masked mean, variance over all views, ``exp(-var)``, the
two-view mask) are one hand-written CUDA kernel, K2
(``csrc/streaming_sample_mean_var.cu``): the sums stay in registers.

Exactness: the projection sums its four products in a fixed order with
separately rounded operations, every scalar is a float32 value, and the
bilinear taps add in a fixed order (``ops/grid_sample.py``). The plain
version and K2 follow the same order, so the view masks (a hard
threshold on the projected pixel) agree between them bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from . import cuda_build
from .grid_sample import grid_sample_2d_packed, pack_bilinear
from .voxel import _host


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
                            n_samples: int):
    """Evenly spaced depths in [near, far] (the deterministic branch of
    the stratified sampler). Returns (pts (R, S, 3), z_vals (R, S))."""
    r = ray_d.shape[0]
    step = (far - near) / (n_samples - 1)
    z = near + step * torch.arange(n_samples, dtype=torch.float32,
                                   device=ray_d.device)
    z_vals = z[None].expand(r, n_samples)
    pts = z_vals[..., None] * ray_d[:, None, :] + ray_o[:, None, :]
    return pts, z_vals


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


def _scales(images, featmaps, img_hw) -> Tuple[float, float, float, float]:
    """Pixel -> map coordinate scales ``(size - 1) / (img - 1)`` per axis
    for the images and the feature maps, as float32 values: the
    projection lives at ``img_hw``, the maps are sampled in their own
    extent (the images padded, the feature maps cropped)."""
    h, w = img_hw
    ih, iw = images.shape[1:3]
    fh, fw = featmaps.shape[1:3]
    return tuple(float(np.float32((m - 1.0) / (i - 1.0)))
                 for m, i in ((iw, w), (ih, h), (fw, w), (fh, h)))


def ray_view_carry_plain(pts, images, featmaps, proj, img_hw):
    """K2's carry in plain PyTorch: the sums before the epilogue.

    Args:
        pts: (R, S, 3) float32 sample points.
        images: (V, IH, IW, 3) float32 denormalized views (padded).
        featmaps: (V, FH, FW, C) float32 mapped feature maps (cropped).
        proj: (V, 4, 4) float32 ``K4 @ pose`` (``view_projection``).
        img_hw: (h, w) the projection's image size.

    Returns (s1u, s2u, s1m) (R, S, 3 + C) and cnt (R, S, 1), float32,
    accumulated in view order: per view the point's bilinear sample f
    ([rgb, features]) adds to ``s1u += f`` and ``s2u += f*f`` whatever
    the view sees; ``s1m += f*m`` and ``cnt += m`` only where the pixel
    is inside ``img_hw`` and the point in front of the camera (m).
    """
    h, w = img_hw
    r, s, _ = pts.shape
    xyz = pts.reshape(-1, 3)
    sx, sy, fsx, fsy = _scales(images, featmaps, img_hw)
    c = 3 + featmaps.shape[-1]
    s1u = torch.zeros((r * s, c), dtype=torch.float32, device=pts.device)
    s2u, s1m = torch.zeros_like(s1u), torch.zeros_like(s1u)
    cnt = torch.zeros((r * s, 1), dtype=torch.float32, device=pts.device)
    for i in range(images.shape[0]):
        pix, in_front = project_to_views(xyz, proj[i:i + 1])
        px, py = pix[0, :, 0], pix[0, :, 1]
        inbound = (px <= w - 1.0) & (px >= 0) & (py <= h - 1.0) & (py >= 0)
        m = (inbound & in_front[0]).float()[:, None]
        f = torch.cat([
            grid_sample_2d_packed(pack_bilinear(images[i]), px * sx, py * sy),
            grid_sample_2d_packed(pack_bilinear(featmaps[i]), px * fsx,
                                  py * fsy)], dim=-1)
        s1u = s1u + f
        s2u = s2u + f * f
        s1m = s1m + f * m
        cnt = cnt + m
    return (s1u.reshape(r, s, c), s2u.reshape(r, s, c),
            s1m.reshape(r, s, c), cnt.reshape(r, s, 1))


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


def streaming_sample_mean_var_plain(pts, images, proj, img_hw, featmaps):
    """Plain PyTorch version of K2 (same signature and results): the
    carry ``ray_view_carry_plain``, then its epilogue ``sample_stats``."""
    carry = ray_view_carry_plain(pts, images, featmaps, proj, img_hw)
    return sample_stats(*carry, images.shape[0])


def streaming_sample_mean_var(pts, images, proj, img_hw, featmaps):
    """K2: per-view sampling with masked mean / exp(-var) over views.
    Returns (globalfeat (R, S, 2(3 + C)), pixel_mask (R, S)); see
    ``streaming_sample_mean_var_plain``.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    fused kernel, which allocates only the two outputs, or raises where
    the kernel does not take the input. K2 has no backward yet: on the
    card it refuses ``featmaps`` that need a gradient.
    """
    if pts.device.type == "cpu":
        return streaming_sample_mean_var_plain(pts, images, proj, img_hw,
                                               featmaps)
    if torch.is_grad_enabled() and featmaps.requires_grad:
        raise NotImplementedError(
            "K2 (streaming_sample_mean_var) has no backward yet; it comes "
            "with joint detection + NVS training (ROADMAP §2). Render "
            "under torch.no_grad() or inference_mode()")
    out = _k2_launch(pts, images, proj, img_hw, featmaps)
    streaming_sample_mean_var.launches += 1
    return out


streaming_sample_mean_var.launches = 0


def _k2_launch(pts, images, proj, img_hw, featmaps):
    """Check and launch K2 on the card; the launch is not counted."""
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    for name, t in (("pts", pts), ("images", images),
                    ("featmaps", featmaps), ("proj", proj)):
        if t.dtype != torch.float32:
            raise TypeError(f"K2 takes float32 only; {name} is {t.dtype}")
        if t.device != pts.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {pts.device}")
    r, s, _ = pts.shape
    v, ih, iw, _ = images.shape
    _, fh, fw, c = featmaps.shape
    if (pts.shape[2] != 3 or images.shape[3] != 3 or featmaps.shape[0] != v
            or proj.shape != (v, 4, 4)):
        raise ValueError("K2 needs pts (R, S, 3), images (V, H, W, 3), "
                         "featmaps (V, h, w, C) and proj (V, 4, 4)")
    if not 1 <= c <= 32:
        raise ValueError(f"K2 takes 1 to 32 feature channels, got {c}")
    dev = pts.device
    gf = torch.empty((r, s, 2 * (3 + c)), dtype=torch.float32, device=dev)
    mask = torch.empty((r, s), dtype=torch.bool, device=dev)
    n = r * s
    if n == 0:
        return gf, mask
    h, w = img_hw
    sx, sy, fsx, fsy = _scales(images, featmaps, img_hw)
    lib = _lib()
    with torch.cuda.device(dev):  # the launch acts on the current device
        err = lib.streaming_sample_mean_var(
            pts.data_ptr(), images.data_ptr(), featmaps.data_ptr(),
            proj.data_ptr(), gf.data_ptr(), mask.data_ptr(), n, v, ih, iw,
            fh, fw, c, h, w, sx, sy, fsx, fsy,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"streaming_sample_mean_var kernel launch "
                           f"failed: cudaError {err}")
    return gf, mask


def _lib():
    lib = cuda_build.load("streaming_sample_mean_var")
    fn = lib.streaming_sample_mean_var
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 6 + [i] * 9 + [f] * 4 + [p]
        fn.restype = ctypes.c_int
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


def render_rays_chunk(ray_o, ray_d, mlp_fn: Callable, *,
                      near_far: Tuple[float, float], n_samples: int,
                      images, proj, img_hw, featmaps) -> Dict:
    """Render one chunk of rays in image mode.

    ``mlp_fn(pts, viewdirs, features) -> (rgb, sigma)`` is the radiance
    field. Evenly spaced samples, the view statistics (K2) as
    the field's features, then compositing (``raw2outputs``)."""
    pts, z_vals = sample_along_camera_ray(ray_o, ray_d, near_far[0],
                                          near_far[1], n_samples)
    globalfeat, pixel_mask = streaming_sample_mean_var(
        pts, images, proj, img_hw, featmaps)
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
