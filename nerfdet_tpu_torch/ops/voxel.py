"""Voxel grid, projection and view-streaming mean/variance fusion.

Port of ``nerfdet_tpu/ops/voxel.py``. Each voxel takes its nearest pixel
in every view; the fusion streams over views, so the (V, N, C) per-view
volume never exists. The carry of that stream (sums, squared sums,
observing-view counts and the squared sums of the mapped stream) is the
hand-written CUDA kernel K1 (``csrc/fused_mean_cov.cu``); the epilogue
(mean and exp(-variance)) is plain torch.

Exactness: geometry is float32 with explicitly ordered multiply-adds
(no TF32, no library-chosen order) and ``torch.round`` (half to even,
as ``jnp.round``): voxel centers often project to exact half-pixel
ties. The kernel takes the pixel indices computed here, so the CUDA
compiler's contractions cannot move a tie.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda_build


def _host(x) -> np.ndarray:
    """float32 numpy copy of a small array, tensor or sequence."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def get_points(n_voxels, voxel_size, origin, device="cpu") -> torch.Tensor:
    """World-space voxel-center grid, (nx, ny, nz, 3) float32.

    The grid spans ``origin +- n_voxels / 2 * voxel_size``.
    """
    dev = torch.device(device)
    n = torch.tensor([float(v) for v in n_voxels], dtype=torch.float32,
                     device=dev)
    vsz = torch.from_numpy(_host(voxel_size)).to(dev)
    org = torch.from_numpy(_host(origin)).to(dev)
    axes = [torch.arange(int(v), dtype=torch.float32, device=dev)
            for v in n_voxels]
    idx = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    new_origin = org - n / 2.0 * vsz
    return idx * vsz + new_origin


def compute_projection(intrinsic, extrinsics, ratio: float,
                       device="cpu") -> torch.Tensor:
    """Per-view 3x4 projection matrices, (V, 3, 4) float32.

    ``ratio`` (original height / feature height) rescales the focal and
    center rows. Computed on the host in numpy float32 with the three
    products summed in a fixed order, then moved to ``device``: a CUDA
    division by a host scalar would multiply by its reciprocal instead.
    """
    intr = _host(intrinsic)[:3, :3].copy()
    intr[:2] /= np.float32(ratio)
    ext = _host(extrinsics)[:, :3, :]  # (V, 3, 4)
    proj = (intr[None, :, 0, None] * ext[:, None, 0, :]
            + intr[None, :, 1, None] * ext[:, None, 1, :]) \
        + intr[None, :, 2, None] * ext[:, None, 2, :]
    return torch.from_numpy(np.ascontiguousarray(proj, np.float32)).to(device)


def project_points(points: torch.Tensor, projection: torch.Tensor,
                   height: int, width: int):
    """Project (N, 3) world points into every view, nearest pixel.

    Returns (x, y, z, valid), each (V, N): x, y int32 pixel coordinates
    (unclipped), z the camera depth, valid the in-image and in-front
    mask. The homogeneous product is summed in the fixed order
    p0*x + p1*y + p2*z + p3 with separately rounded operations.
    """
    px, py, pz = (points[None, :, i] for i in range(3))

    def row(i):
        p = projection[:, i, :, None]  # (V, 4, 1)
        return ((p[:, 0] * px + p[:, 1] * py) + p[:, 2] * pz) + p[:, 3]

    cx, cy, z = row(0), row(1), row(2)
    x = torch.round(cx / z).to(torch.int32)
    y = torch.round(cy / z).to(torch.int32)
    valid = (x >= 0) & (y >= 0) & (x < width) & (y < height) & (z > 0)
    return x, y, z, valid


def pixel_index(x, y, valid, map_width: int) -> torch.Tensor:
    """Flat row index ``y * map_width + x`` into a (H, map_width) map,
    -1 where the view does not see the voxel; (V, N) int32."""
    return torch.where(valid, y * map_width + x,
                       torch.full_like(x, -1)).to(torch.int32)


def fusion_carry_plain(features, pix, mapped_kernel=None, mapped_bias=None):
    """Plain PyTorch version of K1 (same signature and results).

    Args:
        features: (V, H, W, C) float32 or bfloat16.
        pix: (V, N) int32 flat pixel index, -1 where invalid.
        mapped_kernel/mapped_bias: optional (C, M) / (M,) mapped stream.

    Returns (s1 (N, C), s2 (N, C), count (N,), s2m (N, M) or None), all
    float32, accumulated over views in view order.
    """
    v, h, w, c = features.shape
    n = pix.shape[1]
    dev = features.device
    s1 = torch.zeros((n, c), dtype=torch.float32, device=dev)
    s2 = torch.zeros_like(s1)
    count = torch.zeros((n,), dtype=torch.float32, device=dev)
    s2m = None
    if mapped_kernel is not None:
        wm = mapped_kernel.float()
        bm = mapped_bias.float()
        s2m = torch.zeros((n, wm.shape[1]), dtype=torch.float32, device=dev)
    for i in range(v):
        valid = pix[i] >= 0
        rows = features[i].reshape(h * w, c).index_select(
            0, pix[i].clamp(min=0).long()).float()
        rows = torch.where(valid[:, None], rows, torch.zeros_like(rows))
        s1 += rows
        s2 += rows * rows
        count += valid.float()
        if s2m is not None:
            mapped = rows @ wm + bm
            s2m += mapped * mapped
    return s1, s2, count, s2m


def fusion_carry(features, pix, mapped_kernel=None, mapped_bias=None):
    """K1: the view-streaming fusion carry (see ``fusion_carry_plain``).

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel, or raises where the kernel does not take the input.
    """
    if features.device.type == "cpu":
        return fusion_carry_plain(features, pix, mapped_kernel, mapped_bias)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    v, h, w, c = features.shape
    n = pix.shape[1]
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be float32 or bfloat16, "
                        f"got {features.dtype}")
    if not features.is_contiguous():
        raise ValueError("features must be contiguous")
    if c % 32 or c > 1024:
        raise ValueError(f"K1 needs C % 32 == 0 and C <= 1024, got C={c}")
    if (pix.dtype != torch.int32 or pix.shape != (v, n)
            or not pix.is_contiguous() or pix.device != features.device):
        raise ValueError("pix must be a contiguous (V, N) int32 tensor on "
                         "the features' device")
    dev = features.device
    s1 = torch.empty((n, c), dtype=torch.float32, device=dev)
    s2 = torch.empty_like(s1)
    count = torch.empty((n,), dtype=torch.float32, device=dev)
    s2m = None
    m = 0
    w_ptr = b_ptr = s2m_ptr = None
    if mapped_kernel is not None:
        m = mapped_kernel.shape[1]
        if (mapped_kernel.shape != (c, m) or mapped_bias.shape != (m,)
                or mapped_kernel.dtype != torch.float32
                or mapped_bias.dtype != torch.float32
                or not mapped_kernel.is_contiguous()
                or mapped_kernel.device != dev or mapped_bias.device != dev):
            raise ValueError("mapped stream needs float32 contiguous "
                             "(C, M) kernel and (M,) bias on the device")
        smem = 4 * _tile() * (c + m)
        if smem > 48 * 1024:
            raise ValueError(f"K1 tile needs {smem} bytes of shared memory")
        s2m = torch.empty((n, m), dtype=torch.float32, device=dev)
        w_ptr, b_ptr, s2m_ptr = (mapped_kernel.data_ptr(),
                                 mapped_bias.data_ptr(), s2m.data_ptr())
    if n == 0:
        return s1, s2, count, s2m
    lib = _lib()
    with torch.cuda.device(dev):  # the launch acts on the current device
        err = lib.fused_mean_cov_carry(
            features.data_ptr(), int(features.dtype == torch.bfloat16),
            pix.data_ptr(), w_ptr, b_ptr, s1.data_ptr(), s2.data_ptr(),
            count.data_ptr(), s2m_ptr, v, h * w, c, n, m,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mean_cov kernel launch failed: "
                           f"cudaError {err}")
    fusion_carry.launches += 1
    return s1, s2, count, s2m


fusion_carry.launches = 0


def _lib():
    lib = cuda_build.load("fused_mean_cov")
    fn = lib.fused_mean_cov_carry
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.fused_mean_cov_tile.argtypes = []
        lib.fused_mean_cov_tile.restype = ctypes.c_int
    return lib


def _tile() -> int:
    return _lib().fused_mean_cov_tile()


def _stats(s1, s2, count, n_views):
    denom = count[:, None] + 1e-8
    observed = count[:, None] > 0
    mean = torch.where(observed, s1 / denom, torch.zeros_like(s1))
    var = (s2 - 2.0 * mean * s1 + n_views * mean * mean) / denom
    var = torch.where(observed, var, torch.full_like(var, 1e6))
    return mean, torch.exp(-var)


def fused_mean_cov(features, points, projection,
                   depth=None,
                   invalid_fill=None,
                   extra_features=None,
                   image_hw: Optional[Tuple[int, int]] = None,
                   mapped_kernel=None,
                   mapped_bias=None,
                   precomputed_extra=None):
    """Streaming multi-view fusion: mean, exp(-var), valid count.

    mean  = sum_v x_v / (count + 1e-8), 0 where count == 0
    cov   = exp(-sum_v (x_v - mean)^2 / (count + 1e-8)), 0 where
            count == 0; the sum runs over ALL views, an invalid view
            contributing mean^2 (``s2 - 2*mean*s1 + V*mean^2``).

    Args:
        features: (V, H, W, C) per-view maps.
        points: (N, 3) voxel centers; projection: (V, 3, 4).
        image_hw: validity bounds when smaller than the (padded) maps.
        mapped_kernel/mapped_bias/precomputed_extra: the nerf_density
            global volume. The mapped stream ``x_v @ W + b`` (an
            invalid view contributes the bias) has its sum recovered as
            ``s1 @ W + V*b``, its squared sum accumulated by K1; the
            rgb stream arrives as host sums ``(s1e, s2e)``
            (``data/rgb_stats.host_rgb_stats``).

    Returns (mean, cov, count), or (mean, cov, count, g_mean, g_cov)
    with the mapped stream, g_* channels ordered [rgb, mapped].
    """
    if depth is not None:
        raise NotImplementedError(
            "depth_gate belongs to the depth_sp configs, not yet ported")
    if extra_features is not None:
        raise NotImplementedError(
            "the in-scan rgb stream belongs to the depth_sp configs, not "
            "yet ported; pass precomputed_extra")
    if invalid_fill is not None:
        raise NotImplementedError("invalid_fill is not yet ported")
    if (mapped_kernel is None) != (precomputed_extra is None):
        raise ValueError("the mapped stream needs precomputed_extra and "
                         "vice versa")
    v, fh, fw, _ = features.shape
    h, w = image_hw if image_hw is not None else (fh, fw)
    x, y, _, valid = project_points(points, projection, h, w)
    pix = pixel_index(x, y, valid, fw)
    w_map = b_map = None
    if mapped_kernel is not None:
        w_map = mapped_kernel.float().contiguous()
        b_map = mapped_bias.float().contiguous()
    s1, s2, count, s2m = fusion_carry(features.contiguous(), pix,
                                      w_map, b_map)
    mean, cov = _stats(s1, s2, count, v)
    if mapped_kernel is None:
        return mean, cov, count
    s1m = s1 @ w_map + v * b_map
    mean_m, cov_m = _stats(s1m, s2m, count, v)
    mean_e, cov_e = _stats(precomputed_extra[0].float(),
                           precomputed_extra[1].float(), count, v)
    g_mean = torch.cat([mean_e, mean_m], dim=-1)
    g_cov = torch.cat([cov_e, cov_m], dim=-1)
    return mean, cov, count, g_mean, g_cov
