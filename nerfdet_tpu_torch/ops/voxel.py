"""Voxel grid, projection and view-streaming mean/variance fusion.

Port of ``nerfdet_tpu/ops/voxel.py``. Each voxel takes its nearest pixel
in every view; the fusion streams over views, so the (V, N, C) per-view
volume never exists. The carry of that stream (sums, squared sums,
observing-view counts and the squared sums of the mapped stream) is the
hand-written CUDA kernel K1 (``csrc/fused_mean_cov.cu``), in two phases:
A maps every pixel of every view once (``mapped_rows_plain``), B walks
the views for each voxel and gathers its rows and their mapped values.
The epilogue (mean and exp(-variance)) is plain torch.

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


def mapped_rows_plain(features, mapped_kernel, mapped_bias):
    """Plain PyTorch version of K1's phase A: the mapped stream of every
    pixel of every view, ``x @ W + b``, (V, H*W, M) float32."""
    v, h, w, c = features.shape
    return (features.float().reshape(v, h * w, c) @ mapped_kernel.float()
            + mapped_bias.float())


K1_CHANNELS = (32, 64, 128, 256, 512, 1024)  # 32 x a power of two
K1_MAX_MAP = 32  # mapped outputs: lane m of a warp owns output m


def fusion_smem_bytes(c: int, itemsize: int) -> int:
    """Shared memory of one K1 block for C channels of ``itemsize``-byte
    maps, in bytes. Phase A holds W zero-padded to 32 columns and b, then
    a ring of 4 stages of 128 rows x 32 channels, a row padded to 36
    floats or 40 bfloat16 (the layout in ``csrc/fused_mean_cov.cu``);
    phase B holds none: its warps own their voxels. The launch passes
    this size to phase A, whose launcher refuses more than the device
    lets a block opt into."""
    pitch = 36 if itemsize == 4 else 40
    return 4 * (c * K1_MAX_MAP + K1_MAX_MAP) + 4 * 128 * pitch * itemsize


def fusion_carry(features, pix, mapped_kernel=None, mapped_bias=None):
    """K1: the view-streaming fusion carry (see ``fusion_carry_plain``).

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel (phase A, the mapped rows, where the mapped stream is given;
    then phase B, the carry), or raises where the kernel does not take
    the input.
    """
    if features.device.type == "cpu":
        return fusion_carry_plain(features, pix, mapped_kernel, mapped_bias)
    mapped = None
    if mapped_kernel is not None:
        mapped = _mapped_rows_launch(features, mapped_kernel, mapped_bias)
    out = _carry_launch(features, pix, mapped, mapped_bias)
    fusion_carry.launches += 1
    return out


fusion_carry.launches = 0


def _check_maps(features):
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be float32 or bfloat16, "
                        f"got {features.dtype}")
    if features.dim() != 4 or not features.is_contiguous():
        raise ValueError("features must be a contiguous (V, H, W, C) map")
    c = features.shape[3]
    if c not in K1_CHANNELS:
        raise ValueError(f"K1 takes C in {K1_CHANNELS} (C % 32 == 0 and C "
                         f"/ 32 a power of two), got C={c}")


def _mapped_rows_launch(features, mapped_kernel, mapped_bias):
    """Check and launch K1's phase A; returns P (V, H*W, M) float32. The
    launch is not counted."""
    _check_maps(features)
    v, h, w, c = features.shape
    dev = features.device
    if mapped_kernel.dim() != 2 or mapped_kernel.shape[0] != c:
        raise ValueError(f"mapped kernel must be (C, M) with C={c}")
    m = mapped_kernel.shape[1]
    if not 1 <= m <= K1_MAX_MAP:
        raise ValueError(f"K1 takes 1 to {K1_MAX_MAP} mapped channels, "
                         f"got M={m}")
    if (mapped_bias.shape != (m,) or mapped_kernel.dtype != torch.float32
            or mapped_bias.dtype != torch.float32
            or not mapped_kernel.is_contiguous()
            or mapped_kernel.device != dev or mapped_bias.device != dev):
        raise ValueError("mapped stream needs float32 contiguous "
                         "(C, M) kernel and (M,) bias on the device")
    out = torch.empty((v, h * w, m), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):  # the attribute and launch act on it
        err = lib.fused_mean_cov_mapped_rows(
            features.data_ptr(), int(features.dtype == torch.bfloat16),
            mapped_kernel.data_ptr(), mapped_bias.data_ptr(), out.data_ptr(),
            v * h * w, c, m, fusion_smem_bytes(c, features.element_size()),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mean_cov phase A launch failed: "
                           f"cudaError {err}")
    return out


def _carry_launch(features, pix, mapped, mapped_bias):
    """Check and launch K1's phase B on ``mapped`` (phase A's output) and
    the bias, or on neither (None); returns (s1, s2, count, s2m or None).
    The launch is not counted."""
    _check_maps(features)
    v, h, w, c = features.shape
    n = pix.shape[1] if pix.dim() == 2 else -1
    dev = features.device
    if (pix.dtype != torch.int32 or pix.shape != (v, n)
            or not pix.is_contiguous() or pix.device != dev):
        raise ValueError("pix must be a contiguous (V, N) int32 tensor on "
                         "the features' device")
    s1 = torch.empty((n, c), dtype=torch.float32, device=dev)
    s2 = torch.empty_like(s1)
    count = torch.empty((n,), dtype=torch.float32, device=dev)
    s2m = None
    m = 0
    if mapped is not None:
        m = mapped.shape[-1]
        s2m = torch.empty((n, m), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):  # the launch acts on the current device
        err = lib.fused_mean_cov_carry(
            features.data_ptr(), int(features.dtype == torch.bfloat16),
            pix.data_ptr(), None if mapped is None else mapped.data_ptr(),
            None if mapped is None else mapped_bias.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), count.data_ptr(),
            None if s2m is None else s2m.data_ptr(), v, h * w, c, n, m,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mean_cov phase B launch failed: "
                           f"cudaError {err}")
    return s1, s2, count, s2m


def _lib():
    lib = cuda_build.load("fused_mean_cov")
    fn = lib.fused_mean_cov_carry
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.fused_mean_cov_mapped_rows.argtypes = [
            p, i, p, p, p, i, i, i, ctypes.c_longlong, p]
        lib.fused_mean_cov_mapped_rows.restype = ctypes.c_int
    return lib


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
