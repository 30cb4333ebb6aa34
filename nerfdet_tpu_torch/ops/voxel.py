"""Voxel grid, projection and view-streaming mean/variance fusion.

Port of ``nerfdet_tpu/ops/voxel.py``. Each voxel takes its nearest pixel
in every view; the fusion streams over views, so the (V, N, C) per-view
volume never exists. The carry of that stream (sums, squared sums,
observing-view counts and the squared sums of the mapped stream) is the
hand-written CUDA kernel K1 (``csrc/fused_mean_cov.cu``), in two phases:
A maps every pixel of every view once (``mapped_rows_plain``), B walks
the views for each voxel and gathers its rows and their mapped values.
On bfloat16 maps phase A runs on the tensor cores, W split exactly into
three bfloat16 pieces (``split_bf16x3_plain``). The epilogue (mean and
exp(-variance)) is plain torch. The carry is
differentiable: its backward is the hand-written kernel
``csrc/fused_mean_cov_backward.cu`` (``fusion_carry_backward``), which
sums the cotangents of the voxels that share a pixel (found by a counting
sort by hand, ``csrc/counting_sort.cuh``) and maps them back once per
pixel, as phase A maps forward.

The depth_sp configs gate every (voxel, view) pair by the sensed depth
(``depth_gate``, plain torch, as JAX computes it outside the scan) and
sum the rgb stream of the density volume on the device, at the images'
own projection: the hand-written kernel ``rgb_carry`` (a third entry
point of ``csrc/fused_mean_cov.cu``), launched apart from K1 and taking
no gradient.

bfloat16 (the JAX ``--bf16`` path): the maps, and the rgb stream's
images, may be bfloat16; the rows are widened to float32 exactly and the
sums stay float32, as JAX gathers them. The backward then rounds as
XLA's CPU backend runs JAX's transpose of the scan (``ops/bf16.py``):
each (voxel, view)'s float32 cotangent of its row to bfloat16, added to
its pixel in voxel order with each sum rounded. dW and db stay float32.

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

from ..parallel import dist as pdist
from . import cuda_build
from .bf16 import scatter_add_bf16
from .resize import resize_axes


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


def resize_depth(depth: torch.Tensor, height: int,
                 width: int) -> torch.Tensor:
    """(V, H, W) -> (V, height, width) float32, as ``jax.image.resize(
    depth, (V, height, width), "bilinear")``: antialiased triangle weights
    (``ops.resize``), the height first, an axis of unchanged
    size left alone (the sums' order differs from JAX's einsum: within
    1e-6 at the tests' shapes)."""
    return resize_axes(depth.float(), ((1, height), (2, width)))


def depth_gate(z, x, y, valid, depth, height: int, width: int,
               voxel_size_z: float) -> torch.Tensor:
    """``valid`` (V, N) restricted to the voxels within +-voxel_size_z of
    the sensed depth: ``depth`` (V, H, W) is resized to the map's extent
    (``resize_depth``), read at the clipped pixel (x, y), and a voxel's
    camera depth z must lie in (d - voxel_size_z, d + voxel_size_z)."""
    v = depth.shape[0]
    flat = resize_depth(depth, height, width).reshape(v, height * width)
    idx = y.clamp(0, height - 1) * width + x.clamp(0, width - 1)
    d = torch.gather(flat, 1, idx.long())
    return valid & (z > d - voxel_size_z) & (z < d + voxel_size_z)


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
    """Shared memory of one K1 phase A block for C channels of
    ``itemsize``-byte maps, in bytes (the layouts in
    ``csrc/fused_mean_cov.cu``). float32 maps: W zero-padded to 32 columns
    and b, then a ring of 4 stages of 128 rows x 32 channels, a row padded
    to 36 floats. bfloat16 maps: b, W's three bfloat16 pieces transposed
    (32 rows of C + 8), then a ring of 128 rows x 32 channels, a row padded
    to 40 elements, of 4 stages (3 at C = 1024, where 4 would not fit).
    Phase B holds none: its warps own their voxels. The C launcher sizes
    its blocks itself (``fused_mean_cov_mapped_rows_smem``) and refuses
    more than the device lets a block opt into; this states the same
    layout for the tests, and a card test holds the two equal."""
    if itemsize == 4:
        return 4 * (c * K1_MAX_MAP + K1_MAX_MAP) + 4 * 128 * 36 * 4
    stages = 3 if c >= 1024 else 4
    return (4 * K1_MAX_MAP + 2 * 3 * K1_MAX_MAP * (c + 8)
            + 2 * stages * 128 * 40)


def split_bf16x3_plain(w):
    """W (float32) as three bfloat16 pieces (hi, mid, lo) with hi + mid +
    lo == W exactly, as K1's phase A splits W for the tensor cores on
    bfloat16 maps: hi = rn(W), mid = rn(W - hi), lo = rn(W - hi - mid),
    each difference exact in float32 (for |W| above 2^-110, where lo is a
    normal bfloat16). The tests' reference of the kernel's split."""
    w = w.float()
    hi = w.bfloat16()
    rest = w - hi.float()
    mid = rest.bfloat16()
    lo = (rest - mid.float()).bfloat16()
    return hi, mid, lo


def fusion_carry(features, pix, mapped_kernel=None, mapped_bias=None):
    """K1: the view-streaming fusion carry (see ``fusion_carry_plain``),
    differentiable in ``features`` and the mapped stream's kernel and bias
    (``count`` is not differentiable).

    A CPU tensor takes the plain version forward and
    ``fusion_carry_backward_plain`` backward. A CUDA tensor launches the
    kernel (phase A, the mapped rows, where the mapped stream is given;
    then phase B, the carry) and, for the gradient, K1's backward kernel
    (``fusion_carry_backward``), or raises where a kernel does not take
    the input. The maps are float32 or bfloat16, the gradient in their
    dtype.
    """
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1 takes float32 or bfloat16 maps, got "
                        f"{features.dtype}")
    return _FusionCarry.apply(features, pix, mapped_kernel, mapped_bias)


fusion_carry.launches = 0


class _FusionCarry(torch.autograd.Function):
    """K1's forward and backward, dispatched by device. The forward on the
    card saves phase A's mapped rows P for the backward (30.7 MB at the
    flagship, against a second pass over the 245.8 MB of maps to
    recompute them); the plain version recomputes them."""

    @staticmethod
    def forward(ctx, features, pix, mapped_kernel, mapped_bias):
        mapped = None
        if features.device.type == "cpu":
            s1, s2, count, s2m = fusion_carry_plain(
                features, pix, mapped_kernel, mapped_bias)
        else:
            if mapped_kernel is not None:
                mapped = _mapped_rows_launch(features, mapped_kernel,
                                             mapped_bias)
            s1, s2, count, s2m = _carry_launch(features, pix, mapped,
                                               mapped_bias)
            fusion_carry.launches += 1
        ctx.mark_non_differentiable(count)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(features, pix, count, mapped_kernel,
                              mapped_bias, mapped)
        return s1, s2, count, s2m

    @staticmethod
    def backward(ctx, g1, g2, _, gm):
        features, pix, count, w, b, mapped = ctx.saved_tensors
        d_feats, d_w, d_b = fusion_carry_backward(
            features, pix, count, g1, g2, gm, w, b, mapped)
        if not ctx.needs_input_grad[0]:
            d_feats = None
        return d_feats, None, d_w, d_b


@torch.no_grad()
def fusion_carry_backward_plain(features, pix, count, g1=None, g2=None,
                                gm=None, mapped_kernel=None, mapped_bias=None,
                                mapped=None):
    """Plain PyTorch version of K1's backward (same signature and results
    as ``fusion_carry_backward``).

    With x the row of view v at pixel p, y = x @ W + b its mapped value
    (``mapped``, phase A's rows, or recomputed) and G1, G2, GM the sums of
    the cotangents g1, g2 (N, C) and gm (N, M) over the voxels that view v
    sees at p (``index_add_`` per view):

        d features[v, p] = G1 + 2 x G2 + dY @ W^T,   dY = 2 y GM
        dW = sum_(v, p) x^T dY
        db = sum_(v, p) dY + 2 b sum_n (V - count[n]) gm[n]

    (an unseen view's mapped value is b). A None g1/g2/gm contributes
    nothing; dW and db are None without the mapped stream or gm. On
    bfloat16 maps d features is bfloat16 and sums its pairs one by one
    (``_pair_cotangents_bf16``); dW and db are as above.
    """
    v, h, w, c = features.shape
    x = features.float().reshape(v, h * w, c)
    per_pixel = features.dtype != torch.bfloat16
    d = torch.zeros_like(x)
    with_m = mapped_kernel is not None and gm is not None
    d_w = d_b = y = None
    if with_m:
        wm = mapped_kernel.float()
        y = mapped if mapped is not None else mapped_rows_plain(
            features, mapped_kernel, mapped_bias)
        d_w = torch.zeros_like(wm)
        d_b = torch.zeros((wm.shape[1],), dtype=torch.float32,
                          device=x.device)
    for i in range(v):
        n = torch.nonzero(pix[i] >= 0)[:, 0]
        p = pix[i, n].long()
        if g1 is not None and per_pixel:
            d[i].index_add_(0, p, g1[n].float())
        if g2 is not None and per_pixel:
            g2_sum = torch.zeros_like(x[i]).index_add_(0, p, g2[n].float())
            d[i] += 2.0 * x[i] * g2_sum
        if with_m:
            gm_sum = torch.zeros_like(y[i]).index_add_(0, p, gm[n].float())
            dy = 2.0 * y[i] * gm_sum
            if per_pixel:
                d[i] += dy @ wm.t()
            d_w += x[i].t() @ dy
            d_b += dy.sum(0)
    if with_m:
        d_b += 2.0 * mapped_bias.float() * ((v - count)[:, None]
                                            * gm.float()).sum(0)
    if not per_pixel:
        d = _pair_cotangents_bf16(x, pix, g1, g2, gm if with_m else None,
                                  mapped_kernel, y).to(torch.bfloat16)
    return d.reshape(v, h, w, c), d_w, d_b


def _pair_cotangents_bf16(x, pix, g1, g2, gm, mapped_kernel, y):
    """d features (V, H*W, C) float32 holding bfloat16 values: per view,
    each (voxel n, pixel p) pair's float32 cotangent of its row, in the
    order JAX's transpose adds its terms,

        ((2 x[p] g2[n]) + g1[n]) + (2 y[p] gm[n]) @ W^T,

    rounded to bfloat16 and added to pixel p in ascending voxel order,
    each sum rounded (``scatter_add_bf16``). ``x`` (V, H*W, C) and ``y``
    (V, H*W, M) are the rows and their mapped values, float32."""
    v, hw, c = x.shape
    d = torch.zeros_like(x)
    for i in range(v):
        n = torch.nonzero(pix[i] >= 0)[:, 0]
        p = pix[i, n].long()
        d[i] = scatter_add_bf16(hw, p, _pair_rows(
            x[i], None if y is None else y[i], n, p, g1, g2, gm,
            mapped_kernel))
    return d


def _pair_rows(x, y, n, p, g1, g2, gm, mapped_kernel):
    """One view's float32 cotangents of its pairs' rows (K, C), voxel n[k]
    at pixel p[k]: ``((2 x[p] g2[n]) + g1[n]) + (2 y[p] gm[n]) @ W^T`` in
    JAX's order, a None cotangent contributing nothing."""
    pair = torch.zeros((n.shape[0], x.shape[-1]), dtype=torch.float32,
                       device=x.device)
    if g1 is not None:
        pair = g1[n].float()
    if g2 is not None:
        pair = (2.0 * x[p]) * g2[n].float() + pair
    if gm is not None:
        pair = pair + ((2.0 * y[p]) * gm[n].float()
                       ) @ mapped_kernel.float().t()
    return pair


def fusion_carry_backward(features, pix, count, g1=None, g2=None, gm=None,
                          mapped_kernel=None, mapped_bias=None, mapped=None):
    """K1's backward: (d features, dW, db) from the cotangents of s1, s2
    and s2m (see ``fusion_carry_backward_plain``). ``mapped`` is phase
    A's (V, H*W, M) rows from the forward.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    backward kernel (``csrc/fused_mean_cov_backward.cu``), or raises where
    it does not take the input.
    """
    if features.device.type == "cpu":
        return fusion_carry_backward_plain(features, pix, count, g1, g2, gm,
                                           mapped_kernel, mapped_bias, mapped)
    out = _backward_launch(features, pix, count, g1, g2, gm, mapped_kernel,
                           mapped_bias, mapped)
    fusion_carry_backward.launches += 1
    return out


fusion_carry_backward.launches = 0


def pixel_order_plain(pix, hw: int):
    """Plain version of K1's backward index preparation (same signature
    and results as ``pixel_order``): each view's voxels sorted stably by
    pixel, ``order`` (V, N) int32 (the invalid ones first), and ``off``
    (V, hw + 1) int32, where the voxels of pixel p start in ``order[v]``;
    pixel p of view v has ``off[v, p + 1] - off[v, p]`` of them, in
    ascending voxel order. Then the referenced pixels: ``rows`` (V, hw)
    int32, each view's pixels with a voxel in ascending order, -1 past
    ``n_rows`` (V,) int32 of them."""
    v = pix.shape[0]
    keys, order = torch.sort(pix, dim=1, stable=True)
    bounds = torch.arange(hw + 1, dtype=torch.int32, device=pix.device)
    off = torch.searchsorted(keys, bounds.expand(v, -1).contiguous(),
                             out_int32=True)
    held = off[:, 1:] > off[:, :-1]
    n_rows = held.sum(1).to(torch.int32)
    # a stable sort puts each view's referenced pixels first, in order
    rank = torch.sort((~held).to(torch.int8), dim=1, stable=True)[1]
    rows = torch.where(torch.arange(hw, device=pix.device)[None]
                       < n_rows[:, None], rank, -1).to(torch.int32)
    return order.to(torch.int32), off, rows, n_rows


def pixel_order(pix, hw: int):
    """The inverse index of K1's backward from ``pix`` (V, N): (order,
    off, rows, n_rows), see ``pixel_order_plain``. A CPU tensor takes the
    plain version; a CUDA tensor the counting sort of
    ``csrc/counting_sort.cuh``."""
    if pix.device.type == "cpu":
        return pixel_order_plain(pix, hw)
    return _pixel_order_launch(pix.contiguous(), hw)


def _pixel_order_launch(pix, hw: int):
    v, n = pix.shape
    dev = pix.device
    lib = _backward_lib()
    tiles = -(-n // lib.fused_mean_cov_backward_tile())
    if v * tiles * (hw + 1) >= 2 ** 31 or v * n >= 2 ** 31:
        raise ValueError("K1's backward indexes its voxels and tiles' bins "
                         "in int32")
    if 4 * (hw + 2) > _SMEM_OPTIN:
        raise ValueError(f"K1's backward keeps a view's {hw} pixels in "
                         f"shared memory: at most {_SMEM_OPTIN // 4 - 2}")
    hist = torch.empty((v, tiles, hw + 1), dtype=torch.int32, device=dev)
    kept = torch.empty((v, tiles), dtype=torch.int32, device=dev)
    order = torch.empty((v, n), dtype=torch.int32, device=dev)
    off = torch.empty((v, hw + 1), dtype=torch.int32, device=dev)
    rows = torch.empty((v, hw), dtype=torch.int32, device=dev)
    n_rows = torch.empty((v,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the launches act on the current device
        err = lib.fused_mean_cov_backward_order(
            *_ptrs(pix, hist, kept, order, off, rows, n_rows), v, n, hw,
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_mean_cov backward index preparation "
                           f"failed: cudaError {err}")
    return order, off, rows, n_rows


# the most shared memory a block may opt into on an H100 (bytes): the
# backwards' index preparation keeps a view's bins there
_SMEM_OPTIN = 232448


def _ptrs(*tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


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
            v * h * w, c, m, torch.cuda.current_stream(dev).cuda_stream)
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


def rgb_carry_plain(images, pix):
    """Plain PyTorch version of the in-scan rgb stream (same signature and
    results as ``rgb_carry``): ``images`` (V, H, W, 3) float32 or
    bfloat16 gathered
    at ``pix`` (V, N) int32 (-1 where the view does not see the voxel, or
    the depth gate drops it); returns (s1e, s2e), (N, 3) float32 sums and
    squared sums accumulated over views in view order."""
    s1, s2, _, _ = fusion_carry_plain(images, pix)
    return s1, s2


def rgb_carry(images, pix):
    """The in-scan rgb stream of the density volume (see
    ``rgb_carry_plain``). It takes no gradient (the images are inputs),
    and refuses images that require one. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel
    (``csrc/fused_mean_cov.cu``, ``fused_mean_cov_rgb``), or raises where
    it does not take the input."""
    if images.requires_grad:
        raise ValueError("the rgb stream takes no gradient: pass images "
                         "that do not require one")
    if images.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the rgb stream takes float32 or bfloat16 "
                        f"images, got {images.dtype}")
    if images.device.type == "cpu":
        return rgb_carry_plain(images, pix)
    out = _rgb_launch(images, pix)
    rgb_carry.launches += 1
    return out


rgb_carry.launches = 0


def _rgb_launch(images, pix):
    """Check and launch the rgb stream's kernel; returns (s1e, s2e). The
    launch is not counted."""
    dev = images.device
    if (images.device.type != "cuda" or images.dim() != 4
            or images.shape[3] != 3 or not images.is_contiguous()):
        raise ValueError("the rgb stream takes contiguous (V, H, W, 3) "
                         "images on the card")
    v, h, w, _ = images.shape
    n = pix.shape[1] if pix.dim() == 2 else -1
    if (pix.dtype != torch.int32 or pix.shape != (v, n)
            or not pix.is_contiguous() or pix.device != dev):
        raise ValueError("pix must be a contiguous (V, N) int32 tensor on "
                         "the images' device")
    s1 = torch.empty((n, 3), dtype=torch.float32, device=dev)
    s2 = torch.empty_like(s1)
    with torch.cuda.device(dev):  # the launch acts on the current device
        err = _lib().fused_mean_cov_rgb(
            images.data_ptr(), int(images.dtype == torch.bfloat16),
            *_ptrs(pix, s1, s2), v, h * w, n, _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_mean_cov rgb stream launch failed: "
                           f"cudaError {err}")
    return s1, s2


def _contiguous_f32(t, shape, name, dev):
    if (t.dtype != torch.float32 or tuple(t.shape) != shape
            or t.device != dev):
        raise ValueError(f"{name} must be a float32 {shape} tensor on {dev}")
    return t.contiguous()


def _backward_launch(features, pix, count, g1, g2, gm, mapped_kernel,
                     mapped_bias, mapped):
    """Check and launch K1's backward; returns (d features, dW or None,
    db or None): the index preparation (``pixel_order``), pass 1
    (``_pixel_sums``), and with the mapped stream passes 2 and 3
    (``_weight_parts``, ``_weight_reduce``). On bfloat16 maps pass 1
    rounds as ``_pair_cotangents_bf16`` does. The launch is not counted."""
    _check_maps(features)
    v, h, w, c = features.shape
    n = pix.shape[1] if pix.dim() == 2 else -1
    dev = features.device
    if (pix.dtype != torch.int32 or pix.shape != (v, n)
            or not pix.is_contiguous() or pix.device != dev):
        raise ValueError("pix must be a contiguous (V, N) int32 tensor on "
                         "the features' device")
    g1 = (torch.zeros((n, c), device=dev) if g1 is None
          else _contiguous_f32(g1, (n, c), "g1", dev))
    if g2 is not None:
        g2 = _contiguous_f32(g2, (n, c), "g2", dev)
    with_m = mapped_kernel is not None and gm is not None
    m = mapped_kernel.shape[1] if with_m else 0
    if with_m:
        if mapped is None:
            raise ValueError("K1's backward needs phase A's mapped rows")
        gm = _contiguous_f32(gm, (n, m), "gm", dev)
        mapped = _contiguous_f32(mapped, (v, h * w, m), "mapped", dev)
        mapped_kernel = _contiguous_f32(mapped_kernel, (c, m), "W", dev)
        mapped_bias = _contiguous_f32(mapped_bias, (m,), "b", dev)
        count = _contiguous_f32(count, (n,), "count", dev)
    order, off, rows, n_rows = _pixel_order_launch(pix, h * w)
    if not with_m:
        d_feats, _ = _pixel_sums(features, order, off, g1, g2)
        return d_feats, None, None
    d_feats, dy = _pixel_sums(features, order, off, g1, g2, gm, mapped,
                              mapped_kernel)
    parts = _weight_parts(features, dy, rows, n_rows, gm, count)
    return (d_feats,) + _weight_reduce(*parts, mapped_bias)


def _pixel_sums(features, order, off, g1, g2, gm=None, mapped=None, w=None):
    """K1's backward pass 1 on checked inputs: d features and, with the
    mapped stream, dY (V, H*W, M) at the referenced rows (else None);
    ``pixel_sums_plain`` is the twin."""
    v, h, wd, c = features.shape
    n, dev = g1.shape[0], features.device
    m = 0 if mapped is None else mapped.shape[-1]
    d_feats = torch.empty_like(features)
    dy = (None if mapped is None else
          torch.empty((v, h * wd, m), dtype=torch.float32, device=dev))
    with torch.cuda.device(dev):  # the attribute and launch act on it
        err = _backward_lib().fused_mean_cov_backward_pixels(
            *_ptrs(features, order, off, g1, g2, gm, mapped, w, d_feats, dy),
            v, h * wd, c, n, m, _bf16(features), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_mean_cov backward pass 1 launch failed: "
                           f"cudaError {err}")
    return d_feats, dy


@torch.no_grad()
def pixel_sums_plain(features, order, off, g1, g2, gm=None, mapped=None,
                     w=None):
    """Plain twin of ``_pixel_sums`` (K1's backward pass 1): from
    ``pixel_order``'s ``order`` and ``off``, d features in the maps'
    dtype and, with the mapped stream, dY (V, H*W, M) = 2 y GM at the
    referenced rows (zeros elsewhere; the card leaves them unwritten),
    GM the sum of gm over a row's voxels in ascending order. d features:
    on float32 maps each row's G1 + 2 x G2 + dY @ W^T; on bfloat16 maps
    each pair's cotangent (``_pair_rows``) rounded and added in voxel
    order, each sum rounded (``_pair_cotangents_bf16``)."""
    v, h, wd, c = features.shape
    hw = h * wd
    x = features.float().reshape(v, hw, c)
    d = torch.zeros_like(x)
    dy = None if mapped is None else torch.zeros_like(mapped)
    for i in range(v):
        p = torch.repeat_interleave(torch.arange(hw, device=x.device),
                                    (off[i, 1:] - off[i, :-1]).long())
        n = order[i, int(off[i, 0]):int(off[i, -1])].long()
        held = torch.zeros(hw, dtype=torch.bool, device=x.device)
        held[p] = True
        if mapped is not None:
            g_sum = torch.zeros_like(mapped[i]).index_add_(0, p, gm[n])
            dy[i] = torch.where(held[:, None], (2.0 * mapped[i]) * g_sum,
                                0.0)
        if features.dtype == torch.bfloat16:
            d[i] = scatter_add_bf16(hw, p, _pair_rows(
                x[i], None if mapped is None else mapped[i], n, p, g1, g2,
                gm, w))
            continue
        d[i].index_add_(0, p, g1[n])
        if g2 is not None:
            g2_sum = torch.zeros_like(x[i]).index_add_(0, p, g2[n])
            d[i] += 2.0 * x[i] * g2_sum
        if mapped is not None:
            d[i] += dy[i] @ w.t()
        d[i] = torch.where(held[:, None], d[i], 0.0)
    return d.reshape(features.shape).to(features.dtype), dy


def _weight_parts(features, dy, rows, n_rows, gm, count):
    """K1's backward pass 2: the partial sums of x^T dY, of dY and of the
    unseen views' gm over fixed ranges, (parts, C, M), (parts, M) and
    (parts, M)."""
    v, h, w, c = features.shape
    n, m = gm.shape
    dev = features.device
    lib = _backward_lib()
    parts = lib.fused_mean_cov_backward_parts()
    part_w = torch.empty((parts, c, m), dtype=torch.float32, device=dev)
    part_b = torch.empty((parts, m), dtype=torch.float32, device=dev)
    part_i = torch.empty_like(part_b)
    with torch.cuda.device(dev):  # the attribute and launch act on it
        err = lib.fused_mean_cov_backward_weights(
            *_ptrs(features, dy, rows, n_rows, gm, count, part_w, part_b,
                   part_i), v, h * w, c, n, m, _bf16(features), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_mean_cov backward pass 2 launch failed: "
                           f"cudaError {err}")
    return part_w, part_b, part_i


def _weight_reduce(part_w, part_b, part_i, mapped_bias):
    """K1's backward pass 3: (dW, db), the partials summed in order."""
    _, c, m = part_w.shape
    dev = part_w.device
    d_w = torch.empty((c, m), dtype=torch.float32, device=dev)
    d_b = torch.empty((m,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # the launch acts on the current device
        err = _backward_lib().fused_mean_cov_backward_reduce(
            *_ptrs(part_w, part_b, part_i, mapped_bias, d_w, d_b), c, m,
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_mean_cov backward pass 3 launch failed: "
                           f"cudaError {err}")
    return d_w, d_b


def _bf16(features) -> int:
    return int(features.dtype == torch.bfloat16)


def _backward_lib():
    lib = cuda_build.load("fused_mean_cov_backward")
    fn = lib.fused_mean_cov_backward_pixels
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 6 + [p]
        fn.restype = ctypes.c_int
        for name in ("parts", "tile"):
            f = getattr(lib, f"fused_mean_cov_backward_{name}")
            f.argtypes = []
            f.restype = ctypes.c_int
        lib.fused_mean_cov_backward_order.argtypes = [p] * 7 + [i] * 3 + [p]
        lib.fused_mean_cov_backward_order.restype = ctypes.c_int
        lib.fused_mean_cov_backward_weights.argtypes = (
            [p] * 9 + [i] * 6 + [p])
        lib.fused_mean_cov_backward_weights.restype = ctypes.c_int
        lib.fused_mean_cov_backward_reduce.argtypes = [p] * 6 + [i] * 2 + [p]
        lib.fused_mean_cov_backward_reduce.restype = ctypes.c_int
    return lib


def _lib():
    lib = cuda_build.load("fused_mean_cov")
    fn = lib.fused_mean_cov_carry
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.fused_mean_cov_mapped_rows.argtypes = [p, i, p, p, p, i, i, i,
                                                   p]
        lib.fused_mean_cov_mapped_rows.restype = ctypes.c_int
        lib.fused_mean_cov_mapped_rows_smem.argtypes = [i, i]
        lib.fused_mean_cov_mapped_rows_smem.restype = ctypes.c_longlong
        lib.fused_mean_cov_rgb.argtypes = [p, i] + [p] * 3 + [i] * 3 + [p]
        lib.fused_mean_cov_rgb.restype = ctypes.c_int
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
                   voxel_size_z: Optional[float] = None,
                   invalid_fill=None,
                   extra_features=None,
                   extra_projection=None,
                   image_hw: Optional[Tuple[int, int]] = None,
                   extra_image_hw: Optional[Tuple[int, int]] = None,
                   mapped_kernel=None,
                   mapped_bias=None,
                   precomputed_extra=None,
                   view_group=None):
    """Streaming multi-view fusion: mean, exp(-var), valid count.

    mean  = sum_v x_v / (count + 1e-8), 0 where count == 0
    cov   = exp(-sum_v (x_v - mean)^2 / (count + 1e-8)), 0 where
            count == 0; the sum runs over ALL views, an invalid view
            contributing mean^2 (``s2 - 2*mean*s1 + V*mean^2``).

    Args:
        features: (V, H, W, C) per-view maps.
        points: (N, 3) voxel centers; projection: (V, 3, 4).
        depth/voxel_size_z: the sensed depth (V, H', W'): a view sees a
            voxel only within +-voxel_size_z of it (``depth_gate``), in
            both streams.
        image_hw: validity bounds when smaller than the (padded) maps.
        extra_features/extra_projection/extra_image_hw: the rgb stream of
            the global volume, (V, H2, W2, 3) images gathered at their own
            projection and bounds and gated by their own validity, while
            the count comes from the features; summed on the device
            (``rgb_carry``).
        mapped_kernel/mapped_bias: the nerf_density global volume. The
            mapped stream ``x_v @ W + b`` (an invalid view contributes
            the bias) has its sum recovered as ``s1 @ W + V*b``, its
            squared sum accumulated by K1; the rgb stream is
            ``extra_features`` or arrives as host sums
            ``precomputed_extra = (s1e, s2e)``
            (``data/rgb_stats.host_rgb_stats``).
        view_group: the process group over which the scene's views are
            sharded (JAX's ``axis_name``): ``features``, ``projection``
            and the rgb stream's images and depth hold this rank's views,
            as many on every rank. After K1 the sums s1, s2, count, s2m
            and the device rgb stream's s1e, s2e are summed over the group
            (``parallel/dist.all_reduce_sum``, whose backward sums the
            cotangents), and the statistics take the scene's view count;
            the host rgb sums hold every view already. K1's backward keeps
            this rank's count: its unseen-view term of db is this rank's
            share, which the gradients' sum over the ranks completes.

    Returns (mean, cov, count), or (mean, cov, count, g_mean, g_cov)
    with the mapped stream, g_* channels ordered [rgb, mapped]. The
    outputs are differentiable in ``features`` (float32 or bfloat16;
    ``extra_features`` may be bfloat16 too), the mapped
    kernel and bias: the carry through K1's backward, ``s1m`` and the
    statistics through torch autograd.
    """
    if invalid_fill is not None:
        raise NotImplementedError("invalid_fill is not yet ported")
    if extra_features is not None and precomputed_extra is not None:
        raise ValueError("the rgb stream is extra_features or "
                         "precomputed_extra, not both")
    if (mapped_kernel is None) != (extra_features is None
                                   and precomputed_extra is None):
        raise ValueError("the nerf_density global volume takes the mapped "
                         "stream and the rgb stream together")
    v, fh, fw, _ = features.shape
    h, w = image_hw if image_hw is not None else (fh, fw)
    x, y, z, valid = project_points(points, projection, h, w)
    if depth is not None:
        valid = depth_gate(z, x, y, valid, depth, h, w, voxel_size_z)
    pix = pixel_index(x, y, valid, fw)
    rgb = None
    if extra_features is not None:
        feh, few = extra_features.shape[1:3]
        he, we = extra_image_hw if extra_image_hw is not None else (feh,
                                                                    few)
        xe, ye, ze, valide = project_points(points, extra_projection, he, we)
        if depth is not None:
            valide = depth_gate(ze, xe, ye, valide, depth, he, we,
                                voxel_size_z)
        rgb = rgb_carry(extra_features.contiguous(),
                        pixel_index(xe, ye, valide, few))
    elif precomputed_extra is not None:
        rgb = (precomputed_extra[0].float(), precomputed_extra[1].float())
    w_map = b_map = None
    if mapped_kernel is not None:
        w_map = mapped_kernel.float().contiguous()
        b_map = mapped_bias.float().contiguous()
    s1, s2, count, s2m = fusion_carry(features.contiguous(), pix,
                                      w_map, b_map)
    if view_group is not None:
        device_rgb = list(rgb) if extra_features is not None else []
        summed = pdist.all_reduce_sum(
            s1, s2, count, *([s2m] if w_map is not None else []),
            *device_rgb, group=view_group)
        s1, s2, count = summed[0], summed[1], summed[2].detach()
        if w_map is not None:
            s2m = summed[3]
        if device_rgb:
            rgb = tuple(summed[-2:])
        v = v * pdist.world(view_group)
    mean, cov = _stats(s1, s2, count, v)
    if mapped_kernel is None:
        return mean, cov, count
    s1m = s1 @ w_map + v * b_map
    mean_m, cov_m = _stats(s1m, s2m, count, v)
    mean_e, cov_e = _stats(*rgb, count, v)
    g_mean = torch.cat([mean_e, mean_m], dim=-1)
    g_cov = torch.cat([cov_e, cov_m], dim=-1)
    return mean, cov, count, g_mean, g_cov
