"""Host-side rgb statistics of the nerf_density global volume (numpy).

A copy of ``nerfdet_tpu/ops/voxel.py:host_rgb_stats``. The per-voxel sum
and squared sum of the de-normalized image colors over the views that
observe the voxel depend on the input images and the scene geometry
only (no parameters), so the data path computes them and the device
never gathers full-resolution rgb rows.

Exactness: projection and rounding are float32 (round half to even, as
``torch.round`` and ``jnp.round``). With ``compute_dtype="bfloat16"``
the gathered colors are rounded to bfloat16 before the float32
accumulation, as the original does with ``ml_dtypes``; here the rounding
is a torch bfloat16 round trip (round to nearest even in both).
"""

from __future__ import annotations

import numpy as np
import torch


def _round_bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def host_rgb_stats(denorm_imgs, intrinsic, extrinsics, origin,
                   n_voxels, voxel_size, ori_shape, img_shape,
                   compute_dtype="float32"):
    """Returns ``(s1, s2)``: two (N, 3) float32 arrays, N = prod(n_voxels)."""
    n_voxels = np.asarray(n_voxels)
    vsz = np.asarray(voxel_size, np.float32)
    origin = np.asarray(origin, np.float32)
    idx = np.stack(np.meshgrid(
        np.arange(n_voxels[0], dtype=np.float32),
        np.arange(n_voxels[1], dtype=np.float32),
        np.arange(n_voxels[2], dtype=np.float32), indexing="ij"), axis=-1)
    new_origin = origin - n_voxels.astype(np.float32) / 2.0 * vsz
    pts = (idx * vsz + new_origin).reshape(-1, 3)

    h_img, w_img = int(img_shape[0]), int(img_shape[1])
    ratio = np.float32(ori_shape[0]) / np.float32(h_img)
    intr = np.asarray(intrinsic, np.float32)[:3, :3].copy()
    intr[:2] /= ratio
    proj = np.einsum("ij,vjk->vik", intr,
                     np.asarray(extrinsics, np.float32)[:, :3, :])

    pts_h = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=-1)
    cam = np.einsum("vij,nj->vin", proj, pts_h.astype(np.float32),
                    dtype=np.float32)  # (V, 3, N)
    z = cam[:, 2]
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        px = np.nan_to_num(cam[:, 0] / z, nan=-1.0, posinf=-1.0,
                           neginf=-1.0)
        py = np.nan_to_num(cam[:, 1] / z, nan=-1.0, posinf=-1.0,
                           neginf=-1.0)
    x = np.round(px).astype(np.int32)
    y = np.round(py).astype(np.int32)
    valid = (x >= 0) & (y >= 0) & (x < w_img) & (y < h_img) & (z > 0)

    imgs = np.asarray(denorm_imgs, np.float32)
    v = imgs.shape[0]
    flat = imgs.reshape(v, -1, 3)
    lin = (np.clip(y, 0, h_img - 1) * imgs.shape[2]
           + np.clip(x, 0, w_img - 1))
    gathered = np.take_along_axis(flat, lin[..., None], axis=1)
    if compute_dtype in ("bfloat16", torch.bfloat16):
        # rounding only the gathered rows equals rounding the images
        # first (a gather preserves values) and is cheaper
        gathered = _round_bf16(gathered)
    gathered *= valid[..., None].astype(np.float32)
    return gathered.sum(0), (gathered * gathered).sum(0)
