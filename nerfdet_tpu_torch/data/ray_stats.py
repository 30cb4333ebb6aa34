"""Host-side ray stream of the render branch's training path (numpy).

A copy of ``host_sample_z`` and ``host_ray_rgb_stats`` of
``nerfdet_tpu/ops/render.py`` (float32 and bfloat16) and of the ray part of
``ScanNetMultiViewDataset.__getitem__`` (``nerfdet_tpu/data/dataset.py``:
``subsample_rays``, then the host stream). The stratified depths and
the per-sample rgb sums over the source views depend on the ray geometry
and the input images only (no parameters), so the data path computes
them and K2 samples only the feature maps on the device.

Exactness: the same numpy float32 operations in the same order as the
originals, the views summed one after another (numpy's axis sum is
pairwise), so z and the four sums equal the originals bit for bit for
the same ``np.random.RandomState``. The bfloat16 stream rounds the images
and each tap sum to bfloat16 (round to nearest even, through torch, as
``ml_dtypes`` rounds in the original).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .rgb_stats import _round_bf16


def host_sample_z(rng: np.random.RandomState, n_rays: int, near: float,
                  far: float, n_samples: int,
                  det: bool = False) -> np.ndarray:
    """Stratified depths (R, S) float32: the evenly spaced depths, each
    jittered uniformly inside its stratum (the midpoints to its
    neighbours) unless ``det``."""
    step = np.float32((far - near) / (n_samples - 1))
    z = (np.float32(near)
         + step * np.arange(n_samples, dtype=np.float32))
    z = np.broadcast_to(z[None], (n_rays, n_samples)).copy()
    if not det:
        mids = np.float32(0.5) * (z[:, 1:] + z[:, :-1])
        upper = np.concatenate([mids, z[:, -1:]], axis=-1)
        lower = np.concatenate([z[:, 0:1], mids], axis=-1)
        t = rng.random_sample(z.shape).astype(np.float32)
        z = lower + (upper - lower) * t
    return z


def host_ray_rgb_stats(denorm_images, intrinsic, extrinsics, ray_o, ray_d,
                       z_vals, ori_shape, img_shape,
                       compute_dtype="float32"):
    """K2's rgb stream on the host: for each sample point, over the
    source views in order, the bilinear rgb sample f of the padded image
    adds to ``s1u += f``, ``s2u += f*f`` and, where the view sees the
    point (inside ``img_shape`` and in front), ``s1m += f`` and ``cnt +=
    1``. Returns (s1u, s2u, s1m) (R, S, 3) and cnt (R, S, 1), float32.

    ``compute_dtype`` "bfloat16" (the JAX ``--bf16`` path) rounds the
    images to bfloat16 before the float32 taps and each tap sum f after
    them, as K2's eval form samples bfloat16 images.
    """
    bf16 = _is_bf16(compute_dtype)
    h, w = int(img_shape[0]), int(img_shape[1])
    ratio = np.float32(ori_shape[0]) / np.float32(h)
    intr = np.asarray(intrinsic, np.float32)
    intr4 = np.eye(4, dtype=np.float32)
    intr4[: intr.shape[0], : intr.shape[1]] = intr
    intr4[:2] /= ratio
    poses = np.asarray(extrinsics, np.float32)
    proj = np.einsum("ij,vjk->vik", intr4, poses).astype(np.float32)

    pts = (np.asarray(z_vals, np.float32)[..., None]
           * np.asarray(ray_d, np.float32)[:, None, :]
           + np.asarray(ray_o, np.float32)[:, None, :])  # (R, S, 3)
    r, s = pts.shape[:2]
    xyz = pts.reshape(-1, 3)
    xyz_h = np.concatenate([xyz, np.ones_like(xyz[:, :1])], axis=-1)
    cam = np.einsum("vij,nj->vni", proj, xyz_h).astype(np.float32)
    z = np.clip(cam[..., 2], 1e-8, None)
    px = np.clip(cam[..., 0] / z, -1e6, 1e6)
    py = np.clip(cam[..., 1] / z, -1e6, 1e6)
    in_front = cam[..., 2] > 0
    inbound = (px <= w - 1.0) & (px >= 0) & (py <= h - 1.0) & (py >= 0)
    mask = (inbound & in_front).astype(np.float32)  # (V, R*S)

    imgs = np.asarray(denorm_images, np.float32)
    if bf16:
        imgs = _round_bf16(imgs)
    v, ih, iw, _ = imgs.shape
    sx = np.float32((iw - 1.0) / (w - 1.0))
    sy = np.float32((ih - 1.0) / (h - 1.0))
    pxs, pys = px * sx, py * sy
    x0 = np.clip(np.floor(pxs), 0.0, iw - 1.0)
    y0 = np.clip(np.floor(pys), 0.0, ih - 1.0)
    rx, ry = pxs - x0, pys - y0
    wx0 = np.maximum(np.float32(0), np.float32(1) - np.abs(rx))
    wx1 = np.maximum(np.float32(0), np.float32(1) - np.abs(rx - 1))
    wy0 = np.maximum(np.float32(0), np.float32(1) - np.abs(ry))
    wy1 = np.maximum(np.float32(0), np.float32(1) - np.abs(ry - 1))
    x0i = x0.astype(np.int64)
    y0i = y0.astype(np.int64)

    # zero pad on the right and bottom, as pack_bilinear
    pad = np.pad(imgs, ((0, 0), (0, 1), (0, 1), (0, 0)))
    flat = pad.reshape(v, (ih + 1) * (iw + 1), 3)
    base = y0i * (iw + 1) + x0i

    n = r * s
    s1u = np.zeros((n, 3), np.float32)
    s2u = np.zeros((n, 3), np.float32)
    s1m = np.zeros((n, 3), np.float32)
    cnt = np.zeros((n, 1), np.float32)
    for vi in range(v):
        fv = flat[vi]
        lin = base[vi]
        f = (fv[lin] * (wy0[vi] * wx0[vi])[:, None]
             + fv[lin + 1] * (wy0[vi] * wx1[vi])[:, None]
             + fv[lin + (iw + 1)] * (wy1[vi] * wx0[vi])[:, None]
             + fv[lin + (iw + 2)] * (wy1[vi] * wx1[vi])[:, None])
        if bf16:
            f = _round_bf16(f)
        m = mask[vi][:, None]
        s1u += f
        s2u += f * f
        s1m += f * m
        cnt += m
    return (s1u.reshape(r, s, 3), s2u.reshape(r, s, 3),
            s1m.reshape(r, s, 3), cnt.reshape(r, s, 1))


def _is_bf16(compute_dtype) -> bool:
    """float32 or bfloat16 (by name or torch dtype); anything else raises."""
    if compute_dtype in (np.float32, "float32", torch.float32):
        return False
    if compute_dtype in ("bfloat16", torch.bfloat16):
        return True
    raise TypeError(f"the host ray stream takes float32 or bfloat16, got "
                    f"{compute_dtype!r}")


RAY_STREAM_KEYS = ("z_vals", "ray_s1u", "ray_s2u", "ray_s1m", "ray_cnt")


def prepare_rays(scene: Dict, rng: np.random.RandomState, n_rand: int,
                 near_far: Sequence[float], n_samples: int,
                 ori_shape: Tuple[int, int], img_shape: Tuple[int, int],
                 compute_dtype="float32") -> Dict:
    """A training scene's rays and their host stream, as the JAX data
    pipeline ships them: ``scene`` carries ray_o, ray_d, gt_rgb (and
    optionally gt_depth), flat (R, ...) or per target view (T, R', ...).
    Draws ``n_rand`` of them without replacement where the scene holds
    more (dropping zero-depth rays first where it carries depths and
    enough remain), then draws the stratified depths and sums the rgb
    stream, all from ``rng`` in that order. Returns a new dict with the
    rays and ``RAY_STREAM_KEYS`` (z_vals (R, S), ray_s1u / ray_s2u /
    ray_s1m (R, S, 3), ray_cnt (R, S, 1)); ``compute_dtype`` is the
    stream's (``host_ray_rgb_stats``)."""
    out = draw_rays(scene, rng, n_rand)
    z_vals = host_sample_z(rng, out["ray_o"].shape[0], near_far[0],
                           near_far[1], n_samples)
    stats = host_ray_rgb_stats(
        scene["denorm_images"], scene["intrinsic"], scene["extrinsics"],
        out["ray_o"], out["ray_d"], z_vals, ori_shape, img_shape,
        compute_dtype)
    out.update(zip(RAY_STREAM_KEYS, (z_vals,) + stats))
    return out


def draw_rays(scene: Dict, rng: np.random.RandomState, n_rand: int) -> Dict:
    """``prepare_rays``' draw alone: a new dict with the scene's rays
    flat, ``n_rand`` of them drawn without replacement from ``rng`` where
    it holds more (zero-depth rays dropped first where it carries depths
    and enough remain)."""
    out = dict(scene)
    rays = {k: np.asarray(scene[k]) for k in ("ray_o", "ray_d", "gt_rgb")}
    rays = {k: a.reshape(-1, 3) for k, a in rays.items()}
    if "gt_depth" in scene:
        rays["gt_depth"] = np.asarray(scene["gt_depth"]).reshape(-1)
    if rays["ray_d"].shape[0] > n_rand:
        if "gt_depth" in rays:
            nz = rays["gt_depth"] > 0
            if nz.sum() >= n_rand:
                rays = {k: a[nz] for k, a in rays.items()}
        sel = rng.choice(rays["ray_d"].shape[0], size=(n_rand,),
                         replace=False)
        rays = {k: a[sel] for k, a in rays.items()}
    out.update(rays)
    return out
