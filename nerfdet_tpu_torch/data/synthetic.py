"""Synthetic ScanNet-like scenes for detection (numpy only).

A copy of the detection part of ``nerfdet_tpu/data/synthetic.py``
(``make_synthetic_scene``) and of the image helpers it uses from
``nerfdet_tpu/data/pipeline.py``, so the port has a scene without JAX.
Colored axis-aligned boxes on a checkered floor are ray-cast into posed
pinhole views. The random stream is consumed exactly as the original
does, so the detection keys (imgs, denorm_images, intrinsic,
extrinsics, origin, gt_boxes, gt_labels, gt_mask) are bitwise equal to
the original's for the same arguments; the render-target rays are left
out.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# img_norm_cfg of the NeRF-Det configs (RGB)
IMG_MEAN = (123.675, 116.28, 103.53)
IMG_STD = (58.395, 57.12, 57.375)


def imnormalize(img: np.ndarray, mean, std) -> np.ndarray:
    """(img - mean) / std in float32, RGB."""
    img = img.astype(np.float32)
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def imdenormalize(img: np.ndarray, mean, std) -> np.ndarray:
    """Invert :func:`imnormalize` to a uint8-quantized [0, 1] float."""
    x = img * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    return np.clip(x, 0, 255).astype(np.uint8).astype(np.float32) / 255.0


def get_dtu_raydir(pixelcoords, intrinsic, rot):
    """Pixel grid -> world-space ray directions (+0.5 pixel centers)."""
    x = (pixelcoords[..., 0] + 0.5 - intrinsic[0, 2]) / intrinsic[0, 0]
    y = (pixelcoords[..., 1] + 0.5 - intrinsic[1, 2]) / intrinsic[1, 1]
    z = np.ones_like(x)
    dirs = np.stack([x, y, z], axis=-1) @ rot.T
    return dirs.astype(np.float32)


def pad_gt(gt_boxes: np.ndarray, gt_labels: np.ndarray, max_gt: int):
    """Pad ground truth to a static (max_gt, 7) + mask."""
    g = min(len(gt_boxes), max_gt)
    boxes = np.zeros((max_gt, 7), np.float32)
    # degenerate padding boxes far outside the scene so they never match
    boxes[:, :3] = 1e4
    boxes[:, 3:6] = 1e-3
    labels = np.zeros((max_gt,), np.int32)
    mask = np.zeros((max_gt,), bool)
    if g:
        gt_boxes = np.asarray(gt_boxes, np.float32)
        if gt_boxes.shape[-1] == 6:
            gt_boxes = np.concatenate(
                [gt_boxes, np.zeros_like(gt_boxes[:, :1])], axis=-1)
        boxes[:g] = gt_boxes[:g]
        labels[:g] = np.asarray(gt_labels, np.int64)[:g]
        mask[:g] = True
    return boxes, labels, mask


def _look_at(cam_pos, target, up=(0.0, 0.0, 1.0)):
    """c2w with +z forward, +x right, +y down (OpenCV convention)."""
    fwd = np.asarray(target, np.float32) - np.asarray(cam_pos, np.float32)
    fwd = fwd / (np.linalg.norm(fwd) + 1e-9)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right = right / (np.linalg.norm(right) + 1e-9)
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, down, fwd
    c2w[:3, 3] = cam_pos
    return c2w


def _render_view(boxes, colors, c2w, intr, hw: Tuple[int, int]):
    """Nearest axis-aligned box hit per pixel: rgb in [0, 1], (H, W, 3)."""
    h, w = hw
    py, px = np.mgrid[0:h, 0:w].astype(np.float32)
    pix = np.stack([px, py], axis=-1)
    dirs = get_dtu_raydir(pix, intr, c2w[:3, :3])  # (H, W, 3)
    o = c2w[:3, 3]
    inv_d = 1.0 / np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)

    t_best = np.full(dirs.shape[:2], np.inf, np.float32)
    rgb = np.zeros(dirs.shape[:2] + (3,), np.float32)
    # floor plane z = 0 with a checker texture
    t_floor = (0.0 - o[2]) * inv_d[..., 2]
    hit = t_floor > 0.05
    p = o[None, None] + t_floor[..., None] * dirs
    checker = ((np.floor(p[..., 0]) + np.floor(p[..., 1])) % 2).astype(
        np.float32)
    floor_rgb = np.stack([0.25 + 0.2 * checker] * 3, axis=-1)
    t_best = np.where(hit, t_floor, t_best)
    rgb = np.where(hit[..., None], floor_rgb, rgb)

    for box, color in zip(boxes, colors):
        cx, cy, cz, dx, dy, dz = box[:6]
        bmin = np.array([cx - dx / 2, cy - dy / 2, cz], np.float32)
        bmax = np.array([cx + dx / 2, cy + dy / 2, cz + dz], np.float32)
        t1 = (bmin[None, None] - o[None, None]) * inv_d
        t2 = (bmax[None, None] - o[None, None]) * inv_d
        tmin = np.minimum(t1, t2).max(axis=-1)
        tmax = np.maximum(t1, t2).min(axis=-1)
        hit = (tmax > np.maximum(tmin, 0.05)) & (tmin < t_best)
        t_hit = np.where(tmin > 0.05, tmin, tmax)
        hit = hit & (t_hit > 0.05)
        shade = 0.7 + 0.3 * np.clip(t_hit / 8.0, 0, 1)
        t_best = np.where(hit, t_hit, t_best)
        rgb = np.where(hit[..., None],
                       np.asarray(color, np.float32) * shade[..., None],
                       rgb)
    return np.clip(rgb, 0, 1)


def make_scene_geometry(rng: np.random.RandomState, n_boxes: int = 3):
    """Random non-overlapping boxes + labels on the floor."""
    boxes, labels = [], []
    for _ in range(n_boxes):
        for _attempt in range(20):
            c = rng.uniform(-1.8, 1.8, 2)
            d = rng.uniform(0.5, 1.2, 2)
            h = rng.uniform(0.5, 1.4)
            cand = np.array([c[0], c[1], 0.0, d[0], d[1], h, 0.0],
                            np.float32)
            if all(abs(cand[0] - b[0]) > (cand[3] + b[3]) / 2 or
                   abs(cand[1] - b[1]) > (cand[4] + b[4]) / 2
                   for b in boxes):
                boxes.append(cand)
                labels.append(int(rng.randint(0, 18)))
                break
    return np.stack(boxes), np.asarray(labels, np.int64)


_PALETTE = np.array([
    [0.9, 0.2, 0.2], [0.2, 0.8, 0.3], [0.25, 0.35, 0.9], [0.9, 0.8, 0.2],
    [0.8, 0.3, 0.8], [0.3, 0.8, 0.8], [0.95, 0.55, 0.2], [0.6, 0.4, 0.2],
], np.float32)


def make_synthetic_scene(
    seed: int = 0,
    n_views: int = 8,
    n_targets: int = 2,
    hw: Tuple[int, int] = (60, 80),
    pad_hw: Optional[Tuple[int, int]] = None,
    n_boxes: int = 3,
    max_gt: int = 8,
) -> Dict[str, np.ndarray]:
    """One synthetic scene with the detection keys.

    Returns imgs (V, Hp, Wp, 3) normalized and denorm_images
    (V, Hp, Wp, 3) in [0, 1], both zero-padded from ``hw`` to
    ``pad_hw``; intrinsic (4, 4); extrinsics (V, 4, 4) world->camera;
    origin (3,); gt_boxes (max_gt, 7), gt_labels, gt_mask.
    ``n_targets`` only places the (unrendered) target cameras, which
    keeps the random stream and the source poses those of the original.
    """
    rng = np.random.RandomState(seed)
    h, w = hw
    ph, pw = pad_hw or hw
    boxes, labels = make_scene_geometry(rng, n_boxes)
    colors = _PALETTE[rng.randint(0, len(_PALETTE), len(boxes))]

    f = 0.9 * w
    intr = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0],
                     [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)

    views = []
    for i in range(n_views + n_targets):
        ang = 2 * np.pi * i / (n_views + n_targets) + rng.uniform(-.1, .1)
        r = rng.uniform(3.2, 4.2)
        pos = np.array([r * np.cos(ang), r * np.sin(ang),
                        rng.uniform(1.2, 2.2)], np.float32)
        views.append(_look_at(pos, (0.0, 0.0, 0.6)))

    imgs, denorms, extr = [], [], []
    for c2w in views[:n_views]:
        rgb = _render_view(boxes, colors, c2w, intr, hw)
        norm = imnormalize(rgb * 255.0, IMG_MEAN, IMG_STD)
        denorm = imdenormalize(norm, IMG_MEAN, IMG_STD)
        pad = np.zeros((ph, pw, 3), np.float32)
        pad[:h, :w] = norm
        padd = np.zeros((ph, pw, 3), np.float32)
        padd[:h, :w] = denorm
        imgs.append(pad)
        denorms.append(padd)
        extr.append(np.linalg.inv(c2w).astype(np.float32))

    out = dict(
        imgs=np.stack(imgs),
        denorm_images=np.stack(denorms),
        intrinsic=intr,
        extrinsics=np.stack(extr),
        origin=np.array([0.0, 0.0, 0.5], np.float32),
    )
    out["gt_boxes"], out["gt_labels"], out["gt_mask"] = pad_gt(
        boxes, labels, max_gt)
    return out
