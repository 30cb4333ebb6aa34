"""Synthetic ScanNet-like scenes (numpy only).

A copy of ``make_synthetic_scene`` and ``write_synthetic_scannet`` of
``nerfdet_tpu/data/synthetic.py``, so the port has scenes without JAX
(the image helpers come from ``data/pipeline.py``, as the original's
do). Colored axis-aligned boxes on a
checkered floor are ray-cast into posed pinhole views. The random
stream is consumed exactly as the original does, so every key (the
detection keys imgs, denorm_images, intrinsic, extrinsics, origin,
gt_boxes, gt_labels, gt_mask and the render targets ray_o, ray_d,
gt_rgb, gt_depth) is bitwise equal to the original's for the same
arguments.

``make_synthetic_cloud`` is the point-cloud counterpart for VoteNet:
box surfaces on a floor as ``write_synthetic_scannet`` builds them,
given the height column of ``load_points`` and resampled to a static
count as ``sample_points`` does (``nerfdet_tpu/data/pipeline.py``).

``write_synthetic_scannet`` puts such scenes on disk in ScanNet's
layout (``posed_images/`` + ``scannet_infos_{split}.pkl`` + the points
``.bin``) from the same random stream as the original, with the views
written as PNG (the original writes JPEG; the port reads PNG without
``cv2`` or ``PIL``).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .pipeline import (get_dtu_raydir, imdenormalize, imnormalize,
                       imwrite_png, pad_gt)

# img_norm_cfg of the NeRF-Det configs (RGB)
IMG_MEAN = (123.675, 116.28, 103.53)
IMG_STD = (58.395, 57.12, 57.375)


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
    """Nearest axis-aligned box hit per pixel: rgb in [0, 1] (H, W, 3)
    and the camera depth (H, W), 0 where no surface is hit."""
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
    # ray dirs have camera-space z = 1 before rotation, so the ray
    # parameter t IS the camera depth
    depth = np.where(np.isfinite(t_best), t_best, 0.0).astype(np.float32)
    return np.clip(rgb, 0, 1), depth


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


# every camera of a synthetic scene looks at this point
LOOK_AT = (0.0, 0.0, 0.6)

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
    n_rand: int = 512,
    n_boxes: int = 3,
    max_gt: int = 8,
    margin: int = 2,
) -> Dict[str, np.ndarray]:
    """One synthetic scene: source views, boxes and target-view rays.

    Returns imgs (V, Hp, Wp, 3) normalized and denorm_images
    (V, Hp, Wp, 3) in [0, 1], both zero-padded from ``hw`` to
    ``pad_hw``; intrinsic (4, 4) at ``hw``; extrinsics (V, 4, 4)
    world->camera; origin (3,); gt_boxes (max_gt, 7), gt_labels,
    gt_mask; and ``n_rand`` rays drawn without replacement from the
    pixel grids of the ``n_targets`` target views, inside ``margin``:
    ray_o, ray_d (n_rand, 3), gt_rgb (n_rand, 3) uint8-quantized and
    gt_depth (n_rand,). With ``n_rand`` at least the grid's size the
    rays are all of them, in random order.
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
        views.append(_look_at(pos, LOOK_AT))

    imgs, denorms, extr = [], [], []
    for c2w in views[:n_views]:
        rgb, _ = _render_view(boxes, colors, c2w, intr, hw)
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

    # target-view rays
    ray_o, ray_d, gt_rgb, gt_depth = [], [], [], []
    py, px = np.mgrid[margin:h - margin, margin:w - margin]
    pix = np.stack([px, py], axis=-1).astype(np.float32)
    for c2w in views[n_views:]:
        rgb, depth = _render_view(boxes, colors, c2w, intr, hw)
        dirs = get_dtu_raydir(pix, intr, c2w[:3, :3]).reshape(-1, 3)
        ray_d.append(dirs)
        ray_o.append(np.broadcast_to(c2w[:3, 3], dirs.shape))
        # round-trip through the uint8 quantization like the pipeline
        q = imdenormalize(imnormalize(rgb * 255.0, IMG_MEAN, IMG_STD),
                          IMG_MEAN, IMG_STD)
        gt_rgb.append(q[py, px].reshape(-1, 3))
        gt_depth.append(depth[py, px].reshape(-1))
    ray_o = np.concatenate(ray_o)
    ray_d = np.concatenate(ray_d)
    gt_rgb = np.concatenate(gt_rgb)
    gt_depth = np.concatenate(gt_depth)
    sel = rng.choice(ray_d.shape[0], size=(min(n_rand, ray_d.shape[0]),),
                     replace=False)
    out["ray_o"] = ray_o[sel].astype(np.float32)
    out["ray_d"] = ray_d[sel].astype(np.float32)
    out["gt_rgb"] = gt_rgb[sel].astype(np.float32)
    out["gt_depth"] = gt_depth[sel].astype(np.float32)

    out["gt_boxes"], out["gt_labels"], out["gt_mask"] = pad_gt(
        boxes, labels, max_gt)
    return out


# the synthetic cloud: 4 boxes of 8000 surface points on a 16000-point
# floor, 48000 points in all, more than ScanNet's 40000-point sample
CLOUD_BOXES, POINTS_PER_BOX, FLOOR_POINTS = 4, 8000, 16000


def make_synthetic_cloud(seed: int = 0,
                         n_points: int = 40000) -> Dict[str, np.ndarray]:
    """One synthetic ScanNet-like cloud for VoteNet.

    Each box contributes ``POINTS_PER_BOX`` points on its faces, the
    floor ``FLOOR_POINTS`` points in a 3 cm slab over 8 x 8 m. The
    height above the floor (0.99th percentile of z) is appended as the
    fourth column, then ``n_points`` are sampled without replacement,
    as a scan is.
    Returns points (n_points, 4) float32, gt_boxes (CLOUD_BOXES, 7)
    bottom-centered, gt_labels (CLOUD_BOXES,).
    """
    rng = np.random.RandomState(seed)
    boxes, labels = make_scene_geometry(rng, CLOUD_BOXES)
    cloud = []
    for b in boxes:
        local = rng.uniform(-0.5, 0.5, (POINTS_PER_BOX, 3)).astype(
            np.float32)
        face = rng.randint(0, 3, POINTS_PER_BOX)
        sign = rng.randint(0, 2, POINTS_PER_BOX) * 2 - 1
        local[np.arange(POINTS_PER_BOX), face] = 0.48 * sign
        cloud.append(local * b[3:6] + [b[0], b[1], b[2] + b[5] / 2])
    cloud.append(rng.uniform([-4, -4, 0], [4, 4, 0.03],
                             (FLOOR_POINTS, 3)))
    xyz = np.concatenate(cloud).astype(np.float32)
    floor = np.percentile(xyz[:, 2], 0.99)
    pts = np.concatenate([xyz, (xyz[:, 2] - floor)[:, None]],
                         axis=-1).astype(np.float32)
    sel = rng.choice(pts.shape[0], n_points, replace=False)
    return dict(points=pts[sel], gt_boxes=boxes, gt_labels=labels)


def _write_view(job) -> None:
    """Render one view and write it as a PNG (a process pool's task)."""
    boxes, colors, c2w, intr, hw, path = job
    rgb, _ = _render_view(boxes, colors, c2w, intr, hw)
    imwrite_png(path, (rgb * 255).astype(np.uint8))


def write_synthetic_scannet(root: str, n_scenes: int = 2,
                            n_images: int = 10,
                            hw: Tuple[int, int] = (96, 128),
                            n_boxes: int = 3, seed: int = 0,
                            splits: Sequence[str] = ("train", "val"),
                            workers: int = 1) -> str:
    """Write synthetic scenes in ScanNet's on-disk layout under ``root``:
    ``posed_images/scene####_00/#####.png`` (``n_images`` views of
    ``hw`` on a circle around the boxes), ``points/scene####_00.bin``
    ((N, 6) float32 xyz + rgb) and ``scannet_infos_{split}.pkl`` with the
    reference info schema (img_paths, extrinsics c2w, intrinsics at
    ``hw``, pts_path, annos with gravity-centered boxes), ``n_scenes``
    per split. The views are rendered in ``workers`` processes; the
    random stream does not depend on it. Returns ``root``."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = hw
    f = 0.9 * w
    intr = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0],
                     [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    jobs = []
    scene_idx = 0
    for split in splits:
        infos = []
        for _ in range(n_scenes):
            scene = f"scene{scene_idx:04d}_00"
            scene_idx += 1
            os.makedirs(os.path.join(root, "posed_images", scene),
                        exist_ok=True)
            boxes, labels = make_scene_geometry(rng, n_boxes)
            colors = _PALETTE[rng.randint(0, len(_PALETTE), len(boxes))]
            img_paths, poses = [], []
            for i in range(n_images):
                ang = 2 * np.pi * i / n_images
                pos = np.array([3.6 * np.cos(ang), 3.6 * np.sin(ang), 1.7],
                               np.float32)
                c2w = _look_at(pos, LOOK_AT)
                rel = os.path.join("posed_images", scene, f"{i:05d}.png")
                jobs.append((boxes, colors, c2w, intr, hw,
                             os.path.join(root, rel)))
                img_paths.append(rel)
                poses.append(c2w.astype(np.float32))
            # point-cloud modality: box-surface + floor samples in the
            # real ETL's (N, 6) float32 xyz+rgb .bin layout
            os.makedirs(os.path.join(root, "points"), exist_ok=True)
            cloud = []
            for b, col in zip(boxes, colors):
                n = 400
                local = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
                face = rng.randint(0, 3, n)
                sign = rng.randint(0, 2, n) * 2 - 1
                local[np.arange(n), face] = 0.48 * sign
                xyz = local * b[3:6] + [b[0], b[1], b[2] + b[5] / 2]
                rgb = np.broadcast_to(col, (n, 3)).astype(np.float32)
                cloud.append(np.concatenate([xyz, rgb], -1))
            floor = rng.uniform([-4, -4, 0], [4, 4, 0.03],
                                (800, 3)).astype(np.float32)
            cloud.append(np.concatenate(
                [floor, np.full((800, 3), 0.5, np.float32)], -1))
            cloud = np.concatenate(cloud).astype(np.float32)
            pts_rel = os.path.join("points", f"{scene}.bin")
            cloud.tofile(os.path.join(root, pts_rel))

            # gravity-centered GT, reference info schema
            gt = boxes[:, :6].copy()
            gt[:, 2] += boxes[:, 5] / 2.0
            infos.append(dict(
                img_paths=img_paths,
                extrinsics=poses,
                intrinsics=intr,
                pts_path=pts_rel,
                annos=dict(
                    gt_num=len(gt),
                    gt_boxes_upright_depth=gt.astype(np.float32),
                    axis_align_matrix=np.eye(4, dtype=np.float32),
                    **{"class": labels},
                ),
            ))
        with open(os.path.join(root, f"scannet_infos_{split}.pkl"),
                  "wb") as fp:
            pickle.dump(infos, fp)
    if workers > 1 and len(jobs) > 1:
        # spawned, not forked: the caller may hold a CUDA context and
        # BLAS threads
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            pool.map(_write_view, jobs, chunksize=1)
    else:
        for job in jobs:
            _write_view(job)
    return root
