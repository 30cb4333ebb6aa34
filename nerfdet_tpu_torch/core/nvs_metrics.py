"""Novel-view-synthesis metrics: PSNR / SSIM / RMSE + rendered dumps.

Equivalent of `mmdet3d/models/model_utils/save_rendered_img.py:10-78`
and the aggregate driver `evaluate_nerf.py:1-12`. SSIM is the standard
skimage `structural_similarity` formulation (7x7 uniform window,
Gaussian-free default, data_range=1) re-implemented in numpy since
skimage is not in the image.

A copy of ``nerfdet_tpu/core/nvs_metrics.py`` (numpy only), so the port
scores its renders without the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def compute_psnr(pred: np.ndarray, target: np.ndarray,
                 mask: Optional[np.ndarray] = None) -> float:
    """-10 log10(mse), max pixel value 1 (reference `:13-19`)."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    if mask is not None:
        pred, target = pred[mask], target[mask]
    mse = np.mean((pred - target) ** 2)
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Mean filter with reflect padding over the first two axes."""
    pad = size // 2
    x = np.pad(x, ((pad, pad), (pad, pad)) + ((0, 0),) * (x.ndim - 2),
               mode="reflect")
    c = np.cumsum(np.cumsum(x, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)) + ((0, 0),) * (x.ndim - 2))
    s = (c[size:, size:] - c[:-size, size:] - c[size:, :-size]
         + c[:-size, :-size])
    return s / (size * size)


def compute_ssim(pred: np.ndarray, target: np.ndarray,
                 data_range: float = 1.0, win_size: int = 7) -> float:
    """skimage-default SSIM (uniform window, channel-averaged)."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    assert pred.shape == target.shape and pred.shape[-1] == 3
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    n = win_size * win_size
    cov_norm = n / (n - 1)

    ux = _uniform_filter(pred, win_size)
    uy = _uniform_filter(target, win_size)
    uxx = _uniform_filter(pred * pred, win_size)
    uyy = _uniform_filter(target * target, win_size)
    uxy = _uniform_filter(pred * target, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return float(s[pad:-pad or None, pad:-pad or None].mean())


def evaluate_rendering(rgb: np.ndarray, gt_rgb: np.ndarray,
                       depth: Optional[np.ndarray] = None,
                       gt_depth: Optional[np.ndarray] = None,
                       out_dir: Optional[str] = None,
                       scene: str = "scene") -> Dict[str, float]:
    """Per-scene NVS metrics over (V, H, W, 3) views; optional PNG dump
    of [pred | gt | normalized-depth] strips (reference `:38-78`)."""
    v = rgb.shape[0]
    psnr = ssim = rmse = 0.0
    for i in range(v):
        psnr += compute_psnr(rgb[i], gt_rgb[i])
        ssim += compute_ssim(rgb[i], gt_rgb[i])
        if depth is not None and gt_depth is not None:
            rmse += float(np.mean((depth[i] - gt_depth[i]) ** 2))
        if out_dir is not None:
            from PIL import Image

            os.makedirs(os.path.join(out_dir, scene), exist_ok=True)
            strip = [rgb[i], gt_rgb[i]]
            if depth is not None:
                d = depth[i]
                dn = (d - d.min()) / (d.max() - d.min() + 1e-8)
                strip.append(np.repeat(dn[..., None], 3, axis=-1))
            img = np.uint8(np.clip(np.concatenate(strip, axis=1), 0, 1)
                           * 255.0)
            Image.fromarray(img).save(
                os.path.join(out_dir, scene, f"view_{i}.png"))
    out = dict(psnr=psnr / v, ssim=ssim / v)
    if depth is not None and gt_depth is not None:
        out["rmse"] = float(np.sqrt(rmse / v))
    return out


def aggregate_nvs(per_scene: Dict[str, Dict[str, float]]
                  ) -> Dict[str, float]:
    """Average per-scene metrics (reference `evaluate_nerf.py:1-12`)."""
    keys = {k for m in per_scene.values() for k in m}
    return {
        k: float(np.mean([m[k] for m in per_scene.values() if k in m]))
        for k in sorted(keys)
    }
