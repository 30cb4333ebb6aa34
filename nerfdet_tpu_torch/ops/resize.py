"""Antialiased linear resize, as ``jax.image.resize(..., "bilinear" or
"trilinear")``: one axis at a time, each a product with (in, out)
triangle weights that widen by in/out when the axis shrinks (a low-pass
filter), unlike ``F.interpolate``."""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of ``jax.image.resize`` along one axis,
    antialiased."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale)
                - f32(0.0 * inv_scale) - f32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0), f32(1) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


def resize_axes(x: torch.Tensor,
                sizes: Iterable[Tuple[int, int]]) -> torch.Tensor:
    """``x`` (float) resized along each ``(axis, size)`` in turn; an axis
    whose size is unchanged is left as it is."""
    for axis, size_out in sizes:
        if x.shape[axis] == size_out:
            continue
        w = torch.from_numpy(resize_weights(x.shape[axis], size_out)).to(
            x.device)
        x = torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1,
                          axis)
    return x
