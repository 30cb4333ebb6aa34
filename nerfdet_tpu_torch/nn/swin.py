"""Swin Transformer backbone (channels last).

Port of ``nerfdet_tpu/nn/swin.py``: a 4x4 patch embedding, four stages
of window attention blocks (every second block on windows shifted by
half a window, under the -100 mask that keeps shifted-in tokens apart),
with a relative position bias, patch merging between stages and a
LayerNorm on each stage's output. Module names are the flax names
(``patch_embed``, ``stage{i}_block{d}.attn.qkv``, ``downsample{i}``,
``out_norm{i}``, ...), so no parameter matches the optimizer's freeze
rule (``train/optim.is_frozen_backbone_param``), as in the JAX package.

As there, each stage's map is zero-padded to a multiple of the window
before its blocks and cropped after them: the pad tokens take part in
the attention unmasked and pass through ``norm1`` like the others. The
attention is written as its products, bias and mask adds and a softmax,
in the JAX order, its softmax and the MLP's tanh GELU (flax's ``nn.gelu``
default) op by op as JAX writes them. ``dtype`` is flax's compute dtype
(``nn/compute.py``): every op rounds to bfloat16 where JAX's does; a
LayerNorm computes its statistics and its affine in float32 and rounds
once, as flax's does (its variance E[x^2] - E[x]^2, clipped at 0).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .compute import conv, linear

LN_EPS = 1e-6  # flax's LayerNorm epsilon (torch's default is 1e-5)


def layer_norm(ln: nn.LayerNorm, x, dtype):
    """flax ``LayerNorm`` over the last axis: float32 statistics and
    affine, the result in ``dtype``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0)
    y = (xf - mean) * (torch.rsqrt(var + ln.eps) * ln.weight)
    return (y + ln.bias).to(dtype)


def _const(value: float, like):
    """A constant in ``like``'s dtype: JAX rounds a Python scalar to the
    dtype of the array it meets (its weak type); torch would keep it in
    float32 inside a bfloat16 op."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def softmax(x):
    """``jax.nn.softmax`` over the last axis, op by op: exp(x - max), then
    its sum, then the quotient, each rounded to x's dtype (on bfloat16
    ``torch.softmax`` rounds once, which JAX does not)."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def gelu_tanh(x):
    """``jax.nn.gelu(approximate=True)`` (flax's default ``nn.gelu``) op by
    op: x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))) / 2 with x^3 as
    x (x x), each op and constant in x's dtype."""
    cube = x * (x * x)
    inner = _const(float(np.sqrt(2 / np.pi)), x) * (
        x + _const(0.044715, x) * cube)
    return x * (_const(0.5, x) * (_const(1.0, x) + torch.tanh(inner)))


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B*nH*nW, ws*ws, C); H, W multiples of ws."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows, ws: int, b: int, h: int, w: int):
    c = windows.shape[-1]
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2 ws - 1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask of the shifted windows: -100 between
    tokens of different regions, else 0."""
    img = np.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wss, :] = cnt
            cnt += 1
    win = np.reshape(np.transpose(
        img.reshape(1, h // ws, ws, w // ws, ws, 1), (0, 1, 3, 2, 4, 5)),
        (-1, ws * ws))
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)),
            persistent=False)

    def forward(self, x, mask=None):
        """x (nW, N, C); mask (nW_img, N, N) or None."""
        nw, n, c = x.shape
        h = self.num_heads
        d = c // h
        qkv = linear(self.qkv, x, self.dtype).reshape(nw, n, 3, h, d)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each (nW, h, N, d)
        attn = (q * _const(d ** -0.5, q)) @ k.transpose(-1, -2)
        bias = self.relative_position_bias_table[self.index]
        attn = attn + bias.reshape(n, n, h).permute(2, 0, 1)[None].to(
            attn.dtype)
        if mask is not None:
            nm = mask.shape[0]
            attn = (attn.reshape(nw // nm, nm, h, n, n)
                    + mask[None, :, None].to(attn.dtype)).reshape(nw, h, n, n)
        attn = softmax(attn)
        out = (attn @ v).permute(0, 2, 1, 3).reshape(nw, n, c)
        return linear(self.proj, out, self.dtype)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window_size, qkv_bias,
                                    dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        """x (B, H, W, C), H and W multiples of the window."""
        b, h, w, _ = x.shape
        ws, s, dt = self.window_size, self.shift, self.dtype
        shortcut = x
        x = layer_norm(self.norm1, x, dt)
        mask = None
        if s > 0:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
            mask = torch.from_numpy(shift_attn_mask(h, w, ws, s)).to(x.device)
        x = window_reverse(self.attn(window_partition(x, ws), mask), ws, b,
                           h, w)
        if s > 0:
            x = torch.roll(x, (s, s), dims=(1, 2))
        x = shortcut + x
        y = layer_norm(self.norm2, x, dt)
        y = gelu_tanh(linear(self.mlp_fc1, y, dt))
        return x + linear(self.mlp_fc2, y, dt)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return linear(self.reduction, layer_norm(self.norm, x, self.dtype),
                      self.dtype)


class SwinTransformer(nn.Module):
    """The config's SwinTransformer (embed_dims, patch_size, window_size,
    mlp_ratio, depths, num_heads, out_indices, qkv_bias); the other keys
    of the reference's config are not read, as in the JAX package."""

    def __init__(self, embed_dims: int = 96, patch_size: int = 4,
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 qkv_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.window_size = window_size
        self.depths = tuple(depths)
        self.out_indices = tuple(out_indices)
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, embed_dims, patch_size, patch_size)
        self.patch_norm = nn.LayerNorm(embed_dims, eps=LN_EPS)
        dim = embed_dims
        for i, depth in enumerate(self.depths):
            for d in range(depth):
                self.add_module(f"stage{i}_block{d}", SwinBlock(
                    dim, num_heads[i], window_size,
                    0 if d % 2 == 0 else window_size // 2, mlp_ratio,
                    qkv_bias, dtype))
            if i in self.out_indices:
                self.add_module(f"out_norm{i}", nn.LayerNorm(dim, eps=LN_EPS))
            if i < len(self.depths) - 1:
                self.add_module(f"downsample{i}", PatchMerging(dim, dtype))
                dim *= 2

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        """(B, H, W, 3) -> the ``out_indices`` stages' (B, h, w, C)."""
        p, ws, dt = self.patch_size, self.window_size, self.dtype
        h0, w0 = x.shape[1:3]
        x = F.pad(x.to(dt), (0, 0, 0, -w0 % p, 0, -h0 % p))
        x = conv(self.patch_embed, x.permute(0, 3, 1, 2), dt)
        x = layer_norm(self.patch_norm, x.permute(0, 2, 3, 1), dt)
        outs = []
        for i, depth in enumerate(self.depths):
            h, w = x.shape[1:3]
            xp = F.pad(x, (0, 0, 0, -w % ws, 0, -h % ws))
            for d in range(depth):
                xp = getattr(self, f"stage{i}_block{d}")(xp)
            x = xp[:, :h, :w]
            if i in self.out_indices:
                outs.append(layer_norm(getattr(self, f"out_norm{i}"), x, dt))
            if i < len(self.depths) - 1:
                x = getattr(self, f"downsample{i}")(x)
        return tuple(outs)
