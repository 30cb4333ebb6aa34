"""K1's phase A on bfloat16 maps runs on the tensor cores, W split exactly
into three bfloat16 pieces, hi = rn(W), mid = rn(W - hi), lo = rn(W - hi -
mid) (``voxel.split_bf16x3_plain``; the kernel's split in
``csrc/fused_mean_cov.cu``). Every bfloat16 x bfloat16 product is exact in
float32, so x@lo + x@mid + x@hi is JAX's float32 product of the widened
rows up to the order of the sum.

Here, on the CPU: the split is exact (in float64) for the seeded init and
for edge values; and the three-piece product of seeded bfloat16 rows,
summed in the kernel's order (per 32-channel chunk the pieces' products,
lo then mid then hi, summed exactly and rounded once to float32, as a
tensor core rounds; the chunks added in float32; then the bias) lies
within 1e-6 relative of ``mapped_rows_plain`` and of JAX's
``contrib.astype(f32) @ w_map + b_map`` (eager jnp, no compiled graph).
Toy shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfdet_tpu_torch.ops import voxel

CHUNK = 32  # the kernel's channels a stage


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _lecun(seed, c, m):
    """The mapped stream's W and b as the model draws W (lecun-normal),
    with a random bias."""
    rng = np.random.RandomState(seed)
    w = (rng.standard_normal((c, m)) / np.sqrt(c)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    return w, b


def _edges():
    """float32 values whose split stresses the rounding: powers of two
    and their neighbours, ties of each rounding, the kernel's test
    extremes (near 1e4 and 1e-6), 0 and signs."""
    one = np.float32(1.0)
    vals = [0.0, -0.0, 1.0, -1.0, 1e4, -1e4, 1e-6, -1e-6, 3e38, 2.0 ** -100]
    for x in (one, np.float32(1e4), np.float32(1e-6), np.float32(0.3)):
        up, down = np.nextafter(x, np.float32(np.inf)), np.nextafter(
            x, np.float32(0))
        vals += [up, down, -up, -down]
    # ties of the first and of the second rounding: 1 + 2^-8, 1 + 2^-16
    # + 2^-24 and their neighbours
    for bits in (0x3F808000, 0x3F818000, 0x3F800080, 0x3F800180,
                 0x3F7FFFFF, 0x3F80FFFF, 0x3F807FFF, 0x3F808001):
        vals.append(np.array([bits], np.uint32).view(np.float32)[0])
    return np.asarray(vals, np.float32)


@pytest.mark.parametrize("which", ["seeded init", "edge values"])
def test_split_is_exact(which):
    w = _lecun(0, 256, 32)[0] if which == "seeded init" else _edges()
    hi, mid, lo = voxel.split_bf16x3_plain(torch.from_numpy(w))
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = (hi.double() + mid.double()) + lo.double()
    assert np.array_equal(total.numpy(), w.astype(np.float64))
    # the pieces fall in magnitude: each at most half an ulp of the last
    h, m, lo = (t.double().abs().numpy() for t in (hi, mid, lo))
    assert np.all(m <= h * 2.0 ** -8) and np.all(lo <= m * 2.0 ** -8)


def _three_piece_rows(x, w, b):
    """x (R, C) float32 holding bfloat16 values times W's three pieces,
    summed as the kernel sums them; (R, M) float32."""
    pieces = [p.double().numpy() for p in voxel.split_bf16x3_plain(
        torch.from_numpy(w))[::-1]]  # lo, mid, hi
    xd = x.astype(np.float64)
    tot = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k in range(0, x.shape[1], CHUNK):
        chunk = sum(xd[:, k:k + CHUNK] @ p[k:k + CHUNK] for p in pieces)
        tot = tot + chunk.astype(np.float32)  # float32 adds
    return tot + b


@pytest.mark.parametrize("c,m", [(256, 32), (64, 7)])
def test_three_piece_product_matches_plain_and_jax(c, m):
    rng = np.random.RandomState(c + m)
    feats = torch.from_numpy(
        rng.standard_normal((2, 6, 10, c)).astype(np.float32)).bfloat16()
    w, b = _lecun(c + m, c, m)
    x = feats.float().reshape(-1, c).numpy()
    got = _three_piece_rows(x, w, b)
    plain = voxel.mapped_rows_plain(feats, torch.from_numpy(w),
                                    torch.from_numpy(b)).reshape(-1, m)
    contrib = jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)
    jax_rows = contrib @ jnp.asarray(w) + jnp.asarray(b)
    assert _rel(got, plain.numpy()) <= 1e-6
    assert _rel(got, np.asarray(jax_rows)) <= 1e-6
    # the product of the float32 W itself, in float64: the pieces lose
    # nothing of W
    exact = x.astype(np.float64) @ w.astype(np.float64) + b
    assert _rel(got, exact) <= 1e-6
