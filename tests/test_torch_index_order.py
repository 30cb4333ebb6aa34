"""The plain versions of K1's and K2's backward index preparation, on the
CPU: ``ops/voxel.pixel_order_plain`` and ``ops/render.window_order_plain``
against a stable numpy argsort of the same keys, for random keys with
dropped pairs and invalid voxels (hypothesis draws the shapes and the
shares). On the card, ``tests/test_torch_kernels_cuda.py`` holds the
counting-sort kernels to these exactly. Also: a kernel library is
rebuilt when a header it includes changes.
"""

import os

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nerfdet_tpu_torch.ops import cuda_build, render, voxel

SHAPES = st.tuples(st.integers(1, 5), st.integers(1, 300),
                   st.integers(1, 40), st.floats(0.0, 1.0),
                   st.integers(0, 2 ** 31 - 1))


@settings(max_examples=30, deadline=None)
@given(SHAPES)
def test_window_order_equals_a_stable_argsort(case):
    """K2's inverse index: each window's kept pairs in ascending pair
    order, the dropped pairs (keyed past every window) last; ``off``
    starts at 0, never falls and ends at the kept count."""
    v, n, hw, drop, seed = case
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, hw, (v, n)) + (np.arange(v) * hw)[:, None]
    keys[rng.rand(v, n) < drop] = v * hw
    order, off = render.window_order(
        torch.from_numpy(keys.astype(np.int32)), v * hw)
    assert order.dtype == off.dtype == torch.int32
    flat = keys.reshape(-1)
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(flat, kind="stable"))
    off = off.numpy()
    assert off.shape == (v * hw + 1,) and off[0] == 0
    assert np.all(np.diff(off) >= 0)
    assert off[-1] == int((flat < v * hw).sum())
    np.testing.assert_array_equal(
        np.diff(off), np.bincount(flat, minlength=v * hw + 1)[:v * hw])


@settings(max_examples=30, deadline=None)
@given(SHAPES)
def test_pixel_order_equals_a_stable_argsort(case):
    """K1's inverse index: per view the voxels by pixel, the invalid ones
    first, ``off`` from 0 to N per view, and the referenced pixels in
    ascending order with their count, -1 after them."""
    v, n, hw, invalid, seed = case
    rng = np.random.RandomState(seed)
    pix = rng.randint(0, hw, (v, n))
    pix[rng.rand(v, n) < invalid] = -1
    order, off, rows, n_rows = voxel.pixel_order(
        torch.from_numpy(pix.astype(np.int32)), hw)
    for t in (order, off, rows, n_rows):
        assert t.dtype == torch.int32
    assert off.shape == (v, hw + 1) and rows.shape == (v, hw)
    for k in range(v):
        np.testing.assert_array_equal(order[k].numpy(),
                                      np.argsort(pix[k], kind="stable"))
        o = off[k].numpy()
        assert np.all(np.diff(o) >= 0) and o[-1] == n
        assert o[0] == int((pix[k] < 0).sum())
        held = np.flatnonzero(np.bincount(pix[k][pix[k] >= 0],
                                          minlength=hw))
        assert int(n_rows[k]) == held.size
        np.testing.assert_array_equal(rows[k, :held.size].numpy(), held)
        assert bool((rows[k, held.size:] == -1).all())


def test_a_library_is_rebuilt_when_its_header_changes(tmp_path,
                                                      monkeypatch):
    """The library's name hashes its source and the headers beside it, so
    an edited ``counting_sort.cuh`` never loads a stale build."""
    for name, text in (("k.cu", '#include "h.cuh"\n'), ("h.cuh", "// a\n")):
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    before = cuda_build.library_path("k")
    assert before == cuda_build.library_path("k")
    (tmp_path / "h.cuh").write_text("// b\n")
    after = cuda_build.library_path("k")
    assert after != before
    assert os.path.dirname(after) == cuda_build.BUILD_DIR
