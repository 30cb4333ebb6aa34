"""The Swin backbone of the port (``nerfdet_tpu_torch/nn/swin.py``)
against ``nerfdet_tpu/nn/swin.py`` on the CPU, in float32.

* the window partition and its reverse, the relative position index and
  the shifted windows' -100 mask: equal to the JAX package's;
* every stage's output, at the toy widths of
  ``tests/test_torch_fast_cov.py`` and at Swin-T's (96 channels, depths
  2/2/6/2, window 7), on images whose patch grids are not window
  multiples (so each stage pads, and the pad tokens take part in the
  attention as in JAX): within 1e-4 of each output's max. The weights
  are random from a numpy seed at the shapes ``jax.eval_shape`` gives,
  carried over with ``from_jax_variables``'s Swin mapping;
* the optimizer's labels: no Swin parameter is frozen (JAX's freeze rule
  matches none of their names), every one is ``backbone``;
* a reference checkpoint with the Swin backbone is refused by name;
* bfloat16 (the JAX ``--bf16`` path; JAX compiled without excess
  precision, as ``tests/test_torch_bf16.py`` runs it): the toy Swin, every
  stage, bit for bit; one block at Swin-T's width (96 channels, 3 heads,
  window 7, plain and shifted) within one bfloat16 ulp of the output's
  largest value at under 1% of the elements: its products of 96 to 384
  terms accumulate in float32 in another order than XLA's, which moves
  an output across a rounding boundary now and then (through Swin-T's
  twelve blocks such ulps spread as they do through a ResNet's, see
  ``tests/test_torch_bf16_slice.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfdet_tpu.nn import swin as jswin
from nerfdet_tpu.train import optim as joptim

from nerfdet_tpu_torch.nn import swin as tswin
from nerfdet_tpu_torch.train import optim as toptim
from nerfdet_tpu_torch.utils.weight_convert import (_swin_tree,
                                                    load_reference_state_dict)

from tests.test_torch_bf16 import _compiled
from tests.test_torch_fast_cov import SWIN, port_toy

SWIN_T = dict(embed_dims=96, patch_size=4, window_size=7, mlp_ratio=4.0,
              depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
              out_indices=(0, 1, 2, 3), qkv_bias=True)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _swin_params(cfg, x, seed):
    """Random Swin parameters at the shapes of the JAX init: kernels
    normal(1/sqrt(fan_in)), biases normal(0.1), LayerNorm scales
    uniform(0.5, 1.5), bias tables normal(0.02)."""
    shapes = jax.eval_shape(
        lambda k: jswin.SwinTransformer(**cfg).init(k, x),
        jax.random.PRNGKey(0))["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            v = rng.normal(0, float(np.prod(sd.shape[:-1])) ** -0.5,
                           sd.shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, sd.shape)
        elif name == "bias":
            v = rng.normal(0, 0.1, sd.shape)
        else:
            assert name == "relative_position_bias_table", name
            v = rng.normal(0, 0.02, sd.shape)
        return np.asarray(v, np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_swin(cfg, params, dtype=torch.float32):
    out = {}
    _swin_tree(out, "b", params)
    model = tswin.SwinTransformer(dtype=dtype, **cfg)
    model.load_state_dict({k[2:]: v for k, v in out.items()}, strict=True)
    return model


def test_windows_index_and_mask_match_jax():
    x = np.random.RandomState(0).randn(2, 6, 9, 5).astype(np.float32)
    want = np.asarray(jswin.window_partition(jnp.asarray(x), 3))
    got = tswin.window_partition(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tswin.window_reverse(got, 3, 2, 6, 9)
    np.testing.assert_array_equal(back.numpy(), x)
    for ws in (2, 3, 7):
        np.testing.assert_array_equal(tswin.relative_position_index(ws),
                                      jswin._relative_position_index(ws))
    for h, w, ws, s in ((6, 9, 3, 1), (14, 21, 7, 3), (8, 8, 4, 2)):
        mask = tswin.shift_attn_mask(h, w, ws, s)
        np.testing.assert_array_equal(mask,
                                      jswin._shift_attn_mask(h, w, ws, s))
        assert set(np.unique(mask)) == {-100.0, 0.0}


@pytest.mark.parametrize("cfg,hw", [(SWIN, (30, 41)), (SWIN_T, (36, 52))],
                         ids=["toy", "swin_t"])
def test_swin_stage_outputs_match_jax(cfg, hw):
    x = np.random.RandomState(1).rand(2, *hw, 3).astype(np.float32)
    params = _swin_params(cfg, jnp.asarray(x), 3)
    want = jax.jit(lambda p, a: jswin.SwinTransformer(**cfg).apply(
        {"params": p}, a))(params, jnp.asarray(x))
    with torch.no_grad():
        got = _port_swin(cfg, params)(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    ws, grid = cfg["window_size"], (-(-hw[0] // 4), -(-hw[1] // 4))
    assert grid[0] % ws and grid[1] % ws  # the stages pad
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert float(np.abs(a.numpy() - b).max()) <= 1e-4 * np.abs(b).max()


def test_no_swin_parameter_is_frozen():
    model = port_toy()
    labels = toptim.param_labels(model)
    backbone = {n: v for n, v in labels.items() if n.startswith("backbone.")}
    assert backbone and set(backbone.values()) == {"backbone"}
    x = jnp.zeros((1, 32, 40, 3), jnp.float32)
    params = _swin_params(SWIN, x, 0)
    jlabels = jax.tree_util.tree_leaves(
        joptim.param_labels({"backbone": params}))
    assert set(jlabels) == {"backbone"}
    out = {}
    _swin_tree(out, "backbone", params)
    assert set(out) == set(backbone)


def test_reference_checkpoint_with_swin_is_refused():
    with pytest.raises(NotImplementedError, match="Swin"):
        load_reference_state_dict(port_toy(), {})


def _bf16_ulps(got, want):
    """max |got - want| in bfloat16 ulps of max |want|, and the share of
    elements that differ."""
    top = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    return float(np.abs(got - want).max()) / ulp, float((got != want).mean())


def test_toy_swin_bf16_is_jaxs_bit_for_bit():
    x = np.random.RandomState(1).rand(2, 30, 41, 3).astype(np.float32)
    params = _swin_params(SWIN, jnp.asarray(x), 3)
    want = _compiled(lambda p, a: jswin.SwinTransformer(
        dtype=jnp.bfloat16, **SWIN).apply({"params": p}, a), params,
        jnp.asarray(x))
    with torch.no_grad():
        got = _port_swin(SWIN, params, torch.bfloat16)(torch.from_numpy(x))
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))


@pytest.mark.parametrize("shift", [0, 3], ids=["plain", "shifted"])
def test_swin_t_block_bf16_matches_jax(shift):
    x = np.random.RandomState(0).randn(2, 14, 21, 96).astype(np.float32)
    block = jswin.SwinBlock(dim=96, num_heads=3, window_size=7, shift=shift,
                            mlp_ratio=4.0, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda k: block.init(k, jnp.asarray(x)),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.RandomState(5)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            v = rng.normal(0, float(np.prod(sd.shape[:-1])) ** -0.5,
                           sd.shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, sd.shape)
        else:  # biases, the relative position bias table
            v = rng.normal(0, 0.1 if name == "bias" else 0.02, sd.shape)
        return np.asarray(v, np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(_compiled(lambda p, a: block.apply({"params": p}, a),
                                params, xb).astype(jnp.float32))
    out = {}
    _swin_tree(out, "b", params)
    port = tswin.SwinBlock(96, 3, 7, shift, 4.0, True, torch.bfloat16)
    port.load_state_dict({k[2:]: v for k, v in out.items()}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    ulps, share = _bf16_ulps(got.float().numpy(), want)
    assert ulps <= 1 and share < 0.01, (ulps, share)
