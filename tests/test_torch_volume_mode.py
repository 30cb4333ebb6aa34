"""Volume mode (``nerf_mode='volume'``, ``nerf_density=False``) through the
port, against the JAX package on the CPU.

* ``grid_sample_3d`` (border and zeros padding, coordinates inside and
  beyond the volume) and ``volume_sampling``: samples within 1e-6, the
  ``inbound`` mask exact, gradients in the volume and the coordinates
  against ``jax.grad`` within 1e-5.
* ``render_full`` of the toy NeRF-Det of ``tests/test_torch_fast_cov.py``
  in volume mode (the fusion, ``mean_mapping`` / ``cov_mapping``, the
  volumes sampled at evenly spaced depths, the view mask from the
  projection alone): rgb and depth within 1e-4; at
  ``compute_dtype=bfloat16`` closer to JAX's bfloat16 render than that
  lies to its float32 one, by at least 2x.
* One train step of that toy in volume mode (``cov_w_mean``, depth
  supervision): head outputs 1e-3, loss terms and grad_norm 1e-4
  relative, gradients 1e-3 x their max, parameters 1e-6 where the
  gradient is signal. JAX's volume-mode render draws its depths from its
  own key and takes no ``z_vals``, so its ``sample_along_camera_ray`` is
  replaced, while the reference is traced, by one that returns the
  scene's ``z_vals`` (the JAX package itself is not changed); the port
  takes them from the batch. The gradient reaches the fused mean and cov
  through the trilinear taps, so K1's backward runs with both
  cotangents.
* What is refused: volume mode over a views group (``--mesh-views``),
  and ``load_reference_state_dict`` keeps ``mean_mapping`` /
  ``cov_mapping`` in volume mode.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfdet_tpu.models.nerfdet import NerfDet as JaxNerfDet
from nerfdet_tpu.ops import grid_sample as jgrid
from nerfdet_tpu.ops import render as jrender

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.ops import render as trender
from nerfdet_tpu_torch.ops import voxel as tvox
from nerfdet_tpu_torch.ops.grid_sample import grid_sample_3d
from nerfdet_tpu_torch.tools import train as train_cli
from nerfdet_tpu_torch.config import Config
from nerfdet_tpu_torch.utils.weight_convert import (from_jax_variables,
                                                    load_reference_state_dict)

from tests.test_torch_bf16 import _compiled
from tests.test_torch_fast_cov import (ROOT, TOY, check_gradients,
                                       check_heads, check_metrics,
                                       check_parameters, check_relu_margin,
                                       computed_once, jax_toy, port_toy,
                                       random_variables, step_case,
                                       toy_scene)

VOLUME = dict(nerf_mode="volume", nerf_density=False,
              volume_type="cov_w_mean")
STEP_SEEDS = (3, 0)
CHUNK = 8


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# trilinear sampling
# ---------------------------------------------------------------------

def _grid_case():
    rng = np.random.RandomState(2)
    vol = rng.randn(5, 6, 7, 3).astype(np.float32)
    n = 64
    coords = [rng.uniform(-1.5, s + 0.5, n).astype(np.float32)
              for s in (7, 6, 5)]  # px over W, py over H, pz over D
    coords[0][:4] = [0.0, 6.0, -0.25, 6.25]  # on and across the edges
    g = rng.randn(n, 3).astype(np.float32)
    return vol, coords, g


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_grid_sample_3d_and_its_gradients_match_jax(padding):
    vol, coords, g = _grid_case()

    def jax_loss(v, px, py, pz):
        return jnp.sum(jgrid.grid_sample_3d(v, px, py, pz, padding) * g)

    args = [jnp.asarray(a) for a in [vol] + coords]
    want = np.asarray(jgrid.grid_sample_3d(*args, padding=padding))
    want_g = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*args)
    leaves = [torch.from_numpy(a).requires_grad_() for a in [vol] + coords]
    got = grid_sample_3d(*leaves, padding=padding)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    (got * torch.from_numpy(g)).sum().backward()
    for t, w in zip(leaves, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    assert np.abs(np.asarray(want_g[1])).max() > 0


def test_volume_sampling_and_its_gradients_match_jax():
    rng = np.random.RandomState(4)
    vol = rng.randn(8, 8, 4, 5).astype(np.float32)
    pts = rng.uniform(-4.0, 4.0, (6, 16, 3)).astype(np.float32)
    g = rng.randn(6, 16, 5).astype(np.float32)
    aabb = TOY["aabb"]

    def jax_loss(v, p):
        return jnp.sum(jrender.volume_sampling(p, v, aabb)[0] * g)

    want, inb = jrender.volume_sampling(jnp.asarray(pts), jnp.asarray(vol),
                                        aabb)
    want_g = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(vol),
                                                jnp.asarray(pts))
    v, p = (torch.from_numpy(a).requires_grad_() for a in (vol, pts))
    got, got_inb = trender.volume_sampling(p, v, aabb)
    np.testing.assert_array_equal(got_inb.numpy(), np.asarray(inb))
    assert 0 < int(np.asarray(inb).sum()) < inb.size
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    (got * torch.from_numpy(g)).sum().backward()
    for t, w in zip((v, p), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------------
# render_full
# ---------------------------------------------------------------------

def _jax_render_full():
    scene = toy_scene(5)
    jmodel = jax_toy(**VOLUME)
    variables = random_variables(jmodel, scene, 2)
    batch = {k: jnp.asarray(scene[k]) for k in (
        "imgs", "denorm_images", "intrinsic", "extrinsics", "origin",
        "depth", "ray_o", "ray_d")}
    rgb, depth = jax.jit(lambda v, b: jmodel.apply(
        v, b, CHUNK, method=JaxNerfDet.render_full))(variables, batch)
    low = jax_toy(compute_dtype=jnp.bfloat16, **VOLUME)
    rgb16, depth16 = _compiled(lambda v, b: low.apply(
        v, b, CHUNK, method=JaxNerfDet.render_full), variables, batch)
    return dict(variables=variables, rgb=rgb, depth=depth,
                rgb16=rgb16.astype(jnp.float32), depth16=depth16)


def test_render_full_in_volume_mode_matches_jax(tmp_path_factory):
    """float32 within 1e-4; at ``compute_dtype=bfloat16`` the port's rgb
    (bfloat16) and depth (float32) lie closer to JAX's bfloat16 ones than
    JAX's bfloat16 lie to its float32, by at least 2x
    (``tests/test_torch_bf16_slice.py``'s bar: the field's 256-wide
    products accumulate in another order than XLA's, and each flipped
    ulp spreads through the compositing)."""
    ref = computed_once(tmp_path_factory, "torch_volume_mode_render",
                        _jax_render_full)
    scene = toy_scene(5)
    model = port_toy(**VOLUME)
    model.load_state_dict(from_jax_variables(ref["variables"]), strict=True)
    assert not hasattr(model, "mapping")
    model.eval()
    before = (trender.streaming_sample_mean_var.launches,
              tvox.fusion_carry.launches)
    rgb, depth = model.render_full(api.render_batch(model, scene), CHUNK)
    assert (trender.streaming_sample_mean_var.launches,
            tvox.fusion_carry.launches) == before  # the CPU: plain versions
    np.testing.assert_allclose(rgb.numpy(), ref["rgb"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(depth.numpy(), ref["depth"], rtol=0,
                               atol=1e-4)
    assert np.ptp(ref["rgb"]) > 1e-3  # the volumes shape the colour

    low = port_toy(compute_dtype=torch.bfloat16, **VOLUME)
    low.load_state_dict(from_jax_variables(ref["variables"]), strict=True)
    low.eval()
    rgb, depth = low.render_full(api.render_batch(low, scene), CHUNK)
    assert rgb.dtype == torch.bfloat16 and depth.dtype == torch.float32
    for got, want16, want32 in ((rgb.float(), ref["rgb16"], ref["rgb"]),
                                (depth, ref["depth16"], ref["depth"])):
        assert _distance(want32, want16) >= 2 * _distance(got.numpy(),
                                                          want16)


def _distance(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ---------------------------------------------------------------------
# the volume-mode train step
# ---------------------------------------------------------------------

def test_volume_step_matches_jax(tmp_path_factory):
    """Heads, loss terms, every gradient, the parameters after the update
    and the 3D neck's ReLU margin, in one test (the step's JAX reference
    is computed once; see ``tests/test_torch_fast_cov.py``)."""
    z = toy_scene(STEP_SEEDS[0])["z_vals"]

    def at_scene_depths(ray_o, ray_d, near, far, n_samples, det=False,
                        key=None):
        zj = jnp.asarray(z)
        return zj[..., None] * ray_d[:, None, :] + ray_o[:, None, :], zj

    with mock.patch.object(jrender, "sample_along_camera_ray",
                           at_scene_depths):
        case = step_case(tmp_path_factory, "volume_step", STEP_SEEDS,
                         **VOLUME)
    port, ref = case["port"], case["ref"]
    check_heads(port, ref)
    assert set(port["metrics"]) == set(ref["metrics"])
    assert float(ref["metrics"]["loss_nvs"]) > 0
    assert float(ref["metrics"]["loss_depth"]) > 0
    check_metrics(port["metrics"], ref["metrics"], (
        "loss", "loss_cls", "loss_bbox", "loss_centerness", "loss_nvs",
        "loss_depth", "grad_norm"))
    check_gradients(port["grads"], ref["grads"])
    # the render's gradient reaches the mappings, and through the fused
    # mean and cov (K1's backward, both cotangents) the FPN and backbone
    for name in ("mean_mapping.0.weight", "cov_mapping.0.weight",
                 "neck.lateral_convs.0.conv.weight",
                 "backbone.stage1_block1.mlp_fc1.weight",
                 "nerf_mlp.mlp.base.hidden_layers.0.weight"):
        assert float(port["grads"][name].abs().max()) > 0, name
    check_parameters(case["model"], case["start"], port["state"],
                     ref["params"], ref["grads"])
    check_relu_margin(case["model"], case["start"], port["batch"])


# ---------------------------------------------------------------------
# refusals and checkpoints
# ---------------------------------------------------------------------

def test_volume_mode_over_a_views_group_is_refused():
    model = port_toy(**VOLUME)
    scene = toy_scene(0)
    # volume mode is ROADMAP §1 item 2.2 (the strings once said §2)
    with pytest.raises(NotImplementedError,
                       match="mesh-views.*ROADMAP §1 item 2.2"):
        model.render(torch.from_numpy(scene["ray_o"]),
                     torch.from_numpy(scene["ray_d"]), None, None,
                     scene["intrinsic"], scene["extrinsics"],
                     view_group=object())
    path = (f"{ROOT}/configs/imvoxelnet/imvoxelnet_scannet_fast_cov_w_mean_"
            f"volume_renderrgb_volume_mode.py")
    cfg = Config.fromfile(path)
    cfg.merge_from_options({"model.nerf_density": False})
    with pytest.raises(NotImplementedError,
                       match="mesh-views.*ROADMAP §1 item 2.2"):
        train_cli.refuse_unported(
            train_cli.parse_args([path, "--mesh-views", "2"]), cfg)
    train_cli.refuse_unported(train_cli.parse_args([path]), cfg)


def test_reference_state_dict_keeps_the_volume_mappings():
    """A reference state_dict (every module of the original, ``mapping``
    included) loads into the volume-mode model: ``mean_mapping`` and
    ``cov_mapping`` are read, ``mapping`` is dropped."""
    model = port_toy(**VOLUME, backbone_type="ResNet", backbone_cfg=None,
                     fpn_in_channels=(256, 512, 1024, 2048))
    model.init_weights(torch.Generator().manual_seed(0))
    state = {k: v + 1.0 if v.is_floating_point() else v
             for k, v in model.state_dict().items()}
    state["mapping.0.weight"] = torch.zeros(4, 32)
    state["mapping.0.bias"] = torch.zeros(4)
    load_reference_state_dict(model, state)
    for k in ("mean_mapping.0.weight", "cov_mapping.0.bias"):
        assert torch.equal(model.state_dict()[k], state[k])
    assert "mapping.0.weight" not in model.state_dict()
