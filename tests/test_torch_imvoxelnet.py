"""The indoor ImVoxelNet (``ImVoxelNet`` configs without NeRF keys, and
the lowercase ``imvoxelnet`` type) through the port, against the JAX
package on the CPU.

* The six ScanNet configs build in the port with the fields JAX's
  builder gives them; the outdoor and total-scene SUN RGB-D configs
  raise errors naming their ROADMAP item, the other SUN RGB-D configs
  build and train (``tests/test_torch_sunrgbd.py``,
  ``tests/test_torch_sunrgbd_train.py``); the optimizer labels of
  ``imvoxelnet_scannet.py``'s tree are JAX's ``param_labels`` (the Atlas
  blocks' ``conv1`` / ``bn1`` train).
* The Atlas neck (``nn/imvoxel_necks.py``) against JAX's ``ImVoxelNeck``
  at each scale, in eval and train mode, ``conditional`` off and on, at
  an odd decoder size (the trilinear upsampling of 3 to 6): 1e-5 of
  each scale's max; the upsampling and the nearest downscale alone
  against ``jax.image.resize`` (1e-6, exact).
* The V1 head's assignment (labels and assigned box exact, targets
  1e-6), loss sums (1e-5 relative) and decode (boxes 1e-5, scores 1e-6)
  against ``nn/heads_v1.py`` of JAX on seeded inputs.
* One toy ``IndoorImVoxelNet`` (ResNet-50 at 60x80 views padded to
  64x80, FPN 8, an Atlas neck at 8-32 channels with a 16x16x8 volume,
  the V1 head with one tower conv, five classes), random JAX weights at
  ``jax.eval_shape``'s shapes carried over by ``from_jax_variables``:
  its eval-mode head outputs within 1e-3, and one train step on two
  scenes (clip 35, which acts): loss terms and grad_norm 1e-4 relative,
  n_pos exact, every gradient within 1e-3 x its max (the out blocks'
  conv biases, whose gradient a train-mode BatchNorm cancels, within
  1e-6 x grad_norm of 0 on both sides), the parameters after AdamW 1e-6
  where the gradient is signal, the running statistics 1e-5. JAX's
  step is compiled without XLA's fusion pass, so each operation rounds
  on its own, as the step does op by op (``jax.disable_jit``, as in
  ``tests/test_torch_train.py``): fused, XLA's loops round otherwise and
  the backbone's gradients miss 1e-3 by up to 16x; unfused they lie
  within 1% of the tolerance of the op-by-op step's, at a sixth of its
  time (~18 s against ~110 s of one worker).
* The fast_depth graph on the same toy weights (the fast neck, the V2
  head, the depth-gated volume): head outputs 1e-3, loss sums 1e-4.
* That step over two gloo ranks (``--distributed``'s step, and
  ``--mesh-views 2``'s with the views sharded) against one process
  stepping both scenes, and the CLIs (``tools/train`` then ``tools/test
  --eval mAP``) on the smoke config's files.

The JAX side runs once per test run (``computed_once``).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from nerfdet_tpu.api import scene_meta_from_config as jax_meta
from nerfdet_tpu.config import Config as JaxConfig
from nerfdet_tpu.data.synthetic import make_synthetic_scene
from nerfdet_tpu.models.builder import build_model as jax_build_model
from nerfdet_tpu.models.imvoxelnet_indoor import \
    IndoorImVoxelNet as JaxIndoor
from nerfdet_tpu.models.imvoxelnet_indoor import _Neck3DCfg
from nerfdet_tpu.models.nerfdet import NerfDet as JaxNerfDet
from nerfdet_tpu.models.nerfdet import SceneMeta as JaxSceneMeta
from nerfdet_tpu.nn import heads_v1 as jheads_v1
from nerfdet_tpu.nn import imvoxel_necks as jnecks
from nerfdet_tpu.train import TrainState
from nerfdet_tpu.train import make_train_step as jax_train_step
from nerfdet_tpu.train import optim as joptim
from nerfdet_tpu.train.step import scene_loss_terms as jax_loss_terms

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.config import Config
from nerfdet_tpu_torch.models.builder import build_model, unported_refusal
from nerfdet_tpu_torch.models.imvoxelnet_indoor import IndoorImVoxelNet
from nerfdet_tpu_torch.models.nerfdet import NerfDet, SceneMeta
from nerfdet_tpu_torch.nn import heads as theads
from nerfdet_tpu_torch.nn import heads_v1 as theads_v1
from nerfdet_tpu_torch.nn import imvoxel_necks as tnecks
from nerfdet_tpu_torch.tools import test as test_cli
from nerfdet_tpu_torch.tools import train as train_cli
from nerfdet_tpu_torch.train import optim as toptim
from nerfdet_tpu_torch.train.step import make_train_step, scene_loss_terms
from nerfdet_tpu_torch.utils import weight_convert
from nerfdet_tpu_torch.utils.weight_convert import from_jax_variables

from tests.test_torch_ddp import _spawn
from tests.test_torch_session_cache import computed_once
from tests.test_torch_train import _capture, _port_tree, _rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs", "imvoxelnet")
SCANNET = ("imvoxelnet_scannet.py", "imvoxelnet_scannet_top27.py",
           "imvoxelnet_smoke_synthetic.py", "imvoxelnet_scannet_fast.py",
           "imvoxelnet_scannet_fast_depth.py",
           "imvoxelnet_scannet_swin_t.py")
# what each refuses, and whether building it is refused too; None: the
# SUN RGB-D configs without the layout head, which build and train
REFUSED = {"imvoxelnet_sunrgbd.py": (None, False),
           "imvoxelnet_sunrgbd_fast.py": (None, False),
           "imvoxelnet_total_sunrgbd.py": ("SUN RGB-D", True),
           "imvoxelnet_kitti.py": ("outdoor", True),
           "imvoxelnet_nuscenes.py": ("outdoor", True)}

ORI, IMG, PAD = (240, 320), (60, 80), (64, 80)
N_VOX, VOX = (16, 16, 8), (0.4, 0.4, 0.4)
ATLAS = dict(channels=(8, 16, 32), out_channels=8, down_layers=(1, 1, 1),
             up_layers=(1, 1))
TOY = dict(fpn_out_channels=8, n_classes=5, head_n_channels=8,
           head_n_convs=1, n_voxels=N_VOX, voxel_size=VOX)
OPTIMIZER = dict(type="AdamW", lr=2e-4, weight_decay=1e-4,
                 paramwise_cfg=dict(custom_keys=dict(
                     backbone=dict(lr_mult=0.1, decay_mult=1.0))))
MAX_NORM = 35.0
SCENE_KEYS = ("imgs", "intrinsic", "extrinsics", "origin", "gt_boxes",
              "gt_labels", "gt_mask")
SCENE_SEEDS, WEIGHT_SEED = (1, 2), 0
RANGES = ((-1.0, 0.75), (0.75, 1.5), (1.5, 1e8))


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def random_tree(shapes, seed):
    """Random arrays at a variable tree's shapes: kernels normal(1 /
    sqrt(fan_in)) (the head's 0.05), biases and norm means normal(0.1),
    norm scales and variances uniform(0.5, 1.5) (so no Atlas block is
    the identity), the head's scales uniform(0.8, 1.2)."""
    rng = np.random.RandomState(seed)

    def leaf(path, sd):
        names = [str(getattr(p, "key", p)) for p in path]
        name, shape = names[-1], sd.shape
        if name == "kernel":
            v = rng.normal(0.0, 0.05 if "bbox_head" in names
                           else float(np.prod(shape[:-1])) ** -0.5, shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("bias", "mean"):
            v = rng.normal(0.0, 0.1, shape)
        elif name == "scales":
            v = rng.uniform(0.8, 1.2, shape)
        else:
            raise KeyError("/".join(names))
        return np.asarray(v, np.float32)

    return _plain(jax.tree_util.tree_map_with_path(leaf, shapes))


# ---------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", SCANNET)
def test_scannet_config_builds_with_the_jax_fields(name):
    path = os.path.join(CONFIGS, name)
    cfg = Config.fromfile(path)
    want = jax_build_model(JaxConfig.fromfile(path).model,
                           meta=jax_meta(JaxConfig.fromfile(path)))
    with torch.device("meta"):  # the modules without their weights
        model = build_model(cfg.model, meta=api.scene_meta_from_config(cfg))
    assert unported_refusal(cfg.model) is None
    train_cli.refuse_unported(train_cli.parse_args([path]), cfg)
    if cfg.model["type"] == "imvoxelnet":  # the NeRF-Det graph, no density
        assert isinstance(want, JaxNerfDet) and isinstance(model, NerfDet)
        assert not want.nerf_density and not model.nerf_density
        assert not model.host_streams
        assert type(model.backbone).__name__ == "SwinTransformer"
        return
    assert isinstance(want, JaxIndoor) and isinstance(model,
                                                      IndoorImVoxelNet)
    for field in ("n_voxels", "voxel_size", "n_classes", "n_scales",
                  "head_type", "head_limit", "head_centerness_topk",
                  "regress_ranges", "yaw"):
        w = getattr(want, field)
        assert getattr(model, field) == (
            tuple(tuple(r) for r in w) if field == "regress_ranges"
            else tuple(w) if isinstance(w, (list, tuple)) else w), field
    assert tuple(model.meta.__dict__.values()) == tuple(
        want.meta.__dict__.values())
    if want.neck3d.type == "ImVoxelNeck":
        n = want.neck3d
        enc = model.neck_3d.model
        assert enc.chans == tuple(n.channels)
        assert (enc.layers_down, enc.layers_up) == (n.down_layers,
                                                    n.up_layers)
        assert model.neck_3d.out_conv_0.out_channels == n.out_channels
        assert model.uses_v1_head
    else:
        assert type(model.neck_3d).__name__ == "FastIndoorImVoxelNeck"
        assert not model.uses_v1_head


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_imvoxelnet_configs_are_refused_by_name(name):
    path = os.path.join(CONFIGS, name)
    cfg = Config.fromfile(path)
    what, build_refused = REFUSED[name]
    refuse = lambda: train_cli.refuse_unported(  # noqa: E731
        train_cli.parse_args([path]), cfg)
    if what is None:  # trains now: nothing refuses it
        refuse()
    fns = [refuse] if what else []
    if build_refused:
        fns.append(lambda: build_model(cfg.model))
    else:
        with torch.device("meta"):
            assert isinstance(build_model(cfg.model), IndoorImVoxelNet)
    for fn in fns:
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP §1 item 3.*{what}"
                           if what.startswith("SUN RGB-D")
                           else "ROADMAP §1 item 3"):
            fn()


def test_scene_meta_from_the_pipeline_or_the_model_dict():
    """``init_detector`` passes the test pipeline's SceneMeta (img_shape
    478x640 from 968x1296); without a meta the builder reads the model
    dict's (480x640), as JAX's."""
    path = os.path.join(CONFIGS, "imvoxelnet_scannet.py")
    cfg = Config.fromfile(path)
    jcfg = JaxConfig.fromfile(path)
    with torch.device("meta"):
        piped = build_model(cfg.model, meta=api.scene_meta_from_config(cfg))
        bare = build_model(cfg.model)
    assert piped.meta == SceneMeta((968, 1296), (478, 640), (480, 640))
    assert bare.meta == SceneMeta((968, 1296), (480, 640), (480, 640))
    assert tuple(jax_build_model(jcfg.model).meta.__dict__.values()) == \
        tuple(bare.meta.__dict__.values())
    assert tuple(jax_meta(jcfg).__dict__.values()) == tuple(
        piped.meta.__dict__.values())


def test_optimizer_labels_are_jax_param_labels():
    """Each parameter's label ('frozen' | 'backbone' | 'main') for
    ``imvoxelnet_scannet.py``'s tree is JAX's: carried by value through
    ``from_jax_variables`` (each leaf filled with its label's code). JAX
    freezes ``conv1`` / ``bn1`` only under ``backbone``: the Atlas
    blocks' train."""
    path = os.path.join(CONFIGS, "imvoxelnet_scannet.py")
    jcfg = JaxConfig.fromfile(path)
    jmodel = jax_build_model(jcfg.model, meta=jax_meta(jcfg))
    scene = {"imgs": jnp.zeros((1, 32, 32, 3)),
             "intrinsic": jnp.eye(4), "extrinsics": jnp.eye(4)[None],
             "origin": jnp.zeros(3)}
    shapes = jax.eval_shape(lambda k: jmodel.init(k, scene),
                            jax.random.PRNGKey(0))
    codes = {"frozen": 0.0, "backbone": 1.0, "main": 2.0}
    labels = joptim.param_labels(shapes["params"])
    params = jax.tree_util.tree_map(
        lambda sd, lab: np.full(sd.shape, codes[lab], np.float32),
        shapes["params"], labels)
    stats = jax.tree_util.tree_map(
        lambda sd: np.zeros(sd.shape, np.float32), shapes["batch_stats"])
    want = from_jax_variables({"params": _plain(params),
                               "batch_stats": _plain(stats)})
    cfg = Config.fromfile(path)
    model = build_model(cfg.model, meta=api.scene_meta_from_config(cfg))
    got = toptim.param_labels(model)
    assert set(got) == {k for k in want if not k.endswith((
        "running_mean", "running_var", "num_batches_tracked"))}
    for name, label in got.items():
        assert float(want[name].min()) == float(want[name].max()) \
            == codes[label], name
    assert got["neck_3d.model.down_0_0.conv1.weight"] == "main"
    assert got["neck_3d.model.down_1_0.bn1.weight"] == "main"
    assert got["backbone.layer2.0.conv1.weight"] == "frozen"


# ---------------------------------------------------------------------
# the Atlas neck
# ---------------------------------------------------------------------

def _neck_volume(seed, shape, c):
    rng = np.random.RandomState(seed)
    x = rng.normal(0.0, 1.0, (1,) + shape + (c,)).astype(np.float32)
    x[:, rng.uniform(size=shape) < 0.3] = 0.0  # unobserved voxels
    return x


def _jax_neck(conditional, **kw):
    return jnecks.ImVoxelNeck(**dict(ATLAS, conditional=conditional, **kw))


def _port_neck(conditional, **kw):
    return tnecks.ImVoxelNeck(**dict(ATLAS, conditional=conditional, **kw))


def _neck_state(variables):
    """The Atlas neck's JAX variables as the port neck's state_dict (the
    converter's walk of the ``neck_3d`` tree)."""
    out = {}
    weight_convert._layer_bn_tree(out, "neck_3d", variables["params"],
                                  variables["batch_stats"],
                                  weight_convert._conv)
    return {k[len("neck_3d."):]: v for k, v in out.items()}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("conditional", [False, True])
@pytest.mark.parametrize("shape", [(8, 8, 4), (12, 4, 12)],
                         ids=["8x8x4", "odd decoder 3x1x3"])
def test_atlas_neck_matches_jax(shape, conditional, train):
    """Every scale within 1e-5 of its max, the running statistics of a
    train-mode call 1e-5; (12, 4, 12) upsamples 3 x 1 x 3 to 6 x 2 x 6."""
    x = _neck_volume(len(shape) + sum(shape), shape, 8)
    jneck = _jax_neck(conditional)
    shapes = jax.eval_shape(lambda k: jneck.init(k, jnp.asarray(x)),
                            jax.random.PRNGKey(0))
    variables = {"params": random_tree(shapes["params"], 3),
                 "batch_stats": random_tree(shapes["batch_stats"], 4)}
    want, new = jneck.apply(variables, jnp.asarray(x), train=train,
                            mutable=["batch_stats"])
    neck = _port_neck(conditional)
    neck.load_state_dict(_neck_state(variables), strict=True)
    neck.train(train)
    with torch.no_grad():
        got = neck(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.permute(0, 2, 3, 4, 1).numpy()
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= 1e-5 * max(
            float(np.abs(w).max()), 1.0)
    if train:
        stats = _neck_state({"params": variables["params"],
                             "batch_stats": _plain(new["batch_stats"])})
        for k, v in neck.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert float((v - stats[k]).abs().max()) <= 1e-5, k


def test_atlas_blocks_start_as_the_identity():
    """``init_weights`` zeroes each block's ``bn2`` scale, as flax's
    ``scale_init``: a block maps a non-negative input to itself."""
    model = IndoorImVoxelNet(neck3d=dict(ATLAS), meta=SceneMeta(ORI, IMG,
                                                                PAD), **TOY)
    model.init_weights(torch.Generator().manual_seed(0))
    block = model.neck_3d.model.down_1_0
    assert float(block.bn2.weight.abs().max()) == 0.0
    assert float(block.bn1.weight.min()) == 1.0
    x = torch.rand((1, 16, 4, 4, 2))
    with torch.no_grad():
        assert torch.equal(block.eval()(x), x)


@pytest.mark.parametrize("size", [(3, 5, 1), (4, 2, 7)])
def test_upsample_and_nearest_downscale_are_jax_resize(size):
    """``upsample2x`` within 1e-6 of ``jax.image.resize(..., 2x,
    "trilinear")`` (edges included, odd sizes); ``nearest_resize`` of a
    mask 2x and 4x down equal to ``jax.image.resize(..., "nearest")``."""
    rng = np.random.RandomState(sum(size))
    x = rng.normal(size=(1, 3) + size).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x).transpose(0, 2, 3, 4, 1),
                            (1,) + tuple(2 * s for s in size) + (3,),
                            method="trilinear")
    got = tnecks.upsample2x(torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(want), rtol=0, atol=1e-6)
    mask = rng.uniform(size=(1, 1) + tuple(4 * s for s in size)) < 0.5
    for k in (2, 4):
        out = tuple(4 * s // k for s in size)
        want = jax.image.resize(jnp.asarray(mask[0, 0], jnp.float32), out,
                                method="nearest") != 0
        got = tnecks.nearest_resize(torch.from_numpy(mask), out)
        np.testing.assert_array_equal(got[0, 0].numpy(), np.asarray(want))


BF16 = jnp.bfloat16


@pytest.mark.parametrize("size", [(5, 6, 3), (3, 5, 7), (6, 2, 6),
                                  (10, 10, 4)])
def test_upsample2x_bf16_is_jax_resize_bit_for_bit(size):
    """On a bfloat16 volume ``upsample2x`` rounds as ``jax.image.resize``
    does (an axis at a time, the longest first, ties in axis order)."""
    x = jnp.asarray(np.random.RandomState(sum(size)).normal(
        size=(1,) + size + (8,)), BF16)
    want = jax.image.resize(x, (1,) + tuple(2 * s for s in size) + (8,),
                            method="trilinear")
    got = tnecks.upsample2x(torch.from_numpy(np.asarray(
        x.astype(jnp.float32))).bfloat16().permute(0, 4, 1, 2, 3),
        torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().permute(0, 2, 3, 4, 1).numpy(),
        np.asarray(want.astype(jnp.float32)))


class _JaxNeckHead(fnn.Module):
    """The toy's Atlas neck and V1 head, as the model chains them."""

    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x, train=False):
        scales = jnecks.ImVoxelNeck(**ATLAS, dtype=self.dtype,
                                    name="neck_3d")(x, train)
        return scales, jheads_v1.ImVoxelHeadV1(
            n_classes=5, n_channels=8, n_convs=1, n_reg_outs=6,
            regress_ranges=RANGES, yaw=False, dtype=self.dtype,
            name="bbox_head")(scales, train)


def _bf16_rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("train", [False, True])
def test_atlas_neck_and_v1_head_bf16_match_jax(train):
    """At ``compute_dtype=bfloat16`` the Atlas neck's scales and the V1
    head's outputs (each one quantity over the scales) against JAX's
    bfloat16 result (compiled, excess precision off) and its float32 one,
    in relative L2 norms. In eval mode the port lies at least 2x closer to
    JAX's bfloat16 than that lies to float32 (the bar of
    ``tests/test_torch_bf16_slice.py``; on this CPU it is bit for bit). In
    train mode each BatchNorm's float32 statistics sum in another order
    than XLA's, which moves an output across a bfloat16 rounding now and
    then (``test_atlas_block_bf16_matches_jax``: one ulp, under 1%); on
    this toy, where bfloat16 moves JAX's result little, those ulps spread
    through the 14 BatchNorms to ratios of 1.27-1.34. A control, the same
    modules computing in float32 with their outputs cast to bfloat16,
    reads 0.99-1.00 in train mode (0.91-1.32 in eval mode), so the bar
    there is 1.15: it holds the port and refuses the control, which the
    test runs as well."""
    x = _neck_volume(11, N_VOX, 8)
    mod16, mod32 = _JaxNeckHead(dtype=BF16), _JaxNeckHead()
    shapes = jax.eval_shape(lambda k: mod32.init(k, jnp.asarray(x)),
                            jax.random.PRNGKey(0))
    variables = {"params": random_tree(shapes["params"], 5),
                 "batch_stats": random_tree(shapes["batch_stats"], 6)}

    def run(mod, compiled):
        fn = lambda v, a: mod.apply(v, a, train=train,  # noqa: E731
                                    mutable=["batch_stats"])[0]
        lowered = jax.jit(fn).lower(variables, jnp.asarray(x))
        opts = ({"xla_allow_excess_precision": False} if compiled
                else None)
        return lowered.compile(compiler_options=opts)(variables,
                                                      jnp.asarray(x))

    j16, j32 = run(mod16, True), run(mod32, False)
    state = {}
    params, stats = variables["params"], variables["batch_stats"]
    weight_convert._layer_bn_tree(state, "neck_3d", params["neck_3d"],
                                  stats["neck_3d"], weight_convert._conv)
    weight_convert._layer_bn_tree(
        state, "bbox_head", {k: v for k, v in params["bbox_head"].items()
                             if k != "scales"}, stats["bbox_head"],
        weight_convert._conv)
    for i, v in enumerate(params["bbox_head"]["scales"]):
        state[f"bbox_head.scales.{i}.scale"] = torch.tensor(float(v))

    def flat(ts):
        return np.concatenate([np.asarray(t, np.float32).ravel()
                               for t in ts])

    def port(dtype):
        """The port's outputs at ``dtype``, rounded to bfloat16."""
        neck = _port_neck(False, dtype=dtype)
        head = theads_v1.ImVoxelHeadV1(8, 5, 8, 1, 6, RANGES, dtype=dtype)
        neck.load_state_dict({k[8:]: v for k, v in state.items()
                              if k.startswith("neck_3d.")})
        head.load_state_dict({k[10:]: v for k, v in state.items()
                              if k.startswith("bbox_head.")})
        neck.train(train)
        head.train(train)
        with torch.no_grad():
            scales = neck(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
            outs = head(scales)
        assert all(t.dtype == dtype for t in scales)
        got = {"neck": flat([t.bfloat16().float().permute(0, 2, 3, 4, 1)
                             for t in scales])}
        for k, name in enumerate(("centerness", "bbox", "cls")):
            got[name] = flat([o[k].bfloat16().float().permute(0, 2, 3, 4, 1)
                              for o in outs])
        return got

    want = {"neck": [flat([jnp.asarray(t, jnp.float32) for t in j[0]])
                     for j in (j16, j32)]}
    for k, name in enumerate(("centerness", "bbox", "cls")):
        want[name] = [flat([jnp.asarray(o[k], jnp.float32) for o in j[1]])
                      for j in (j16, j32)]
    bar = 1.15 if train else 2.0
    control = port(torch.float32)
    for name, g in port(torch.bfloat16).items():
        w16, w32 = want[name]
        d_port, d_ref = _bf16_rel(g, w16), _bf16_rel(w16, w32)
        d_ctrl = _bf16_rel(control[name], w16)
        print(f"[bf16] {name}: port-jax16 {d_port:.3g}, jax16-jax32 "
              f"{d_ref:.3g}, ratio {d_ref / max(d_port, 1e-30):.2f} "
              f"(float32 control {d_ref / max(d_ctrl, 1e-30):.2f})")
        assert d_ref >= bar * d_port, name
        assert d_ref < bar * d_ctrl, name


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("input_dtype", ["float32", "bfloat16"])
def test_atlas_block_bf16_matches_jax(input_dtype, train):
    """One Atlas block at bfloat16 (two convs, two flax BatchNorms, the
    residual; a float32 input, the fused volume, keeps the block's output
    float32, as in JAX): within one bfloat16 ulp of the largest output at
    under 1% of the elements, as ``tests/test_torch_bf16.py`` holds
    single layers."""
    dt = jnp.float32 if input_dtype == "float32" else BF16
    x = jnp.asarray(_neck_volume(13, (8, 8, 4), 8)).astype(dt)
    mod = jnecks.AtlasBlock3d(channels=8, dtype=BF16)
    shapes = jax.eval_shape(lambda k: mod.init(k, x), jax.random.PRNGKey(0))
    variables = {"params": random_tree(shapes["params"], 7),
                 "batch_stats": random_tree(shapes["batch_stats"], 8)}
    fn = lambda v, a: mod.apply(v, a, train=train,  # noqa: E731
                                mutable=["batch_stats"])[0]
    want = jax.jit(fn).lower(variables, x).compile(compiler_options={
        "xla_allow_excess_precision": False})(variables, x)
    state = {}
    weight_convert._layer_bn_tree(state, "b", variables["params"],
                                  variables["batch_stats"],
                                  weight_convert._conv)
    block = tnecks.AtlasBlock3d(8, torch.bfloat16)
    block.load_state_dict({k[2:]: v for k, v in state.items()})
    block.train(train)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).permute(
        0, 4, 1, 2, 3)
    with torch.no_grad():
        got = block(xt if dt == jnp.float32 else xt.bfloat16())
    assert got.dtype == (torch.float32 if dt == jnp.float32
                         else torch.bfloat16)
    got = got.float().permute(0, 2, 3, 4, 1).numpy()
    want = np.asarray(want.astype(jnp.float32))
    top = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert float(np.abs(got - want).max()) <= ulp
    assert float((got != want).mean()) < 0.01


# ---------------------------------------------------------------------
# the V1 head: targets, losses, decode
# ---------------------------------------------------------------------

def _mlvl_points(origin=(0.0, 0.0, 0.5)):
    from nerfdet_tpu_torch.ops.voxel import get_points
    return [get_points(tuple(v // 2 ** i for v in N_VOX),
                       tuple(s * 2 ** i for s in VOX), origin).reshape(-1, 3)
            for i in range(2)]


def _gt(seed, n=4, max_gt=6):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((max_gt, 7), np.float32)
    boxes[:n, :2] = rng.uniform(-2.0, 2.0, (n, 2))
    boxes[:n, 2] = rng.uniform(0.0, 0.5, n)
    boxes[:n, 3:6] = rng.uniform(0.4, 2.4, (n, 3))
    boxes[1, 3:6] = boxes[0, 3:6]  # two boxes of one volume: the first
    labels = rng.randint(0, 5, max_gt).astype(np.int64)
    mask = np.arange(max_gt) < n
    return boxes, labels, mask


@pytest.mark.parametrize("topk", [0, 3, 18, 10000])
@pytest.mark.parametrize("seed", [0, 1])
def test_v1_targets_match_jax(seed, topk):
    pts = _mlvl_points()
    points = torch.cat(pts)
    ids = torch.cat([torch.full((p.shape[0],), i, dtype=torch.int32)
                     for i, p in enumerate(pts)])
    boxes, labels, mask = _gt(seed)
    want = jheads_v1.get_targets_v1(
        jnp.asarray(points.numpy()), jnp.asarray(ids.numpy()), RANGES,
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask), 5,
        topk, yaw=False)
    got = theads_v1.get_targets_v1(
        points, ids, RANGES, torch.from_numpy(boxes),
        torch.from_numpy(labels), torch.from_numpy(mask), 5, topk)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    fg = got[2].numpy() < 5
    assert 0 < int(fg.sum()) < len(fg)
    np.testing.assert_allclose(got[0].numpy()[fg], np.asarray(want[0])[fg],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=1e-6)


def _head_outs(seed, n_classes=5):
    rng = np.random.RandomState(seed)
    outs = []
    for i in range(2):
        shape = tuple(v // 2 ** i for v in N_VOX)
        outs.append((rng.normal(0, 1, shape + (1,)),
                     np.exp(rng.normal(-0.5, 0.5, shape + (6,))),
                     rng.normal(-2, 1, shape + (n_classes,))))
    valid = rng.randint(0, 3, N_VOX).astype(np.float32)
    return [tuple(np.asarray(t, np.float32) for t in o) for o in outs], valid


@pytest.mark.parametrize("seed", [0, 1])
def test_v1_loss_sums_match_jax(seed):
    outs, valid = _head_outs(seed)
    boxes, labels, mask = _gt(seed + 2)
    pts = _mlvl_points()
    want = jheads_v1.head_loss_sums_v1(
        [tuple(jnp.asarray(t) for t in o) for o in outs], jnp.asarray(valid),
        [jnp.asarray(p.numpy()) for p in pts], RANGES, jnp.asarray(boxes),
        jnp.asarray(labels), jnp.asarray(mask), 5, 18, False)
    got = theads_v1.head_loss_sums_v1(
        [tuple(torch.from_numpy(t) for t in o) for o in outs],
        torch.from_numpy(valid), pts, RANGES, torch.from_numpy(boxes),
        torch.from_numpy(labels), torch.from_numpy(mask), 5, 18)
    assert float(got["n_pos"]) == float(want["n_pos"]) > 0
    for k in ("cls_sum", "centerness_sum", "bbox_sum", "bbox_avg"):
        assert _rel(got[k], want[k]) <= 1e-5, k


@pytest.mark.parametrize("nms_pre", [0, 50])
def test_v1_candidates_match_jax(nms_pre):
    outs, valid = _head_outs(7)
    pts = _mlvl_points()
    want = jheads_v1.get_candidate_bboxes_v1(
        [tuple(jnp.asarray(t) for t in o) for o in outs], jnp.asarray(valid),
        [jnp.asarray(p.numpy()) for p in pts], nms_pre, 5, False)
    got = theads.get_candidate_bboxes(
        [tuple(torch.from_numpy(t) for t in o) for o in outs],
        torch.from_numpy(valid), pts, nms_pre, 5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-6)
    # the yawed (SUN RGB-D) head builds, its decode is yawed
    # (tests/test_torch_sunrgbd.py), its training targets are held to
    # JAX's in tests/test_torch_sunrgbd_train.py
    assert theads_v1.ImVoxelHeadV1(8, 5, 8, 1, 7, RANGES, yaw=True).yaw


# ---------------------------------------------------------------------
# the toy model: forward and one train step against JAX
# ---------------------------------------------------------------------

def jax_toy() -> JaxIndoor:
    return JaxIndoor(backbone_depth=50, neck3d=_Neck3DCfg(**ATLAS),
                     meta=JaxSceneMeta(ORI, IMG, PAD), **TOY)


def port_toy() -> IndoorImVoxelNet:
    return IndoorImVoxelNet(neck3d=dict(ATLAS), meta=SceneMeta(ORI, IMG,
                                                               PAD), **TOY)


def toy_scene(seed, n_views=3):
    """A synthetic scene without rays, its intrinsic at ``ori_shape``."""
    s = make_synthetic_scene(seed=seed, n_views=n_views, n_targets=1,
                             hw=IMG, pad_hw=PAD, n_rand=8, n_boxes=3,
                             max_gt=4, margin=2)
    s = {k: s[k] for k in SCENE_KEYS}
    s["intrinsic"] = s["intrinsic"].copy()
    s["intrinsic"][:2] *= np.float32(ORI[0] / IMG[0])
    return s


def toy_variables(tmp_path_factory):
    """The toy's random JAX variables at ``jax.eval_shape``'s shapes, once
    per test run."""
    def compute():
        first = {k: jnp.asarray(v) for k, v in toy_scene(SCENE_SEEDS[0])
                 .items()}
        shapes = jax.eval_shape(lambda k: jax_toy().init(k, first),
                                jax.random.PRNGKey(0))
        return {"params": random_tree(shapes["params"], WEIGHT_SEED),
                "batch_stats": random_tree(shapes["batch_stats"],
                                           WEIGHT_SEED + 1)}
    return computed_once(tmp_path_factory, "torch_imvoxelnet_variables",
                         compute)


UNFUSED = {"xla_disable_hlo_passes": "fusion"}


def _jax_reference(variables):
    """JAX's eval-mode head outputs of scene 0 and one train step on both
    scenes, compiled; the step without XLA's fusion pass (``UNFUSED``)."""
    jmodel = jax_toy()
    scenes = [toy_scene(s) for s in SCENE_SEEDS]
    first = {k: jnp.asarray(v) for k, v in scenes[0].items()}
    heads, _, _ = jax.jit(lambda v, b: jmodel.apply(v, b))(variables, first)
    params = variables["params"]
    tx = optax.chain(_capture(), joptim.build_optimizer(
        params, OPTIMIZER, grad_clip=dict(max_norm=MAX_NORM)))
    state = TrainState.create(params, variables["batch_stats"], tx)
    step = jax_train_step(jmodel, tx, rgb_supervision=False, donate=False)
    batch = {k: np.stack([s[k] for s in scenes]) for k in SCENE_KEYS}
    key = jax.random.PRNGKey(0)
    new, metrics = step.lower(state, batch, key).compile(
        compiler_options=UNFUSED)(state, batch, key)
    raw = new.opt_state[0]
    clip = optax.clip_by_global_norm(MAX_NORM)
    clipped, _ = jax.jit(clip.update)(raw, clip.init(raw))
    zero = jax.tree_util.tree_map(np.zeros_like, variables["batch_stats"])
    return dict(heads=[[np.asarray(t) for t in s] for s in heads],
                metrics={k: np.asarray(v) for k, v in metrics.items()},
                grads=_port_tree(clipped, zero),
                params=_port_tree(new.params, new.batch_stats))


def _one_process_step(start, scenes):
    """The port's train step (clip 35) on ``scenes`` from the state_dict
    ``start``: its metrics, gradients and state after it, and the
    model."""
    model = port_toy()
    model.load_state_dict(start, strict=True)
    opt = toptim.build_optimizer(model, OPTIMIZER,
                                 grad_clip=dict(max_norm=MAX_NORM))
    metrics = make_train_step(model, opt)(api.train_batch(model, scenes))
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for n, p in model.named_parameters()}
    return metrics, grads, copy.deepcopy(model.state_dict()), model


def test_toy_forward_and_train_step_match_jax(tmp_path_factory):
    """The toy's eval-mode head outputs, and one train step: loss terms,
    gradients, parameters (one test, so that one worker computes the
    JAX reference and no second worker waits on it)."""
    variables = toy_variables(tmp_path_factory)
    ref = computed_once(tmp_path_factory, "torch_imvoxelnet_toy",
                        lambda: _jax_reference(variables))
    scenes = [toy_scene(s) for s in SCENE_SEEDS]
    start = from_jax_variables(variables)
    model = port_toy()
    model.load_state_dict(start, strict=True)
    model.eval()
    with torch.no_grad():
        heads, valid, third = model(api.device_batch(model, scenes[0]))
    metrics, grads, state, model = _one_process_step(start, scenes)
    toy = dict(ref=ref, start=start, heads=heads, third=third, valid=valid,
               metrics=metrics, grads=grads, state=state, model=model)
    for check in (_check_heads, _check_loss_terms, _check_gradients,
                  _check_parameters):
        check(toy)


def _under_train_bn(name):
    """The out blocks' conv biases: a train-mode BatchNorm follows them,
    so their gradient is 0 but for rounding, in both packages."""
    return name.startswith("neck_3d.out_conv_") and name.endswith(".bias")


def _check_heads(toy):
    assert toy["third"] is None
    assert len(toy["heads"]) == len(toy["ref"]["heads"]) == 2
    for got, want in zip(toy["heads"], toy["ref"]["heads"]):
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert float(np.abs(a.numpy() - b).max()) <= 1e-3
    assert float(toy["valid"].max()) >= 2


def _check_loss_terms(toy):
    got, want = toy["metrics"], toy["ref"]["metrics"]
    assert set(got) == set(want)
    assert float(got["n_pos"]) == float(want["n_pos"]) > 0
    assert float(want["grad_norm"]) > MAX_NORM  # the clip acts
    for k in ("loss", "loss_cls", "loss_bbox", "loss_centerness",
              "grad_norm"):
        assert _rel(got[k], want[k]) <= 1e-4, (k, got[k], want[k])


REACHED = ("neck.lateral_convs.0.conv.weight",
           "backbone.layer3.2.conv2.weight",
           "neck_3d.model.down_0_0.conv1.weight",
           "neck_3d.model.proj_0.conv.weight",
           "bbox_head.reg_convs.conv_0.weight", "bbox_head.scales.0.scale")


def _check_gradients(toy, reached=REACHED):
    grads, want = toy["grads"], toy["ref"]["grads"]
    assert set(grads) == {k for k in want if not k.endswith((
        "running_mean", "running_var", "num_batches_tracked"))}
    norm = float(toy["ref"]["metrics"]["grad_norm"])
    for name, g in grads.items():
        if _under_train_bn(name):
            assert max(float(g.abs().max()),
                       float(want[name].abs().max())) <= 1e-6 * norm, name
            continue
        tol = 1e-3 * float(want[name].abs().max())
        assert float((g - want[name]).abs().max()) <= tol, name
    # the gradient crosses K1's backward into the FPN and the backbone,
    # and reaches the Atlas blocks and the V1 head's towers
    for name in reached:
        assert float(grads[name].abs().max()) > 0, name


def _check_parameters(toy):
    """Parameters 1e-6 where the JAX gradient is at least 1e-3 of its
    tensor's max (else 2 lr mult + 1e-6: Adam's first step is lr g / (|g|
    + eps), whose sign is noise where g is: so for the out blocks' conv
    biases, whose gradient is rounding), frozen ones bitwise unchanged,
    running statistics 1e-5."""
    state, want, start = toy["state"], toy["ref"]["params"], toy["start"]
    labels = toptim.param_labels(toy["model"])
    for name, label in labels.items():
        g = toy["grads"][name].abs()
        err = (state[name] - want[name]).abs()
        if label == "frozen":
            assert torch.equal(state[name], start[name]), name
            continue
        mult = 0.1 if label == "backbone" else 1.0
        if float(g.max()) > 0 and not _under_train_bn(name):
            signal = g >= 1e-3 * float(g.max())
            assert float(err[signal].max()) <= 1e-6, name
        assert float(err.max()) <= 2 * 2e-4 * mult + 1e-6, name
    for name, v in state.items():
        if name.endswith(("running_mean", "running_var")):
            assert float((v - want[name]).abs().max()) <= 1e-5, name


# ---------------------------------------------------------------------
# the fast_depth form: the fast neck, the V2 head, the depth gate
# ---------------------------------------------------------------------

FAST = dict(type="FastIndoorImVoxelNeck", out_channels=8, n_blocks=(1, 1, 1))
V2 = "ScanNetImVoxelHeadV2"


def _fast_depth_reference(toy_vars, scene):
    """JAX's fast_depth toy on one scene with depth maps, compiled: its
    eval-mode head outputs and valid, and its train-mode V2 loss sums.
    The backbone and FPN weights are the toy's, the fast neck's and the
    V2 head's random at ``jax.eval_shape``'s shapes."""
    jmodel = JaxIndoor(backbone_depth=50, neck3d=_Neck3DCfg(**FAST),
                       head_type=V2, meta=JaxSceneMeta(ORI, IMG, PAD), **TOY)
    batch = {k: jnp.asarray(v) for k, v in scene.items()}
    shapes = jax.eval_shape(lambda k: jmodel.init(k, batch),
                            jax.random.PRNGKey(0))
    variables = {"params": random_tree(shapes["params"], WEIGHT_SEED + 2),
                 "batch_stats": random_tree(shapes["batch_stats"],
                                            WEIGHT_SEED + 3)}
    for part in ("backbone", "neck"):
        variables["params"][part] = toy_vars["params"][part]

    def run(v, b):
        heads, valid, _ = jmodel.apply(v, b)
        terms, _ = jax_loss_terms(jmodel, v["params"], v["batch_stats"], b,
                                  jax.random.PRNGKey(0), False, False,
                                  rgb_supervision=False)
        return heads, valid, terms

    heads, valid, terms = jax.jit(run)(variables, batch)
    return dict(variables=variables, valid=np.asarray(valid),
                heads=[[np.asarray(t) for t in s] for s in heads],
                terms={k: np.asarray(v) for k, v in terms.items()})


def test_toy_fast_depth_matches_jax(tmp_path_factory):
    """``imvoxelnet_scannet_fast_depth.py``'s graph on the toy (the fast
    neck at 8 channels, the V2 head through this model's n_scales and
    head_limit, the volume depth-gated): the valid volume exact (the gate
    keeps fewer voxels than no depth does), the eval-mode head outputs
    within 1e-3 and the train-mode V2 loss sums 1e-4 relative, against
    JAX compiled."""
    s = make_synthetic_scene(seed=SCENE_SEEDS[0], n_views=3, n_targets=1,
                             hw=IMG, pad_hw=PAD, n_rand=8, n_boxes=3,
                             max_gt=4, margin=2, with_depth=True)
    scene = {k: s[k] for k in SCENE_KEYS + ("depth",)}
    scene["intrinsic"] = scene["intrinsic"].copy()
    scene["intrinsic"][:2] *= np.float32(ORI[0] / IMG[0])
    toy_vars = toy_variables(tmp_path_factory)
    ref = computed_once(tmp_path_factory, "torch_imvoxelnet_fast_depth",
                        lambda: _fast_depth_reference(toy_vars, scene))
    model = IndoorImVoxelNet(neck3d=dict(FAST), head_type=V2,
                             meta=SceneMeta(ORI, IMG, PAD), **TOY)
    assert not model.uses_v1_head and model.n_scales == 3
    model.load_state_dict(from_jax_variables(ref["variables"]), strict=True)
    model.eval()
    with torch.no_grad():
        heads, valid, third = model(api.device_batch(model, scene))
        ungated = model(api.device_batch(model, {
            k: v for k, v in scene.items() if k != "depth"}))[1]
    assert third is None
    np.testing.assert_array_equal(valid.numpy(), ref["valid"])
    kept = float((valid > 0).sum()) / float((ungated > 0).sum())
    print(f"[fast_depth] kept {kept:.3f}")
    assert 0 < kept < 1, kept
    assert len(heads) == len(ref["heads"]) == 3
    for got, want in zip(heads, ref["heads"]):
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert float(np.abs(a.numpy() - b).max()) <= 1e-3
    model.train()
    with torch.no_grad():
        terms = scene_loss_terms(model, api.train_batch(model, [scene])[0],
                                 rgb_supervision=False)
    want = ref["terms"]
    assert set(terms) == set(want)
    assert float(terms["n_pos"]) == float(want["n_pos"]) > 0
    for k in want:
        assert _rel(terms[k], want[k]) <= 1e-4, (k, terms[k], want[k])


# ---------------------------------------------------------------------
# data parallel, and the CLIs
# ---------------------------------------------------------------------

def _ddp_rank(rank, world, port, case, out, mesh_views):
    from nerfdet_tpu_torch.parallel import dist as pdist

    torch.set_num_threads(2)
    saved = torch.load(case, weights_only=False)
    model = port_toy()
    model.load_state_dict(saved["start"])
    with pdist.process_group("cpu", f"localhost:{port}", world, rank) as (
            _, group):
        views = data = None
        scenes = saved["scenes"][rank::world]
        if mesh_views > 1:  # one views group holding both scenes
            views, data = pdist.mesh_groups(mesh_views, group)
            scenes = saved["scenes"]
        opt = toptim.build_optimizer(model, OPTIMIZER,
                                     grad_clip=dict(max_norm=MAX_NORM))
        metrics = make_train_step(model, opt, process_group=group,
                                  view_group=views, data_group=data)(
            api.train_batch(model, scenes, view_group=views))
    torch.save(dict(metrics=metrics, state=model.state_dict()),
               os.path.join(out, f"rank{rank}.pt"))


@pytest.mark.parametrize("mesh_views", [1, 2],
                         ids=["distributed", "mesh-views 2"])
def test_toy_step_over_two_gloo_ranks_is_the_global_step(
        tmp_path_factory, tmp_path, mesh_views):
    """``--distributed``'s step at world 2 (gloo; a scene a rank, or with
    ``--mesh-views 2`` both scenes on one views group, each rank holding
    half of every scene's 4 views) against one process stepping both
    scenes: loss terms 1e-5 relative (1e-4 view-sharded: the views' sums
    add in another order), every parameter and running statistic within
    1e-6 of its tensor's max; view-sharded, the running statistics 1e-4
    of their max and the parameters by ``tests/test_torch_mesh2d.py``'s
    rule (Adam's first step is lr sign(g) where g is rounding: at most
    max(3, 1e-3 of a tensor) elements beyond 2e-4 relative + 2e-6, none
    beyond 2.2 lr; of the out blocks' conv biases, whose gradient is
    rounding, only the latter); the ranks bitwise equal."""
    start = from_jax_variables(toy_variables(tmp_path_factory))
    scenes = [toy_scene(s, n_views=3 if mesh_views == 1 else 4)
              for s in SCENE_SEEDS]
    metrics, _, state, _ = _one_process_step(start, scenes)
    case = str(tmp_path / "case.pt")
    torch.save(dict(start=start, scenes=scenes), case)
    _spawn(_ddp_rank, 2, case, str(tmp_path), mesh_views)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    tol = 1e-5 if mesh_views == 1 else 1e-4
    for k in ("loss", "loss_cls", "loss_bbox", "loss_centerness", "n_pos"):
        assert _rel(ranks[0]["metrics"][k], metrics[k]) <= tol, k
    assert float(metrics["n_pos"]) > 0
    for name, v in state.items():
        if not v.is_floating_point():
            continue
        got = ranks[0]["state"][name]
        assert torch.equal(got, ranks[1]["state"][name]), name
        diff = (got - v).abs()
        if mesh_views == 1 or name.endswith(("running_mean", "running_var")):
            tol = (1e-6 if mesh_views == 1 else 1e-4) * max(
                float(v.abs().max()), 1.0)
            assert float(diff.max()) <= tol, name
        else:
            n_bad = int((diff > 2e-4 * v.abs() + 2e-6).sum())
            if not _under_train_bn(name):
                assert n_bad <= max(3, 1e-3 * diff.numel()), name
            assert float(diff.max()) <= 2.2 * OPTIMIZER["lr"], name


def test_smoke_config_trains_and_tests_through_the_clis(tmp_path):
    """``tools/train`` for 2 steps (a checkpoint, a validation) and
    ``tools/test --eval mAP`` from it, on the smoke config's files; the
    train set's scenes have no rays; ``--eval nvs`` is refused by name."""
    from nerfdet_tpu_torch.data.synthetic import write_synthetic_scannet

    root = write_synthetic_scannet(str(tmp_path / "data"), n_scenes=1,
                                   n_images=8, hw=(240, 320), seed=0)
    config = os.path.join(CONFIGS, "imvoxelnet_smoke_synthetic.py")
    opts = [f"data.{split}.{key}={root}/{value}"
            for split, ann in (("train", "train"), ("val", "val"),
                               ("test", "val"))
            for key, value in (("data_root", ""),
                               ("ann_file", f"scannet_infos_{ann}.pkl"))]
    result = train_cli.main([config, "--work-dir", str(tmp_path / "w"),
                             "--max-steps", "2", "--total-epochs", "2",
                             "--device", "cpu",
                             "--options", *opts])
    assert len(result["history"]) == 2 and result["checkpoints"]
    assert all(np.isfinite(h["loss"]) for h in result["history"])
    assert "mAP_0.25" in result["val"][0]
    metrics = test_cli.main([config, result["checkpoints"][-1], "--eval",
                             "mAP", "--device", "cpu", "--options", *opts])
    assert "mAP_0.25" in metrics
    with pytest.raises(NotImplementedError, match="render"):
        test_cli.main([config, result["checkpoints"][-1], "--eval", "nvs",
                       "--device", "cpu", "--options", *opts])
