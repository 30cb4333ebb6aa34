"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package, its copies of JAX-free host code equal the originals bit for
bit, reference and JAX weights reach it identically, and its entry
points never fall back to the CPU unasked."""

import ast
import glob
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nerfdet_tpu.config import Config as JaxConfig
from nerfdet_tpu.core import nvs_metrics as jax_nvs_metrics
from nerfdet_tpu.core.boxes import corners_from_boxes as jax_corners
from nerfdet_tpu.data.sunrgbd_dataset import \
    SUNRGBD_CLASSES as JAX_SUNRGBD_CLASSES
from nerfdet_tpu.data.sunrgbd_etl import CLASSES_V2 as JAX_CLASSES_V2
from nerfdet_tpu.data.synthetic import make_synthetic_scene as jax_scene
from nerfdet_tpu.models.nerfdet import NerfDet as JaxNerfDet
from nerfdet_tpu.models.nerfdet import SceneMeta as JaxSceneMeta
from nerfdet_tpu.models.votenet import votenet_nms as jax_votenet_nms
from nerfdet_tpu.ops import rotated_iou as jax_rotated_iou
from nerfdet_tpu.ops.voxel import host_rgb_stats as jax_rgb_stats
from nerfdet_tpu.utils.weight_convert import (convert_reference_checkpoint,
                                              merge_params)

from nerfdet_tpu_torch.api import init_detector
from nerfdet_tpu_torch.config import Config
from nerfdet_tpu_torch.core import nvs_metrics
from nerfdet_tpu_torch.core.boxes import corners_from_boxes
from nerfdet_tpu_torch.data.rgb_stats import host_rgb_stats
from nerfdet_tpu_torch.data.sunrgbd_multiview import SUNRGBD_CLASSES
from nerfdet_tpu_torch.data.synthetic import make_synthetic_scene
from nerfdet_tpu_torch.models.nerfdet import NerfDet
from nerfdet_tpu_torch.models.votenet import VoteNet, votenet_nms
from nerfdet_tpu_torch.ops import rotated_iou
from nerfdet_tpu_torch.utils.weight_convert import (
    from_jax_variables, from_reference_state_dict, load_reference_state_dict)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "ml_dtypes", "nerfdet_tpu")
SCENE_KEYS = ("imgs", "denorm_images", "intrinsic", "extrinsics", "origin",
              "gt_boxes", "gt_labels", "gt_mask", "ray_o", "ray_d", "gt_rgb",
              "gt_depth")


def _port_files():
    files = glob.glob(os.path.join(ROOT, "nerfdet_tpu_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(ROOT, name)
                            for name in ("chip_smoke.py", "kernel_ab.py")]


def test_the_import_rule_reads_every_module_of_the_port():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in ("nn/swin.py", "ops/grid_sample.py", "ops/render.py",
                 "models/builder.py", "models/nerfdet.py",
                 "models/imvoxelnet_indoor.py", "nn/imvoxel_necks.py",
                 "nn/heads_v1.py", "ops/rotated_iou.py",
                 "data/sunrgbd_multiview.py"):
        assert os.path.join("nerfdet_tpu_torch", name) in names, name


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


@pytest.mark.parametrize("cfg", sorted(glob.glob(
    os.path.join(ROOT, "configs", "nerfdet", "*.py"))) + sorted(glob.glob(
    os.path.join(ROOT, "configs", "votenet", "*.py"))) + sorted(glob.glob(
    os.path.join(ROOT, "configs", "imvoxelnet", "*fast_cov*.py"))),
    ids=os.path.basename)
def test_config_copy(cfg):
    assert Config.fromfile(cfg).to_dict() == JaxConfig.fromfile(cfg).to_dict()


@pytest.mark.parametrize("kw", [
    dict(seed=0, n_views=3, n_targets=1, hw=(31, 40), pad_hw=(32, 40)),
    dict(seed=5, n_views=2, n_targets=2, hw=(24, 32), n_boxes=4,
         max_gt=2, n_rand=10000, margin=3),
])
def test_synthetic_scene_copy(kw):
    want = jax_scene(**kw)
    got = make_synthetic_scene(**kw)
    assert set(got) == set(SCENE_KEYS)
    for k in SCENE_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _nvs_case(mod, name, out_dir):
    rng = np.random.RandomState(3)
    rgb = rng.uniform(0, 1, (2, 20, 24, 3)).astype(np.float32)
    gt = np.clip(rgb + rng.normal(0, 0.05, rgb.shape), 0, 1).astype(
        np.float32)
    depth = rng.uniform(0.5, 5, (2, 20, 24)).astype(np.float32)
    gt_depth = depth + rng.normal(0, 0.1, depth.shape).astype(np.float32)
    if name == "compute_psnr":
        return (mod.compute_psnr(rgb, gt),
                mod.compute_psnr(rgb, gt, mask=depth > 2))
    if name == "compute_ssim":
        return mod.compute_ssim(rgb[0], gt[0])
    if name == "evaluate_rendering":
        return mod.evaluate_rendering(rgb, gt, depth=depth,
                                      gt_depth=gt_depth, out_dir=out_dir)
    return mod.aggregate_nvs({"a": dict(psnr=20.5, ssim=0.7, rmse=0.1),
                              "b": dict(psnr=25.0, ssim=0.8)})


@pytest.mark.parametrize("name", ["compute_psnr", "compute_ssim",
                                  "evaluate_rendering", "aggregate_nvs"])
def test_nvs_metrics_copy(name, tmp_path):
    got = _nvs_case(nvs_metrics, name, str(tmp_path / "port"))
    want = _nvs_case(jax_nvs_metrics, name, str(tmp_path / "jax"))
    assert got == want
    if name == "evaluate_rendering":
        for i in range(2):
            rel = os.path.join("scene", f"view_{i}.png")
            with open(tmp_path / "port" / rel, "rb") as a, \
                    open(tmp_path / "jax" / rel, "rb") as b:
                assert a.read() == b.read()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_rgb_stats_copy(dtype):
    scene = jax_scene(seed=1, n_views=3, n_targets=1, hw=(31, 40),
                      pad_hw=(32, 40))
    args = (scene["denorm_images"], scene["intrinsic"], scene["extrinsics"],
            scene["origin"], (8, 8, 4), (0.8, 0.8, 0.8), (128, 160),
            (31, 40))
    for got, want in zip(host_rgb_stats(*args, compute_dtype=dtype),
                         jax_rgb_stats(*args, compute_dtype=dtype)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _boxes(rng, n, yaw=True):
    boxes = np.concatenate([
        rng.uniform(-3, 3, (n, 2)), rng.uniform(-0.2, 1.0, (n, 1)),
        rng.uniform(0.2, 2.0, (n, 3)),
        rng.uniform(-np.pi, np.pi, (n, 1)) * yaw], axis=1)
    return boxes.astype(np.float32)


@pytest.mark.parametrize("yaw", [False, True])
def test_corners_from_boxes_copy(yaw):
    boxes = _boxes(np.random.RandomState(int(yaw)), 50, yaw)
    got, want = corners_from_boxes(boxes), jax_corners(boxes)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fn", ["bev_corners", "rotated_bev_overlap",
                                "rotated_iou_3d"])
def test_rotated_iou_copy(fn, dtype):
    """The numpy rotated overlap (``ops/rotated_iou.py``) on yawed boxes,
    a few of them identical, nested or touching, at float32 (JAX's numpy
    path) and float64 (the port's)."""
    a = _boxes(np.random.RandomState(4), 30)
    a[1], a[3] = a[0], a[2] * np.float32([1, 1, 1, .5, .5, .5, 1])
    a[5] = a[4] + np.float32([a[4, 3], 0, 0, 0, 0, 0, 0])
    a[4:6, 6] = 0
    a = a.astype(dtype)
    if fn == "bev_corners":
        got, want = rotated_iou.bev_corners(a), jax_rotated_iou.bev_corners(a)
    else:
        got = getattr(rotated_iou, fn)(a, a[::2])
        want = getattr(jax_rotated_iou, fn)(a, a[::2])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_sunrgbd_class_tuple_copy():
    assert SUNRGBD_CLASSES == JAX_SUNRGBD_CLASSES == JAX_CLASSES_V2


@pytest.mark.parametrize("per_class_proposal", [True, False])
def test_votenet_nms_copy(per_class_proposal):
    """The host tail on seeded gravity-centered proposals and a cloud
    dense enough that some boxes pass the non-empty filter."""
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, 64, yaw=False)
    boxes[:, 2] += boxes[:, 5] / 2
    obj = rng.uniform(0, 1, 64).astype(np.float32)
    sem = rng.dirichlet(np.ones(18), 64).astype(np.float32)
    pts = rng.uniform([-3, -3, 0], [3, 3, 2], (4000, 3)).astype(np.float32)
    got = votenet_nms(boxes, obj, sem, pts,
                      per_class_proposal=per_class_proposal)
    want = jax_votenet_nms(boxes, obj, sem, pts,
                           per_class_proposal=per_class_proposal)
    assert set(got) == set(want)
    assert 0 < len(want["labels_3d"]) < 64 * (18 if per_class_proposal
                                              else 1)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _reference_state():
    """A reference-keyed NeRF-Det state_dict (random, seeded)."""
    from tests.test_checkpoint_convert import randomize_bn
    from tests.test_whole_graph_parity import (TorchHead, TorchNeck3D,
                                               TorchNerfMLP)
    from tests.test_whole_model_parity import (TorchFPN, TorchResNet50,
                                               _randomize_bn)

    torch.manual_seed(0)
    backbone, fpn = TorchResNet50(), TorchFPN(out=64)
    _randomize_bn(backbone)
    neck3d = TorchNeck3D(64, 16)
    randomize_bn(neck3d)
    mods = (("backbone.", backbone), ("neck.", fpn), ("neck_3d.", neck3d),
            ("bbox_head.", TorchHead(16)), ("nerf_mlp.", TorchNerfMLP()),
            ("mapping.", torch.nn.Sequential(torch.nn.Linear(64, 8))))
    state = {pre + k: v.numpy() for pre, m in mods
             for k, v in m.state_dict().items()}
    # a volume-mode module the port does not build yet
    state["mean_mapping.0.weight"] = np.zeros((8, 64, 1, 1, 1), np.float32)
    state["mean_mapping.0.bias"] = np.zeros((8,), np.float32)
    return state


def test_from_jax_variables_round_trip():
    state = _reference_state()
    conv = convert_reference_checkpoint(state, depth=50,
                                        neck3d_blocks=(1, 1), n_scales=2)
    variables = {"params": merge_params({}, conv["params"]),
                 "batch_stats": merge_params({}, conv["batch_stats"])}
    via_jax = from_jax_variables(variables)
    direct = from_reference_state_dict(state)

    model = NerfDet(fpn_out_channels=64, neck3d_out_channels=16,
                    neck3d_n_blocks=(1, 1), n_classes=5, n_scales=2,
                    n_voxels=(8, 8, 4))
    own = model.state_dict()
    assert set(via_jax) == set(own)
    for k in own:
        a, b = via_jax[k], direct[k]
        assert a.shape == own[k].shape, k
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(a.float(), torch.as_tensor(b).float()), k
    model.load_state_dict(via_jax, strict=True)
    load_reference_state_dict(model, state)


def test_from_jax_variables_loads_the_render_head():
    """A JAX tree initialized with a ray bundle holds the rgb head
    (bottleneck_layer, rgb_layer): it loads strictly into the port, and
    a reference checkpoint still loads over it."""
    meta = JaxSceneMeta(ori_shape=(128, 160), img_shape=(31, 40),
                        pad_shape=(32, 40))
    jmodel = JaxNerfDet(fpn_out_channels=64, neck3d_out_channels=16,
                        neck3d_n_blocks=(1, 1), n_classes=5, n_scales=2,
                        n_voxels=(8, 8, 4), n_samples=16, meta=meta)
    scene = jax_scene(seed=0, n_views=2, n_targets=1, hw=(31, 40),
                      pad_hw=(32, 40), n_rand=8)
    batch = {k: scene[k] for k in ("imgs", "denorm_images", "intrinsic",
                                   "extrinsics", "origin", "ray_o",
                                   "ray_d")}
    shapes = jax.eval_shape(lambda k: jmodel.init(
        k, batch, train=False, with_rays=True), jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), shapes)
    state = from_jax_variables(variables)
    rgb_head = variables["params"]["nerf_mlp"]["mlp"]["rgb_layer"]
    for key, kernel in (
            ("bottleneck_layer.output_layer", variables["params"]["nerf_mlp"]
             ["mlp"]["bottleneck_layer"]["output"]["kernel"]),
            ("rgb_layer.hidden_layers.0", rgb_head["hidden_0"]["kernel"]),
            ("rgb_layer.output_layer", rgb_head["output"]["kernel"])):
        np.testing.assert_array_equal(
            state[f"nerf_mlp.mlp.{key}.weight"].numpy(), kernel.T)
    model = NerfDet(fpn_out_channels=64, neck3d_out_channels=16,
                    neck3d_n_blocks=(1, 1), n_classes=5, n_scales=2,
                    n_voxels=(8, 8, 4), n_samples=16)
    model.load_state_dict(state, strict=True)
    load_reference_state_dict(model, _reference_state())


@pytest.mark.parametrize("kind", ["v1", "v2"])
def test_from_jax_variables_carries_the_yawed_heads(kind):
    """A JAX indoor ImVoxelNet with a SUN RGB-D head (the yawed V1 or V2
    head, seven regression outputs) loads strictly into the port: its
    ``reg_conv`` kernel DHWIO -> OIDHW, (7, C, 3, 3, 3), and the V1
    towers' convs and norms by their flax names."""
    from tests.test_torch_sunrgbd import jax_toy, port_toy, toy_scene

    batch = {k: jax.numpy.asarray(v) for k, v in toy_scene().items()}
    shapes = jax.eval_shape(lambda k: jax_toy(kind).init(k, batch),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    variables = jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), shapes)
    state = from_jax_variables(variables)
    head = variables["params"]["bbox_head"]
    kernel = head["reg_conv"]["kernel"]
    assert kernel.shape[-1] == 7
    np.testing.assert_array_equal(state["bbox_head.reg_conv.weight"].numpy(),
                                  kernel.transpose(4, 3, 0, 1, 2))
    if kind == "v1":
        np.testing.assert_array_equal(
            state["bbox_head.reg_convs.norm_0.running_var"].numpy(),
            variables["batch_stats"]["bbox_head"]["reg_convs"]["norm_0"][
                "var"])
    port_toy(kind).load_state_dict(state, strict=True)


def test_entry_points_need_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    cfg = os.path.join(ROOT, "configs", "nerfdet",
                       "nerfdet_res50_2x_low_res.py")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_detector(cfg)
    model = init_detector(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert not model.training


def test_process_group_needs_cuda_unless_cpu(monkeypatch):
    """The data-parallel entry joins no group and falls back to no CPU
    where a card is asked for and absent."""
    from nerfdet_tpu_torch.parallel import dist as pdist

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        with pdist.process_group("cuda"):
            pass
    assert not torch.distributed.is_initialized()


def test_ranks_module_imports_no_jax():
    """The data-parallel test's ranks import its module in fresh
    processes (spawn): the port's modules and nothing of JAX."""
    code = ("import sys; sys.path.insert(0, 'tests'); import test_torch_ddp; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); assert not bad, bad; "
            "assert 'nerfdet_tpu_torch.parallel.dist' in sys.modules")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]


def test_init_detector_loads_reference_checkpoint(tmp_path):
    """A reference ``.pth`` (``{"state_dict": ...}``) loads through
    ``init_detector``, folded exactly as ``from_reference_state_dict``."""
    state = _reference_state()
    path = tmp_path / "reference.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in state.items()}}, path)
    cfg = Config.fromfile(os.path.join(
        ROOT, "configs", "nerfdet", "nerfdet_res50_2x_low_res.py"))
    cfg.model["neck"]["out_channels"] = 64
    cfg.model["neck_3d"].update(out_channels=16, n_blocks=[1, 1])
    cfg.model["bbox_head"].update(n_classes=5, n_scales=2)
    model = init_detector(cfg, checkpoint=str(path), device="cpu")
    want = from_reference_state_dict(state)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, torch.as_tensor(want[k]).float()), k


def test_votenet_init_detector_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    cfg = os.path.join(ROOT, "configs", "votenet",
                       "votenet_8x8_scannet-3d-18class.py")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_detector(cfg)
    model = init_detector(cfg, device="cpu")
    assert isinstance(model, VoteNet) and not model.training
    assert next(model.parameters()).device.type == "cpu"
    assert model.backbone.sa0.num_point == 2048
    assert model.bbox_head.conv_cls.out_features == 18 + 2


def test_votenet_init_detector_refuses_a_checkpoint(tmp_path):
    """Reference checkpoints load into NeRF-Det only; a VoteNet config
    with one raises before any file is read."""
    cfg = os.path.join(ROOT, "configs", "votenet",
                       "votenet_8x8_scannet-3d-18class.py")
    with pytest.raises(NotImplementedError, match="VoteNet"):
        init_detector(cfg, checkpoint=str(tmp_path / "absent.pth"),
                      device="cpu")
