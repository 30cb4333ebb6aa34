"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package, its copies of JAX-free host code equal the originals bit for
bit, reference and JAX weights reach it identically, and its entry
points never fall back to the CPU unasked."""

import ast
import glob
import os

import numpy as np
import pytest
import torch

from nerfdet_tpu.config import Config as JaxConfig
from nerfdet_tpu.data.synthetic import make_synthetic_scene as jax_scene
from nerfdet_tpu.ops.voxel import host_rgb_stats as jax_rgb_stats
from nerfdet_tpu.utils.weight_convert import (convert_reference_checkpoint,
                                              merge_params)

from nerfdet_tpu_torch.api import init_detector
from nerfdet_tpu_torch.config import Config
from nerfdet_tpu_torch.data.rgb_stats import host_rgb_stats
from nerfdet_tpu_torch.data.synthetic import make_synthetic_scene
from nerfdet_tpu_torch.models.nerfdet import NerfDet
from nerfdet_tpu_torch.utils.weight_convert import (
    from_jax_variables, from_reference_state_dict, load_reference_state_dict)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "ml_dtypes", "nerfdet_tpu")
DET_KEYS = ("imgs", "denorm_images", "intrinsic", "extrinsics", "origin",
            "gt_boxes", "gt_labels", "gt_mask")


def _port_files():
    files = glob.glob(os.path.join(ROOT, "nerfdet_tpu_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(ROOT, "chip_smoke.py")]


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
    os.path.join(ROOT, "configs", "nerfdet", "*.py"))),
    ids=os.path.basename)
def test_config_copy(cfg):
    assert Config.fromfile(cfg).to_dict() == JaxConfig.fromfile(cfg).to_dict()


@pytest.mark.parametrize("kw", [
    dict(seed=0, n_views=3, n_targets=1, hw=(31, 40), pad_hw=(32, 40)),
    dict(seed=5, n_views=2, n_targets=2, hw=(24, 32), n_boxes=4,
         max_gt=2),
])
def test_synthetic_scene_copy(kw):
    want = jax_scene(**kw)
    got = make_synthetic_scene(**kw)
    for k in DET_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


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
