"""The depth_sp data path of the port from files, against OpenCV, PIL and
the JAX package, and the CLIs with depth on the CPU.

* ``imresize`` of float32 (H, W) maps equals ``cv2.resize(INTER_LINEAR)``
  bit for bit (what the JAX pipeline calls on the depth maps), shrinking
  by non-integer ratios, at exactly one half and growing.
* ``png_decode`` of 16-bit gray PNGs (big-endian samples, each of the
  five row filters and a mix) equals PIL's and ``cv2.imread(...,
  IMREAD_UNCHANGED)``'s decode exactly, and ``read_depth`` of such a
  file equals the JAX pipeline's millimetres / 1000.
* ``write_synthetic_scannet(with_depth=True)`` writes each view's depth
  as ``.npy`` beside it, the renderer's depth bit for bit, and
  ``make_synthetic_scene(with_depth=True)`` returns the JAX scene's
  ``depth`` bit for bit; ``tools/create_data synthetic`` always writes
  them, as the JAX tool does.
* ``build_dataset(use_depth=True)`` of both packages on the port's files:
  every key of ``dataset[i]`` bitwise equal (``depth``, ``gt_depth``, no
  host rgb sums), in train and test mode, for the smoke config resized
  240x320 -> 60x80 and for NeRF-Det-R50* (fewer views) resized 484x648
  -> 239x320.
* the three depth_sp configs pass the train CLI's refusals and build
  (R50 or R101, their views);
* ``tools/train`` (2 steps, ``loss_depth`` logged) then ``tools/test
  --eval mAP nvs`` on the smoke config with ``model.depth_supervise=True
  input_modality.use_depth=True``, in subprocesses with ``--device
  cpu``.
"""

import json
import os
import pickle
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from nerfdet_tpu.config import Config as JaxConfig
from nerfdet_tpu.data import dataset as jdataset
from nerfdet_tpu.data import synthetic as jsynthetic
from nerfdet_tpu.data.pipeline import MultiViewPipeline as JaxPipeline

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.config import Config
from nerfdet_tpu_torch.data import dataset as tdataset
from nerfdet_tpu_torch.data import pipeline as tpipeline
from nerfdet_tpu_torch.data import synthetic as tsynthetic
from nerfdet_tpu_torch.models.builder import build_model
from nerfdet_tpu_torch.tools import create_data as create_data_cli
from nerfdet_tpu_torch.tools import train as train_cli

from tests.test_torch_data import _assert_items_equal, _data_cfg, _paeth
from tests.test_torch_runtime import _cli, _options

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "nerfdet", "nerfdet_smoke_synthetic.py")
R50_DEPTH = os.path.join(ROOT, "configs", "nerfdet",
                         "nerfdet_res50_2x_low_res_depth_sp.py")
DEPTH_OPTIONS = ["model.depth_supervise=True", "input_modality.use_depth=True"]


# ---------------------------------------------------------------------
# float32 resize and 16-bit PNG
# ---------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((968, 1296), (320, 239)),
                                     ((484, 648), (320, 239)),
                                     ((29, 40), (10, 7)),
                                     ((240, 320), (160, 120)),
                                     ((60, 80), (320, 239))])
def test_float_imresize_matches_cv2(src, dst):
    rng = np.random.RandomState(src[0])
    depth = (rng.rand(*src) * 6).astype(np.float32)
    depth[rng.rand(*src) < 0.1] = 0  # pixels without a depth reading
    got = tpipeline.imresize(depth, dst)
    want = cv2.resize(depth, dst, interpolation=cv2.INTER_LINEAR)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_float_imresize_refuses_multichannel_maps():
    with pytest.raises(TypeError, match="float32"):
        tpipeline.imresize(np.zeros((4, 4, 3), np.float32), (2, 2))


def _png16(depth_mm, kinds):
    """A 16-bit gray PNG whose row y carries filter ``kinds[y %
    len(kinds)]`` (the filters act on bytes, two a pixel)."""
    h, w = depth_mm.shape
    rows = depth_mm.astype(">u2").view(np.uint8).reshape(h, 2 * w).astype(
        np.int64)
    out = bytearray()
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur = rows[y]
        prior = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(2, np.int64), cur[:-2]])
        upleft = np.concatenate([np.zeros(2, np.int64), prior[:-2]])
        f = [cur, cur - left, cur - prior, cur - (left + prior) // 2,
             cur - np.array([_paeth(a, b, d) for a, b, d in
                             zip(left, prior, upleft)])][kind]
        out.append(kind)
        out += bytes((f % 256).astype(np.uint8))
    header = tpipeline.struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)
    return (tpipeline.PNG_SIGNATURE + tpipeline._chunk(b"IHDR", header)
            + tpipeline._chunk(b"IDAT", zlib.compress(bytes(out)))
            + tpipeline._chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,),
                                   (4, 3, 2, 1, 0)],
                         ids=lambda k: "filters" + "".join(map(str, k)))
def test_png16_decode_matches_pil_and_cv2(kinds, tmp_path):
    rng = np.random.RandomState(len(kinds))
    mm = rng.randint(0, 65536, (13, 17)).astype(np.uint16)
    mm[5:9] = 1500 + mm[5:9] % 300  # smooth rows, as a depth map's
    path = str(tmp_path / "00000.png")
    with open(path, "wb") as f:
        f.write(_png16(mm, kinds))
    got = tpipeline.png_decode(open(path, "rb").read())
    assert got.dtype == np.uint16 and got.shape == (13, 17, 1)
    np.testing.assert_array_equal(got[..., 0], mm)
    with Image.open(path) as im:
        np.testing.assert_array_equal(got[..., 0], np.asarray(im))
    np.testing.assert_array_equal(
        got[..., 0], cv2.imread(path, cv2.IMREAD_UNCHANGED))
    # the depth map of a view, as the JAX pipeline reads it (PIL, / 1000)
    view = str(tmp_path / "00000.jpg")
    np.testing.assert_array_equal(
        tpipeline.read_depth(view),
        np.asarray(Image.open(path)).astype(np.float32) / 1000.0)
    np.testing.assert_array_equal(
        tpipeline.load_depth(view, (7, 9)),
        JaxPipeline()._load_depth(view, (7, 9)))
    with pytest.raises(ValueError, match="depth map"):
        tpipeline.imread(path)


# ---------------------------------------------------------------------
# the writers
# ---------------------------------------------------------------------

def test_synthetic_depth_matches_jax(tmp_path):
    kw = dict(seed=5, n_views=3, n_targets=1, hw=(30, 40), pad_hw=(32, 40),
              n_rand=20, n_boxes=2, max_gt=4, margin=2)
    got = tsynthetic.make_synthetic_scene(with_depth=True, **kw)
    want = jsynthetic.make_synthetic_scene(with_depth=True, **kw)
    assert set(got) == set(want) and got["depth"].shape == (3, 30, 40)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "depth" not in tsynthetic.make_synthetic_scene(**kw)

    hw = (30, 40)
    root = tsynthetic.write_synthetic_scannet(
        str(tmp_path / "d"), n_scenes=1, n_images=3, hw=hw,
        splits=("train",), with_depth=True)
    with open(os.path.join(root, "scannet_infos_train.pkl"), "rb") as f:
        info = pickle.load(f)[0]
    rng = np.random.RandomState(0)  # the writer's stream, seed 0
    boxes, _ = tsynthetic.make_scene_geometry(rng, 3)
    colors = tsynthetic._PALETTE[rng.randint(0, len(tsynthetic._PALETTE),
                                             len(boxes))]
    for rel, c2w in zip(info["img_paths"], info["extrinsics"]):
        depth = np.load(os.path.join(root, rel[:-4] + ".npy"))
        _, want = tsynthetic._render_view(boxes, colors, c2w,
                                          info["intrinsics"], hw)
        assert depth.dtype == np.float32 and (depth > 0).any()
        np.testing.assert_array_equal(depth, want)
        assert tpipeline.imread(os.path.join(root, rel)).shape == hw + (3,)


def test_create_data_cli_writes_depth(tmp_path):
    root = create_data_cli.main(
        ["synthetic", "--root-path", str(tmp_path / "c"), "--n-scenes", "1",
         "--n-images", "2", "--hw", "24", "32", "--splits", "val"])
    with open(os.path.join(root, "scannet_infos_val.pkl"), "rb") as f:
        info = pickle.load(f)[0]
    assert len(info["img_paths"]) == 2
    for rel in info["img_paths"]:
        depth = np.load(os.path.join(root, rel[:-4] + ".npy"))
        assert depth.shape == (24, 32) and depth.dtype == np.float32
        assert tpipeline.imread(os.path.join(root, rel)).shape == (24, 32, 3)


# ---------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Port-written scenes with depth: the smoke geometry resized
    (240x320 -> 60x80) and half ScanNet's (484x648 -> 239x320)."""
    base = tmp_path_factory.mktemp("depth")
    return dict(
        smoke=tsynthetic.write_synthetic_scannet(
            str(base / "smoke"), n_scenes=1, n_images=7, hw=(240, 320),
            seed=1, with_depth=True),
        depth_sp=tsynthetic.write_synthetic_scannet(
            str(base / "depth_sp"), n_scenes=1, n_images=5,
            hw=(484, 648), seed=2, workers=2, with_depth=True))


# config, written root, train views, test views, targets, ori_shape
CASES = {"smoke": (SMOKE, "smoke", None, None, None, None),
         "depth_sp": (R50_DEPTH, "depth_sp", 5, 4, 1, (484, 648))}


def _both(case, split, written):
    path, root, n_train, n_test, targets, ori = CASES[case]
    test_mode = split == "val"
    data_cfg = _data_cfg(path, written[root], split,
                         n_test if test_mode else n_train, targets)
    cfg = JaxConfig.fromfile(path)
    specs = dict(rgb_stats_spec=jdataset.rgb_stats_spec_from_config(
        cfg, use_depth=True))
    assert specs["rgb_stats_spec"] is None
    if not test_mode:
        specs["ray_stats_spec"] = jdataset.ray_stats_spec_from_config(cfg)
    kw = dict(test_mode=test_mode, use_depth=True,
              n_rand=cfg.model.get("N_rand", 2048), **specs)
    return (tdataset.build_dataset(data_cfg, **kw),
            jdataset.build_dataset(data_cfg, **kw), ori)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_depth_items_match_jax(case, split, written):
    port, jax_ds, ori = _both(case, split, written)
    for i in range(min(len(port), 2)):
        got, want = port[i], jax_ds[i]
        assert "depth" in got and "gt_depth" in got and "rgb_s1" not in got
        _assert_items_equal(got, want, f"{case} {split} [{i}]")
        if ori is not None:  # resized from 484x648: the float path ran
            assert got["depth"].shape[1:] == (239, 320)
        assert (got["depth"] > 0).any() and (got["gt_depth"] > 0).any()


# ---------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name,blocks,views", [
    ("nerfdet_res50_2x_low_res_depth_sp.py", 6, 50),
    ("nerfdet_res101_2x_low_res_depth_sp.py", 23, 48),
    ("nerfdet_res101_2x_orign_res_depth_sp.py", 23, 30)])
def test_depth_sp_configs_build(name, blocks, views):
    """The three depth_sp configs pass the train CLI's refusals, ask for
    depth maps and build their backbone (R50 or R101)."""
    path = os.path.join(ROOT, "configs", "nerfdet", name)
    cfg = Config.fromfile(path)
    train_cli.refuse_unported(train_cli.parse_args([path]), cfg)
    assert cfg.model["depth_supervise"] and cfg.input_modality["use_depth"]
    model = build_model(cfg.model, meta=api.scene_meta_from_config(cfg))
    assert len(model.backbone.layer3) == blocks
    train = cfg.data["train"].get("dataset", cfg.data["train"])
    mv = [t for t in train["pipeline"] if t["type"] == "MultiViewPipeline"]
    assert mv[0]["n_images"] == views


@pytest.fixture(scope="module")
def smoke_root(tmp_path_factory):
    return tsynthetic.write_synthetic_scannet(
        str(tmp_path_factory.mktemp("smoke_depth")), n_scenes=2,
        n_images=8, hw=(240, 320), with_depth=True)


def test_train_then_test_cli_with_depth_on_cpu(smoke_root, tmp_path):
    work = str(tmp_path / "work")
    opts = _options(smoke_root) + DEPTH_OPTIONS
    run = _cli("train", SMOKE, "--work-dir", work, "--max-steps", "2",
               "--device", "cpu", "--options", *opts)
    assert run.returncode == 0, run.stderr[-3000:]
    records = [json.loads(line) for line in
               open(os.path.join(work, "metrics.jsonl"))]
    assert records[0]["step"] == 2
    assert np.isfinite(records[0]["loss_depth"])
    assert records[0]["loss_depth"] > 0
    assert records[-1]["mode"] == "val"

    ckpt = os.path.join(work, "ckpts", "ckpt_1.pth")
    run = _cli("test", SMOKE, ckpt, "--eval", "mAP", "nvs", "--device",
               "cpu", "--options", *opts)
    assert run.returncode == 0, run.stderr[-3000:]
    printed = json.loads(run.stdout[run.stdout.rindex("{"):])
    assert {"mAP_0.25", "mAR_0.25", "psnr", "ssim", "rmse"} <= set(printed)
    assert all(np.isfinite(v) for v in printed.values())
