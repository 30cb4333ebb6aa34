"""The port's data path from files against the JAX package and OpenCV.

* PNG: the port's codec round-trips, and its ``imread`` equals
  ``cv2.imread`` (BGR -> RGB) bit for bit on files with every row
  filter, on files OpenCV wrote and on gray / RGBA files; JPEG goes to
  the port's decoder (``tests/test_torch_jpeg.py``), other formats to
  cv2, and raise without a decoder.
* ``imresize`` equals ``cv2.resize(INTER_LINEAR)`` bit for bit at
  968x1296 -> 320x239, 484x648 -> 320x239, the smoke config's 240x320 ->
  80x60 and on random shapes (tolerance: none; a same-size image comes
  back unchanged).
* ``write_synthetic_scannet``: the infos and the points equal the JAX
  writer's but for the file extension; the views are
  ``(rgb * 255).astype(uint8)`` of the JAX renderer's views; the
  process pool writes the same bytes.
* ``build_dataset`` of both packages on the port's files: every key of
  ``dataset[i]`` bitwise equal, in train mode (views, rays, ``z_vals``,
  the ray and rgb sums, the origin jitter) and in test mode, for the
  smoke config and the flagship config with fewer views, at geometries
  where no resize happens and at one where it does (bitwise there too,
  as ``imresize`` is).
* ``BatchLoader`` with one worker yields the JAX loader's scenes in its
  order; a dying worker raises and does not hang.
"""

import os
import pickle
import sys
import threading
import zlib

import cv2
import numpy as np
import pytest

from nerfdet_tpu.config import Config as JaxConfig
from nerfdet_tpu.data import dataset as jdataset
from nerfdet_tpu.data import loader as jloader
from nerfdet_tpu.data import synthetic as jsynthetic

from nerfdet_tpu_torch.data import dataset as tdataset
from nerfdet_tpu_torch.data import loader as tloader
from nerfdet_tpu_torch.data import pipeline as tpipeline
from nerfdet_tpu_torch.data import synthetic as tsynthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "nerfdet", "nerfdet_smoke_synthetic.py")
FLAGSHIP = os.path.join(ROOT, "configs", "nerfdet",
                        "nerfdet_res50_2x_low_res.py")


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


# ---------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _filtered_png(img, kinds):
    """An RGB PNG whose row y carries filter ``kinds[y % len(kinds)]``."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur = rows[y]
        prior = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - prior
        elif kind == 3:
            f = cur - (left + prior) // 2
        else:
            f = cur - np.array([_paeth(a, b, d) for a, b, d in
                                zip(left, prior, upleft)])
        out.append(kind)
        out += bytes((f % 256).astype(np.uint8))
    header = tpipeline.struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (tpipeline.PNG_SIGNATURE + tpipeline._chunk(b"IHDR", header)
            + tpipeline._chunk(b"IDAT", zlib.compress(bytes(out)))
            + tpipeline._chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(13, 17, 3), (9, 20), (7, 11, 4)])
def test_png_round_trip_and_cv2(shape, tmp_path):
    img = np.random.RandomState(sum(shape)).randint(
        0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    tpipeline.imwrite_png(path, img)
    decoded = tpipeline.png_decode(open(path, "rb").read())
    np.testing.assert_array_equal(decoded.reshape(img.shape), img)
    got = tpipeline.imread(path)
    assert got.dtype == np.uint8 and got.shape == shape[:2] + (3,)
    np.testing.assert_array_equal(got, _cv2_rgb(path))


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,),
                                   (4, 3, 2, 1, 0)],
                         ids=lambda k: "filters" + "".join(map(str, k)))
def test_png_row_filters_match_cv2(kinds, tmp_path):
    img = np.random.RandomState(len(kinds)).randint(
        0, 256, (11, 9, 3)).astype(np.uint8)
    img[4:8] = img[4:8] // 7  # smooth rows too
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_filtered_png(img, kinds))
    np.testing.assert_array_equal(tpipeline.imread(path), img)
    np.testing.assert_array_equal(tpipeline.imread(path), _cv2_rgb(path))


@pytest.mark.parametrize("gray", [False, True])
def test_imread_opencv_written_png(gray, tmp_path):
    """OpenCV's own PNGs (libpng's adaptive row filters)."""
    rgb = tsynthetic._render_view(
        *tsynthetic.make_scene_geometry(np.random.RandomState(4), 3)[:1],
        tsynthetic._PALETTE[:3], tsynthetic._look_at((3.0, 1.0, 1.5),
                                                     tsynthetic.LOOK_AT),
        np.array([[40, 0, 24, 0], [0, 40, 18, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32), (36, 48))[0]
    img = (rgb * 255).astype(np.uint8)
    img = img[..., 0] if gray else cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    path = str(tmp_path / "cv.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(tpipeline.imread(path), _cv2_rgb(path))


def test_imread_jpeg_needs_a_decoder(tmp_path, monkeypatch):
    """JPEG goes through the port's own decoder (``data/jpeg.py``), with
    or without cv2; a format neither of the port's decoders reads (BMP)
    needs cv2 or PIL and raises without them."""
    img = np.random.RandomState(0).randint(0, 256, (16, 24, 3)).astype(
        np.uint8)
    path = str(tmp_path / "a.jpg")
    cv2.imwrite(path, img)
    bmp = str(tmp_path / "a.bmp")
    cv2.imwrite(bmp, img)
    want = _cv2_rgb(path)
    np.testing.assert_array_equal(tpipeline.imread(path), want)
    np.testing.assert_array_equal(tpipeline.imread(bmp), _cv2_rgb(bmp))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(tpipeline.imread(path), want)
    with pytest.raises(RuntimeError, match="neither cv2 nor PIL"):
        tpipeline.imread(bmp)
    with pytest.raises(FileNotFoundError):
        tpipeline.imread(str(tmp_path / "absent.png"))


# ---------------------------------------------------------------------
# imresize
# ---------------------------------------------------------------------

def _image(hw, seed):
    """Half noise, half a smooth gradient: every coefficient matters."""
    rng = np.random.RandomState(seed)
    h, w = hw
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img[h // 2:] = ((xx[h // 2:, :, None] * 7 + yy[h // 2:, :, None] * 3
                     + np.arange(3) * 50) % 256).astype(np.uint8)
    return img


@pytest.mark.parametrize("src,dst", [((968, 1296), (320, 239)),
                                     ((484, 648), (320, 239)),
                                     ((240, 320), (80, 60))],
                         ids=lambda v: "x".join(map(str, v)))
def test_imresize_matches_cv2(src, dst):
    img = _image(src, 0)
    got = tpipeline.imresize(img, dst)
    want = cv2.resize(img, dst, interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # keep-ratio as the pipeline calls it
    scaled, _ = tpipeline.imresize_keep_ratio(img, (dst[0], dst[1] + 1))
    assert scaled.shape[:2] == (dst[1], dst[0])


def test_imresize_random_shapes_and_identity():
    rng = np.random.RandomState(1)
    for t in range(40):
        h, w, dh, dw = rng.randint(2, 90, 4)
        shape = (h, w, 3) if t % 2 else (h, w)
        img = rng.randint(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(
            tpipeline.imresize(img, (dw, dh)),
            cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR),
            err_msg=f"{shape} -> {(dh, dw)}")
    img = _image((30, 40), 2)
    same = tpipeline.imresize(img, (40, 30))
    assert same is not img
    np.testing.assert_array_equal(same, img)


# ---------------------------------------------------------------------
# the synthetic writer
# ---------------------------------------------------------------------

def test_write_synthetic_scannet_matches_jax(tmp_path):
    kw = dict(n_scenes=2, n_images=3, hw=(48, 64), n_boxes=3, seed=3,
              splits=("train", "val"))
    jroot = jsynthetic.write_synthetic_scannet(str(tmp_path / "jax"), **kw)
    troot = tsynthetic.write_synthetic_scannet(str(tmp_path / "port"), **kw)
    for split in kw["splits"]:
        with open(os.path.join(jroot, f"scannet_infos_{split}.pkl"),
                  "rb") as f:
            want = pickle.load(f)
        with open(os.path.join(troot, f"scannet_infos_{split}.pkl"),
                  "rb") as f:
            got = pickle.load(f)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert g["img_paths"] == [p[:-4] + ".png"
                                      for p in w["img_paths"]]
            assert g["pts_path"] == w["pts_path"]
            for a, b in zip(g["extrinsics"], w["extrinsics"]):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(g["intrinsics"], w["intrinsics"])
            assert set(g["annos"]) == set(w["annos"])
            for k in w["annos"]:
                np.testing.assert_array_equal(g["annos"][k], w["annos"][k])
                assert np.asarray(g["annos"][k]).dtype == \
                    np.asarray(w["annos"][k]).dtype
            with open(os.path.join(troot, g["pts_path"]), "rb") as a, \
                    open(os.path.join(jroot, w["pts_path"]), "rb") as b:
                assert a.read() == b.read()

    # the first scene's views, rendered by the JAX module
    rng = np.random.RandomState(kw["seed"])
    boxes, _ = jsynthetic.make_scene_geometry(rng, kw["n_boxes"])
    colors = jsynthetic._PALETTE[rng.randint(0, len(jsynthetic._PALETTE),
                                             len(boxes))]
    with open(os.path.join(troot, "scannet_infos_train.pkl"), "rb") as f:
        info = pickle.load(f)[0]
    for rel, c2w in zip(info["img_paths"], info["extrinsics"]):
        rgb, _ = jsynthetic._render_view(boxes, colors, c2w,
                                         info["intrinsics"], kw["hw"])
        np.testing.assert_array_equal(
            tpipeline.imread(os.path.join(troot, rel)),
            (rgb * 255).astype(np.uint8))

    # views rendered in a process pool: the same files
    proot = tsynthetic.write_synthetic_scannet(str(tmp_path / "pool"),
                                               workers=2, **kw)
    for rel in info["img_paths"]:
        with open(os.path.join(troot, rel), "rb") as a, \
                open(os.path.join(proot, rel), "rb") as b:
            assert a.read() == b.read()


# ---------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------

def _data_cfg(path, root, split, n_images=None, targets=None):
    """The config's ``data[split]`` pointed at ``root``, the multi-view
    pipeline's n_images / nerf_target_views lowered where given."""
    data = JaxConfig.fromfile(path).to_dict()["data"]
    cfg = dict(data["train" if split == "train" else "test"])
    inner = cfg["dataset"] if cfg.get("type") == "RepeatDataset" else cfg
    inner.update(data_root=root + "/",
                 ann_file=f"{root}/scannet_infos_"
                          f"{'train' if split == 'train' else 'val'}.pkl")
    for step in inner["pipeline"]:
        if step["type"] == "MultiViewPipeline":
            if n_images is not None:
                step["n_images"] = n_images
            if targets is not None:
                step["nerf_target_views"] = targets
    return cfg


def _assert_items_equal(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, (what, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")


def _both(path, data_cfg, test_mode):
    """(port dataset, JAX dataset), built as the train / test CLIs do."""
    cfg = JaxConfig.fromfile(path)
    n_rand = cfg.model.get("N_rand", 2048)
    specs = {}
    if not test_mode:
        specs["ray_stats_spec"] = jdataset.ray_stats_spec_from_config(cfg)
    specs["rgb_stats_spec"] = jdataset.rgb_stats_spec_from_config(cfg)
    return (tdataset.build_dataset(data_cfg, test_mode=test_mode,
                                   n_rand=n_rand, **specs),
            jdataset.build_dataset(data_cfg, test_mode=test_mode,
                                   n_rand=n_rand, **specs))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Port-written scenes: the smoke geometry unresized (60x80) and
    resized (240x320 -> 60x80), the flagship's unresized (240x320)."""
    base = tmp_path_factory.mktemp("written")
    return dict(
        smoke=tsynthetic.write_synthetic_scannet(
            str(base / "smoke"), n_scenes=2, n_images=7, hw=(60, 80)),
        smoke_resized=tsynthetic.write_synthetic_scannet(
            str(base / "smoke_resized"), n_scenes=1, n_images=7,
            hw=(240, 320), seed=1),
        flagship=tsynthetic.write_synthetic_scannet(
            str(base / "flagship"), n_scenes=1, n_images=14,
            hw=(240, 320), seed=2, workers=2))


CASES = {
    "smoke": (SMOKE, "smoke", None, None, None),
    "smoke_resized": (SMOKE, "smoke_resized", None, None, None),
    "flagship": (FLAGSHIP, "flagship", 13, 6, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_items_match_jax(case, written):
    path, root, n_train, _, _ = CASES[case]
    port, jax_ds = _both(path, _data_cfg(path, written[root], "train",
                                         n_train), test_mode=False)
    assert len(port) == len(jax_ds)
    for i in (0, 1, len(port) - 1):
        got, want = port[i], jax_ds[i]
        for k in ("z_vals", "ray_s1u", "ray_cnt", "rgb_s1", "origin"):
            assert k in got, (case, k)
        _assert_items_equal(got, want, f"{case} train [{i}]")


@pytest.mark.parametrize("case", sorted(CASES))
def test_test_items_match_jax(case, written):
    path, root, _, n_test, targets = CASES[case]
    port, jax_ds = _both(path, _data_cfg(path, written[root], "val",
                                         n_test, targets), test_mode=True)
    for i in range(len(port)):
        got = port[i]
        assert got["ray_o"].ndim == 3 and "rgb_s1" in got
        _assert_items_equal(got, jax_ds[i], f"{case} test [{i}]")


IMVOXELNET = os.path.join(ROOT, "configs", "imvoxelnet",
                          "imvoxelnet_scannet.py")


@pytest.mark.parametrize("split", ["train", "val"])
def test_imvoxelnet_items_match_jax(split, written):
    """The indoor ImVoxelNet's pipelines (``imvoxelnet_scannet.py``:
    480x640 views resized from the written 240x320, no target views, no
    host streams; the train split's ``RandomShiftOrigin`` std (.7, .7,
    0) in a RepeatDataset x3, 13 of its 20 views as the scene holds 14;
    the test split's 6 of its 50 by stride) give the JAX package's items
    bit for bit."""
    cfg = JaxConfig.fromfile(IMVOXELNET)
    assert jdataset.rgb_stats_spec_from_config(cfg) is None
    assert jdataset.ray_stats_spec_from_config(cfg) is None
    test_mode = split == "val"
    port, jax_ds = _both(IMVOXELNET, _data_cfg(
        IMVOXELNET, written["flagship"], split, 6 if test_mode else 13),
        test_mode=test_mode)
    assert len(port) == len(jax_ds) == (1 if test_mode else 3)
    for i in range(len(port)):
        got = port[i]
        assert got["imgs"].shape[1:] == (480, 640, 3)
        assert "ray_o" not in got and "rgb_s1" not in got
        _assert_items_equal(got, jax_ds[i], f"imvoxelnet {split} [{i}]")


def test_repeat_dataset_len_and_refusals(written):
    cfg = _data_cfg(FLAGSHIP, written["flagship"], "train")
    assert cfg["type"] == "RepeatDataset" and cfg["times"] == 6
    assert len(tdataset.build_dataset(cfg)) == 6
    assert len(tdataset.build_dataset(cfg["dataset"])) == 1
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 3"):
        tdataset.build_dataset(dict(cfg["dataset"], type="ScanNetDataset"))
    # the depth_sp configs' depth maps are read (``test_torch_depth_data``
    # holds their scenes to JAX's)
    depth = tdataset.build_dataset(cfg, use_depth=True)
    assert len(depth) == 6 and depth.pipeline.use_depth
    # the bfloat16 specs (the --bf16 path) are the JAX package's
    flag = JaxConfig.fromfile(FLAGSHIP)
    assert tdataset.rgb_stats_spec_from_config(flag, bf16=True) == \
        jdataset.rgb_stats_spec_from_config(flag, bf16=True)
    assert tdataset.ray_stats_spec_from_config(flag, bf16=True) == \
        jdataset.ray_stats_spec_from_config(flag, bf16=True)
    assert tdataset.ray_stats_spec_from_config(flag, bf16=True)[2] == \
        "bfloat16"


# ---------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------

class _Draws:
    """Scenes that draw from one shared stream, as the train-mode dataset
    does; ``fail_at`` raises in that scene."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at
        self._rng = np.random.RandomState(5)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError("a broken scene")
        return {"i": np.int64(i), "draw": self._rng.rand(3)}


def test_loader_one_worker_matches_jax_order():
    port = tloader.BatchLoader(_Draws(7), batch_size=2, num_workers=1,
                               seed=3)
    jax_loader = jloader.BatchLoader(_Draws(7), batch_size=2,
                                     num_workers=1, seed=3)
    assert len(port) == len(jax_loader) == 3
    for _ in range(2):  # two epochs: the order reshuffles alike
        got, want = list(port), list(jax_loader)
        assert len(got) == len(want) == 3
        for scenes, stacked in zip(got, want):
            assert isinstance(scenes, list) and len(scenes) == 2
            for k in ("i", "draw"):
                np.testing.assert_array_equal(
                    np.stack([s[k] for s in scenes]), stacked[k])


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("workers", [1, 3])
def test_loader_worker_death_raises(workers):
    """With three workers the other two fill the prefetch capacity (2 +
    3 batches) and block: the consumer still raises at the failed batch."""
    loader = tloader.BatchLoader(_Draws(40, fail_at=2), batch_size=1,
                                 num_workers=workers, shuffle=False)
    outcome = {}

    def consume():
        try:
            outcome["n"] = sum(1 for _ in loader)
        except RuntimeError as e:
            outcome["error"] = str(e)
            outcome["cause"] = e.__cause__

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the loader hung on a dead worker"
    assert "died before producing batch 2" in outcome.get("error", "")
    assert isinstance(outcome["cause"], ValueError)
