"""The port's JPEG decoder (``nerfdet_tpu_torch/data/jpeg.py``) against
OpenCV, and the exactness behind K2's fused bfloat16 taps.

* ``jpeg.decode`` equals ``cv2.imread(path, IMREAD_COLOR)`` then BGR ->
  RGB (libjpeg-turbo) bit for bit, at 1x1, 7x9, 17x33 and 239x320, on
  files written by PIL as the JAX writer writes them (quality 95, its
  default 4:2:0) and by cv2 at qualities 50 / 75 / 95 with 4:4:4, 4:2:2,
  4:2:0 and 4:4:0 sampling, gray, and a restart interval.
* It refuses progressive, CMYK, arithmetic-coded, lossless and 12-bit
  files and an EXIF orientation other than 1, naming the form.
* With ``cv2`` and ``PIL`` hidden from the port, a synthetic dataset the
  JAX package wrote (JPEG views) gives the port's items bitwise equal to
  JAX's, in train and test mode.
* The committed views under ``tests/data/torch_jpeg`` decode to the
  SHA-256 of ``cv2.imread``'s RGB output recorded beside them. They and
  ``meta.json`` (poses, intrinsic, boxes, hashes) were written with the
  JAX package from the repository root:

      import hashlib, json, os, pickle, shutil, tempfile
      import cv2, numpy as np
      from nerfdet_tpu.data.synthetic import write_synthetic_scannet
      out, meta = "tests/data/torch_jpeg", {}
      for tag, hw, n in (("scene", (484, 648), 8),
                         ("full", (968, 1296), 1)):
          root = write_synthetic_scannet(tempfile.mkdtemp(), n_scenes=1,
                                         n_images=n, hw=hw, splits=("val",))
          with open(f"{root}/scannet_infos_val.pkl", "rb") as f:
              info = pickle.load(f)[0]
          views = []
          for rel, c2w in zip(info["img_paths"], info["extrinsics"]):
              name = f"{tag}_{os.path.basename(rel)}"
              shutil.copy(os.path.join(root, rel), os.path.join(out, name))
              rgb = cv2.cvtColor(cv2.imread(os.path.join(out, name)),
                                 cv2.COLOR_BGR2RGB)
              views.append(dict(
                  file=name, extrinsic=np.asarray(c2w).tolist(),
                  sha256=hashlib.sha256(rgb.tobytes()).hexdigest()))
          annos = info["annos"]
          meta[tag] = dict(
              hw=list(hw), intrinsic=np.asarray(info["intrinsics"]).tolist(),
              views=views,
              gt_boxes_upright_depth=annos["gt_boxes_upright_depth"].tolist(),
              labels=np.asarray(annos["class"]).tolist())
      with open(os.path.join(out, "meta.json"), "w") as f:
          json.dump(meta, f, indent=1)

* K2's bfloat16 feature taps fuse each multiply with the add after it:
  for bfloat16 t, w and float32 f, ``f32(f + f32(t w))`` is the exact
  ``f + t w`` rounded once, across float32's normal range; a product in
  the subnormal range is the one place the two differ.
"""

import hashlib
import io
import json
import os
import struct
import sys
from fractions import Fraction

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from nerfdet_tpu.data import synthetic as jsynthetic

from nerfdet_tpu_torch.data import jpeg
from nerfdet_tpu_torch.data import pipeline as tpipeline

from tests.test_torch_data import SMOKE, _assert_items_equal, _both, _data_cfg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_jpeg")


def _cv2_rgb(data: bytes) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _image(h, w, seed):
    """Smooth colour waves with every third pixel noise: flat and busy
    blocks, every coefficient in use."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    smooth = np.stack([127 + 120 * np.sin(x / 7.0 + c) * np.cos(y / 5.0 - c)
                       for c in range(3)], -1)
    noise = rng.randint(0, 256, (h, w, 3))
    img = np.where(((x + y) % 3 == 0)[..., None], noise, smooth)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_jpeg(img, *params):
    ok, enc = cv2.imencode(".jpg", img, list(params))
    assert ok
    return enc.tobytes()


def _encodings(form, img):
    """(name, bytes) of ``img`` (RGB) written in one form."""
    if form == "PIL (the JAX writer)":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=95)
        return [("PIL q95", buf.getvalue())]
    bgr = img[..., ::-1]
    out = []
    for q in (50, 75, 95):
        quality = (cv2.IMWRITE_JPEG_QUALITY, q)
        if form == "gray":
            out.append((f"q{q}", _cv2_jpeg(img[..., 1], *quality)))
        elif form == "restart interval":
            out.append((f"q{q}", _cv2_jpeg(
                bgr, *quality, cv2.IMWRITE_JPEG_RST_INTERVAL, 2)))
        else:
            factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{form}")
            out.append((f"q{q}", _cv2_jpeg(
                bgr, *quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor)))
    return out


@pytest.mark.parametrize("form", ["PIL (the JAX writer)", "444", "422",
                                  "420", "440", "gray", "restart interval"])
@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (17, 33), (239, 320)])
def test_decode_matches_cv2(hw, form):
    img = _image(*hw, seed=hw[0] * hw[1])
    for name, data in _encodings(form, img):
        got = jpeg.decode(data)
        assert got.dtype == np.uint8 and got.shape == hw + (3,), name
        np.testing.assert_array_equal(got, _cv2_rgb(data),
                                      err_msg=f"{form} {name}")


def test_imread_reads_jpeg_without_cv2_or_pil(tmp_path, monkeypatch):
    img = _image(30, 41, seed=5)
    path = str(tmp_path / "view.jpg")
    Image.fromarray(img).save(path, quality=95)
    with open(path, "rb") as f:
        want = _cv2_rgb(f.read())
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(tpipeline.imread(path), want)


def _patched_sof(data: bytes, marker=None, precision=None) -> bytes:
    """The file with its frame marker or sample precision rewritten."""
    at = next(i for i in range(2, len(data) - 1)
              if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC1))
    out = bytearray(data)
    if marker is not None:
        out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    return bytes(out)


def _refused_file(form):
    img = _image(16, 24, seed=1)
    buf = io.BytesIO()
    if form == "progressive":
        Image.fromarray(img).save(buf, format="JPEG", progressive=True)
    elif form == "CMYK":
        Image.fromarray(img).convert("CMYK").save(buf, format="JPEG")
    elif form == "EXIF orientation 6":
        exif = Image.Exif()
        exif[0x0112] = 6
        Image.fromarray(img).save(buf, format="JPEG", exif=exif)
    else:
        Image.fromarray(img).save(buf, format="JPEG")
        return _patched_sof(buf.getvalue(), **{
            "arithmetic-coded": dict(marker=0xC9),
            "lossless": dict(marker=0xC3),
            "12-bit": dict(precision=12)}[form])
    return buf.getvalue()


@pytest.mark.parametrize("form,match", [
    ("progressive", "progressive"), ("CMYK", "4-component"),
    ("EXIF orientation 6", "orientation 6"),
    ("arithmetic-coded", "arithmetic"), ("lossless", "lossless"),
    ("12-bit", "12-bit")])
def test_decode_refuses_forms_it_does_not_read(form, match, tmp_path,
                                               monkeypatch):
    data = _refused_file(form)
    with pytest.raises(jpeg.UnsupportedJPEG, match=match):
        jpeg.decode(data)
    # imread raises too, and never hands the file to cv2
    path = str(tmp_path / "refused.jpg")
    with open(path, "wb") as f:
        f.write(data)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(jpeg.UnsupportedJPEG, match=match):
        tpipeline.imread(path)


def test_decode_refuses_malformed_files():
    data = _cv2_jpeg(_image(16, 16, seed=2), cv2.IMWRITE_JPEG_QUALITY, 90)
    with pytest.raises(ValueError, match="SOI"):
        jpeg.decode(data[2:])
    with pytest.raises(ValueError):
        jpeg.decode(data[:len(data) // 2])


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """Synthetic datasets written by the JAX package (PIL JPEG views):
    the smoke geometry at 60x80 and at 240x320 (resized by the
    pipeline)."""
    base = tmp_path_factory.mktemp("jax_jpeg")
    return dict(
        smoke=jsynthetic.write_synthetic_scannet(
            str(base / "smoke"), n_scenes=1, n_images=7, hw=(60, 80)),
        smoke_resized=jsynthetic.write_synthetic_scannet(
            str(base / "smoke_resized"), n_scenes=1, n_images=6,
            hw=(240, 320), seed=1))


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("case", ["smoke", "smoke_resized"])
def test_port_reads_jax_written_jpeg_dataset_without_cv2_or_pil(
        case, split, jax_written, monkeypatch):
    """The repair: the JAX writer's JPEG views, read by the port with no
    cv2 and no PIL, give items bitwise equal to the JAX dataset's."""
    root = jax_written[case]
    assert os.path.exists(os.path.join(root, "posed_images", "scene0000_00",
                                       "00000.jpg"))
    test_mode = split == "val"
    port, jax_ds = _both(SMOKE, _data_cfg(SMOKE, root, split), test_mode)
    idx = range(len(jax_ds)) if test_mode else (0, len(jax_ds) - 1)
    want = [jax_ds[i] for i in idx]
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for i, w in zip(idx, want):
        _assert_items_equal(port[i], w, f"{case} {split} [{i}]")


def test_fixtures_decode_to_their_recorded_hashes():
    with open(os.path.join(FIXTURES, "meta.json")) as f:
        meta = json.load(f)
    assert sorted(meta) == ["full", "scene"]
    assert len(meta["scene"]["views"]) == 8
    for part in meta.values():
        for view in part["views"]:
            with open(os.path.join(FIXTURES, view["file"]), "rb") as f:
                data = f.read()
            for rgb in (jpeg.decode(data), _cv2_rgb(data)):
                assert rgb.shape == tuple(part["hw"]) + (3,)
                assert hashlib.sha256(rgb.tobytes()).hexdigest() == \
                    view["sha256"], view["file"]


# ---------------------------------------------------------------------
# the exactness of K2's fused bfloat16 taps
# ---------------------------------------------------------------------

def _f32(bits: int) -> np.float32:
    return np.frombuffer(struct.pack("<I", bits), np.float32)[0]


def _round_f32(q: Fraction) -> np.float32:
    """The rational ``q`` rounded once to float32, to nearest even."""
    if q == 0:
        return np.float32(0.0)
    a = abs(q)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1  # now 2^e <= a < 2^(e + 1)
    ulp = Fraction(2) ** (max(e, -126) - 23)
    n = round(a / ulp)  # Fraction rounds half to even
    return np.float32(float(n * ulp) * (1 if q > 0 else -1))


def _bf16(sign, exponent, mantissa):
    """A bfloat16 value as float32: 8 exponent bits, 7 mantissa bits."""
    return _f32(sign << 31 | exponent << 23 | mantissa << 16)


@settings(max_examples=400, deadline=None)
@given(st.integers(0, 1), st.integers(1, 254), st.integers(0, 127),
       st.integers(0, 1), st.integers(1, 254), st.integers(0, 127),
       st.integers(0, 2 ** 32 - 1))
def test_bf16_products_are_exact_so_the_fused_tap_rounds_once(
        ts, te, tm, ws, we, wm, f_bits):
    t, w, f = _bf16(ts, te, tm), _bf16(ws, we, wm), _f32(f_bits)
    exact = Fraction(float(t)) * Fraction(float(w))
    if not np.isfinite(f) or not (2.0 ** -126 <= abs(exact) < 2.0 ** 127):
        return  # outside float32's normal range
    with np.errstate(over="ignore"):
        product = np.float32(t) * np.float32(w)
        separate = np.float32(f + product)
    assert Fraction(float(product)) == exact  # the product is exact
    fused = Fraction(float(f)) + exact
    if abs(fused) >= 2.0 ** 128:
        return
    assert separate == _round_f32(fused)


def test_a_subnormal_product_rounds_twice():
    """t w = 1.25 x 2^-149 rounds to 2^-149 on its own; 2^-125 + 2^-149
    is then a tie that rounds to even (2^-125), while the exact sum
    2^-125 + 1.25 x 2^-149 rounds up to 2^-125 + 2^-148."""
    t = np.float32(1.25 * 2.0 ** -74)
    w = np.float32(2.0 ** -75)
    f = np.float32(2.0 ** -125)
    assert t == _bf16(0, 127 - 74, 32) and w == _bf16(0, 127 - 75, 0)
    with np.errstate(under="ignore"):
        product = np.float32(t * w)
    exact = Fraction(float(t)) * Fraction(float(w))
    assert Fraction(float(product)) != exact
    separate = np.float32(f + product)
    fused = _round_f32(Fraction(float(f)) + exact)
    assert separate == f and fused == np.float32(2.0 ** -125 + 2.0 ** -148)
    assert separate != fused
