"""Host-side multi-view preprocessing (numpy).

Port of ``nerfdet_tpu/data/pipeline.py``: the mmcv image transforms the
reference composes (``Resize(keep_ratio=True)``, ``Normalize``,
``Pad``), the ray directions of ``get_dtu_raydir``, ``MultiViewPipeline``,
``subsample_rays``, ``RandomShiftOrigin`` and ``pad_gt``. The same numpy
operations in the same order, drawing from the same ``RandomState``, so
a scene equals the original's bit for bit.

The machine the port runs on need not have ``cv2`` or ``PIL``, so two
image functions are the port's own:

* ``imresize`` is OpenCV's ``INTER_LINEAR`` resize (what mmcv's
  ``imresize`` calls, and what the JAX pipeline calls on the float32
  depth maps) in numpy. Of uint8 images: 11-bit fixed-point coefficients
  ``saturate_cast<short>((1 - f) * 2048)`` computed from float32
  offsets, borders clamped in x and the rows clipped in y, the
  horizontal integer sums, then OpenCV's vectorized vertical pass
  ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16)``, rounded by
  ``(v + 2) >> 2``. Of float32 (H, W) maps: what OpenCV's IPP HAL (on by
  default in the OpenCV wheels) computes, float64 offsets and fractions
  f (borders clamped on both axes), then per axis, x first, the fused
  multiply-add ``fma(S1 - S0, float32(f), S0)``, emulated in float64. It
  equals ``cv2.resize`` bit for bit on the shapes the tests hold it to.
* ``imread`` decodes PNG itself (``zlib`` and numpy: 8-bit gray, gray +
  alpha, RGB and RGBA and 16-bit gray, not interlaced, all five row
  filters) and JPEG with the port's own decoder (``data/jpeg.py``,
  bit for bit libjpeg-turbo's), and leaves every other format to
  ``cv2`` or ``PIL`` where one is installed, raising otherwise. A JPEG
  the decoder refuses raises: it never goes to ``cv2``. ``read_depth``
  reads a depth map as the JAX pipeline does: ``.npy`` metres, else a
  16-bit PNG of millimetres.

``png_encode`` / ``imwrite_png`` write the PNGs the synthetic dataset
writer produces (filter 0 on every row).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from . import jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels of each PNG color type the decoder reads (8-bit; gray also
# 16-bit)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COEF_SCALE = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE (11 bits)


# ----------------------------------------------------------------------
# PNG
# ----------------------------------------------------------------------

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_encode(img: np.ndarray) -> bytes:
    """An 8-bit PNG of a uint8 image: (H, W) gray, (H, W, 3) RGB or
    (H, W, 4) RGBA; every row with filter 0."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"png_encode takes uint8 images, got {img.dtype}")
    channels = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[channels]
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + w * channels), np.uint8)
    rows[:, 1:] = img.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def imwrite_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_encode(img))


def _unfilter_sequential(kind: int, cur: bytearray, prior: bytes,
                         bpp: int) -> None:
    """Average (3) and Paeth (4) rows, which depend on the byte decoded
    just before: one byte at a time, in place."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def png_decode(data: bytes) -> np.ndarray:
    """Decode a non-interlaced PNG to (H, W, C), C the color type's
    channels (gray 1, gray + alpha 2, RGB 3, RGBA 4): uint8 for 8-bit
    data, uint16 for 16-bit gray (big-endian samples)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if (ctype not in _PNG_CHANNELS or interlace
            or depth not in ((8, 16) if ctype == 0 else (8,))):
        raise ValueError(
            f"PNG bit depth {depth}, color type {ctype}, interlace "
            f"{interlace}: only 8-bit gray / gray+alpha / RGB / RGBA and "
            f"16-bit gray without interlace are decoded")
    channels = _PNG_CHANNELS[ctype]
    bpp = channels * depth // 8  # the filters work on bytes, bpp apart
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    if not raw[:, 0].any():  # filter 0 on every row (the port's writer)
        out = raw[:, 1:].copy()
    else:
        out = np.empty((h, stride), np.uint8)
        prior = np.zeros(stride, np.uint8)
        for y in range(h):
            kind, row = raw[y, 0], raw[y, 1:]
            if kind == 0:
                out[y] = row
            elif kind == 1:  # Sub: a running sum per byte of a pixel
                out[y] = np.cumsum(row.reshape(w, bpp), axis=0,
                                   dtype=np.uint8).reshape(-1)
            elif kind == 2:  # Up
                out[y] = row + prior
            elif kind in (3, 4):
                cur = bytearray(row.tobytes())
                _unfilter_sequential(int(kind), cur, prior.tobytes(), bpp)
                out[y] = np.frombuffer(bytes(cur), np.uint8)
            else:
                raise ValueError(f"PNG row {y}: unknown filter {kind}")
            prior = out[y]
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(h, w, channels)
    return out.reshape(h, w, channels)


# ----------------------------------------------------------------------
# mmcv-equivalent image transforms
# ----------------------------------------------------------------------

def imread(path: str) -> np.ndarray:
    """Read an image file to RGB uint8 (H, W, 3), as ``cv2.imread(path,
    IMREAD_COLOR)`` followed by BGR -> RGB: gray is replicated, alpha
    dropped. PNG is decoded here and JPEG by ``data/jpeg.py``; other
    formats need ``cv2`` or ``PIL``."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        img = png_decode(data)
        if img.dtype != np.uint8:
            raise ValueError(f"{path}: a 16-bit PNG is a depth map "
                             f"(read_depth), not an image")
        if img.shape[2] <= 2:  # gray (+ alpha)
            return np.repeat(img[..., :1], 3, axis=2)
        return np.ascontiguousarray(img[..., :3])
    if data[:2] == b"\xff\xd8":  # SOI
        return jpeg.decode(data)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"cv2 cannot decode {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path} is neither a PNG nor a JPEG, and neither cv2 nor PIL "
            f"is installed to decode it") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def read_depth(img_path: str) -> np.ndarray:
    """The depth map of the view ``img_path``, float32 (H, W) metres:
    ``<stem>.npy`` where it exists, else ``<stem>.png``, 16-bit
    millimetres (ScanNet's sensor depth), as the JAX pipeline reads
    them."""
    base = os.path.splitext(img_path)[0]
    if os.path.exists(base + ".npy"):
        return np.load(base + ".npy").astype(np.float32)
    with open(base + ".png", "rb") as f:
        d = png_decode(f.read())
    if d.dtype != np.uint16 or d.shape[2] != 1:
        raise ValueError(f"{base}.png: a depth map is a 16-bit gray PNG")
    return d[..., 0].astype(np.float32) / 1000.0


def load_depth(img_path: str, size_hw: Tuple[int, int]) -> np.ndarray:
    """``read_depth`` resized to (h, w) = ``size_hw``."""
    return imresize(read_depth(img_path), (size_hw[1], size_hw[0]))


def _resize_taps(dst: int, src: int, clamp: bool):
    """OpenCV's INTER_LINEAR taps along one axis: the two source indices
    and their 11-bit weights. Offsets are float32 ``(d + 0.5) * scale -
    0.5``; x clamps them to the image (``clamp``), y keeps the fraction
    and clips the rows."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        f[s < 0] = 0
        s[s < 0] = 0
        f[s >= src - 1] = 0
        s[s >= src - 1] = src - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE))
    w1 = np.rint(f * np.float32(_COEF_SCALE))
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1),
            w0.astype(np.int32), w1.astype(np.int32))


def _float_taps(dst: int, src: int):
    """The IPP HAL's INTER_LINEAR taps along one axis: the two source
    indices and the float32 fraction, from float64 offsets ``(d + 0.5) *
    src / dst - 0.5`` clamped to the map at both ends."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    f[s < 0] = 0
    s[s < 0] = 0
    f[s >= src - 1] = 0
    s[s >= src - 1] = src - 1
    return s, np.minimum(s + 1, src - 1), f.astype(np.float32)


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    float32 product is exact in float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def imresize(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a uint8 (H, W) or (H, W, C) image, or of a
    float32 (H, W) map, to (w, h): ``cv2.resize(img, size_wh,
    interpolation=cv2.INTER_LINEAR)``, bit for bit. A same-size image is
    returned as a copy, as OpenCV does."""
    w, h = int(size_wh[0]), int(size_wh[1])
    src_h, src_w = img.shape[:2]
    if not (img.dtype == np.uint8
            or (img.dtype == np.float32 and img.ndim == 2)):
        raise TypeError(f"imresize takes uint8 images or float32 (H, W) "
                        f"maps, got {img.dtype} {img.shape}")
    if (src_h, src_w) == (h, w):
        return img.copy()
    if img.dtype == np.float32:
        x0, x1, fx = _float_taps(w, src_w)
        y0, y1, fy = _float_taps(h, src_h)
        rows = _fma32(img[:, x1] - img[:, x0], fx[None], img[:, x0])
        return _fma32(rows[y1] - rows[y0], fy[:, None], rows[y0])
    x0, x1, a0, a1 = _resize_taps(w, src_w, clamp=True)
    y0, y1, b0, b1 = _resize_taps(h, src_h, clamp=False)
    src = img.reshape(src_h, src_w, -1).astype(np.int32)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    top = np.clip(rows[y0] >> 4, -32768, 32767)
    bottom = np.clip(rows[y1] >> 4, -32768, 32767)
    v = ((top * b0[:, None, None]) >> 16) + ((bottom * b1[:, None, None])
                                            >> 16)
    v = np.clip(v, -32768, 32767)
    out = np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
    return out.reshape((h, w) + img.shape[2:])


def imresize_keep_ratio(img: np.ndarray, scale_wh: Tuple[int, int]
                        ) -> Tuple[np.ndarray, float]:
    """mmcv ``Resize(img_scale, keep_ratio=True)``: rescale so the image
    fits inside (w, h), preserving aspect. Returns (image, scale_factor).
    """
    h, w = img.shape[:2]
    max_w, max_h = scale_wh
    scale = min(max_w / w, max_h / h)
    new_size = (int(w * scale + 0.5), int(h * scale + 0.5))
    return imresize(img, new_size), scale


def imnormalize(img: np.ndarray, mean, std) -> np.ndarray:
    """(img - mean) / std in float32, RGB."""
    img = img.astype(np.float32)
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def imdenormalize(img: np.ndarray, mean, std) -> np.ndarray:
    """Invert :func:`imnormalize` to a uint8-quantized [0, 1] float (the
    reference rounds through uint8)."""
    x = img * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    return np.clip(x, 0, 255).astype(np.uint8).astype(np.float32) / 255.0


def impad(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Zero-pad bottom/right to (h, w) — mmcv ``Pad(size)``."""
    h, w = img.shape[:2]
    ph, pw = size_hw
    out = np.zeros((ph, pw) + img.shape[2:], img.dtype)
    out[:h, :w] = img
    return out


def get_dtu_raydir(pixelcoords, intrinsic, rot, dir_norm: bool = False):
    """Pixel grid -> world-space ray directions: +0.5 pixel centers,
    the inverse intrinsic, then the camera-to-world rotation."""
    x = (pixelcoords[..., 0] + 0.5 - intrinsic[0, 2]) / intrinsic[0, 0]
    y = (pixelcoords[..., 1] + 0.5 - intrinsic[1, 2]) / intrinsic[1, 1]
    z = np.ones_like(x)
    dirs = np.stack([x, y, z], axis=-1) @ rot.T
    if dir_norm:
        dirs = dirs / (np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-5)
    return dirs.astype(np.float32)


# ----------------------------------------------------------------------
# the multi-view pipeline
# ----------------------------------------------------------------------

class MultiViewPipeline:
    """Sample views, load + transform images, generate target-view rays.

    The reference's transform stack (Resize keep_ratio -> Normalize ->
    Pad) baked in.

    Args:
        n_images: number of source views drawn per scene (in 'random'
            loading the ``nerf_target_views`` targets are then removed
            from them, so a scene keeps at most n_images - targets).
        img_scale: (w, h) resize bound.
        pad_size: (h, w) padded tensor size.
        mean/std: normalization (RGB order).
        margin: ray-grid crop margin (pixels).
        depth_range: recorded into the output.
        loading: 'random' (train) or 'stride' (test).
        nerf_target_views: held-out views rendered by the NeRF branch.
        sample_freq: stride for loading='stride'.
        use_depth: load each view's depth map (``read_depth``) resized
            to its ``img_shape``: the sources' ``depth`` (V, h, w) and
            the target rays' ``gt_depths`` (T, R), read from the map
            padded to ``pad_size``.
    """

    def __init__(self, n_images: int = 50,
                 img_scale: Tuple[int, int] = (320, 240),
                 pad_size: Tuple[int, int] = (240, 320),
                 mean=(123.675, 116.28, 103.53),
                 std=(58.395, 57.12, 57.375),
                 margin: int = 10,
                 depth_range=(0.5, 5.5),
                 loading: str = "random",
                 nerf_target_views: int = 10,
                 sample_freq: int = 3,
                 use_depth: bool = False):
        self.n_images = n_images
        self.img_scale = img_scale
        self.pad_size = pad_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.margin = margin
        self.depth_range = np.asarray(depth_range, np.float32)
        self.loading = loading
        self.nerf_target_views = nerf_target_views
        self.sample_freq = sample_freq
        self.use_depth = use_depth

    def _load_one(self, img_path: str):
        """LoadImageFromFile -> Resize -> Normalize -> Pad for one view."""
        img = imread(img_path)
        ori_shape = img.shape[:2]
        img, _ = imresize_keep_ratio(img, self.img_scale)
        img_shape = img.shape[:2]
        norm = imnormalize(img, self.mean, self.std)
        denorm = imdenormalize(norm, self.mean, self.std)
        return (impad(norm, self.pad_size), impad(denorm, self.pad_size),
                ori_shape, img_shape)

    def __call__(self, info: Dict, rng: np.random.RandomState) -> Dict:
        """Args:
            info: scene dict with ``img_paths`` (list), ``extrinsics``
                ((n, 4, 4) world->cam, axis-aligned), ``c2w`` ((n, 4, 4)),
                ``intrinsic`` ((4, 4)).
            rng: numpy RandomState driving all sampling.

        Returns a dict of stacked arrays: imgs, denorm_images, extrinsics,
        intrinsic, ori_shape, img_shape, depth_range (with ``use_depth``
        depth) and, with target views, raydirs / lightpos / gt_images
        (T, R, 3), nerf_size (with ``use_depth`` gt_depths (T, R)).
        """
        n_all = len(info["img_paths"])
        if self.loading == "random":
            ids = np.arange(n_all)
            replace = self.n_images > n_all
            ids = rng.choice(ids, self.n_images, replace=replace)
            if self.nerf_target_views != 0:
                target_id = rng.choice(
                    ids, self.nerf_target_views, replace=False)
                ids = np.setdiff1d(ids, target_id)
        else:
            ids = np.arange(0, self.n_images * self.sample_freq,
                            self.sample_freq) % max(n_all, 1)
            target_id = ids[: max(self.nerf_target_views, 1)] \
                if self.nerf_target_views != 0 else np.array([], np.int64)

        imgs, denorms, extrinsics, depths = [], [], [], []
        ori_shape = img_shape = None
        for i in ids:
            norm, denorm, ori_shape, img_shape = self._load_one(
                info["img_paths"][i])
            imgs.append(norm)
            denorms.append(denorm)
            extrinsics.append(info["extrinsics"][i])
            if self.use_depth:
                depths.append(load_depth(info["img_paths"][i], img_shape))

        ratio = ori_shape[0] / img_shape[0]
        out = dict(
            imgs=np.stack(imgs),
            denorm_images=np.stack(denorms),
            extrinsics=np.stack(extrinsics).astype(np.float32),
            intrinsic=np.asarray(info["intrinsic"], np.float32),
            ori_shape=np.asarray(ori_shape, np.int32),
            img_shape=np.asarray(img_shape, np.int32),
            depth_range=self.depth_range,
        )
        if self.use_depth:
            out["depth"] = np.stack(depths)

        if self.nerf_target_views > 0:
            intr = np.asarray(info["intrinsic"], np.float32).copy()
            intr[:2] = intr[:2] / ratio
            height, width = self.pad_size
            px, py = np.meshgrid(
                np.arange(self.margin, width - self.margin,
                          dtype=np.float32),
                np.arange(self.margin, height - self.margin,
                          dtype=np.float32),
            )
            pixelcoords = np.stack((px, py), axis=-1)
            raydirs, lightpos, gt_rgbs, gt_depths = [], [], [], []
            for i in target_id:
                c2w = np.asarray(info["c2w"][i], np.float32)
                raydir = get_dtu_raydir(pixelcoords, intr, c2w[:3, :3])
                raydirs.append(raydir.reshape(-1, 3))
                lightpos.append(
                    np.broadcast_to(c2w[:3, 3], raydir.reshape(-1, 3).shape))
                _, denorm_t, _, timg_shape = self._load_one(
                    info["img_paths"][i])
                gt = denorm_t[py.astype(np.int32), px.astype(np.int32)]
                gt_rgbs.append(gt.reshape(-1, 3))
                if self.use_depth:
                    d = impad(load_depth(info["img_paths"][i], timg_shape),
                              self.pad_size)
                    gt_depths.append(
                        d[py.astype(np.int32), px.astype(np.int32)]
                        .reshape(-1))
            out["raydirs"] = np.stack(raydirs)      # (T, R, 3)
            out["lightpos"] = np.stack(lightpos)    # (T, R, 3)
            out["gt_images"] = np.stack(gt_rgbs)    # (T, R, 3)
            out["nerf_size"] = np.asarray(
                [height - 2 * self.margin, width - 2 * self.margin],
                np.int32)
            if gt_depths:
                out["gt_depths"] = np.stack(gt_depths)  # (T, R)
        return out


def subsample_rays(out: Dict, n_rand: int, rng: np.random.RandomState
                   ) -> Dict:
    """Training-time ray subset: flattens all target views, drops
    zero-depth rays when depths are present, and draws ``n_rand`` rays
    without replacement. Mutates/returns ``out`` with flat
    ``ray_o/ray_d/gt_rgb/gt_depth``."""
    ray_d = out.pop("raydirs").reshape(-1, 3)
    ray_o = out.pop("lightpos").reshape(-1, 3)
    gt_rgb = out.pop("gt_images").reshape(-1, 3)
    gt_depth = out.pop("gt_depths", None)
    if gt_depth is not None:
        gt_depth = gt_depth.reshape(-1)
        nz = gt_depth > 0
        # guard tiny synthetic scenes: keep at least n_rand rays
        if nz.sum() >= n_rand:
            ray_d, ray_o = ray_d[nz], ray_o[nz]
            gt_rgb, gt_depth = gt_rgb[nz], gt_depth[nz]
    sel = rng.choice(ray_d.shape[0], size=(n_rand,), replace=False)
    out["ray_o"] = ray_o[sel]
    out["ray_d"] = ray_d[sel]
    out["gt_rgb"] = gt_rgb[sel]
    if gt_depth is not None:
        out["gt_depth"] = gt_depth[sel]
    return out


class RandomShiftOrigin:
    """Train-time origin jitter."""

    def __init__(self, std=(0.7, 0.7, 0.0)):
        self.std = np.asarray(std, np.float32)

    def __call__(self, origin: np.ndarray, rng: np.random.RandomState):
        return origin + rng.normal(0.0, self.std).astype(np.float32)


def pad_gt(gt_boxes: np.ndarray, gt_labels: np.ndarray, max_gt: int):
    """Pad ground truth to a static (max_gt, 7) + mask."""
    g = min(len(gt_boxes), max_gt)
    boxes = np.zeros((max_gt, 7), np.float32)
    # degenerate padding boxes far outside the scene so they never match
    boxes[:, :3] = 1e4
    boxes[:, 3:6] = 1e-3
    labels = np.zeros((max_gt,), np.int32)
    mask = np.zeros((max_gt,), bool)
    if g:
        gt_boxes = np.asarray(gt_boxes, np.float32)
        if gt_boxes.shape[-1] == 6:
            gt_boxes = np.concatenate(
                [gt_boxes, np.zeros_like(gt_boxes[:, :1])], axis=-1)
        boxes[:g] = gt_boxes[:g]
        labels[:g] = np.asarray(gt_labels, np.int64)[:g]
        mask[:g] = True
    return boxes, labels, mask
