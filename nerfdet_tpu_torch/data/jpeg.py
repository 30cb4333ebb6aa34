"""A baseline JPEG decoder of the port's own, bit for bit libjpeg-turbo's.

``decode(data)`` gives what the JAX pipeline reads from a JPEG view,
``cv2.imread(path, IMREAD_COLOR)`` then BGR -> RGB, without ``cv2`` or
``PIL``: the machine the port runs on need not have either, and real
ScanNet's ``posed_images`` and the JAX package's synthetic views are
JPEG. It reads baseline and extended sequential Huffman JPEG with 8-bit
samples: 1 component (gray, replicated to three channels) or 3 (YCbCr),
sampling factors of 1 or 2 (4:4:4, 4:2:2, 4:2:0, 4:4:0), restart
intervals, any number of sequential scans, tables anywhere before the
scan that uses them; APPn and COM segments are skipped. It refuses, with
an error that names the form: progressive, arithmetic-coded, lossless,
hierarchical and 12-bit files, 2 or 4 components (CMYK, YCCK), RGB-coded
3-component files (Adobe transform 0, or component ids 'R', 'G', 'B'),
other sampling factors, and an EXIF orientation other than 1 (which
``cv2.imread`` would apply).

The stages, each as libjpeg-turbo's default decompression runs them
(``cv2.imread`` takes those defaults):

* the Huffman entropy decoding, the one stage that does not vectorize,
  in host C++ (``csrc/jpeg_entropy.cpp``, built at first use by
  ``ops/cuda_build.py`` with the host compiler), to int16 coefficient
  blocks in natural order;
* dequantization and ``jidctint.c``'s integer "islow" inverse DCT. Each
  of its two passes is linear over the integers until its one rounding
  shift, so it is an integer 8x8 matrix (``_IDCT``, the butterfly run on
  the unit vectors) applied in float64, where every product and sum is
  an integer below 2^53 and so exact, then ``(x + 2^(n-1)) >> n``: n =
  11 after the columns, 18 after the rows; the samples are clipped to
  [0, 255] after adding 128;
* ``jdsample.c``'s upsampling: "fancy" (triangle) filters for h2v1 and
  h2v2 where the component is more than 2 samples wide, and for h1v2,
  nearest-neighbour replication otherwise, edges replicated;
* ``jdcolor.c``'s fixed-point YCbCr -> RGB tables (16 fraction bits).

Vectorized over blocks and pixels in numpy integer (and exact float64)
arithmetic, in the manner of the port's PNG decoder
(``data/pipeline.py``).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, List, Tuple

import numpy as np

from ..ops import cuda_build

LIBRARY = "jpeg_entropy"  # csrc/jpeg_entropy.cpp
# position k of the zig-zag scan -> natural-order index (T.81 Figure 5)
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# frame markers that are not baseline / extended sequential Huffman
_REFUSED_SOF = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
    0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded "
    "hierarchical", 0xCE: "arithmetic-coded hierarchical progressive",
    0xCF: "arithmetic-coded hierarchical lossless"}


class UnsupportedJPEG(ValueError):
    """A JPEG form the decoder does not read (named in the message)."""


def _islow_matrix() -> np.ndarray:
    """The 8x8 integer matrix of one pass of ``jidctint.c``'s
    ``jpeg_idct_islow`` before its rounding shift (CONST_BITS = 13): the
    butterfly applied to each unit vector."""
    def butterfly(x):
        z2, z3 = x[2], x[6]
        z1 = (z2 + z3) * 4433
        tmp2 = z1 + z3 * -15137
        tmp3 = z1 + z2 * 6270
        tmp0 = (x[0] + x[4]) << 13
        tmp1 = (x[0] - x[4]) << 13
        t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, \
            tmp1 - tmp2
        o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
        z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
        z5 = (z3 + z4) * 9633
        o0, o1, o2, o3 = o0 * 2446, o1 * 16819, o2 * 25172, o3 * 12299
        z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069, z4 * -3196
        z3, z4 = z3 + z5, z4 + z5
        o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, \
            o3 + z1 + z4
        return [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                t13 - o0, t12 - o1, t11 - o2, t10 - o3]

    eye = np.eye(8, dtype=np.int64)
    return np.array(butterfly([eye[k] for k in range(8)]), np.int64)


_IDCT = _islow_matrix().astype(np.float64)  # (out, in)


def _ycc_tables():
    """``jdcolor.c``'s ``build_ycc_rgb_table`` (SCALEBITS = 16) as int16
    lookups: Cr -> R and Cb -> B by the sample 0..255, and Cb, Cr -> G,
    ``(Cb_g[cb] + Cr_g[cr]) >> 16`` with the rounding half in Cb's, by
    both samples (256 x 256)."""
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * 65536 + 0.5)

    half = 1 << 15
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return (((fix(1.40200) * x + half) >> 16).astype(np.int16),
            ((fix(1.77200) * x + half) >> 16).astype(np.int16),
            ((cb_g[:, None] + cr_g[None, :]) >> 16).astype(np.int16))


_CR_R, _CB_B, _CBCR_G = _ycc_tables()


def _segment(data: bytes, pos: int):
    """The marker segment at ``pos`` (fill bytes and standalone markers
    skipped): (marker, position of its payload, payload length), or None
    at EOI."""
    while True:
        while pos + 1 < len(data) and data[pos] == 0xFF and \
                data[pos + 1] == 0xFF:
            pos += 1  # fill bytes
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise ValueError(f"JPEG: no marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xD9:  # EOI
            return None
        if marker != 0x01 and not 0xD0 <= marker <= 0xD7:
            break
        pos += 2  # standalone markers
    if pos + 4 > len(data):
        raise ValueError("JPEG: truncated segment")
    length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
    if length < 2 or pos + 2 + length > len(data):
        raise ValueError(f"JPEG: segment {marker:#04x} overruns the file")
    return marker, pos + 4, length - 2


def _scan_end(buf: np.ndarray, start: int) -> int:
    """The position of the marker that ends the entropy-coded data from
    ``start``: the first 0xFF followed by neither 0x00 (a stuffed byte)
    nor an RSTn marker."""
    ff = np.flatnonzero(buf[start:-1] == 0xFF) + start
    nxt = buf[ff + 1]
    ends = ff[(nxt != 0x00) & ((nxt < 0xD0) | (nxt > 0xD7)) & (nxt != 0xFF)]
    if len(ends) == 0:
        raise ValueError("JPEG: the scan data has no end marker")
    return int(ends[0])


def _exif_orientation(body: bytes) -> int:
    """Tag 0x0112 of IFD0 of an APP1 "Exif" payload, 1 where absent."""
    tiff = body[6:]
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    end = "<" if tiff[:2] == b"II" else ">"
    ifd = struct.unpack(end + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    n = struct.unpack(end + "H", tiff[ifd:ifd + 2])[0]
    for i in range(n):
        e = ifd + 2 + 12 * i
        if e + 12 > len(tiff):
            break
        tag, kind = struct.unpack(end + "HH", tiff[e:e + 4])
        if tag == 0x0112 and kind == 3:
            return struct.unpack(end + "H", tiff[e + 8:e + 10])[0]
    return 1


def _frame(body: bytes, marker: int):
    if marker in _REFUSED_SOF:
        raise UnsupportedJPEG(f"{_REFUSED_SOF[marker]} JPEG is not read "
                              f"(baseline sequential only)")
    precision, h, w, nc = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise UnsupportedJPEG(f"{precision}-bit JPEG is not read (8-bit "
                              f"samples only)")
    if nc not in (1, 3):
        raise UnsupportedJPEG(
            f"{nc}-component JPEG is not read (gray or YCbCr only"
            + ("; CMYK / YCCK" if nc == 4 else "") + ")")
    if h == 0 or w == 0:
        raise UnsupportedJPEG("JPEG with its height in a DNL marker is "
                              "not read")
    comps = []
    for i in range(nc):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        hs, vs = hv >> 4, hv & 15
        if hs not in (1, 2) or vs not in (1, 2):
            raise UnsupportedJPEG(f"JPEG sampling factors {hs}x{vs} are "
                                  f"not read (1 or 2 only)")
        comps.append(dict(id=cid, h=hs, v=vs, tq=tq))
    if nc == 1:  # one component: its MCU is one block, whatever it says
        comps[0].update(h=1, v=1)
    return h, w, comps


def _entropy_lib():
    lib = cuda_build.load(LIBRARY)
    fn = lib.jpeg_decode_scan
    if fn.argtypes is None:
        p, i, long_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        fn.argtypes = [p, long_, long_, i, p, p, p, p, p, p, i, i, i]
        fn.restype = long_
    return lib


def _decode_scan(data: np.ndarray, pos, end, scan, comps, coefs, frame_wh,
                 tables, restart):
    """Entropy-decode the scan data ``data[pos:end]`` into the coefficient
    arrays."""
    w, h = frame_wh
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    ns = len(scan)
    if ns == 1:  # non-interleaved: the component's own block grid
        c = comps[scan[0][0]]
        cw = -(-w * c["h"] // hmax)
        ch = -(-h * c["v"] // vmax)
        mcus = (-(-cw // 8), -(-ch // 8))
        hs, vs = [1], [1]
    else:
        mcus = (-(-w // (8 * hmax)), -(-h // (8 * vmax)))
        hs = [comps[ci]["h"] for ci, _, _ in scan]
        vs = [comps[ci]["v"] for ci, _, _ in scan]
    dc = np.zeros((ns, 272), np.uint8)
    ac = np.zeros((ns, 272), np.uint8)
    for k, (ci, td, ta) in enumerate(scan):
        for out, key in ((dc, (0, td)), (ac, (1, ta))):
            if key not in tables:
                raise ValueError(f"JPEG: Huffman table {key} is not "
                                 f"defined before the scan")
            spec = tables[key]
            out[k, :len(spec)] = np.frombuffer(spec, np.uint8)
    arrays = [coefs[ci] for ci, _, _ in scan]
    ptrs = (ctypes.c_void_p * ns)(*[a.ctypes.data for a in arrays])
    per_row = np.array([a.shape[1] for a in arrays], np.int32)
    hs_, vs_ = np.array(hs, np.int32), np.array(vs, np.int32)
    got = _entropy_lib().jpeg_decode_scan(
        data.ctypes.data, pos, end, ns, ctypes.addressof(ptrs),
        per_row.ctypes.data, hs_.ctypes.data, vs_.ctypes.data,
        dc.ctypes.data, ac.ctypes.data, mcus[0], mcus[1], restart)
    if got < 0:
        raise ValueError({-1: "JPEG: a bad Huffman table",
                          -2: "JPEG: a bad Huffman code in the scan",
                          -3: "JPEG: a missing restart marker",
                          -4: "JPEG: a coefficient past the block"}.get(
            got, f"JPEG: scan error {got}"))


def _idct(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Dequantize and inverse-DCT (bh, bw, 64) int16 blocks into the
    (8 bh, 8 bw) uint8 plane, ``jpeg_idct_islow``'s arithmetic."""
    bh, bw, _ = coef.shape
    x = (coef.astype(np.float64) * qtable).reshape(-1, 8, 8)  # (n, v, u)
    # columns: each (block, u) column through the matrix, then >> 11
    t = x.transpose(0, 2, 1).reshape(-1, 8) @ _IDCT.T  # (n * u, y)
    ws = np.floor((t + 1024.0) * (1.0 / 2048.0))
    # rows: each (block, y) row, then >> 18
    ws = ws.reshape(-1, 8, 8).transpose(0, 2, 1).reshape(-1, 8)
    out = np.floor((ws @ _IDCT.T + 131072.0) * (1.0 / 262144.0))
    out = np.clip(out + 128.0, 0, 255).astype(np.uint8)
    return out.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
        bh * 8, bw * 8)


def _fancy_h(x: np.ndarray, b_even: int, b_odd: int,
             shift: int) -> np.ndarray:
    """Twice as wide: output column 2i is (3 x[i] + x[i-1] + b_even) >>
    shift, column 2i + 1 (3 x[i] + x[i+1] + b_odd) >> shift, the edges
    replicated (``x`` int32, already scaled for the h2v2 colsums)."""
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + b_even) >> shift
    out[:, 1::2] = (3 * x + right + b_odd) >> shift
    return out


def _upsample(plane: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """``jdsample.c``'s upsampling of one component by (fx, fy) in {1,
    2}, as libjpeg-turbo chooses it with fancy upsampling on."""
    if fx == 1 and fy == 1:
        return plane
    x = plane.astype(np.int32)
    width = x.shape[1]
    if fy == 2 and (fx == 1 or width > 2):
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        if fx == 1:  # h1v2: (3 near + far + 1 | 2) >> 2
            out = np.empty((2 * x.shape[0], width), np.int32)
            out[0::2] = (3 * x + up + 1) >> 2
            out[1::2] = (3 * x + down + 2) >> 2
            return out.astype(np.uint8)
        # h2v2: column sums 3 near + far, then (3 s + s' + 8 | 7) >> 4
        sums = np.empty((2 * x.shape[0], width), np.int32)
        sums[0::2] = 3 * x + up
        sums[1::2] = 3 * x + down
        return _fancy_h(sums, 8, 7, 4).astype(np.uint8)
    if fx == 2 and fy == 1 and width > 2:  # h2v1
        return _fancy_h(x, 1, 2, 2).astype(np.uint8)
    return np.repeat(np.repeat(plane, fy, axis=0), fx, axis=1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """``jdcolor.c``'s ``ycc_rgb_convert``: (H, W, 3) RGB uint8."""
    yi = y.astype(np.int16)
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = np.clip(yi + _CR_R[cr], 0, 255)
    out[..., 1] = np.clip(yi + _CBCR_G[cb, cr], 0, 255)
    out[..., 2] = np.clip(yi + _CB_B[cb], 0, 255)
    return out


def decode(data: bytes) -> np.ndarray:
    """Decode a baseline JPEG to RGB uint8 (H, W, 3), bit for bit
    ``cv2.imread(path, IMREAD_COLOR)`` then BGR -> RGB (libjpeg-turbo's
    defaults). Raises ``UnsupportedJPEG`` on a form it does not read and
    ``ValueError`` on a malformed file."""
    buf = np.frombuffer(data, np.uint8)
    qtables: Dict[int, np.ndarray] = {}
    htables: Dict[Tuple[int, int], bytes] = {}
    restart = 0
    frame = None
    coefs: List[np.ndarray] = []
    latched: Dict[int, np.ndarray] = {}
    jfif = adobe = None
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    pos = 2
    while True:
        seg = _segment(data, pos)
        if seg is None:
            break
        marker, at, n = seg
        body = data[at:at + n]
        pos = at + n
        if marker == 0xDB:  # DQT
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                if pq != 0:
                    raise UnsupportedJPEG("16-bit quantization tables are "
                                          "not read (12-bit JPEG)")
                q = np.zeros(64, np.float64)
                q[_NATURAL] = np.frombuffer(body[p + 1:p + 65], np.uint8)
                qtables[tq] = q
                p += 65
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(body):
                tc, th = body[p] >> 4, body[p] & 15
                count = sum(body[p + 1:p + 17])
                htables[(tc, th)] = body[p + 1:p + 17 + count]
                p += 17 + count
        elif marker == 0xDD:  # DRI
            restart = struct.unpack(">H", body[:2])[0]
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            orient = _exif_orientation(body)
            if orient != 1:
                raise UnsupportedJPEG(
                    f"JPEG with EXIF orientation {orient} is not read "
                    f"(cv2.imread would rotate it)")
        elif marker == 0xCC:
            raise UnsupportedJPEG("arithmetic-coded JPEG is not read")
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8):
            if frame is not None:
                raise ValueError("JPEG: a second frame")
            frame = _frame(body, marker)
            h, w, comps = frame
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            coefs = [np.zeros((my * c["v"], mx * c["h"], 64), np.int16)
                     for c in comps]
            if len(comps) == 3 and _rgb_coded(comps, jfif, adobe):
                raise UnsupportedJPEG("RGB-coded JPEG (Adobe transform 0 or "
                                      "component ids R, G, B) is not read")
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG: a scan before the frame")
            h, w, comps = frame
            ids = [c["id"] for c in comps]
            ns = body[0]
            scan = []
            for k in range(ns):
                cid, tables = body[1 + 2 * k:3 + 2 * k]
                if cid not in ids:
                    raise ValueError(f"JPEG: scan component {cid} is not "
                                     f"in the frame")
                ci = ids.index(cid)
                if ci not in latched:
                    if comps[ci]["tq"] not in qtables:
                        raise ValueError("JPEG: a quantization table is "
                                         "not defined")
                    latched[ci] = qtables[comps[ci]["tq"]]
                scan.append((ci, tables >> 4, tables & 15))
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            if ss != 0 or se != 63 or a != 0:
                raise UnsupportedJPEG("progressive scans are not read")
            pos = _scan_end(buf, pos)
            _decode_scan(buf, at + n, pos, scan, comps, coefs, (w, h),
                         htables, restart)
    if frame is None or len(latched) != len(frame[2]):
        raise ValueError("JPEG: no frame, or a component no scan decodes")
    h, w, comps = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    planes = []
    for ci, c in enumerate(comps):
        cw, ch = -(-w * c["h"] // hmax), -(-h * c["v"] // vmax)
        plane = _idct(coefs[ci], latched[ci])[:ch, :cw]
        planes.append(_upsample(plane, hmax // c["h"],
                                vmax // c["v"])[:h, :w])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    return _ycc_to_rgb(*planes)


def _rgb_coded(comps, jfif, adobe) -> bool:
    """libjpeg's guess of a 3-component color space: JFIF says YCbCr,
    Adobe's transform 0 RGB; else the component ids 'R', 'G', 'B'."""
    if jfif:
        return False
    if adobe is not None:
        return adobe == 0
    return [c["id"] for c in comps] == [82, 71, 66]
