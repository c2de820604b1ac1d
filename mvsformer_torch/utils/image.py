"""Image files and resizes, without an image library.

The machine with the card has no `cv2`, `PIL` or `torchvision`, so the port
keeps its own codecs (stdlib `zlib`, numpy and a host C++ JPEG decoder) and
writes out the two resizes that the JAX package takes from `cv2.resize`.

Reading (`read_image`) sniffs the file's first bytes, as `cv2.imread` does,
not its extension:
- JPEG (`utils/jpeg.py`): baseline and extended sequential, Huffman-coded,
  8-bit, grey or YCbCr in one scan at 4:4:4, 4:2:2, 4:4:0 or 4:2:0, with
  restart intervals and optimised tables, decoded bit for bit as
  `cv2.imread` decodes it (libjpeg-turbo's integer IDCT, upsampling and
  colour tables). A grey read of a YCbCr JPEG is its Y plane, as
  `IMREAD_GRAYSCALE` gives it, not the grey of the colour read.
- PNG: 8-bit, non-interlaced, colour types 0 (grey), 2 (RGB) and 6
  (RGBA), with all five row filters; alpha is dropped.
- Binary PPM (P6) and PGM (P5) with a maxval up to 255.
- Anything else raises `ValueError` naming the format: progressive,
  lossless, arithmetic-coded, hierarchical, 12-bit, CMYK and RGB JPEG, a
  JPEG whose EXIF orientation would turn it, and a truncated JPEG (where
  cv2.imread returns a partly grey image); 16-bit, palette, grey+alpha or
  interlaced PNG.

It returns RGB uint8 [H, W, 3], or grey [H, W] with `gray=True`; a colour
PNG or PPM read as grey takes OpenCV's `COLOR_BGR2GRAY` weights and
rounding.

Writing (`write_png`) uses the Up filter on every row and a fast zlib level,
which `read_image` undoes in a handful of whole-image numpy calls.

The resizes follow OpenCV's sampling conventions:
- `resize_bilinear_u8` (`INTER_LINEAR` on uint8 images): source coordinate
  (d + 0.5) * in / out - 0.5, clamped at both borders, no antialias,
  rounded half up to uint8. OpenCV weights in 11-bit fixed point, so the two
  can differ by one grey level; at equal sizes both are the identity.
- `resize_nearest` (`INTER_NEAREST`): source index floor(d * (1 / (out /
  in))) in float64, as OpenCV computes it, clamped to in - 1. This is
  torch's `mode="nearest"`, whose float32 scale can flip an index where
  the product lands on an integer.
- `resize_area_u8` (`INTER_AREA` on uint8 images, shrinking only; numpy
  in, numpy out, for the training loader's threads). Where in / out is an integer k
  on both axes, each output is the mean of its k x k block: the sum times
  the float32 1 / k^2, rounded half to even, except at k = 2, where it is
  (sum + 2) >> 2. Otherwise each axis takes OpenCV's area table: output d
  covers [d s, d s + s) with s = 1 / (out / in) in float64, and weighs each
  source pixel by its overlap over s (float32 weights; partial cells under
  1e-3 are dropped); the rows are summed first, then the columns, in
  float32, and rounded half to even. Within one grey level of `cv2.resize`
  (tests/test_torch_train_data.py states the share that differs).

The colour conversions follow OpenCV's uint8 HSV, with hue in [0, 180):
- `rgb_to_hsv_u8` (`COLOR_RGB2HSV`): V = max, S = diff * round(255 * 2^12 /
  V) >> 12 and H from the max channel's sector times round(180 * 2^12 / (6
  diff)), each rounded by adding 2^11 before the shift (an arithmetic
  shift, so a negative H floors, then wraps by 180).
- `hsv_to_rgb_u8` (`COLOR_HSV2RGB`): OpenCV's float32 sector formula on
  h * 6 / 180, s / 255 and v / 255 (1 - s h and 1 - s (1 - h) in one
  rounding, as a fused multiply-add gives them), times 255 and truncated,
  as OpenCV's vectorised loop computes it. OpenCV takes the last pixels of each row
  (fewer than its vector width) through a scalar loop that rounds instead,
  so there the two can differ by one grey level.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np
import torch

from mvsformer_torch.utils.jpeg import decode_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PNG_ZLIB_LEVEL = 1  # fast: the port writes its PNGs to read them back soon
# OpenCV's COLOR_BGR2GRAY for uint8: (R*9798 + G*19235 + B*3735 + 2^14) >> 15.
_GRAY_WEIGHTS = (9798, 19235, 3735)
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}


def read_image(path: str, gray: bool = False) -> np.ndarray:
    """Decode the image at `path`: RGB uint8 [H, W, 3], or [H, W] if gray."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        img = decode_png(data)
    elif data[:2] in (b"P5", b"P6"):
        img = decode_pnm(data)
    elif data[:2] == b"\xff\xd8":
        try:
            return decode_jpeg(data, gray)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    else:
        raise ValueError(f"{path}: not a PNG, PPM or PGM file, nor a JPEG stream "
                         f"(starts {data[:8]!r})")
    return to_gray(img) if gray else to_rgb(img)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """[H, W, C] with C = 1 (grey), 3 (RGB) or 4 (RGBA) -> RGB [H, W, 3]."""
    if img.shape[2] == 1:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def to_gray(img: np.ndarray) -> np.ndarray:
    """[H, W, C] -> grey [H, W] with OpenCV's BGR2GRAY fixed-point weights."""
    if img.shape[2] == 1:
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3].astype(np.int32)
    wr, wg, wb = _GRAY_WEIGHTS
    y = rgb[..., 0] * wr + rgb[..., 1] * wg + rgb[..., 2] * wb
    return ((y + (1 << 14)) >> 15).astype(np.uint8)


# ---- PNG ------------------------------------------------------------------

def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit non-interlaced PNG -> uint8 [H, W, C] as stored (C = 1, 3
    or 4)."""
    pos, idat, header = len(PNG_SIGNATURE), [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype == 3:
        raise ValueError("palette PNG (colour type 3) is not supported")
    if ctype == 4:
        raise ValueError("grey+alpha PNG (colour type 4) is not supported")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not supported")
    if depth != 8:
        raise ValueError(f"{depth}-bit PNG is not supported; only 8-bit")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    ch = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = width * ch + 1
    if raw.size < height * stride:
        raise ValueError("truncated PNG image data")
    rows = raw[:height * stride].reshape(height, stride)
    filters = rows[:, 0]
    if int(filters.max(initial=0)) > 4:
        raise ValueError(f"PNG row filter {int(filters.max())} is not defined")
    return unfilter(rows[:, 1:].reshape(height, width, ch), filters)


def unfilter(filt: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters: filt [H, W, C] uint8 (each row's filtered
    bytes), filters [H] in 0-4 (None, Sub, Up, Average, Paeth). Files
    without Average or Paeth rows, the port's own among them, take the row
    path: for the Up rows of a 1600x1200 RGB image it is over ten times
    faster than the wavefront, which every other file needs
    (`chip_smoke.py` times both on the GPU machine's host)."""
    if np.isin(filters, (3, 4)).any():
        return _unfilter_wavefront(filt, filters)
    return _unfilter_rows(filt, filters)


def _unfilter_rows(filt, filters):
    """None, Sub and Up only. Sub is a cumulative sum along the row (mod 256),
    None and Sub rows then stand alone, and each run of Up rows adds onto the
    row before it: a cumulative sum down the rows, restarted at every row
    that is not Up."""
    h = filt.shape[0]
    x = filt.copy()
    sub = filters == 1
    if sub.any():
        x[sub] = np.cumsum(filt[sub], axis=1, dtype=np.uint8)
    up = filters == 2
    if not up.any():
        return x
    total = np.cumsum(x, axis=0, dtype=np.uint8)
    if up[1:].all():  # the first row stands alone whatever its filter
        return total
    # The row each run of Up rows builds on: the last row at or above that
    # is not Up (-1 above the image, where the row before is zero).
    base = np.maximum.accumulate(np.where(up, -1, np.arange(h)))
    before = np.zeros_like(x)
    before[1:] = total[:-1]
    start = np.where(base >= 0, base, 0)
    return total - np.where((base >= 0)[:, None, None], before[start], 0).astype(np.uint8)


def _unfilter_wavefront(filt, filters):
    """Every filter, by anti-diagonals: the pixel (y, x) needs only (y, x-1),
    (y-1, x) and (y-1, x-1), which lie on the diagonal before it (d - 1) or
    the one before that, so one diagonal is decoded at a time, whatever each
    row's filter is. Diagonals are stored skewed, diag[d, y + 1] = pixel (y,
    d - y), with a zero row 0 for the row above the image and zeros for
    pixels left of it."""
    h, w, ch = filt.shape
    nd = h + w - 1
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    skewed = np.zeros((nd, h + 1, ch), np.int16)
    skewed[(ys + xs).ravel(), (ys + 1).ravel()] = filt.reshape(-1, ch)
    diag = np.zeros((nd + 1, h + 1, ch), np.int16)  # diag[-1] is the zero diagonal
    f = filters.astype(np.int16)
    kinds = {k: (f == k)[:, None] for k in range(5) if (f == k).any()}
    for d in range(nd):
        lo, hi = max(0, d - w + 1), min(h - 1, d)
        prev, prev2 = diag[d - 1], diag[d - 2]
        a = prev[lo + 1:hi + 2]  # (y, x - 1)
        b = prev[lo:hi + 1]      # (y - 1, x)
        pred = np.zeros_like(a)
        sel = slice(lo, hi + 1)
        if 1 in kinds:
            pred = np.where(kinds[1][sel], a, pred)
        if 2 in kinds:
            pred = np.where(kinds[2][sel], b, pred)
        if 3 in kinds:
            pred = np.where(kinds[3][sel], (a + b) >> 1, pred)
        if 4 in kinds:
            c = prev2[lo:hi + 1]  # (y - 1, x - 1)
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            pred = np.where(kinds[4][sel], paeth, pred)
        np.bitwise_and(skewed[d, lo + 1:hi + 2] + pred, 255, out=diag[d, lo + 1:hi + 2])
    return diag[(ys + xs), ys + 1].astype(np.uint8)


def write_png(path: str, img) -> None:
    """uint8 [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> an 8-bit
    PNG with the Up filter on every row, compressed at zlib level
    `PNG_ZLIB_LEVEL`."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(ch)
    if ctype is None:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, not {ch}")
    rows = np.empty((h, 1 + w * ch), np.uint8)
    rows[:, 0] = 2
    flat = img.reshape(h, w * ch)
    rows[0, 1:] = flat[0]
    rows[1:, 1:] = flat[1:] - flat[:-1]  # uint8 arithmetic wraps mod 256

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), PNG_ZLIB_LEVEL)))
        f.write(chunk(b"IEND", b""))


# ---- PPM / PGM ------------------------------------------------------------

def decode_pnm(data: bytes) -> np.ndarray:
    """Binary PGM (P5) or PPM (P6) with maxval <= 255 -> uint8 [H, W, 1|3]."""
    fields, pos = [], 2
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    width, height, maxval = fields
    if maxval > 255:
        raise ValueError(f"16-bit PNM (maxval {maxval}) is not supported")
    ch = 3 if data[:2] == b"P6" else 1
    n = width * height * ch
    pixels = np.frombuffer(data, np.uint8, count=n, offset=pos + 1)
    return pixels.reshape(height, width, ch).copy()


# ---- Resizes --------------------------------------------------------------

def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """OpenCV's INTER_NEAREST source index along one axis, in float64."""
    inv = 1.0 / (n_out / n_in)
    return np.minimum(np.floor(np.arange(n_out) * inv).astype(np.int64), n_in - 1)


def resize_nearest(img, out_hw) -> torch.Tensor:
    """Nearest resize of the first two axes of [H, W] or [H, W, C] (a tensor
    or an array; any dtype) to out_hw = (H', W')."""
    t = torch.as_tensor(img)
    oh, ow = out_hw
    iy = torch.from_numpy(nearest_index(t.shape[0], oh)).to(t.device)
    ix = torch.from_numpy(nearest_index(t.shape[1], ow)).to(t.device)
    return t.index_select(0, iy).index_select(1, ix)


def _linear_taps(n_in: int, n_out: int):
    """(i0, i1, w1) per output along one axis: the half-pixel source
    coordinate, clamped to [0, n_in - 1] as OpenCV clamps it."""
    s = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(s)
    w1 = s - i0
    low, high = i0 < 0, i0 >= n_in - 1
    i0 = np.where(low, 0, np.where(high, n_in - 1, i0)).astype(np.int64)
    w1 = np.where(low | high, 0.0, w1).astype(np.float32)
    return i0, np.minimum(i0 + 1, n_in - 1), w1


def resize_bilinear_u8(img, out_hw) -> torch.Tensor:
    """Bilinear resize of a uint8 image [H, W] or [H, W, C] to out_hw, as
    OpenCV's INTER_LINEAR computes it up to one grey level; rows first,
    then columns, in float32, rounded half up."""
    t = torch.as_tensor(img)
    if t.dtype != torch.uint8:
        raise ValueError(f"resize_bilinear_u8 takes uint8 images, not {t.dtype}")
    oh, ow = out_hw
    if (oh, ow) == tuple(t.shape[:2]):
        return t.clone()
    dev = t.device
    y0, y1, wy = (torch.from_numpy(a).to(dev) for a in _linear_taps(t.shape[0], oh))
    x0, x1, wx = (torch.from_numpy(a).to(dev) for a in _linear_taps(t.shape[1], ow))
    f = t.float()
    shape_y = (-1,) + (1,) * (f.dim() - 1)
    shape_x = (1, -1) + (1,) * (f.dim() - 2)
    rows = torch.lerp(f.index_select(0, y0), f.index_select(0, y1), wy.reshape(shape_y))
    out = torch.lerp(rows.index_select(1, x0), rows.index_select(1, x1), wx.reshape(shape_x))
    return torch.floor(out + 0.5).clamp_(0, 255).to(torch.uint8)


def _area_taps(n_in: int, n_out: int):
    """OpenCV's INTER_AREA table along one axis: (index [n_out, K], weight
    [n_out, K] float32), padded with weight 0 at index 0."""
    scale = 1.0 / (n_out / n_in)
    rows = []
    for d in range(n_out):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, n_in - fs1)
        s2 = min(math.floor(fs2), n_in - 1)
        s1 = min(math.ceil(fs1), s2)
        taps = []
        if s1 - fs1 > 1e-3:
            taps.append((s1 - 1, (s1 - fs1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            taps.append((s2, min(min(fs2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((n_out, k), np.int64)
    wgt = np.zeros((n_out, k), np.float32)
    for d, taps in enumerate(rows):
        for j, (i, w) in enumerate(taps):
            idx[d, j], wgt[d, j] = i, w
    return idx, wgt


def resize_area_u8(img: np.ndarray, out_hw) -> np.ndarray:
    """Shrink a uint8 image [H, W] or [H, W, C] to out_hw = (H', W') as
    OpenCV's INTER_AREA does (see the module docstring). Returns uint8."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_area_u8 takes uint8 images, not {img.dtype}")
    h, w = img.shape[:2]
    oh, ow = out_hw
    if oh > h or ow > w:
        raise ValueError(f"resize_area_u8 shrinks only: {(h, w)} -> {(oh, ow)}")
    sy, sx = 1.0 / (oh / h), 1.0 / (ow / w)
    ky, kx = round(sy), round(sx)
    eps = np.finfo(np.float64).eps
    if abs(sy - ky) < eps and abs(sx - kx) < eps:
        total = sum(img[i:oh * ky:ky, j:ow * kx:kx].astype(np.int32)
                    for i in range(ky) for j in range(kx))
        if ky == 2 and kx == 2:
            return ((total + 2) >> 2).astype(np.uint8)
        out = np.rint(total.astype(np.float32) * np.float32(1.0 / (ky * kx)))
        return np.clip(out, 0, 255).astype(np.uint8)
    yi, yw = (torch.from_numpy(a) for a in _area_taps(h, oh))
    xi, xw = (torch.from_numpy(a) for a in _area_taps(w, ow))
    src = torch.from_numpy(np.ascontiguousarray(img))
    tail = (1,) * (img.ndim - 2)
    cols = src.index_select(1, xi[:, 0]).float() * xw[:, 0].reshape(1, -1, *tail)
    for j in range(1, xi.shape[1]):
        cols += src.index_select(1, xi[:, j]).float() * xw[:, j].reshape(1, -1, *tail)
    out = cols.index_select(0, yi[:, 0]) * yw[:, 0].reshape(-1, 1, *tail)
    for j in range(1, yi.shape[1]):
        out += cols.index_select(0, yi[:, j]) * yw[:, j].reshape(-1, 1, *tail)
    return torch.round(out).clamp_(0, 255).to(torch.uint8).numpy()


_HSV_SHIFT = 12
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / np.arange(1, 256))]).astype(np.int32)
_HDIV180 = np.concatenate(
    [[0], np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256)))]).astype(np.int32)
# OpenCV's sector table: which of (v, p, q, t) is (b, g, r) in each sixth of the hue circle.
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """RGB uint8 [..., 3] -> HSV uint8 [..., 3] as cv2.COLOR_RGB2HSV: hue
    in [0, 180), saturation and value in [0, 255]."""
    rgb = np.asarray(img).astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """HSV uint8 [..., 3] (hue in [0, 180)) -> RGB uint8 as
    cv2.COLOR_HSV2RGB's vectorised loop computes it (see the module
    docstring)."""
    hsv = np.asarray(hsv)
    one, inv255 = np.float32(1.0), np.float32(1.0 / 255.0)
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)
    s = hsv[..., 1].astype(np.float32) * inv255
    v = hsv[..., 2].astype(np.float32) * inv255
    sector = np.trunc(h)
    h = h - sector

    def one_minus(a, b):  # 1 - a * b in one rounding, as a fused multiply-add gives it
        return (1.0 - a.astype(np.float64) * b).astype(np.float32)

    tab = np.stack([v, v * (one - s), v * one_minus(s, h), v * one_minus(s, one - h)], -1)
    picks = _SECTORS[sector.astype(np.int64) % 6]  # [..., 3]: (b, g, r) as indices into tab
    bgr = np.take_along_axis(tab, picks, axis=-1) * np.float32(255.0)
    return np.clip(np.trunc(bgr[..., ::-1]), 0, 255).astype(np.uint8)
