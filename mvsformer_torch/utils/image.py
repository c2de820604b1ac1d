"""Image files and resizes, without an image library.

The machine with the card has no `cv2`, `PIL` or `torchvision`, so the port
keeps its own codecs (stdlib `zlib` and numpy) and writes out the two resizes
that the JAX package takes from `cv2.resize`.

Reading (`read_image`) sniffs the file's first bytes, as `cv2.imread` does,
not its extension:
- PNG: 8-bit, non-interlaced, colour types 0 (grey), 2 (RGB) and 6
  (RGBA), with all five row filters; alpha is dropped.
- Binary PPM (P6) and PGM (P5) with a maxval up to 255.
- Anything else raises `ValueError` naming the format: 16-bit, palette,
  grey+alpha or interlaced PNG, and JPEG, which the port does not decode
  (ROADMAP A3).

It returns RGB uint8 [H, W, 3], or grey [H, W] with `gray=True`; a colour
image read as grey takes OpenCV's `COLOR_BGR2GRAY` weights and rounding.

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
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PNG_ZLIB_LEVEL = 1  # fast: the port writes its PNGs to read them back soon
JPEG_ITEM = ("ROADMAP A3: a baseline JPEG decoder the port keeps itself, or a "
             "one-off conversion of the scans to PNG")
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
        raise ValueError(f"{path}: a JPEG stream; the port does not decode JPEG ({JPEG_ITEM})")
    else:
        raise ValueError(f"{path}: not a PNG, PPM or PGM file (starts {data[:8]!r})")
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
