"""The port's image codecs and resizes (`mvsformer_torch/utils/image.py`)
against OpenCV, which the JAX package reads, writes and resizes with.

- PNG: every colour type the port reads (grey, RGB, RGBA) and every row
  filter. OpenCV writes the Sub filter on every row, so the other
  filters and their mixes are encoded here row by row and read by both.
- PPM and PGM, `write_png` read back by OpenCV, and the refusals
  (progressive JPEG, 16-bit, palette, grey+alpha, interlaced; the JPEG
  decoder's own cases are tests/test_torch_jpeg.py's).
- Bilinear on uint8 against `cv2.resize` INTER_LINEAR: at most one grey
  level apart, and on at most 20% of the pixels (OpenCV weights in 11-bit
  fixed point; the port in float32; 8-16% measured); equal at equal sizes.
- Nearest against INTER_NEAREST: bit-exact at the stage ratios 2, 4 and 8
  and at DTU's ground-truth ratio (1200x1600 -> 1152x1536), where torch's
  own `mode="nearest"` picks other rows.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvsformer_torch.utils import image as I

torch.set_num_threads(2)

BILINEAR_MAX_DIFF = 1
BILINEAR_MAX_SHARE = 0.2


def filter_rows(img, filters):
    """PNG-filter img [H, W, C] uint8 with filters[y] on row y (numpy, from
    the already known pixels)."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = {0: np.zeros_like(x), 1: a, 2: b, 3: (a + b) >> 1,
            4: np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))}
    out = np.zeros_like(x)
    for k in range(5):
        out = np.where((np.asarray(filters) == k)[:, None, None], x - pred[k], out)
    return (out % 256).astype(np.uint8)


def png_bytes(img, filters, ctype, depth=8, interlace=0, extra=b""):
    h, w, ch = img.shape
    rows = np.concatenate([np.asarray(filters, np.uint8)[:, None],
                           filter_rows(img, filters).reshape(h, w * ch)], axis=1)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (I.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                          interlace))
            + extra + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def image(rng, h, w, ch):
    """Noise over a smooth ramp, so every filter meets both kinds of rows."""
    y, x = np.mgrid[0:h, 0:w]
    ramp = ((3 * x + 5 * y)[..., None] + 40 * np.arange(ch)) % 256
    noise = rng.integers(0, 256, (h, w, ch))
    return np.where(rng.random((h, w, 1)) < 0.5, ramp, noise).astype(np.uint8)


def cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


FILTERS = {"none": [0], "sub": [1], "up": [2], "average": [3], "paeth": [4],
           "mixed": [0, 1, 2, 3, 4, 4, 3, 2, 1, 0, 2, 4]}


@pytest.mark.parametrize("ctype", [0, 2, 6])
@pytest.mark.parametrize("filters", list(FILTERS), ids=str)
def test_png_decoder_matches_cv2_at_every_filter(tmp_path, ctype, filters):
    rng = np.random.default_rng(ctype * 10 + len(filters))
    h, w = 29, 37
    img = image(rng, h, w, {0: 1, 2: 3, 6: 4}[ctype])
    rows = (FILTERS[filters] * h)[:h]
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(png_bytes(img, rows, ctype))
    np.testing.assert_array_equal(I.read_image(path), cv2_rgb(path))
    gray = I.read_image(path, gray=True)
    if ctype == 0:
        np.testing.assert_array_equal(gray, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    else:
        # OpenCV's imread(GRAYSCALE) converts with libpng's weights; the port
        # takes cvtColor's BGR2GRAY whatever the codec.
        np.testing.assert_array_equal(
            gray, cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decoder_reads_cv2_written_files(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = image(rng, 40, 52, channels)
    path = str(tmp_path / "x.png")
    bgr = img[..., [2, 1, 0, 3][:channels]] if channels > 1 else img[..., 0]
    assert cv2.imwrite(path, np.ascontiguousarray(bgr))
    np.testing.assert_array_equal(I.read_image(path), cv2_rgb(path))


def test_png_decoder_takes_several_idat_chunks_and_ancillary_chunks(tmp_path):
    img = image(np.random.default_rng(5), 20, 24, 3)
    data = png_bytes(img, [4] * 20, 2, extra=b"\x00\x00\x00\x01gAMA\x00\x00\x00\x00\x00")
    # split the IDAT in two
    start = data.index(b"IDAT") - 4
    n = struct.unpack(">I", data[start:start + 4])[0]
    body = data[start + 8:start + 8 + n]

    def chunk(kind, b):
        return struct.pack(">I", len(b)) + kind + b + struct.pack(">I", zlib.crc32(kind + b))

    data = data[:start] + chunk(b"IDAT", body[:n // 2]) + chunk(b"IDAT", body[n // 2:]) \
        + data[start + 12 + n:]
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(I.read_image(path), cv2_rgb(path))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_write_png_is_read_back_by_cv2_and_the_port(tmp_path, channels):
    img = image(np.random.default_rng(7), 33, 45, channels)
    path = str(tmp_path / "x.png")
    I.write_png(path, img[..., 0] if channels == 1 else img)
    want = {1: np.repeat(img, 3, axis=2), 3: img, 4: img[..., :3]}[channels]
    np.testing.assert_array_equal(cv2_rgb(path), want)
    np.testing.assert_array_equal(I.read_image(path), want)
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == I.PNG_SIGNATURE


@pytest.mark.parametrize("kind", ["ppm", "pgm"])
def test_pnm_matches_cv2(tmp_path, kind):
    img = image(np.random.default_rng(3), 21, 30, 3 if kind == "ppm" else 1)
    img = img if kind == "ppm" else img[..., 0]
    by_cv2 = str(tmp_path / f"cv2.{kind}")
    assert cv2.imwrite(by_cv2, img[..., ::-1] if kind == "ppm" else img)
    want = cv2_rgb(by_cv2)
    np.testing.assert_array_equal(I.read_image(by_cv2), want)
    # A colour image read as grey: cvtColor's BGR2GRAY (OpenCV's own PPM and
    # PNG readers each convert with other fixed-point weights).
    want_gray = (cv2.imread(by_cv2, cv2.IMREAD_GRAYSCALE) if kind == "pgm" else
                 cv2.cvtColor(cv2.imread(by_cv2, cv2.IMREAD_COLOR), cv2.COLOR_BGR2GRAY))
    np.testing.assert_array_equal(I.read_image(by_cv2, gray=True), want_gray)
    # a comment in the header, as other writers put one
    commented = str(tmp_path / f"commented.{kind}")
    with open(by_cv2, "rb") as f:
        data = f.read()
    with open(commented, "wb") as f:
        f.write(data[:3] + b"# made by a test\n" + data[3:])
    np.testing.assert_array_equal(cv2_rgb(commented), want)
    np.testing.assert_array_equal(I.read_image(commented), want)


def test_the_file_name_does_not_pick_the_codec(tmp_path):
    img = image(np.random.default_rng(9), 16, 16, 3)
    path = str(tmp_path / "00000000.jpg")
    I.write_png(path, img)
    np.testing.assert_array_equal(I.read_image(path), img)
    np.testing.assert_array_equal(cv2_rgb(path), img)


def refusal_files(tmp_path):
    rng = np.random.default_rng(11)
    jpeg = str(tmp_path / "x.jpg")
    cv2.imwrite(jpeg, image(rng, 16, 16, 3), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    deep = str(tmp_path / "deep.png")
    cv2.imwrite(deep, (rng.integers(0, 65535, (8, 8))).astype(np.uint16))
    out = {"JPEG": jpeg, "16-bit": deep}
    for name, ch, kwargs in (("palette", 1, dict(ctype=3)), ("grey+alpha", 2, dict(ctype=4)),
                             ("interlaced", 1, dict(ctype=0, interlace=1))):
        out[name] = str(tmp_path / f"{name}.png")
        with open(out[name], "wb") as f:
            f.write(png_bytes(image(rng, 8, 8, ch), [0] * 8, **kwargs))
    out["ASCII PNM"] = str(tmp_path / "ascii.ppm")
    with open(out["ASCII PNM"], "w") as f:
        f.write("P3\n1 1\n255\n1 2 3\n")
    out["BMP"] = str(tmp_path / "x.bmp")
    cv2.imwrite(out["BMP"], image(rng, 4, 4, 3))
    return out


@pytest.mark.parametrize("kind,match", [
    ("JPEG", "JPEG"), ("16-bit", "16-bit"), ("palette", "palette"),
    ("grey+alpha", "grey\\+alpha"), ("interlaced", "interlaced"),
    ("ASCII PNM", "not a PNG, PPM or PGM"), ("BMP", "not a PNG, PPM or PGM")])
def test_refusals_name_the_format(tmp_path, kind, match):
    path = refusal_files(tmp_path)[kind]
    with pytest.raises(ValueError, match=match):
        I.read_image(path)


@pytest.mark.parametrize("in_hw,out_hw", [((64, 80), (48, 64)), ((150, 200), (144, 192)),
                                          ((48, 64), (96, 128)), ((37, 53), (64, 64))],
                         ids=["80x64to64x48", "dtu_ratio_toy_crop", "up2", "odd"])
@pytest.mark.parametrize("channels", [1, 3])
def test_bilinear_u8_within_one_grey_level_of_cv2(in_hw, out_hw, channels):
    """(150, 200) -> (144, 192) is DTU's 1200x1600 -> 1152x1536 at an eighth."""
    img = image(np.random.default_rng(13), *in_hw, channels)[..., :channels]
    img = img[..., 0] if channels == 1 else img
    got = I.resize_bilinear_u8(img, out_hw).numpy()
    want = cv2.resize(img, out_hw[::-1], interpolation=cv2.INTER_LINEAR)
    diff = np.abs(got.astype(np.int16) - want)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert diff.max() <= BILINEAR_MAX_DIFF, diff.max()
    assert (diff > 0).mean() <= BILINEAR_MAX_SHARE, (diff > 0).mean()
    # the same half-pixel map as torch's bilinear (align_corners=False,
    # no antialias), before rounding
    ref = F.interpolate(torch.from_numpy(img).float().reshape(1, *in_hw, -1).permute(0, 3, 1, 2),
                        size=out_hw, mode="bilinear", align_corners=False, antialias=False)
    ref = torch.floor(ref + 0.5).clamp(0, 255).permute(0, 2, 3, 1).reshape(got.shape)
    assert (np.abs(ref.numpy() - got) <= 1).all()


def test_bilinear_u8_at_equal_sizes_is_the_identity_as_in_cv2():
    img = image(np.random.default_rng(17), 40, 56, 3)
    np.testing.assert_array_equal(I.resize_bilinear_u8(img, (40, 56)).numpy(), img)
    np.testing.assert_array_equal(cv2.resize(img, (56, 40)), img)


@pytest.mark.parametrize("in_hw,out_hw", [((8, 8), (16, 16)), ((16, 20), (64, 80)),
                                          ((8, 10), (64, 80)), ((144, 192), (1152, 1536)),
                                          ((1200, 1600), (1152, 1536)), ((300, 400), (128, 160))],
                         ids=["ratio2", "ratio4", "ratio8", "stage1_dtu", "dtu_gt", "down"])
def test_nearest_is_bit_exact_to_cv2(in_hw, out_hw):
    x = np.random.default_rng(19).standard_normal(in_hw).astype(np.float32)
    got = I.resize_nearest(x, out_hw).numpy()
    want = cv2.resize(x, out_hw[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(got, want)
    stacked = np.stack([x, -x], axis=-1)  # channels last ride along
    np.testing.assert_array_equal(I.resize_nearest(stacked, out_hw).numpy()[..., 1], -want)


def test_torch_nearest_picks_other_rows_at_the_dtu_gt_ratio():
    """Why the port computes the index itself: torch's float32 scale flips
    indices where OpenCV's float64 does not."""
    x = np.arange(1200 * 1600, dtype=np.float32).reshape(1200, 1600)
    want = cv2.resize(x, (1536, 1152), interpolation=cv2.INTER_NEAREST)
    torch_nearest = F.interpolate(torch.from_numpy(x)[None, None], size=(1152, 1536),
                                  mode="nearest")[0, 0].numpy()
    assert not np.array_equal(torch_nearest, want)
    np.testing.assert_array_equal(I.resize_nearest(x, (1152, 1536)).numpy(), want)
