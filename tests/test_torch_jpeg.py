"""The port's JPEG decoder (`mvsformer_torch/csrc/host/jpeg_decode.cpp`
through `utils/jpeg.py`) against OpenCV's, which the JAX package reads
every scan with.

- Colour and grey (`IMREAD_GRAYSCALE`) reads, bit for bit equal to
  `cv2.imdecode`, of streams that `cv2.imencode` makes from seeded images:
  each chroma sampling (4:4:4, 4:2:2, 4:4:0, 4:2:0) at qualities 50, 90
  and 100, with optimised Huffman tables and with restart intervals, and
  grey streams, at sizes from 1x1 up that cover partial MCUs and the
  upsampler's switch from triangle filtering to replication at a chroma
  width of 2.
- A grey read of a YCbCr stream is its Y plane, which differs from the
  grey of the colour read.
- Refusals, each naming the format: progressive, lossless, arithmetic,
  12-bit, CMYK, RGB, EXIF-rotated and truncated streams.
- Malformed streams (over-subscribed Huffman tables, seeded byte flips and
  truncations) raise ValueError or decode, in a child process that a
  write out of bounds would crash.
- 4 threads decoding 16 streams at once give the serial results.
- tests/fixtures/jpeg/ (made by tools/make_jpeg_fixtures.py, the GPU
  machine's oracle) holds what cv2 decodes here.
- The build: at first use, from the source alone, into build/host/.
"""

import concurrent.futures
import hashlib
import io
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from mvsformer_torch.utils import image as I
from mvsformer_torch.utils import jpeg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "jpeg")
SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
# (height, width): 1x1 and 2x3 (one partial MCU; chroma widths of 1 and 2
# replicate), 3x5 (a chroma width of 3: the triangle filter), 17x9 and
# 61x47 (partial MCUs at both edges), 64x48 (whole MCUs).
SIZES = [(1, 1), (2, 3), (3, 5), (17, 9), (61, 47), (64, 48)]
OPTIONS = {"optimised": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
           "restart_1": [cv2.IMWRITE_JPEG_RST_INTERVAL, 1],
           "restart_3": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]}


def textured(seed, h, w, channels=3):
    """A smooth colour field with noise: uint8 BGR [h, w, 3] or grey [h, w]."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, 3)).astype(np.uint8)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_LINEAR).astype(np.int16)
    img = np.clip(img + rng.integers(-30, 31, img.shape), 0, 255).astype(np.uint8)
    return img if channels == 3 else np.ascontiguousarray(img[..., 1])


def encode(img, quality=90, params=()):
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality, *params])
    assert ok
    return buf.tobytes()


def assert_decodes_as_cv2(stream):
    buf = np.frombuffer(stream, np.uint8)
    want_rgb = cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]
    want_grey = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
    got_rgb, got_grey = jpeg.decode_jpeg(stream, gray=False), jpeg.decode_jpeg(stream, gray=True)
    assert got_rgb.dtype == got_grey.dtype == np.uint8
    assert got_rgb.shape == want_rgb.shape and got_grey.shape == want_grey.shape
    np.testing.assert_array_equal(got_rgb, want_rgb)
    np.testing.assert_array_equal(got_grey, want_grey)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_colour_streams_decode_as_cv2(sampling, quality, size):
    img = textured(quality + size[0] * 100 + size[1], *size)
    assert_decodes_as_cv2(encode(img, quality, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                SAMPLINGS[sampling]]))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_optimised_and_restart_streams_decode_as_cv2(sampling, option, size):
    img = textured(7 + size[0] * 100 + size[1], *size)
    stream = encode(img, 90, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling],
                              *OPTIONS[option]])
    if option.startswith("restart") and size[0] * size[1] > 256:
        assert b"\xff\xdd" in stream and b"\xff\xd0" in stream  # DRI, then RST0
    assert_decodes_as_cv2(stream)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 100])
def test_grey_streams_decode_as_cv2(quality, size):
    stream = encode(textured(size[0] + size[1], *size, channels=1), quality)
    assert stream[stream.index(b"\xff\xc0") + 9] == 1  # one component
    assert_decodes_as_cv2(stream)
    np.testing.assert_array_equal(jpeg.decode_jpeg(stream)[..., 0],
                                  jpeg.decode_jpeg(stream, gray=True))


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_a_grey_read_is_the_y_plane_not_the_grey_of_the_colour_read(tmp_path, sampling):
    """IMREAD_GRAYSCALE of a YCbCr stream is libjpeg's decoded Y plane; the
    OpenCV grey of the colour read (COLOR_BGR2GRAY) is another image, and
    `read_image(..., gray=True)` gives the former."""
    stream = encode(textured(3, 61, 47), 90, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                              SAMPLINGS[sampling]])
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(stream)
    y_plane = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    of_colour = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2GRAY)
    assert (y_plane != of_colour).any()
    np.testing.assert_array_equal(I.read_image(path, gray=True), y_plane)
    np.testing.assert_array_equal(I.read_image(path), cv2.imread(path)[..., ::-1])


def exif_with_orientation(value):
    exif = Image.Exif()
    exif[0x0112] = value
    return exif.tobytes()


def pil_jpeg(img, mode, **kwargs):
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "JPEG", **kwargs)
    return buf.getvalue()


def refused_streams():
    img = textured(5, 40, 56)
    base = encode(img)
    sof = base.index(b"\xff\xc0")
    rgb = np.ascontiguousarray(img[..., ::-1])
    return {
        "progressive": (encode(img, 90, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
                        r"progressive JPEG \(SOF2\)"),
        "lossless": (base[:sof + 1] + b"\xc3" + base[sof + 2:], r"lossless JPEG \(SOF3\)"),
        "arithmetic": (base[:sof + 1] + b"\xc9" + base[sof + 2:], "arithmetic-coded JPEG"),
        "12-bit": (base[:sof + 4] + b"\x0c" + base[sof + 5:], "12-bit JPEG"),
        "CMYK": (pil_jpeg(rgb, "CMYK"), r"4-component \(CMYK/YCCK\) JPEG"),
        "RGB": (pil_jpeg(rgb, "RGB", keep_rgb=True), "RGB JPEG"),
        "EXIF orientation 6": (pil_jpeg(rgb, "RGB", exif=exif_with_orientation(6)),
                               "EXIF orientation 6"),
        "truncated": (base[:len(base) // 2], "truncated or corrupt JPEG"),
        "DNL height 0": (base[:sof + 5] + b"\x00\x00" + base[sof + 7:], "DNL"),
    }


@pytest.mark.parametrize("kind", list(refused_streams()))
def test_refusals_name_the_format(tmp_path, kind):
    stream, match = refused_streams()[kind]
    with pytest.raises(ValueError, match=match):
        jpeg.decode_jpeg(stream)
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(stream)
    with pytest.raises(ValueError, match=f"x.jpg: .*{match}"):
        I.read_image(path, gray=True)


def dht_segment(table, counts):
    """A DHT segment defining `table` (class << 4 | id) with these code
    counts per length and symbols 0, 1, 2, ..."""
    body = bytes([table, *counts, *(i % 256 for i in range(sum(counts)))])
    return b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big") + body


def malformed_streams():
    """Corrupt streams, by name: over-subscribed Huffman tables (more codes
    of a length than its bits hold, or an all-ones code) put before the
    stream's own, seeded byte flips in the headers and in the entropy-coded
    data, and seeded truncations that cut into the data."""
    base = encode(textured(11, 40, 56))
    sos = base.index(b"\xff\xda")
    bad_tables = {"DC 3 codes of length 1": (0x00, [3]),
                  "DC 1 of length 1 and 4 of length 2": (0x00, [1, 4]),
                  "DC 255 codes of length 1": (0x00, [255]),
                  "DC an all-ones code of length 1": (0x00, [2]),
                  "AC 3 codes of length 1": (0x10, [3])}
    cases = {f"Huffman {k}": base[:2] + dht_segment(t, c + [0] * (16 - len(c))) + base[2:]
             for k, (t, c) in bad_tables.items()}
    rng = np.random.default_rng(21)
    for i in range(16):
        pos = int(rng.integers(2, sos) if i < 8 else rng.integers(sos, len(base) - 2))
        flipped = bytearray(base)
        flipped[pos] ^= int(rng.integers(1, 256))
        cases[f"flip {'header' if i < 8 else 'data'} byte {pos}"] = bytes(flipped)
    for cut in sorted(rng.choice(np.arange(2, len(base) - 2), 8, replace=False)):
        cases[f"cut at {cut} of {len(base)}"] = base[:cut]
    return cases


DECODE_EACH = """
import json, sys
from mvsformer_torch.utils import jpeg
out = {}
for name, hexed in json.load(open(sys.argv[1])).items():
    out[name] = []
    for gray in (False, True):
        try:
            img = jpeg.decode_jpeg(bytes.fromhex(hexed), gray=gray)
            out[name].append(["ok", list(img.shape), str(img.dtype)])
        except ValueError as e:
            out[name].append(["ValueError", str(e)])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def malformed_results(tmp_path_factory):
    """Every malformed stream decoded in colour and in grey in one child
    process, so that a decoder which writes out of bounds crashes the child
    and fails these tests instead of the test process."""
    jpeg.library()  # built here, where a failed build shows its message
    path = tmp_path_factory.mktemp("malformed") / "streams.json"
    path.write_text(json.dumps({k: v.hex() for k, v in malformed_streams().items()}))
    proc = subprocess.run([sys.executable, "-c", DECODE_EACH, str(path)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    return json.loads(proc.stdout)


@pytest.mark.parametrize("name", list(malformed_streams()))
def test_a_malformed_stream_raises_or_decodes_and_never_crashes(malformed_results, name):
    """A bad Huffman table and a cut into the data raise ValueError naming
    the fault; a flipped byte raises ValueError or decodes to an image of
    the frame's shape (a flip in the data may still be a valid stream)."""
    for gray, got in zip((False, True), malformed_results[name]):
        if name.startswith("Huffman"):
            assert got == ["ValueError", "corrupt JPEG: bad Huffman table"]
        elif name.startswith("cut"):
            assert got[0] == "ValueError" and "JPEG" in got[1], got
        elif got[0] == "ok":
            assert len(got[1]) == (2 if gray else 3) and got[2] == "uint8", got
        else:
            assert got[0] == "ValueError" and "JPEG" in got[1], got


def test_a_truncated_stream_is_a_partly_grey_image_in_cv2(tmp_path):
    """The documented difference: cv2.imread warns and fills the missing
    MCUs with grey; the port raises."""
    stream = refused_streams()["truncated"][0]
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(stream)
    partial = cv2.imread(path)
    assert partial is not None and (partial == 128).all(axis=2).any()


def test_exif_orientation_1_and_a_missing_eoi_decode_as_cv2_imread(tmp_path):
    """EXIF orientation 1 leaves the image as stored. A stream that ends
    after its last MCU without EOI decodes whole, as cv2.imread decodes it
    (cv2.imdecode refuses it)."""
    rgb = textured(9, 33, 20)[..., ::-1]
    stream = pil_jpeg(np.ascontiguousarray(rgb), "RGB", exif=exif_with_orientation(1))
    assert_decodes_as_cv2(stream)
    cut = encode(textured(9, 33, 20))[:-2]
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(cut)
    np.testing.assert_array_equal(I.read_image(path), cv2.imread(path)[..., ::-1])


def test_threads_decode_at_once_as_serially():
    streams = [encode(textured(s, 96 + 8 * s, 130 - 4 * s), 60 + 2 * s,
                      [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, list(SAMPLINGS.values())[s % 4]])
               for s in range(16)]
    serial = [jpeg.decode_jpeg(s, gray=i % 2 == 1) for i, s in enumerate(streams)]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        threaded = list(pool.map(lambda a: jpeg.decode_jpeg(a[1], gray=a[0] % 2 == 1),
                                 enumerate(streams)))
    for a, b in zip(serial, threaded):
        np.testing.assert_array_equal(a, b)


def load_manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


def fixture_entries():
    m = load_manifest()
    return {**{f"small/{k}": v for k, v in m["small"].items()}, "view0": m["view0"],
            **{f"scan/{k}": v for k, v in m["scan"].items()}}


def sha256(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name", list(fixture_entries()))
def test_the_committed_fixtures_hold_what_cv2_decodes(name):
    """The GPU machine has no cv2: its oracle is these files. Each stream's
    cv2 decodes here match the committed digests (and PNGs), and so do the
    port's."""
    e = fixture_entries()[name]
    with open(os.path.join(FIXTURES, e["jpeg"]), "rb") as f:
        stream = f.read()
    buf = np.frombuffer(stream, np.uint8)
    rgb = cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]
    grey = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
    assert list(grey.shape) == e["shape"]
    assert (sha256(rgb), sha256(grey)) == (e["rgb_sha256"], e["grey_sha256"])
    if "rgb_png" in e:
        np.testing.assert_array_equal(I.read_image(os.path.join(FIXTURES, e["rgb_png"])), rgb)
        np.testing.assert_array_equal(
            I.read_image(os.path.join(FIXTURES, e["grey_png"]), gray=True), grey)
    assert sha256(jpeg.decode_jpeg(stream)) == e["rgb_sha256"]
    assert sha256(jpeg.decode_jpeg(stream, gray=True)) == e["grey_sha256"]


def test_the_fixtures_stay_small():
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, files in os.walk(FIXTURES) for f in files)
    assert total < 1.5e6, total


def test_the_library_is_built_from_the_source_into_build_host():
    path = jpeg.lib_path()
    jpeg.library()
    assert path.is_file() and path.parent == jpeg.BUILD_DIR
    assert path.parent.relative_to(REPO).as_posix() == "build/host"
    assert path.name.startswith("libjpeg_decode-") and path.suffix == ".so"
    assert jpeg.SOURCE.relative_to(REPO).as_posix() == "mvsformer_torch/csrc/host/jpeg_decode.cpp"


def test_without_a_compiler_the_build_raises_naming_what_it_tried(monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match=r"\$CXX is unset and none of c\+\+, g\+\+"):
        jpeg.compiler()
    monkeypatch.setenv("CXX", "/usr/bin/my-c++")
    assert jpeg.compiler() == "/usr/bin/my-c++"
