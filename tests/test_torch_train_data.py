"""The port's training data layer against the JAX package's, on the CPU.

- `utils/image.resize_area_u8` against `cv2.INTER_AREA` at the dataset's
  scales 0.45, 0.5, 0.6 and 0.83 (and at DTU's and BlendedMVS's full
  sizes): bound one grey level, measured equal on every pixel. Against the
  JAX package's C `native.resize_area_u8` where that is INTER_AREA (an
  integer ratio; elsewhere it is a box filter with whole-pixel cells, which
  the JAX dataset does not call: `mvsformer_tpu/data/dtu.py` resizes with
  `cv2.resize`).
- The uint8 HSV conversions against `cv2.cvtColor` and `adjust_hue`
  against the JAX `adjust_hue`: within one grey level.
- `DTUMVSDataset` and `BlendedMVSDataset`, port against JAX, from the same
  seed and called serially in the same order, in training (augment on) and
  validation at two crop sizes: the cameras, depths, masks, depth values
  and file names equal; the images within 2 grey levels after
  normalisation (2 / 255 / 0.225).
- `MVSLoader`: the same index order, host split and crop-size barrels as
  the JAX loader for 3 epochs at 1 and 2 hosts, and the same batches.
- `load_config`: every field of the port's config equals the JAX value for
  the three repo configs, and a config the port saves reads back in the
  JAX package the same.

The synthetic DTU tree is tests/test_data.py's `make_dtu_tree` at 240x320,
with the datasets' base size patched to it as the JAX tests do.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pytest.importorskip("jax")

from mvsformer_tpu import config as jax_config  # noqa: E402
from mvsformer_tpu.data import augment as jax_augment  # noqa: E402
from mvsformer_tpu.data import native  # noqa: E402
from mvsformer_tpu.data.blended import BlendedMVSDataset as JaxBlended  # noqa: E402
from mvsformer_tpu.data.dtu import DTUMVSDataset as JaxDTU  # noqa: E402
from mvsformer_tpu.data.loader import MVSLoader as JaxLoader  # noqa: E402
from mvsformer_torch import config as port_config  # noqa: E402
from mvsformer_torch.data import augment  # noqa: E402
from mvsformer_torch.data.blended import BlendedMVSDataset  # noqa: E402
from mvsformer_torch.data.dtu import DTUMVSDataset  # noqa: E402
from mvsformer_torch.data.loader import MVSLoader  # noqa: E402
from mvsformer_torch.utils.cams import CameraParams, write_cam_file  # noqa: E402
from mvsformer_torch.utils.image import (hsv_to_rgb_u8, resize_area_u8,  # noqa: E402
                                         rgb_to_hsv_u8, write_png)
from mvsformer_torch.utils.pfm import save_pfm  # noqa: E402

from test_data import make_dtu_tree  # noqa: E402
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALES = (0.45, 0.5, 0.6, 0.83)
GREY = 1  # grey levels, uint8
IMG_ATOL = 2.0 / 255.0 / 0.225 + 1e-6  # two grey levels after normalisation
AUG = dict(brightness=0.2, contrast=0.1, saturation=0.1, hue=0.05, min_gamma=0.9, max_gamma=1.1)
CROPS = ([128, 160], [96, 128])


def images(h, w):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = 128 + 100 * np.sin(xx / 7.0 + yy / 11.0)[..., None] * np.array([1.0, 0.6, -0.8])
    return {"noise": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            "smooth": np.clip(smooth, 0, 255).astype(np.uint8)}


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("hw", [(240, 320), (1200, 1600), (1536, 2048)])
def test_resize_area_matches_opencv(hw, scale):
    h, w = hw
    oh, ow = int(h * scale), int(w * scale)
    for name, img in images(h, w).items():
        got = resize_area_u8(img, (oh, ow))
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert got.shape == want.shape
        assert diff.max() <= GREY, (name, diff.max())
        assert (diff > 0).mean() == 0.0, (name, (diff > 0).mean())  # measured: every pixel equal
    gray = images(h, w)["noise"][..., 0]
    assert np.array_equal(resize_area_u8(gray, (oh, ow)),
                          cv2.resize(gray, (ow, oh), interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("scale", SCALES)
def test_resize_area_against_the_native_resize(scale):
    if not native.available():
        pytest.skip("the JAX package's native library is not built")
    h, w = 240, 320
    oh, ow = int(h * scale), int(w * scale)
    img = images(h, w)["smooth"]
    got = resize_area_u8(img, (oh, ow)).astype(int)
    nat = native.resize_area_u8(img, oh, ow).astype(int)
    share = (np.abs(got - nat) > GREY).mean()
    if (h / oh).is_integer() and (w / ow).is_integer():
        assert np.abs(got - nat).max() <= GREY and share == 0.0
    else:  # whole-pixel boxes, not INTER_AREA: most pixels lie more than a level apart
        assert share > 0.5


def test_hsv_conversions_match_opencv():
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (400, 512, 3), dtype=np.uint8)  # rows a multiple of 64 pixels
    hsv = rgb_to_hsv_u8(rgb)
    assert np.array_equal(hsv, cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    assert int(hsv[..., 0].max()) < 180
    got = hsv_to_rgb_u8(hsv).astype(int)
    want = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(int)
    assert np.abs(got - want).max() <= GREY
    # OpenCV's vectorised loop truncates; its scalar tail (a few pixels a
    # row, by the CPU's vector width) rounds: the share that differs is small.
    assert (got != want).any(-1).mean() < 0.02


@pytest.mark.parametrize("offset", [-0.05, -0.013, 0.0, 0.021, 0.05])
def test_adjust_hue_matches_jax(offset):
    img = images(96, 160)["noise"].astype(np.float32) / 255.0
    got = augment.adjust_hue(img, offset)
    want = jax_augment.adjust_hue(img, offset)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got - want).max() <= GREY / 255.0 + 1e-7


def test_jitter_draws_and_applies_like_jax():
    img = images(64, 96)["smooth"].astype(np.float32) / 255.0
    for seed in range(6):
        p = augment.JitterParams.draw(np.random.default_rng(seed), **AUG)
        q = jax_augment.JitterParams.draw(np.random.default_rng(seed), **AUG)
        assert list(p.order) == list(q.order)
        assert (p.brightness, p.contrast, p.saturation, p.hue, p.gamma) == (
            q.brightness, q.contrast, q.saturation, q.hue, q.gamma)
        got, want = augment.apply_jitter(img, p), jax_augment.apply_jitter(img, q)
        assert np.abs(got - want).max() <= 2 * GREY / 255.0 + 1e-6


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    return make_dtu_tree(str(tmp_path_factory.mktemp("dtu")), H=240, W=320)


def write_blended_tree(root, scan="scanA", views=9, h=120, w=160):
    """A BlendedMVS-layout scan by the port's writers: PNG bytes under
    blended_images/*.jpg, cams with a depth count, rendered depth with a
    zero border (the mask), and a pair.txt where view 0 has 8 sources and
    view 1 none."""
    rng = np.random.default_rng(2)
    base = os.path.join(root, scan, scan, scan)
    for d in ("blended_images", "cams", "rendered_depth_maps"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    with open(os.path.join(base, "cams", "pair.txt"), "w") as f:
        f.write(f"{views}\n")
        for ref in range(views):
            srcs = [] if ref == 1 else [v for v in range(views) if v != ref][:8 if ref == 0 else 3]
            f.write(f"{ref}\n{len(srcs)} " + " ".join(f"{s} {50 - i}" for i, s in enumerate(srcs))
                    + "\n")
    K = np.array([[140.0, 0, 80.0], [0, 140.0, 60.0], [0, 0, 1]], np.float32)
    for v in range(views):
        write_png(os.path.join(base, "blended_images", f"{v:0>8}.jpg"),
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        ext = np.eye(4, dtype=np.float32)
        ext[0, 3] = 0.5 * v
        write_cam_file(os.path.join(base, "cams", f"{v:0>8}_cam.txt"),
                       CameraParams(ext, K, 2.0, 0.01, 192.0, 3.92))
        depth = rng.uniform(2.1, 3.5, (h, w)).astype(np.float32)
        depth[:8] = 0.0
        save_pfm(os.path.join(base, "rendered_depth_maps", f"{v:0>8}.pfm"), depth)
    return root


@pytest.fixture(scope="module")
def blended_root(tmp_path_factory):
    return write_blended_tree(str(tmp_path_factory.mktemp("blended")))


def assert_same_sample(a, b):
    for key in ("proj_matrices", "depth", "mask"):
        assert set(a[key]) == set(b[key])
        for s in a[key]:
            assert a[key][s].dtype == b[key][s].dtype, (key, s)
            assert np.array_equal(a[key][s], b[key][s]), (key, s)
    assert np.array_equal(a["depth_values"], b["depth_values"])
    assert a["filename"] == b["filename"]
    assert a["imgs"].shape == b["imgs"].shape and a["imgs"].dtype == b["imgs"].dtype
    assert np.abs(a["imgs"] - b["imgs"]).max() <= IMG_ATOL


def dataset_pair(port_cls, jax_cls, root, scans, mode, crop, base_hw, ndepths=48, **extra):
    kw = dict(nviews=3, ndepths=ndepths, crop=True, augment=True, aug_args=AUG,
              multi_scale=True, multi_scale_args={"scales": [crop], "resize_range": [1.0, 1.2]},
              batch_size=2, height=crop[0], width=crop[1], resize_scale=0.6, seed=7, **extra)
    pair = (port_cls(root, scans, mode, **kw), jax_cls(root, scans, mode, **kw))
    for d in pair:
        d.BASE_H, d.BASE_W = base_hw
        d.reset_dataset(np.arange(len(d)))
    return pair


@pytest.mark.parametrize("crop", CROPS, ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("mode", ["train", "val"])
def test_dtu_samples_match_jax(dtu_root, mode, crop):
    port, ref = dataset_pair(DTUMVSDataset, JaxDTU, dtu_root, ["scan1"], mode, crop, (240, 320))
    assert port.metas == ref.metas
    for i in (0, 9, 3, 20, 34, 9):  # serially, a repeat among them
        assert_same_sample(port[i], ref[i])
    assert port.rng.random() == ref.rng.random()  # the same draws were taken


@pytest.mark.parametrize("crop", [[96, 128], [64, 96]], ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("mode", ["train", "val"])
def test_blended_samples_match_jax(blended_root, mode, crop):
    port, ref = dataset_pair(BlendedMVSDataset, JaxBlended, blended_root, ["scanA"], mode, crop,
                             (120, 160), ndepths=64)
    assert port.metas == ref.metas and len(port) == 8  # view 1 has no sources
    for i in range(len(port)):
        s = port[i]
        assert_same_sample(s, ref[i])
        assert np.array_equal(s["mask"]["stage4"], (s["depth"]["stage4"] > 0).astype(np.float32))
    assert port.rng.random() == ref.rng.random()


def test_consistent_crop_matches_jax(dtu_root):
    port, ref = dataset_pair(DTUMVSDataset, JaxDTU, dtu_root, ["scan1"], "train", [128, 160],
                             (240, 320), consist_crop=True)
    for i in (4, 5):
        assert_same_sample(port[i], ref[i])


@pytest.mark.parametrize("num_hosts", [1, 2])
def test_loader_order_split_and_barrels_match_jax(dtu_root, num_hosts):
    crops = [[64, 96], [96, 128], [128, 160]]
    kw = dict(nviews=3, ndepths=16, crop=True, multi_scale=True,
              multi_scale_args={"scales": crops}, seed=3)
    for host in range(num_hosts):
        pd, jd = DTUMVSDataset(dtu_root, ["scan1"], "train", **kw), \
            JaxDTU(dtu_root, ["scan1"], "train", **kw)
        for drop_last in (True, False):
            pl = MVSLoader(pd, 3, seed=11, host_id=host, num_hosts=num_hosts, drop_last=drop_last)
            jl = JaxLoader(jd, 3, seed=11, host_id=host, num_hosts=num_hosts, drop_last=drop_last)
            for epoch in range(3):
                pl.set_epoch(epoch)
                jl.set_epoch(epoch)
                assert np.array_equal(pl._host_idx, jl._host_idx)
                assert len(pl) == len(jl)
                assert all(pd.crop_size_for(i) == jd.crop_size_for(i)
                           for i in pl._host_idx.tolist())


def test_loader_batches_match_jax(dtu_root):
    kw = dict(nviews=3, ndepths=16, crop=True, augment=True, aug_args=AUG, multi_scale=True,
              multi_scale_args={"scales": [[64, 96], [96, 128]]}, seed=5)
    pd, jd = DTUMVSDataset(dtu_root, ["scan1"], "train", **kw), \
        JaxDTU(dtu_root, ["scan1"], "train", **kw)
    for d in (pd, jd):
        d.BASE_H, d.BASE_W = 240, 320
        d.metas = d.metas[:8]
    pl, jl = MVSLoader(pd, 2, num_workers=1, seed=1), JaxLoader(jd, 2, num_workers=1, seed=1)
    pl.set_epoch(2)
    jl.set_epoch(2)
    got, want = list(pl), list(jl)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a["filename"] == b["filename"]
        assert a["imgs"].shape == b["imgs"].shape
        assert np.abs(a["imgs"] - b["imgs"]).max() <= IMG_ATOL
        assert np.array_equal(a["depth"]["stage1"], b["depth"]["stage1"])
    assert len(pl.load_ms) == 8


def test_loader_raises_what_a_worker_raised(dtu_root):
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError(f"sample {i} is unreadable")

    with pytest.raises(OSError, match="unreadable"):
        list(MVSLoader(Broken(), 2, num_workers=2))


def fields_of(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(fields_of(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = v
    return out


@pytest.mark.parametrize("name", ["config_mvsformer.json", "config_mvsformer-p.json",
                                  "config_mvsformer_blendmvs.json", None])
def test_load_config_matches_jax(name):
    path = os.path.join(REPO, "configs", name) if name else None
    port = fields_of(port_config.load_config(path))
    ref = fields_of(jax_config.load_config(path))
    assert set(port) < set(ref)
    for k, v in port.items():
        assert v == ref[k], k


def test_a_config_the_port_saves_reads_back_in_jax(tmp_path):
    cfg = port_config.load_config(os.path.join(REPO, "configs", "config_mvsformer_blendmvs.json"))
    cfg.name = "round-trip"
    cfg.trainer.save_every_steps = 7
    cfg.data.multi_scale_args.scales = [[64, 96]]
    cfg.arch.vit_args.vit_path = "twins.pth"
    path = str(tmp_path / "config.json")
    port_config.save_config(cfg, path)
    back = fields_of(jax_config.load_config(path))
    for k, v in fields_of(cfg).items():
        assert back[k] == v, k
    assert fields_of(port_config.load_config(path)) == fields_of(cfg)
