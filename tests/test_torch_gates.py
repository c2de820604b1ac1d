"""The accuracy gates' committed scenes, their writers and the port's gate
loop, against the JAX gates (CPU, cheap: no JAX gradient is compiled).

The four gates themselves train for minutes and are `slow`
(tests/test_torch_geometric_e2e.py, tests/test_torch_convergence.py);
`chip_smoke.py` phase 19 runs them on the card from the committed fixtures
(tests/fixtures/gates/, `python tools/make_gate_fixtures.py`), since the
card's machine has neither cv2 nor JAX to render them. Here:
- the committed views are what tests/test_geometric_e2e.py
  `_render_views` renders now: the port's decode of each committed stream
  is `cv2.imdecode` of a fresh quality-100 encode of the render, bit for
  bit;
- the committed scenes (`chip_smoke.plane_scenes`) are
  tests/test_convergence.py `make_scene`'s, bit for bit, and
  `chip_smoke`'s copies of the gates' constants are the JAX tests';
- every digest in the manifest holds;
- the port's `MVSEvalDataset` over `chip_smoke.write_plane_scan` /
  `write_plane_scan_tt` gives the JAX `MVSEvalDataset`'s items over
  `_make_plane_scan` / `_make_plane_scan_tt` (dtu; tt with the short-range
  cams and the per-scan interval): projections, depth values, ground truth
  and mask equal, images within one grey level (the 128 -> 64 resize,
  tests/test_torch_pipeline.py's bound); the written files but the PNG
  masks are the JAX writers' bytes;
- phase 19's pipeline thresholds are the JAX gates', each strict;
- one step of the port's gate loop gives a finite loss and moves the
  weights, and its best-weights copy is not the live parameters.
"""

import hashlib
import os

import cv2
import numpy as np
import pytest
import torch

from mvsformer_tpu.data import eval_dataset as jax_eval
from mvsformer_torch.data import eval_dataset as port_eval
from mvsformer_torch.models.mvsformer import build_model, random_init_
from mvsformer_torch.utils.jpeg import decode_jpeg

import chip_smoke
from tests import test_convergence as conv
from tests import test_geometric_e2e as geo
from test_torch_pipeline import IMG_ATOL

torch.set_num_threads(4)

CONSTANTS = [  # chip_smoke's copy, the JAX test's
    ("GATE_IMG", geo.IH), ("GATE_IMG", geo.IW), ("GATE_HW", geo.EH), ("GATE_HW", geo.EW),
    ("GATE_NV", geo.NV), ("GATE_FX", geo.FX), ("GATE_DEPTH", geo.DEPTH),
    ("GATE_DMIN", geo.DMIN), ("GATE_DITV", geo.DITV), ("GATE_ND", geo.ND),
    ("CONV_HW", conv.H), ("CONV_HW", conv.W), ("CONV_FX", conv.FX),
]
DATASETS = {
    "dtu": dict(dataset="dtu", interval_scale=1.0),
    "tt_short_range": dict(dataset="tt", interval_scale={"scan1": 1.0}, use_short_range=True),
}


@pytest.fixture(scope="module")
def rendered():
    imgs, txs, _ = geo._render_views()
    assert txs == [chip_smoke.GATE_TX * v for v in range(chip_smoke.GATE_NV)]
    return imgs


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """{name: (the port's scan root, the JAX gate's)}, written from the
    committed views and from a fresh render."""
    root = tmp_path_factory.mktemp("gate_scans")
    views = chip_smoke.gate_views()
    return {
        "dtu": (chip_smoke.write_plane_scan(str(root / "port_dtu" / "eval"), views),
                geo._make_plane_scan(str(root / "jax_dtu" / "eval"))),
        "tt_short_range": (chip_smoke.write_plane_scan_tt(str(root / "port_tt" / "tteval"),
                                                          views),
                           geo._make_plane_scan_tt(str(root / "jax_tt" / "tteval"))),
    }


@pytest.mark.parametrize("name,want", CONSTANTS)
def test_gate_constants_are_the_jax_tests(name, want):
    assert getattr(chip_smoke, name) == want


@pytest.mark.parametrize("v", range(5))
def test_committed_view_is_the_jax_render(rendered, v):
    bgr = cv2.cvtColor((rendered[v] * 255).astype(np.uint8), cv2.COLOR_RGB2BGR)
    ok, fresh = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 100])
    assert ok
    want = cv2.imdecode(fresh, cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(decode_jpeg(chip_smoke.gate_views()[v]), want)


def assert_scene_equal(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        pairs = [(g[k], w[k]) for k in w] if isinstance(w, dict) else [(g, w)]
        if isinstance(w, dict):
            assert g.keys() == w.keys()
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_committed_scenes_are_make_scene():
    scenes, one = chip_smoke.plane_scenes()
    rng = np.random.default_rng(0)
    assert len(scenes) == len(chip_smoke.CONV_DEPTHS) == 4
    for depth, got in zip(chip_smoke.CONV_DEPTHS, scenes):
        assert_scene_equal(got, conv.make_scene(rng, depth))
    assert_scene_equal(one, conv.make_scene(np.random.default_rng(1), chip_smoke.CONV_DEPTH1))


def test_manifest_digests_hold():
    m = chip_smoke.gate_manifest()
    here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        chip_smoke.GATE_FIXTURES)
    names = sorted(os.listdir(here))
    assert names == sorted(list(m["views"]) + ["scenes.npz", "manifest.json"])
    for name, entry in m["views"].items():
        with open(os.path.join(here, name), "rb") as f:
            data = f.read()
        assert hashlib.sha256(data).hexdigest() == entry["sha256"], name
        assert chip_smoke.sha256_of(decode_jpeg(data)) == entry["rgb_sha256"], name
    with open(os.path.join(here, "scenes.npz"), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == m["scenes"]["file_sha256"]
    scenes, one = chip_smoke.plane_scenes()
    assert [chip_smoke.sha256_of(s[0]) for s in scenes] == m["scenes"]["imgs_sha256"]["rng0"]
    assert [chip_smoke.sha256_of(one[0])] == m["scenes"]["imgs_sha256"]["rng1"]
    assert m["scenes"]["depths"] == {"rng0": list(chip_smoke.CONV_DEPTHS),
                                     "rng1": [chip_smoke.CONV_DEPTH1]}


def test_a_tampered_fixture_is_refused():
    with pytest.raises(RuntimeError, match="not the file its manifest names"):
        chip_smoke.gate_file("00000000.jpg", "0" * 64)


@pytest.mark.parametrize("name", list(DATASETS))
def test_eval_dataset_over_the_ports_writers_matches_jax(scans, name):
    port_root, jax_root = scans[name]
    kw = dict(nviews=chip_smoke.GATE_NUM_VIEW, ndepths=chip_smoke.GATE_ND,
              max_h=chip_smoke.GATE_HW, max_w=chip_smoke.GATE_HW, **DATASETS[name])
    jds = jax_eval.MVSEvalDataset(jax_root, ["scan1"], **kw)
    tds = port_eval.MVSEvalDataset(port_root, ["scan1"], **kw)
    assert jds.metas == tds.metas and len(tds) == chip_smoke.GATE_NV
    for i in range(len(tds)):
        j, t = jds[i], tds[i]
        assert j.keys() == t.keys() and t["filename"] == j["filename"]
        for k in j["proj_matrices"]:
            np.testing.assert_array_equal(t["proj_matrices"][k], j["proj_matrices"][k], err_msg=k)
        np.testing.assert_array_equal(t["depth_values"], j["depth_values"])
        for k in ("depth_gt", "mask"):
            assert (k in j) == (k in t) == (name == "dtu")
            if k in j:
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert t["imgs"].dtype == np.float32 and t["imgs"].shape == j["imgs"].shape
        np.testing.assert_allclose(t["imgs"], j["imgs"], rtol=0, atol=IMG_ATOL)
    # The depths start where the gate needs them: at 40, also in the T&T
    # layout, whose long-range cams start 60 past it.
    assert float(tds[0]["depth_values"][0]) == chip_smoke.GATE_DMIN


@pytest.mark.parametrize("name", list(DATASETS))
def test_the_ports_writers_write_the_jax_gates_files(scans, name):
    port_root, jax_root = scans[name]
    port_root, jax_root = os.path.dirname(port_root), os.path.dirname(jax_root)
    files = sorted(os.path.relpath(os.path.join(d, f), jax_root)
                   for d, _, fs in os.walk(jax_root) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), port_root)
                           for d, _, fs in os.walk(port_root) for f in fs)
    assert len(files) == (4 * chip_smoke.GATE_NV + 1 if name == "dtu"
                          else 3 * chip_smoke.GATE_NV + 1)
    for rel in files:
        with open(os.path.join(jax_root, rel), "rb") as f, \
                open(os.path.join(port_root, rel), "rb") as g:
            if rel.endswith(".png"):  # cv2's PNG and the port's: the same pixels
                np.testing.assert_array_equal(
                    cv2.imdecode(np.frombuffer(g.read(), np.uint8), cv2.IMREAD_UNCHANGED),
                    cv2.imdecode(np.frombuffer(f.read(), np.uint8), cv2.IMREAD_UNCHANGED))
            else:
                assert f.read() == g.read(), rel


@pytest.mark.parametrize("change,met", [
    ({}, True),
    ({"abs_depth_error": 2.5}, False),            # 0.5 * DITV
    ({"thres2mm_error": 0.25}, False),
    ({"thres8mm_error": 0.05}, False),
    ({"points": 4096}, False),                    # 0.2 * NV * EH * EW
    ({"zerr": [0.0, 2.5, 2.5]}, False),           # the median at 0.5 * DITV
    ({"zerr": [0.0, 0.0, 15.0]}, False),          # the mean at DITV
    ({"metrics": None}, True),                    # T&T: no protocol metrics
])
def test_pipeline_thresholds_are_the_jax_gates(change, met):
    case = {"metrics": {"abs_depth_error": 2.49, "thres2mm_error": 0.249,
                        "thres8mm_error": 0.049}, "points": 4097, "zerr": [0.1, 0.2, 0.3]}
    for k, v in change.items():
        if k in case["metrics"]:
            case["metrics"] = dict(case["metrics"], **{k: v})
        else:
            case[k] = v
    rows = chip_smoke.pipeline_thresholds(case["metrics"], case["points"],
                                          np.asarray(case["zerr"]))
    assert len(rows) == (3 if case["metrics"] is None else 6)
    assert chip_smoke.thresholds_met(rows) is met


def test_one_step_of_the_gate_loop(scans):
    ds = port_eval.MVSEvalDataset(scans["dtu"][0], ["scan1"], nviews=chip_smoke.GATE_NUM_VIEW,
                                  ndepths=chip_smoke.GATE_ND, interval_scale=1.0,
                                  max_h=chip_smoke.GATE_HW, max_w=chip_smoke.GATE_HW)
    batch = chip_smoke.plane_batch(torch, [ds[0]], "cpu")
    model = build_model(chip_smoke.gate_config("re"), device="cpu", train=True)
    random_init_(model, torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    res = chip_smoke.gate_train(torch, model, batch, chip_smoke.GATE_LR, 1, "re",
                                eval_err=chip_smoke.plane_eval_err(torch, batch), eval_every=1)
    assert len(res["losses"]) == 1 and np.isfinite(res["losses"][0])
    assert len(res["errors"]) == 2 and np.isfinite(res["errors"]).all()
    assert model.training
    live = model.state_dict()
    assert any(not torch.equal(live[k], init[k]) for k in init)  # the step trained
    want = init if res["best_step"] == 0 else {k: v.detach().clone() for k, v in live.items()}
    assert res["best_err"] == min(res["errors"])
    for k, v in res["best_state"].items():
        assert v.data_ptr() != live[k].data_ptr(), k
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    for k, v in res["best_state"].items():
        assert torch.equal(v, want[k]), k
