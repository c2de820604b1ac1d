"""The port's multi-scale models and DINO's decoder without attention fusion
against the JAX models (CPU).

At tests/test_torch_model.py's toy shape (B=1, V=3, 64x64, ndepths
8/4/4/2, drop path 0), full-width backbones:
- TwinMVSNet under `multi_scale` (TwinDecoderStage4V2 and FPNDecoderV2):
  the port's `random_init_` weights carried to JAX by `convert_full_twin`;
- DINOMVSNet (vit_small) under `multi_scale` (VITDecoderStage4 and
  FPNDecoderV2) and with `att_fusion: false` (VITDecoderStage4NoAtt): random
  values on the shapes `jax.eval_shape` gives the JAX init, carried to the
  port by `load_flax_dino` (the JAX converter maps neither decoder).

Held, in fp32:
- the eval forward: each stage's hypotheses, depth and confidence and the
  refined outputs within tests/test_torch_model.py's bounds (1e-2 in depth,
  1e-4 in confidence);
- each stage's `sim_depth` (`want_similarity`) against the JAX CPU output,
  which always computes it: at random weights the summed cosine volume is
  nearly flat over depth (stage 1's median gap between its two largest
  values is ~4e-5), so either side's rounding flips the argmax at near
  ties. Held by `chip_smoke.similarity_agreement`, as phase 17 holds the
  card to the CPU: the hypothesis JAX picks is the port's at 0.8 of the
  pixels or more (0.875-0.92 measured at stage 1, 0.995 at stage 4), and
  at every other pixel the port's own cosine sum at JAX's pick lies within
  1e-5 of its maximum (8.3e-7 at most measured);
- the Twins model in bf16 against the JAX model built with
  `dtype=jnp.bfloat16`, within 2x the JAX package's own bf16-vs-fp32 gap
  (tests/test_torch_bf16.py's rule and island guard);
- the bridge: the JAX tree of the multi-scale Twins model has exactly the
  keys and shapes of the JAX init, a reference `.pth` of each model loads
  back strictly, and `convert_flax_grads` names every parameter;
- `att_fusion: false` with `multi_scale` raises ValueError (no model on
  either side: the JAX DINOMVSNet's no-attention decoder returns one map
  where FPNDecoderV2 takes three);
- every norm of the new decoders takes the layout's data group (SyncBN);
- both CLIs: `python -m mvsformer_torch.train` trains a toy epoch of the
  multi-scale Twins model with `remat_backbone` (fp32, finite losses, the
  checkpoints), and `python -m mvsformer_torch.test` serves its
  model_best, view 0 bit for bit `make_infer_fn`'s.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformer_tpu.config import ModelConfig as JaxModelConfig
from mvsformer_tpu.config import ViTConfig as JaxViTConfig
from mvsformer_tpu.models.mvsformer import build_model as jax_build_model
from mvsformer_tpu.utils.convert_weights import convert_full_twin

from mvsformer_torch import test as test_cli
from mvsformer_torch.config import ModelConfig, ViTConfig, save_config
from mvsformer_torch.data.eval_dataset import MVSEvalDataset
from mvsformer_torch.data.loader import collate
from mvsformer_torch.infer import STAGES, make_infer_fn
from mvsformer_torch.models import stagenet
from mvsformer_torch.models.blocks import FoldedBatchNorm
from mvsformer_torch.models.decoders import (TwinDecoderStage4V2, VITDecoderStage4,
                                             VITDecoderStage4NoAtt)
from mvsformer_torch.models.fpn import FPNDecoderV2
from mvsformer_torch.models.mvsformer import build_model, random_init_
from mvsformer_torch.parallel.mesh import Layout
from mvsformer_torch.train import __main__ as train_cli
from mvsformer_torch.utils.convert_weights import (BUFFER_SUFFIXES, convert_flax_grads,
                                                   load_flax_dino, load_reference_checkpoint)
from mvsformer_torch.utils.pfm import read_pfm

import chip_smoke
from test_data import make_dtu_tree

from test_torch_bf16 import JAX_FLAGS, assert_islands, forwards, hold_forward
from test_torch_model import CFG, TMPS, make_batch
from test_torch_trainer import records, toy_config
from test_torch_variants import random_variables
from test_torch_watchdog import watchdog

torch.set_num_threads(4)
hang_watchdog = watchdog()

KEYS = ("stage1", "stage2", "stage3", "stage4")
DEPTH_ATOL, CONF_ATOL = 1e-2, 1e-4  # tests/test_torch_model.py's bounds
DINO_VIT = dict(twin=False, vit_arch="vit_small", vit_ch=384, out_ch=64)
CASES = {"twin-multi_scale": (dict(multi_scale=True), None),
         "dino-multi_scale": (dict(model_type="dino", multi_scale=True), True),
         "dino-att_fusion=false": (dict(model_type="dino"), False)}


def port_cfg(name):
    kw, att = CASES[name]
    vit = {} if att is None else dict(vit_args=ViTConfig(**DINO_VIT, att_fusion=att))
    return ModelConfig(**CFG, **kw, **vit)


def jax_cfg(name):
    kw, att = CASES[name]
    vit = {} if att is None else dict(vit_args=JaxViTConfig(**DINO_VIT, att_fusion=att))
    return JaxModelConfig(**CFG, **kw, **JAX_FLAGS, **vit)


def as_jax(batch):
    imgs, projs, dv = batch
    return jnp.asarray(imgs), jax.tree.map(jnp.asarray, projs), jnp.asarray(dv)


def port_forward(model, batch):
    """The port's fp32 eval forward with `want_similarity`, as float64
    numpy, and each stage's summed cosine volume [B, D, H, W], recorded
    where the stage computes it."""
    imgs, projs, dv = batch
    volumes = []
    original = stagenet.cosine_similarity_volume

    def record(*args):
        volumes.append(original(*args))
        return volumes[-1]

    stagenet.cosine_similarity_volume = record
    try:
        with torch.inference_mode():
            out = model(torch.from_numpy(imgs), {k: torch.from_numpy(v) for k, v in projs.items()},
                        torch.from_numpy(dv), tmp=TMPS, want_similarity=True)
    finally:
        stagenet.cosine_similarity_volume = original
    views = imgs.shape[1] - 1
    sums = [sum(volumes[i * views:(i + 1) * views]).double().numpy() for i in range(4)]
    out = {k: ({n: t.double().numpy() for n, t in v.items()} if isinstance(v, dict)
               else v.double().numpy()) for k, v in out.items()}
    return out, sums


def jax_forward(jcfg, variables, batch):
    jmodel = jax_build_model(jcfg, dtype=jnp.float32)
    out = jax.jit(lambda v, i, p, d: jmodel.apply(v, i, p, d, training=False, tmp=TMPS))(
        variables, *as_jax(batch))
    return jax.tree.map(lambda a: np.asarray(a, np.float64), out)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One config on both sides: the JAX fp32 forward (and for the Twins
    model its bf16 one, and the port's bf16 forward under the island
    guard), the port's fp32 forward with the similarity."""
    name = request.param
    batch = make_batch(np.random.default_rng(0))
    out = dict(name=name, batch=batch)
    if name.startswith("twin"):
        model = random_init_(build_model(port_cfg(name), device="cpu"),
                             torch.Generator().manual_seed(0))
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        params, stats = convert_full_twin(sd, ndepths=tuple(CFG["ndepths"]), model_th=8)
        with pytest.MonkeyPatch.context() as mp:
            j32, j16, t16, seen, _ = forwards(model, jax_cfg(name), params, stats, batch, mp)
        out.update(j16=j16, t16=t16, seen=seen)
        jout = jax.tree.map(lambda a: np.asarray(a, np.float64), j32)
    else:
        jmodel = jax_build_model(jax_cfg(name), dtype=jnp.float32)
        shapes = jax.eval_shape(lambda k: jmodel.init(k, *as_jax(batch), training=False),
                                jax.random.PRNGKey(0))
        variables = random_variables(shapes, np.random.default_rng(1))
        params, stats = variables["params"], variables.get("batch_stats", {})
        model = build_model(port_cfg(name), device="cpu")
        load_flax_dino(model, params, stats)
        jout = jax_forward(jax_cfg(name), {"params": params, "batch_stats": stats}, batch)
    tout, sims = port_forward(model, batch)
    out.update(model=model, params=params, stats=stats, jout=jout, tout=tout, sims=sims)
    return out


def test_the_configs_build_their_decoders(case):
    model, name = case["model"], case["name"]
    assert isinstance(model.decoder, FPNDecoderV2) == ("multi_scale" in name)
    want = {"twin-multi_scale": TwinDecoderStage4V2, "dino-multi_scale": VITDecoderStage4,
            "dino-att_fusion=false": VITDecoderStage4NoAtt}[name]
    assert type(model.decoder_vit) is want


@pytest.mark.parametrize("stage", KEYS + ("refined",))
def test_eval_forward_matches_jax(case, stage):
    j, t = case["jout"], case["tout"]
    if stage == "refined":
        pairs = [("refined_depth", DEPTH_ATOL), ("photometric_confidence", CONF_ATOL)]
    else:
        j, t = j[stage], t[stage]
        pairs = [("depth_values", DEPTH_ATOL), ("depth", DEPTH_ATOL),
                 ("photometric_confidence", CONF_ATOL)]
    for key, atol in pairs:
        assert np.isfinite(t[key]).all(), key
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=atol,
                                   err_msg=f"{case['name']} {stage} {key}")


@pytest.mark.parametrize("stage", range(4))
def test_similarity_depth_matches_jax(case, stage):
    """The port's sim_depth is the hypothesis at its own cosine sum's
    argmax, and JAX's agrees with that sum (`chip_smoke.similarity_agreement`)."""
    key = KEYS[stage]
    got, want = case["tout"][key], case["jout"][key]
    assert got["sim_depth"].shape == want["sim_depth"].shape == got["depth"].shape
    dv, sims = (torch.from_numpy(a) for a in (got["depth_values"], case["sims"][stage]))
    mine = torch.gather(dv, 1, sims.argmax(dim=1, keepdim=True))[:, 0]
    assert torch.equal(mine, torch.from_numpy(got["sim_depth"]))
    share, shortfall = chip_smoke.similarity_agreement(torch.from_numpy(want["sim_depth"]),
                                                       dv, sims)
    assert share >= chip_smoke.SIM_SHARE and shortfall <= chip_smoke.SIM_ATOL, (share, shortfall)


def test_similarity_is_off_by_default(case):
    model, (imgs, projs, dv) = case["model"], case["batch"]
    with torch.inference_mode():
        out = model(torch.from_numpy(imgs), {k: torch.from_numpy(v) for k, v in projs.items()},
                    torch.from_numpy(dv), tmp=TMPS)
    assert not any("sim_depth" in out[k] for k in KEYS)
    np.testing.assert_array_equal(out["refined_depth"].double().numpy(),
                                  case["tout"]["refined_depth"])


@pytest.mark.parametrize("case", ["twin-multi_scale"], indirect=True)
def test_twin_multi_scale_forward_in_bf16(case):
    hold_forward(dict(case, tout=case["t16"], j32=case["jout"]))
    assert_islands(case["seen"])


def test_bridge_round_trips(case, tmp_path):
    """The bridge: for the Twins model the JAX tree `convert_full_twin`
    gives is the JAX init's, key for key and shape for shape; a reference
    `.pth` of the port's state (DataParallel's prefix) loads back strictly;
    `convert_flax_grads` of the JAX trees names every parameter and running
    statistic of the port's model."""
    model = case["model"]
    if case["name"].startswith("twin"):
        jmodel = jax_build_model(jax_cfg(case["name"]), dtype=jnp.float32)
        want = jax.eval_shape(lambda k: jmodel.init(k, *as_jax(case["batch"]), training=False),
                              jax.random.PRNGKey(0))
        for got, tree in ((case["params"], want["params"]),
                          (case["stats"], want["batch_stats"])):
            want_leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
            got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
            assert len(got_leaves) == len(want_leaves)
            for path, leaf in want_leaves:
                assert got_leaves[path].shape == leaf.shape, path
    path = tmp_path / "ref.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}}, path)
    again = build_model(model.cfg, device="cpu")
    load_reference_checkpoint(str(path), again)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    grads, buffers = convert_flax_grads(case["params"], case["stats"], tuple(CFG["ndepths"]), 8)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    assert set(buffers) == {n for n, _ in model.named_buffers()
                            if not n.endswith(".num_batches_tracked")}
    for name, p in model.named_parameters():
        assert torch.equal(grads[name].to(p.dtype), p.detach()), name
    assert all(k.endswith(BUFFER_SUFFIXES) for k in buffers)


def test_att_fusion_false_with_multi_scale_is_refused():
    cfg = ModelConfig(**CFG, model_type="dino", multi_scale=True,
                      vit_args=ViTConfig(**DINO_VIT, att_fusion=False))
    with pytest.raises(ValueError, match="att_fusion=false with multi_scale"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_every_norm_of_the_new_decoders_takes_the_data_group(name):
    """`use_layout` reaches each norm of the new decoders: SyncBN in a
    training forward under a data split."""
    model = build_model(port_cfg(name), device="cpu")
    group = object()
    model.use_layout(Layout(data=2, data_group=group))
    norms = [m for part in (model.decoder, model.decoder_vit) for m in part.modules()
             if isinstance(m, FoldedBatchNorm)]
    assert len(norms) >= (7 if "multi_scale" in name else 3)
    assert all(m.data_group is group for m in norms)
    model.use_layout(None)
    assert all(m.data_group is None for m in norms)


def test_the_clis_train_and_serve_the_multi_scale_model(tmp_path):
    root = make_dtu_tree(str(tmp_path / "dtu"), H=240, W=320)
    with open(os.path.join(root, "Cameras", "pair.txt"), "w") as f:
        f.write("1\n0\n4 1 100 2 99 3 98 4 97\n")  # one reference view: 7 samples
    save_dir = str(tmp_path / "saved")
    run_dir = os.path.join(save_dir, "models", "toy")
    cfg = toy_config(root, save_dir)
    cfg.arch.multi_scale = cfg.arch.remat_backbone = True
    config = str(tmp_path / "config.json")
    save_config(cfg, config)
    try:
        history = train_cli.main(["--config", config, "--device", "cpu", "--dtype", "fp32"])
        assert len(history) == 1 and np.isfinite(history[0]["loss"])
        steps = [r for r in records(run_dir) if r["kind"] == "step"]
        assert len(steps) == 3 and all(np.isfinite(r["loss"]) for r in steps)
        eval_root = chip_smoke.write_dtu_scan(str(tmp_path / "eval"), views=4, img_hw=(96, 128))
        listfile = os.path.join(eval_root, "list.txt")
        with open(listfile, "w") as f:
            f.write("scan1\n")
        out = str(tmp_path / "out")
        test_cli.main(["--testpath", eval_root, "--testlist", listfile, "--ckpt_dir", run_dir,
                       "--which_ckpt", "model_best", "--outdir", out, "--max_h", "64",
                       "--max_w", "64", "--ndepths", "16", "--num_view", "3", "--device", "cpu",
                       "--skip_fusion", "--dtype", "fp32"])
        model = build_model(cfg.arch, device="cpu")
        assert isinstance(model.decoder, FPNDecoderV2)
        load_reference_checkpoint(os.path.join(run_dir, "model_best.pth"), model)
        ds = MVSEvalDataset(eval_root, ["scan1"], nviews=3, ndepths=16, interval_scale=1.06,
                            max_h=64, max_w=64)
        batch = collate([ds[0]])
        depth, _, _ = make_infer_fn(model)(
            batch["imgs"], {k: batch["proj_matrices"][k] for k in STAGES}, batch["depth_values"])
        saved = read_pfm(os.path.join(out, "scan1", "depth_est", "00000000.pfm"))[0]
        assert np.array_equal(saved, depth[0].numpy())
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)  # checkpoints of ~0.3 GB each
