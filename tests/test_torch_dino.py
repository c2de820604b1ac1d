"""The PyTorch port's DINOMVSNet (MVSFormer-P) against the JAX model (CPU).

Both sides run fp32 on the same weights and the same inputs, made from a
seed with numpy: the modules take the JAX init (the decoder's BN
randomised) through the port's bridge, the whole model takes the port's
`random_init_` (non-trivial BN stats) through the JAX `convert_full_dino`. The port runs its plain kernel
versions here (CPU tensors); the JAX model its XLA path (`fused_ok()` is
false on the CPU), with the fused FPN flags off (exact rewrites of the
same convolutions, tests/test_torch_model.py holds them).

- `DINOViT`: tokens and the last block's attention within 1e-5, narrow
  (embed 64, depth 2, heads 2) and at vit_small, with the default scale
  and a log-N `qk_scale`, on grids other than the 14x14 pretrain grid (the
  position embedding is resized) and on it (not resized).
- `VITDecoderStage4Single` with `AttentionFusionSimple` within 1e-5.
- The whole eval forward, vit_small at full width, ndepths 8/4/4/2, B=1
  and B=2, V=3, 64x128 (a 2x4 token grid): 1e-2 in depth, 1e-4 in
  confidence (the Twins bounds); and `depth_type="was"`, whose final
  confidence is still the stages' mean in DINOMVSNet.
- The bridge: `convert_full_dino(port.state_dict())` gives back the JAX
  tree, and `load_flax_dino` loads strictly.
- One `fix=true` training step against `jax.value_and_grad` and optax, in
  float64 as tests/test_torch_train_step.py runs the Twins step, with its
  bounds; the ViT's tensors take no gradient and do not move.
- The layer-decay groups at `fix=false` against the JAX `lr_scale_tree`
  and `weight_decay_mask`.
- `load_config` of `configs/config_mvsformer-p.json` against the JAX one.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformer_tpu.config import ModelConfig as JaxModelConfig
from mvsformer_tpu.config import OptimizerConfig as JaxOptimizerConfig
from mvsformer_tpu.config import ViTConfig as JaxViTConfig
from mvsformer_tpu.config import load_config as jax_load_config
from mvsformer_tpu.models.decoders import VITDecoderStage4Single as JaxVITDecoder
from mvsformer_tpu.models.dino import DINOViT as JaxDINOViT
from mvsformer_tpu.models.mvsformer import build_model as jax_build_model
from mvsformer_tpu.ops import losses as jlosses
from mvsformer_tpu.train.optim import lr_scale_tree, make_optimizer, weight_decay_mask
from mvsformer_tpu.utils.convert_weights import convert_full_dino

from mvsformer_torch.config import Config, ModelConfig, OptimizerConfig, ViTConfig, load_config
from mvsformer_torch.infer import make_infer_fn
from mvsformer_torch.models.decoders import VITDecoderStage4Single
from mvsformer_torch.models.dino import DINOMVSNet, DINOViT
from mvsformer_torch.models.mvsformer import build_model, random_init_
from mvsformer_torch.train.optim import param_groups
from mvsformer_torch.train.step import TrainStep
from mvsformer_torch.utils.convert_weights import (convert_flax_grads, dino_vit_state,
                                                   load_flax_dino, to_torch, vit_decoder_state)

from test_torch_model import make_batch, randomise_bn, to_numpy
from test_torch_train_step import jax_x64, make_train_batch, micro, to_numpy64
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DINO_VIT = dict(twin=False, vit_arch="vit_small", vit_ch=384, out_ch=64, att_fusion=True)
CFG = dict(model_type="dino", ndepths=[8, 4, 4, 2], depth_interals_ratio=[4.0, 2.67, 1.5, 1.0],
           feat_chs=[8, 16, 32, 64], base_ch=8, depth_type="ce", inverse_depth=True,
           fusion_type="cnn")
JAX_FLAGS = dict(fused_enc_head=False, fused_fpn_final=False, fused_fpn_l2=False)
TMPS = [5.0, 5.0, 5.0, 1.0]
SIZE = (64, 128)  # the ViT sees 32x64: a 2x4 token grid
DEPTH_ATOL, CONF_ATOL = 1e-2, 1e-4  # tests/test_torch_model.py's bounds
MODULE_ATOL = 1e-5


def jax_cfg(**kw):
    return JaxModelConfig(**dict(CFG, **kw), **JAX_FLAGS,
                          vit_args=JaxViTConfig(**DINO_VIT))


def port_cfg(**kw):
    return ModelConfig(**dict(CFG, **kw), vit_args=ViTConfig(**DINO_VIT))


# ------------------------------------------------------------------ the ViT

@pytest.mark.parametrize("width,qk_scale,hw", [
    ("narrow", "default", (64, 96)), ("narrow", 14.0, (64, 96)),
    ("narrow", "default", (224, 224)), ("vit_small", "default", (64, 96)),
    ("vit_small", 14.0, (48, 80)),
])
def test_vit_matches_jax(width, qk_scale, hw):
    dims = dict(embed_dim=64, depth=2, num_heads=2) if width == "narrow" else \
        dict(embed_dim=384, depth=12, num_heads=6)
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    jvit = JaxDINOViT(**dims, qk_scale=qk_scale, dtype=jnp.float32)
    params = to_numpy(jax.jit(lambda k: jvit.init(k, jnp.asarray(x)))(
        jax.random.PRNGKey(1))["params"])
    jtok, jatt = jax.jit(lambda p: jvit.apply({"params": p}, jnp.asarray(x)))(params)

    vit = DINOViT(**dims, qk_scale=qk_scale)
    vit.load_state_dict(to_torch(dino_vit_state(params, dims["depth"])), strict=True)
    with torch.no_grad():
        tok, att = vit(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    n = 1 + (hw[0] // 16) * (hw[1] // 16)
    assert tok.shape == (2, n, dims["embed_dim"]) and att.shape == (2, dims["num_heads"], n, n)
    np.testing.assert_allclose(tok.numpy(), np.asarray(jtok), rtol=0, atol=MODULE_ATOL)
    np.testing.assert_allclose(att.numpy(), np.asarray(jatt), rtol=0, atol=MODULE_ATOL)


def test_vit_decoder_matches_jax():
    rng = np.random.default_rng(2)
    embed, heads, vit_ch, out_ch = 48, 3, 32, 8
    x = rng.standard_normal((2, 3, 5, embed)).astype(np.float32)
    att = rng.uniform(0, 1, (2, 3, 5, heads)).astype(np.float32)
    jdec = JaxVITDecoder(out_ch=out_ch, vit_ch=vit_ch, dtype=jnp.float32)
    variables = jax.jit(lambda k: jdec.init(k, jnp.asarray(x), jnp.asarray(att)))(
        jax.random.PRNGKey(3))
    params, stats = to_numpy(variables["params"]), to_numpy(variables["batch_stats"])
    randomise_bn(params, stats, rng)
    want = jax.jit(lambda v: jdec.apply(v, jnp.asarray(x), jnp.asarray(att)))(
        {"params": params, "batch_stats": stats})

    dec = VITDecoderStage4Single(embed, heads, vit_ch, out_ch).eval()
    dec.load_state_dict(to_torch(vit_decoder_state(params, stats)), strict=True)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got = dec(nchw(x), nchw(att)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 12, 20, out_ch)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=MODULE_ATOL)


# ------------------------------------------------------------------ the eval forward

def batch_of_two(rng):
    """tests/test_torch_model.py's batch at B = 2 and SIZE, the second sample
    with cameras and depths of its own."""
    imgs, projs, dv = make_batch(rng, B=2, H=SIZE[0], W=SIZE[1])
    for s, scale in zip(range(1, 5), (1 / 8, 1 / 4, 1 / 2, 1.0)):
        cams = projs[f"stage{s}"]
        for v in range(cams.shape[1]):
            cams[1, v, 0, 0, 3] = v * 1.5
            cams[1, v, 0, 1, 3] = v * 0.5
            cams[1, v, 1, 0, 0] = cams[1, v, 1, 1, 1] = 90.0 * scale
    dv[1] = np.linspace(500, 1000, dv.shape[1], dtype=np.float32)
    return imgs, projs, dv


def jax_forward(cfg, variables, batch):
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    imgs, projs, dv = batch
    out = jax.jit(lambda v, i, p, d: jmodel.apply(v, i, p, d, training=False, tmp=TMPS))(
        variables, jnp.asarray(imgs), jax.tree.map(jnp.asarray, projs), jnp.asarray(dv))
    return jax.tree.map(np.asarray, out)


def random_variables(cfg, seed):
    """The port's model of `cfg` filled by `random_init_` (non-trivial BN
    affine and running stats), and its JAX variables through
    `convert_full_dino`."""
    model = random_init_(build_model(cfg, device="cpu"), torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_full_dino(sd, ndepths=tuple(cfg.ndepths), model_th=cfg.model_th)
    return model, params, stats


@pytest.fixture(scope="module")
def both():
    """One forward of each side at B = 2 on the same weights, and the port's
    at B = 1 (the first sample)."""
    batch2 = batch_of_two(np.random.default_rng(0))
    batch1 = tuple(jax.tree.map(lambda a: a[:1], b) for b in batch2)
    model, params, stats = random_variables(port_cfg(), 0)
    assert isinstance(model, DINOMVSNet)
    jout = jax_forward(jax_cfg(), {"params": params, "batch_stats": stats}, batch2)
    outs = {}
    for b, batch in ((1, batch1), (2, batch2)):
        imgs, projs, dv = batch
        with torch.inference_mode():
            outs[b] = model(torch.from_numpy(imgs),
                            {k: torch.from_numpy(v) for k, v in projs.items()},
                            torch.from_numpy(dv), tmp=TMPS)
    return dict(params=params, stats=stats, model=model, jout=jout, tout=outs,
                batches={1: batch1, 2: batch2})


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("stage", [1, 2, 3, 4, "refined"])
def test_eval_forward_matches_jax(both, B, stage):
    j, t = both["jout"], both["tout"][B]
    if stage == "refined":
        pairs = [("refined_depth", DEPTH_ATOL), ("photometric_confidence", CONF_ATOL)]
    else:
        j, t = j[f"stage{stage}"], t[f"stage{stage}"]
        pairs = [("depth", DEPTH_ATOL), ("photometric_confidence", CONF_ATOL)]
        np.testing.assert_allclose(t["depth_values"].numpy(), j["depth_values"][:B],
                                   rtol=1e-5, atol=DEPTH_ATOL)
    for key, atol in pairs:
        np.testing.assert_allclose(t[key].numpy(), j[key][:B], rtol=0, atol=atol, err_msg=key)


def test_make_infer_fn_serves_the_dino_model(both):
    imgs, projs, dv = both["batches"][1]
    depth, conf, stage_confs = make_infer_fn(both["model"], TMPS)(imgs, projs, dv)
    assert depth.shape == conf.shape == (1, *SIZE)
    np.testing.assert_allclose(depth.numpy(), both["jout"]["refined_depth"][:1], rtol=0,
                               atol=DEPTH_ATOL)
    np.testing.assert_allclose(conf.numpy(), both["jout"]["photometric_confidence"][:1],
                               rtol=0, atol=CONF_ATOL)
    assert ((conf.numpy() > 0) & (conf.numpy() <= 1)).all() and len(stage_confs) == 4


def test_was_confidence_is_still_the_stages_mean(both):
    """DINOMVSNet averages the stages' confidences whatever the depth type
    (the JAX dino.py does; TwinMVSNet keeps the last stage's for was)."""
    model = build_model(port_cfg(depth_type="was"), device="cpu")
    model.load_state_dict(both["model"].state_dict())
    batch = both["batches"][1]
    jout = jax_forward(jax_cfg(depth_type="was"),
                       {"params": both["params"], "batch_stats": both["stats"]}, batch)
    depth, conf, stage_confs = make_infer_fn(model, TMPS)(*batch)
    np.testing.assert_allclose(depth.numpy(), jout["refined_depth"], rtol=0, atol=DEPTH_ATOL)
    np.testing.assert_allclose(conf.numpy(), jout["photometric_confidence"], rtol=0,
                               atol=CONF_ATOL)
    mean = sum(torch.nn.functional.interpolate(c[:, None], size=SIZE, mode="nearest")[:, 0]
               for c in stage_confs) / 4
    np.testing.assert_allclose(conf.numpy(), mean.numpy(), rtol=0, atol=1e-6)
    assert float((conf - stage_confs[-1]).abs().max()) > 1e-3


def test_bridge_gives_the_jax_tree_and_loads_back(both):
    """convert_full_dino(port.state_dict()) has exactly the keys and shapes
    of the JAX DINOMVSNet's init, and load_flax_dino (strict) gives back the
    port's tensors."""
    jmodel = jax_build_model(jax_cfg(), dtype=jnp.float32)
    imgs, projs, dv = both["batches"][1]
    want = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(imgs), jax.tree.map(jnp.asarray, projs),
        jnp.asarray(dv), training=False))
    for got, tree in ((both["params"], want["params"]), (both["stats"], want["batch_stats"])):
        want_leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(got_leaves) == len(want_leaves)
        for path, leaf in want_leaves:
            assert got_leaves[path].shape == leaf.shape, path
    model = build_model(port_cfg(), device="cpu")
    load_flax_dino(model, both["params"], both["stats"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, both["model"].state_dict()[k].reshape(v.shape)), k


def test_random_init_draws_the_vit_tokens_from_the_generator():
    a = random_init_(build_model(port_cfg(), device="cpu"), torch.Generator().manual_seed(4))
    b = random_init_(build_model(port_cfg(), device="cpu"), torch.Generator().manual_seed(4))
    for name in ("vit.cls_token", "vit.pos_embed"):
        pa, pb = a.state_dict()[name], b.state_dict()[name]
        assert torch.equal(pa, pb), name
        assert 0.015 < float(pa.std()) < 0.025, name  # 0.02 N(0, 1), not the trunc_normal init


@pytest.mark.parametrize("field,kw", [
    ("att_fusion", dict(att_fusion=False)), ("multi_scale", None), ("cross_att",
                                                                    dict(cross_att=True))])
def test_build_model_refuses_the_unported_dino_variants(field, kw):
    """A6 ported these DINO variants: each builds, with the JAX model's
    decoder (and no cross block under cross_att, as the JAX DINOMVSNet);
    the one refusal left is att_fusion=false with multi_scale, which no
    model has (ROADMAP E10)."""
    cfg = port_cfg(multi_scale=kw is None)
    if kw:
        cfg.vit_args = ViTConfig(**dict(DINO_VIT, **kw))
    model = build_model(cfg, device="cpu")
    want = {"att_fusion": "VITDecoderStage4NoAtt", "multi_scale": "VITDecoderStage4",
            "cross_att": "VITDecoderStage4Single"}[field]
    assert type(model.decoder_vit).__name__ == want
    assert not any(n.startswith("vit.cross_block") for n in model.state_dict())
    cfg.multi_scale = True
    cfg.vit_args = ViTConfig(**dict(DINO_VIT, att_fusion=False))
    with pytest.raises(ValueError, match="att_fusion=false with multi_scale"):
        build_model(cfg, device="cpu")


# ------------------------------------------------------------------ training

KEYS = ("stage1", "stage2", "stage3", "stage4")
OPT = dict(vit_lr=3e-5, lr=1e-3, weight_decay=0.01, layer_decay=0.75, min_lr=0.01,
           warmup_steps=0, grad_norm=None)
EPOCHS = 15


def jax_fix_step(params, stats, batch):
    """One float64 JAX training step with `fix`: two micro-batches with
    chained batch stats, averaged gradients, then the optax AdamW of the
    dino groups with the backbone frozen (tests/test_torch_train_step.py's
    jax_step for the Twins model)."""
    with jax_x64(True):
        jmodel = jax_build_model(jax_cfg(fix=True), dtype=jnp.float64)
        cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)

        def grad_step(p, s, mb):
            dv = mb["depth_values"]

            def loss_fn(p):
                out, upd = jmodel.apply({"params": p, "batch_stats": s}, mb["imgs"],
                                        mb["proj_matrices"], dv, training=True,
                                        mutable=["batch_stats"])
                loss, ld = jlosses.total_loss(out, mb["depth_gt"], mb["mask"],
                                              dv[:, 1] - dv[:, 0], depth_type="ce",
                                              focal=False, gamma=2.0, inverse_depth=True,
                                              stage_keys=KEYS)
                return loss, (ld, upd["batch_stats"])

            (loss, (ld, new_s)), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
            return loss, ld, new_s, g

        p, s, grads, losses_ = cast(params), cast(stats), None, []
        step = jax.jit(grad_step)
        for i in range(2):
            # The 3D cost regulariser returns its running stats in fp32;
            # back in float64 (exact) they keep the compiled signature.
            loss, ld, s, g = step(p, cast(s), cast(micro(batch, i)))
            losses_.append({"loss": float(loss), **{k: float(v) for k, v in ld.items()}})
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        grads = jax.tree.map(lambda x: x / 2, grads)
        tx, _ = make_optimizer(p, JaxOptimizerConfig(**OPT), "dino", total_steps=EPOCHS,
                               fix_backbone=True)
        updates = jax.jit(lambda g, p: tx.update(g, tx.init(p), p)[0])(grads, p)
        new_params = jax.tree.map(jnp.add, p, updates)
        return losses_, to_numpy64(grads), to_numpy64(s), to_numpy64(new_params)


@pytest.fixture(scope="module")
def fix_step():
    """One `fix=true` training step of each side from the same weights and
    batch (B=2 as two micro-batches of one, V=3, 64x64, a 2x2 token grid),
    in float64."""
    batch = make_train_batch(np.random.default_rng(0))
    cfg = Config(arch=port_cfg(fix=True), optimizer=OptimizerConfig(**OPT))
    cfg.data.multi_scale_args.scale_batch_map = {"64": 1}
    cfg.trainer.epochs = EPOCHS
    model, params, stats = random_variables(cfg.arch, 1)
    jlosses_, grads, jstats, new_params = jax_fix_step(params, stats, batch)
    model = model.train().double()
    vit_before = {k: v.clone() for k, v in model.vit.state_dict().items()}
    metrics = TrainStep(model, cfg)(batch)

    nd = tuple(CFG["ndepths"])
    want_grads, want_stats = convert_flax_grads(grads, jstats, nd, 8)
    want_params, _ = convert_flax_grads(new_params, jstats, nd, 8)
    before, _ = convert_flax_grads(to_numpy64(params), to_numpy64(stats), nd, 8)
    return dict(model=model, metrics=metrics, jlosses=jlosses_, want_grads=want_grads,
                want_stats=want_stats, want_params=want_params, before=before,
                vit_before=vit_before)


@pytest.mark.parametrize("key", ("loss",) + KEYS)
def test_fix_step_losses_match_jax(fix_step, key):
    want = np.mean([m[key] for m in fix_step["jlosses"]])
    got = fix_step["metrics"]["loss" if key == "loss" else f"loss_{key}"]
    np.testing.assert_allclose(got, want, rtol=1e-6)


# tests/test_torch_train_step.py's bounds for the Twins step, in float64,
# with one term more. The warp, correlation, softmaxes and losses are fp32
# on both sides, and their rounding reaches the gradients at up to ~1e-2 of
# a tensor's scale (the Twins test measured 3.9e-3 of the visibility CNNs'
# norm). Its visibility CNNs' gradients are 1e-6 to 1e-4 in norm, so an
# absolute 2e-6 covers it there; random_init_'s weights give the stage-4
# visibility CNN gradients of ~1e-3, which hold 4.6e-3 of their norm and
# 6.7e-3 of their largest entry in that noise. So the elementwise bound
# adds GRAD_OF_SCALE of the tensor's largest entry.
GRAD_RTOL, GRAD_ATOL, GRAD_OF_SCALE, GRAD_L2, NONZERO = 5e-3, 2e-6, 2e-2, 2e-2, 1e-7


def test_fix_step_gradients_match_jax(fix_step):
    named = dict(fix_step["model"].named_parameters())
    trainable = {n for n, p in named.items() if p.requires_grad}
    assert trainable == {n for n in named if not n.startswith("vit.")}
    for name, want in fix_step["want_grads"].items():
        got = named[name].grad
        if name.startswith("vit."):
            assert got is None and not bool(want.abs().max()), name  # stop_gradient: zeros
            continue
        got, want = got.numpy(), want.numpy()
        atol = GRAD_ATOL + GRAD_OF_SCALE * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol, err_msg=name)
        norm = float(np.linalg.norm(want))
        if norm > NONZERO:
            assert np.linalg.norm(got - want) <= GRAD_L2 * norm, name


def test_fix_step_running_stats_match_jax(fix_step):
    buffers = dict(fix_step["model"].named_buffers())
    for name, want in fix_step["want_stats"].items():
        np.testing.assert_allclose(buffers[name].numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_fix_step_updates_match_jax_and_leave_the_vit(fix_step):
    """Updates within 1e-4 of the LR where |g| >= 1e-5 (the Twins test's
    bound); the ViT's tensors are bit-equal before and after."""
    named = dict(fix_step["model"].named_parameters())
    for name, want in fix_step["want_params"].items():
        before = fix_step["before"][name].numpy()
        got = named[name].detach().numpy() - before
        want = want.numpy() - before
        if name.startswith("vit."):
            assert not np.abs(want).any() and not np.abs(got).any(), name
            continue
        ulps = 1e-15 * max(1.0, float(np.abs(before).max()))
        sure = np.abs(fix_step["want_grads"][name].numpy()) >= 1e-5
        if sure.any():
            np.testing.assert_allclose(got[sure], want[sure], rtol=0,
                                       atol=1e-4 * OPT["lr"] + ulps, err_msg=name)
    for k, v in fix_step["model"].vit.state_dict().items():
        assert torch.equal(v, fix_step["vit_before"][k]), k


def test_layer_decay_groups_match_jax():
    """At fix=false each ViT tensor's LR and decay are the JAX
    `lr_scale_tree(..., "dino")` and `weight_decay_mask` (the pattern of
    tests/test_optim.py), carried to the port's names by the bridge."""
    model = build_model(port_cfg(), device="cpu")
    opt = OptimizerConfig(**OPT)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_full_dino(sd, ndepths=tuple(CFG["ndepths"]), model_th=8)
    jopt = JaxOptimizerConfig(**OPT)
    full = lambda tree: jax.tree.map(lambda leaf, p: np.full(np.shape(p), float(leaf)),
                                     tree, params)
    scales, _ = convert_flax_grads(full(lr_scale_tree(params, jopt, "dino", vit_depth=12)),
                                   stats, tuple(CFG["ndepths"]), 8)
    decay, _ = convert_flax_grads(full(weight_decay_mask(params, "dino")), stats,
                                  tuple(CFG["ndepths"]), 8)
    groups = param_groups(model, opt, fix=False, model_type="dino")
    seen = set()
    for g in groups:
        for name in g["names"]:
            seen.add(name)
            np.testing.assert_allclose(g["lr"] / opt.lr, float(scales[name].flatten()[0]),
                                       rtol=1e-12, err_msg=name)
            assert (g["weight_decay"] > 0) == bool(decay[name].flatten()[0]), name
            assert g["weight_decay"] in (0.0, opt.weight_decay)
    assert seen == {n for n, _ in model.named_parameters()}
    assert len(groups) == 1 + 2 * 12 + 3  # rest; blocks by decay; embeddings x2, final norm
    fixed = param_groups(model, opt, fix=True, model_type="dino")
    assert [g["group"] for g in fixed] == ["rest"]


def test_load_config_of_the_p_config_matches_jax():
    path = os.path.join(REPO, "configs", "config_mvsformer-p.json")
    port, ref = load_config(path), jax_load_config(path)
    assert port.arch.model_type == "dino" and port.arch.fix
    for section in ("arch", "optimizer"):
        for f in dataclasses.fields(getattr(port, section)):
            if f.name != "vit_args":
                assert getattr(getattr(port, section), f.name) == \
                    getattr(getattr(ref, section), f.name), (section, f.name)
    assert dataclasses.asdict(port.arch.vit_args) == dataclasses.asdict(ref.arch.vit_args)
    assert port.optimizer.layer_decay == ref.optimizer.layer_decay == 0.75
