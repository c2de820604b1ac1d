"""The cascade's model variants of the port against the JAX model (CPU).

At tests/test_model.py's tiny_cfg shape (tests/test_torch_model.py's
CFG: B=1, V=3, 64x64, ndepths 8/4/4/2, full-width alt_gvt_small), fp32:
- the eval forward of six configs within tests/test_torch_model.py's
  bounds (1e-2 in depth, 1e-4 in confidence): cnn / re / GN, cnn / ce /
  IN, epipole / was / BN, epipoleV2 / mixup_ce / BN, cnn / ce with
  `eval_view_chunk=2`, and cnn / ce with `clamp_eth3d` on a scene scaled
  into the clamp's 0.01-50 range. Each config's variables are random
  values on the shapes `jax.eval_shape` gives the JAX init (no init
  compile), carried to the port by the weight bridge; its JAX forward is
  compiled once, in a module fixture;
- the bridge for each config: a reference `.pth` of the port's state
  loads back strictly (`load_reference_checkpoint`), and
  `convert_flax_grads` names every parameter and running statistic;
- the kernel routing: under GN and IN the encoder head, the FPN levels
  and the visibility CNN run as their modules, under BN through the
  wrappers of K4, K5 and K2;
- one float64 training step each for `re` + GN + `mask_out_range` and
  for `mixup_ce` against `jax.value_and_grad` and optax, as
  tests/test_torch_train_step.py holds the ce step (with
  tests/test_torch_dino.py's bounds for random weights);
- `build_model` builds `multi_scale`, `att_fusion=false` and `cross_att`
  (ROADMAP A6 landed), and still refuses DINO's `att_fusion=false` with
  `multi_scale`, which no model has (ROADMAP E10).
"""

import copy
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformer_tpu.config import ModelConfig as JaxModelConfig
from mvsformer_tpu.config import OptimizerConfig as JaxOptimizerConfig
from mvsformer_tpu.models.mvsformer import build_model as jax_build_model
from mvsformer_tpu.ops import losses as jlosses
from mvsformer_tpu.train.optim import make_optimizer

from mvsformer_torch.config import Config, ModelConfig, OptimizerConfig, ViTConfig
from mvsformer_torch.models import fpn, stagenet
from mvsformer_torch.models.mvsformer import build_model
from mvsformer_torch.train.step import TrainStep
from mvsformer_torch.utils.convert_weights import (BUFFER_SUFFIXES, convert_flax_grads,
                                                   load_flax_twin, load_reference_checkpoint)

import chip_smoke
from test_torch_model import CFG, TMPS, make_batch
from test_torch_train_step import EPOCHS, OPT, jax_x64, make_train_batch, micro, to_numpy64
from test_torch_watchdog import watchdog

torch.set_num_threads(4)
hang_watchdog = watchdog()

KEYS = ("stage1", "stage2", "stage3", "stage4")
DEPTH_ATOL, CONF_ATOL = 1e-2, 1e-4
# The clamp_eth3d scene: tests/test_torch_model.py's cameras and 425-900
# depths scaled by 1/20 (the same images in pixels), so the range lies
# inside the clamp's 0.01-50 and the later stages' windows reach its 0.02
# inverse-depth floor.
ETH3D_SCALE = 1 / 20

VARIANTS = {
    "cnn-re-GN": dict(depth_type="re", norm_type="GN"),
    "cnn-ce-IN": dict(norm_type="IN"),
    "epipole-was-BN": dict(fusion_type="epipole", depth_type="was"),
    "epipoleV2-mixup_ce-BN": dict(fusion_type="epipoleV2", depth_type="mixup_ce"),
    "cnn-ce-view_chunk": dict(eval_view_chunk=2),
    "cnn-ce-clamp_eth3d": dict(clamp_eth3d=True),
}


def batch_for(name):
    imgs, projs, dv = make_batch(np.random.default_rng(0))
    if name.startswith("epipoleV2"):
        # make_batch's sources move along x only, so the first and last rows
        # project exactly onto the source frustum's edge in y, where the
        # fp32 coordinates of either package round to either side and
        # epipoleV2's -1e4 bias flips; a small y baseline takes every pixel
        # off the edge.
        for cams in projs.values():
            cams[:, :, 0, 1, 3] = cams[:, :, 0, 0, 3] / 4
    if name == "cnn-ce-clamp_eth3d":
        for cams in projs.values():
            cams[:, :, 0, :3, 3] *= ETH3D_SCALE
        dv = dv * ETH3D_SCALE
    return imgs, projs, dv


def random_variables(shapes, rng):
    """numpy values on a JAX variables tree of shapes: kernels N(0, 1 /
    fan_in), biases 0.05 N, norm scales 1 + 0.1 N, BN means 0.1 N and
    variances 1 + 0.2 |N|, epipoleV2's temperature 1.5 (its init is 1)."""
    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        x = rng.standard_normal(shape)
        if name == "kernel":
            x = x / math.sqrt(math.prod(shape[:-1]))
        elif name == "scale":
            x = 1 + 0.1 * x
        elif name == "mean":
            x = 0.1 * x
        elif name == "var":
            x = 1 + 0.2 * np.abs(x)
        elif name == "attn_temp":
            x = np.full(shape, 1.5)
        else:
            x = 0.05 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_variables(jmodel, imgs, projs, dv, seed):
    shapes = jax.eval_shape(lambda k: jmodel.init(k, imgs, projs, dv, training=False),
                            jax.random.PRNGKey(0))
    variables = random_variables(shapes, np.random.default_rng(seed))
    return variables["params"], variables.get("batch_stats", {})


def jax_cfg(**kw):
    return JaxModelConfig(**dict(CFG, **kw), fused_enc_head=False, fused_fpn_final=False,
                          fused_fpn_l2=False)


def jax_forward(kw, variables, imgs, projs, dv, x64=False):
    with jax_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dt), tree)
        jmodel = jax_build_model(jax_cfg(**kw), dtype=dt)
        out = jax.jit(lambda v, i, p, d: jmodel.apply(v, i, p, d, training=False, tmp=TMPS))(
            cast(variables), cast(imgs), cast(projs), cast(dv))
        return jax.tree.map(lambda a: np.asarray(a, np.float64), out)


def port_forward(model, imgs, projs, dv, dtype=torch.float32):
    T = lambda a: torch.from_numpy(a).to(dtype)
    with torch.inference_mode():
        out = model.to(dtype)(T(imgs), {k: T(v) for k, v in projs.items()}, T(dv), tmp=TMPS)
    return {k: ({n: t.double().numpy() for n, t in v.items()} if isinstance(v, dict)
                else v.double().numpy()) for k, v in out.items()}


# Instance norm at this toy shape normalises, at the cost regularisers'
# bottlenecks, over a few values per channel (stage 1's CostRegNet3D
# reaches 1x1 pixels over 8 depths), where fp32 rounding is amplified: the
# JAX model's own fp32 output lies up to 1.8e-2 in depth from its float64
# one. So IN is held in float64 on both sides within the bounds, and in
# fp32 the port is held to the JAX float64 output no further than the
# larger of the bound and twice the JAX fp32 output's own distance (two
# fp32 runs rounding independently; the port measured 0.7-1.4 times it).
FLOAT64 = {"cnn-ce-IN"}


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    """One config on both sides: the JAX eval forward (compiled once) and
    the port's, on the same variables and batch."""
    name, kw = request.param, VARIANTS[request.param]
    imgs, projs, dv = batch_for(name)
    jmodel = jax_build_model(jax_cfg(**kw), dtype=jnp.float32)
    params, stats = jax_variables(jmodel, jnp.asarray(imgs), jax.tree.map(jnp.asarray, projs),
                                  jnp.asarray(dv), seed=1)
    variables = {"params": params, "batch_stats": stats}
    model = build_model(ModelConfig(**dict(CFG, **kw)), device="cpu")
    load_flax_twin(model, params, stats)
    out = dict(name=name, model=model, params=params, stats=stats,
               jout=jax_forward(kw, variables, imgs, projs, dv),
               tout=port_forward(model, imgs, projs, dv))
    if name in FLOAT64:
        out["jout64"] = jax_forward(kw, variables, imgs, projs, dv, x64=True)
        out["tout64"] = port_forward(copy.deepcopy(model), imgs, projs, dv, torch.float64)
    return out


def outputs(out, stage):
    if stage == "refined":
        return {"depth": out["refined_depth"], "confidence": out["photometric_confidence"]}
    return {"depth_values": out[stage]["depth_values"], "depth": out[stage]["depth"],
            "confidence": out[stage]["photometric_confidence"]}


ATOL = {"depth_values": DEPTH_ATOL, "depth": DEPTH_ATOL, "confidence": CONF_ATOL}


@pytest.mark.parametrize("stage", KEYS + ("refined",))
def test_eval_forward_matches_jax(variant, stage):
    name = variant["name"]
    if name not in FLOAT64:
        want, got = outputs(variant["jout"], stage), outputs(variant["tout"], stage)
        for k in want:
            assert np.isfinite(got[k]).all()
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL[k], err_msg=f"{name} {k}")
        return
    want, got = outputs(variant["jout64"], stage), outputs(variant["tout64"], stage)
    jax32, port32 = outputs(variant["jout"], stage), outputs(variant["tout"], stage)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL[k], err_msg=f"{name} {k}")
        own = float(np.abs(jax32[k] - want[k]).max())
        err = float(np.abs(port32[k] - want[k]).max())
        assert np.isfinite(port32[k]).all() and err <= max(ATOL[k], 2 * own), (k, err, own)


def test_clamped_schedule_reaches_its_floor():
    """The clamp_eth3d scene exercises the clamp: without it, some later
    stage's window would pass the 0.02 inverse-depth floor (depth 50)."""
    from mvsformer_torch.ops import hypotheses

    _, _, dv = batch_for("cnn-ce-clamp_eth3d")
    assert 0.01 <= dv.min() and dv.max() <= 50
    depth = torch.full((1, 8, 8), float(dv.max()))
    hypo = hypotheses.init_inverse_range(torch.from_numpy(dv), 8, 8, 8)
    plain = hypotheses.schedule_inverse_range(depth, hypo, 4, 4.0, 16, 16)
    clamped = hypotheses.schedule_inverse_range(depth, hypo, 4, 4.0, 16, 16,
                                                inv_floor=hypotheses.ETH3D_INV_FLOOR)
    assert float(plain.max()) > 50 and float(clamped.max()) == pytest.approx(50, rel=1e-5)


@pytest.mark.parametrize("dprev", [2, 3, 8])
@pytest.mark.parametrize("clamped", [False, True])
def test_inverse_schedulers_match_jax(dprev, clamped):
    """The inverse-depth schedulers, plain and clamped, against the JAX
    ones on windows that reach the 0.02 floor, after a stage of `dprev`
    hypotheses: after 2, JAX reads the interval of bins 2 and 1 with the
    index clamped (bin 1 twice), as the verify fixture's ndepths 4/4/2/2
    meet it."""
    from mvsformer_torch.ops import hypotheses
    from mvsformer_tpu.ops import hypotheses as jhyp

    rng = np.random.default_rng(dprev)
    depth = rng.uniform(20, 60, (2, 6, 8)).astype(np.float32)
    hypo = np.sort(rng.uniform(15, 70, (2, dprev, 6, 8)), axis=1)[:, ::-1].astype(np.float32)
    name = "schedule_inverse_range_clamped" if clamped else "schedule_inverse_range"
    want = getattr(jhyp, name)(jnp.asarray(depth), jnp.asarray(hypo), 4, 2.0, 12, 16)
    got = hypotheses.schedule_inverse_range(
        torch.from_numpy(depth), torch.from_numpy(hypo.copy()), 4, 2.0, 12, 16,
        inv_floor=hypotheses.ETH3D_INV_FLOOR if clamped else None)
    # in inverse depth, where the schedulers work: near 1/d = 0 a window's
    # depth carries the fp32 rounding of its inverse many times over
    inv_got, inv_want = 1 / got.numpy(), 1 / np.asarray(want)
    np.testing.assert_allclose(inv_got, inv_want, rtol=0, atol=1e-6 * np.abs(inv_want).max())
    init = "init_inverse_range_clamped" if clamped else "init_inverse_range"
    dv = np.array([[5e-3, 40.0], [20.0, 80.0]], np.float32)
    np.testing.assert_allclose(getattr(hypotheses, init)(torch.from_numpy(dv), 8, 6, 8).numpy(),
                               np.asarray(getattr(jhyp, init)(jnp.asarray(dv), 8, 6, 8)),
                               rtol=1e-6)


def test_bridge_round_trips(variant, tmp_path):
    """A reference `.pth` of the port's state (DataParallel's prefix) loads
    back strictly; `convert_flax_grads` of the JAX trees names every
    parameter and running statistic of the port's model."""
    model = variant["model"]
    path = tmp_path / "ref.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}}, path)
    again = build_model(model.cfg, device="cpu")
    load_reference_checkpoint(str(path), again)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    grads, buffers = convert_flax_grads(variant["params"], variant["stats"],
                                        tuple(CFG["ndepths"]), 8)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    assert set(buffers) == {n for n, _ in model.named_buffers()
                            if not n.endswith(".num_batches_tracked")}
    for name, p in model.named_parameters():
        assert torch.equal(grads[name].to(p.dtype), p.detach()), name
    cfg = model.cfg
    if cfg.norm_type != "BN":
        assert not buffers
    if cfg.fusion_type == "epipoleV2":
        assert all(f"fusions.{i}.attn_temp" in grads for i in range(4))
    if cfg.fusion_type != "cnn":
        assert not any(".vis." in n for n in grads)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind,channels", [("GN", 16), ("GN", 12), ("GN", 5), ("IN", 8)])
def test_group_norms_match_flax(kind, channels, dtype):
    """`make_norm`'s GN (min(8, C) groups, lowered until they divide C) and
    IN (C groups), eps 1e-6, against flax's GroupNorm on conv-like
    activations of 2D and 3D maps: 1e-5 in fp32 (flax takes the variance
    as E[x^2] - E[x]^2, torch by a two-pass sum), 1e-12 in float64."""
    import flax.linen as fnn

    from mvsformer_torch.models.blocks import group_count, make_norm

    rng = np.random.default_rng(channels)
    for shape in ((2, channels, 12, 10), (2, channels, 4, 6, 5)):
        x = (0.5 + rng.standard_normal(shape)).astype(dtype)
        scale = (1 + 0.1 * rng.standard_normal(channels)).astype(dtype)
        bias = (0.05 * rng.standard_normal(channels)).astype(dtype)
        norm = make_norm(kind, channels).to(torch.float64 if dtype == np.float64 else torch.float32)
        with torch.no_grad():
            norm.weight.copy_(torch.from_numpy(scale))
            norm.bias.copy_(torch.from_numpy(bias))
            got = norm(torch.from_numpy(x)).numpy()
        flax_gn = fnn.GroupNorm(num_groups=group_count(kind, channels), dtype=dtype,
                                param_dtype=dtype)
        with jax_x64(dtype == np.float64):
            want = np.moveaxis(np.asarray(flax_gn.apply(
                {"params": {"scale": scale, "bias": bias}}, np.moveaxis(x, 1, -1))), -1, 1)
        tol = 1e-5 if dtype == np.float32 else 1e-12
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    assert group_count("GN", 12) == 6 and group_count("GN", 5) == 5 and group_count("IN", 8) == 8


@pytest.mark.parametrize("norm", ["BN", "GN", "IN"])
def test_kernel_routing_follows_the_norm(monkeypatch, norm):
    """The wrappers of K4 (encoder head), K5 (FPN levels) and K2 (the
    visibility CNN) run in eval under BN only, as the JAX package gates its
    kernels on `norm == "BN"`; the choice is made at build time."""
    calls = {"encoder_head": 0, "fpn_level": 0, "visibility_net": 0}

    def counting(mod, name):
        original = getattr(mod, name)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return original(*args, **kwargs)
        monkeypatch.setattr(mod, name, wrapped)

    counting(fpn, "encoder_head")
    counting(fpn, "fpn_level")
    counting(stagenet, "visibility_net")
    model = build_model(ModelConfig(**dict(CFG, norm_type=norm)), device="cpu")
    assert model.encoder.kernel == model.decoder.kernel == (norm == "BN")
    imgs, projs, dv = make_batch(np.random.default_rng(0))
    with torch.inference_mode():
        model(torch.from_numpy(imgs), {k: torch.from_numpy(v) for k, v in projs.items()},
              torch.from_numpy(dv), tmp=TMPS)
    want = {"encoder_head": 1, "fpn_level": 3, "visibility_net": 4} if norm == "BN" else \
        {"encoder_head": 0, "fpn_level": 0, "visibility_net": 0}
    assert calls == want


@pytest.mark.parametrize("field,cfg", [
    ("multi_scale", ModelConfig(multi_scale=True)),
    ("att_fusion=false", ModelConfig(model_type="dino", vit_args=ViTConfig(
        twin=False, vit_arch="vit_small", vit_ch=384, att_fusion=False))),
    ("cross_att", ModelConfig(model_type="dino", vit_args=ViTConfig(
        twin=False, vit_arch="vit_small", vit_ch=384, cross_att=True))),
])
def test_build_model_still_refuses(field, cfg):
    """Each of A6's configurations builds; what is still refused is its
    combination of DINO's att_fusion=false with multi_scale (ROADMAP
    E10), by a ValueError."""
    model = build_model(cfg, device="cpu")
    assert (type(model.decoder).__name__ == "FPNDecoderV2") == (field == "multi_scale")
    refused = copy.deepcopy(cfg)
    refused.model_type, refused.multi_scale = "dino", True
    refused.vit_args = ViTConfig(twin=False, vit_arch="vit_small", vit_ch=384, att_fusion=False)
    with pytest.raises(ValueError, match="att_fusion=false with multi_scale"):
        build_model(refused, device="cpu")


@pytest.mark.parametrize("field,value", [("depth_type", "bimodal"), ("norm_type", "LN"),
                                         ("fusion_type", "attention")])
def test_build_model_names_an_unknown_value(field, value):
    with pytest.raises(ValueError, match=value):
        build_model(ModelConfig(**{field: value}), device="cpu")


# ------------------------------------------------------------------ training

STEPS = {
    "re-GN-mask_out_range": dict(depth_type="re", norm_type="GN", mask_out_range=True),
    "mixup_ce": dict(depth_type="mixup_ce"),
}


def jax_train_step(kw, params, stats, batch):
    """tests/test_torch_train_step.py's `jax_step` for the config `kw`: two
    float64 micro-batches with chained batch stats, averaged gradients,
    the optax AdamW. The model's logits are fp32 on both sides, so are the
    losses."""
    jcfg = JaxModelConfig(**dict(CFG, **kw))
    jcfg.vit_args.drop_path_rate = 0.0
    with jax_x64(True):
        jmodel = jax_build_model(jcfg, dtype=jnp.float64)
        cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)

        def grad_step(p, s, mb):
            dv = mb["depth_values"]

            def loss_fn(p):
                out, upd = jmodel.apply({"params": p, "batch_stats": s}, mb["imgs"],
                                        mb["proj_matrices"], dv, training=True,
                                        mutable=["batch_stats"],
                                        rngs={"droppath": jax.random.PRNGKey(0)})
                loss, ld = jlosses.total_loss(out, mb["depth_gt"], mb["mask"],
                                              dv[:, 1] - dv[:, 0], depth_type=jcfg.depth_type,
                                              inverse_depth=True,
                                              mask_out_range=jcfg.mask_out_range,
                                              stage_keys=KEYS)
                return loss, (ld, upd.get("batch_stats", {}))

            (loss, (ld, new_s)), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
            return loss, ld, new_s, g

        step = jax.jit(grad_step)
        p, s, grads, losses_ = cast(params), cast(stats), None, []
        for i in range(2):
            loss, ld, s, g = step(p, cast(s), cast(micro(batch, i)))
            losses_.append({"loss": float(loss), **{k: float(v) for k, v in ld.items()}})
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        grads = jax.tree.map(lambda x: x / 2, grads)
        tx, _ = make_optimizer(p, JaxOptimizerConfig(**OPT), "twin", total_steps=EPOCHS)
        updates = jax.jit(lambda g, p: tx.update(g, tx.init(p), p)[0])(grads, p)
        new_params = jax.tree.map(jnp.add, p, updates)
        return losses_, to_numpy64(grads), to_numpy64(s), to_numpy64(new_params)


@pytest.fixture(scope="module", params=list(STEPS))
def step(request):
    kw = STEPS[request.param]
    batch = make_train_batch(np.random.default_rng(0))
    jmodel = jax_build_model(jax_cfg(**kw), dtype=jnp.float32)
    params, stats = jax_variables(
        jmodel, jnp.asarray(batch["imgs"][:1]),
        jax.tree.map(lambda x: jnp.asarray(x[:1]), batch["proj_matrices"]),
        jnp.asarray(batch["depth_values"][:1]), seed=2)
    jlosses_, grads, jstats, new_params = jax_train_step(kw, params, stats, batch)

    cfg = Config(arch=ModelConfig(**dict(CFG, **kw)), optimizer=OptimizerConfig(**OPT))
    cfg.arch.vit_args.drop_path_rate = 0.0
    cfg.data.multi_scale_args.scale_batch_map = {"64": 1}
    cfg.trainer.epochs = EPOCHS
    model = build_model(cfg.arch, device="cpu", train=True).double()
    load_flax_twin(model, params, stats)
    metrics = TrainStep(model, cfg)(batch)

    nd = tuple(CFG["ndepths"])
    want_grads, want_stats = convert_flax_grads(grads, jstats, nd, 8)
    want_params, _ = convert_flax_grads(new_params, jstats, nd, 8)
    before, _ = convert_flax_grads(to_numpy64(params), to_numpy64(stats), nd, 8)
    return dict(name=request.param, model=model, metrics=metrics, jlosses=jlosses_,
                want_grads=want_grads, want_stats=want_stats, want_params=want_params,
                before=before)


def test_step_losses_match_jax(step):
    for key in ("loss",) + KEYS:
        want = np.mean([m[key] for m in step["jlosses"]])
        got = step["metrics"]["loss" if key == "loss" else f"loss_{key}"]
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"{step['name']} {key}")


# tests/test_torch_dino.py's bounds for a step from random weights:
# tests/test_torch_train_step.py's, with an elementwise term of the
# tensor's largest entry, since random weights amplify the fp32 parts'
# rounding (the warp, correlation, softmaxes and losses, fp32 on both
# sides) more than the JAX init does.
GRAD_RTOL, GRAD_ATOL, GRAD_OF_SCALE, GRAD_L2, NONZERO = 5e-3, 2e-6, 2e-2, 2e-2, 1e-7


def grad_bound(want):
    return GRAD_ATOL + GRAD_RTOL * np.abs(want) + GRAD_OF_SCALE * float(np.abs(want).max())


def test_step_gradients_match_jax(step):
    named = dict(step["model"].named_parameters())
    assert set(named) == set(step["want_grads"])
    noise_only = chip_smoke.zero_in_exact_arithmetic(torch, step["model"])
    for name, want in step["want_grads"].items():
        got, want = named[name].grad, want.numpy()
        assert got is not None and got.dtype == torch.float64, name
        got = got.numpy()
        assert (np.abs(got - want) <= grad_bound(want)).all(), (name, np.abs(got - want).max())
        norm = float(np.linalg.norm(want))
        if norm > NONZERO and name not in noise_only:
            assert np.linalg.norm(got - want) <= GRAD_L2 * norm, (name, norm)


def test_step_running_stats_match_jax(step):
    buffers = dict(step["model"].named_buffers())
    assert {n for n in buffers if not n.endswith(".num_batches_tracked")} == set(
        step["want_stats"])
    for name, want in step["want_stats"].items():
        np.testing.assert_allclose(buffers[name].numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_step_updated_parameters_match_jax(step):
    """tests/test_torch_train_step.py's bound: within 1e-4 of the LR where
    |g| >= 1e-5 and its sign is certain within the gradient bound; no
    weight moves further than one step."""
    named = dict(step["model"].named_parameters())
    for name, want in step["want_params"].items():
        before = step["before"][name].numpy()
        got = named[name].detach().numpy() - before
        want = want.numpy() - before
        lr = OPT["vit_lr"] if name.startswith("vit.") else OPT["lr"]
        pmax = float(np.abs(before).max())
        ulps = 1e-15 * max(1.0, pmax)
        assert np.abs(got).max() <= lr * (1 + OPT["weight_decay"] * pmax) + ulps, name
        g = step["want_grads"][name].numpy()
        sure = np.abs(g) >= np.maximum(1e-5, grad_bound(g))  # the gradient's sign is certain
        if sure.any():
            np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-4 * lr + ulps,
                                       err_msg=name)
    assert not any(n.endswith(BUFFER_SUFFIXES) for n in step["want_params"])
