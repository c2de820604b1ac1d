"""The port's bf16 training step against the JAX package's (CPU).

tests/test_torch_train_step.py's step (TwinMVSNet at the toy cascade, ce
loss, drop path 0, B=2 as two micro-batches of one, here at 128x128), from
tests/test_torch_variants.py's random variables (non-trivial BN stats),
with alt_gvt_small cut to two blocks a stage (one local, one global
attention; full width), and the model built in bf16 on both sides:
`jax.value_and_grad` of the JAX model built with `dtype=jnp.bfloat16`,
chaining its batch stats from micro-batch to micro-batch and averaging the
gradients, against the port's `TrainStep` on `build_model(...,
dtype=torch.bfloat16)`.

As in tests/test_torch_bf16.py, each bound is a multiple of the JAX
package's own gap, its bf16 step against its fp32 step on the same inputs:
the losses (the total and each stage's) within MULT times that gap in RMS
over the five (one scalar's gap is a single draw of the rounding noise, so
it is pooled; plus 1e-6 of the loss); the gradients per tensor group (each
top-level module, each stage) by chip_smoke.py's `grad_group_check`, the
rule phase 15 holds the card's bf16 step to: relative L2, 1 - cosine and
the norm ratio's distance from 1 within MULT times the gap's plus a floor
(1e-3, the fp32 step's own noise, tests/test_torch_train_step.py; 0.1 for
the norm ratio), the relative L2 under 0.9 and the gap under 0.8 whatever
the gap, so that a zero, unrelated, negated, halved or 1.5 x gradient
fails in every group (`test_bf16_step_gradient_bounds_reject_wrong_
gradients`); the BN running statistics after the step within MULT times
the gap, in the mean and the maximum, plus 1e-6. After the AdamW step the
parameters and the optimizer's moments are fp32, as are the running
statistics; and in the step the losses read fp32 outputs and the training
warp (K7/K8's plain versions here) fp32 features.

At this toy random network the gradient gap is large: at random weights
the stages' probability volumes are nearly flat, so bf16 rounding moves
the argmax that places the next stage's window, and the cost regularisers'
lowest levels hold few values a channel. Measured (`PYTHONPATH=.:tests
python -m tests.test_torch_bf16_step` prints them): JAX's bf16 gradients
lie 0.30-0.66 in relative L2 from its fp32 ones (cosine 0.78-0.96, norm
ratio 0.97-0.99); the port's lie 0.31-0.66 from JAX's bf16 ones, cosine
0.79-0.95, norm ratio 0.987-1.024. The losses' RMS error is 1.08 times
the JAX gap, the running statistics' 0.95 (mean) and 0.54 (max).
"""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformer_tpu.config import ModelConfig as JaxModelConfig
from mvsformer_tpu.models import twins as jtwins
from mvsformer_tpu.models.mvsformer import build_model as jax_build_model
from mvsformer_tpu.ops import losses as jlosses

from mvsformer_torch.config import Config, ModelConfig, OptimizerConfig
from mvsformer_torch.models import stagenet, twins
from mvsformer_torch.models.mvsformer import build_model
from mvsformer_torch.train import step as step_module
from mvsformer_torch.train.step import TrainStep
from mvsformer_torch.utils.convert_weights import convert_flax_grads, load_flax_twin

import chip_smoke
from test_torch_bf16 import MULT, OpDtypes
from test_torch_model import CFG
from test_torch_train_step import EPOCHS, KEYS, OPT, make_train_batch, micro, to_numpy64
from test_torch_variants import jax_variables
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

LOSS_FLOOR = 1e-6   # of the loss
STATS_FLOOR = 1e-6
SIZE = 128
SHALLOW = (2, 2, 2, 2)  # alt_gvt_small's blocks per stage, here
GROUPS = ("encoder", "vit", "decoder_vit", "decoder", "fusions.0", "fusions.1", "fusions.2",
          "fusions.3")


def jax_grads(params, stats, batch, dtype):
    """The JAX step's losses (per micro-batch), averaged gradients and the
    running statistics it leaves, with the model built in `dtype`."""
    jcfg = JaxModelConfig(**CFG)
    jcfg.vit_args.drop_path_rate = 0.0
    jmodel = jax_build_model(jcfg, dtype=dtype)

    @jax.jit
    def grad_step(p, s, mb):
        dv = mb["depth_values"]

        def loss_fn(p):
            out, upd = jmodel.apply({"params": p, "batch_stats": s}, mb["imgs"],
                                    mb["proj_matrices"], dv, training=True,
                                    mutable=["batch_stats"],
                                    rngs={"droppath": jax.random.PRNGKey(0)})
            loss, ld = jlosses.total_loss(out, mb["depth_gt"], mb["mask"], dv[:, 1] - dv[:, 0],
                                          depth_type="ce", focal=False, gamma=2.0,
                                          inverse_depth=True, stage_keys=KEYS)
            return loss, (ld, upd["batch_stats"])

        (loss, (ld, new_s)), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return loss, ld, new_s, g

    s, grads, losses = stats, None, []
    for i in range(2):
        loss, ld, s, g = grad_step(params, s, jax.tree.map(jnp.asarray, micro(batch, i)))
        losses.append({"loss": float(loss), **{k: float(v) for k, v in ld.items()}})
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    return losses, to_numpy64(jax.tree.map(lambda x: x / 2, grads)), to_numpy64(s)


def port_step(params, stats, batch):
    """The port's bf16 TrainStep, its gradients' and the losses' dtypes
    recorded: (model, step, metrics, {site: dtypes})."""
    cfg = Config(arch=ModelConfig(**CFG), optimizer=OptimizerConfig(**OPT))
    cfg.arch.vit_args.drop_path_rate = 0.0
    cfg.data.multi_scale_args.scale_batch_map = {str(SIZE): 1}
    cfg.trainer.epochs = EPOCHS
    model = build_model(cfg.arch, device="cpu", train=True, dtype=torch.bfloat16)
    load_flax_twin(model, params, stats)
    step = TrainStep(model, cfg)
    seen = collections.defaultdict(set)
    warp, loss_fn = stagenet.WarpCorrTrain, step_module.total_loss

    class Warp:
        @staticmethod
        def apply(*args):
            seen["warp inputs"].update(a.dtype for a in args if isinstance(a, torch.Tensor))
            return warp.apply(*args)

    def total_loss(out, *args, **kwargs):
        seen["loss inputs"].update(out[k][n].dtype for k in KEYS
                                   for n in ("depth", "prob_volume_pre", "depth_values"))
        loss, stage_losses = loss_fn(out, *args, **kwargs)
        seen["losses"].update(t.dtype for t in (loss, *stage_losses.values()))
        return loss, stage_losses

    agree = {}
    hooks = chip_smoke.entropy_agreement_hooks(torch, model, batch["imgs"].shape[1] - 1, agree)
    ops = OpDtypes()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stagenet, "WarpCorrTrain", Warp)
        mp.setattr(step_module, "total_loss", total_loss)
        with ops:
            metrics = step(batch)
    for h in hooks:
        h.remove()
    seen.update({f"op:{k}": v for k, v in ops.seen.items()})
    seen["flat entropy stages"] = {i for i, shares in agree.items() if max(shares) == 1.0}
    return model, step, metrics, dict(seen)


def shallow_gvt_small(dtype=jnp.bfloat16, drop_path_rate=0.2, fused_attn=False):
    return jtwins.ALTGVT(embed_dims=(64, 128, 256, 512), num_heads=(2, 4, 8, 16),
                         depths=SHALLOW, drop_path_rate=drop_path_rate, dtype=dtype,
                         fused_attn=fused_attn)


def run(mp):
    """Both sides' steps with alt_gvt_small at SHALLOW depths (`mp` patches
    the presets of both packages)."""
    mp.setattr(jtwins, "alt_gvt_small", shallow_gvt_small)
    mp.setitem(twins.PRESETS, "alt_gvt_small", dict(twins.PRESETS["alt_gvt_small"],
                                                    depths=SHALLOW))
    batch = make_train_batch(np.random.default_rng(0), H=SIZE, W=SIZE)
    first = jax.tree.map(jnp.asarray, micro(batch, 0))
    params, stats = jax_variables(jax_build_model(JaxModelConfig(**CFG), dtype=jnp.float32),
                                  first["imgs"], first["proj_matrices"], first["depth_values"],
                                  seed=0)
    jax_side = {dt: jax_grads(params, stats, batch, dt) for dt in (jnp.float32, jnp.bfloat16)}
    model, step, metrics, seen = port_step(params, stats, batch)
    nd, vit_depths = tuple(CFG["ndepths"]), tuple(len(b) for b in model.vit.blocks)
    want = {}
    for dt, (losses, grads, jstats) in jax_side.items():
        g, s = convert_flax_grads(grads, jstats, nd, 8, vit_depths)
        want[dt] = dict(losses=losses, grads=g, stats=s)
    return dict(model=model, step=step, metrics=metrics, seen=seen, j32=want[jnp.float32],
                j16=want[jnp.bfloat16])


@pytest.fixture(scope="module")
def steps():
    with pytest.MonkeyPatch.context() as mp:
        return run(mp)


def flat(tensors):
    return np.concatenate([np.asarray(t, np.float64).ravel() for t in tensors])


def group_grads(steps):
    """{group: (port, JAX bf16, JAX fp32) gradients, flat}."""
    named = dict(steps["model"].named_parameters())
    out = {}
    for group in GROUPS:
        names = [n for n in steps["j16"]["grads"] if n == group or n.startswith(group + ".")]
        out[group] = (flat(named[n].grad for n in names),
                      *(flat(steps[k]["grads"][n] for n in names) for k in ("j16", "j32")))
    return out


def losses(steps):
    """(port, JAX bf16, JAX fp32) of the total and each stage's loss, the
    means over the micro-batches."""
    return [np.array([np.mean([m[k] for m in steps[side]["losses"]]) for k in ("loss",) + KEYS])
            for side in ("j16", "j32")]


def test_bf16_step_losses_match_jax(steps):
    j16, j32 = losses(steps)
    got = np.array([steps["metrics"]["loss" if k == "loss" else f"loss_{k}"]
                    for k in ("loss",) + KEYS])
    assert np.isfinite(got).all()
    rms = lambda x: float(np.sqrt(np.mean(x ** 2)))
    assert rms(j16 - j32) > 0
    assert rms(got - j16) <= MULT * rms(j16 - j32) + LOSS_FLOOR * abs(j32[0]), (got, j16, j32)


@pytest.mark.parametrize("group", GROUPS)
def test_bf16_step_gradients_match_jax(steps, group):
    assert all(p.grad.dtype == torch.float32 for p in steps["model"].parameters()
               if p.grad is not None)
    got, j16, j32 = group_grads(steps)[group]
    ok, r = chip_smoke.grad_group_check(got, j16, j32)
    assert r["gap"] > 0
    assert ok, r


@pytest.mark.parametrize("mutant", ("zero", "random", "negated", "half", "x1.5"))
def test_bf16_step_gradient_bounds_reject_wrong_gradients(steps, mutant):
    """The bounds above can fail: each group rejects the port's gradient
    made zero, replaced by noise of its norm, negated, halved or scaled by
    3/2."""
    for group, (got, j16, j32) in group_grads(steps).items():
        wrong = chip_smoke.grad_mutants(got)[mutant]
        assert not chip_smoke.grad_group_check(wrong, j16, j32)[0], group


def test_bf16_step_running_stats_match_jax(steps):
    buffers = dict(steps["model"].named_buffers())
    names = sorted(steps["j16"]["stats"])
    assert names and all(buffers[n].dtype == torch.float32 for n in names)
    got = flat(buffers[n] for n in names)
    j16, j32 = (flat(steps[k]["stats"][n] for n in names) for k in ("j16", "j32"))
    err, gap = np.abs(got - j16), np.abs(j16 - j32)
    assert err.mean() <= MULT * gap.mean() + STATS_FLOOR, (err.mean(), gap.mean())
    assert err.max() <= MULT * gap.max() + STATS_FLOOR, (err.max(), gap.max())


def test_bf16_step_keeps_parameters_and_optimizer_state_fp32(steps):
    assert steps["model"].compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in steps["model"].parameters())
    moments = [t for st in steps["step"].optimizer.state.values() for t in st.values()
               if torch.is_tensor(t) and t.dim() > 0]
    assert moments and all(t.dtype == torch.float32 for t in moments)
    assert steps["metrics"]["micro_batches"] == 2 and np.isfinite(steps["metrics"]["loss"])


def test_bf16_step_islands_are_fp32(steps):
    seen = steps["seen"]
    assert seen["warp inputs"] == {torch.float32}
    assert seen["loss inputs"] == {torch.float32} and seen["losses"] == {torch.float32}
    for op in ("softmax", "batch_norm", "layer_norm", "upsample_bicubic2d"):
        assert seen.get(f"op:{op}") == {torch.float32}, op
    assert torch.bfloat16 in seen["op:conv"]


if __name__ == "__main__":
    # PYTHONPATH=.:tests python -m tests.test_torch_bf16_step: the numbers the docstring quotes.
    jax.config.update("jax_platforms", "cpu")
    with pytest.MonkeyPatch.context() as mp:
        result = run(mp)
    for group, grads in group_grads(result).items():
        ok, r = chip_smoke.grad_group_check(*grads)
        print(f"{group}: relative L2 {r['err']:.4f} (JAX gap {r['gap']:.4f}); cosine "
              f"{r['cos']:.4f} (JAX gap {r['cos_gap']:.4f}); norm ratio {r['norm']:.4f} (JAX "
              f"gap {r['norm_gap']:.4f}); {'ok' if ok else 'FAILED'}")
    j16s, j32s = losses(result)
    gots = np.array([result["metrics"]["loss" if k == "loss" else f"loss_{k}"]
                     for k in ("loss",) + KEYS])
    for key, got, j16, j32 in zip(("loss",) + KEYS, gots, j16s, j32s):
        print(f"{key}: port {got:.6f}, JAX bf16 {j16:.6f}, JAX fp32 {j32:.6f}")
    print(f"RMS over the losses: port - JAX bf16 {np.sqrt(np.mean((gots - j16s) ** 2)):.3e}, "
          f"JAX bf16 - fp32 {np.sqrt(np.mean((j16s - j32s) ** 2)):.3e}")
    buffers = dict(result["model"].named_buffers())
    names = sorted(result["j16"]["stats"])
    got = flat(buffers[n] for n in names)
    j16, j32 = (flat(result[k]["stats"][n] for n in names) for k in ("j16", "j32"))
    print(f"running stats: port - JAX bf16 mean {np.abs(got - j16).mean():.3e} max "
          f"{np.abs(got - j16).max():.3e}; JAX gap mean {np.abs(j16 - j32).mean():.3e} max "
          f"{np.abs(j16 - j32).max():.3e}")




def test_bf16_step_zero_gradients_are_zero_in_exact_arithmetic(steps):
    """bf16 turns some gradients that are zero in exact arithmetic, which
    fp32 fills with rounding noise, into exact zeros. At random weights a
    stage's correlation is almost flat over depth, so its entropy lies
    within one bf16 step of log(D) at every pixel of every view: the
    visibility CNN reads the same map for each view of a micro-batch
    (chip_smoke.py's `entropy_agreement_hooks` notes it), the views' weights are
    equal and its gradient is zero in exact arithmetic (but for the 1e-6 in
    the view mean's denominator); JAX casts the entropy to bf16 as well (its
    StageNet). The others are tests/test_torch_variants.py's:
    the cost regularisers' probability biases, ahead of the softmax over
    depth, and the biases of convs ahead of a batch norm. Only those may
    hold an all-zero gradient, and the other stages' visibility CNNs do
    not."""
    model = steps["model"]
    zero = {n for n, p in model.named_parameters() if p.grad is not None and not bool(p.grad.any())}
    flat = tuple(f"fusions.{i}.vis." for i in steps["seen"]["flat entropy stages"])
    allowed = chip_smoke.zero_in_exact_arithmetic(torch, model)
    assert not [n for n in zero if not n.startswith(flat) and n not in allowed]
    others = [n for n, _ in model.named_parameters() if ".vis." in n and not n.startswith(flat)]
    assert others and not zero.intersection(others)
