"""One training step of the port against the JAX model on the CPU, in
float64.

The full-width TwinMVSNet (alt_gvt_small, feat_chs 8/16/32/64, G=8, cnn
fusion, ce loss, inverse depth) at tests/test_model.py's tiny cascade,
ndepths 8/4/4/2, with drop path 0 (the masks of two frameworks' generators
cannot agree): B=2, V=3, 64x64, two micro-batches of one sample. Both sides
start from the JAX init with randomised BN affine and running stats; the
JAX side chains its batch stats from micro-batch to micro-batch and
averages the gradients, as `train/trainer.py` does, then applies the optax
AdamW of `train/optim.py`. The port runs `TrainStep` (its plain kernel
versions, CPU tensors). Compared: each stage's loss, every gradient, the
BN running statistics after the step, and every parameter after the AdamW
update, through the weight bridge.

Both sides run in float64 (JAX with x64 on, the port's model in double)
around the same fp32 parts: the warp and correlation, the softmaxes, the
3D cost regulariser's BN moments on the JAX side, and the losses. In fp32
this tiny random network amplifies rounding: a change of the images by
1e-6 of their value moves the JAX model's own fp32 gradients by up to
5.3e-2 of a tensor's largest entry, and its float64 ones by 9.2e-5
(tensors of gradient norm above 1e-4; run this file as a module to print
these numbers).
"""

import contextlib

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

from mvsformer_torch.config import Config, ModelConfig, OptimizerConfig
from mvsformer_torch.models.mvsformer import build_model
from mvsformer_torch.train.step import TrainStep
from mvsformer_torch.utils.convert_weights import convert_flax_grads, load_flax_twin

from tests.test_torch_model import CFG, make_batch, randomise_bn, to_numpy
from test_torch_watchdog import watchdog

torch.set_num_threads(4)
hang_watchdog = watchdog()

KEYS = ("stage1", "stage2", "stage3", "stage4")
# The default optimizer, without the warmup (its first step has LR 0).
OPT = dict(vit_lr=3e-5, lr=1e-3, weight_decay=0.01, min_lr=0.01, warmup_steps=0, grad_norm=None)
EPOCHS = 15


def make_train_batch(rng, B=2, V=3, H=64, W=64):
    imgs, projs, dv = make_batch(rng, B=B, V=V, H=H, W=W)
    gt, mask = {}, {}
    for key, scale in zip(KEYS, (8, 4, 2, 1)):
        h, w = H // scale, W // scale
        gt[key] = rng.uniform(430, 890, (B, h, w)).astype(np.float32)
        mask[key] = (rng.uniform(size=(B, h, w)) > 0.1).astype(np.float32)
    return dict(imgs=imgs, proj_matrices=projs, depth_values=dv, depth_gt=gt, mask=mask)


def micro(batch, i):
    return jax.tree.map(lambda x: x[i:i + 1], batch)


def to_numpy64(tree):
    return jax.tree.map(lambda a: np.array(a, np.float64), tree)


@contextlib.contextmanager
def jax_x64(on: bool):
    """JAX's x64 mode switched on or off for the block only."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def jax_model(x64: bool):
    jcfg = JaxModelConfig(**CFG)
    jcfg.vit_args.drop_path_rate = 0.0
    return jax_build_model(jcfg, dtype=jnp.float64 if x64 else jnp.float32)


def init_variables(batch):
    """The JAX init with randomised BN affine and running stats: numpy fp32
    (params, batch_stats)."""
    with jax_x64(True):
        jmodel = jax_model(True)
        variables = jax.jit(lambda k: jmodel.init(
            k, jnp.asarray(batch["imgs"][:1]), jax.tree.map(lambda x: jnp.asarray(x[:1]),
                                                            batch["proj_matrices"]),
            jnp.asarray(batch["depth_values"][:1]), training=False))(jax.random.PRNGKey(0))
    params, stats = to_numpy(variables["params"]), to_numpy(variables["batch_stats"])
    randomise_bn(params, stats, np.random.default_rng(1))
    return params, stats


def jax_step(params, stats, batch, x64: bool = True):
    """One JAX training step in float64 (x64) or fp32: two micro-batches
    with chained batch stats, averaged gradients, then the optax AdamW.
    Returns (per-micro-batch losses, gradients, running stats, parameters
    after the update), the trees as float64 numpy."""
    with jax_x64(x64):
        jmodel = jax_model(x64)
        dt = jnp.float64 if x64 else jnp.float32
        cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dt), tree)

        @jax.jit
        def grad_step(p, s, mb):
            dv = mb["depth_values"]

            def loss_fn(p):
                out, upd = jmodel.apply({"params": p, "batch_stats": s}, mb["imgs"],
                                        mb["proj_matrices"], dv, training=True,
                                        mutable=["batch_stats"],
                                        rngs={"droppath": jax.random.PRNGKey(0)})
                loss, ld = jlosses.total_loss(out, mb["depth_gt"], mb["mask"],
                                              dv[:, 1] - dv[:, 0], depth_type="ce",
                                              focal=False, gamma=2.0, inverse_depth=True,
                                              stage_keys=KEYS)
                return loss, (ld, upd["batch_stats"])

            (loss, (ld, new_s)), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
            return loss, ld, new_s, g

        p, s, grads, losses_ = cast(params), cast(stats), None, []
        for i in range(2):
            loss, ld, s, g = grad_step(p, s, cast(micro(batch, i)))
            losses_.append({"loss": float(loss), **{k: float(v) for k, v in ld.items()}})
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        grads = jax.tree.map(lambda x: x / 2, grads)
        tx, _ = make_optimizer(p, JaxOptimizerConfig(**OPT), "twin", total_steps=EPOCHS)
        updates, _ = tx.update(grads, tx.init(p), p)
        new_params = jax.tree.map(jnp.add, p, updates)
        return losses_, to_numpy64(grads), to_numpy64(s), to_numpy64(new_params)


def run_steps():
    """One training step of each side from the same weights and batch, in
    float64. Returns the port's model and metrics, the JAX losses, and the
    JAX gradients, running statistics and parameters in the port's names."""
    batch = make_train_batch(np.random.default_rng(0))
    params, stats = init_variables(batch)
    jlosses_, grads, jstats, new_params = jax_step(params, stats, batch)

    cfg = Config(arch=ModelConfig(**CFG), optimizer=OptimizerConfig(**OPT))
    cfg.arch.vit_args.drop_path_rate = 0.0
    cfg.data.multi_scale_args.scale_batch_map = {"64": 1}
    cfg.trainer.epochs = EPOCHS
    model = build_model(cfg.arch, device="cpu", train=True).double()
    load_flax_twin(model, params, stats)
    step = TrainStep(model, cfg)
    metrics = step(batch)

    nd, vit_depths = tuple(CFG["ndepths"]), tuple(len(b) for b in model.vit.blocks)
    want_grads, want_stats = convert_flax_grads(grads, jstats, nd, 8, vit_depths)
    want_params, _ = convert_flax_grads(new_params, jstats, nd, 8, vit_depths)
    before, _ = convert_flax_grads(to_numpy64(params), to_numpy64(stats), nd, 8, vit_depths)
    return dict(model=model, metrics=metrics, jlosses=jlosses_, want_grads=want_grads,
                want_stats=want_stats, want_params=want_params, before=before)


@pytest.fixture(scope="module")
def steps():
    return run_steps()


@pytest.mark.parametrize("key", ("loss",) + KEYS)
def test_step_losses_match_jax(steps, key):
    want = np.mean([m[key] for m in steps["jlosses"]])
    got = steps["metrics"]["loss" if key == "loss" else f"loss_{key}"]
    # fp32 log-softmax and masked means on both sides: 5.7e-8 at most.
    np.testing.assert_allclose(got, want, rtol=1e-6)


# The losses are fp32 on both sides, so every gradient carries an absolute
# noise of order 1e-8 (the global norm is about 20). Elementwise, at
# tests/test_parallel.py's rtol of 5e-3, the port needs an atol of 1.5e-7
# against JAX. The gradients of the stage 1-2 visibility CNNs are 1e-6 to
# 1e-4 in norm, so that noise is up to 3.9e-3 of their L2 norm. A few
# tensors are zero in exact arithmetic (the cost regulariser's probability
# bias, ahead of the softmax over depth; biases ahead of a batch norm):
# they hold only that noise and are left to the elementwise check.
GRAD_RTOL, GRAD_ATOL = 5e-3, 2e-6
GRAD_L2 = 2e-2         # ||got - want|| <= GRAD_L2 * ||want|| where ||want|| > NONZERO
NONZERO = 1e-7


def test_step_gradients_match_jax(steps):
    named = dict(steps["model"].named_parameters())
    assert set(named) == set(steps["want_grads"])
    for name, want in steps["want_grads"].items():
        got, want = named[name].grad, want.numpy()
        assert got is not None and got.dtype == torch.float64, name
        got = got.numpy()
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
        norm = float(np.linalg.norm(want))
        if norm > NONZERO:
            assert np.linalg.norm(got - want) <= GRAD_L2 * norm, name


def test_step_running_stats_match_jax(steps):
    """The JAX 3D cost regulariser takes its BN moments in fp32: 1.8e-7 at
    most."""
    buffers = dict(steps["model"].named_buffers())
    for name, want in steps["want_stats"].items():
        np.testing.assert_allclose(buffers[name].numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_step_updated_parameters_match_jax(steps):
    """A first Adam step moves a weight by lr * g / (|g| + 1e-8), about lr
    times the sign of its gradient, plus the decay. Where |g| >= 1e-5, far
    above the gradients' noise, the two updates agree within 1e-4 of the LR
    (8.8e-6 measured); nowhere does a weight move further than one step."""
    named = dict(steps["model"].named_parameters())
    for name, want in steps["want_params"].items():
        before = steps["before"][name].numpy()
        got = named[name].detach().numpy() - before
        want = want.numpy() - before
        lr = OPT["vit_lr"] if name.startswith("vit.") else OPT["lr"]
        pmax = float(np.abs(before).max())
        ulps = 1e-15 * max(1.0, pmax)  # float64 roundings of the weight
        assert np.abs(got).max() <= lr * (1 + OPT["weight_decay"] * pmax) + ulps, name
        sure = np.abs(steps["want_grads"][name].numpy()) >= 1e-5
        if sure.any():
            np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-4 * lr + ulps,
                                       err_msg=name)
            assert np.abs(got[sure]).min() >= 0.5 * lr, name
    assert steps["metrics"]["lr"] == OPT["lr"]
    assert steps["metrics"]["micro_batches"] == 2


# ------------------------------------------------------------------ measurements

def worst_of_scale(a, b, floor=NONZERO):
    """max |a - b| / max |a| over the leaves of two gradient trees whose
    norm in a is above `floor`."""
    worst = 0.0
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        if np.linalg.norm(x) > floor:
            worst = max(worst, float(np.abs(x - y).max() / np.abs(x).max()))
    return worst


def report(steps):
    """The agreement the bounds above are set from."""
    named = dict(steps["model"].named_parameters())
    loss = max(abs(steps["metrics"]["loss" if k == "loss" else f"loss_{k}"]
                   - np.mean([m[k] for m in steps["jlosses"]]))
               / abs(np.mean([m[k] for m in steps["jlosses"]])) for k in ("loss",) + KEYS)
    atol, l2, l2_at, upd = 0.0, 0.0, None, 0.0
    for name, want in steps["want_grads"].items():
        got, want = named[name].grad.numpy(), want.numpy()
        atol = max(atol, float((np.abs(got - want) - GRAD_RTOL * np.abs(want)).max()))
        norm = float(np.linalg.norm(want))
        if norm > NONZERO and np.linalg.norm(got - want) / norm > l2:
            l2, l2_at = float(np.linalg.norm(got - want) / norm), name
        sure = np.abs(want) >= 1e-5
        if sure.any():
            before = steps["before"][name].numpy()
            lr = OPT["vit_lr"] if name.startswith("vit.") else OPT["lr"]
            moved = named[name].detach().numpy() - before
            upd = max(upd, float(np.abs(moved - (steps["want_params"][name].numpy() - before))
                                 [sure].max()) / lr)
    buffers = dict(steps["model"].named_buffers())
    stats = max(float((buffers[n] - w).abs().max()) for n, w in steps["want_stats"].items())
    print(f"float64 step against JAX: losses {loss:.2e} relative; gradients need atol "
          f"{atol:.2e} at rtol {GRAD_RTOL:g}, L2 {l2:.2e} at {l2_at}; updates {upd:.2e} of "
          f"the LR where |g| >= 1e-5; running stats {stats:.2e}")


def conditioning():
    """How far the JAX model's own gradients move with the precision and
    with a change of the images by 1e-6 of their value."""
    batch = make_train_batch(np.random.default_rng(0))
    params, stats = init_variables(batch)
    moved = dict(batch, imgs=batch["imgs"].astype(np.float64) * (1 + 1e-6))
    grads = {(x64, b): jax_step(params, stats, (moved if b else batch), x64)[1]
             for x64 in (True, False) for b in (False, True)}
    for floor in (NONZERO, 1e-4):
        print(f"JAX gradients of norm > {floor:g}, of scale: fp32 against float64 "
              f"{worst_of_scale(grads[True, False], grads[False, False], floor):.2e}; "
              f"images x (1 + 1e-6): fp32 "
              f"{worst_of_scale(grads[False, False], grads[False, True], floor):.2e}, float64 "
              f"{worst_of_scale(grads[True, False], grads[True, True], floor):.2e}")


if __name__ == "__main__":
    # python -m tests.test_torch_train_step: the numbers PERF.md quotes.
    jax.config.update("jax_platforms", "cpu")
    report(run_steps())
    conditioning()
