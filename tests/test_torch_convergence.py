"""The mini-convergence gates (tests/test_convergence.py) through the port
(CPU, slow).

Each JAX test's scene, configuration (tests/test_model.py tiny_cfg: GN, ce,
full-width alt_gvt_small, ndepths 8/4/4/2, drop path 0), learning rate,
step count, evaluation cadence and thresholds, unchanged; the port trains
its own model (`build_model(cfg, device="cpu")`, fp32) with its
`ops/losses.total_loss` in `chip_smoke.gate_train`'s loop (torch's Adam
with optax.adam's betas and eps) on the committed scenes
(`chip_smoke.plane_scenes`, tests/test_torch_gates.py holds them to
`make_scene` bit for bit). Both packages start from the JAX init at
PRNGKey(0), carried across by the weight bridge, and the JAX loop runs
beside the port's on the same scenes. The first 3 losses are held within
1e-4 relative of the JAX loop's where rounding cannot part the two loops
(`along_the_jax_loop`, `check_first_losses`): the port's loss at the JAX
loop's weights before each of its first 3 steps (the first at the shared
init), and its Adam, fed the JAX loop's gradients, within a few float32
roundings of optax's weights after each. The port's own loop's first
losses are printed beside them, not compared: Adam's first steps move every
weight by about lr times the sign of its gradient, so a weight whose
gradient lies within the two frameworks' rounding of zero moves the other
way, and the gates' own second and third losses part from the JAX loop's
by up to 3.6e-4 relative (tests/test_torch_train_step.py measures the
same on one step; the T&T gate's own loop reads the port's scan, whose
images are within a grey level of the JAX scan's, and parts from its
first loss: 6.6e-4, then 1.9e-3 and 9.6e-3). After
that the two trajectories are printed side by side and not compared, and
each must meet the gate's thresholds.
`chip_smoke.py` phase 19 runs the same gates on the card.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_convergence.py -m slow -rA
"""

import functools
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mvsformer_tpu.models.mvsformer import build_model as jax_build_model
from mvsformer_tpu.ops import losses as jlosses
from mvsformer_torch.models.mvsformer import build_model
from mvsformer_torch.utils.convert_weights import convert_flax_grads, load_flax_twin

import chip_smoke
from tests import test_convergence as conv
from tests.test_model import tiny_cfg
from test_torch_watchdog import watchdog

torch.set_num_threads(4)
hang_watchdog = watchdog(3000)

FIRST_LOSSES = 3
LOSS_RTOL = 1e-4
# One Adam step from the same weights and gradients: a few float32 roundings
# of the weight and of the update (a step moves a weight by about lr).
WEIGHT_RTOL, WEIGHT_ATOL_LR = 1e-6, 1e-4


def jax_gate_loop(depth_type, imgs, projs, dv, gt, mask, lr, steps, eval_fn=None,
                  eval_every=0):
    """The JAX gates' loop as their tests write it: tiny_cfg (GN,
    `depth_type`, drop path 0), init at PRNGKey(0) with training=False,
    optax.adam(lr), a jitted value_and_grad step on `total_loss`;
    `eval_fn(model, params)` -> scalar before the first step and every
    `eval_every` steps. Returns {"params": the weights before each of the
    first FIRST_LOSSES steps and after the last of them, "grads": those
    steps' gradients (numpy trees), "losses", "errors"}."""
    cfg = tiny_cfg(ndepths=[8, 4, 4, 2], norm_type="GN", depth_type=depth_type)
    cfg.vit_args.drop_path_rate = 0.0
    model = jax_build_model(cfg, dtype=jnp.float32)
    params = jax.jit(lambda k: model.init(k, imgs, projs, dv, training=False))(
        jax.random.PRNGKey(0))["params"]
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            out = model.apply({"params": p, "batch_stats": {}}, imgs, projs, dv, training=True)
            loss, _ = jlosses.total_loss(out, gt, mask, dv[:, 1] - dv[:, 0],
                                         depth_type=depth_type)
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    numpy = functools.partial(jax.tree.map, np.asarray)
    evaluate = jax.jit(lambda p: eval_fn(model, p)) if eval_fn else None
    res = {"params": [numpy(params)], "grads": [], "losses": [], "errors": []}
    if evaluate:
        res["errors"].append(float(evaluate(params)))
    for i in range(steps):
        params, opt_state, loss, grads = step(params, opt_state)
        res["losses"].append(float(loss))
        if i < FIRST_LOSSES:
            res["params"].append(numpy(params))
            res["grads"].append(numpy(grads))
        if evaluate and (i + 1) % eval_every == 0:
            res["errors"].append(float(evaluate(params)))
    return res


def port_model(depth_type, jax_params):
    """The port's gate model on the CPU, in training mode, from the JAX init."""
    model = build_model(chip_smoke.gate_config(depth_type), device="cpu", train=True)
    load_flax_twin(model, jax_params, {})
    return model


def along_the_jax_loop(depth_type, batch, jres, lr):
    """The port on the JAX loop's path, where rounding cannot part them:
    its training loss at the JAX loop's weights before each of its first
    FIRST_LOSSES steps, and its Adam (`chip_smoke.gate_train`'s: torch's,
    with optax.adam's betas and eps) fed the JAX loop's gradients from the
    JAX init. Returns (the losses, each step's largest |port - JAX| weight
    gap over the tolerance `WEIGHT_RTOL * |w| + WEIGHT_ATOL_LR * lr`)."""
    from mvsformer_torch.ops.losses import total_loss

    model = port_model(depth_type, jres["params"][0])
    itv = batch["dv"][:, 1] - batch["dv"][:, 0]
    losses = []
    with torch.no_grad():
        for params in jres["params"][:FIRST_LOSSES]:
            load_flax_twin(model, params, {})
            out = model(batch["imgs"], batch["projs"], batch["dv"])
            losses.append(float(total_loss(out, batch["gt"], batch["mask"], itv,
                                           depth_type=depth_type)[0]))
    load_flax_twin(model, jres["params"][0], {})
    named = dict(model.named_parameters())
    opt = torch.optim.Adam(named.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    cfg = model.cfg
    layout = (tuple(cfg.ndepths), cfg.model_th, tuple(len(b) for b in model.vit.blocks))
    gaps = []
    for grads, after in zip(jres["grads"], jres["params"][1:]):
        for name, g in convert_flax_grads(grads, {}, *layout)[0].items():
            named[name].grad = g.clone()
        opt.step()
        want = convert_flax_grads(after, {}, *layout)[0]
        gaps.append(max(float(((p.detach() - want[n]).abs()
                               / (WEIGHT_RTOL * want[n].abs() + WEIGHT_ATOL_LR * lr)).max())
                        for n, p in named.items()))
    return losses, gaps


def check_first_losses(port, jax_losses, along):
    """The first FIRST_LOSSES losses: the port's along the JAX loop
    (`along_the_jax_loop`; the first is its loss at the shared init on the
    JAX loop's inputs) within LOSS_RTOL relative of the JAX loop's, and its
    Adam's weights within tolerance of optax's after each step. Its own
    loop's first losses are printed beside them, not compared (the
    analytic-plane gates' own loops read the port's scan, whose images are
    within a grey level of the JAX scan's)."""
    along_losses, gaps = along

    def rel(a, b):
        return np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))

    for what, got in (("the port's own loop", port[:FIRST_LOSSES]),
                      ("the port at the JAX loop's weights", along_losses)):
        print(f"first losses, {what} / JAX: "
              + ", ".join(f"{g:.7f} / {w:.7f}" for g, w in zip(got, jax_losses))
              + f"; relative {', '.join(f'{r:.2e}' for r in rel(got, jax_losses[:len(got)]))}")
    print(f"the port's Adam from the JAX loop's gradients: weight gap / tolerance "
          f"{', '.join(f'{g:.3f}' for g in gaps)}")
    assert len(along_losses) == len(gaps) == FIRST_LOSSES
    assert (rel(along_losses, jax_losses[:FIRST_LOSSES]) <= LOSS_RTOL).all(), (
        along_losses, jax_losses[:FIRST_LOSSES])
    assert max(gaps) <= 1.0, gaps


def side_by_side(what, port, jax_values):
    print(f"{what}, port | JAX:")
    for i, (p, j) in enumerate(zip(port, jax_values)):
        print(f"  {i:3d}  {p:10.4f} | {j:10.4f}")


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def stacked(dicts):
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}


@pytest.mark.slow
def test_loss_decreases_on_planar_scenes():
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    scenes = [conv.make_scene(rng, depth) for depth in chip_smoke.CONV_DEPTHS]
    parts = list(zip(*scenes))
    arrays = (np.stack(parts[0]), stacked(parts[1]), np.stack(parts[2]), stacked(parts[3]),
              stacked(parts[4]))
    jres = jax_gate_loop("ce", *map(to_jax, arrays), lr=chip_smoke.CONV_LOSS["lr"],
                         steps=chip_smoke.CONV_LOSS["steps"])
    t_jax = time.perf_counter() - t0

    committed, _ = chip_smoke.plane_scenes()
    batch = chip_smoke.scenes_batch(torch, committed, "cpu")
    model = port_model("ce", jres["params"][0])
    res = chip_smoke.gate_train(torch, model, batch, chip_smoke.CONV_LOSS["lr"],
                                chip_smoke.CONV_LOSS["steps"], "ce")
    t_port = time.perf_counter() - t0 - t_jax
    along = along_the_jax_loop("ce", batch, jres, chip_smoke.CONV_LOSS["lr"])
    print(f"seconds: JAX loop {t_jax:.1f}, port loop {t_port:.1f}, along the JAX loop "
          f"{time.perf_counter() - t0 - t_jax - t_port:.1f}")
    side_by_side("losses", res["losses"], jres["losses"])
    check_first_losses(res["losses"], jres["losses"], along)
    for history in (res["losses"], jres["losses"]):
        early, late = np.mean(history[:4]), np.mean(history[-4:])
        assert np.isfinite(history).all()
        assert late < early * 0.85, f"loss did not learn: {early:.3f} -> {late:.3f}"


@pytest.mark.slow
def test_overfit_reaches_subinterval_depth_accuracy():
    t0 = time.perf_counter()
    depth_true = chip_smoke.CONV_DEPTH1
    imgs, projs, dv, gt, mask = conv.make_scene(np.random.default_rng(1), depth_true)
    arrays = (imgs[None], {k: v[None] for k, v in projs.items()}, dv[None],
              {k: v[None] for k, v in gt.items()}, {k: v[None] for k, v in mask.items()})
    jarrays = tuple(map(to_jax, arrays))
    itv = float(dv[1] - dv[0])

    def jax_err(model, p):
        out = model.apply({"params": p, "batch_stats": {}}, jarrays[0], jarrays[1], jarrays[2],
                          training=False, tmp=[5.0, 5.0, 5.0, 1.0])
        return jnp.abs(out["refined_depth"] - depth_true).mean()

    fit = chip_smoke.CONV_FIT
    jres = jax_gate_loop("ce", *jarrays, lr=fit["lr"], steps=fit["steps"], eval_fn=jax_err,
                         eval_every=fit["eval_every"])
    t_jax = time.perf_counter() - t0

    _, one = chip_smoke.plane_scenes()
    batch = chip_smoke.scenes_batch(torch, [one], "cpu")
    model = port_model("ce", jres["params"][0])

    def err(m):
        return (chip_smoke.gate_eval(torch, m, batch) - depth_true).abs().mean()

    res = chip_smoke.gate_train(torch, model, batch, fit["lr"], fit["steps"], "ce",
                                eval_err=err, eval_every=fit["eval_every"])
    t_port = time.perf_counter() - t0 - t_jax
    along = along_the_jax_loop("ce", batch, jres, fit["lr"])
    print(f"seconds: JAX loop {t_jax:.1f}, port loop {t_port:.1f}, along the JAX loop "
          f"{time.perf_counter() - t0 - t_jax - t_port:.1f}")
    side_by_side("losses", res["losses"], jres["losses"])
    side_by_side(f"eval error every {fit['eval_every']} steps", res["errors"], jres["errors"])
    check_first_losses(res["losses"], jres["losses"], along)
    for errors in (res["errors"], jres["errors"]):
        err0, best = errors[0], min(errors)
        assert np.isfinite(best)
        assert best < 1.5 * itv, f"best error {best:.2f} >= 1.5*interval ({itv:.2f})"
        assert best < 0.15 * err0, f"error never dropped: {err0:.2f} -> best {best:.2f}"
    assert res["best_err"] == min(res["errors"])
