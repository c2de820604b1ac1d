"""The port's depth types against the JAX package on the CPU, in float64:
the `re`, `was` and `mixup_ce` decodes and losses, beside `ce`'s.

Inputs are drawn from a numpy seed at toy shapes (B = 2, D = 4 to 32,
8x10 to 16x20) and go through both packages in float64, JAX with x64 on.
Each value is held to the JAX one, and each gradient to
`jax.value_and_grad`'s, within 1e-9 of the largest entry (`REL`); the
Sinkhorn loss, ten log-domain iterations, within 1e-8 (`SINKHORN_REL`).

The JAX losses cast their inputs to float32 (an fp32 island for bf16
models), so here they run with `jnp.float32` read as float64 in their
module's namespace (`x64_losses`): the JAX package is unchanged, and the
port's float64 arithmetic is held to the same arithmetic in float64.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformer_tpu.ops import losses as jlosses
from mvsformer_tpu.ops import regression as jreg

from mvsformer_torch.ops import losses, regression
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

REL = 1e-9
SINKHORN_REL = 1e-8
KEYS = ("stage1", "stage2")
T = torch.from_numpy


@contextlib.contextmanager
def jax_x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


class _Float64Numpy:
    """jax.numpy with `float32` read as float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def x64_losses(monkeypatch):
    monkeypatch.setattr(jlosses, "jnp", _Float64Numpy())
    with jax_x64():
        yield


def close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * scale, f"max error {err:.3e}, {err / scale:.3e} of {scale:.3e}"


def softmax(x, axis=1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def logits_of(rng, B, D, H, W):
    return 3.0 * rng.standard_normal((B, D, H, W))


def hypotheses(rng, B, D, H, W, inverse_depth=True):
    """Pixelwise hypotheses over ~425-900, descending in depth for inverse
    depth as the schedulers give them."""
    dv = np.sort(rng.uniform(425, 900, (B, D, H, W)), axis=1)
    return dv[:, ::-1].copy() if inverse_depth else dv


# ------------------------------------------------------------------ decodes

@pytest.mark.parametrize("n,D", [(2, 8), (3, 16), (4, 32), (4, 6), (3, 5)])
def test_conf_regression_matches_jax(rng, n, D):
    prob = softmax(logits_of(rng, 2, D, 8, 10))
    with jax_x64():
        want = jreg.conf_regression(jnp.asarray(prob), n)
    got = regression.conf_regression(T(prob), n)
    assert got.dtype == torch.float64
    close(got.numpy(), want)


@pytest.mark.parametrize("table", [False, True])
def test_mixup_depth_matches_jax(rng, table):
    logits = logits_of(rng, 2, 8, 12, 14)
    dv = hypotheses(rng, 2, 8, 12, 14)
    dv = dv[:, :, 0, 0].copy() if table else dv
    with jax_x64():
        fn = lambda lg: jreg.mixup_depth(jax.nn.softmax(lg, axis=1), jnp.asarray(dv))
        (want_d, want_c) = fn(jnp.asarray(logits))
        want_grad = jax.grad(lambda lg: fn(lg)[0].sum())(jnp.asarray(logits))
    tl = T(logits).requires_grad_()
    got_d, got_c = regression.mixup_depth(torch.softmax(tl, 1), T(dv))
    got_d.sum().backward()
    close(got_d.detach().numpy(), want_d)
    close(got_c.detach().numpy(), want_c)
    close(tl.grad.numpy(), want_grad)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("depth_type", ["ce", "was", "re", "mixup_ce"])
@pytest.mark.parametrize("D", [4, 8, 16, 32])
def test_decode_depth_matches_jax(rng, depth_type, training, D):
    """Depth, confidence (no gradient on either side) and the depth's
    gradient to the logits, for every depth type in training and eval."""
    logits = logits_of(rng, 2, D, 8, 10)
    dv = hypotheses(rng, 2, D, 8, 10)
    tmp = 5.0

    def jfn(lg):
        return jreg.decode_depth(lg, jax.nn.softmax(lg, axis=1), jnp.asarray(dv), depth_type,
                                 D, training, tmp)

    with jax_x64():
        want_d, want_c = jfn(jnp.asarray(logits))
        want_grad = jax.grad(lambda lg: (jfn(lg)[0] * 1e-3).sum())(jnp.asarray(logits))
        want_cgrad = jax.grad(lambda lg: jfn(lg)[1].sum())(jnp.asarray(logits))
    tl = T(logits).requires_grad_()
    got_d, got_c = regression.decode_depth(tl, T(dv), depth_type, tmp, training=training)
    close(got_d.detach().numpy(), want_d)
    close(got_c.detach().numpy(), want_c)
    assert not got_c.requires_grad and not np.asarray(want_cgrad).any()
    if got_d.requires_grad:
        (got_d * 1e-3).sum().backward()
        close(tl.grad.numpy(), want_grad)
    else:
        assert not np.asarray(want_grad).any()


def test_decode_depth_names_an_unknown_depth_type():
    with pytest.raises(ValueError, match="bimodal"):
        regression.decode_depth(torch.zeros(1, 4, 2, 2), torch.ones(1, 4, 2, 2), "bimodal", 1.0)


# ------------------------------------------------------------------ losses

def stages(rng, inverse_depth, shapes=((2, 8, 8, 10), (2, 4, 16, 20))):
    """Per-stage logits, regressed depths, hypotheses, a ground truth partly
    outside the hypotheses, and a mask; float64 numpy."""
    outs, gt, mask = {}, {}, {}
    for key, (B, D, H, W) in zip(KEYS, shapes):
        outs[key] = {"prob_volume_pre": logits_of(rng, B, D, H, W),
                     "depth": rng.uniform(420, 900, (B, H, W)),
                     "depth_values": hypotheses(rng, B, D, H, W, inverse_depth)}
        gt[key] = rng.uniform(400, 920, (B, H, W))
        mask[key] = (rng.uniform(size=(B, H, W)) > 0.2).astype(np.float64)
    return outs, gt, mask


DIV = np.array([10.0, 7.5])
DLOSSW = (1.0, 0.5)


def loss_pair(outs, gt, mask, depth_type, inverse_depth, mask_out_range, wrt):
    """(JAX total, stages, gradient to `wrt` per stage) and the port's."""
    def jax_loss(x):
        o = {k: dict(outs[k], **{wrt: x[k]}) for k in KEYS}
        for k in KEYS:
            o[k]["prob_volume"] = jax.nn.softmax(o[k]["prob_volume_pre"], axis=1)
        return jlosses.total_loss(o, gt, mask, DIV, depth_type, DLOSSW, False, 2.0,
                                  inverse_depth, mask_out_range, stage_keys=KEYS)

    (want, want_stages), want_grad = jax.value_and_grad(jax_loss, has_aux=True)(
        {k: jnp.asarray(outs[k][wrt]) for k in KEYS})
    tx = {k: T(outs[k][wrt]).requires_grad_() for k in KEYS}
    tout = {k: {n: (tx[k] if n == wrt else T(a)) for n, a in outs[k].items()} for k in KEYS}
    got, got_stages = losses.total_loss(tout, {k: T(v) for k, v in gt.items()},
                                        {k: T(v) for k, v in mask.items()}, T(DIV), depth_type,
                                        DLOSSW, False, 2.0, inverse_depth, mask_out_range,
                                        stage_keys=KEYS)
    got.backward()
    assert got.dtype == torch.float64
    return ((want, want_stages, want_grad),
            (got.detach(), {k: v.detach() for k, v in got_stages.items()},
             {k: tx[k].grad for k in KEYS}))


def check_pair(pair, rel=REL):
    (want, want_stages, want_grad), (got, got_stages, got_grad) = pair
    close(got.numpy(), want, rel)
    for k in KEYS:
        close(got_stages[k].numpy(), want_stages[k], rel)
        close(got_grad[k].numpy(), want_grad[k], rel)
    assert float(np.abs(np.asarray(want_grad[KEYS[0]])).max()) > 0


@pytest.mark.parametrize("mask_out_range", [False, True])
@pytest.mark.parametrize("inverse_depth", [True, False])
def test_re_loss_matches_jax(rng, x64_losses, inverse_depth, mask_out_range):
    outs, gt, mask = stages(rng, inverse_depth)
    pair = loss_pair(outs, gt, mask, "re", inverse_depth, mask_out_range, "depth")
    check_pair(pair)
    if mask_out_range:  # some pixels of the mask fall outside the hypotheses
        plain = loss_pair(outs, gt, mask, "re", inverse_depth, False, "depth")
        assert float(pair[1][0]) != float(plain[1][0])


@pytest.mark.parametrize("inverse_depth", [True, False])
def test_mixup_ce_loss_matches_jax(rng, x64_losses, inverse_depth):
    outs, gt, mask = stages(rng, inverse_depth)
    check_pair(loss_pair(outs, gt, mask, "mixup_ce", inverse_depth, False, "prob_volume_pre"))


@pytest.mark.parametrize("inverse_depth", [True, False])
def test_ce_loss_in_float64_matches_jax(rng, x64_losses, inverse_depth):
    outs, gt, mask = stages(rng, inverse_depth)
    check_pair(loss_pair(outs, gt, mask, "ce", inverse_depth, False, "prob_volume_pre"))


def test_was_loss_matches_jax(rng, x64_losses):
    """The trainer's Sinkhorn loss (discrete, 10 iterations, eps 1) through
    `total_loss`, D <= 8 at 8x8."""
    outs, gt, mask = stages(rng, True, shapes=((2, 8, 8, 8), (2, 4, 8, 8)))
    check_pair(loss_pair(outs, gt, mask, "was", True, False, "prob_volume_pre"), SINKHORN_REL)


def jax_sinkhorn(gt, dv, prob, mask, continuous):
    """The JAX Sinkhorn loss. Its continuous form builds the virtual bin's
    cost as [B, 1, H, W] - [D, 1, 1, 1], which broadcasts only at B = 1
    and lays the pixels out right only at H = W = 1 (ROADMAP E7); so that
    form is taken pixel by pixel (vmapped, each pixel a B = H = W = 1
    call with its mask on) and then the masked mean is taken as the JAX
    function takes it."""
    if not continuous:
        return jlosses.sinkhorn_loss(gt, dv, prob, mask)
    D = prob.shape[1]

    def one(g, d, p):
        return jlosses.sinkhorn_loss(g.reshape(1, 1, 1), d.reshape(1, D, 1, 1),
                                     p.reshape(1, D, 1, 1), jnp.ones((1, 1, 1), bool),
                                     continuous=True)

    per_pixel = jax.vmap(one)(gt.reshape(-1), dv.transpose(0, 2, 3, 1).reshape(-1, D),
                              prob.transpose(0, 2, 3, 1).reshape(-1, D))
    m = mask.reshape(-1).astype(per_pixel.dtype)
    return (per_pixel * m).sum() / (m.sum() + 1e-12)


@pytest.mark.parametrize("continuous", [False, True])
def test_sinkhorn_loss_matches_jax(rng, x64_losses, continuous):
    """Both forms of the Sinkhorn loss, value and gradient to the predicted
    distribution's logits; the ground truth lies inside the hypotheses."""
    B, D, H, W = 2, 8, 8, 8
    logits = logits_of(rng, B, D, H, W)
    dv = hypotheses(rng, B, D, H, W)
    gt = rng.uniform(dv[:, -1], dv[:, 0])
    mask = rng.uniform(size=(B, H, W)) > 0.3

    want, want_grad = jax.value_and_grad(lambda lg: jax_sinkhorn(
        jnp.asarray(gt), jnp.asarray(dv), jax.nn.softmax(lg, axis=1), jnp.asarray(mask),
        continuous))(jnp.asarray(logits))
    tl = T(logits).requires_grad_()
    got = losses.sinkhorn_loss(T(gt), T(dv), torch.softmax(tl, 1), T(mask), continuous=continuous)
    got.backward()
    close(float(got.detach()), float(want), SINKHORN_REL)
    close(tl.grad.numpy(), want_grad, SINKHORN_REL)
    assert float(np.abs(np.asarray(want_grad)).max()) > 0


def test_simple_loss_matches_jax(rng, x64_losses):
    est, gt = rng.uniform(0, 3, (2, 8, 10)), rng.uniform(0, 3, (2, 8, 10))
    mask = (rng.uniform(size=(2, 8, 10)) > 0.2).astype(np.float64)
    want, want_grad = jax.value_and_grad(
        lambda e: jlosses.simple_loss(e, jnp.asarray(gt), jnp.asarray(mask)))(jnp.asarray(est))
    te = T(est).requires_grad_()
    got = losses.simple_loss(te, T(gt), T(mask))
    got.backward()
    close(float(got), float(want))
    close(te.grad.numpy(), want_grad)


def test_bimodal_loss_matches_jax(rng, x64_losses):
    keys = ("stage1", "stage2", "stage3")
    shapes = ((2, 8, 10), (2, 16, 20), (2, 16, 20))
    outs, gt, mask = {}, {}, {}
    for key, shape in zip(keys, shapes):
        pi0 = rng.uniform(0.1, 0.9, shape)
        outs[key] = {"depth0": rng.uniform(420, 900, shape), "depth1": rng.uniform(420, 900, shape),
                     "sigma0": rng.uniform(0.5, 3, shape), "sigma1": rng.uniform(0.5, 3, shape),
                     "pi0": pi0, "pi1": 1 - pi0}
        gt[key] = rng.uniform(420, 900, shape)
        mask[key] = (rng.uniform(size=shape) > 0.2).astype(np.float64)

    def jfn(o):
        ld = jlosses.bimodal_loss(o, gt, mask, DIV)
        return sum(ld.values()), ld

    (want, want_stages), want_grad = jax.value_and_grad(jfn, has_aux=True)(
        jax.tree.map(jnp.asarray, outs))
    tout = {k: {n: T(a).requires_grad_() for n, a in o.items()} for k, o in outs.items()}
    got_stages = losses.bimodal_loss(tout, {k: T(v) for k, v in gt.items()},
                                     {k: T(v) for k, v in mask.items()}, T(DIV))
    sum(got_stages.values()).backward()
    close(float(sum(got_stages.values())), float(want))
    for k in keys:
        close(float(got_stages[k]), float(want_stages[k]))
        for n in outs[k]:
            close(tout[k][n].grad.numpy(), want_grad[k][n])


def test_total_loss_names_an_unknown_depth_type(rng):
    outs, gt, mask = stages(rng, True)
    with pytest.raises(ValueError, match="bimodal"):
        losses.total_loss({k: {n: T(a) for n, a in o.items()} for k, o in outs.items()},
                          gt, mask, T(DIV), "bimodal", stage_keys=KEYS)
