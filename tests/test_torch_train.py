"""The parts of the port's training step against the JAX package on the CPU:
the ce and focal losses, AdamW with the Twins groups and the warmup-cosine
schedule against optax, train-mode batch norm against flax, the micro-batch
split, and stochastic depth.
"""

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformer_tpu.config import OptimizerConfig as JaxOptimizerConfig
from mvsformer_tpu.ops import losses as jlosses
from mvsformer_tpu.ops import regression as jreg
from mvsformer_tpu.train import optim as joptim

from mvsformer_torch.config import Config, OptimizerConfig
from mvsformer_torch.models.blocks import FoldedBatchNorm
from mvsformer_torch.models.twins import ALTGVT, drop_path
from mvsformer_torch.ops import losses, regression
from mvsformer_torch.train.optim import build_optimizer, warmup_cosine_factor
from mvsformer_torch.train.step import _clip_by_global_norm, micro_batches
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

T = torch.from_numpy
KEYS = ("stage1", "stage2")


# ------------------------------------------------------------------ losses

def stage_outputs(rng, inverse_depth, shapes=((2, 8, 6, 7), (2, 4, 12, 14))):
    """Per-stage logits, pixelwise hypotheses (descending in depth for
    inverse depth, as the schedulers give them), ground truth partly outside
    the hypothesis range, and a mask."""
    outs, gt, mask = {}, {}, {}
    for key, (B, D, H, W) in zip(KEYS, shapes):
        dv = np.sort(rng.uniform(420, 900, (B, D, H, W)).astype(np.float32), axis=1)
        if inverse_depth:
            dv = dv[:, ::-1].copy()
        outs[key] = {"prob_volume_pre": (3 * rng.standard_normal((B, D, H, W))).astype(np.float32),
                     "depth_values": dv}
        gt[key] = rng.uniform(400, 920, (B, H, W)).astype(np.float32)
        mask[key] = (rng.uniform(size=(B, H, W)) > 0.2).astype(np.float32)
    return outs, gt, mask


@pytest.mark.parametrize("inverse_depth", [True, False])
@pytest.mark.parametrize("focal", [False, True])
def test_ce_losses_and_their_gradients_match_jax(rng, inverse_depth, focal):
    outs, gt, mask = stage_outputs(rng, inverse_depth)
    dlossw = (1.0, 0.5)
    div = np.full((2,), 10.0, np.float32)

    def jax_loss(logits):
        o = {k: dict(outs[k], prob_volume_pre=logits[k]) for k in KEYS}
        total, stages = jlosses.total_loss(o, gt, mask, div, "ce", dlossw, focal, 2.0,
                                           inverse_depth, stage_keys=KEYS)
        return total, stages

    jlogits = {k: jnp.asarray(outs[k]["prob_volume_pre"]) for k in KEYS}
    (want, want_stages), want_grad = jax.value_and_grad(jax_loss, has_aux=True)(jlogits)

    tlogits = {k: T(outs[k]["prob_volume_pre"]).requires_grad_() for k in KEYS}
    tout = {k: {"prob_volume_pre": tlogits[k], "depth_values": T(outs[k]["depth_values"])}
            for k in KEYS}
    got, got_stages = losses.total_loss(tout, {k: T(v) for k, v in gt.items()},
                                        {k: T(v) for k, v in mask.items()}, T(div), "ce",
                                        dlossw, focal, 2.0, inverse_depth, stage_keys=KEYS)
    got.backward()
    # fp32 log-softmax and masked means on both sides.
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k in KEYS:
        np.testing.assert_allclose(float(got_stages[k]), float(want_stages[k]), rtol=1e-6)
        np.testing.assert_allclose(tlogits[k].grad.numpy(), np.asarray(want_grad[k]),
                                   rtol=1e-5, atol=1e-8)


def test_range_and_bins_match_jax(rng):
    outs, gt, _ = stage_outputs(rng, True)
    dv, g = outs["stage1"]["depth_values"], gt["stage1"]
    idx, in_range, flipped = losses._range_and_bins(T(dv), T(g), True)
    jidx, jin, jflipped = jlosses._range_and_bins(jnp.asarray(dv), jnp.asarray(g), True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(in_range.numpy(), np.asarray(jin))
    np.testing.assert_array_equal(flipped.numpy(), np.asarray(jflipped))
    assert 0 < in_range.mean() < 1


@pytest.mark.parametrize("depth_type", ["re", "was", "mixup_ce"])
def test_re_was_and_mixup_ce_losses_match_jax(rng, depth_type):
    """Each of the other depth types' losses gives the JAX loss on these
    outputs (fp32; the float64 values and gradients are
    tests/test_torch_depth_types.py's)."""
    outs, gt, mask = stage_outputs(rng, True)
    for k in KEYS:  # the re loss reads the regressed depth, the was loss the softmax
        outs[k]["depth"] = rng.uniform(420, 900, gt[k].shape).astype(np.float32)
        outs[k]["prob_volume"] = np.asarray(jax.nn.softmax(outs[k]["prob_volume_pre"], axis=1))
    div = np.full((2,), 10.0, np.float32)
    want, _ = jlosses.total_loss(outs, gt, mask, div, depth_type, stage_keys=KEYS)
    got, _ = losses.total_loss({k: {n: T(a) for n, a in o.items()} for k, o in outs.items()},
                               {k: T(v) for k, v in gt.items()},
                               {k: T(v) for k, v in mask.items()}, T(div), depth_type,
                               stage_keys=KEYS)
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_training_decode_matches_jax(rng):
    """The training decode: the depth of the argmax bin (first on a tie),
    and max-probability confidence, neither carrying a gradient."""
    logits = (3 * rng.standard_normal((2, 6, 5, 7))).astype(np.float32)
    logits[0, 2, 0, 0] = logits[0, 4, 0, 0] = 50.0  # a tie
    dv = np.sort(rng.uniform(420, 900, (2, 6, 5, 7)).astype(np.float32), axis=1)
    tl = T(logits).requires_grad_()
    depth, conf = regression.decode_depth(tl, T(dv), "ce", 1.0, training=True)
    jl = jnp.asarray(logits)
    want_d, want_c = jreg.decode_depth(jl, jax.nn.softmax(jl, axis=1), jnp.asarray(dv), "ce", 6,
                                       training=True, tmp=1.0)
    np.testing.assert_array_equal(depth.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(conf.numpy(), np.asarray(want_c), rtol=1e-6)
    assert depth[0, 0, 0] == dv[0, 2, 0, 0]
    assert not depth.requires_grad and not conf.requires_grad
    idx = T(rng.integers(0, 6, (2, 5, 7)))
    np.testing.assert_array_equal(
        regression.select_bin(T(dv), idx).numpy(),
        np.asarray(jreg.select_bin(jnp.asarray(dv), jnp.asarray(idx.numpy()))))


# ------------------------------------------------------------------ optimizer

class Toy(torch.nn.Module):
    """A parameter tree with the names the optimizer groups by: backbone
    matrices (decayed), backbone vectors and pos_embed (not decayed), and
    the rest."""

    def __init__(self, rng):
        super().__init__()
        p = lambda *s: torch.nn.Parameter(T(rng.standard_normal(s).astype(np.float32)))
        self.vit = torch.nn.Module()
        self.vit.w = p(4, 3)
        self.vit.b = p(3)
        self.vit.pos_embed = p(1, 5, 3)
        self.head = torch.nn.Module()
        self.head.w = p(3, 2)
        self.head.b = p(2)


def flax_tree(model):
    return {"vit": {n.split(".")[1]: jnp.asarray(p.detach().numpy())
                    for n, p in model.named_parameters() if n.startswith("vit.")},
            "head": {n.split(".")[1]: jnp.asarray(p.detach().numpy())
                     for n, p in model.named_parameters() if n.startswith("head.")}}


@pytest.mark.parametrize("grad_norm,fix", [(None, False), (0.5, False), (None, True)])
def test_adamw_groups_and_schedule_match_optax(rng, grad_norm, fix):
    """Four steps, two of warmup and two of the cosine, with the same
    gradients on both sides; the clip and the frozen backbone as options."""
    kw = dict(vit_lr=3e-3, lr=1e-2, weight_decay=0.1, min_lr=0.01, warmup_steps=2,
              grad_norm=grad_norm)
    model = Toy(rng)
    params = flax_tree(model)
    tx, _ = joptim.make_optimizer(params, JaxOptimizerConfig(**kw), "twin", total_steps=6,
                                  fix_backbone=fix)
    state = tx.init(params)
    optimizer, scheduler = build_optimizer(model, OptimizerConfig(**kw), 6, fix=fix)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for _ in range(4):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32)
                 for n, p in model.named_parameters()}
        if fix:
            grads = {n: (0 * g if n.startswith("vit.") else g) for n, g in grads.items()}
        jgrads = {"vit": {}, "head": {}}
        for n, g in grads.items():
            jgrads[n.split(".")[0]][n.split(".")[1]] = jnp.asarray(g)
        updates, state = tx.update(jgrads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)

        trainable = [p for n, p in model.named_parameters() if p.requires_grad]
        for n, p in model.named_parameters():
            p.grad = T(grads[n]) if p.requires_grad else None
        if grad_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in trainable]))
            _clip_by_global_norm([p.grad for p in trainable], grad_norm, norm)
        optimizer.step()
        scheduler.step()
        want = flax_tree_to_named(params)
        for n, p in model.named_parameters():
            # fp32 Adam on both sides; the LR is computed in fp32 by optax.
            np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-5, atol=1e-6,
                                       err_msg=n)
    for n, p in model.named_parameters():
        moved = not torch.equal(p.detach(), start[n])
        assert moved == (not (fix and n.startswith("vit."))), n


def flax_tree_to_named(params):
    return {f"{top}.{k}": np.asarray(v) for top, sub in params.items() for k, v in sub.items()}


def test_param_groups_split_as_the_jax_masks_do():
    from mvsformer_torch.config import ModelConfig
    from mvsformer_torch.models.mvsformer import TwinMVSNet
    from mvsformer_torch.train.optim import param_groups

    model = TwinMVSNet(ModelConfig(ndepths=[8, 4, 4, 2]))
    groups = {g["group"]: g for g in param_groups(model, OptimizerConfig())}
    named = dict(model.named_parameters())
    assert sum(len(g["names"]) for g in groups.values()) == len(named)
    for name in groups["vit_decay"]["names"]:
        assert name.startswith("vit.") and named[name].dim() > 1
    for name in groups["vit_no_decay"]["names"]:
        assert name.startswith("vit.") and named[name].dim() == 1
    assert all(not n.startswith("vit.") for n in groups["rest"]["names"])
    assert groups["vit_decay"]["weight_decay"] == 0.01
    assert groups["vit_no_decay"]["weight_decay"] == 0.0 == groups["rest"]["weight_decay"]
    assert groups["vit_decay"]["lr"] == 3e-5 and groups["rest"]["lr"] == 1e-3


def test_warmup_cosine_matches_jax():
    fn = joptim.warmup_cosine_schedule(1.0, 500, 12000, 0.01)
    for step in (0, 1, 250, 499, 500, 501, 6000, 11999, 12000):
        # optax's schedule runs in fp32, the port's in Python floats.
        np.testing.assert_allclose(warmup_cosine_factor(step, 500, 12000, 0.01),
                                   float(fn(step)), rtol=3e-6, atol=1e-9)


# ------------------------------------------------------------------ batch norm

@pytest.mark.parametrize("shape", [(6, 5, 7, 9), (2, 4, 3, 5, 6)])
def test_train_batch_norm_matches_flax(rng, shape):
    """Output and running statistics after two training forwards: flax
    updates the running variance with the biased batch variance (torch's own
    batch norm uses the unbiased one), momentum 0.9, eps 1e-5."""
    C = shape[1]
    xs = [(2 + 3 * rng.standard_normal(shape)).astype(np.float32) for _ in range(2)]
    scale = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    mean0 = (0.1 * rng.standard_normal(C)).astype(np.float32)
    var0 = (1 + 0.2 * np.abs(rng.standard_normal(C))).astype(np.float32)

    bn = FoldedBatchNorm(C).train()
    with torch.no_grad():
        bn.weight.copy_(T(scale))
        bn.bias.copy_(T(bias))
        bn.running_mean.copy_(T(mean0))
        bn.running_var.copy_(T(var0))
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    for x in xs:
        cl = np.moveaxis(x, 1, -1)  # flax normalises the last axis
        want, upd = fbn.apply(variables, jnp.asarray(cl), mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        got = bn(T(x))
        np.testing.assert_allclose(got.detach().numpy(), np.moveaxis(np.asarray(want), -1, 1),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(variables["batch_stats"]["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(variables["batch_stats"]["var"]), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ the step's pieces

def test_micro_batches_follow_scale_batch_map():
    batch = {"imgs": torch.arange(6).float().view(6, 1, 1, 1, 1).expand(6, 2, 64, 8, 3),
             "proj_matrices": {"stage1": torch.arange(6).float().view(6, 1)},
             "depth_values": torch.zeros(6, 4)}
    for want, sbm in ((2, {"64": 2}), (3, {"64": 4}), (6, {"512": 4}), (1, {"64": 1})):
        micros = micro_batches(batch, sbm)
        assert len(micros) == 6 // want
        assert [m["proj_matrices"]["stage1"][:, 0].tolist() for m in micros] == \
            [list(range(i, i + want)) for i in range(0, 6, want)]
    assert Config().data.multi_scale_args.scale_batch_map["512"] == 4


def test_drop_path_ramp_and_per_sample_mask():
    """The linear rate ramp over all blocks (twins.py:220-228) and one
    keep/drop draw per sample, kept samples scaled by 1/(1-rate)."""
    net = ALTGVT(drop_path_rate=0.2)
    rates = [blk.drop_path_rate for stage in net.blocks for blk in stage]
    assert len(rates) == 18
    np.testing.assert_allclose(rates, [0.2 * i / 17 for i in range(18)])
    x = torch.ones((64, 3, 4, 5))
    y = drop_path(x, 0.5, torch.Generator().manual_seed(0))
    per_sample = y.reshape(64, -1)
    assert set(per_sample.unique().tolist()) <= {0.0, 2.0}
    assert (per_sample == per_sample[:, :1]).all()  # one draw per sample
    assert 0 < (per_sample[:, 0] == 0).sum() < 64
    same = drop_path(x, 0.5, torch.Generator().manual_seed(0))
    torch.testing.assert_close(y, same, rtol=0, atol=0)
    assert drop_path(x, 0.0) is x
