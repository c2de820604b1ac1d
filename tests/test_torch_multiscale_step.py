"""Training the multi-scale models, and both multi-scale models over the
process grid (CPU).

- One float64 training step of TwinMVSNet under `multi_scale` against
  `jax.value_and_grad` and optax, as tests/test_torch_train_step.py holds
  the default model's step and at its bounds: the JAX init with
  randomised BN affine and running statistics, carried by the weight
  bridge; B=2 as two micro-batches of one, V=3, 64x64, ndepths 8/4/4/2,
  drop path 0. Compared: the losses, every gradient, the BN running
  statistics and the parameters after AdamW.
- Over gloo ranks (tests/test_torch_parallel_ranks.py's `run_ranks`), in
  float64 against the port's serial computation on the same weights: the
  multi-scale Twins step at data 2 with SyncBN (the decoders' BN over both
  ranks' samples) against the serial step on the whole batch with the
  data-parallel loss (`chip_smoke.serial_ddp_grads`), and the multi-scale
  DINO eval forward at view 2 (two of the four sources a rank) with
  `want_similarity` against the serial forward: the refined outputs, and
  each stage's sim_depth, whose cosine sums join the view all-reduce
  (held by `chip_smoke.similarity_agreement` to the serial sums).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformer_tpu.config import ModelConfig as JaxModelConfig
from mvsformer_tpu.models.mvsformer import build_model as jax_build_model

from mvsformer_torch.config import Config, ModelConfig, OptimizerConfig, ViTConfig
from mvsformer_torch.models import stagenet
from mvsformer_torch.models.mvsformer import build_model, random_init_
from mvsformer_torch.train.step import TrainStep
from mvsformer_torch.utils.convert_weights import convert_flax_grads, load_flax_twin

import chip_smoke
from test_torch_model import CFG, TMPS, make_batch, randomise_bn, to_numpy
from test_torch_parallel_ranks import run_ranks, train_config
from test_torch_train_step import (EPOCHS, GRAD_ATOL, GRAD_L2, GRAD_RTOL, NONZERO, OPT, jax_x64,
                                   make_train_batch, to_numpy64)
from test_torch_variants import jax_train_step
from test_torch_watchdog import watchdog

torch.set_num_threads(4)
hang_watchdog = watchdog()

KEYS = ("stage1", "stage2", "stage3", "stage4")
MS = dict(multi_scale=True)


@pytest.fixture(scope="module")
def step():
    batch = make_train_batch(np.random.default_rng(0))
    with jax_x64(True):
        jcfg = JaxModelConfig(**CFG, **MS)
        jcfg.vit_args.drop_path_rate = 0.0
        jmodel = jax_build_model(jcfg, dtype=jnp.float64)
        variables = jax.jit(lambda k: jmodel.init(
            k, jnp.asarray(batch["imgs"][:1]),
            jax.tree.map(lambda x: jnp.asarray(x[:1]), batch["proj_matrices"]),
            jnp.asarray(batch["depth_values"][:1]), training=False))(jax.random.PRNGKey(0))
    params, stats = to_numpy(variables["params"]), to_numpy(variables["batch_stats"])
    randomise_bn(params, stats, np.random.default_rng(1))
    jlosses_, grads, jstats, new_params = jax_train_step(MS, params, stats, batch)

    cfg = Config(arch=ModelConfig(**CFG, **MS), optimizer=OptimizerConfig(**OPT))
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
    return dict(model=model, metrics=metrics, jlosses=jlosses_, want_grads=want_grads,
                want_stats=want_stats, want_params=want_params, before=before)


@pytest.mark.parametrize("key", ("loss",) + KEYS)
def test_step_losses_match_jax(step, key):
    want = np.mean([m[key] for m in step["jlosses"]])
    got = step["metrics"]["loss" if key == "loss" else f"loss_{key}"]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_step_gradients_match_jax(step):
    """tests/test_torch_train_step.py's bounds, every gradient of the
    multi-scale decoders among them."""
    named = dict(step["model"].named_parameters())
    assert set(named) == set(step["want_grads"])
    assert any(n.startswith("decoder.upsample3.") for n in named)
    assert any(n.startswith("decoder_vit.decoder2.") for n in named)
    for name, want in step["want_grads"].items():
        got, want = named[name].grad, want.numpy()
        assert got is not None and got.dtype == torch.float64, name
        got = got.numpy()
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
        norm = float(np.linalg.norm(want))
        if norm > NONZERO:
            assert np.linalg.norm(got - want) <= GRAD_L2 * norm, name


def test_step_running_stats_match_jax(step):
    buffers = dict(step["model"].named_buffers())
    assert {n for n in buffers if not n.endswith(".num_batches_tracked")} == set(
        step["want_stats"])
    for name, want in step["want_stats"].items():
        np.testing.assert_allclose(buffers[name].numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_step_updated_parameters_match_jax(step):
    """tests/test_torch_train_step.py's bound: within 1e-4 of the LR where
    |g| >= 1e-5; no weight moves further than one step."""
    named = dict(step["model"].named_parameters())
    for name, want in step["want_params"].items():
        before = step["before"][name].numpy()
        got = named[name].detach().numpy() - before
        want = want.numpy() - before
        lr = OPT["vit_lr"] if name.startswith("vit.") else OPT["lr"]
        pmax = float(np.abs(before).max())
        ulps = 1e-15 * max(1.0, pmax)
        assert np.abs(got).max() <= lr * (1 + OPT["weight_decay"] * pmax) + ulps, name
        sure = np.abs(step["want_grads"][name].numpy()) >= 1e-5
        if sure.any():
            np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-4 * lr + ulps,
                                       err_msg=name)


# ------------------------------------------------------------------ the process grid

# float64 on both sides around the fp32 parts (the warp, the softmaxes and
# the losses), the sums in another order: measured 4.0e-8 relative in the
# loss, at most 1.1e-7 in relative L2 per gradient but for those zero in
# exact arithmetic (biases ahead of a BN, ~1e-17 in norm), 8.7e-16 in the
# running statistics.
GRID_LOSS_RTOL = 1e-6
GRID_GRAD_L2 = 1e-5     # ||rank - serial|| <= this * ||serial||
GRID_NOISE_ATOL = 1e-12  # the gradients zero in exact arithmetic
GRID_STATS_RTOL = 1e-10


def test_data_parallel_multi_scale_step_matches_the_serial_step(tmp_path):
    cfg = train_config("BN", MS)
    model = random_init_(build_model(cfg.arch, device="cpu", train=True),
                         torch.Generator().manual_seed(3)).double()
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    batch = make_train_batch(np.random.default_rng(0))
    torch.save(batch, tmp_path / "batch.pt")
    ranks = run_ranks(tmp_path, 2, dict(kind="step", data=2, view=1, cfg=MS, dtype="float64",
                                        weights=str(tmp_path / "weights.pt"),
                                        batch=str(tmp_path / "batch.pt")))
    tensors = {k: ({s: torch.from_numpy(a).double() for s, a in v.items()}
                   if isinstance(v, dict) else torch.from_numpy(v).double())
               for k, v in batch.items()}
    loss, grads = chip_smoke.serial_ddp_grads(torch, model, tensors, 2, 2, cfg.arch)
    buffers = dict(model.named_buffers())
    synced = [n for n in buffers if n.startswith(("decoder.", "decoder_vit."))
              and n.endswith("running_var")]
    assert synced
    noise_only = chip_smoke.zero_in_exact_arithmetic(torch, model)
    for r in ranks:
        np.testing.assert_allclose(r["metrics"]["loss"], loss, rtol=GRID_LOSS_RTOL)
        assert set(r["grads"]) == set(grads)
        for name, want in grads.items():
            err = float((r["grads"][name] - want).norm())
            if name in noise_only:
                assert float((r["grads"][name] - want).abs().max()) <= GRID_NOISE_ATOL, name
            else:
                assert err <= GRID_GRAD_L2 * float(want.norm()), (name, err)
        for name in synced:  # SyncBN: the running statistics of the whole batch
            np.testing.assert_allclose(r["buffers"][name].numpy(), buffers[name].numpy(),
                                       rtol=GRID_STATS_RTOL, err_msg=name)


def test_view_split_multi_scale_dino_forward_matches_the_serial_forward(tmp_path):
    over = dict(MS, model_type="dino", vit_args=dict(twin=False, vit_arch="vit_small",
                                                     vit_ch=384, out_ch=64))
    cfg = train_config("BN", dict(over, vit_args=ViTConfig(**over["vit_args"])))
    model = random_init_(build_model(cfg.arch, device="cpu"), torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    imgs, projs, dv = make_batch(np.random.default_rng(0), V=5)
    torch.save((torch.from_numpy(imgs), {k: torch.from_numpy(v) for k, v in projs.items()},
                torch.from_numpy(dv)), tmp_path / "request.pt")
    ranks = run_ranks(tmp_path, 2, dict(kind="similarity", data=1, view=2, cfg=over,
                                        weights=str(tmp_path / "weights.pt"),
                                        request=str(tmp_path / "request.pt"), tmps=TMPS))
    volumes, original = [], stagenet.cosine_similarity_volume

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
    for r in ranks:  # fp32: the view sums' order differs
        np.testing.assert_allclose(r["depth"].numpy(), out["refined_depth"].numpy(), rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(r["conf"].numpy(), out["photometric_confidence"].numpy(),
                                   rtol=0, atol=1e-5)
        for i, sim in enumerate(r["sim_depth"]):
            share, shortfall = chip_smoke.similarity_agreement(
                sim, out[f"stage{i + 1}"]["depth_values"],
                sum(volumes[i * views:(i + 1) * views]))
            assert share >= chip_smoke.SIM_SHARE and shortfall <= chip_smoke.SIM_ATOL, (
                i, share, shortfall)
