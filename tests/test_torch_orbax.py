"""A JAX run's orbax checkpoints through `tools/orbax_to_torch.py`, then
served and resumed by the port (CPU).

The JAX side writes its checkpoints here with its own `CheckpointManager`
(`mvsformer_tpu/train/checkpoint.py`), after two steps of its
`make_optimizer` chain, and the converter turns the run directory into the
port's. Both models start from the port's `random_init_` weights carried to
JAX by the JAX package's `convert_full_*`.

- TwinMVSNet (tests/test_torch_model.py's toy cascade, ndepths 8/4/4/2 at
  full width, drop path 0) with `focal` (gamma 2) and a `grad_norm` clip
  that binds, the warmup-cosine schedule mid-warmup: two float64 JAX
  training steps on one batch (B=1, V=3, 64x64), saved as model_last
  (the run's validation did not improve); then (b) a third,
  the JAX step from the restored orbax state against the port's `Trainer`
  resumed from the converted `.pth` (`resume_auto`, the path of `python -m
  mvsformer_torch.train --resume`), on the same batch in float64: the
  gradients within tests/test_torch_dino.py's float64 step bounds (those
  of tests/test_torch_train_step.py with a term of the tensor's scale),
  `global_step` and every tensor's LR equal, and the JAX chain from the
  restored state, given the port's gradient, moves the parameters and
  Adam's moments as the port did (float64; the LR within the JAX
  schedule's fp32 rounding).
- DINOMVSNet (vit_small, the -p config's arch with the ViT trained) with
  `layer_decay` 0.75 and the clip: two optax updates from seeded
  gradients, saved; then the third update from the restored state against
  the port's resumed optimizer given the same gradient (the clip as its
  `TrainStep` applies it): parameters within 1e-6 of the LR, moments 3e-5
  of their scale. The DINO model's own gradient parity is
  tests/test_torch_dino.py's.
- (a) For both models, the port's eval forward from the converted `.pth`
  against the JAX model's forward from the restored orbax tree, fp32,
  within tests/test_torch_model.py's bounds (depth 1e-2, confidence
  1e-4); and `python -m mvsformer_torch.test --ckpt_dir OUT_DIR` serves
  the converted Twins run.
- (c) A params-only export (no `opt_state`) as model_best and model_last
  converts, each present, to a `.pth` without `optimizer`, which
  `finetune(restore_opt=False)` takes and
  `finetune(restore_opt=True)` and `resume_auto` refuse.
- (d) Finding only orbax directories, the test CLI, `resume_auto` and
  `finetune` raise, naming the converter's command.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

pytest.importorskip("orbax.checkpoint")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mvsformer_tpu.config import Config as JaxConfig  # noqa: E402
from mvsformer_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from mvsformer_tpu.config import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from mvsformer_tpu.config import ViTConfig as JaxViTConfig  # noqa: E402
from mvsformer_tpu.config import save_config as jax_save_config  # noqa: E402
from mvsformer_tpu.models.mvsformer import build_model as jax_build_model  # noqa: E402
from mvsformer_tpu.ops import losses as jlosses  # noqa: E402
from mvsformer_tpu.train.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from mvsformer_tpu.train.optim import lr_scale_tree, make_optimizer  # noqa: E402
from mvsformer_tpu.utils.convert_weights import convert_full_dino, convert_full_twin  # noqa: E402

from mvsformer_torch.config import load_config  # noqa: E402
from mvsformer_torch.infer import make_infer_fn  # noqa: E402
from mvsformer_torch.models.mvsformer import build_model, random_init_  # noqa: E402
from mvsformer_torch.train.step import _clip_by_global_norm  # noqa: E402
from mvsformer_torch.train.trainer import Trainer  # noqa: E402
from mvsformer_torch.utils.convert_weights import (convert_flax_grads,  # noqa: E402
                                                   load_reference_checkpoint)
from tools.orbax_to_torch import convert_run  # noqa: E402

from test_torch_model import CFG, make_batch  # noqa: E402
from test_torch_train_step import (GRAD_ATOL, GRAD_RTOL, jax_x64, make_train_batch,  # noqa: E402
                                   to_numpy64)
from test_torch_watchdog import watchdog  # noqa: E402

torch.set_num_threads(4)
hang_watchdog = watchdog()

KEYS = ("stage1", "stage2", "stage3", "stage4")
JAX_FLAGS = dict(fused_enc_head=False, fused_fpn_final=False, fused_fpn_l2=False)
DINO_VIT = dict(twin=False, vit_arch="vit_small", vit_ch=384, out_ch=64, att_fusion=True)
TMPS = [5.0, 5.0, 5.0, 1.0]
DEPTH_ATOL, CONF_ATOL = 1e-2, 1e-4   # tests/test_torch_model.py's bounds
STEPS_PER_EPOCH, EPOCHS = 5, 4       # a schedule of 20 steps
# The clip binds: the toy models' global norms are tens at random weights.
OPT = dict(vit_lr=3e-5, lr=1e-3, weight_decay=0.01, layer_decay=0.75, min_lr=0.01,
           warmup_steps=4, grad_norm=0.5)
SAVED_STEP = 2
LR_RTOL = 1e-6  # the JAX schedule is float32


class Loader:
    def __len__(self):
        return STEPS_PER_EPOCH


class Quiet:
    def info(self, msg):
        pass


def jax_config(name, arch, save_dir):
    cfg = JaxConfig(name=name, arch=arch, optimizer=JaxOptimizerConfig(**OPT))
    cfg.trainer.epochs, cfg.trainer.save_dir = EPOCHS, save_dir
    cfg.data.multi_scale_args.scale_batch_map = {"64": 1}
    return cfg


def write_run(run_dir, jcfg, state, global_step, best=True):
    """A JAX run directory: config.json, and the JAX manager's model_best
    and model_last at `global_step` (one validation that improved), or
    model_last alone."""
    os.makedirs(run_dir, exist_ok=True)
    jax_save_config(jcfg, os.path.join(run_dir, "config.json"))
    mgr = JaxManager(run_dir, jcfg.trainer.monitor)
    if not best:
        mgr.best = 0.0  # no improvement: the manager saves model_last alone
    mgr.step(1, 0.5, state, extra_meta={"global_step": global_step})


def global_norm(tree) -> float:
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(x, np.float64)))
                             for x in jax.tree.leaves(tree))))


def as_numpy(tree, dtype):
    """The floating leaves as numpy arrays of `dtype`, the others (the
    optimizer's counts) as numpy arrays of their own dtype, so that a
    jitted function given a restored state does not compile again (on the
    host: a per-leaf jnp cast would compile once per shape)."""
    def leaf(a):
        a = np.asarray(a)
        return a.astype(dtype) if np.issubdtype(a.dtype, np.floating) else a

    return jax.tree.map(leaf, tree)


def jitted(tx):
    """(the update applied to the parameters, the state's init) of an optax
    chain, each one compile."""
    def apply(g, state, p):
        updates, state = tx.update(g, state, p)
        return jax.tree.map(jnp.add, p, updates), state

    return jax.jit(apply), jax.jit(tx.init)


def port_state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def moments(opt, model):
    names = {p: n for n, p in model.named_parameters()}
    return {names[p]: s for p, s in opt.state.items()}


# ------------------------------------------------------------------ TwinMVSNet

def twin_arch(jax_side):
    over = dict(CFG, focal=True, gamma=2.0)
    if jax_side:
        arch = JaxModelConfig(**over, **JAX_FLAGS)
    else:
        from mvsformer_torch.config import ModelConfig
        arch = ModelConfig(**over)
    arch.vit_args.drop_path_rate = 0.0
    return arch


def jax_grad_fn(jmodel):
    """A float64 JAX training step's loss, gradient and batch statistics
    (one micro-batch, the focal ce loss)."""
    @jax.jit
    def grad_step(p, s, mb):
        dv = mb["depth_values"]

        def loss_fn(p):
            out, upd = jmodel.apply({"params": p, "batch_stats": s}, mb["imgs"],
                                    mb["proj_matrices"], dv, training=True,
                                    mutable=["batch_stats"],
                                    rngs={"droppath": jax.random.PRNGKey(0)})
            loss, _ = jlosses.total_loss(out, mb["depth_gt"], mb["mask"], dv[:, 1] - dv[:, 0],
                                         depth_type="ce", focal=True, gamma=2.0,
                                         inverse_depth=True, stage_keys=KEYS)
            return loss, upd["batch_stats"]

        (loss, new_s), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return loss, new_s, g

    return grad_step


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """Two JAX steps, the orbax run, the converted run, the port's step
    resumed from it, and from the restored orbax state the JAX step on the
    same batch and the JAX update given the port's gradient."""
    tmp = tmp_path_factory.mktemp("twin")
    model = random_init_(build_model(twin_arch(False), device="cpu"),
                         torch.Generator().manual_seed(0))
    vd = tuple(len(b) for b in model.vit.blocks)
    nd = tuple(CFG["ndepths"])
    params, stats = convert_full_twin(port_state(model), ndepths=nd, model_th=8, vit_depths=vd)
    batch = make_train_batch(np.random.default_rng(0), B=1)
    jcfg = jax_config("twin", twin_arch(True), str(tmp / "jax"))
    run = str(tmp / "jax" / "models" / "twin")
    out = str(tmp / "port" / "models" / "twin")
    with jax_x64(True):
        jmodel = jax_build_model(jcfg.arch, dtype=jnp.float64)
        cast = lambda tree: as_numpy(tree, np.float64)
        grad_step = jax_grad_fn(jmodel)
        mb = cast(batch)
        tx, schedule = make_optimizer(cast(params), jcfg.optimizer, "twin",
                                      STEPS_PER_EPOCH * EPOCHS)
        apply, init = jitted(tx)
        p, s = cast(params), cast(stats)
        opt_state = init(p)
        norms = []
        for _ in range(SAVED_STEP):
            _, s, g = grad_step(p, cast(s), mb)
            norms.append(global_norm(g))
            p, opt_state = apply(g, opt_state, p)
        # Saved in fp32, as a JAX run keeps its state.
        write_run(run, jcfg, as_numpy({"params": p, "batch_stats": s,
                                       "opt_state": opt_state}, np.float32), SAVED_STEP,
                  best=False)

        converted = convert_run(run, out, log=lambda *a: None)
        files = sorted(os.listdir(out))
        cfg = load_config(os.path.join(out, "config.json"))
        resumed = build_model(cfg.arch, device="cpu", train=True).double()
        trainer = Trainer(cfg, Loader(), model=resumed, logger=Quiet())
        trainer.init_state()
        info = trainer.resume_auto()
        group_lrs = {n: g["lr"] for g in trainer.optimizer.param_groups for n in g["names"]}
        step_before = trainer.global_step
        metrics = trainer.step(batch)
        port_grads = {n: q.grad.numpy() for n, q in resumed.named_parameters()}

        # The JAX trainer's restore into its template, then the step.
        restored, meta = JaxManager(run).restore("model_last", {
            "params": p, "batch_stats": s, "opt_state": init(p)})
        p, s, opt_state = (cast(restored[k]) for k in ("params", "batch_stats", "opt_state"))
        restored_vars = as_numpy({"params": p, "batch_stats": s}, np.float32)
        count = int(opt_state[0][1].count)
        _, s, g = grad_step(p, s, mb)
        norms.append(global_norm(g))
        given, _ = convert_full_twin(dict(port_state(resumed), **port_grads), ndepths=nd,
                                     model_th=8, vit_depths=vd)
        new_p, new_state = apply(cast(given), opt_state, p)
        scales = lr_scale_tree(p, jcfg.optimizer, "twin")
        clip = min(1.0, OPT["grad_norm"] / norms[-1])
        jax_side = dict(before=to_numpy64(p), grads=to_numpy64(jax.tree.map(
            lambda x: x * clip, g)), params=to_numpy64(new_p), mu=to_numpy64(
            new_state[0][1].mu), nu=to_numpy64(new_state[0][1].nu), stats=to_numpy64(s),
            lr=float(schedule(count)), count=count, meta=meta, norms=norms)

    def port_names(tree):
        return convert_flax_grads(tree, jax_side["stats"], nd, 8, vd)[0]

    return dict(run=run, out=out, converted=converted, files=files, cfg=cfg, trainer=trainer,
                info=info, metrics=metrics, group_lrs=group_lrs, step_before=step_before,
                jax=jax_side, restored=restored_vars,
                want={k: port_names(jax_side[k]) for k in ("before", "grads", "params", "mu",
                                                            "nu")},
                want_scales=port_names(jax.tree.map(lambda v, x: np.full(np.shape(x), v),
                                                    scales, jax_side["before"])),
                params=params, stats=stats, jcfg=jcfg)


def test_the_converter_writes_the_port_layout(twin):
    assert twin["converted"] == ["model_last"]
    assert twin["files"] == ["config.json", "model_last.meta.json", "model_last.pth"]
    state = torch.load(os.path.join(twin["out"], "model_last.pth"), weights_only=False)
    assert {"arch", "epoch", "state_dict", "optimizer", "monitor_best", "config", "scheduler",
            "global_step"} <= set(state)
    assert state["arch"] == "TwinMVSNet" and state["global_step"] == SAVED_STEP
    with open(os.path.join(twin["run"], "model_last.meta.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(twin["out"], "model_last.meta.json")) as f:
        assert json.load(f) == jmeta
    # The converted run is its own run dir: --config OUT/config.json --resume finds it.
    cfg = twin["cfg"]
    assert os.path.join(cfg.trainer.save_dir, "models", cfg.name) == twin["out"]
    assert cfg.arch.focal and cfg.optimizer.grad_norm == OPT["grad_norm"]


def test_the_resumed_step_is_the_jax_step_from_the_restored_state(twin):
    """`resume_auto` starts at the saved step; the step's LR is the JAX
    schedule at the restored count, times each tensor's scale; the clip
    binds on both sides."""
    assert twin["info"] == {"start_epoch": 2, "skip_batches": 0}
    assert twin["step_before"] == twin["jax"]["count"] == SAVED_STEP
    assert twin["trainer"].global_step == SAVED_STEP + 1
    lr = twin["jax"]["lr"]
    assert 0 < lr < OPT["lr"]  # mid-warmup: step 2 of 4
    assert math.isclose(twin["metrics"]["lr"], lr, rel_tol=1e-6)
    for name, got in twin["group_lrs"].items():
        want = lr * float(twin["want_scales"][name].flatten()[0])
        assert math.isclose(got, want, rel_tol=1e-6), name
    assert min(twin["jax"]["norms"]) > OPT["grad_norm"]
    assert math.isclose(twin["metrics"]["grad_norm"], twin["jax"]["norms"][-1], rel_tol=1e-4)


# tests/test_torch_dino.py's float64 step bounds (tests/test_torch_train_step.py's
# with a term of the tensor's largest entry for the fp32 islands' noise), in
# units of the clipped gradient.
GRAD_OF_SCALE, GRAD_L2, NONZERO = 2e-2, 2e-2, 1e-7


def test_the_resumed_gradients_match_the_jax_step(twin):
    """The focal step's clipped gradients against the JAX step's on the
    same batch from the restored state."""
    scale = OPT["grad_norm"] / twin["jax"]["norms"][-1]
    named = dict(twin["trainer"].model.named_parameters())
    for name, want in twin["want"]["grads"].items():
        got, want = named[name].grad.numpy(), want.numpy()
        atol = GRAD_ATOL * scale + GRAD_OF_SCALE * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol, err_msg=name)
        norm = float(np.linalg.norm(want))
        if norm > NONZERO * scale:
            assert np.linalg.norm(got - want) <= GRAD_L2 * norm, name


def test_the_resumed_update_is_the_jax_update(twin):
    """From the restored orbax state, the JAX chain given the port's
    (clipped) gradient moves every parameter and Adam moment as the
    resumed port did, float64 on both sides: the moments within 1e-12 of
    their scale, the parameters within 1e-6 of each tensor's LR (the JAX
    schedule computes the LR in fp32, tests/test_torch_checkpoint.py's
    LR_RTOL)."""
    trainer = twin["trainer"]
    state = moments(trainer.optimizer, trainer.model)
    for name, q in trainer.model.named_parameters():
        lr = twin["group_lrs"][name]
        np.testing.assert_allclose(q.detach().numpy(), twin["want"]["params"][name].numpy(),
                                   rtol=0, atol=LR_RTOL * lr, err_msg=name)
        assert state[name]["step"] == SAVED_STEP + 1, name
        for key, want in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            w = twin["want"][want][name].numpy()
            np.testing.assert_allclose(state[name][key].numpy(), w, rtol=0,
                                       atol=1e-12 * float(np.abs(w).max()), err_msg=name)


def test_the_converted_twin_serves_as_the_jax_model(twin):
    """(a) The eval forward of `model_last.pth` against the JAX model on
    the tree the fixture restored from orbax, fp32."""
    eval_parity(twin["cfg"], jax_build_model(twin["jcfg"].arch, dtype=jnp.float32),
                twin["restored"], os.path.join(twin["out"], "model_last.pth"), (64, 64))


def test_the_test_cli_serves_the_converted_run(twin, tmp_path):
    """`python -m mvsformer_torch.test --ckpt_dir OUT_DIR` (model_last) on a
    PNG scan: the files, and each depth map the eval forward's."""
    import chip_smoke
    from mvsformer_torch import test as test_cli
    from mvsformer_torch.utils.pfm import read_pfm

    chip_smoke.write_dtu_scan(str(tmp_path), views=3, img_hw=(150, 225))
    (tmp_path / "list.txt").write_text("scan1\n")
    out = str(tmp_path / "out")
    test_cli.main(["--testpath", str(tmp_path / "dtu"), "--testlist", str(tmp_path / "list.txt"),
                   "--ckpt_dir", twin["out"], "--outdir", out, "--max_h", "128", "--max_w",
                   "192", "--ndepths", "48", "--num_view", "3", "--device", "cpu",
                   "--skip_fusion", "--dtype", "fp32", "--which_ckpt", "model_last"])
    depths = sorted(os.listdir(os.path.join(out, "scan1", "depth_est")))
    assert len(depths) == 3
    for f in depths:
        d = read_pfm(os.path.join(out, "scan1", "depth_est", f))[0]
        assert np.isfinite(d).all() and d.min() > 0


# ------------------------------------------------------------------ DINOMVSNet

def dino_arch(jax_side):
    over = dict(CFG, model_type="dino")
    if jax_side:
        return JaxModelConfig(**over, **JAX_FLAGS, vit_args=JaxViTConfig(**DINO_VIT))
    from mvsformer_torch.config import ModelConfig, ViTConfig
    return ModelConfig(**over, vit_args=ViTConfig(**DINO_VIT))


@pytest.fixture(scope="module")
def dino(tmp_path_factory):
    """Two optax updates of the dino groups (layer decay, the clip) from
    seeded gradients, the orbax run, the converted run; the third update
    on each side from the same gradient."""
    tmp = tmp_path_factory.mktemp("dino")
    model = random_init_(build_model(dino_arch(False), device="cpu"),
                         torch.Generator().manual_seed(1))
    params, stats = convert_full_dino(port_state(model), ndepths=tuple(CFG["ndepths"]),
                                      model_th=8)
    jcfg = jax_config("dino", dino_arch(True), str(tmp / "jax"))
    total = STEPS_PER_EPOCH * EPOCHS
    tx, schedule = make_optimizer(params, jcfg.optimizer, "dino", total)
    apply, init = jitted(tx)
    rng = np.random.default_rng(2)
    grads = [jax.tree.map(lambda x: rng.standard_normal(np.shape(x)).astype(np.float32)
                          * 0.05, params) for _ in range(SAVED_STEP + 1)]
    p, opt_state = params, init(params)
    for g in grads[:SAVED_STEP]:
        p, opt_state = apply(g, opt_state, p)
    run = str(tmp / "jax" / "models" / "dino")
    write_run(run, jcfg, {"params": p, "batch_stats": stats, "opt_state": opt_state},
              SAVED_STEP, best=False)
    restored, _ = JaxManager(run).restore("model_last", {
        "params": p, "batch_stats": stats, "opt_state": init(p)})
    new_p, new_state = apply(grads[-1], restored["opt_state"], restored["params"])

    out = str(tmp / "port" / "models" / "dino")
    convert_run(run, out, log=lambda *a: None)
    cfg = load_config(os.path.join(out, "config.json"))
    trainer = Trainer(cfg, Loader(), model=build_model(cfg.arch, device="cpu", train=True),
                      logger=Quiet())
    trainer.init_state()
    trainer.resume_auto()
    names = lambda tree: convert_flax_grads(jax.tree.map(np.asarray, tree), stats,
                                            tuple(CFG["ndepths"]), 8)[0]
    g3 = names(grads[-1])
    before = {n: q.detach().clone() for n, q in trainer.model.named_parameters()}
    group_lrs = {n: g["lr"] for g in trainer.optimizer.param_groups for n in g["names"]}
    trainable = [q for q in trainer.step.params]
    named = dict(trainer.model.named_parameters())
    for n, q in named.items():
        q.grad = g3[n].clone()
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(q.grad)
                                                 for q in trainable]))
    _clip_by_global_norm([q.grad for q in trainable], cfg.optimizer.grad_norm, norm)
    trainer.optimizer.step()
    scales = names(jax.tree.map(lambda v, x: np.full(np.shape(x), v, np.float32),
                                lr_scale_tree(p, jcfg.optimizer, "dino"), p))
    return dict(run=run, out=out, cfg=cfg, jcfg=jcfg, trainer=trainer, before=before,
                restored={"params": restored["params"], "batch_stats": restored["batch_stats"]},
                group_lrs=group_lrs, norm=float(norm), lr=float(schedule(SAVED_STEP)),
                want_params=names(new_p), want_mu=names(new_state[0][1].mu),
                want_nu=names(new_state[0][1].nu), scales=scales)


def test_dino_layer_decay_groups_resume_at_the_jax_lrs(dino):
    """Every ViT tensor's LR after the resume is the JAX schedule at the
    restored count times its layer-decay scale (blocks 0-11 at vit_lr x
    0.75^(12 - i))."""
    assert dino["trainer"].global_step == SAVED_STEP
    assert dino["norm"] > OPT["grad_norm"]  # the clip binds
    vit = 0
    for name, got in dino["group_lrs"].items():
        want = dino["lr"] * float(dino["scales"][name].flatten()[0])
        assert math.isclose(got, want, rel_tol=1e-6), name
        vit += name.startswith("vit.blocks.")
    assert vit > 0


def test_dino_resumed_update_is_the_jax_update(dino):
    """The third update from the same gradient, fp32 on both sides:
    parameters within 1e-6 of each tensor's LR and 2.5e-7 of its scale
    (two fp32 roundings), moments within 3e-5 of their scale: the clip divides
    by the global norm of 26M fp32 squares, summed in another order on
    each side (the first moment read 2.9e-6 apart, the second, which takes
    the clip's factor squared, 1.03e-5)."""
    trainer = dino["trainer"]
    state = moments(trainer.optimizer, trainer.model)
    for name, q in trainer.model.named_parameters():
        lr = dino["group_lrs"][name]
        np.testing.assert_allclose(q.detach().numpy(), dino["want_params"][name].numpy(),
                                   rtol=0, atol=1e-6 * lr + 2.5e-7 * float(
                                       dino["before"][name].abs().max()), err_msg=name)
        assert state[name]["step"] == SAVED_STEP + 1
        for key, want in (("exp_avg", dino["want_mu"]), ("exp_avg_sq", dino["want_nu"])):
            w = want[name].numpy()
            np.testing.assert_allclose(state[name][key].numpy(), w, rtol=0,
                                       atol=3e-5 * float(np.abs(w).max()), err_msg=name)


def test_the_converted_dino_serves_as_the_jax_model(dino):
    """(a) for DINOMVSNet, on a 64x128 request (a 2x4 token grid), the
    JAX model on the tree the fixture restored from orbax."""
    eval_parity(dino["cfg"], jax_build_model(dino["jcfg"].arch, dtype=jnp.float32),
                dino["restored"], os.path.join(dino["out"], "model_last.pth"), (64, 128))


def eval_parity(cfg, jmodel, variables, pth, hw):
    imgs, projs, dv = make_batch(np.random.default_rng(3), H=hw[0], W=hw[1])
    jout = jax.jit(lambda v: jmodel.apply(v, jnp.asarray(imgs), jax.tree.map(jnp.asarray, projs),
                                          jnp.asarray(dv), training=False, tmp=TMPS))(variables)
    model = build_model(cfg.arch, device="cpu")
    load_reference_checkpoint(pth, model)
    depth, conf, stage_confs = make_infer_fn(model, TMPS)(imgs, projs, dv)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jout["refined_depth"]), rtol=0,
                               atol=DEPTH_ATOL)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jout["photometric_confidence"]),
                               rtol=0, atol=CONF_ATOL)
    for i, c in enumerate(stage_confs):
        np.testing.assert_allclose(c.numpy(), np.asarray(
            jout[f"stage{i + 1}"]["photometric_confidence"]), rtol=0, atol=CONF_ATOL)


# ------------------------------------------------------------------ exports and refusals

def test_a_params_only_export_finetunes_without_the_optimizer(twin, tmp_path):
    """(c) {params, batch_stats} alone, as model_best and model_last: each
    converts to a .pth without `optimizer`, which
    `finetune(restore_opt=False)` takes (the weights bit-equal, fresh
    moments, the schedule reset); `restore_opt=True` and a resume refuse
    it, naming --no_restore_opt."""
    run = str(tmp_path / "jax" / "models" / "export")
    write_run(run, twin["jcfg"], {"params": twin["params"], "batch_stats": twin["stats"]}, 7)
    out = str(tmp_path / "port" / "models" / "export")
    assert convert_run(run, out, log=lambda *a: None) == ["model_best", "model_last"]
    state = torch.load(os.path.join(out, "model_best.pth"), weights_only=False)
    assert "optimizer" not in state and state["global_step"] == 7

    cfg = load_config(os.path.join(out, "config.json"))
    cfg.name = "finetuned"
    trainer = Trainer(cfg, Loader(), model=build_model(cfg.arch, device="cpu", train=True),
                      logger=Quiet())
    trainer.init_state()
    trainer.finetune(out, restore_opt=False)
    assert trainer.global_step == 0 and not trainer.optimizer.state
    for name, t in trainer.model.state_dict().items():
        assert torch.equal(t, state["state_dict"][name]), name
    with pytest.raises(ValueError, match="no_restore_opt"):
        trainer.finetune(out, restore_opt=True)
    resumer = Trainer(load_config(os.path.join(out, "config.json")), Loader(),
                      model=build_model(cfg.arch, device="cpu", train=True), logger=Quiet())
    resumer.init_state()
    with pytest.raises(ValueError, match="no_restore_opt"):
        resumer.resume_auto()


def test_orbax_directories_are_refused_naming_the_converter(twin, tmp_path):
    """(d) The JAX run dir itself: the test CLI, `resume_auto` and
    `finetune` raise, each naming `tools/orbax_to_torch.py`."""
    from mvsformer_torch import test as test_cli

    hint = r"python tools/orbax_to_torch\.py"
    with pytest.raises(ValueError, match=hint):
        test_cli.main(["--testpath", str(tmp_path), "--ckpt_dir", twin["run"], "--outdir",
                       str(tmp_path / "out"), "--device", "cpu", "--dtype", "fp32",
                       "--which_ckpt", "model_last"])
    cfg = load_config(os.path.join(twin["run"], "config.json"))
    trainer = Trainer(cfg, Loader(), model=build_model(cfg.arch, device="cpu", train=True),
                      logger=Quiet())
    trainer.init_state()
    assert os.path.join(cfg.trainer.save_dir, "models", cfg.name) == twin["run"]
    with pytest.raises(ValueError, match=hint):
        trainer.resume_auto()
    with pytest.raises(ValueError, match=hint):
        trainer.finetune(twin["run"], name="model_last")
