"""Checkpoints, resume and finetune: the port against the JAX package, on the CPU.

- `CheckpointManager`: over scripted monitor values (min and max modes,
  `save_period` 2) the same best/last decisions and the same sidecar metas
  as the JAX manager (orbax there, one `.pth` here); the `.pth` holds the
  reference layout.
- `Trainer.resume_auto`: from the same metas, the same start epoch, batches
  to skip and global step as the JAX trainer (its tensor restore stubbed:
  only the metas decide).
- `Trainer.finetune`, for each of restore_opt x reset_schedule: the next
  update's LR and Adam bias-correction step equal the optax counts that the
  JAX `finetune` leaves (its checkpoint restore stubbed with a state at
  count N), and the moments are the saved ones or zero.
- `set_step`, `warmup_multistep_schedule`, `merge_pretrained_backbone` and
  `DictAverageMeter` on their own.

The trainers here hold a small module with a `vit` part, not TwinMVSNet:
only the optimizer's groups and counts matter.
"""

import json
import math
import os

import numpy as np
import pytest
import torch
import torch.nn as nn

pytest.importorskip("jax")
pytest.importorskip("orbax.checkpoint")

import jax.numpy as jnp  # noqa: E402

from mvsformer_tpu.config import Config as JaxConfig  # noqa: E402
from mvsformer_tpu.train import checkpoint as jax_checkpoint  # noqa: E402
from mvsformer_tpu.train import trainer as jax_trainer  # noqa: E402
from mvsformer_tpu.train.meters import DictAverageMeter as JaxMeter  # noqa: E402
from mvsformer_tpu.train.optim import make_optimizer  # noqa: E402
from mvsformer_tpu.train.optim import warmup_multistep_schedule as jax_multistep  # noqa: E402
from mvsformer_torch.config import Config  # noqa: E402
from mvsformer_torch.train.checkpoint import CheckpointManager  # noqa: E402
from mvsformer_torch.train.meters import DictAverageMeter  # noqa: E402
from mvsformer_torch.train.optim import set_step, warmup_multistep_schedule  # noqa: E402
from mvsformer_torch.train.trainer import Trainer  # noqa: E402
from mvsformer_torch.utils.convert_weights import merge_pretrained_backbone  # noqa: E402
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

STEPS_PER_EPOCH, EPOCHS, SAVED_STEP = 25, 4, 37
LR_RTOL = 1e-6  # the JAX schedule is float32


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.vit = nn.Linear(3, 4)
        self.head = nn.Linear(4, 2)


class Loader:
    def __len__(self):
        return STEPS_PER_EPOCH


class Quiet:
    def info(self, msg):
        pass


def port_trainer(tmp_path, name="run"):
    cfg = Config()
    cfg.name = name
    cfg.trainer.save_dir = str(tmp_path)
    cfg.trainer.epochs = EPOCHS
    cfg.optimizer.warmup_steps = 10
    torch.manual_seed(0)
    t = Trainer(cfg, Loader(), model=Tiny(), logger=Quiet())
    t.init_state()
    return t


@pytest.mark.parametrize("mode,values", [
    ("min", [0.5, 0.6, 0.4, 0.4, 0.3, 0.35]),
    ("max", [0.1, 0.3, 0.2, 0.5, 0.5, 0.7]),
])
def test_best_and_last_decisions_match_jax(tmp_path, mode, values):
    port = CheckpointManager(str(tmp_path / "port"), f"{mode} mean_error", save_period=2)
    ref = jax_checkpoint.CheckpointManager(str(tmp_path / "jax"), f"{mode} mean_error",
                                           save_period=2)
    for epoch, v in enumerate(values, 1):
        extra = {"global_step": 10 * epoch}
        got = port.step(epoch, v, {"x": torch.full((3,), float(epoch))}, extra_meta=extra)
        want = ref.step(epoch, v, {"x": np.full((3,), float(epoch))}, extra_meta=extra)
        assert got == want and port.best == ref.best
        for name in ("model_best", "model_last"):
            assert port.has(name) == ref.has(name)
            assert port.peek_meta(name) == ref.peek_meta(name)
        assert [s["name"] for s in port.saves] == (["model_best"] if got else []) + (
            ["model_last"] if epoch % 2 == 0 else [])
        assert all(s["bytes"] > 0 and s["ms"] >= 0 for s in port.saves)
        port.saves.clear()
    state, meta = port.restore("model_best")
    assert meta == ref.peek_meta("model_best")
    assert state["epoch"] == meta["epoch"] and state["monitor_best"] == meta["monitor_best"]
    assert not [f for f in os.listdir(port.ckpt_dir) if f.endswith(".tmp")]


def test_a_checkpoint_holds_the_reference_layout(tmp_path):
    t = port_trainer(tmp_path)
    t.ckpt.step(1, 0.25, t.state_dict(), extra_meta={"global_step": 0})
    state = torch.load(t.ckpt.path("model_best"), weights_only=False)
    assert {"arch", "epoch", "state_dict", "optimizer", "monitor_best", "config", "scheduler",
            "global_step"} <= set(state)
    assert state["arch"] == "Tiny" and state["config"]["name"] == "run"
    assert state["epoch"] == 1 and state["monitor_best"] == 0.25
    with open(os.path.join(t.ckpt.ckpt_dir, "model_best.meta.json")) as f:
        assert json.load(f) == {"epoch": 1, "monitor_metric": "mean_error",
                                "monitor_value": 0.25, "monitor_best": 0.25, "global_step": 0}


class JaxStub:
    """A JAX Trainer without a model: its checkpoint restore reads only the
    metas (resume_auto) or returns a state whose optax counts are N (finetune)."""

    @staticmethod
    def resume(ckpt_dir):
        t = jax_trainer.Trainer.__new__(jax_trainer.Trainer)
        t.ckpt = jax_checkpoint.CheckpointManager(ckpt_dir)
        t.global_step = 0
        t.logger = Quiet()

        def restore(name):
            meta = t.ckpt.peek_meta(name)
            t.global_step = int(meta.get("global_step", t.global_step))
            return meta

        t.restore = restore
        return t


METAS = {
    "last only": {"model_last": {"epoch": 2, "global_step": 50}},
    "step ahead": {"model_last": {"epoch": 2, "global_step": 50},
                   "model_step": {"epoch": 3, "batch_idx": 3, "global_step": 54}},
    "step behind": {"model_last": {"epoch": 3, "global_step": 75},
                    "model_step": {"epoch": 3, "batch_idx": 20, "global_step": 71}},
    "step only": {"model_step": {"epoch": 1, "batch_idx": 0, "global_step": 1}},
    "none": {},
}


@pytest.mark.parametrize("case", list(METAS))
def test_resume_auto_matches_jax(tmp_path, case):
    src = port_trainer(tmp_path / "port")
    jdir = str(tmp_path / "jax")
    os.makedirs(jdir)
    for name, meta in METAS[case].items():
        src.global_step = meta["global_step"]
        src.ckpt._save(name, src.state_dict(), meta)
        os.makedirs(os.path.join(jdir, name))
        with open(os.path.join(jdir, name + ".meta.json"), "w") as f:
            json.dump(meta, f)
    port = port_trainer(tmp_path / "port")
    ref = JaxStub.resume(jdir)
    got, want = port.resume_auto(), ref.resume_auto()
    assert got == want
    assert port.global_step == ref.global_step


def optax_counts(state):
    """Every `count` in an optax state tree."""
    out = []
    if hasattr(state, "_fields"):
        if "count" in state._fields:
            out.append(int(state.count))
        for f in state._fields:
            out += optax_counts(getattr(state, f))
    elif isinstance(state, (tuple, list)):
        for s in state:
            out += optax_counts(s)
    elif isinstance(state, dict):
        for s in state.values():
            out += optax_counts(s)
    return out


def jax_finetune(restore_opt, reset_schedule, monkeypatch):
    """(counts the JAX finetune leaves, its global_step, its schedule)."""
    cfg = JaxConfig()
    cfg.optimizer.warmup_steps = 10
    params = {"vit": {"kernel": jnp.ones((3, 4))}, "head": {"kernel": jnp.ones((4, 2))}}
    t = jax_trainer.Trainer.__new__(jax_trainer.Trainer)
    t.cfg, t.mesh, t.logger, t.global_step = cfg, None, Quiet(), 0
    t.params, t.batch_stats = params, {}
    t.optimizer, t.schedule = make_optimizer(params, cfg.optimizer, "twin",
                                             STEPS_PER_EPOCH * EPOCHS)
    t.opt_state = t.optimizer.init(params)
    saved = jax_trainer._set_counts(t.optimizer.init(params), SAVED_STEP)

    class Manager:
        def __init__(self, *a, **k):
            pass

        def restore(self, name, template):
            state = {"params": params, "batch_stats": {}, "opt_state": saved}
            return {k: state[k] for k in template}, {"epoch": 2, "global_step": SAVED_STEP}

    monkeypatch.setattr(jax_checkpoint, "CheckpointManager", Manager)
    t.finetune("unused", restore_opt=restore_opt, reset_schedule=reset_schedule)
    counts = set(optax_counts(t.opt_state))
    assert len(counts) == 1
    return counts.pop(), t.global_step, t.schedule


@pytest.mark.parametrize("reset_schedule", [True, False])
@pytest.mark.parametrize("restore_opt", [True, False])
def test_finetune_counts_match_jax(tmp_path, monkeypatch, restore_opt, reset_schedule):
    src = port_trainer(tmp_path, name="source")
    for p in src.model.parameters():
        p.grad = torch.ones_like(p)
    src.optimizer.step()  # moments that are not zero
    set_step(src.optimizer, src.scheduler, SAVED_STEP)
    src.global_step = SAVED_STEP
    src.ckpt._save("model_best", src.state_dict(), {"epoch": 2, "global_step": SAVED_STEP})
    saved = {n: src.optimizer.state[p]["exp_avg"].clone() for n, p in src.model.named_parameters()}

    port = port_trainer(tmp_path, name="finetuned")
    port.finetune(src.ckpt.ckpt_dir, restore_opt=restore_opt, reset_schedule=reset_schedule)
    count, global_step, schedule = jax_finetune(restore_opt, reset_schedule, monkeypatch)

    assert port.global_step == global_step
    for n, p in port.model.named_parameters():
        state = port.optimizer.state[p]
        assert (int(state["step"]) if state else 0) == count, n
        if restore_opt:
            assert torch.equal(state["exp_avg"], saved[n]), n
        elif state:
            assert not state["exp_avg"].any(), n
    rest = next(g for g in port.optimizer.param_groups if g["group"] == "rest")
    want = float(schedule(count))
    assert math.isclose(rest["lr"], want, rel_tol=LR_RTOL, abs_tol=1e-12)
    assert math.isclose(port.schedule(port.global_step), float(schedule(global_step)),
                        rel_tol=LR_RTOL, abs_tol=1e-12)


def test_set_step_gives_the_next_update_its_bias_correction_and_lr(tmp_path):
    t = port_trainer(tmp_path)
    k = 17
    set_step(t.optimizer, t.scheduler, k)
    p = t.model.head.weight
    before = p.detach().clone()
    g = torch.full_like(p, 0.5)
    for q in t.model.parameters():
        q.grad = torch.zeros_like(q)
    p.grad = g.clone()
    t.optimizer.step()
    lr = t.schedule(k)
    m = (1 - 0.9) * g / (1 - 0.9 ** (k + 1))
    v = (1 - 0.999) * g * g / (1 - 0.999 ** (k + 1))
    want = before - lr * m / (v.sqrt() + 1e-8)
    assert torch.allclose(p.detach(), want, rtol=1e-6, atol=1e-9)
    assert t.scheduler.last_epoch == k


@pytest.mark.parametrize("method", ["linear", "constant"])
def test_warmup_multistep_schedule_matches_jax(method):
    kw = dict(milestones=[30, 10], gamma=0.5, warmup_factor=0.2, warmup_iters=8,
              warmup_method=method)
    port, ref = warmup_multistep_schedule(1e-3, **kw), jax_multistep(1e-3, **kw)
    for step in (0, 1, 4, 7, 8, 9, 10, 11, 29, 30, 31, 100):
        assert math.isclose(port(step), float(ref(step)), rel_tol=LR_RTOL), step


def test_merge_pretrained_backbone_reports_and_copies(tmp_path):
    model = Tiny()
    sd = {"weight": torch.randn(4, 3), "bias": torch.randn(7), "extra": torch.zeros(1)}
    path = str(tmp_path / "twins.pth")
    torch.save({"state_dict": {f"vit.{k}": v for k, v in sd.items()}}, path)
    lines = []
    report = merge_pretrained_backbone(model, path, log=lines.append)
    assert report == {"loaded": ["weight"], "missing": [], "unexpected": ["extra"],
                      "mismatched": ["bias"]}
    assert torch.equal(model.vit.weight.detach(), sd["weight"])
    assert lines[0].endswith("loaded 1/2 tensors; missing 0, unexpected 1, shape-mismatch 1")
    torch.save({"model": {"weight": sd["weight"]}}, path)
    assert merge_pretrained_backbone(model, path, log=lines.append)["missing"] == ["bias"]


def test_meter_matches_jax_and_raises_on_non_finite():
    port, ref = DictAverageMeter(), JaxMeter()
    for rec, n in (({"loss": 1.5, "e": 0.25}, 1), ({"loss": 0.5, "e": 0.75}, 3)):
        port.update(rec, n)
        ref.update(rec, n)
    assert port.mean() == ref.mean()
    for bad in (float("nan"), float("inf")):
        with pytest.raises(ValueError, match="not finite"):
            DictAverageMeter().update({"loss": bad})
