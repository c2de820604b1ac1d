"""The port's trainer and train command line, on the CPU.

Against the JAX package:
- `valid_epoch`'s metrics on fixed predictions (DTU and BlendedMVS, a
  trailing partial batch among them) equal the JAX trainer's aggregation
  within 1e-6 (fp32 metrics in another summation order);
- `micro_batches` gives the JAX `Trainer.micro_batches` sizes (mesh None)
  for every entry of the default `scale_batch_map`.

Port only:
- two steps of `Trainer.train_epoch` on the loader's batches give exactly
  the losses and parameters of two direct `TrainStep` calls on the same
  batches (`TrainStep` is held to the JAX step by test_torch_train_step.py),
  with PyTorch's deterministic algorithms on: without them two identical
  CPU backwards already differ by ~1e-8 in the encoder's gradients;
- `python -m mvsformer_torch.train` runs end to end on the CPU at a toy
  config (64x64 crops, 3 views, ndepths 8/4/4/2 over 16 depths, the default
  Twins width): training with validation, model_step/best/last checkpoints,
  a profile window and the gradient scan; `--resume` continues at the next
  epoch with the schedule's LR; `python -m mvsformer_torch.test
  --which_ckpt model_best` evaluates what it saved, equal to
  `make_infer_fn` of the restored model (on `chip_smoke.write_dtu_scan`'s
  PNG scan);
- what the CLI does not port raises, naming the ROADMAP item (training
  over the depth axis, A5b), a grid the processes cannot fill raises
  naming torchrun, and
  the default device is `cuda`.
"""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from mvsformer_tpu.config import Config as JaxConfig  # noqa: E402
from mvsformer_tpu.train import trainer as jax_trainer  # noqa: E402
from mvsformer_torch import test as test_cli  # noqa: E402
from mvsformer_torch.config import Config, load_config, save_config  # noqa: E402
from mvsformer_torch.data.dtu import DTUMVSDataset  # noqa: E402
from mvsformer_torch.data.eval_dataset import MVSEvalDataset  # noqa: E402
from mvsformer_torch.data.loader import MVSLoader, collate  # noqa: E402
from mvsformer_torch.infer import STAGES, make_infer_fn  # noqa: E402
from mvsformer_torch.models.mvsformer import build_model  # noqa: E402
from mvsformer_torch.train import __main__ as train_cli  # noqa: E402
from mvsformer_torch.train.step import TrainStep, micro_batches  # noqa: E402
from mvsformer_torch.train.trainer import Trainer  # noqa: E402
from mvsformer_torch.utils.convert_weights import load_reference_checkpoint  # noqa: E402
from mvsformer_torch.utils.pfm import read_pfm  # noqa: E402

import chip_smoke  # noqa: E402
from test_data import make_dtu_tree  # noqa: E402
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

METRIC_RTOL = 1e-6


class Quiet:
    def info(self, msg):
        pass


def val_batches(rng, sizes, H=16, W=20, D=8):
    """Loader-layout batches and fixed predictions near their ground truth."""
    out = []
    for B in sizes:
        itv = rng.uniform(2.0, 3.0, (B, 1)).astype(np.float32)
        dv = (425.0 + itv * np.arange(D, dtype=np.float32)).astype(np.float32)
        gt = rng.uniform(430, 440, (B, H, W)).astype(np.float32)
        batch = {"imgs": np.zeros((B, 2, H, W, 3), np.float32),
                 "proj_matrices": {f"stage{i}": np.zeros((B, 2, 2, 4, 4), np.float32)
                                   for i in range(1, 5)},
                 "depth_values": dv,
                 "depth": {"stage4": gt},
                 "mask": {"stage4": (rng.uniform(size=(B, H, W)) > 0.3).astype(np.float32)}}
        pred = (gt + rng.normal(0, 8, gt.shape)).astype(np.float32)
        out.append((batch, pred))
    return out


@pytest.mark.parametrize("is_blended", [False, True])
def test_validation_metrics_match_jax(tmp_path, is_blended):
    batches = val_batches(np.random.default_rng(3), (4, 4, 3))
    jt = jax_trainer.Trainer.__new__(jax_trainer.Trainer)
    jt.cfg, jt.mesh, jt.writer, jt.is_blended = JaxConfig(), None, None, is_blended
    jt.val_loader = [b for b, _ in batches]
    preds = iter([p for _, p in batches])
    jt._eval_step = lambda params, stats, split: (jnp.asarray(next(preds)),) * 2
    jt.params = jt.batch_stats = None
    want = jt.valid_epoch(1)

    cfg = Config()
    cfg.trainer.save_dir = str(tmp_path)
    port = Trainer(cfg, [], val_loader=[b for b, _ in batches],
                   model=torch.nn.Linear(1, 1), logger=Quiet(), is_blended=is_blended)
    preds = iter([p for _, p in batches])
    port._eval_forward = lambda batch: (torch.from_numpy(next(preds)),) * 2
    got = port.valid_epoch(1)
    assert set(got) == set(want)
    for k in want:
        assert np.isclose(got[k], want[k], rtol=METRIC_RTOL, atol=1e-7), k
    with open(os.path.join(port.run_dir, "train_log.jsonl")) as f:
        rec = json.loads(f.readlines()[-1])
    assert rec["kind"] == "val" and len(rec["batch_ms"]) == 3


@pytest.mark.parametrize("B", [8, 6, 3, 1])
def test_micro_batches_match_jax(B):
    sbm = JaxConfig().data.multi_scale_args.scale_batch_map
    jt = jax_trainer.Trainer.__new__(jax_trainer.Trainer)
    jt.mesh, jt.scale_batch_map = None, {int(k): v for k, v in sbm.items()}
    for h in [int(k) for k in sbm] + [320]:
        batch = {"imgs": np.zeros((B, 2, h, 4, 3), np.float32), "depth_values": np.zeros((B, 4))}
        want = [m["imgs"].shape[0] for m in jt.micro_batches(batch)]
        got = [m["imgs"].shape[0] for m in micro_batches(batch, sbm)]
        assert got == want, h


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    root = make_dtu_tree(str(tmp_path_factory.mktemp("dtu")), H=240, W=320)
    with open(os.path.join(root, "Cameras", "pair.txt"), "w") as f:
        f.write("1\n0\n4 1 100 2 99 3 98 4 97\n")  # one reference view: 7 samples
    return root


def toy_config(root, save_dir, name="toy", cfg=None):
    """`cfg` (the default Config unless given) at the toy size."""
    cfg = cfg or Config()
    cfg.name = name
    cfg.arch.ndepths = [8, 4, 4, 2]
    cfg.data.datapath = root
    listfile = os.path.join(save_dir, "list.txt")
    os.makedirs(save_dir, exist_ok=True)
    with open(listfile, "w") as f:
        f.write("scan1\n")
    cfg.data.train_data_list = cfg.data.val_data_list = listfile
    cfg.data.nviews, cfg.data.num_depths, cfg.data.batch_size = 3, 16, 2
    cfg.data.num_workers = 2
    cfg.data.height = cfg.data.width = 64
    cfg.data.resize_scale = 0.3
    cfg.data.multi_scale_args.scales = [[64, 64]]
    cfg.data.multi_scale_args.scale_batch_map = {"64": 1}
    cfg.trainer.epochs = 1
    cfg.trainer.save_dir = save_dir
    cfg.trainer.logging_every = 1
    cfg.optimizer.warmup_steps = 2
    return cfg


def toy_loader(cfg, seed=4):
    ds = DTUMVSDataset(cfg.data.datapath, cfg.data.train_data_list, "train", nviews=3,
                       ndepths=16, crop=True, augment=True, multi_scale=True,
                       multi_scale_args={"scales": [[64, 64]]}, seed=seed)
    ds.BASE_H, ds.BASE_W = 240, 320
    ds.metas = ds.metas[:4]
    return MVSLoader(ds, 2, num_workers=1, seed=seed)


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def test_two_trainer_steps_equal_two_train_step_calls(dtu_root, tmp_path, deterministic):
    cfg = toy_config(dtu_root, str(tmp_path))
    torch.manual_seed(0)
    model = build_model(cfg.arch, device="cpu", train=True)
    direct = TrainStep(copy.deepcopy(model), cfg, steps_per_epoch=2, seed=5)
    loader = toy_loader(cfg)
    loader.set_epoch(1)
    losses = []
    for b in loader:
        losses.append(direct({"imgs": b["imgs"], "proj_matrices": b["proj_matrices"],
                              "depth_values": b["depth_values"], "depth_gt": b["depth"],
                              "mask": b["mask"]})["loss"])

    trainer = Trainer(cfg, toy_loader(cfg), model=model, logger=Quiet(), seed=5)
    trainer.init_state()
    out = trainer.train_epoch(1)
    with open(trainer.log_path) as f:
        steps = [r for r in map(json.loads, f) if r["kind"] == "step"]
    assert [r["loss"] for r in steps] == losses
    assert out["loss"] == sum(losses) / 2
    assert trainer.global_step == direct.global_step == 2
    for (n, p), q in zip(model.named_parameters(), direct.model.parameters()):
        assert torch.equal(p, q), n
    for (n, b), c in zip(model.named_buffers(), direct.model.buffers()):
        assert torch.equal(b, c), n
    assert [r["crop"] for r in steps] == [[64, 64]] * 2
    assert [r["micro_batches"] for r in steps] == [2, 2]


def records(run_dir):
    with open(os.path.join(run_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_runs_resumes_and_feeds_the_test_cli(dtu_root, tmp_path):
    save_dir = str(tmp_path / "saved")
    run_dir = os.path.join(save_dir, "models", "toy")
    cfg = toy_config(dtu_root, save_dir)
    config = str(tmp_path / "config.json")
    save_config(cfg, config)
    base = ["--config", config, "--device", "cpu", "--seed", "1", "--dtype", "fp32"]
    try:
        history = train_cli.main(base + ["--save_every_steps", "2", "--debug", "--profile_dir",
                                          str(tmp_path / "prof"), "--profile_start", "1",
                                          "--profile_steps", "1"])
        assert len(history) == 1 and np.isfinite(history[0]["loss"])
        assert 0.0 <= history[0]["val_mean_error"] <= 1.0
        for name in ("model_best", "model_last", "model_step"):
            assert os.path.isfile(os.path.join(run_dir, name + ".pth"))
            assert os.path.isfile(os.path.join(run_dir, name + ".meta.json"))
        assert load_config(os.path.join(run_dir, "config.json")).name == "toy"
        with open(os.path.join(tmp_path, "prof", "profile_summary.json")) as f:
            assert json.load(f)["steps"] == 1
        assert os.path.isfile(os.path.join(tmp_path, "prof", "trace.json"))
        recs = records(run_dir)
        steps = [r for r in recs if r["kind"] == "step"]
        assert len(steps) == 3 and all(np.isfinite(r["loss"]) for r in steps)
        val = [r for r in recs if r["kind"] == "val"]
        assert len(val) == 1 and len(val[0]["batch_ms"]) == 4  # 7 samples in batches of 2
        assert {r["name"] for r in recs if r["kind"] == "checkpoint"} == {
            "model_step", "model_best", "model_last"}

        cfg.trainer.epochs = 2
        save_config(cfg, config)
        history = train_cli.main(base + ["--resume"])
        assert len(history) == 1
        recs = records(run_dir)
        resume = [r for r in recs if r["kind"] == "resume"]
        assert resume == [{"kind": "resume", "name": "model_last", "global_step": 3,
                           "start_epoch": 2, "skip_batches": 0}]
        steps = [r for r in recs if r["kind"] == "step"]
        assert [(r["epoch"], r["global_step"]) for r in steps[3:]] == [(2, 4), (2, 5), (2, 6)]
        t = Trainer(cfg, [None] * 3, model=build_model(cfg.arch, device="cpu", train=True),
                    logger=Quiet())
        t.init_state()
        assert steps[3]["lr"] == pytest.approx(t.schedule(3))

        eval_root = chip_smoke.write_dtu_scan(str(tmp_path / "eval"), views=4, img_hw=(96, 128))
        listfile = os.path.join(eval_root, "list.txt")
        with open(listfile, "w") as f:
            f.write("scan1\n")
        out = str(tmp_path / "out")
        test_cli.main(["--testpath", eval_root, "--testlist", listfile, "--ckpt_dir", run_dir,
                       "--which_ckpt", "model_best", "--outdir", out, "--max_h", "64",
                       "--max_w", "64", "--ndepths", "16", "--num_view", "3", "--device", "cpu",
                       "--skip_fusion", "--dtype", "fp32"])
        model = build_model(cfg.arch, device="cpu")
        load_reference_checkpoint(os.path.join(run_dir, "model_best.pth"), model)
        ds = MVSEvalDataset(eval_root, ["scan1"], nviews=3, ndepths=16, interval_scale=1.06,
                            max_h=64, max_w=64)
        batch = collate([ds[0]])
        depth, conf, _ = make_infer_fn(model)(
            batch["imgs"], {k: batch["proj_matrices"][k] for k in STAGES}, batch["depth_values"])
        saved = read_pfm(os.path.join(out, "scan1", "depth_est", "00000000.pfm"))[0]
        assert np.array_equal(saved, depth[0].numpy())
        assert np.array_equal(np.load(os.path.join(out, "scan1", "confidence", "00000000.npy")),
                              conf[0].numpy())
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)  # three checkpoints of ~0.3 GB each


@pytest.mark.parametrize("argv", [[], ["--dtype", "bf16"]], ids=["default", "bf16"])
def test_train_cli_trains_in_bf16(dtu_root, tmp_path, argv):
    """The CLI trains in bf16 by default, as the JAX train.py does: one toy
    epoch with finite losses, and checkpoints whose tensors, and whose
    optimizer moments, are all fp32 (the layout of an fp32 run's)."""
    save_dir = str(tmp_path / "saved")
    cfg = toy_config(dtu_root, save_dir)
    config = str(tmp_path / "config.json")
    save_config(cfg, config)
    try:
        history = train_cli.main(["--config", config, "--device", "cpu"] + argv)
        assert len(history) == 1 and np.isfinite(history[0]["loss"])
        steps = [r for r in records(os.path.join(save_dir, "models", "toy")) if r["kind"] == "step"]
        assert len(steps) == 3 and all(np.isfinite(r["loss"]) for r in steps)
        saved = torch.load(os.path.join(save_dir, "models", "toy", "model_last.pth"),
                           weights_only=False)
        floats = [v for v in saved["state_dict"].values() if v.is_floating_point()]
        assert floats and all(v.dtype == torch.float32 for v in floats)
        moments = [t for st in saved["optimizer"]["state"].values() for t in st.values()
                   if torch.is_tensor(t) and t.is_floating_point() and t.dim() > 0]
        assert moments and all(t.dtype == torch.float32 for t in moments)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)


# The ids are the cases' names from when ROADMAP A5 refused all four.
@pytest.mark.parametrize("argv,error,match", [
    (["--data_parallel", "2"], ValueError, "torchrun"),
    (["--view_parallel", "2"], ValueError, "torchrun"),
    (["--depth_parallel", "2"], NotImplementedError, "ROADMAP A5b"),
    (["--multi_host"], RuntimeError, "torchrun"),
], ids=["argv0-ROADMAP A5", "argv1-ROADMAP A5", "argv2-ROADMAP A5", "argv3-ROADMAP A5"])
def test_train_cli_refuses_what_is_not_ported(argv, error, match):
    """`--depth_parallel` above 1 serves only: training over it is not
    ported (A5b, training). The data and view
    axes are (A5), but one process cannot be a grid of two, and
    `--multi_host` needs torchrun's variables: both raise, naming torchrun,
    before the config is read."""
    with pytest.raises(error, match=match):
        train_cli.main(["--config", "unused.json", "--device", "cpu"] + argv)


def test_train_cli_trains_the_p_config_with_a_frozen_vit(dtu_root, tmp_path):
    """`python -m mvsformer_torch.train --config configs/config_mvsformer-p.json
    --device cpu` (DINOMVSNet, `fix` on), shrunk as the Twins toy config,
    with `--vit_path` a DINO ViT checkpoint: one short epoch. The merge is
    reported, and the checkpoint holds the merged ViT unchanged and no ViT
    tensor in the optimizer."""
    from test_convert import synth_dino_sd

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    save_dir = str(tmp_path / "saved")
    cfg = toy_config(dtu_root, save_dir, name="toy_p",
                     cfg=load_config(os.path.join(repo, "configs", "config_mvsformer-p.json")))
    assert cfg.arch.model_type == "dino" and cfg.arch.fix
    config, vit_path = str(tmp_path / "config.json"), str(tmp_path / "dino_vits16.pth")
    save_config(cfg, config)
    vit = {k: torch.from_numpy(v) for k, v in synth_dino_sd(np.random.default_rng(0)).items()}
    torch.save(vit, vit_path)
    try:
        history = train_cli.main(["--config", config, "--device", "cpu", "--vit_path", vit_path,
                                  "--dtype", "fp32"])
        assert len(history) == 1 and np.isfinite(history[0]["loss"])
        run_dir = os.path.join(save_dir, "models", "toy_p")
        with open(os.path.join(run_dir, "info.log")) as f:
            log = f.read()
        assert f"[pretrained] {vit_path} -> vit: loaded {len(vit)}/{len(vit)} tensors; " \
            "missing 0, unexpected 0, shape-mismatch 0" in log
        saved = torch.load(os.path.join(run_dir, "model_last.pth"), weights_only=False)
        assert saved["arch"] == "DINOMVSNet"
        for k, v in vit.items():
            assert torch.equal(saved["state_dict"][f"vit.{k}"], v), k
        names = [n for g in saved["optimizer"]["param_groups"] for n in g["names"]]
        assert names and not [n for n in names if n.startswith("vit.")]
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)


def test_the_default_device_is_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    cfg.arch.ndepths = [8, 4, 4, 2]
    cfg.trainer.save_dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, [])
    config = str(tmp_path / "config.json")
    save_config(cfg, config)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--config", config])


def test_validation_writes_scalars_and_images_to_a_writer(tmp_path):
    class Writer:
        def __init__(self):
            self.calls = []

        def add_scalar(self, tag, value, step):
            self.calls.append(("scalar", tag))

        def add_image(self, tag, img, step):
            assert img.ndim == 3 and img.shape[0] == 1
            self.calls.append(("image", tag))

    batches = val_batches(np.random.default_rng(4), (2,))
    cfg = Config()
    cfg.trainer.save_dir = str(tmp_path)
    writer = Writer()
    port = Trainer(cfg, [], val_loader=[b for b, _ in batches], model=torch.nn.Linear(1, 1),
                   logger=Quiet(), writer=writer)
    port._eval_forward = lambda batch: (torch.from_numpy(batches[0][1]),) * 2
    port.valid_epoch(3)
    assert ("scalar", "val/mean_error") in writer.calls
    assert {t for k, t in writer.calls if k == "image"} == {
        "val/pred_depth", "val/gt_depth", "val/confidence"}
