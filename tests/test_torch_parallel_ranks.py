"""The port's process grid on the CPU, without JAX: gloo ranks as
subprocesses, and the rank side of tests/test_torch_parallel*.py.

`run_ranks` starts `world` ranks of a job as subprocesses (`python
tests/test_torch_parallel_ranks.py JOB`), each with one thread, a gloo
process group met through a `file://` store under the test's tmp_path (no
TCP port to collide across xdist workers) and a timeout; each rank writes
its result to `rank<r>.pt`, which the test compares.

The tests here need no JAX:
- the grid: rank r sits at `np.unravel_index(r, (data, view, depth))`,
  the refusals (training over a depth axis above 1 naming A5b, a grid
  that does not use every process, a view split of the source views that
  does not divide), and the differentiable sum's backward;
- `python -m mvsformer_torch.parallel.dryrun --world 4`;
- the step at data 2 with SyncBN, at view 2 (each of the three fusions),
  at data 2 x view 2 and DINOMVSNet's `fix` step at data 2 against the
  serial step of the port on the same weights and batch (float64: the sums
  in another order are the only difference), and the bf16 step at data 2
  against the serial bf16 step at the bf16 bounds;
- the train CLI at data 2: only rank 0 writes the run directory; at view
  2 under GN: the serial run's losses and validation;
- the test CLI at view 2: the serial CLI's files.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mvsformer_torch.config import Config, ModelConfig
from mvsformer_torch.parallel import mesh
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RANK_TIMEOUT_S = 300
KEYS = ("stage1", "stage2", "stage3", "stage4")
# The toy step: tests/test_model.py's tiny cascade at the default widths.
CFG = dict(ndepths=[8, 4, 4, 2], depth_interals_ratio=[4.0, 2.67, 1.5, 1.0],
           feat_chs=[8, 16, 32, 64], base_ch=8, depth_type="ce", inverse_depth=True,
           fusion_type="cnn")
OPT = dict(vit_lr=3e-5, lr=1e-3, weight_decay=0.01, min_lr=0.01, warmup_steps=0,
           grad_norm=None)
# DINOMVSNet's ViT as configs/config_mvsformer-p.json ships it (tests/test_torch_dino.py).
DINO_VIT = dict(twin=False, vit_arch="vit_small", vit_ch=384, out_ch=64, att_fusion=True)


# ------------------------------------------------------------------ the ranks

def run_ranks(tmp_path, world, job, timeout=RANK_TIMEOUT_S, env=None, script=__file__):
    """Run `job` (a JSON-able dict naming its `kind`) on `world` gloo ranks
    (`python <script> JOB`, this file's `rank_main` by default) and return
    each rank's result. A rank that fails, or a run that passes `timeout`,
    fails the test with every rank's output."""
    job = dict(job, store=str(tmp_path / "store"), out=str(tmp_path), world=world)
    path = tmp_path / f"job-{job['kind']}.json"
    path.write_text(json.dumps(job))
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, script, str(path)], cwd=REPO, stdout=logs[r], stderr=subprocess.STDOUT,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                 OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([REPO, HERE]), **(env or {})))
        for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    text = "\n".join(f"--- rank {r} (exit {p.returncode}):\n"
                     + (tmp_path / f"rank{r}.log").read_text()[-3000:]
                     for r, p in enumerate(procs))
    assert all(p.returncode == 0 for p in procs), text
    results = []
    for r in range(world):  # each file removed once read: a rank's gradients take 0.2 GB
        results.append(torch.load(tmp_path / f"rank{r}.pt", weights_only=False))
        (tmp_path / f"rank{r}.pt").unlink()
    return results


def train_config(norm="BN", cfg=None):
    """The toy step's Config: CFG's cascade under `norm`, no drop path, one
    sample a micro-batch at 64x64, AdamW without warmup."""
    from mvsformer_torch.config import OptimizerConfig

    c = Config(arch=ModelConfig(**dict(CFG, norm_type=norm, **(cfg or {}))),
               optimizer=OptimizerConfig(**OPT))
    c.arch.vit_args.drop_path_rate = 0.0
    c.data.multi_scale_args.scale_batch_map = {"64": 1}
    c.trainer.epochs = 15
    return c


def job_config(norm, over):
    """`train_config(norm, over)` where `over` may give `vit_args` as a dict
    (a job's JSON)."""
    from mvsformer_torch.config import ViTConfig

    over = dict(over or {})
    if "vit_args" in over:
        over["vit_args"] = ViTConfig(**over["vit_args"])
    return train_config(norm, over)


def _build(job, layout, train):
    from mvsformer_torch.models.mvsformer import build_model

    cfg = job_config(job.get("norm", "BN"), job.get("cfg"))
    dtype = torch.bfloat16 if job.get("dtype") == "bf16" else torch.float32
    model = build_model(cfg.arch, device=job.get("device", "cpu"), train=train, layout=layout,
                        dtype=dtype)
    if job.get("dtype") == "float64":
        model = model.double()
    model.load_state_dict(torch.load(job["weights"], weights_only=False))
    return cfg, model


def _share(batch, d, data):
    """Data rank d's contiguous share of the batch's samples."""
    def take(a):
        b = a.shape[0] // data
        return a[d * b:(d + 1) * b]
    return {k: ({s: take(a) for s, a in v.items()} if isinstance(v, dict) else take(v))
            for k, v in batch.items()}


def job_step(job, layout):
    import contextlib

    import chip_smoke
    from mvsformer_torch.train.step import TrainStep

    cfg, model = _build(job, layout, train=True)
    batch = torch.load(job["batch"], weights_only=False)
    pinned = contextlib.nullcontext()
    if job.get("schedules"):  # the serial step's hypotheses, this data rank's samples of them
        n = batch["imgs"].shape[0] // layout.data
        d = layout.data_index
        pinned = chip_smoke.pinned_schedules([t[d * n:(d + 1) * n] for t in torch.load(
            job["schedules"], weights_only=False)])
    with pinned:
        metrics = TrainStep(model, cfg)(_share(batch, layout.data_index, layout.data))
    # The updated parameters by a fingerprint each (their sum and sum of
    # squares, bit for bit): the ranks' updates must be the same.
    return {"metrics": metrics,
            "grads": {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
            "buffers": {n: b for n, b in model.named_buffers() if b.is_floating_point()},
            "params": {n: (float(p.detach().double().sum()),
                           float(p.detach().double().square().sum()))
                       for n, p in model.named_parameters()}}


def job_eval(job, layout):
    from mvsformer_torch.infer import make_infer_fn
    from mvsformer_torch.ops import cuda_build

    _, model = _build(job, layout, train=False)
    imgs, projs, dv = torch.load(job["request"], weights_only=False)
    cuda_build.reset_launches()
    depth, conf, stage_confs = make_infer_fn(model, job["tmps"])(imgs, projs, dv)
    return {"depth": depth.cpu(), "conf": conf.cpu(), "stage_confs": [c.cpu() for c in stage_confs],
            "launches": dict(cuda_build.LAUNCHES)}


def job_similarity(job, layout):
    """The eval forward of this rank's views with `want_similarity`: the
    refined outputs and each stage's sim_depth."""
    _, model = _build(job, layout, train=False)
    imgs, projs, dv = torch.load(job["request"], weights_only=False)
    imgs, projs = layout.local_request(imgs, projs)
    with torch.inference_mode():
        out = model(imgs, projs, dv, tmp=job["tmps"], want_similarity=True)
    return {"depth": out["refined_depth"], "conf": out["photometric_confidence"],
            "sim_depth": [out[f"stage{i + 1}"]["sim_depth"] for i in range(len(KEYS))]}


def job_save_depth(job, layout):
    from mvsformer_torch.infer import save_depth

    _, model = _build(job, layout, train=False)
    return {"metrics": save_depth(model, device="cpu", logger=lambda *a: None,
                                  **job["save_depth"])}


def job_cli(job, layout):
    import importlib

    importlib.import_module(job["module"]).main(job["argv"])
    return {}


def job_sums(job, layout):
    """The collectives on a rank's own numbers: x = rank + 1 (a vector),
    the differentiable sum over the world with the loss sum(y * (rank +
    2)), and `mean_` of a copy."""
    import torch.distributed as dist

    r = dist.get_rank()
    x = torch.full((3,), float(r + 1), dtype=torch.float64, requires_grad=True)
    y = mesh.all_sum(x, None)
    (y * (r + 2)).sum().backward()
    m = mesh.all_mean(x.detach(), None)
    z = [x.detach().clone(), torch.full((2, 2), float(10 * r))]
    mesh.mean_(z)
    return {"y": y.detach(), "grad": x.grad, "mean": m, "mean_": z}


JOBS = {"step": job_step, "eval": job_eval, "save_depth": job_save_depth, "cli": job_cli,
        "sums": job_sums, "similarity": job_similarity}


def rank_main(path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(path) as f:
        job = json.load(f)
    rank = int(os.environ["RANK"])
    if job["kind"] == "cli":  # the CLI joins the group itself (--dist_url)
        result = job_cli(job, None)
    else:
        dist.init_process_group("gloo", init_method="file://" + job["store"],
                                world_size=job["world"], rank=rank)
        layout = mesh.make_layout(job["data"], job["view"], job.get("depth", 1))
        with torch.backends.mkldnn.flags(enabled=job.get("mkldnn", True)):
            result = JOBS[job["kind"]](job, layout)
        dist.destroy_process_group()
    torch.save(result, os.path.join(job["out"], f"rank{rank}.pt"))


# ------------------------------------------------------------------ the grid

@pytest.mark.parametrize("data,view", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (3, 4)])
def test_grid_position_is_the_row_major_reshape(data, view):
    world = data * view
    grid = np.arange(world).reshape(data, view, 1)
    for r in range(world):
        d, v, z = mesh.grid_position(r, data, view)
        assert grid[d, v, z] == r and (d, v) == divmod(r, view)
    assert mesh.grid_shape(world, -1, view) == (data, view, 1)
    for depth in (2, 3):  # the depth axis is the fastest, as make_mesh reshapes
        grid = np.arange(world * depth).reshape(data, view, depth)
        assert mesh.grid_shape(world * depth, -1, view, depth) == (data, view, depth)
        for r in range(world * depth):
            layout = mesh.Layout(data=data, view=view, depth=depth, rank=r)
            assert mesh.grid_position(r, data, view, depth) == (
                layout.data_index, layout.view_index, layout.depth_index)
            assert grid[layout.data_index, layout.view_index, layout.depth_index] == r
            assert grid[layout.data_index, 0, layout.depth_index] == layout.view_lead


@pytest.mark.parametrize("world,data,view,match", [
    (4, 3, 1, "needs 3 processes"),
    (4, -1, 3, "do not split into view groups of 3"),
    (2, 1, 1, "needs 1 processes"),
    (1, 2, 1, "torchrun"),
])
def test_a_grid_that_does_not_use_every_process_raises(world, data, view, match):
    with pytest.raises(ValueError, match=match):
        mesh.grid_shape(world, data, view)


def test_a_depth_axis_raises_naming_a5b():
    """The depth axis serves (a grid of 8 lays out 2 x 2 x 2; one process
    is no grid of two), and the train CLI's setup refuses it, naming A5b's
    training half."""
    from argparse import Namespace

    assert mesh.grid_shape(8, 2, 2, 2) == (2, 2, 2)
    assert mesh.grid_shape(8, -1, 1, 4) == (2, 1, 4)
    with pytest.raises(ValueError, match="view x depth groups of 3 x 2"):
        mesh.grid_shape(8, -1, 3, 2)
    with pytest.raises(ValueError, match="torchrun"):
        mesh.make_layout(depth=2)
    args = Namespace(device="cpu", data_parallel=-1, view_parallel=1, depth_parallel=2,
                     multi_host=False, dist_backend=None, dist_url="env://")
    with pytest.raises(NotImplementedError, match="ROADMAP A5b, training"):
        mesh.start(args, train=True)


def test_one_process_lays_out_alone():
    layout = mesh.make_layout()
    assert (layout.data, layout.view, layout.world, layout.rank) == (1, 1, 1, 0)
    assert layout.data_group is None and layout.view_group is None
    with pytest.raises(ValueError, match="torchrun"):
        mesh.make_layout(view=2)


@pytest.mark.parametrize("view_index", [0, 1, 2])
def test_local_views_keep_the_reference_and_a_block_of_sources(view_index):
    layout = mesh.Layout(data=1, view=3, rank=view_index)
    x = torch.arange(2 * 7).reshape(2, 7)
    got = layout.local_views(x)
    want = [0] + list(range(1 + 2 * view_index, 3 + 2 * view_index))
    assert torch.equal(got, x[:, want])
    with pytest.raises(ValueError, match="num_view - 1 must divide"):
        layout.local_views(x[:, :6])


def test_the_cli_start_refuses_what_it_cannot_run(monkeypatch):
    from argparse import Namespace

    for var in ("WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    args = Namespace(device="cpu", data_parallel=-1, view_parallel=1, depth_parallel=1,
                     multi_host=False, dist_backend=None, dist_url="env://")
    device, layout = mesh.start(args)
    assert device.type == "cpu" and layout.world == 1
    with pytest.raises(ValueError, match="torchrun"):  # serving: one process is no grid
        mesh.start(Namespace(**dict(vars(args), depth_parallel=2)))
    with pytest.raises(NotImplementedError, match="ROADMAP A5b"):
        mesh.start(Namespace(**dict(vars(args), depth_parallel=2)), train=True)
    with pytest.raises(ValueError, match="torchrun"):
        mesh.start(Namespace(**dict(vars(args), data_parallel=2)))
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh.start(Namespace(**dict(vars(args), multi_host=True)))
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="--multi_host"):
        mesh.start(args)


def test_nccl_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one CUDA card per rank"):
        mesh.init_distributed("nccl", "cuda:0")


def test_the_differentiable_sum_is_its_own_transpose(tmp_path):
    """Over 3 ranks: all_sum gives every rank the sum, its backward sums the
    ranks' cotangents (the psum's transpose), all_mean and mean_ give the
    mean."""
    ranks = run_ranks(tmp_path, 3, dict(kind="sums", data=3, view=1))
    for r in ranks:
        assert torch.equal(r["y"], torch.full((3,), 6.0, dtype=torch.float64))
        assert torch.equal(r["grad"], torch.full((3,), 9.0, dtype=torch.float64))
        assert torch.equal(r["mean"], torch.full((3,), 2.0, dtype=torch.float64))
        assert torch.equal(r["mean_"][0], torch.full((3,), 2.0, dtype=torch.float64))
        assert torch.equal(r["mean_"][1], torch.full((2, 2), 10.0))


def test_dryrun_trains_one_step_over_four_ranks():
    out = subprocess.run([sys.executable, "-m", "mvsformer_torch.parallel.dryrun", "--world",
                          "4", "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                         timeout=RANK_TIMEOUT_S, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "data 2 x view 2" in out.stdout
    loss, gnorm = (float(x) for x in out.stdout.split("loss ")[1].split(" grad_norm "))
    assert np.isfinite(loss) and loss > 0 and np.isfinite(gnorm) and gnorm > 0


def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The dry run's ranks take the card by default: without one it raises
    before it starts a rank; nccl wants a card per rank, and refuses the
    CPU and one card shared by several ranks."""
    from mvsformer_torch.parallel import dryrun

    with pytest.raises(RuntimeError, match="none is available"):
        dryrun.main(["--world", "2"])
    for argv in (["--device", "cpu", "--backend", "nccl"], ["--device", "cuda:0", "--backend",
                                                            "nccl"], []):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(SystemExit):
            dryrun.main(["--world", "2"] + argv)


# ------------------------------------------------------------------ the step

def make_train_batch(rng, B=2, V=5, H=64, W=64):
    """tests/test_model.py's make_batch cameras, 425-900 depths over 48
    hypotheses, a uniform depth ground truth and a random mask per stage."""
    imgs = rng.standard_normal((B, V, H, W, 3)).astype(np.float32)
    K = np.array([[80.0, 0, W / 4], [0, 80.0, H / 4], [0, 0, 1]], np.float32)
    projs, gt, mask = {}, {}, {}
    for s, scale in zip(KEYS, (1 / 8, 1 / 4, 1 / 2, 1.0)):
        cams = np.zeros((B, V, 2, 4, 4), np.float32)
        for v in range(V):
            ext = np.eye(4, dtype=np.float32)
            ext[0, 3] = v * 2.0
            cams[:, v, 0] = ext
            cams[:, v, 1, :3, :3] = K * scale
            cams[:, v, 1, 2, 2] = 1.0
            cams[:, v, 1, 3, 3] = 1.0
        projs[s] = cams
    for s, down in zip(KEYS, (8, 4, 2, 1)):
        gt[s] = rng.uniform(430, 890, (B, H // down, W // down)).astype(np.float32)
        mask[s] = (rng.uniform(size=(B, H // down, W // down)) > 0.1).astype(np.float32)
    dv = np.broadcast_to(np.linspace(425, 900, 48, dtype=np.float32)[None], (B, 48)).copy()
    return dict(imgs=imgs, proj_matrices=projs, depth_values=dv, depth_gt=gt, mask=mask)


def ddp_loss(out, batch, shards, cfg):
    """The loss data-parallel ranks minimise: each shard's masked mean,
    then their mean (tests/test_parallel.py:60-76). -> (loss, stage losses)."""
    from mvsformer_torch.ops.losses import total_loss

    B = batch["imgs"].shape[0]
    n = B // shards
    total, stages = 0.0, {k: 0.0 for k in KEYS}
    for i in range(shards):
        sl = slice(i * n, (i + 1) * n)
        o = {k: {f: t[sl] for f, t in out[k].items()} for k in KEYS}
        dv = batch["depth_values"][sl]
        loss, ld = total_loss(o, {k: v[sl] for k, v in batch["depth_gt"].items()},
                              {k: v[sl] for k, v in batch["mask"].items()}, dv[:, 1] - dv[:, 0],
                              depth_type=cfg.arch.depth_type, stage_keys=KEYS)
        total = total + loss / shards
        for k in KEYS:
            stages[k] = stages[k] + ld[k] / shards
    return total, stages


def serial_ddp_step(model, batch, shards, cfg, dtype=torch.float64):
    """The serial model's gradients of `ddp_loss` over `shards` shards of
    the whole batch in one training forward (BN over every sample, as
    SyncBN gives the data ranks), and its running statistics after it; the
    batch in `dtype` (the parameters', float64 or fp32)."""
    from mvsformer_torch import fp32_math

    tb = {k: ({s: torch.as_tensor(a, dtype=dtype) for s, a in v.items()}
              if isinstance(v, dict) else torch.as_tensor(v, dtype=dtype))
          for k, v in batch.items()}
    model.train()
    model.zero_grad(set_to_none=True)
    with fp32_math():
        out = model(tb["imgs"], tb["proj_matrices"], tb["depth_values"])
        loss, stages = ddp_loss(out, tb, shards, cfg)
        loss.backward()
    return (float(loss.detach()), {k: float(v.detach()) for k, v in stages.items()},
            {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
            {n: b for n, b in model.named_buffers()})


@pytest.fixture(scope="module")
def step_inputs(tmp_path_factory):
    """The batch (B=2, V=5, 64x64), saved for the ranks."""
    tmp = tmp_path_factory.mktemp("step")
    batch = make_train_batch(np.random.default_rng(0))
    torch.save(batch, tmp / "batch.pt")
    return {"batch": batch, "batch_path": str(tmp / "batch.pt")}


def random_weights(path, cfg, dtype=torch.float64):
    """A model of `cfg` with random weights (seed 1) in `dtype`, its state
    saved to `path` for the ranks."""
    from mvsformer_torch.models.mvsformer import build_model, random_init_

    model = build_model(cfg.arch, device="cpu", train=True).to(dtype)
    random_init_(model, torch.Generator().manual_seed(1))
    torch.save(model.state_dict(), path)
    return model


# Sums in another order are the only difference. The model is float64, but
# the warp, the correlation, the view weights and sum and the losses are fp32
# islands on both sides (as in the JAX package), so a view split, which sums
# the views in another order, moves the loss by ~1e-7 of itself (8.3e-8
# measured) and every gradient by an absolute fp32 noise (3.7e-8 measured);
# the data split moves them by 5e-9 of scale, and the running statistics by
# 4e-15.
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
STATS_RTOL, STATS_ATOL = 1e-9, 1e-12


# (norm, data, view, the toy cascade's overrides). A view split runs under GN
# (a view rank's BN would see the FPN statistics of its own views only); the
# epipole fusions weight the views by their own nets, whose sum the view
# group all-reduces as it does the cnn fusion's; DINOMVSNet's `fix` step
# keeps the ViT frozen.
GRID_STEPS = [
    pytest.param("BN", 2, 1, {}, id="BN-2-1"),
    pytest.param("GN", 1, 2, {}, id="GN-1-2"),
    pytest.param("GN", 2, 2, {}, id="GN-2-2"),
    pytest.param("GN", 1, 2, {"fusion_type": "epipole"}, id="GN-1-2-epipole"),
    pytest.param("GN", 1, 2, {"fusion_type": "epipoleV2"}, id="GN-1-2-epipoleV2"),
    pytest.param("BN", 2, 1, {"model_type": "dino", "fix": True, "vit_args": DINO_VIT},
                 id="BN-2-1-dino-fix"),
]


@pytest.mark.parametrize("norm,data,view,over", GRID_STEPS)
def test_the_step_over_a_grid_is_the_serial_step(tmp_path, step_inputs, norm, data, view, over):
    """data 2 with SyncBN, view 2, data 2 x view 2 (the cnn fusion), view 2
    with each epipole fusion, and DINOMVSNet's `fix` step at data 2: every
    rank's averaged gradients, losses and running statistics are the serial
    model's on the whole batch with the DDP loss, and its update the same
    on every rank."""
    cfg = job_config(norm, over)
    model = random_weights(tmp_path / "weights.pt", cfg)
    ranks = run_ranks(tmp_path, data * view, dict(
        kind="step", data=data, view=view, norm=norm, cfg=over, dtype="float64",
        weights=str(tmp_path / "weights.pt"), batch=step_inputs["batch_path"]))
    loss, stages, grads, buffers = serial_ddp_step(model, step_inputs["batch"], 2, cfg)
    for r in ranks:
        m = r["metrics"]
        np.testing.assert_allclose(m["loss"], loss, rtol=LOSS_RTOL)
        for k in KEYS:
            np.testing.assert_allclose(m[f"loss_{k}"], stages[k], rtol=LOSS_RTOL)
        assert set(r["grads"]) == set(grads)
        for n, g in grads.items():
            np.testing.assert_allclose(r["grads"][n].numpy(), g.numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=n)
        for n, b in buffers.items():
            if b.is_floating_point():
                np.testing.assert_allclose(r["buffers"][n].numpy(), b.numpy(), rtol=STATS_RTOL,
                                           atol=STATS_ATOL, err_msg=n)
        assert r["params"] == ranks[0]["params"]


def bf16_grid_step(tmp_path, step_inputs, mkldnn=True):
    """The data 2 SyncBN step in bf16 (the CLIs' default) and the serial step
    with the DDP loss on the same fp32 weights, in bf16 and in fp32, all
    three on the serial bf16 step's hypotheses (`chip_smoke.
    pinned_schedules`, as phase 15 pins its steps). -> (rank results,
    {"bf16": serial, "fp32": serial}, each (loss, stages, grads,
    buffers))."""
    import chip_smoke
    from mvsformer_torch.models.mvsformer import build_model

    cfg = train_config("BN")
    random_weights(tmp_path / "weights.pt", cfg, torch.float32)
    serial, schedules = {}, []
    with torch.backends.mkldnn.flags(enabled=mkldnn):
        for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            model = build_model(cfg.arch, device="cpu", train=True, dtype=dtype)
            model.load_state_dict(torch.load(tmp_path / "weights.pt", weights_only=False))
            with chip_smoke.pinned_schedules(schedules):
                serial[name] = serial_ddp_step(model, step_inputs["batch"], 2, cfg,
                                               torch.float32)
    torch.save(schedules, tmp_path / "schedules.pt")
    ranks = run_ranks(tmp_path, 2, dict(
        kind="step", data=2, view=1, norm="BN", dtype="bf16", mkldnn=mkldnn,
        weights=str(tmp_path / "weights.pt"), batch=step_inputs["batch_path"],
        schedules=str(tmp_path / "schedules.pt")))
    return ranks, serial


def test_the_bf16_step_at_data_2_is_the_serial_bf16_step(tmp_path, step_inputs):
    """The CLIs' default dtype on the grid: SyncBN on bf16 activations (fp32
    statistics through the all-reduce) and the gradients' world mean, held
    at the bf16 bounds of tests/test_torch_bf16_step.py and phase 15, whose
    yardstick is the serial step's own bf16-vs-fp32 gap: each gradient
    group by `chip_smoke.grad_group_check` (and each of its mutants
    rejected), the losses' RMS and the running statistics (mean and maximum
    error) within BF16_MULT times that gap plus 1e-6. oneDNN is off on both
    sides, as in phase 15's CPU step (its bf16 Conv3d weight gradient is not
    stable on every host). At these random weights bf16 rounding alone moves
    a gradient group by 0.26-0.70 of its norm from fp32, and the grid lies
    0.18-0.38 from the serial bf16 step (measured on the CPU); with the
    ranks' BN statistics left unsynchronised it lies 0.81-1.41 away (oneDNN
    on) and every group fails."""
    import chip_smoke

    ranks, serial = bf16_grid_step(tmp_path, step_inputs, mkldnn=False)
    (l16, st16, g16, b16), (l32, st32, g32, b32) = serial["bf16"], serial["fp32"]
    mult, floor = chip_smoke.BF16_MULT, 1e-6
    want16 = np.array([l16] + [st16[k] for k in KEYS])
    want32 = np.array([l32] + [st32[k] for k in KEYS])
    rms = lambda x: float(np.sqrt(np.mean(x ** 2)))
    names = [n for n, b in b16.items() if b.is_floating_point()]
    flat = lambda d, ns: torch.cat([d[n].double().reshape(-1) for n in ns]).numpy()
    for r in ranks:
        got = np.array([r["metrics"]["loss"]] + [r["metrics"][f"loss_{k}"] for k in KEYS])
        assert rms(got - want16) <= mult * rms(want16 - want32) + floor * abs(l32), (got, want16)
        assert set(r["grads"]) == set(g16)
        for group in chip_smoke.STEP_GROUPS:
            ns = sorted(n for n in g16 if n.startswith(group + "."))
            got_g, want_g, ref_g = flat(r["grads"], ns), flat(g16, ns), flat(g32, ns)
            ok, reading = chip_smoke.grad_group_check(got_g, want_g, ref_g)
            assert ok, (group, reading)
            for mutant, wrong in chip_smoke.grad_mutants(got_g).items():
                assert not chip_smoke.grad_group_check(wrong, want_g, ref_g)[0], (group, mutant)
        err = np.abs(flat(r["buffers"], names) - flat(b16, names))
        gap = np.abs(flat(b16, names) - flat(b32, names))
        assert err.mean() <= mult * gap.mean() + floor, (err.mean(), gap.mean())
        assert err.max() <= mult * gap.max() + floor, (err.max(), gap.max())
        assert r["params"] == ranks[0]["params"]


# ------------------------------------------------------------------ the CLIs

# The view split sums the views in another order (the serial stage adds
# each view's product in one rounding, fused; the all-reduce adds the
# rounded products): 8.6e-7 of the depth, 6.1e-4 at most over 425-900
# (measured on the CPU), where the model tests' bound is 1e-2.
DEPTH_ATOL = 2e-3


def _records(run_dir):
    with open(os.path.join(run_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def cli_train_config(tmp_path, name="toy", norm="BN", workers=2, drop_path=0.2, lr=None):
    """A toy training run's config.json (3 views x 7 lights of chip_smoke's
    plane at 240x320, 64x64 crops, batch 4 in micro-batches of 1, ndepths
    8/4/4/2 over the cameras' 192 depths, one epoch; `workers` loader
    threads, the backbone's `drop_path` rate, `lr` for both LR groups if
    given) -> its path."""
    import chip_smoke
    from mvsformer_torch.config import save_config

    root = str(tmp_path / "dtu")
    if not os.path.isdir(root):
        chip_smoke.write_dtu_train_tree(root, views=3, img_hw=(240, 320))
    cfg = Config()
    cfg.name = name
    cfg.arch.ndepths = [8, 4, 4, 2]
    cfg.arch.norm_type = norm
    cfg.arch.vit_args.drop_path_rate = drop_path
    cfg.data.datapath = root
    (tmp_path / "list.txt").write_text("scan1\n")
    cfg.data.train_data_list = cfg.data.val_data_list = str(tmp_path / "list.txt")
    cfg.data.nviews, cfg.data.num_depths, cfg.data.batch_size = 3, 192, 4
    cfg.data.num_workers = workers
    cfg.data.height = cfg.data.width = 64
    cfg.data.resize_scale = 0.3
    cfg.data.multi_scale_args.scales = [[64, 64]]
    cfg.data.multi_scale_args.scale_batch_map = {"64": 1}
    cfg.trainer.epochs, cfg.trainer.logging_every = 1, 1
    cfg.trainer.save_dir = str(tmp_path / "saved")
    cfg.optimizer.warmup_steps = 2
    if lr is not None:
        cfg.optimizer.lr = cfg.optimizer.vit_lr = lr
    path = str(tmp_path / f"{name}.json")
    save_config(cfg, path)
    return path


def grid_argv(tmp_path, *axes):
    return list(axes) + ["--dist_backend", "gloo", "--dist_url",
                         "file://" + str(tmp_path / "store")]


def test_train_cli_at_data_2_writes_from_rank_0_only(tmp_path):
    """`python -m mvsformer_torch.train --data_parallel 2` on two gloo
    ranks (`cli_train_config`): both ranks train and validate, every step
    is recorded once, with a finite loss, and the run directory holds one
    config, log and checkpoint set."""
    config = cli_train_config(tmp_path)
    run_ranks(tmp_path, 2, dict(kind="cli", module="mvsformer_torch.train.__main__", argv=[
        "--config", config, "--device", "cpu", "--dtype", "fp32"]
        + grid_argv(tmp_path, "--data_parallel", "2")))
    run = str(tmp_path / "saved" / "models" / "toy")
    recs = _records(run)
    steps = [r for r in recs if r["kind"] == "step"]
    # 21 samples padded to 22, 11 a rank: 5 steps of 2 a rank.
    assert [r["global_step"] for r in steps] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(r["loss"]) and r["micro_batches"] == 2 for r in steps)
    assert [r["kind"] for r in recs].count("val") == 1
    assert {r["name"] for r in recs if r["kind"] == "checkpoint"} == {"model_best",
                                                                      "model_last"}
    assert sorted(os.listdir(run)) == sorted([
        "config.json", "info.log", "train_log.jsonl", "model_best.pth",
        "model_best.meta.json", "model_last.pth", "model_last.meta.json"])
    with open(os.path.join(run, "info.log")) as f:
        assert sum("epoch 1 val:" in line for line in f) == 1


def test_train_cli_at_view_2_is_the_serial_run(tmp_path):
    """Under GN (BN's FPN statistics would differ over a view rank's own
    views) the train CLI at view 2, each rank the reference and one of the
    two source views of every sample, trains and validates as the serial
    CLI does from the same seed: every step's loss and the validation
    metrics within 1e-3 of it. fp32 sums in another order, and AdamW turns
    the gradients' last bits into LR-sized moves where they are small: at
    the default LR the losses agree to 2e-7 over the first 4 steps and to
    2.6e-4 at the 5th, and the validation's mean absolute error after them
    to 0.4%, so both runs take an LR of 1e-6, which keeps the weights
    within 1e-5 of each other. One loader thread (with more, the samples'
    random draws depend on the threads' order, E5) and no drop path (a view
    rank draws its masks for its own views, as a JAX view shard does)."""
    from mvsformer_torch.train import __main__ as train_cli

    serial = cli_train_config(tmp_path, "serial", norm="GN", workers=1, drop_path=0.0, lr=1e-6)
    train_cli.main(["--config", serial, "--device", "cpu", "--dtype", "fp32"])
    grid = cli_train_config(tmp_path, "grid", norm="GN", workers=1, drop_path=0.0, lr=1e-6)
    run_ranks(tmp_path, 2, dict(kind="cli", module="mvsformer_torch.train.__main__", argv=[
        "--config", grid, "--device", "cpu", "--dtype", "fp32"]
        + grid_argv(tmp_path, "--view_parallel", "2")))
    one, two = (_records(str(tmp_path / "saved" / "models" / n)) for n in ("serial", "grid"))
    steps = [[r["loss"] for r in recs if r["kind"] == "step"] for recs in (one, two)]
    assert len(steps[0]) == 5
    np.testing.assert_allclose(steps[1], steps[0], rtol=1e-3)
    vals = [next(r for r in recs if r["kind"] == "val") for recs in (one, two)]
    assert 0 < vals[0]["mean_error"] < 1 and all(loss > 0 for loss in steps[0])
    for k in ("abs_error", "thres2mm_error", "thres4mm_error", "thres8mm_error", "mean_error"):
        np.testing.assert_allclose(vals[1][k], vals[0][k], rtol=1e-3, atol=1e-3, err_msg=k)


def test_test_cli_at_view_2_writes_the_serial_files(tmp_path):
    """`python -m mvsformer_torch.test --view_parallel 2` on two gloo ranks
    (3 views a request: one source each) writes the files the serial CLI
    writes for chip_smoke's 6-view plane scan, each depth map within
    DEPTH_ATOL, and rank 0 fuses them."""
    import dataclasses

    import chip_smoke
    from mvsformer_torch import test as test_cli
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.utils.pfm import read_pfm

    chip_smoke.write_dtu_scan(str(tmp_path), img_hw=(150, 225))
    cfg = Config()
    cfg.arch.ndepths = [8, 4, 4, 2]
    (tmp_path / "config.json").write_text(json.dumps({"arch": dataclasses.asdict(cfg.arch)}))
    model = random_init_(build_model(cfg.arch, device="cpu"), torch.Generator().manual_seed(0))
    torch.save({"state_dict": model.state_dict()}, tmp_path / "model.pth")
    (tmp_path / "list.txt").write_text("scan1\n")

    def argv(out):
        return ["--testpath", str(tmp_path / "dtu"), "--testlist", str(tmp_path / "list.txt"),
                "--ckpt_dir", str(tmp_path), "--torch_ckpt", str(tmp_path / "model.pth"),
                "--outdir", str(out), "--max_h", "128", "--max_w", "192", "--ndepths", "48",
                "--num_view", "3", "--device", "cpu", "--prob_threshold", "0.0",
                "--thres_view", "2", "--dtype", "fp32"]

    test_cli.main(argv(tmp_path / "serial"))
    run_ranks(tmp_path, 2, dict(kind="cli", module="mvsformer_torch.test", argv=argv(
        tmp_path / "grid") + grid_argv(tmp_path, "--view_parallel", "2")))

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(tmp_path / "grid") == files(tmp_path / "serial")
    depths = [f for f in files(tmp_path / "serial") if f.endswith(".pfm")]
    assert len(depths) == 6
    for f in depths:
        np.testing.assert_allclose(read_pfm(str(tmp_path / "grid" / f))[0],
                                   read_pfm(str(tmp_path / "serial" / f))[0], rtol=0,
                                   atol=DEPTH_ATOL, err_msg=f)


if __name__ == "__main__":
    rank_main(sys.argv[1])
