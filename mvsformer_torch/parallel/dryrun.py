"""One full training step over N processes: the multi-device dry run.

    python -m mvsformer_torch.parallel.dryrun --world 4          # cuda:r a rank, nccl
    python -m mvsformer_torch.parallel.dryrun --world 2 --device cuda:0 --backend gloo
    python -m mvsformer_torch.parallel.dryrun --world 4 --device cpu   # gloo

Port of `__graft_entry__.dryrun_multichip` without the depth axis: N ranks,
laid out data N/2 x view 2 for an even N (data N otherwise), train
TwinMVSNet at the default ModelConfig's widths with ndepths 8/4/4/2, GN and
no drop path, for one step on a synthetic batch of the JAX dry run's
shapes (B = data samples, V = 1 + 2 x view views, 64x64, 48 depths, depth
ground truth and a full mask per stage): every rank builds the same
weights from one seed, and the step splits the batch over "data" and the
source views over "view" (`train/step.TrainStep`). Rank 0 prints the loss
and the gradient norm. The ranks meet through a file store in a temporary
directory, so no port is opened. The JAX dry run's opt-in scaling proxy is
not ported.

The ranks run on the card unless `--device cpu` asks for the CPU: with
`--device cuda` (the default) rank r takes `cuda:r` and the backend
defaults to nccl, which needs a card per rank; a named card (`cuda:0`)
holds every rank, over gloo. The JAX dry run takes the real devices where
there are enough, and the CPU where there are not; here the caller
chooses, and asking for a card where there is none raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

NDEPTH_FULL = 48
H = W = 64


def grid(world: int) -> tuple:
    """(data, view) of the dry run: data N/2 x view 2 for an even N."""
    return (world // 2, 2) if world % 2 == 0 else (world, 1)


def synthetic_batch(b, v_, h=H, w=W, ndepth_full=NDEPTH_FULL) -> dict:
    """`__graft_entry__._synthetic_batch(with_gt=True)` as numpy arrays:
    unit-variance images, cameras translated along x, 425-900 depths, a
    uniform depth ground truth and a full mask per stage."""
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((b, v_, h, w, 3)).astype(np.float32)
    K = np.array([[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]], np.float32)
    projs, gt, mask = {}, {}, {}
    for s, scale in zip(range(1, 5), (1 / 8, 1 / 4, 1 / 2, 1.0)):
        cams = np.zeros((b, v_, 2, 4, 4), np.float32)
        for v in range(v_):
            ext = np.eye(4, dtype=np.float32)
            ext[0, 3] = v * 2.0
            cams[:, v, 0] = ext
            cams[:, v, 1, :3, :3] = K * scale
            cams[:, v, 1, 2, 2] = 1.0
            cams[:, v, 1, 3, 3] = 1.0
        projs[f"stage{s}"] = cams
    for s, down in zip(range(1, 5), (8, 4, 2, 1)):
        gt[f"stage{s}"] = rng.uniform(430, 890, (b, h // down, w // down)).astype(np.float32)
        mask[f"stage{s}"] = np.ones((b, h // down, w // down), np.float32)
    dv = np.broadcast_to(np.linspace(425.0, 900.0, ndepth_full, dtype=np.float32)[None],
                         (b, ndepth_full)).copy()
    return {"imgs": imgs, "proj_matrices": projs, "depth_values": dv, "depth_gt": gt,
            "mask": mask}


def rank_step(rank: int, world: int, store: str, backend, device) -> dict:
    """One rank's part: join the group on `device` (`cuda` is `cuda:rank`,
    as torchrun's LOCAL_RANK gives it), lay out the grid, build the model
    and train one step on this data rank's samples. Returns the step's
    metrics."""
    import torch.distributed as dist

    from mvsformer_torch.config import Config
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.parallel.mesh import init_distributed, make_layout
    from mvsformer_torch.train.step import TrainStep

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    device = init_distributed(backend, device, f"file://{store}")
    try:
        data, view = grid(world)
        layout = make_layout(data, view)
        cfg = Config()
        cfg.arch.ndepths = [8, 4, 4, 2]
        cfg.arch.norm_type = "GN"
        cfg.arch.vit_args.drop_path_rate = 0.0
        cfg.data.multi_scale_args.scale_batch_map = {str(H): 1}
        model = build_model(cfg.arch, device=device, train=True, layout=layout)
        random_init_(model, torch.Generator().manual_seed(0))
        batch = synthetic_batch(data, 1 + 2 * view)
        d = layout.data_index
        share = {k: ({s: a[d:d + 1] for s, a in v.items()} if isinstance(v, dict) else v[d:d + 1])
                 for k, v in batch.items()}
        return TrainStep(model, cfg)(share)
    finally:
        dist.destroy_process_group()


def _worker(rank, world, tmp, backend, device):
    metrics = rank_step(rank, world, os.path.join(tmp, "store"), backend, device)
    if rank == 0:
        with open(os.path.join(tmp, "metrics.json"), "w") as f:
            json.dump(metrics, f)


def main(argv=None) -> int:
    from mvsformer_torch import resolve_device

    parser = argparse.ArgumentParser(description="one training step over N processes")
    parser.add_argument("--world", type=int, default=4, help="processes (ranks)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (rank r on cuda:r), a card for every rank (cuda:0), or cpu")
    parser.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                        help="process group backend: nccl by default on cuda (a card per "
                             "rank), gloo on the CPU or to share one card")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and (device.type != "cuda" or device.index is not None
                              or torch.cuda.device_count() < args.world):
        parser.error(f"nccl needs one card per rank (--device cuda, {args.world} cards; "
                     f"{torch.cuda.device_count()} here): pass --backend gloo to share a card")
    data, view = grid(args.world)
    cards = (str(device) if device.index is not None
             else f"cuda:0-{args.world - 1}" if args.world > 1 else "cuda:0")
    where = "CPU" if device.type == "cpu" else f"{cards} ({backend})"
    print(f"dry run: {args.world} ranks on {where}, data {data} x view {view}, B={data}, "
          f"V={1 + 2 * view}, {H}x{W}, {NDEPTH_FULL} depths", flush=True)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_worker, args=(r, args.world, tmp, backend, str(device)))
                 for r in range(args.world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            print(f"dry run failed: ranks {failed} exited with an error", file=sys.stderr)
            return 1
        with open(os.path.join(tmp, "metrics.json")) as f:
            metrics = json.load(f)
    print(f"loss {metrics['loss']:.6f} grad_norm {metrics['grad_norm']:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
