"""The training command line: `python -m mvsformer_torch.train`.

Port of the JAX package's `train.py`, with the same flags:

    python -m mvsformer_torch.train --config configs/config_mvsformer.json \\
        --data_path /path/to/dtu_training [--resume | --finetune RUN_DIR]

It builds the dataset of `data.type` (DTULoader or BlendedLoader) for the
train and val lists, the threaded loaders, the config's model (TwinMVSNet,
or DINOMVSNet for `arch.model_type` "dino"; weights from `--seed`, and a
pretrained Twins or DINO ViT backbone with `--vit_path`) with fp32
parameters computing in `--dtype`: bf16 by default, as in the JAX CLI,
with the JAX package's fp32 islands (optimizer state and checkpoints stay
fp32, no loss scaler), or fp32 throughout with `--dtype fp32`. Then it
trains with validation and checkpoints in `save_dir/models/<name>/`, which holds
`config.json`, `info.log`, `train_log.jsonl` and the `model_*.pth`
checkpoints. `--resume` continues from that run dir's furthest checkpoint;
`--finetune DIR` starts from another run's `--finetune_name` checkpoint.

Several GPUs, one process each, under torchrun (`--dist_backend` nccl,
the default on CUDA, needs one card per rank; gloo also runs on the CPU and
may share a card):

    torchrun --nproc_per_node 8 -m mvsformer_torch.train --config ... \
        --data_parallel 4 --view_parallel 2 --dist_backend nccl

`--data_parallel` (-1, the default, absorbs the processes that
`--view_parallel` leaves) and `--view_parallel` lay the processes out as
`make_mesh` lays out devices (`parallel/mesh.py`). Each data rank reads
its share of every batch (the loader's host split, `batch_size / data`
samples, which must divide) in per-device micro-batches of
`scale_batch_map[height]`; the ranks of a view group train on the same
samples (the first reads them and broadcasts them) with a block of the
source views each. `--multi_host` lets the torchrun variables span nodes.

Departures from the JAX CLI:
- `--device` (default `cuda`) replaces `--platform`; under torchrun `cuda`
  means `cuda:LOCAL_RANK`, and a device with an index puts every rank on
  that card (gloo only).
- `--depth_parallel` above 1 raises: the cost volume's depth slabs are not
  ported (ROADMAP A5b).
- `--dist_backend` and `--dist_url` (default env://, torchrun's
  variables) choose the process group's backend and rendezvous.
- No TensorBoard writer (the card's machine has no tensorboard package):
  the log and `train_log.jsonl` carry the scalars.
- The model is built from the config alone, so no batch is read before
  training starts (the JAX CLI reads one to initialise its parameters,
  which draws from the dataset's generator ahead of epoch 1).
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="MVSFormer training on PyTorch and CUDA",
        epilog="Departures from the JAX package's train.py: --device replaces --platform; "
               "--depth_parallel above 1 is not ported (ROADMAP A5b); --dist_backend and "
               "--dist_url start the process group under torchrun; no TensorBoard writer.")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--data_path", type=str, default=None)
    parser.add_argument("--resume", action="store_true",
                        help="continue the run in save_dir/models/<name> from its furthest "
                             "checkpoint (model_last, or a later model_step)")
    parser.add_argument("--vit_path", type=str, default=None,
                        help="pretrained backbone checkpoint (.pth: Twins, or DINO's ViT for a "
                             "dino config), merged into the backbone "
                             "(overrides arch.vit_args.vit_path)")
    parser.add_argument("--finetune", type=str, default=None,
                        help="run dir of a previous run to finetune from")
    parser.add_argument("--finetune_name", type=str, default="model_best")
    parser.add_argument("--no_restore_opt", action="store_true",
                        help="finetune: do not restore the optimizer's moments")
    parser.add_argument("--keep_schedule", action="store_true",
                        help="finetune: fast-forward the LR schedule instead of resetting it")
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--save_every_steps", type=int, default=None,
                        help="a mid-epoch model_step checkpoint every N steps (--resume picks "
                             "it up)")
    parser.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"],
                        help="compute dtype: bf16 (the default) keeps the JAX package's fp32 "
                             "islands, with fp32 parameters, optimizer state and "
                             "checkpoints; fp32 computes in fp32 throughout")
    parser.add_argument("--data_parallel", type=int, default=-1,
                        help="data ranks (-1 = the processes left over after the view "
                             "split); must divide batch_size")
    parser.add_argument("--view_parallel", type=int, default=1,
                        help="view ranks per sample; must divide nviews - 1")
    parser.add_argument("--depth_parallel", type=int, default=1,
                        help="above 1: not ported (ROADMAP A5b)")
    parser.add_argument("--multi_host", action="store_true",
                        help="the torchrun processes span several nodes")
    parser.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                        help="process group backend (default nccl on CUDA, gloo on the CPU); "
                             "nccl needs one card per rank")
    parser.add_argument("--dist_url", type=str, default="env://",
                        help="process group rendezvous (default env://: torchrun's "
                             "MASTER_ADDR and MASTER_PORT)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; 'cpu' runs the plain PyTorch path)")
    parser.add_argument("--debug", action="store_true",
                        help="scan each top-level module's gradient for inf/nan every step")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="trace training steps [profile_start, profile_start + "
                             "profile_steps) with torch.profiler into this directory")
    parser.add_argument("--profile_start", type=int, default=10)
    parser.add_argument("--profile_steps", type=int, default=5)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from mvsformer_torch.config import load_config, save_config
    from mvsformer_torch.data.blended import BlendedMVSDataset
    from mvsformer_torch.data.dtu import DTUMVSDataset
    from mvsformer_torch.data.loader import MVSLoader, ViewGroupLoader
    from mvsformer_torch.models.mvsformer import build_model
    from mvsformer_torch.parallel.mesh import start, stop
    from mvsformer_torch.train.trainer import Trainer
    from mvsformer_torch.utils.logging import setup_logging

    device, layout = start(args)
    overrides = {}
    if args.lr is not None:
        overrides["optimizer.lr"] = args.lr
    cfg = load_config(args.config, overrides)
    if args.data_path:
        cfg.data.datapath = args.data_path
    if args.vit_path is not None:
        cfg.arch.vit_args.vit_path = args.vit_path
    if args.save_every_steps is not None:
        cfg.trainer.save_every_steps = args.save_every_steps

    if cfg.data.batch_size % layout.data:
        raise ValueError(f"batch_size {cfg.data.batch_size} does not split over "
                         f"{layout.data} data ranks")
    if (cfg.data.nviews - 1) % layout.view:
        raise ValueError(f"nviews {cfg.data.nviews}: nviews - 1 source views do not split "
                         f"over {layout.view} view ranks")
    batch_size = cfg.data.batch_size // layout.data
    torch.manual_seed(args.seed)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = build_model(cfg.arch, device=device, train=True, dtype=dtype, layout=layout)

    is_blended = cfg.data.type == "BlendedLoader"
    ds_cls = BlendedMVSDataset if is_blended else DTUMVSDataset
    msa = cfg.data.multi_scale_args
    dkw = dict(
        nviews=cfg.data.nviews, ndepths=cfg.data.num_depths,
        interval_scale=cfg.data.interval_scale, crop=cfg.data.crop,
        augment=cfg.data.augment, aug_args=vars(cfg.data.aug_args),
        height=cfg.data.height, width=cfg.data.width, multi_scale=cfg.data.multi_scale,
        multi_scale_args={"scales": msa.scales, "resize_range": msa.resize_range,
                          "scale_batch_map": msa.scale_batch_map},
        resize_scale=cfg.data.resize_scale, consist_crop=cfg.data.consist_crop, seed=args.seed)
    train_ds = ds_cls(cfg.data.datapath, cfg.data.train_data_list, "train",
                      batch_size=batch_size, **dkw)
    val_ds = ds_cls(cfg.data.datapath, cfg.data.val_data_list, "val", **dkw)
    shard = dict(host_id=layout.data_index, num_hosts=layout.data)
    train_loader = MVSLoader(train_ds, batch_size, shuffle=cfg.data.shuffle,
                             num_workers=cfg.data.num_workers, seed=args.seed, **shard)
    val_loader = MVSLoader(val_ds, batch_size, shuffle=False, drop_last=False,
                           num_workers=cfg.data.num_workers, **shard)
    val_loader.set_epoch(0)
    if layout.view > 1:
        train_loader = ViewGroupLoader(train_loader, layout)
        val_loader = ViewGroupLoader(val_loader, layout)

    run_dir = os.path.join(cfg.trainer.save_dir, "models", cfg.name)
    logger = None
    if layout.rank == 0:
        os.makedirs(run_dir, exist_ok=True)
        save_config(cfg, os.path.join(run_dir, "config.json"))
        logger = setup_logging(run_dir)
    profile = (args.profile_dir, args.profile_start, args.profile_steps) \
        if args.profile_dir else None
    trainer = Trainer(cfg, train_loader, val_loader, model=model, writer=None, logger=logger,
                      is_blended=is_blended, debug=args.debug, profile=profile, seed=args.seed)
    trainer.init_state()

    start_epoch, skip_batches = 1, 0
    if args.resume:
        info = trainer.resume_auto()
        if info:
            start_epoch, skip_batches = info["start_epoch"], info["skip_batches"]
    elif args.finetune:
        trainer.finetune(args.finetune, name=args.finetune_name,
                         restore_opt=not args.no_restore_opt,
                         reset_schedule=not args.keep_schedule)
    history = trainer.train(start_epoch, skip_batches)
    stop()
    return history


if __name__ == "__main__":
    main()
