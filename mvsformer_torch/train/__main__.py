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

Departures from the JAX CLI:
- `--device` (default `cuda`) replaces `--platform`.
- One device: `--data_parallel`, `--view_parallel` and `--depth_parallel`
  above 1 and `--multi_host` are not ported (ROADMAP A5).
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
               "parallel axes above 1 and --multi_host "
               "are not ported (ROADMAP A5); no TensorBoard writer.")
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
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="above 1: not ported (ROADMAP A5)")
    parser.add_argument("--view_parallel", type=int, default=1,
                        help="above 1: not ported (ROADMAP A5)")
    parser.add_argument("--depth_parallel", type=int, default=1,
                        help="above 1: not ported (ROADMAP A5)")
    parser.add_argument("--multi_host", action="store_true", help="not ported (ROADMAP A5)")
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
    if max(args.data_parallel, args.view_parallel, args.depth_parallel) > 1 or args.multi_host:
        raise NotImplementedError("--data_parallel, --view_parallel and --depth_parallel above "
                                  "1 and --multi_host are not ported yet (ROADMAP A5)")

    import torch

    from mvsformer_torch import resolve_device
    from mvsformer_torch.config import load_config, save_config
    from mvsformer_torch.data.blended import BlendedMVSDataset
    from mvsformer_torch.data.dtu import DTUMVSDataset
    from mvsformer_torch.data.loader import MVSLoader
    from mvsformer_torch.models.mvsformer import build_model
    from mvsformer_torch.train.trainer import Trainer
    from mvsformer_torch.utils.logging import setup_logging

    device = resolve_device(args.device)
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

    torch.manual_seed(args.seed)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = build_model(cfg.arch, device=device, train=True, dtype=dtype)

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
                      batch_size=cfg.data.batch_size, **dkw)
    val_ds = ds_cls(cfg.data.datapath, cfg.data.val_data_list, "val", **dkw)
    train_loader = MVSLoader(train_ds, cfg.data.batch_size, shuffle=cfg.data.shuffle,
                             num_workers=cfg.data.num_workers, seed=args.seed)
    val_loader = MVSLoader(val_ds, cfg.data.batch_size, shuffle=False, drop_last=False,
                           num_workers=cfg.data.num_workers)
    val_loader.set_epoch(0)

    run_dir = os.path.join(cfg.trainer.save_dir, "models", cfg.name)
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
    return trainer.train(start_epoch, skip_batches)


if __name__ == "__main__":
    main()
