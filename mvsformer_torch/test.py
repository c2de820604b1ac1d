"""The two-phase test pipeline's command line: depth maps, then point clouds.

Port of the JAX package's `test.py`, with the same flags and defaults except
where stated below. Phase 1 (`infer.save_depth`) writes per-view depth,
confidence, cameras and the reference image; phase 2 (`fuse.fuse_scan`)
fuses them into one PLY per scan by `pcd`, `dpcd` or `gipuma` filtering.

    python -m mvsformer_torch.test --dataset dtu --testpath /path/dtu_test \\
        --testlist lists/dtu/test.txt --ckpt_dir saved/models/RUN --which_ckpt model_best \\
        --outdir outputs --max_h 1152 --max_w 1536 --ndepths 192 --filter_method pcd

`--dtype bf16`, the default as in the JAX CLI, computes in bf16 with the
JAX package's fp32 islands (`build_model`'s `dtype`); `--dtype fp32`
computes in fp32 throughout.

Several GPUs, one process each, under torchrun: `--data_parallel` ranks
take disjoint shares of the reference views (-1, the default here, absorbs
the processes `--view_parallel` and `--depth_parallel` leave), the
`--view_parallel` ranks of a view group serve the same views with a block
of the source views each (`num_view - 1` must divide; a `batch_size` that
is not a multiple of the data size becomes the data size, as in the JAX
CLI), and the `--depth_parallel` ranks of a depth group regularise a slab
of each stage's depth hypotheses each (`parallel/depth.py`); rank 0 fuses:

    torchrun --nproc_per_node 4 -m mvsformer_torch.test ... --view_parallel 2 \
        --depth_parallel 2 --dist_backend nccl

Departures from the JAX CLI:
- `--device` (default `cuda`) replaces `--platform`; under torchrun `cuda`
  means `cuda:LOCAL_RANK`, and a device with an index puts every rank on
  that card (gloo only).
- `--data_parallel` defaults to -1 (the JAX CLI's 1 idles the devices it
  does not use; a spare process would wait for ever).
- `--dist_backend` (nccl by default on CUDA, gloo on the CPU; nccl needs
  one card per rank) and `--dist_url` (default env://) start the process
  group.
- Weights come from `<ckpt_dir>/<which_ckpt>.pth`, a checkpoint that
  `python -m mvsformer_torch.train` wrote, or from `--torch_ckpt` (a
  reference `.pth`). A JAX run's orbax checkpoint directories are read
  after `python tools/orbax_to_torch.py <run_dir> <out_dir>` has converted
  them where JAX and orbax are installed (the card's machine has neither);
  `--ckpt_dir <out_dir>` then serves them.
- The scans' images must be PNG, PPM or PGM (under their `.jpg` names is
  fine): the port decodes no JPEG (ROADMAP A3), and saves `images/*.jpg`
  as PNG bytes.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="MVSFormer testing on PyTorch and CUDA",
        epilog="Departures from the JAX package's test.py: --device replaces --platform; "
               "weights come from <ckpt_dir>/<which_ckpt>.pth or --torch_ckpt (a JAX run's "
               "orbax directories after python tools/orbax_to_torch.py <run_dir> <out_dir>); "
               "--data_parallel defaults to -1; --dist_backend and --dist_url start the "
               "process group under torchrun; input images must be PNG, "
               "PPM or PGM (no JPEG decoder: ROADMAP A3), and images/*.jpg is written as PNG.")
    parser.add_argument("--dataset", default="dtu", choices=["dtu", "tt"])
    parser.add_argument("--testpath", required=True)
    parser.add_argument("--testlist", default=None,
                        help="scan list file; default = builtin benchmark list")
    parser.add_argument("--ckpt_dir", required=True, help="run dir containing config.json")
    parser.add_argument("--which_ckpt", default="model_best",
                        help="the checkpoint of the training run in ckpt_dir: "
                             "<ckpt_dir>/<which_ckpt>.pth")
    parser.add_argument("--torch_ckpt", default=None,
                        help="a reference MVSFormer checkpoint (.pth), loaded as it is, "
                             "instead of --which_ckpt")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--num_view", type=int, default=5,
                        help="views per reference (T&T benchmarks use 10-20)")
    parser.add_argument("--ndepths", type=int, default=192)
    parser.add_argument("--interval_scale", default="1.06",
                        help="depth interval scale: a float, or per-scene "
                             "'Scene1:1.0,Scene2:1.2' pairs (T&T)")
    parser.add_argument("--use_short_range", action="store_true",
                        help="read T&T short_range_cameras/cams_<scan>")
    parser.add_argument("--max_h", type=int, default=1152)
    parser.add_argument("--max_w", type=int, default=1536)
    parser.add_argument("--tmps", default="5.0,5.0,5.0,1.0")
    parser.add_argument("--filter_method", default="pcd", choices=["pcd", "dpcd", "gipuma"])
    parser.add_argument("--prob_threshold", default="0.5")
    parser.add_argument("--thres_view", type=int, default=5)
    parser.add_argument("--thres_disp", type=float, default=1.0)
    parser.add_argument("--dist_base", type=float, default=4.0)
    parser.add_argument("--rel_diff_base", type=float, default=1300.0)
    parser.add_argument("--disp_threshold", type=float, default=0.1,
                        help="gipuma disparity threshold")
    parser.add_argument("--num_consistent", type=int, default=2,
                        help="gipuma consistent-view count")
    parser.add_argument("--fusion_src_views", type=int, default=10)
    parser.add_argument("--combine_conf", action=argparse.BooleanOptionalAction, default=True,
                        help="save the stage-averaged confidence map; --no-combine_conf "
                             "saves the stacked per-stage maps instead, which fusion reads "
                             "with per-stage prob thresholds")
    parser.add_argument("--skip_depth", action="store_true",
                        help="fusion only (phase-1 outputs already exist)")
    parser.add_argument("--skip_fusion", action="store_true")
    parser.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"],
                        help="compute dtype: bf16 (the default) keeps the JAX package's "
                             "fp32 islands; fp32 computes in fp32 throughout")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' runs the plain PyTorch path)")
    parser.add_argument("--batch_size", type=int, default=1,
                        help="reference views per inference batch")
    parser.add_argument("--data_parallel", type=int, default=-1,
                        help="data ranks, each serving a share of the reference views (-1 = "
                             "the processes left over after the view split)")
    parser.add_argument("--view_parallel", type=int, default=1,
                        help="view ranks per request; must divide num_view - 1")
    parser.add_argument("--depth_parallel", type=int, default=1,
                        help="depth ranks per request, each regularising a slab of every "
                             "stage's depth hypotheses")
    parser.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                        help="process group backend (default nccl on CUDA, gloo on the CPU); "
                             "nccl needs one card per rank")
    parser.add_argument("--dist_url", default="env://",
                        help="process group rendezvous (default env://: torchrun's "
                             "MASTER_ADDR and MASTER_PORT)")
    parser.add_argument("--eval_view_chunk", type=int, default=0,
                        help="above 0: the backbone runs over chunks of this many views")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from mvsformer_torch.config import load_config
    from mvsformer_torch.data import scan_lists
    from mvsformer_torch.fuse import fuse_scan
    from mvsformer_torch.infer import save_depth
    from mvsformer_torch.models.mvsformer import build_model
    from mvsformer_torch.parallel.mesh import start, stop
    from mvsformer_torch.train.checkpoint import ORBAX_HINT
    from mvsformer_torch.utils.convert_weights import load_reference_checkpoint

    device, layout = start(args)
    if (args.num_view - 1) % layout.view:
        raise SystemExit(f"--num_view {args.num_view} needs num_view-1 divisible by "
                         f"--view_parallel {layout.view}")
    if args.batch_size % layout.data:
        print(f"--batch_size {args.batch_size} is not a multiple of the {layout.data} data "
              f"ranks: serving batches of {layout.data}")
        args.batch_size = layout.data
    if args.testlist:
        with open(args.testlist) as f:
            testlist = [line.strip() for line in f if line.strip()]
    elif args.dataset == "dtu":
        testlist = scan_lists.DTU_TEST
    else:
        testlist = scan_lists.TT_INTERMEDIATE

    os.makedirs(args.outdir, exist_ok=True)

    if not args.skip_depth:
        cfg = load_config(os.path.join(args.ckpt_dir, "config.json"))
        if args.eval_view_chunk:
            cfg.arch.eval_view_chunk = args.eval_view_chunk
        dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
        model = build_model(cfg.arch, device=device, dtype=dtype, layout=layout)
        ckpt = args.torch_ckpt or os.path.join(args.ckpt_dir, args.which_ckpt + ".pth")
        if not os.path.isfile(ckpt):
            if os.path.isdir(os.path.join(args.ckpt_dir, args.which_ckpt)):
                raise ValueError(ORBAX_HINT.format(
                    what=f"{args.which_ckpt} in {args.ckpt_dir}", run_dir=args.ckpt_dir))
            raise FileNotFoundError(f"no checkpoint {ckpt}")
        load_reference_checkpoint(ckpt, model)
        tmps = [float(t) for t in args.tmps.split(",")]
        if ":" in args.interval_scale:
            interval_scale = {k: float(v) for k, v in
                              (pair.split(":") for pair in args.interval_scale.split(","))}
        else:
            interval_scale = float(args.interval_scale)
        save_depth(model, testlist, args.testpath, args.outdir, num_view=args.num_view,
                   ndepths=args.ndepths, interval_scale=interval_scale, max_h=args.max_h,
                   max_w=args.max_w, tmps=tmps, dataset=args.dataset,
                   batch_size=args.batch_size // layout.data, combine_conf=args.combine_conf,
                   use_short_range=args.use_short_range, device=device)

    if not args.skip_fusion and layout.rank == 0:
        prob_threshold = [float(p) for p in args.prob_threshold.split(",")]
        for scan in testlist:
            kwargs = {"pcd": dict(thres_view=args.thres_view, dist_thresh=args.thres_disp),
                      "dpcd": dict(dist_base=args.dist_base, rel_diff_base=args.rel_diff_base),
                      "gipuma": dict(disp_thresh=args.disp_threshold,
                                     num_consistent=args.num_consistent)}[args.filter_method]
            fuse_scan(os.path.join(args.testpath, scan), os.path.join(args.outdir, scan),
                      os.path.join(args.outdir, f"{scan}.ply"), method=args.filter_method,
                      prob_threshold=prob_threshold, n_src_views=args.fusion_src_views,
                      device=device, **kwargs)
    stop()


if __name__ == "__main__":
    main()
