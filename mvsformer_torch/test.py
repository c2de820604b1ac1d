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

Departures from the JAX CLI:
- `--device` (default `cuda`) replaces `--platform`.
- Weights come from `<ckpt_dir>/<which_ckpt>.pth`, a checkpoint that
  `python -m mvsformer_torch.train` wrote, or from `--torch_ckpt` (a
  reference `.pth`); the JAX package's orbax checkpoint directories are not
  read (ROADMAP A4).
- `--data_parallel`, `--view_parallel` and `--depth_parallel` above 1 are
  not ported (ROADMAP A5).
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
               "weights come from "
               "<ckpt_dir>/<which_ckpt>.pth or --torch_ckpt (orbax restore: ROADMAP A4); "
               "--data_parallel, "
               "--view_parallel and --depth_parallel above 1 (ROADMAP A5) are not ported; "
               "input images must be PNG, "
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
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="above 1: not ported (ROADMAP A5)")
    parser.add_argument("--view_parallel", type=int, default=1,
                        help="above 1: not ported (ROADMAP A5)")
    parser.add_argument("--depth_parallel", type=int, default=1,
                        help="above 1: not ported (ROADMAP A5)")
    parser.add_argument("--eval_view_chunk", type=int, default=0,
                        help="above 0: the backbone runs over chunks of this many views")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.data_parallel * args.view_parallel * args.depth_parallel > 1:
        raise NotImplementedError("--data_parallel, --view_parallel and --depth_parallel "
                                  "above 1 are not ported yet (ROADMAP A5)")

    import torch

    from mvsformer_torch import resolve_device
    from mvsformer_torch.config import load_config
    from mvsformer_torch.data import scan_lists
    from mvsformer_torch.fuse import fuse_scan
    from mvsformer_torch.infer import save_depth
    from mvsformer_torch.models.mvsformer import build_model
    from mvsformer_torch.utils.convert_weights import load_reference_checkpoint

    device = resolve_device(args.device)
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
        model = build_model(cfg.arch, device=device, dtype=dtype)
        ckpt = args.torch_ckpt or os.path.join(args.ckpt_dir, args.which_ckpt + ".pth")
        if not os.path.isfile(ckpt):
            if os.path.isdir(os.path.join(args.ckpt_dir, args.which_ckpt)):
                raise NotImplementedError(
                    f"{args.which_ckpt} in {args.ckpt_dir} is a JAX orbax checkpoint directory, "
                    "which the port does not read (ROADMAP A4); pass a .pth")
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
                   batch_size=args.batch_size, combine_conf=args.combine_conf,
                   use_short_range=args.use_short_range, device=device)

    if not args.skip_fusion:
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


if __name__ == "__main__":
    main()
