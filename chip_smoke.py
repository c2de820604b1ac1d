#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. Print the card's name and power limit (nvidia-smi).
2. Build every CUDA kernel from `mvsformer_torch/csrc/` (one nvcc per
   source, all at once) and print the build time, each kernel's ptxas
   registers and spills, K5's resident blocks per SM at each level (its
   design needs two), K2's (its design needs three) and K1's and K7's at
   each DTU stage (their design needs four), K8's at each stage of the
   training step (three or more), K4's (its design needs two) and K6's
   (its design needs four).
3. Build TwinMVSNet on `cuda` in fp32 at the default ModelConfig (the full
   width of alt_gvt_small, ndepths 32/16/8/4, inverse depth, cnn fusion, ce
   decode), with weights and non-trivial BN running stats drawn from a
   seeded torch.Generator. The FPN encoder head is K4 and each top-down
   FPN level K5 (the JAX package's default flags), and each global
   sub-sampled attention of the backbone is K6. Its forward runs with TF32
   off (checked in 4), so the request that is timed is the one phase 7
   checks.
4. Serve a synthetic DTU-eval request (B=1, 5 views, 1152x1536, 192 depths;
   the cameras of `__graft_entry__._synthetic_batch`) through
   `make_infer_fn`: one warm-up request, then 3 timed requests, each with
   every launch count set to 0 just before it and read just after it (and
   the peak memory counted over the three alone). Per request, K1-K3 must
   launch once per stage (4), K4 once, K5 once per FPN level (3) and K6
   once per global sub-sampled attention block of the backbone (9). One
   more request records the tensors the forward feeds each kernel.
5. Check the outputs: finite, depth within [depth_min, depth_max] and every
   stage's depth within its hypotheses, confidence in (0, 1].
   A further request is timed layer by layer (CUDA events on forward hooks)
   and one under torch.profiler for the device's idle share.
6. With TF32 off, hold every kernel against its plain PyTorch version on
   the card, on the tensors the forward fed it at every call of the
   recorded request (K1-K3 at each of the 4 stages, and K1 twice more: at
   stage 4 with V=1, the one-view form, and at stage 1 with B=2, the
   recorded sample beside a second one with its own depths and cameras;
   K4 once; K5 at each FPN level; K6 at each GSA block), and time both; for
   K6 also time scaled_dot_product_attention on the same inputs as the
   library yardstick. Print K1's time per stage. Each of K1-K6 must also
   give the same bits in 5 runs on each of those inputs.
7. Run the __graft_entry__ request (B=1, 3 views, 128x128, 192 depths) on
   the card and, with the same weights, on the CPU (the plain versions),
   TF32 off, and compare depth and confidences.
8. Train TwinMVSNet at the JAX package's training shape: the default
   Config (drop path 0.2 from a seeded CUDA generator, AdamW with the twin
   LR split and warmup-cosine), B=8 as 2 micro-batches of 4
   (`scale_batch_map["512"]`), 5 views, 512x640, 192 depths, the cameras
   above and a depth_gt/mask per stage as `_synthetic_batch(with_gt=True)`
   builds them, random weights from a seeded torch.Generator. One warm-up
   step, then 3 timed steps through `train.step.TrainStep`, each with the
   launch counts set to 0 just before it and read just after it: K7
   `warp_corr_fwd` and K8 `warp_corr_bwd` launch 4 times per micro-batch
   (8 per step), K1-K6 never. Loss and every gradient must be finite and
   every trainable tensor's gradient non-zero, but those zero in exact
   arithmetic (the cost regularisers' probability biases, ahead of the
   softmax over depth, and conv biases ahead of a BN), whose rounding
   noise can sum to exactly zero, here and in phases 13-15. One more step is timed
   layer by layer, forward and backward, under torch.profiler (the
   device's idle share and top kernels), and one records the tensors it
   feeds K7 and K8.
9. With TF32 off, hold K7 and K8 against their plain versions on the card
   at each of those 8 + 8 launches, and time both; hold K8 once more at
   stage 1 with every source camera zoomed 3 times, where neighbouring
   pixels' taps lie 3 source pixels apart and a pixel's tap square moves at
   almost every depth, so its sums over depths hardly merge. Print K7's and
   K8's time per stage.
10. Run one fp32 training step (the __graft_entry__ request's cameras,
   B=2 as 2 micro-batches, 3 views, 128x128, 192 depths, drop path 0, no
   warmup) on the card and, with the same weights and batch, on the CPU,
   and compare the losses, the gradients, the BN running statistics and
   the updated parameters.
11. The DTU test pipeline (`python -m mvsformer_torch.test`'s two phases).
   Write a synthetic DTU-layout scan with the port's writers: 6 views of a
   tilted plane, each with the other 5 as sources, 1600x1200 PNG images
   under images/*.jpg (so the dataset resizes them), DTU cam files and
   Depths_raw ground truth; time the decode of one image, and of copies
   whose rows take libpng's adaptive filters or Paeth (the decoder's
   wavefront path), and the unfiltering of Up rows by both paths. Run `save_depth`
   on the card at the default ModelConfig (1152x1536, 192 depths, 5 views,
   random weights from seed 0): 6 requests, each timed as load, forward and
   writes, with every launch count set to 0 just before and read just
   after (K1-K6: 6 x their per-request counts), then once more under
   torch.profiler for the device's idle share. Hold view 0's saved depth
   and confidence to `make_infer_fn` on the same sample, and two runs of
   `make_infer_fn` to each other, within the card-to-CPU tolerance; name
   the first op whose output varies between two forwards; then, with
   `cudnn.deterministic`, run save_depth again and require view 0 and two
   runs of `make_infer_fn` to agree bit for bit. Run save_depth at a small
   shape on the card and on the CPU with the same weights and compare
   every artifact (depth_metric.txt within 1e-4). Fuse the plane's exact depth maps by pcd, dpcd
   and gipuma on the card (kept share of the interior, distance from the
   plane; fusion ms per view) and views 0 and 3 on the CPU as well (mask
   agreement, points), then
   the random weights' depth maps into a PLY as a smoke run. 11h, JPEG:
   build the host decoder (`mvsformer_torch/csrc/host/jpeg_decode.cpp`,
   the host C++ compiler; its seconds printed) and decode every committed
   stream of tests/fixtures/jpeg/ in colour and in grey, each bit-equal to
   its committed cv2 decode (sha256, and PNGs for the small ones); print
   the median ms of 5 reads of the 1600x1200 stream (view 0 of this scan,
   4:2:0, quality 90) beside 11a's PNG decode of the same pixels, and
   decode it from 4 threads at once, each the serial result.
12. The training run as a user runs it: `python -m mvsformer_torch.train
   --config configs/config_mvsformer.json` (as it ships: the default
   ModelConfig, batch 8, 5 views, 192 depths, the 25 crop sizes and the
   scale-batch map, augmentation, 4 loader threads; only the data paths,
   1 epoch, a model_step every 2 steps and a log line every step are
   set; the CLI's default dtype, bf16) on a synthetic DTU training tree
   written by the port's writers: one scan of 5 views x 7 lights of the
   tilted plane, 1600x1200 PNG whose rows take libpng's adaptive filters,
   cam files and Depths_raw, 3 of the views listed as references. 2 steps
   at the 2 largest crop sizes (1024x1280 first, 8 micro-batches of 1), a
   `--profile_dir` window of step 2, validation over the 21 samples (3
   batches, B=8 and B=5, 512x640). Then `--resume` with 2 epochs (2 more
   steps; the resumed epoch does not validate, epoch 1's validation runs
   the same code), and beside it `python -m mvsformer_torch.test
   --which_ckpt model_best` (bf16, its default) on the committed
   DTU-layout JPEG scan (tests/fixtures/jpeg/scan: 6 views of the plane at
   400x300, 4:2:0, quality 90, encoded by cv2; its cams, pair and
   Depths_raw from `write_dtu_scan` at that size and seed).
   Each step must show a finite loss, the barrels' crop size, K7/K8 4
   launches a micro-batch and K1-K6 none; the validation K1-K6 at their
   per-request counts a batch;
   model_best, model_last, model_step and their sidecars must be written;
   the resume must start at epoch 2, global step 2, at LR schedule(2);
   model_last restored in this process must equal the file bit for bit;
   the eval dataset's samples of the JPEG scan must equal those of its PNG
   twin (the committed cv2 decodes, written as PNG) bit for bit, the test
   CLI must launch K1-K6 at 6 x their per-request counts, and its view 0
   must match `make_infer_fn` of the restored model in bf16 within the
   card-to-CPU bounds. Prints per step its ms, crop, micro-
   batches and loader wait; load ms per sample, validation ms per batch,
   checkpoint ms and bytes, peak memory, the profile window's idle share.
   Then K1-K6 are held against their plain versions on one validation batch
   (B=8, 512x640) and K7/K8 on one training micro-batch at 1024x1280; and
   at every other of the 25 crop sizes from the largest (13) one training
   micro-batch and one eval forward of 1 sample run, all outputs finite. Each kernel's entry of the
   kernels line adds these checks and the CLI runs' launches.
13. DINOMVSNet (MVSFormer-P) as `configs/config_mvsformer-p.json` ships
   it: vit_small at full width (384 wide, 12 blocks, 6 heads, patch 16) on
   the 0.5x images, the CLS-attention ViT decoder, the same FPN and
   cascade, `fix`; weights, CLS token, position embedding and BN stats
   from a seeded generator. Serve the DTU request through `make_infer_fn`
   (one warm-up, 3 timed requests, counts set to 0 before each): K1-K3 4
   launches, K4 1, K5 3 and K6 none (the ViT has no GSA); print the
   request ms, peak memory, ms per layer and the idle share; check the
   outputs as phase 5 does; hold K1-K5 to their plain versions at every
   launch of one request (the same bits in 5 runs); run the __graft_entry__
   request on the card and on the CPU (phase 7's bounds); run `python -m
   mvsformer_torch.test --dtype fp32 --dataset tt` with the -p config on
   phase 12's JPEG scan in the Tanks-and-Temples layout (its images padded
   by 4 rows, cy shifted) from a DINOMVSNet checkpoint in the reference's
   layout: K1-K5 at 6 x their per-request counts, view 0 against
   `make_infer_fn` on `MVSEvalDataset(dataset="tt")` within the
   card-to-CPU bounds. Then train at phase 8's
   shape with the -p config (B=8 as 2 micro-batches of 4, 5 views, 512x640,
   192 depths, fix): one warm-up and 3 timed steps, K7/K8 4 launches a
   micro-batch and K1-K6 none, the loss and every trainable gradient finite
   and non-zero, no ViT tensor with a gradient and every one bit-equal
   after the steps; one fp32 step on the card against the CPU at phase 10's
   shape (phase 10's bounds; the frozen tensors unmoved on both). Each
   kernel's entry of the kernels line adds this phase's checks and one
   request's and one step's launches.
14. The cascade's variants (the default ModelConfig with these fields
   set; seeded weights): serve the DTU request (one warm-up, one timed
   request, counts set to 0 before it) with cnn / re / GN (K1 4 launches,
   K6 9, no K2-K5: GN runs the encoder head, the FPN levels and the
   visibility CNN as their modules), epipole / was / BN (K1 4, K3 4, K4 1,
   K5 3, K6 9, no K2: the epipole fusions have no visibility CNN) and
   epipoleV2 / mixup_ce / BN (as epipole, without K3: mixup_ce decodes in
   torch); print each request's ms, peak memory and ms per layer, and
   check the outputs as phase 5 does; hold K1 and K3 to their plain
   versions at every launch of one epipole request (phase 6's tolerances);
   serve the epipole model again with `eval_view_chunk=2` (the backbone
   over 2 + 2 + 1 views: K4 3, K5 9, K6 27), hold K4, K5 and K6 to their
   plain versions at every launch of one chunked request (phase 6's
   tolerances; these are their only batches of 2 and 1 full-size views),
   and hold it to the whole request within the card-to-CPU bounds,
   printing both peaks. Train one
   warm-up and one timed step at phase 8's shape for re + GN +
   `mask_out_range`, was (the Sinkhorn loss) and mixup_ce: K7/K8 4
   launches a micro-batch, K1-K6 none, the loss and every trainable
   gradient finite and non-zero. Then one fp32 step of cnn / re / GN on
   the card against the CPU at phase 10's shape (phase 10's bounds).
15. The bf16 mode (`build_model(..., dtype=torch.bfloat16)`, the JAX
   package's and both CLIs' default; K2, K4, K5 and K6 as fp32 islands).
   TwinMVSNet at the default ModelConfig with phase 4's weights: the DTU
   request (one warm-up, 3 timed requests, counts set to 0 before each:
   K1-K3 4, K4 1, K5 3, K6 9), its ms, peak memory, ms per layer and idle
   share, its gap to the fp32 request on the same weights, the outputs
   checked as phase 5 does; every kernel held to its plain version at
   every launch of one bf16 request (the islands on their bf16 inputs cast
   up, before the output cast; phase 6's tolerances; the same bits in 5
   runs), K1 and K3 fed fp32 and the islands bf16, and each island's casts
   up and down timed by CUDA events beside the bound of a bf16 body; the
   __graft_entry__ request's bf16 forward on the card against the CPU's
   within twice the CPU's own bf16-vs-fp32 gap in the mean (4 times at the
   maximum) plus phase 7's bounds. DINOMVSNet (-p) in bf16: the DTU request (one
   warm-up, 3 timed, launches as phase 13's), its outputs as phase 5. The
   bf16 training step at phase 8's shape: one warm-up and 3 timed steps,
   K7/K8 4 launches a micro-batch and K1-K6 none, the loss finite, every
   gradient finite and fp32 and non-zero but those zero in exact
   arithmetic (the probability biases, conv biases ahead of a BN) and the
   visibility CNNs' noise (`vis_noise_only`: a stage's whole CNN where its
   views' bf16 entropy maps agree at every pixel, its last bias where they
   agree at more than 0.9; the shares printed), the parameters, buffers
   and AdamW moments fp32, the peak memory; one bf16 step on the card
   against the CPU at phase 10's shape, all three steps (card bf16, CPU
   bf16, CPU fp32) on the CPU bf16 step's hypotheses: each layer group's
   gradient by `grad_group_check` (relative L2, cosine and norm ratio
   within twice the CPU's bf16-vs-fp32 gap, the L2 under 0.9, the gap
   under 0.8), which must reject zero, random, negated, halved and 1.5 x
   card gradients in every group; the running stats' mean within twice
   the gap, their max and the RMS of the five losses within 4 times. Each
   kernel's entry of the
   kernels line adds this phase's checks and a request's, a DINO request's
   and a step's launches.
16. The process grid (data, view and depth parallelism,
   `mvsformer_torch/parallel/`): two ranks on this one card over gloo
   (NCCL puts one rank on a card), each a process that `python -m
   torch.distributed.run` starts, with a time limit on every launch; the
   kernels are built (phase 2) before any rank starts. One launch runs
   16a-16c and 16e, each rank writing its results to
   a file that this process compares. 16a: phase 4's request at view 2
   (each rank the reference and 2 of the 4 sources; the view sums
   all-reduced), each rank's depth and confidence within phase 7's bounds
   of phase 4's serial request and of the other rank's (cuDNN's transposed
   3D convs are not deterministic, so not bit for bit); each rank's
   launches (K1-K6 at phase 4's counts) and K1's launch shapes printed,
   K1-K6 held to their plain versions at rank 0's launches (3 images, 2
   sources), the other rank waiting at a barrier so that the checks' times
   are the card's alone. 16b: phase 8's
   step (8 x 5 x 512x640, drop path 0) at data 2 with SyncBN, each rank 4
   samples as 2 micro-batches of 2 (its share of each micro-batch of 4),
   and 16c: the step at view 2 under GN (BN's FPN statistics over a view
   rank's own views would be another function), each rank all 8 samples at
   1 + 2 views; each rank's averaged gradients against the serial step's
   on the same weights and batch (for 16b with the data-parallel loss, each
   shard's masked mean averaged), per layer group by `grad_group_check` at
   a stated bound with its five mutants rejected, the loss and the running
   statistics at phase 10's bounds; K7/K8 4 launches a micro-batch a rank,
   held to their plain versions at rank 0's launches in 16c (the other
   rank at a barrier); each rank's step ms and peak memory. 16e: phase 4's
   request at depth 2 (every rank the whole volume, each regularising its
   half of every stage's depth hypotheses, the halos and the logits moved
   by all_gather), each rank's depth and confidence within phase 7's
   bounds of phase 4's serial request and of the other rank's, its
   launches K1-K6 at phase 4's counts, and K1-K6 held to their plain
   versions at every launch of each rank in turn (the other at a
   barrier). 16d, four torchrun launches at once beside the serial CLI in
   this process:
   `python -m mvsformer_torch.train` at data 2 in the CLI's default bf16
   (gloo, both ranks on this card) for two steps on a 3-view training
   tree, whose run directory holds one set of files written by rank 0 and
   each step recorded once; `python -m mvsformer_torch.test` at view 2 on
   phase 11's plane scan against the serial CLI in this process (the same
   files, depth and confidence within phase 7's bounds), and the same at
   `--depth_parallel 2`; the train CLI at world 1 on NCCL for one step.
   Each kernel's entry of the kernels line adds the ranks' launches and
   checks.
17. The rest of the model variants (ROADMAP A6), seeded by `random_init_`:
   serve the DTU request (one warm-up, one timed request, counts set to 0
   before it) with TwinMVSNet under `multi_scale` (TwinDecoderStage4V2,
   FPNDecoderV2: K1-K3 4, K4 1, K5 none, K6 9), DINOMVSNet (the -p
   config's arch) under `multi_scale` (VITDecoderStage4: K1-K3 4, K4 1, no
   K5 or K6) and with `att_fusion: false` (VITDecoderStage4NoAtt: K1-K3 4,
   K4 1, K5 3); print each request's ms and peak memory (the Twins one's
   ms per layer), check the outputs as phase 14 does, and hold each
   config's forward on the card against the CPU at phase 7's request and
   bounds; hold K1-K4 and K6 to their plain versions at every launch of
   the Twins request (phase 6's tolerances, the same bits in 5 runs); run
   the Twins model with `want_similarity` at phase 7's request on the card
   and on the CPU (each stage's sim_depth: the CPU's pick the card's at
   0.8 of the pixels or more, elsewhere the CPU's cosine sum at the
   card's pick within 1e-5 of its maximum). Train the Twins multi-scale
   model at phase 8's shape (drop path 0.2) with `remat_backbone` off and
   on, the same weights and generator seed: each one compared and two
   timed steps (K7/K8 4 launches a micro-batch, K1-K6 none), the step ms
   and peak memory of each, the compared steps run with `cudnn.deterministic`
   and their gradients held per layer group by `grad_group_check` within
   1e-4 (its mutants rejected). Run
   `DINOViT(cross_att=True, nview=5)` with non-zero gates and epipoles on
   the card against the CPU at 5x3x128x192 (1e-4 of scale), and time it at
   the DTU request's ViT input (5x3x576x768) with and without its cross
   blocks. Each kernel's entry of the kernels line adds this phase's
   checks and launches.
18. The training options no shipped config sets (ROADMAP A4): 18a, one
   fp32 step at phase 8's shape with `focal` (gamma 2) and a `grad_norm`
   clip that binds (the global norm printed before and after it), its
   launches counted (K7/K8 8) and K7/K8 held to their plain versions at
   every launch; 18b, the same options at phase 10's shape on the card
   against the CPU at phase 10's bounds; 18c, DINOMVSNet (the -p config's
   arch with `fix` off) at phase 10's shape with `layer_decay`: card
   against CPU at phase 10's bounds (18b and 18c's card steps under
   deterministic cuDNN), every group's LR the same on both
   and block i's vit_lr x layer_decay^(12 - i), and block 0's qkv update
   on the card the CPU's and its LR's size. Each kernel's entry of the
   kernels line adds this phase's checks and launches.
19. The four accuracy gates of the JAX package (tests/test_geometric_e2e.py,
   tests/test_convergence.py) with their scenes, configuration (GN,
   full-width alt_gvt_small, ndepths 8/4/4/2, drop path 0), learning
   rates, steps, evaluation cadence and thresholds, fp32 with TF32 off,
   each loop under deterministic cuDNN, from `random_init_` at seed 0.
   19a, 19b: the analytic-plane gates, a re model trained on every
   reference view of the committed 128x128 JPEG views
   (tests/fixtures/gates/) written in the DTU layout (19a) and the
   Tanks-and-Temples layout with short-range cams (19b); the best
   weights saved by the port's CheckpointManager with the gate's
   config.json and served by `python -m mvsformer_torch.test` (pcd; dpcd
   with `--use_short_range`; 19a also `--dtype bf16`), its
   depth_metric.txt and PLY held to the JAX gates' thresholds and its view
   0 to the best weights' request in this process. 19c: the convergence
   gates on the committed scenes (ce). Every training step's and eval's
   launches counted (K7/K8 4 a step; K1 4, K6 9 an eval, K3 4 under ce;
   the CLI's from its launch line), and each kernel held to its plain
   version at the first step, the first eval and one request of the
   CLI's shape. Each kernel's entry of the kernels line adds this phase's
   checks and launches.
20. Print the wall seconds of each phase, one JSON line of per-kernel
   numbers, then, last, the result line
   {"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json,
   the CLI runs' output to chiprun_out/training_run_*.log,
   chiprun_out/dino_test.log, chiprun_out/parallel_*.log and
   chiprun_out/gate_*.log.

Bounds: the larger of bytes moved (each input read once, each output
written once) over 3.35 TB/s and operations over 67 TFLOP/s (fp32 outside
the tensor cores), the published H100 SXM peaks. K2 runs layers 1 and 2
and K5 its 3x3 conv on the tensor cores in 3xTF32 (three TF32 products per
multiply-add, which keeps fp32's accuracy), so their bounds have a third
term: 3 x 2 x those multiply-adds over 494.7 TFLOP/s (dense TF32), with
their other operations over 67 TFLOP/s; their lines name the term that
binds ("bytes", "tensor" or "operations") and the kernel's share of the
bound. K4 runs all three of its convs that way, and K6 both products of
its attention (the softmax's operations stay on the fp32 term). A kernel's
entry in the kernels line sums the bounds of its launches, and names the
tensor term "operations".
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 494.7e12
TF32_PRODUCTS = 3  # 3xTF32: lo*hi + hi*lo + hi*hi per multiply-add
N_REQUESTS = 3
B, V, H, W, NDEPTH_FULL = 1, 5, 1152, 1536, 192
DEPTH_MIN, DEPTH_MAX = 425.0, 900.0

# Tolerances for kernel vs plain version (both fp32 on the card, TF32 off).
# K1: the two compute the same products in another order (FMA contraction,
#     per-group sums); pixel coordinates ~1e3 differ in their last bit, and
#     bilinear sampling with zero padding is continuous in them, so the
#     error is a few ulps of the correlation's scale.
K1_RTOL_OF_SCALE = 1e-4   # |corr error| <= 1e-4 * max|corr|
K1_ENT_ATOL = 1e-3        # entropy in nats, <= log(32) ~ 3.47
# K2: ~3.6k multiply-adds per pixel summed in another order than cuDNN's,
#     layers 1-2 in 3xTF32 (fp32's accuracy; one TF32 product would read
#     ~1.7e-4, tests/test_torch_vis_tf32.py).
K2_ATOL = 1e-5            # weights lie in (0, 1)
# K3: exp(tmp*(l-m)) against softmax(tmp*l): weights differ by ~1e-6
#     relative; the depth is a weighted mean of depths ~500 apart.
K3_DEPTH_ATOL, K3_DEPTH_RTOL = 1e-3, 1e-5
K3_CONF_ATOL, K3_CONF_RTOL = 1e-6, 1e-5
# K4, K5: fp32 convolutions against cuDNN's, which may pick a Winograd or
#     FFT algorithm with a larger fp32 error than direct sums. K4 sums
#     147-200 products per output through three layers; K5 64 x 9 + cl,
#     after an interpolation whose align-corners weights are computed as
#     PyTorch computes them (a wrong weight shows at 1e-2 of the scale).
K4_RTOL_OF_SCALE = 1e-4   # per output (conv01, down0), of max(1, its max |value|)
K5_RTOL_OF_SCALE = 1e-4   # per output (out, intra'), of max(1, its max |value|)
# K6: fp32 logits and probabilities on both sides, both products in
#     3xTF32 (fp32's accuracy: tests/test_torch_gsa_tf32.py); the kernel's
#     online softmax rescales its sums per 64-key tile, the plain version
#     divides once.
K6_RTOL_OF_SCALE = 1e-5   # of max(1, max |output|): a convex mix of v rows
# End to end, the forward on the card (kernels, cuDNN, cuBLAS) against the
# same weights on the CPU (plain versions) at the __graft_entry__ request,
# TF32 off: the bounds tests/test_torch_model.py holds the port to against
# the JAX model (sums in another order, through four stages of decode).
E2E_SHAPE = (1, 3, 128, 128)  # B, V, H, W
E2E_DEPTH_ATOL = 1e-2         # depth units over the 425-900 range
E2E_CONF_ATOL = 1e-4

# Training: the JAX package's training shape (DataConfig: batch_size 8,
# scale_batch_map["512"] 4, nviews 5, 512x640, 192 depths).
TRAIN_B, TRAIN_MICRO, TRAIN_V, TRAIN_H, TRAIN_W = 8, 4, 5, 512, 640
N_STEPS = 3
# K7: K1's kernel body without the entropy; the same bound as K1's corr.
K7_RTOL_OF_SCALE = 1e-4   # of max(1, max |corr|)
# K8: each dsrc entry sums up to 4*D terms and each dref entry V*D, in
#     registers and then by fp32 vector reductions in an order that varies
#     from run to run; the plain version sums the same products through
#     autograd's scatter.
K8_RTOL_OF_SCALE = 1e-5   # per output (dref, dsrc), of its max |value|
# One training step on the card against the CPU, fp32 with TF32 off (the
# kernels take fp32 only). A tiny randomly initialised network amplifies
# fp32 rounding in its gradients: on the CPU the JAX model's move by up to
# 5.3e-2 of a tensor's largest entry when the images move by 1e-6 of their
# value, and by 9.2e-5 in float64 (`python -m tests.test_torch_train_step`
# prints both). So the gradient bounds here are measured ones, not the
# float64 CPU test's: the card read 4.05e-2 of scale and 1.04e-2 in L2 (an
# H100 80GB HBM3 at 700 W).
STEP_SHAPE = (2, 3, 128, 128)  # B (2 micro-batches of 1), V, H, W
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_OF_SCALE = 5e-2      # |card - cpu| <= 5e-4 + this * max|cpu|, per tensor
STEP_GRAD_L2 = 3e-2            # ||card - cpu|| <= this * ||cpu|| where ||cpu|| > 1e-4
STEP_STATS_RTOL, STEP_STATS_ATOL = 1e-4, 1e-5
STEP_UPDATE_OF_LR = 1e-2       # where the gradient's sign is certain


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def synthetic_request(torch, b=B, v_=V, h=H, w=W, device="cuda"):
    """__graft_entry__._synthetic_batch (DTU eval shape by default), as tensors."""
    batch = synthetic_batch(torch, b, v_, h, w, device)
    return batch["imgs"], batch["proj_matrices"], batch["depth_values"]


def synthetic_batch(torch, b, v_, h, w, device="cuda", with_gt=False):
    """__graft_entry__._synthetic_batch as a dict of tensors: imgs,
    proj_matrices, depth_values and, with_gt, depth_gt and mask per stage."""
    import numpy as np

    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((b, v_, h, w, 3)).astype(np.float32)
    K = np.array([[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]], np.float32)
    projs = {}
    for s, scale in zip(range(1, 5), (1 / 8, 1 / 4, 1 / 2, 1.0)):
        cams = np.zeros((b, v_, 2, 4, 4), np.float32)
        for v in range(v_):
            ext = np.eye(4, dtype=np.float32)
            ext[0, 3] = v * 2.0
            cams[:, v, 0] = ext
            cams[:, v, 1, :3, :3] = K * scale
            cams[:, v, 1, 2, 2] = 1.0
            cams[:, v, 1, 3, 3] = 1.0
        projs[f"stage{s}"] = torch.from_numpy(cams).to(device)
    dv = np.broadcast_to(np.linspace(DEPTH_MIN, DEPTH_MAX, NDEPTH_FULL,
                                     dtype=np.float32)[None], (b, NDEPTH_FULL)).copy()
    batch = {"imgs": torch.from_numpy(imgs).to(device), "proj_matrices": projs,
             "depth_values": torch.from_numpy(dv).to(device)}
    if with_gt:
        gt, mask = {}, {}
        for s, scale in zip(range(1, 5), (8, 4, 2, 1)):
            gt[f"stage{s}"] = torch.from_numpy(
                rng.uniform(430, 890, (b, h // scale, w // scale)).astype(np.float32)).to(device)
            mask[f"stage{s}"] = torch.ones((b, h // scale, w // scale), device=device)
        batch["depth_gt"], batch["mask"] = gt, mask
    return batch


def time_ms(torch, fn, reps=10):
    """Mean device time of fn() over `reps` runs after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


REPEAT_RUNS = 5  # runs of an eval kernel on the same inputs, compared bit for bit


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def k1_cost(args, kwargs):
    ref, src, _, _, dv = args[:5]
    b, v, h, w, c = src.shape
    d, g, hw = dv.shape[1], 8, h * w
    nbytes = 4 * (b * hw * c + b * v * hw * c + b * d * hw + b * v * 16 + b * 16
                  + b * v * g * d * hw + b * v * hw)
    # per (view, depth, pixel): ~30 coordinate/weight ops, 4 taps x C FMAs,
    # C FMAs for the products, G means, ~10 for the entropy.
    flops = b * v * d * hw * (30 + 8 * c + 2 * c + g + 10)
    return nbytes, flops


def k1_two_samples(torch, ref, src, src_projs, ref_proj, dv):
    """K1's inputs at B=2: the recorded sample, and beside it a second one
    with its source views in reverse order (other cameras for each view) and
    its depths moved to 1.15 d + 30 (another range)."""
    flip = lambda t: t.flip(1)
    return (torch.cat([ref, ref.flip(2)]).contiguous(),
            torch.cat([src, flip(src)]).contiguous(),
            torch.cat([src_projs, flip(src_projs)]).contiguous(),
            torch.cat([ref_proj, ref_proj]).contiguous(),
            torch.cat([dv, dv * 1.15 + 30.0]).contiguous())


def k2_cost(args, kwargs):
    ent = args[0]
    n, h, w = ent.shape
    nbytes = 4 * (2 * n * h * w + 3689)
    # Outside the tensor cores, per pixel: layer 0's and the head's
    # multiply-adds, BN and ReLU on 40 channels, the bias and the sigmoid.
    # On them: layers 1 and 2, 144 x 16 + 144 x 8 multiply-adds.
    return nbytes, n * h * w * (2 * (9 * 16 + 8) + 3 * 40 + 4), n * h * w * 144 * 24


def k3_cost(args, kwargs):
    logits = args[0]
    b, d, h, w = logits.shape
    return 4 * (2 * b * d * h * w + 2 * b * h * w), b * h * w * d * 10


def k4_cost(args, kwargs):
    n, _, h, w = args[0].shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    nbytes = 4 * (n * 3 * h * w + n * 8 * h * w + n * 16 * ho * wo + 6040)
    # Outside the tensor cores: BN (2) and lrelu (1) per output of the
    # three layers. On them: the three convs' multiply-adds.
    macs = n * h * w * (7 * 7 * 3 * 8 + 5 * 5 * 8 * 8) + n * ho * wo * 5 * 5 * 8 * 16
    return nbytes, 3 * (2 * n * 8 * h * w + n * 16 * ho * wo), macs


def k5_cost(args, kwargs):
    prev, lat, _, _, k3 = args[:5]
    n, _, h, w = prev.shape
    cl, co, hw = lat.shape[1], k3.shape[0], 4 * h * w
    emit = kwargs.get("emit_intra", False)
    nbytes = 4 * (prev.numel() + lat.numel() + n * co * hw + (n * 64 * hw if emit else 0)
                  + 64 * (cl + 1) + co * (576 + 3))
    # Outside the tensor cores, per pixel: the 1x1 multiply-adds, ~10 ops
    # per channel for the align-corners lerp and the bias, ~8 per output for
    # bias, BN and swish. On them: the 3x3 conv's multiply-adds.
    return nbytes, n * hw * (2 * 64 * cl + 64 * 10 + co * 8), n * hw * 576 * co


def k6_cost(args, kwargs):
    q, k, _, nh = args
    b, n, c = q.shape
    nk = k.shape[1]
    # Outside the tensor cores: ~5 ops per logit for the scale and the
    # online softmax. On them: the two products' multiply-adds.
    return (4 * (2 * b * n * c + 2 * b * nk * c), 5 * b * nh * n * nk,
            2 * b * n * nk * c)


def k7_cost(args, kwargs):
    ref, src, _, _, dv = args[:5]
    b, v, h, w, c = src.shape
    d, g, hw = dv.shape[1], 8, h * w
    nbytes = 4 * (b * hw * c + b * v * hw * c + b * d * hw + b * v * 16 + b * 16
                  + b * v * g * d * hw)
    # per (view, depth, pixel): ~30 coordinate/weight ops, 4 taps x C FMAs,
    # C FMAs for the products, G means.
    return nbytes, b * v * d * hw * (30 + 8 * c + 2 * c + g)


def k8_cost(args, kwargs):
    ref, src, _, _, dv, dcorr = args[:6]
    b, v, h, w, c = src.shape
    d, g, hw = dv.shape[1], 8, h * w
    # reads ref, src, dv, dcorr and the cameras; writes dref and dsrc.
    nbytes = 4 * (2 * b * hw * c + 2 * b * v * hw * c + b * d * hw + dcorr.numel()
                  + b * v * 16 + b * 16)
    # per (view, depth, pixel): ~30 coordinate/weight ops, the warped vector
    # again (4 taps x C FMAs), C FMAs into dref, the C products ref * dcex
    # once, then per tap and channel a product and an add into dsrc.
    return nbytes, b * v * d * hw * (30 + 8 * c + 2 * c + c + 8 * c + g)


def k8_zoomed(torch, args):
    """K8's inputs with every source camera zoomed 3 times about the image
    centre: neighbouring pixels' taps lie 3 source pixels apart, and only
    the middle third of the reference view lands in the source."""
    ref, src, src_projs, *rest = args
    h, w = src.shape[2:4]
    zoom = torch.eye(4, dtype=src_projs.dtype, device=src_projs.device)
    zoom[0, 0] = zoom[1, 1] = 3.0
    zoom[0, 2], zoom[1, 2] = -float(w - 1), -float(h - 1)
    return (ref, src, (zoom @ src_projs).contiguous(), *rest)


def bound_ms(nbytes, flops, tensor_macs=0):
    """(least ms, the term that binds): bytes over the memory rate, fp32
    operations over the CUDA cores' rate and, for a kernel on the tensor
    cores (K2, K4, K5, K6), its 3xTF32 products over the dense TF32 rate."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": flops / FP32_FLOPS_PER_S,
             "tensor": TF32_PRODUCTS * 2 * tensor_macs / TF32_FLOPS_PER_S}
    by = max(times, key=times.get)  # ties go to bytes, then operations
    return times[by] * 1e3, by


def layer_breakdown(torch, model, fn, request):
    """Device time per layer in one request, from CUDA events recorded by
    forward hooks around the model's top-level layers and each stage's
    visibility CNN (K2) and cost regulariser; a stage's remainder is K1, the
    weighted view sum, the view weights outside cnn fusion and the decode."""
    nst = len(model.fusions)
    modules = dict(model.named_modules())
    names = ["encoder", "vit", "decoder_vit", "decoder"]
    for i in range(nst):
        names += [n for n in (f"fusions.{i}", f"fusions.{i}.vis", f"fusions.{i}.cost_reg")
                  if n in modules]
    spans, hooks = {}, []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    for name in names:
        def pre(mod, args, name=name):
            spans.setdefault(name, []).append([event(), None])

        def post(mod, args, out, name=name):
            spans[name][-1][1] = event()
        hooks += [modules[name].register_forward_pre_hook(pre),
                  modules[name].register_forward_hook(post)]
    try:
        torch.cuda.synchronize()
        start = event()
        fn(*request)
        end = event()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    ms = {n: sum(a.elapsed_time(b) for a, b in spans[n]) for n in names}
    out = {n: ms[n] for n in ("encoder", "vit", "decoder_vit", "decoder")}
    for i in range(nst):
        vis = ms.get(f"fusions.{i}.vis", 0.0)
        if f"fusions.{i}.vis" in ms:  # cnn fusion only; K2 under BN, its modules otherwise
            out[f"stage{i + 1}.vis" + ("(K2)" if model.fusions[i].vis.kernel else "")] = vis
        out[f"stage{i + 1}.cost_reg"] = ms[f"fusions.{i}.cost_reg"]
        out[f"stage{i + 1}.warp+sum+decode"] = (ms[f"fusions.{i}"] - vis
                                                - ms[f"fusions.{i}.cost_reg"])
    total = start.elapsed_time(end)
    out["other (resizes, hypotheses, confidence)"] = total - sum(
        ms[n] for n in ("encoder", "vit", "decoder_vit", "decoder")) - sum(
        ms[f"fusions.{i}"] for i in range(nst))
    out["total"] = total
    return out


def device_busy(torch, fn, request):
    """(device kernel ms, wall ms, top kernels) of one request under
    torch.profiler; kernel ms is None when the profiler saw no device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*request)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top = kernel_times(torch, prof)
    return busy_ms, wall_ms, top


def kernel_times(torch, prof):
    """(device kernel ms, the 12 kernels that took longest) of a profile;
    (None, []) when the profiler saw no device events."""
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    if not by_name:
        return None, []
    return sum(by_name.values()), sorted(by_name.items(), key=lambda kv: -kv[1])[:12]


def small_request_errors(torch, model, make_infer_fn):
    """Max |card - CPU| of refined depth, combined confidence and each stage's
    confidence for one E2E_SHAPE request through make_infer_fn."""
    import copy

    cpu_model = copy.deepcopy(model).cpu()
    got = make_infer_fn(model)(*synthetic_request(torch, *E2E_SHAPE))
    want = make_infer_fn(cpu_model)(*synthetic_request(torch, *E2E_SHAPE, device="cpu"))
    errs = {"refined_depth": max_err(got[0].cpu(), want[0]),
            "photometric_confidence": max_err(got[1].cpu(), want[1])}
    for i, (g, w) in enumerate(zip(got[2], want[2])):
        errs[f"stage{i + 1}_confidence"] = max_err(g.cpu(), w)
    if not all(torch.isfinite(t).all() for t in (got[0], got[1])):
        raise RuntimeError("small request: non-finite output on the card")
    return errs


def check_confidence(torch, depth, conf):
    """A request's outputs have its shape, finite values and confidence in
    (0, 1]; raises on a failure, returns the confidence's range."""
    if tuple(depth.shape) != (B, H, W) or tuple(conf.shape) != (B, H, W):
        raise RuntimeError(f"output shapes {tuple(depth.shape)}, {tuple(conf.shape)}")
    if not (torch.isfinite(depth).all() and torch.isfinite(conf).all()):
        raise RuntimeError("non-finite depth or confidence")
    cmin, cmax = float(conf.min()), float(conf.max())
    if cmin <= 0.0 or cmax > 1.0:
        raise RuntimeError(f"confidence range [{cmin}, {cmax}] outside (0, 1]")
    return cmin, cmax


def check_outputs(torch, depth, conf, decode_calls, decode):
    """Phase 5's checks of one DTU request's outputs: shapes, finite values,
    depth within [DEPTH_MIN, DEPTH_MAX] and each stage's depth (`decode`
    run again on its recorded inputs) within its hypotheses, confidence in
    (0, 1]. Raises on a failure; returns the line to print."""
    cmin, cmax = check_confidence(torch, depth, conf)
    dmin, dmax = float(depth.min()), float(depth.max())
    if dmin < DEPTH_MIN or dmax > DEPTH_MAX:
        raise RuntimeError(f"depth range [{dmin}, {dmax}] outside [{DEPTH_MIN}, {DEPTH_MAX}]")
    for s, (args, _) in enumerate(decode_calls):
        dv_s = args[1]
        with torch.inference_mode():
            d_s, _ = decode(*args)
        lo, hi = float(dv_s.min()), float(dv_s.max())
        if float(d_s.min()) < lo - 1e-3 or float(d_s.max()) > hi + 1e-3:
            raise RuntimeError(f"stage {s + 1}: depth outside its hypotheses [{lo}, {hi}]")
    return f"outputs ok: depth [{dmin:.3f}, {dmax:.3f}], conf [{cmin:.6f}, {cmax:.6f}]"


def rel_compare(rtol_of_scale, names, floor=1.0):
    """Compare outputs one by one: |got - want| <= rtol * max(floor, max|want|).
    A floor of 0 makes the bound relative to the output's own scale, for
    outputs whose scale follows their inputs' (a gradient of a mean over many
    pixels is small)."""
    def compare(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        ok, err, parts = True, 0.0, []
        for name, g, w in zip(names, got, want):
            e, allowed = max_err(g, w), rtol_of_scale * max(floor, float(w.abs().max()))
            ok, err = ok and e <= allowed, max(err, e)
            parts.append(f"{name} {e:.3e} (<= {allowed:.3e})")
        return (ok, err, ", ".join(parts),
                f"{rtol_of_scale:g} of max({floor:g}, max |output|)" if floor
                else f"{rtol_of_scale:g} of max |output|")
    return compare


def compare_k1(got, want):
    scale = max(1.0, float(want[0].abs().max()))
    e_corr, e_ent = max_err(got[0], want[0]), max_err(got[1], want[1])
    return (e_corr <= K1_RTOL_OF_SCALE * scale and e_ent <= K1_ENT_ATOL, max(e_corr, e_ent),
            f"corr {e_corr:.3e}, entropy {e_ent:.3e}",
            f"corr <= {K1_RTOL_OF_SCALE:g}*{scale:.3f}, entropy <= {K1_ENT_ATOL:g}")


def compare_k2(got, want):
    err = max_err(got, want)
    return err <= K2_ATOL, err, f"{err:.3e}", f"{K2_ATOL:g}"


def compare_k3(got, want):
    e_d = float(((got[0] - want[0]).abs() - K3_DEPTH_RTOL * want[0].abs()).max())
    e_c = float(((got[1] - want[1]).abs() - K3_CONF_RTOL * want[1].abs()).max())
    err_d, err_c = max_err(got[0], want[0]), max_err(got[1], want[1])
    return (e_d <= K3_DEPTH_ATOL and e_c <= K3_CONF_ATOL, max(err_d, err_c),
            f"depth {err_d:.3e}, conf {err_c:.3e}",
            f"depth {K3_DEPTH_ATOL:g}+{K3_DEPTH_RTOL:g}|d|, conf {K3_CONF_ATOL:g}+{K3_CONF_RTOL:g}|c|")


def sdpa(torch, args):
    """K6's library yardstick: one scaled_dot_product_attention call on the
    same q, k, v (heads split as views), and the map of its [B, heads, N,
    hd] output back to K6's [B, N, C]."""
    import torch.nn.functional as F

    q, k, v, nh = args
    b, n, c = q.shape
    qh, kh, vh = (t.reshape(b, t.shape[1], nh, c // nh).transpose(1, 2) for t in (q, k, v))
    return (lambda: F.scaled_dot_product_attention(qh, kh, vh),
            lambda out: out.transpose(1, 2).reshape(b, n, c))


def call_label(name, i, args):
    if name == "encoder_head":
        return "request"
    if name == "fpn_level":
        return f"level{i + 1}"
    if name == "gsa_attention":
        return f"block{i + 1} N={args[0].shape[1]} C={args[0].shape[2]}"
    if name == "warp_corr_bwd":  # the backward meets the stages in reverse
        return f"stage{4 - i}"
    return f"stage{i + 1}"


def tensors_of(out):
    """The tensors of a kernel's output (a tensor or a tuple of them), in order."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in tensors_of(o)]
    return [out] if hasattr(out, "shape") else []


def bit_equal(torch, a, b) -> bool:
    """Whether two outputs hold the same bits (NaN payloads included)."""
    ta, tb = tensors_of(a), tensors_of(b)
    return len(ta) == len(tb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8))
        for x, y in zip(ta, tb))


def check_kernel(torch, card, name, spec, label, args, kwargs):
    """Hold one launch of a kernel against its plain version on the same
    inputs, and time both (and the library call, where there is one). An
    eval kernel (`bitwise` in its spec) must also give the same bits in
    REPEAT_RUNS runs on the same inputs: none of K1-K6 sums with atomics."""
    with torch.no_grad():
        got = spec["kernel"](*args, **kwargs)
        repeat = ""
        if spec.get("bitwise"):
            if not all(bit_equal(torch, got, spec["kernel"](*args, **kwargs))
                       for _ in range(REPEAT_RUNS - 1)):
                raise RuntimeError(f"{name} {label}: the kernel's output varies between runs "
                                   f"on the same inputs")
            repeat = f"; bit-equal in {REPEAT_RUNS} runs"
        want = spec["plain"](*args, **kwargs)
        torch.cuda.synchronize()
        ok, err, detail, tol = spec["compare"](got, want)
        detail += repeat
        ms = time_ms(torch, lambda: spec["kernel"](*args, **kwargs))
        plain_ms = time_ms(torch, lambda: spec["plain"](*args, **kwargs), reps=3)
        lib_ms = None
        if "library" in spec:
            lib, to_plain = spec["library"](torch, args)
            lib_ms = time_ms(torch, lib)
            detail += f"; library call max_abs_err {max_err(to_plain(lib()), want):.3e}"
    nbytes, flops, *tensor = spec["cost"](args, kwargs)
    tensor_macs = tensor[0] if tensor else 0
    b_ms, b_by = bound_ms(nbytes, flops, tensor_macs)
    lib_text = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
    share = f", {b_ms / ms:.1%} of it" if tensor else ""
    print(f"{name} {label}: max_abs_err {detail} (tolerance {tol}) "
          f"{'ok' if ok else 'FAILED'}; {ms:.4f} ms, plain {plain_ms:.4f} ms{lib_text}, "
          f"bound {b_ms:.4f} ms ({b_by}){share} [{card}]", flush=True)
    if not ok:
        raise RuntimeError(f"{name} {label}: kernel disagrees with its plain version")
    return dict(label=label, err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                tensor_macs=tensor_macs)


def kernel_row(name, spec, rows, launches):
    """One entry of the kernels JSON line, summed over the checked launches:
    the bound is the sum of the launches' bounds, and bound_by the term
    that binds the most of it (the tensor cores' term counts as
    operations)."""
    by_term = {}
    for r in rows:
        term = "operations" if r["bound_by"] == "tensor" else r["bound_by"]
        by_term[term] = by_term.get(term, 0.0) + r["bound_ms"]
    return {
        "name": name, "route": spec["route"], "source": spec["source"],
        "replaces": spec["replaces"], "launches": launches,
        "max_abs_err": max(r["err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(by_term.values()),
        "bound_by": max(by_term, key=by_term.get),
        "library_ms": (sum(r["library_ms"] for r in rows) if "library" in spec else None),
    }


def train_layer_breakdown(torch, model, step, batch):
    """Device time per layer in one training step, under torch.profiler.

    Forward: CUDA events on forward pre/post hooks, as `layer_breakdown`.
    Backward: the device time of the kernels each autograd node launches
    (the profiler's record of that node, matched by its sequence number),
    given to the layer whose forward made the node: a layer's nodes are
    those reachable from its outputs without passing its inputs or a
    parameter's gradient accumulator. A nested layer (a stage's visibility
    CNN and cost regulariser) counts inside its stage as well. The
    optimizer step is spanned by CUDA events on the optimizer's hooks.
    Returns (split, kernel ms, wall ms, top kernels)."""
    from torch.profiler import ProfilerActivity, profile

    nst = len(model.fusions)
    top = ["encoder", "vit", "decoder_vit", "decoder"] + [f"fusions.{i}" for i in range(nst)]
    names = top + [f"fusions.{i}.{sub}" for i in range(nst) for sub in ("vis", "cost_reg")]
    modules = dict(model.named_modules())
    fwd = {n: [] for n in names}
    owner, inputs, hooks = {}, {}, []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def tensors(x):
        if isinstance(x, torch.Tensor):
            return [x] if x.grad_fn is not None else []
        if isinstance(x, (list, tuple)):
            return [t for y in x for t in tensors(y)]
        if isinstance(x, dict):
            return [t for y in x.values() for t in tensors(y)]
        return []

    def claim(name, outs, ins):
        stop = {t.grad_fn for t in ins}
        seen, todo = set(), [t.grad_fn for t in outs]
        while todo:
            node = todo.pop()
            if node is None or node in seen or node in stop or \
                    type(node).__name__ == "AccumulateGrad":
                continue
            seen.add(node)
            owner.setdefault(node._sequence_nr(), name)  # an inner layer claims first
            todo.extend(f for f, _ in node.next_functions)

    for name in names:
        def pre(mod, args, name=name):
            fwd[name].append([event(), None])
            inputs[name] = tensors(args)

        def post(mod, args, out, name=name):
            fwd[name][-1][1] = event()
            claim(name, tensors(out), inputs.pop(name))
        hooks += [modules[name].register_forward_pre_hook(pre),
                  modules[name].register_forward_hook(post)]
    opt = []
    hooks += [step.optimizer.register_step_pre_hook(lambda *a: opt.append(event())),
              step.optimizer.register_step_post_hook(lambda *a: opt.append(event()))]
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            start = event()
            step(batch)
            end = event()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for h in hooks:
            h.remove()
    backward = {n: 0.0 for n in names}
    for e in prof.events():
        if e.name.startswith("autograd::engine::evaluate_function") and e.sequence_nr in owner:
            o = owner[e.sequence_nr]
            for n in names:
                if o == n or o.startswith(n + "."):
                    backward[n] += e.device_time_total / 1e3
    out = {"forward": {n: sum(a.elapsed_time(b) for a, b in fwd[n]) for n in names},
           "backward (kernels)": backward}
    out["optimizer"] = opt[0].elapsed_time(opt[-1])
    out["total"] = start.elapsed_time(end)
    out["other (resizes, hypotheses, loss, view split, gradient accumulation, idle)"] = (
        out["total"] - out["optimizer"]
        - sum(out["forward"][n] + backward[n] for n in top))
    kernel_ms, top_kernels = kernel_times(torch, prof)
    return out, kernel_ms, wall_ms, top_kernels


def grads_of(model):
    return {n: p.grad for n, p in model.named_parameters() if p.requires_grad}


def zero_in_exact_arithmetic(torch, model):
    """The trainable tensors whose gradient is zero in exact arithmetic, so
    that it holds only rounding noise, which can sum to exactly zero (fp32
    on the CPU gives 0.0 for a probability bias in one of two steps of the
    `was` toy step): the cost regularisers' probability biases, ahead of
    the softmax over depth, and the biases of convs ahead of a batch norm
    or of a group norm with one channel a group (with more, only the
    bias's mean over a group drops out)."""
    def removes_bias(norm):
        return (isinstance(norm, torch.nn.modules.batchnorm._BatchNorm)
                or (isinstance(norm, torch.nn.GroupNorm)
                    and norm.num_groups == norm.num_channels))

    names = {n for n, _ in model.named_parameters() if n.endswith("cost_reg.prob.bias")}
    for name, mod in model.named_modules():
        if (isinstance(mod, torch.nn.Sequential) and len(mod) > 1 and removes_bias(mod[1])
                and getattr(mod[0], "bias", None) is not None):
            names.add(f"{name}.0.bias")
    return names


def zero_gradients(torch, model):
    return sorted(n for n, g in grads_of(model).items()
                  if g is not None and not bool((g != 0).any()))


def bad_gradients(torch, model, zero_ok=()):
    """The trainable tensors whose gradient is missing, non-finite or not
    fp32, or all zero though neither zero in exact arithmetic nor in
    `zero_ok`."""
    exact = zero_in_exact_arithmetic(torch, model) | set(zero_ok)
    return [n for n, g in grads_of(model).items()
            if g is None or g.dtype != torch.float32 or not bool(torch.isfinite(g).all())
            or (n not in exact and not bool((g != 0).any()))]


def compare_steps(torch, card_model, cpu_model, before, card_metrics, cpu_metrics, opt_cfg):
    """Card against CPU after one training step from the same weights:
    (ok, {what: worst error}, message lines)."""
    lines, errs, ok = [], {}, True
    for k, v in cpu_metrics.items():
        if k.startswith("loss"):
            e = abs(card_metrics[k] - v)
            errs[k] = e
            if e > STEP_LOSS_RTOL * abs(v):
                ok = False
                lines.append(f"{k}: card {card_metrics[k]:.7f}, cpu {v:.7f}")
    card_g, cpu_g = grads_of(card_model), grads_of(cpu_model)
    worst_scale, worst_l2, worst_at = 0.0, 0.0, None
    for n, want in cpu_g.items():
        got = card_g[n].cpu()
        e = float((got - want).abs().max())
        scale = float(want.abs().max())
        if e > 5e-4 + STEP_GRAD_OF_SCALE * scale:
            ok = False
            lines.append(f"grad {n}: max error {e:.3e}, scale {scale:.3e}")
        norm = float(want.norm())
        if norm > 1e-4:  # the worst errors are reported where the gradient is not ~0
            if e / scale > worst_scale:
                worst_scale, worst_at = e / scale, n
            rel = float((got - want).norm()) / norm
            worst_l2 = max(worst_l2, rel)
            if rel > STEP_GRAD_L2:
                ok = False
                lines.append(f"grad {n}: L2 error {rel:.3e} of its norm")
    errs["grad_of_scale"], errs["grad_l2"] = worst_scale, worst_l2
    lines.append(f"largest gradient error, of its tensor's scale: {worst_scale:.3e} at {worst_at}")
    card_b, worst_stat = dict(card_model.named_buffers()), 0.0
    for n, want in cpu_model.named_buffers():
        if n.endswith(("running_mean", "running_var")):
            e = (card_b[n].cpu() - want).abs()
            worst_stat = max(worst_stat, float(e.max()))
            if bool((e > STEP_STATS_ATOL + STEP_STATS_RTOL * want.abs()).any()):
                ok = False
                lines.append(f"running stat {n}: max error {float(e.max()):.3e}")
    errs["running_stats"] = worst_stat
    card_p, worst_upd = dict(card_model.named_parameters()), 0.0
    for n, p in cpu_model.named_parameters():
        if n not in cpu_g:  # frozen (`fix`): bit-equal to the start on both
            if not (bit_equal(torch, p.detach(), before[n])
                    and bit_equal(torch, card_p[n].detach().cpu(), before[n])):
                ok = False
                lines.append(f"frozen {n} moved")
            continue
        lr = opt_cfg.vit_lr if n.startswith("vit.") else opt_cfg.lr
        got = card_p[n].detach().cpu() - before[n]
        want = p.detach() - before[n]
        g = cpu_g[n]
        pmax = float(before[n].abs().max())
        ulps = 2.5e-7 * max(1.0, pmax)  # two fp32 roundings of the weight
        if float(g.norm()) > 1e-4:
            sure = g.abs() >= 0.1 * g.abs().max()
            e = float((got[sure] - want[sure]).abs().max())
            worst_upd = max(worst_upd, e / lr)
            if e > STEP_UPDATE_OF_LR * lr + ulps:
                ok = False
                lines.append(f"update {n}: max error {e:.3e} where the gradient sign is certain")
        bound = lr * (1 + opt_cfg.weight_decay * pmax) + ulps
        if float(got.abs().max()) > bound:
            ok = False
            lines.append(f"update {n}: moved {float(got.abs().max()):.3e}, more than one step")
    errs["update_of_lr"] = worst_upd
    return ok, errs, lines


def eval_kernel_specs(model):
    """K1-K6: each kernel's wrapper and plain version, the module whose
    global the model calls it through, its launches per request of `model`,
    its cost, check and row."""
    from mvsformer_torch.models import fpn, stagenet, twins
    from mvsformer_torch.ops import (encoder_head, fpn_level, gsa_attention, stage_tail, vis_net,
                                     warp_corr)

    nstages = len(model.fusions)
    return {
        "warp_group_corr": dict(
            kernel=warp_corr.warp_group_corr, plain=warp_corr.warp_group_corr_plain,
            owner=stagenet, per_request=nstages, cost=k1_cost, compare=compare_k1,
            route="cuda", source="mvsformer_torch/csrc/warp_corr.cu",
            replaces="mvsformer_tpu/ops/pallas/warp_corr.py:1325", bitwise=True),
        "visibility_net": dict(
            kernel=vis_net.visibility_net, plain=vis_net.visibility_net_plain,
            owner=stagenet, per_request=nstages, cost=k2_cost, compare=compare_k2,
            route="cuda", source="mvsformer_torch/csrc/vis_net.cu",
            replaces="mvsformer_tpu/ops/pallas/vis_net.py:192", bitwise=True),
        "depth_decode": dict(
            kernel=stage_tail.depth_decode, plain=stage_tail.depth_decode_plain,
            owner=stagenet, per_request=nstages, cost=k3_cost, compare=compare_k3,
            route="cuda", source="mvsformer_torch/csrc/depth_decode.cu",
            replaces="mvsformer_tpu/ops/pallas/stage_tail.py:57", bitwise=True),
        "encoder_head": dict(
            kernel=encoder_head.encoder_head, plain=encoder_head.encoder_head_plain,
            owner=fpn, per_request=1, cost=k4_cost,
            compare=rel_compare(K4_RTOL_OF_SCALE, ("conv01", "down0")),
            route="cuda", source="mvsformer_torch/csrc/encoder_head.cu",
            replaces="mvsformer_tpu/ops/pallas/encoder_head.py:213", bitwise=True),
        "fpn_level": dict(
            kernel=fpn_level.fpn_level, plain=fpn_level.fpn_level_plain,
            owner=fpn, per_request=3, cost=k5_cost,
            compare=rel_compare(K5_RTOL_OF_SCALE, ("out", "intra'")),
            route="cuda", source="mvsformer_torch/csrc/fpn_level.cu",
            replaces="mvsformer_tpu/ops/pallas/fpn_final.py:212", bitwise=True),
        "gsa_attention": dict(
            kernel=gsa_attention.gsa_attention, plain=gsa_attention.gsa_attention_plain,
            owner=twins, per_request=sum(d // 2 for d in model.vit.depths), cost=k6_cost,
            compare=rel_compare(K6_RTOL_OF_SCALE, ("out",)), library=sdpa,
            route="cuda", source="mvsformer_torch/csrc/gsa_attention.cu",
            replaces="mvsformer_tpu/ops/pallas/gsa_attention.py:68", bitwise=True),
    }


def train_kernel_specs(per_step):
    """K7 and K8: their wrappers, plain versions, checks and rows, and the
    module whose globals the training Function calls them through."""
    from mvsformer_torch.ops import warp_corr, warp_corr_train

    return {
        "warp_corr_fwd": dict(
            kernel=warp_corr.warp_corr_fwd, plain=warp_corr.warp_corr_fwd_plain,
            owner=warp_corr_train, per_step=per_step, cost=k7_cost,
            compare=rel_compare(K7_RTOL_OF_SCALE, ("corr",)),
            route="cuda", source="mvsformer_torch/csrc/warp_corr.cu",
            replaces="mvsformer_tpu/ops/pallas/warp_corr.py:694"),
        "warp_corr_bwd": dict(
            kernel=warp_corr_train.warp_corr_bwd, plain=warp_corr_train.warp_corr_bwd_plain,
            owner=warp_corr_train, per_step=per_step, cost=k8_cost,
            compare=rel_compare(K8_RTOL_OF_SCALE, ("dref", "dsrc"), floor=0.0),
            route="cuda", source="mvsformer_torch/csrc/warp_corr_bwd.cu",
            replaces="mvsformer_tpu/ops/pallas/warp_corr_bwd.py:197"),
    }


def training_phase(torch, card, eval_kernels):
    """Phases 8-10. Returns the details, with the K7/K8 rows of the kernels
    line under "kernels"."""
    import copy

    from mvsformer_torch.config import Config
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.ops import cuda_build
    from mvsformer_torch.train.step import TrainStep

    cfg = Config()
    sbm = cfg.data.multi_scale_args.scale_batch_map
    if cfg.data.batch_size != TRAIN_B or int(sbm[str(TRAIN_H)]) != TRAIN_MICRO:
        raise RuntimeError("the default DataConfig no longer gives the training shape")
    n_micro = TRAIN_B // TRAIN_MICRO
    nstages = len(cfg.arch.ndepths)
    specs = train_kernel_specs(per_step=nstages * n_micro)

    # 8a. The model, the optimizer and the batch.
    t0 = time.perf_counter()
    model = build_model(cfg.arch, device="cuda", train=True)
    random_init_(model, torch.Generator().manual_seed(1))
    step = TrainStep(model, cfg, seed=0)
    batch = synthetic_batch(torch, TRAIN_B, TRAIN_V, TRAIN_H, TRAIN_W, with_gt=True)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    print(f"training: TwinMVSNet alt_gvt_small fp32, drop path "
          f"{model.vit.blocks[-1][-1].drop_path_rate:.2f} at the last block, "
          f"{len(trainable)} trainable tensors, B={TRAIN_B} as {n_micro} micro-batches of "
          f"{TRAIN_MICRO}, {TRAIN_V} views, {TRAIN_H}x{TRAIN_W}, {NDEPTH_FULL} depths; "
          f"built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    step(batch)
    torch.cuda.synchronize()
    print(f"warm-up step: {time.perf_counter() - t0:.3f} s")

    # 8b. Timed steps, each driving the training path once.
    torch.cuda.reset_peak_memory_stats()
    times, launches, metrics = [], None, []
    for _ in range(N_STEPS):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        metrics.append(step(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = dict(cuda_build.LAUNCHES)
        for name, spec in specs.items():
            if counts.get(name, 0) != spec["per_step"]:
                raise RuntimeError(f"{name}: {counts.get(name, 0)} launches in a training "
                                   f"step, want {spec['per_step']}")
        ran = {n: counts[n] for n in eval_kernels if counts.get(n, 0)}
        if ran:
            raise RuntimeError(f"eval-only kernels launched in a training step: {ran}")
        launches = launches or counts
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mean_s = sum(times) / len(times)
    print(f"launches per training step, the same in each of {N_STEPS} steps: {launches}")
    for i, (t, m) in enumerate(zip(times, metrics)):
        print(f"step {i}: {t * 1e3:.2f} ms, loss {m['loss']:.5f} ("
              + ", ".join(f"{k[5:]} {m[k]:.5f}" for k in m if k.startswith("loss_"))
              + f"), grad norm {m['grad_norm']:.5f}, lr {m['lr']:.3e} [{card}]")
    print(f"mean training step: {mean_s * 1e3:.2f} ms, {1 / mean_s:.4f} train-steps/s, "
          f"{TRAIN_B / mean_s:.3f} samples/s, peak memory {peak_gb:.2f} GB (timed steps) [{card}]")

    # 8c. The last step's loss and gradients.
    import math

    if not all(math.isfinite(v) for m in metrics for k, v in m.items() if k.startswith("loss")):
        raise RuntimeError("non-finite training loss")
    bad = bad_gradients(torch, model)
    if bad:
        raise RuntimeError(f"{len(bad)} trainable tensors with a missing, non-finite or "
                           f"all-zero gradient: {bad[:8]}")
    print(f"gradients: all {len(trainable)} trainable tensors finite and non-zero (but for "
          f"those zero in exact arithmetic: {zero_gradients(torch, model)})")

    # 8d. Layer split of one step, and the device's idle share.
    layers, busy_ms, wall_ms, top = train_layer_breakdown(torch, model, step, batch)
    print("training step layers (device ms): " + json.dumps(
        {k: ({n: round(t, 3) for n, t in v.items()} if isinstance(v, dict) else round(v, 3))
         for k, v in layers.items()}))
    if busy_ms is None:
        print(f"profiled training step: {wall_ms:.2f} ms wall; device busy share not measured "
              f"(the profiler saw no device events)")
    else:
        print(f"profiled training step: {wall_ms:.2f} ms wall, {busy_ms:.2f} ms of kernels, "
              f"device idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} [{card}]")
        for name, t in top:
            print(f"  {t:9.3f} ms  {name[:110]}")

    # 8e. One more step, recording the tensors it feeds K7 and K8 at every
    # launch (the Function calls them through warp_corr_train's globals).
    recorded, _ = record_calls(torch, specs, step, batch)

    for name, spec in specs.items():
        if len(recorded[name]) != spec["per_step"]:
            raise RuntimeError(f"{name}: recorded {len(recorded[name])} calls, "
                               f"want {spec['per_step']}")

    # 9. K7 and K8 against their plain versions, TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    per_call = {name: [check_kernel(torch, card, name, spec, f"micro{i // nstages + 1} "
                                    + call_label(name, i % nstages, args), args, kwargs)
                       for i, (args, kwargs) in enumerate(recorded[name])]
                for name, spec in specs.items()}
    kernels = [kernel_row(name, spec, per_call[name], launches.get(name, 0))
               for name, spec in specs.items()]
    # K8 at stage 1 of micro-batch 1 (its last launch there) with zoomed sources.
    args, kwargs = recorded["warp_corr_bwd"][nstages - 1]
    k8_zoom = check_kernel(torch, card, "warp_corr_bwd", specs["warp_corr_bwd"],
                           "micro1 stage1 zoomed 3x", k8_zoomed(torch, args), kwargs)
    for name, kernel in (("warp_corr_fwd", "K7"), ("warp_corr_bwd", "K8")):
        ms = [r["ms"] for r in per_call[name]]
        if name == "warp_corr_bwd":  # the backward meets the stages in reverse
            ms = [t for m in range(n_micro) for t in ms[m * nstages:(m + 1) * nstages][::-1]]
        print(f"{name} ({kernel}) ms per stage, "
              + ", ".join(f"micro-batch {m + 1}: " + " / ".join(
                  f"{t:.4f}" for t in ms[m * nstages:(m + 1) * nstages]) for m in range(n_micro))
              + f"; {sum(ms):.4f} per step [{card}]")
    del recorded, model, step, batch
    torch.cuda.empty_cache()

    # 10. One step on the card against the CPU.
    sb, sv, sh, sw = STEP_SHAPE
    small = Config()
    small.arch.vit_args.drop_path_rate = 0.0
    small.optimizer.warmup_steps = 0
    small.data.multi_scale_args.scale_batch_map = {str(sh): 1}
    cpu_model = build_model(small.arch, device="cpu", train=True)
    random_init_(cpu_model, torch.Generator().manual_seed(2))
    card_model = copy.deepcopy(cpu_model).cuda()
    before = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    t0 = time.perf_counter()
    card_metrics = TrainStep(card_model, small, seed=0)(
        synthetic_batch(torch, sb, sv, sh, sw, device="cuda", with_gt=True))
    cpu_metrics = TrainStep(cpu_model, small, seed=0)(
        synthetic_batch(torch, sb, sv, sh, sw, device="cpu", with_gt=True))
    ok, step_errs, lines = compare_steps(torch, card_model, cpu_model, before, card_metrics,
                                         cpu_metrics, small.optimizer)
    print(f"training step {STEP_SHAPE} on the card against the CPU ({time.perf_counter() - t0:.1f}"
          f" s): loss {card_metrics['loss']:.6f} / {cpu_metrics['loss']:.6f}; worst errors "
          + ", ".join(f"{k} {v:.3e}" for k, v in step_errs.items())
          + f" (bounds: loss {STEP_LOSS_RTOL:g} relative; gradients {STEP_GRAD_OF_SCALE:g} of "
          f"scale + 5e-4 and {STEP_GRAD_L2:g} in L2; running stats {STEP_STATS_ATOL:g} + "
          f"{STEP_STATS_RTOL:g} relative; updates {STEP_UPDATE_OF_LR:g} of the LR where the "
          f"gradient sign is certain) " + ("ok" if ok else "FAILED"), flush=True)
    for line in lines[-20:]:
        print(f"  {line}")
    if not ok:
        raise RuntimeError("the training step on the card disagrees with the CPU step")
    return {"kernels": kernels, "step_ms": [t * 1e3 for t in times],
            "train_steps_per_s": 1 / mean_s, "peak_memory_gb": peak_gb, "launches": launches,
            "metrics": metrics, "layers_ms": layers, "per_call": per_call,
            "profiled_wall_ms": wall_ms, "profiled_kernel_ms": busy_ms, "top_kernels": top,
            "card_vs_cpu_step": step_errs, "k8_zoomed": k8_zoom,
            "shape": {"B": TRAIN_B, "micro": TRAIN_MICRO, "V": TRAIN_V, "H": TRAIN_H,
                      "W": TRAIN_W, "depths": NDEPTH_FULL}}


# The DTU test pipeline (phase 11): a synthetic DTU-layout scan of a tilted
# plane, written by the port's own codecs, through `save_depth` (1152x1536,
# 192 depths, 5 views per request, the default ModelConfig) and the three
# fusion methods. The cameras look down z from x = 10 v; the plane is
# z = 650 + 0.1 x + 0.05 y in the world.
PIPE_VIEWS = 6               # reference views, each with the other 5 as sources
PIPE_NUM_VIEW = 5            # views per request (the JAX default)
PIPE_IMG_HW = (1200, 1600)   # DTU's image size, resized to H x W by the dataset
PIPE_FOCAL = 1400.0          # at the image's size, as the cam files hold it
PIPE_BASELINE = 10.0
PIPE_PLANE = (650.0, 0.1, 0.05)
PIPE_METHODS = ("pcd", "dpcd", "gipuma")
# The reference views whose fusion also runs on the CPU to be compared (the
# CPU takes ~4 s a view and method at 1152x1536; the card fuses all 6).
PIPE_CPU_FUSE_VIEWS = (0, 3)
PIPE_KEEP_MIN = 0.9          # of the interior (the middle 3/4 of each axis)
PIPE_MASK_AGREE = 0.9999     # card against CPU, of the pixels
PIPE_POINT_RTOL = 1e-4       # card against CPU where both keep, of |point|
PIPE_PLANE_RTOL = 1e-3       # kept points off the plane, of its depth
PIPE_METRIC_ATOL = 1e-4      # depth_metric.txt, card against CPU (the CPU tests' bound)
# Card against CPU at a small shape: 3 views, ndepths 8/4/4/2 over 48 depths,
# images 150x225 resized to 128x192 (the backbone needs multiples of 64).
PIPE_SMALL = dict(img_hw=(150, 225), max_hw=(128, 192), num_view=3, ndepths=[8, 4, 4, 2],
                  depths=48, views=4)


def first_varying_module(torch, model, fn, inputs):
    """Run fn(*inputs) twice with a forward hook on every leaf module that
    sums the bits of its inputs and outputs, and name the first call, in
    call order, whose sums differ between the runs: "<module> (<type>)" if
    its inputs were equal (the module varies), "an op before <module>" if
    they were not (a functional op varies), "none" if no call differs."""
    records = []

    def bits(ts):
        return sum(int(t.detach().contiguous().view(torch.uint8).sum(dtype=torch.int64))
                   for t in ts if torch.is_tensor(t) and t.is_floating_point())

    def hook(name):
        def record(mod, args, out):
            records.append((name, type(mod).__name__, bits(args), bits(tensors_of(out))))
        return record

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules()
               if not any(True for _ in m.children())]
    try:
        runs = []
        for _ in range(2):
            records.clear()
            fn(*inputs)
            torch.cuda.synchronize()
            runs.append(list(records))
    finally:
        for h in handles:
            h.remove()
    for (name, kind, a_in, a_out), (_, _, b_in, b_out) in zip(*runs):
        if a_in != b_in:
            return f"an op before {name}"
        if a_out != b_out:
            return f"{name} ({kind})"
    return "none"


def plane_depth(K, tx, h, w):
    """The plane's depth [h, w] in a camera with intrinsics K at x = tx,
    pixel centres at +0.5 (the fusion's convention)."""
    import numpy as np

    z0, b, c = PIPE_PLANE
    v, u = np.mgrid[0:h, 0:w].astype(np.float64) + 0.5
    rx, ry = (u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1]
    return ((z0 - b * tx) / (1.0 - b * rx - c * ry)).astype(np.float32)


def write_dtu_scan(root, views=PIPE_VIEWS, img_hw=None, seed=0):
    """A DTU-layout test scan under `root`, by the port's writers:
    dtu/scan1/pair.txt (every other view a source), dtu/scan1/images/*.jpg
    (PNG bytes: the plane's texture seen by each camera, with noise),
    dtu/scan1/cams/*_cam.txt (intrinsics at the image's size, which the
    dataset quarters for stage 2; depth_min 425, interval 2.5, 192 depths) and Depths_raw/scan1 (the plane's depth and a
    mask without a 4% border). Returns the dataset root, root/dtu."""
    import numpy as np

    from mvsformer_torch.utils.cams import CameraParams, write_cam_file
    from mvsformer_torch.utils.image import write_png
    from mvsformer_torch.utils.pfm import save_pfm

    h, w = img_hw or PIPE_IMG_HW
    f = PIPE_FOCAL * w / 1600
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    data = os.path.join(root, "dtu")
    scan, gt = os.path.join(data, "scan1"), os.path.join(root, "Depths_raw", "scan1")
    for d in (os.path.join(scan, "images"), os.path.join(scan, "cams"), gt):
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(scan, "pair.txt"), "w") as fp:
        fp.write(f"{views}\n")
        for ref in range(views):
            srcs = sorted((v for v in range(views) if v != ref), key=lambda v: abs(v - ref))
            fp.write(f"{ref}\n{len(srcs)} " + " ".join(f"{s} {100 - abs(s - ref)}" for s in srcs)
                     + "\n")
    rng = np.random.default_rng(seed)
    mask = plane_mask(h, w)
    for v in range(views):
        tx = v * PIPE_BASELINE
        img, z = plane_view(K, tx, h, w, rng)
        write_png(os.path.join(scan, "images", f"{v:0>8}.jpg"), img)
        ext = np.eye(4, dtype=np.float32)
        ext[0, 3] = tx
        write_cam_file(os.path.join(scan, "cams", f"{v:0>8}_cam.txt"),
                       CameraParams(ext, K.astype(np.float32), 425.0, 2.5, 192.0))
        save_pfm(os.path.join(gt, f"depth_map_{v:0>4}.pfm"), z)
        write_png(os.path.join(gt, f"depth_visual_{v:0>4}.png"), mask)
    return data


def plane_view(K, tx, h, w, rng, gain=1.0):
    """The plane seen by the camera at x = tx: (RGB uint8 [h, w, 3], its
    texture times `gain` with noise; depth float32 [h, w])."""
    import numpy as np

    v_, u_ = np.mgrid[0:h, 0:w] + 0.5
    z = plane_depth(K, tx, h, w).astype(np.float64)
    xw, yw = (u_ - K[0, 2]) / K[0, 0] * z - tx, (v_ - K[1, 2]) / K[1, 1] * z
    tex = np.stack([np.sin(xw / 6.0) + np.cos(yw / 9.0), np.sin((xw + yw) / 11.0),
                    np.cos(xw / 17.0) * np.sin(yw / 5.0)], -1)
    img = gain * (128 + 50 * tex) + rng.normal(0, 6, tex.shape)
    return np.clip(img, 0, 255).astype(np.uint8), z.astype(np.float32)


def plane_mask(h, w):
    """The ground-truth mask: 255 but for a 4% border."""
    import numpy as np

    border = max(1, int(0.04 * min(h, w)))
    mask = np.zeros((h, w), np.uint8)
    mask[border:-border, border:-border] = 255
    return mask


# The committed JPEG fixtures (tools/make_jpeg_fixtures.py, from cv2): the
# decoder's oracle here, where there is no cv2. Their manifest holds each
# stream's shape and the sha256 of its cv2 colour (RGB) and grey decodes.
JPEG_FIXTURES = os.path.join("tests", "fixtures", "jpeg")
JPEG_RUNS = 5      # decodes of the 1600x1200 stream, timed; the median is printed
JPEG_THREADS = 4   # the training loader's threads, decoding at once


def jpeg_manifest():
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, JPEG_FIXTURES, "manifest.json")) as f:
        return json.load(f)


def jpeg_stream(entry):
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, JPEG_FIXTURES, entry["jpeg"]), "rb") as f:
        return f.read()


def sha256_of(a) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def write_jpeg_scan(root, png_twin=False):
    """The committed DTU-layout JPEG scan under `root`: `write_dtu_scan` at
    its size and seed (the same cams, pair, Depths_raw and images as the
    fixtures were encoded from), with images/*.jpg replaced by the committed
    cv2 JPEG streams; with `png_twin`, by PNGs of the port's decodes of
    them, each first held to its committed cv2 digest. Returns the dataset
    root, root/dtu."""
    import shutil

    from mvsformer_torch.utils.jpeg import decode_jpeg
    from mvsformer_torch.utils.image import write_png

    m = jpeg_manifest()
    here = os.path.dirname(os.path.abspath(__file__))
    data = write_dtu_scan(root, img_hw=tuple(m["scan_hw"]), seed=m["scan_seed"])
    for vid, entry in m["scan"].items():
        dst = os.path.join(data, "scan1", "images", f"{vid}.jpg")
        if not png_twin:
            shutil.copyfile(os.path.join(here, JPEG_FIXTURES, entry["jpeg"]), dst)
            continue
        rgb = decode_jpeg(jpeg_stream(entry))
        if sha256_of(rgb) != entry["rgb_sha256"]:
            raise RuntimeError(f"{entry['jpeg']}: the port's decode is not cv2's")
        write_png(dst, rgb)
    return data


def check_cli_launches(log_name, specs, requests):
    """The test CLI's "kernel launches in phase 1" line from
    chiprun_out/<log_name>.log: every kernel of `specs` launched `requests`
    x its per-request count, and nothing else. Returns the counts."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "chiprun_out", f"{log_name}.log")) as f:
        lines = [ln for ln in f if ln.startswith("kernel launches in phase 1")]
    if len(lines) != 1:
        raise RuntimeError(f"{log_name}.log: {len(lines)} launch lines, want 1")
    got = json.loads(lines[0].split(": ", 1)[1])
    want = {n: requests * s["per_request"] for n, s in specs.items() if s["per_request"]}
    if got != want:
        raise RuntimeError(f"{log_name}: launches {got}, want {want}")
    return got


def jpeg_checks(card, png_decode_ms):
    """11h: build the host JPEG decoder, decode every committed fixture in
    colour and grey against its cv2 decode, time the 1600x1200 stream
    beside the PNG decode of the same pixels, and decode it from
    `JPEG_THREADS` threads at once. Returns the details."""
    import statistics

    from mvsformer_torch.utils import jpeg
    from mvsformer_torch.utils.image import read_image

    here = os.path.dirname(os.path.abspath(__file__))
    cached = jpeg.lib_path().exists()
    t_start = time.perf_counter()
    jpeg.library()
    build_s = time.perf_counter() - t_start
    m = jpeg_manifest()
    entries = dict({f"small/{k}": v for k, v in m["small"].items()}, view0=m["view0"],
                   **{f"scan/{k}": v for k, v in m["scan"].items()})
    bad = []
    for name, e in entries.items():
        stream = jpeg_stream(e)
        rgb, grey = jpeg.decode_jpeg(stream), jpeg.decode_jpeg(stream, gray=True)
        if list(grey.shape) != e["shape"] or (sha256_of(rgb), sha256_of(grey)) != (
                e["rgb_sha256"], e["grey_sha256"]):
            bad.append(name)
        for key, got, gray in (("rgb_png", rgb, False), ("grey_png", grey, True)):
            if key in e:
                want = read_image(os.path.join(here, JPEG_FIXTURES, e[key]), gray=gray)
                if want.shape != got.shape or (want != got).any():
                    bad.append(f"{name} {key}")
    print(f"JPEG decoder: {'cached' if cached else 'built'} in {build_s:.2f} s; "
          f"{len(entries)} committed streams decoded in colour and grey, "
          f"{len(entries) - len(bad)} bit-equal to their cv2 decodes", flush=True)
    if bad:
        raise RuntimeError(f"JPEG decodes differ from cv2's: {bad}")
    path = os.path.join(here, JPEG_FIXTURES, m["view0"]["jpeg"])
    times = {}
    for label, gray in (("colour", False), ("grey", True)):
        runs = []
        for _ in range(JPEG_RUNS):
            t0 = time.perf_counter()
            read_image(path, gray=gray)
            runs.append((time.perf_counter() - t0) * 1e3)
        times[label] = statistics.median(runs)
    stream = jpeg_stream(m["view0"])
    serial = jpeg.decode_jpeg(stream)
    with concurrent.futures.ThreadPoolExecutor(JPEG_THREADS) as pool:
        t0 = time.perf_counter()
        threaded = list(pool.map(lambda _: jpeg.decode_jpeg(stream), range(JPEG_THREADS)))
        threads_ms = (time.perf_counter() - t0) * 1e3
    if any(t.shape != serial.shape or (t != serial).any() for t in threaded):
        raise RuntimeError("a JPEG decode from several threads differs from the serial one")
    h, w = m["view0"]["shape"]
    print(f"JPEG {w}x{h} 4:2:0 q{m['quality']} ({len(stream) / 1e6:.2f} MB): read_image "
          f"median of {JPEG_RUNS} {times['colour']:.1f} ms in colour, {times['grey']:.1f} ms "
          f"grey; the PNG of the same pixels {png_decode_ms:.1f} ms (11a); {JPEG_THREADS} "
          f"threads at once {threads_ms:.1f} ms, each the serial result [{card}]", flush=True)
    return {"seconds": time.perf_counter() - t_start, "build_s": build_s, "cached": cached,
            "streams": len(entries),
            "decode_ms": times, "png_decode_ms": png_decode_ms,
            "threads": JPEG_THREADS, "threads_ms": threads_ms}


def write_png_filtered(path, img, row_filter=None):
    """RGB uint8 [H, W, 3] -> an 8-bit PNG whose rows all take `row_filter`
    (0-4: None, Sub, Up, Average, Paeth) or, if it is None, each the filter
    with the least sum of |byte as a signed char|, the heuristic libpng (and
    so OpenCV and PIL) uses by default. Returns the number of rows that took
    each filter."""
    import struct
    import zlib

    import numpy as np

    h, w, ch = img.shape
    x = img.reshape(h, w * ch).astype(np.int16)
    a = np.zeros_like(x)
    a[:, ch:] = x[:, :-ch]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, ch:] = x[:-1, :-ch]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cands = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]) & 255
    if row_filter is None:
        choice = np.where(cands >= 128, 256 - cands, cands).sum(axis=2).argmin(axis=0)
    else:
        choice = np.full(h, row_filter)
    rows = np.empty((h, 1 + w * ch), np.uint8)
    rows[:, 0] = choice
    rows[:, 1:] = cands[choice, np.arange(h)]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
    return np.bincount(choice, minlength=5).tolist()


def host_steps(png, root):
    """Host ms of one view's steps in save_depth, each the mean of 3 after
    one untimed run: the PNG decode, the bilinear resize to H x W, the
    normalisation, and the writes of its depth (PFM), confidence (npy) and
    image (PNG). Then the decoder's two paths on the same image: the decode
    of a copy whose rows take libpng's adaptive filters and of one whose
    rows are all Paeth (the wavefront path), and the unfiltering alone of
    the port's Up-filtered rows by the row path and by the wavefront.
    Returns (ms by step, rows per filter of the adaptive copy)."""
    import numpy as np

    from mvsformer_torch.data.augment import normalize
    from mvsformer_torch.utils import image
    from mvsformer_torch.utils.image import read_image, resize_bilinear_u8, write_png
    from mvsformer_torch.utils.pfm import save_pfm

    img = read_image(png)
    small = resize_bilinear_u8(img, (H, W)).numpy()
    depth = np.full((H, W), 600.0, np.float32)
    adaptive, paeth = os.path.join(root, "adaptive.png"), os.path.join(root, "paeth.png")
    filters = write_png_filtered(adaptive, img)
    write_png_filtered(paeth, img, row_filter=4)
    for copy in (adaptive, paeth):
        if not np.array_equal(read_image(copy), img):
            raise RuntimeError(f"{copy} decodes to another image")
    up_rows = np.empty_like(img)
    up_rows[0], up_rows[1:] = img[0], img[1:] - img[:-1]
    up = np.full(img.shape[0], 2, np.uint8)
    steps = {
        "decode": lambda: read_image(png),
        "resize": lambda: resize_bilinear_u8(img, (H, W)),
        "normalise": lambda: normalize(small.astype(np.float32) / 255.0),
        "write pfm": lambda: save_pfm(os.path.join(root, "t.pfm"), depth),
        "write npy": lambda: np.save(os.path.join(root, "t.npy"), depth),
        "write png": lambda: write_png(os.path.join(root, "t.png"), small),
        "decode adaptive": lambda: read_image(adaptive),
        "decode paeth": lambda: read_image(paeth),
        "unfilter up, rows": lambda: image._unfilter_rows(up_rows, up),
        "unfilter up, wavefront": lambda: image._unfilter_wavefront(up_rows, up),
    }
    out = {}
    for name, fn in steps.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        out[name] = (time.perf_counter() - t0) / 3 * 1e3
    return out, filters


def plane_folder(saved_scan, folder):
    """A copy of save_depth's scan folder whose depth maps are the plane's
    exact depths (from the saved cameras) and whose confidences are 1."""
    import shutil

    import numpy as np

    from mvsformer_torch.utils.cams import read_cam_file
    from mvsformer_torch.utils.pfm import read_pfm, save_pfm

    shutil.copytree(saved_scan, folder)
    for name in sorted(os.listdir(os.path.join(folder, "cams"))):
        vid = name[:8]
        cam = read_cam_file(os.path.join(folder, "cams", name))
        h, w = read_pfm(os.path.join(folder, "depth_est", f"{vid}.pfm"))[0].shape
        save_pfm(os.path.join(folder, "depth_est", f"{vid}.pfm"),
                 plane_depth(cam.intrinsic.astype(np.float64), float(cam.extrinsic[0, 3]), h, w))
        np.save(os.path.join(folder, "confidence", f"{vid}.npy"), np.ones((h, w), np.float32))
    return folder


def save_depth_card_vs_cpu(torch, root, device="cuda"):
    """save_depth at PIPE_SMALL on the card (`device`) and, with the same
    weights, on the CPU: {artifact: worst error} over every view (depth and confidence
    max |card - cpu|; cams and images 0 when their bytes are equal, else
    inf)."""
    import copy

    import numpy as np

    from mvsformer_torch.config import ModelConfig
    from mvsformer_torch.infer import save_depth
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.utils.pfm import read_pfm

    s = PIPE_SMALL
    data = write_dtu_scan(os.path.join(root, "small"), views=s["views"], img_hw=s["img_hw"])
    cpu_model = build_model(ModelConfig(ndepths=s["ndepths"]), device="cpu")
    random_init_(cpu_model, torch.Generator().manual_seed(3))
    card_model = copy.deepcopy(cpu_model).to(device)
    out = {}
    for dev, model in (("cuda", card_model), ("cpu", cpu_model)):
        out[dev] = os.path.join(root, f"small_{dev}")
        save_depth(model, ["scan1"], data, out[dev], num_view=s["num_view"],
                   ndepths=s["depths"], max_h=s["max_hw"][0], max_w=s["max_hw"][1],
                   device=device if dev == "cuda" else "cpu", logger=lambda *a: None)
    errs = {"depth": 0.0, "confidence": 0.0, "cams": 0.0, "images": 0.0, "depth_metric": 0.0}

    def raw(dev, *parts):
        with open(os.path.join(out[dev], *parts), "rb") as fp:
            return fp.read()

    for v in range(s["views"]):
        vid = f"{v:0>8}"
        a, b = (read_pfm(os.path.join(out[d], "scan1", "depth_est", f"{vid}.pfm"))[0]
                for d in ("cuda", "cpu"))
        errs["depth"] = max(errs["depth"], float(np.abs(a - b).max()))
        a, b = (np.load(os.path.join(out[d], "scan1", "confidence", f"{vid}.npy"))
                for d in ("cuda", "cpu"))
        errs["confidence"] = max(errs["confidence"], float(np.abs(a - b).max()))
        for kind, name in (("cams", f"{vid}_cam.txt"), ("images", f"{vid}.jpg")):
            if raw("cuda", "scan1", kind, name) != raw("cpu", "scan1", kind, name):
                errs[kind] = float("inf")
    metrics = [dict(line.split(": ") for line in raw(d, "depth_metric.txt").decode().splitlines())
               for d in ("cuda", "cpu")]
    errs["depth_metric"] = max(abs(float(metrics[0][k]) - float(metrics[1][k]))
                               for k in metrics[1])
    ok = (errs["depth"] <= E2E_DEPTH_ATOL and errs["confidence"] <= E2E_CONF_ATOL
          and errs["cams"] == 0 and errs["images"] == 0
          and errs["depth_metric"] <= PIPE_METRIC_ATOL)
    return ok, errs


def fusion_card_vs_cpu(torch, pair, scan, method, device="cuda"):
    """Every reference view of `scan` (pair.txt in `pair`) fused on the card,
    and the views PIPE_CPU_FUSE_VIEWS on the CPU as well:
    (per view: kept share of the interior on the card, worst distance from
    the plane of the card's kept points in the interior, of their depth;
    where the CPU fused it, mask agreement and worst point error of |point|
    where both keep, else None)."""
    import numpy as np

    from mvsformer_torch.fuse import FusionDataset, fuse_view, make_fuse_fn

    ds = FusionDataset(pair, scan)
    fn = make_fuse_fn(method)
    z0, b, c = PIPE_PLANE
    rows = []
    for i in range(len(ds)):
        s = ds[i]
        mc, _, pc, _ = fuse_view(s, fn, (0.5,), torch.device(device))
        mc, pc = mc.cpu().numpy(), pc.cpu().numpy()
        agree = pt_err = None
        if i in PIPE_CPU_FUSE_VIEWS:
            mk, _, pk, _ = fuse_view(s, fn, (0.5,), torch.device("cpu"))
            mk, pk = mk.numpy(), pk.numpy()
            both = mc & mk
            agree = float((mc == mk).mean())
            pt_err = float((np.abs(pc[both] - pk[both]).max(axis=1)
                            / np.linalg.norm(pk[both], axis=1)).max(initial=0.0))
        h, w = mc.shape
        interior = mc[h // 8:h - h // 8, w // 8:w - w // 8]
        inner = np.zeros_like(mc)
        inner[h // 8:h - h // 8, w // 8:w - w // 8] = True
        x, y, z = pc[mc & inner].T  # border pixels may average in a blended source sample
        plane = z0 + b * x + c * y
        rows.append(dict(view=s["ref_id"], kept_interior=float(interior.mean()),
                         mask_agree=agree, point_rel_err=pt_err,
                         plane_rel_err=float((np.abs(z - plane) / plane).max(initial=0.0))))
    return rows


def subphase_clock(first):
    """A clock for a phase's subphases: `mark(label)` prints the wall
    seconds of the subphase that ends there (`first` the one that starts
    with the clock) and starts `label` (None: the last has ended)."""
    last = [time.perf_counter(), first]

    def mark(label):
        now = time.perf_counter()
        print(f"{last[1]}: {now - last[0]:.1f} s", flush=True)
        last[0], last[1] = now, label
    return mark


def pipeline_phase(torch, card, specs, device="cuda"):
    """Phase 11, the DTU test pipeline, on the card (`device`). Returns its
    details."""
    import shutil

    import numpy as np

    from mvsformer_torch.config import ModelConfig
    from mvsformer_torch.data.eval_dataset import MVSEvalDataset
    from mvsformer_torch.data.loader import collate
    from mvsformer_torch.fuse import fuse_scan
    from mvsformer_torch.infer import STAGES, make_infer_fn, save_depth
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.ops import cuda_build
    from mvsformer_torch.utils.image import read_image
    from mvsformer_torch.utils.pfm import read_pfm

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "pipeline")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.cuda.reset_peak_memory_stats()
    try:
        subphase = subphase_clock("11a")
        # 11a. The scan, and the PNG decode of one 1600x1200 image.
        t0 = time.perf_counter()
        data = write_dtu_scan(root)
        write_s = time.perf_counter() - t0
        png = os.path.join(data, "scan1", "images", "00000000.jpg")
        host, filters = host_steps(png, root)
        decode_ms = host["decode"]
        print(f"pipeline scan: {PIPE_VIEWS} views of {PIPE_IMG_HW[1]}x{PIPE_IMG_HW[0]} PNG "
              f"({os.path.getsize(png) / 1e6:.2f} MB each), written in {write_s:.1f} s; host ms "
              f"per view: " + ", ".join(f"{k} {v:.1f}" for k, v in host.items())
              + f"; the adaptive copy's rows by filter (None, Sub, Up, Average, Paeth): "
              f"{filters} [{card}]", flush=True)

        subphase("11b")
        # 11b. save_depth on the card at the default ModelConfig, every launch
        # count set to 0 just before it and read just after.
        model = build_model(ModelConfig(), device=device)
        random_init_(model, torch.Generator().manual_seed(0))
        out = os.path.join(root, "out")
        kw = dict(num_view=PIPE_NUM_VIEW, ndepths=NDEPTH_FULL, max_h=H, max_w=W,
                  device=device, logger=lambda *a: None)
        timings = []
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        metrics = save_depth(model, ["scan1"], data, out, timings=timings, **kw)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        for name, spec in specs.items():
            want = PIPE_VIEWS * spec["per_request"]
            if launches.get(name, 0) != want:
                raise RuntimeError(f"{name}: {launches.get(name, 0)} launches in save_depth's "
                                   f"{PIPE_VIEWS} requests, want {want}")
        print(f"save_depth launches over {PIPE_VIEWS} requests: "
              + ", ".join(f"{n} {launches.get(n, 0)}" for n in specs)
              + f" ({PIPE_VIEWS} x per request)")
        for i, t in enumerate(timings):
            print(f"save_depth request {i}: load {t['load_ms']:.1f} ms, forward {t['forward_ms']:.1f}"
                  f" ms, writes {t['write_ms']:.1f} ms [{card}]")
        mean = {k: sum(t[k] for t in timings) / len(timings) for k in timings[0]}
        print(f"save_depth: {total_s:.2f} s for {PIPE_VIEWS} requests, mean load "
              f"{mean['load_ms']:.1f} / forward {mean['forward_ms']:.1f} / writes "
              f"{mean['write_ms']:.1f} ms, depth metrics {json.dumps(metrics)} [{card}]", flush=True)
        if metrics is None or len(metrics) != 7:
            raise RuntimeError("save_depth wrote no depth metrics for a scan with ground truth")

        subphase("11c")
        # 11c. The same save_depth under torch.profiler: the device's idle share.
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            save_depth(model, ["scan1"], data, os.path.join(root, "out_profiled"), **kw)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, _ = kernel_times(torch, prof)
        if busy_ms is None:
            idle = None
            print(f"profiled save_depth: {prof_wall_ms:.1f} ms wall; device idle share not "
                  f"measured (the profiler saw no device events)")
        else:
            idle = max(0.0, 1 - busy_ms / prof_wall_ms)
            print(f"profiled save_depth: {prof_wall_ms:.1f} ms wall, {busy_ms:.1f} ms of kernels, "
                  f"device idle share {idle:.3f} [{card}]", flush=True)

        path_peak_gb = torch.cuda.max_memory_allocated() / 1e9

        subphase("11d")
        # 11d. View 0 on disk against make_infer_fn on the same sample. With
        # cuDNN free to pick its algorithms the forward varies from run to run
        # (the bound is the card-to-CPU one); the op that varies is found by
        # hooks; with cudnn.deterministic both runs and the saved view must
        # agree bit for bit.
        ds = MVSEvalDataset(data, ["scan1"], nviews=PIPE_NUM_VIEW, ndepths=NDEPTH_FULL,
                            interval_scale=1.06, max_h=H, max_w=W)
        batch = collate([ds[0]])
        inputs = (batch["imgs"], {k: batch["proj_matrices"][k] for k in STAGES},
                  batch["depth_values"])
        infer = make_infer_fn(model)

        def view0(folder):
            return (read_pfm(os.path.join(folder, "scan1", "depth_est", "00000000.pfm"))[0],
                    np.load(os.path.join(folder, "scan1", "confidence", "00000000.npy")))

        def gaps(a, b):
            return tuple(float(np.abs(np.asarray(x) - np.asarray(y)).max())
                         for x, y in zip(a, b))

        def run_infer():
            d, c, _ = infer(*inputs)
            return d[0].cpu().numpy(), c[0].cpu().numpy()

        first = run_infer()
        saved = gaps(view0(out), first)
        rerun = gaps(run_infer(), first)
        varying = first_varying_module(torch, model, infer, inputs)
        print(f"view 0 saved against make_infer_fn: depth {saved[0]:.3e}, confidence "
              f"{saved[1]:.3e}; make_infer_fn run twice on it: depth {rerun[0]:.3e}, "
              f"confidence {rerun[1]:.3e} (tolerance {E2E_DEPTH_ATOL:g}, {E2E_CONF_ATOL:g}); "
              f"the first op whose output varies between two forwards: {varying}", flush=True)
        if max(saved[0], rerun[0]) > E2E_DEPTH_ATOL or max(saved[1], rerun[1]) > E2E_CONF_ATOL:
            raise RuntimeError("save_depth's view 0 disagrees with make_infer_fn")
        det_timings = []
        torch.backends.cudnn.deterministic = True
        try:
            save_depth(model, ["scan1"], data, os.path.join(root, "out_deterministic"),
                       timings=det_timings, **kw)
            det_first = run_infer()
            det_saved = gaps(view0(os.path.join(root, "out_deterministic")), det_first)
            det_rerun = gaps(run_infer(), det_first)
        finally:
            torch.backends.cudnn.deterministic = False
        det_forward = [t["forward_ms"] for t in det_timings]
        print(f"with cudnn.deterministic: view 0 saved against make_infer_fn: depth "
              f"{det_saved[0]:.3e}, confidence {det_saved[1]:.3e}; make_infer_fn run twice: "
              f"depth {det_rerun[0]:.3e}, confidence {det_rerun[1]:.3e} (exact expected); "
              f"save_depth forward ms " + ", ".join(f"{t:.1f}" for t in det_forward)
              + f" [{card}]", flush=True)
        if max(det_saved + det_rerun) != 0:
            raise RuntimeError("with cudnn.deterministic, save_depth's view 0 and make_infer_fn "
                               "are not bit-equal")
        del model, infer, inputs
        torch.cuda.empty_cache()

        subphase("11e")
        # 11e. save_depth on the card against the CPU, small shape.
        ok, small_errs = save_depth_card_vs_cpu(torch, root, device)
        print(f"save_depth {PIPE_SMALL['max_hw']} on the card against the CPU: "
              + ", ".join(f"{k} {v:.3e}" for k, v in small_errs.items())
              + f" (tolerance depth {E2E_DEPTH_ATOL:g}, confidence {E2E_CONF_ATOL:g}, "
              f"depth_metric {PIPE_METRIC_ATOL:g}, cams and images byte-equal) "
              + ("ok" if ok else "FAILED"), flush=True)
        if not ok:
            raise RuntimeError("save_depth on the card disagrees with the CPU")

        subphase("11f")
        # 11f. Fusion of the plane's exact depths, card against CPU, then
        # fuse_scan on the card (timed per view).
        pair = os.path.join(data, "scan1")
        plane = plane_folder(os.path.join(out, "scan1"), os.path.join(root, "plane"))
        fusion = {}
        for method in PIPE_METHODS:
            rows = fusion_card_vs_cpu(torch, pair, plane, method, device)
            view_ms = []
            n = fuse_scan(pair, plane, os.path.join(root, f"plane_{method}.ply"), method=method,
                          device=device, logger=lambda *a: None, timings=view_ms)
            keep = min(r["kept_interior"] for r in rows)
            agree = min(r["mask_agree"] for r in rows if r["mask_agree"] is not None)
            pt = max(r["point_rel_err"] for r in rows if r["point_rel_err"] is not None)
            off = max(r["plane_rel_err"] for r in rows)
            print(f"fusion {method} of the plane, card against CPU (views "
                  f"{list(PIPE_CPU_FUSE_VIEWS)}): kept share of the interior "
                  f"{keep:.4f} (min over views; > {PIPE_KEEP_MIN}), mask agreement {agree:.6f} "
                  f"(>= {PIPE_MASK_AGREE}), points {pt:.2e} of |point| (<= {PIPE_POINT_RTOL:g}), "
                  f"off the plane {off:.2e} of its depth (<= {PIPE_PLANE_RTOL:g}); {n} points",
                  flush=True)
            print(f"fusion {method} ms per reference view (load, fuse): "
                  + ", ".join(f"{t['load_ms']:.1f}/{t['fuse_ms']:.1f}" for t in view_ms)
                  + f" [{card}]")
            if keep <= PIPE_KEEP_MIN or agree < PIPE_MASK_AGREE or pt > PIPE_POINT_RTOL \
                    or off > PIPE_PLANE_RTOL or n == 0:
                raise RuntimeError(f"fusion {method} of the plane failed its checks: {rows}")
            fusion[method] = dict(views=rows, view_ms=view_ms, points=n)

        subphase("11g")
        # 11g. Fusion of the random weights' depth maps, as a smoke run. Their
        # confidences lie far below the default threshold of 0.5, so the
        # consistency check alone decides here.
        smoke = {}
        for method in PIPE_METHODS:
            ply = os.path.join(root, f"random_{method}.ply")
            smoke[method] = fuse_scan(pair, os.path.join(out, "scan1"), ply, method=method,
                                      prob_threshold=(0.0,), device=device,
                                      logger=lambda *a: None)
            if not os.path.exists(ply):
                raise RuntimeError(f"fusion {method}: no PLY")

        subphase("11h")
        # 11h. JPEG: the host decoder on every committed fixture against its
        # cv2 decode, its time beside 11a's PNG decode, and 4 threads at once.
        jpeg_details = jpeg_checks(card, decode_ms)
        subphase(None)
        print("fusion of the random weights' depths (confidence threshold 0): "
              + ", ".join(f"{m} {n} points" for m, n in smoke.items()))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"pipeline phase peak memory {peak_gb:.3f} GB; over save_depth's two runs "
              f"(11b, 11c) {path_peak_gb:.3f} GB [{card}]", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"requests": timings, "save_depth_s": total_s, "launches": launches,
            "host_ms_per_view": host, "adaptive_filters": filters, "view0_rerun": rerun, "first_varying_op": varying,
            "metrics": metrics, "profiled_wall_ms": prof_wall_ms, "profiled_kernel_ms": busy_ms,
            "idle_share": idle, "view0": {"depth": saved[0], "confidence": saved[1]},
            "deterministic": {"view0": det_saved, "rerun": det_rerun,
                              "forward_ms": det_forward},
            "small_card_vs_cpu": small_errs, "fusion": fusion, "smoke_points": smoke,
            "png_decode_ms": decode_ms, "jpeg": jpeg_details, "peak_memory_gb": peak_gb,
            "save_depth_peak_memory_gb": path_peak_gb}


# The training run (phase 12): `python -m mvsformer_torch.train` with
# configs/config_mvsformer.json as it ships, on a synthetic DTU training
# tree of one scan (5 views x 7 lights of the tilted plane at 1600x1200,
# PNG rows with libpng's adaptive filters; 3 views listed as references,
# so 21 samples), then `--resume` for a second
# epoch, then `python -m mvsformer_torch.test --which_ckpt model_best`.
RUN_CONFIG = "configs/config_mvsformer.json"
# What the config must still give: batch, views, depths, crop sizes, loader
# threads, augmentation.
RUN_SHAPE = (8, 5, 192, 25, 4, True)
RUN_VIEWS = 5                  # the config's nviews: every reference has 4 sources
RUN_REFS = 3                   # x 7 lights: 21 samples, 2 steps of 8 (5 dropped), 3 val batches
DTU_LIGHTS = 7                 # the lights `data/dtu.py` reads for every view
RUN_PROFILE = (1, 1)           # --profile_start, --profile_steps
RUN_TIMEOUT_S = 900
# Launches per validation batch (K1-K6) and per training micro-batch (K7, K8).
EVAL_PER_BATCH = {"warp_group_corr": 4, "visibility_net": 4, "depth_decode": 4,
                  "encoder_head": 1, "fpn_level": 3, "gsa_attention": 9}
TRAIN_PER_MICRO = {"warp_corr_fwd": 4, "warp_corr_bwd": 4}


def write_dtu_train_tree(root, views, lights=DTU_LIGHTS, img_hw=None, seed=0, refs=None):
    """A DTU training tree under `root` in the layout `data/dtu.py` reads:
    Cameras/pair.txt (the first `refs` views, all by default, as references,
    every other view a source of each) and <vid>_cam.txt
    (intrinsics at the image's size; depth_min 425, interval 2.5),
    DTU_origin/Rectified/scan1/rect_<vid + 1>_<light>_r5000.png (the plane's
    texture, brighter by light, with noise; rows with libpng's adaptive
    filters; made and written on 8 threads), Depths_raw/scan1/
    depth_map_<vid>.pfm (the plane's depth) and depth_visual_<vid>.png (a
    mask without a 4% border). Returns the rectified images' rows by
    filter."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mvsformer_torch.utils.cams import CameraParams, write_cam_file
    from mvsformer_torch.utils.image import write_png
    from mvsformer_torch.utils.pfm import save_pfm

    h, w = img_hw or PIPE_IMG_HW
    f = PIPE_FOCAL * w / 1600
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    cams = os.path.join(root, "Cameras")
    rect = os.path.join(root, "DTU_origin", "Rectified", "scan1")
    raw = os.path.join(root, "Depths_raw", "scan1")
    for d in (cams, rect, raw):
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(cams, "pair.txt"), "w") as fp:
        fp.write(f"{refs or views}\n")
        for ref in range(refs or views):
            srcs = sorted((v for v in range(views) if v != ref), key=lambda v: abs(v - ref))
            fp.write(f"{ref}\n{len(srcs)} " + " ".join(f"{s} {100 - abs(s - ref)}" for s in srcs)
                     + "\n")
    def rectified(v, light):
        img, _ = plane_view(K, v * PIPE_BASELINE, h, w, np.random.default_rng((seed, v, light)),
                            gain=0.7 + 0.1 * light)
        return write_png_filtered(os.path.join(rect, f"rect_{v + 1:0>3}_{light}_r5000.png"), img)

    mask = plane_mask(h, w)
    with ThreadPoolExecutor(8) as pool:
        jobs = [pool.submit(rectified, v, light) for v in range(views) for light in range(lights)]
        for v in range(views):
            ext = np.eye(4, dtype=np.float32)
            ext[0, 3] = v * PIPE_BASELINE
            write_cam_file(os.path.join(cams, f"{v:0>8}_cam.txt"),
                           CameraParams(ext, K.astype(np.float32), 425.0, 2.5, 192.0))
            save_pfm(os.path.join(raw, f"depth_map_{v:0>4}.pfm"),
                     plane_depth(K, v * PIPE_BASELINE, h, w))
            write_png(os.path.join(raw, f"depth_visual_{v:0>4}.png"), mask)
        counts = [job.result() for job in jobs]
    return [sum(c[i] for c in counts) for i in range(5)]


def run_cli(module, args, log_name, timeout=RUN_TIMEOUT_S):
    """`python -m <module> <args>` from the repo's root; its output goes to
    chiprun_out/<log_name>.log. Raises if it fails. Returns its seconds."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", module] + args, cwd=here, capture_output=True,
                         text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    with open(os.path.join(here, "chiprun_out", f"{log_name}.log"), "w") as f:
        f.write(res.stdout + "\n--- stderr ---\n" + res.stderr)
    if res.returncode != 0:
        print(res.stdout[-3000:] + res.stderr[-6000:], file=sys.stderr)
        raise RuntimeError(f"python -m {module} {' '.join(args)} exited {res.returncode}")
    return seconds


def read_records(run_dir):
    with open(os.path.join(run_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def record_calls(torch, specs, fn, *args):
    """Run fn(*args) with each kernel of `specs` wrapped where its owner
    module calls it; returns ({name: [(args, kwargs)]}, fn's result)."""
    recorded = {name: [] for name in specs}
    originals = {name: getattr(spec["owner"], name) for name, spec in specs.items()}

    def recorder(name):
        def wrapped(*a, **k):
            recorded[name].append((a, k))
            return originals[name](*a, **k)
        return wrapped

    for name, spec in specs.items():
        setattr(spec["owner"], name, recorder(name))
    try:
        out = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        for name, spec in specs.items():
            setattr(spec["owner"], name, originals[name])
    return recorded, out


def check_epoch_records(recs, epoch, crops, steps, card, validated=True):
    """The records of one epoch of the CLI: its steps (finite losses, the
    barrels' crop sizes, K7/K8 4 times a micro-batch and K1-K6 never), its
    validation where `validated` (K1-K6 at their per-batch counts; none
    otherwise) and its checkpoints. Prints the per-step, validation and
    checkpoint lines; returns the epoch's records by kind."""
    import math

    mine = {kind: [r for r in recs if r.get("epoch") == epoch and r["kind"] == kind]
            for kind in ("step", "train_epoch", "val")}
    mine["checkpoint"] = [r for r in recs if r["kind"] == "checkpoint"
                          and steps[0] <= r["global_step"] <= steps[-1]]
    got = [r["global_step"] for r in mine["step"]]
    if got != list(steps):
        raise RuntimeError(f"epoch {epoch}: steps {got}, want {list(steps)}")
    for i, r in enumerate(mine["step"]):
        if not all(math.isfinite(r[k]) for k in r if k.startswith("loss")):
            raise RuntimeError(f"epoch {epoch} step {r['global_step']}: non-finite loss {r}")
        if r["crop"] != list(crops[i]):
            raise RuntimeError(f"step {r['global_step']}: crop {r['crop']}, want {crops[i]}")
        want = {name: n * r["micro_batches"] for name, n in TRAIN_PER_MICRO.items() if n}
        if r["launches"] != want:
            raise RuntimeError(f"step {r['global_step']}: launches {r['launches']}, want {want}")
        print(f"training run epoch {epoch} step {r['global_step']}: {r['ms']:.1f} ms, crop "
              f"{r['crop'][0]}x{r['crop'][1]}, {r['micro_batches']} micro-batches, waited "
              f"{r['wait_ms']:.1f} ms on the loader, loss {r['loss']:.5f}, lr {r['lr']:.4e} "
              f"[{card}]")
    ep, val = mine["train_epoch"][0], mine["val"]
    if len(val) != int(validated):
        raise RuntimeError(f"epoch {epoch}: {len(val)} validations, want {int(validated)}")

    def gb(x):
        return "not measured" if x is None else f"{x:.2f} GB"

    text = "no validation"
    if validated:
        val = val[0]
        n_val = len(val["batch_ms"])
        want = {name: n * n_val for name, n in EVAL_PER_BATCH.items() if n}
        if val["launches"] != want:
            raise RuntimeError(f"epoch {epoch} validation: launches {val['launches']}, "
                               f"want {want}")
        text = (f"validation {n_val} batches at " + ", ".join(f"{t:.1f}" for t in val["batch_ms"])
                + f" ms, load {val['load_ms_per_sample']:.1f} ms per sample, peak memory "
                f"{gb(val['peak_memory_gb'])}, mean_error {val['mean_error']:.5f}")
    print(f"training run epoch {epoch}: load {ep['load_ms_per_sample']:.1f} ms per training "
          f"sample ({ep['samples_loaded']} read), peak memory {gb(ep['peak_memory_gb'])}; "
          f"{text} [{card}]")
    for c in mine["checkpoint"]:
        print(f"training run checkpoint {c['name']} at step {c['global_step']}: "
              f"{c['ms']:.1f} ms, {c['bytes'] / 1e6:.1f} MB [{card}]")
    return mine


def training_run_phase(torch, card, eval_specs, device="cuda"):
    """Phase 12 on the card (`device`). Returns its details, with each
    kernel's checked launches under "rows" and its launches in the CLI runs
    under "launches"."""
    import math
    import shutil

    import numpy as np

    from mvsformer_torch.config import load_config, save_config
    from mvsformer_torch.data.dtu import DTUMVSDataset
    from mvsformer_torch.data.eval_dataset import MVSEvalDataset
    from mvsformer_torch.data.loader import MVSLoader, collate
    from mvsformer_torch.infer import STAGES, make_infer_fn
    from mvsformer_torch.models.mvsformer import build_model
    from mvsformer_torch.ops import cuda_build
    from mvsformer_torch.train.optim import warmup_cosine_factor
    from mvsformer_torch.train.trainer import Trainer
    from mvsformer_torch.utils.convert_weights import load_reference_checkpoint
    from mvsformer_torch.utils.pfm import read_pfm

    train_specs = train_kernel_specs(per_step=None)
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "training_run")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        subphase = subphase_clock("12a")
        # 12a. The tree and the config as it ships, but for the paths and the run's length.
        t0 = time.perf_counter()
        data = os.path.join(root, "dtu")
        filters = write_dtu_train_tree(data, RUN_VIEWS, refs=RUN_REFS)
        listfile = os.path.join(root, "scans.txt")
        with open(listfile, "w") as f:
            f.write("scan1\n")
        cfg = load_config(os.path.join(here, RUN_CONFIG))
        msa = cfg.data.multi_scale_args
        if (cfg.data.batch_size, cfg.data.nviews, cfg.data.num_depths, len(msa.scales),
                cfg.data.num_workers, cfg.data.augment) != RUN_SHAPE:
            raise RuntimeError(f"{RUN_CONFIG} no longer gives the training run this phase holds")
        steps = RUN_REFS * DTU_LIGHTS // cfg.data.batch_size
        cli_device = [] if device == "cuda" else ["--device", device]
        cfg.data.datapath = data
        cfg.data.train_data_list = cfg.data.val_data_list = listfile
        cfg.trainer.epochs, cfg.trainer.save_every_steps, cfg.trainer.logging_every = 1, 2, 1
        cfg.trainer.save_dir = os.path.join(root, "saved")
        run_dir = os.path.join(cfg.trainer.save_dir, "models", cfg.name)
        config1, config2 = os.path.join(root, "run1.json"), os.path.join(root, "run2.json")
        save_config(cfg, config1)
        # The resumed epoch skips its validation (epoch 1's runs the same code).
        cfg.trainer.epochs, cfg.trainer.eval_freq = 2, 3
        save_config(cfg, config2)
        print(f"training run tree: {RUN_VIEWS} views x {DTU_LIGHTS} lights ({RUN_REFS} "
              f"references) of "
              f"{PIPE_IMG_HW[1]}x{PIPE_IMG_HW[0]} PNG, written in {time.perf_counter() - t0:.1f} s; "
              f"rows by filter (None, Sub, Up, Average, Paeth): {filters}", flush=True)

        subphase("12b")
        # 12b. Epoch 1 through the CLI, its profile window, then epoch 2 by
        # --resume beside 12d's test CLI on epoch 1's model_best (the resumed
        # epoch does not validate, so it leaves model_best as it was).
        pdir = os.path.join(root, "profile")
        run1_s = run_cli("mvsformer_torch.train", [
            "--config", config1, "--profile_dir", pdir, "--profile_start", str(RUN_PROFILE[0]),
            "--profile_steps", str(RUN_PROFILE[1])] + cli_device, "training_run_1")
        eval_data = write_jpeg_scan(os.path.join(root, "eval"))
        out = os.path.join(root, "test_out")
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            run2 = pool.submit(run_cli, "mvsformer_torch.train",
                               ["--config", config2, "--resume"] + cli_device, "training_run_2")
            test = pool.submit(run_cli, "mvsformer_torch.test", [
                "--testpath", eval_data, "--testlist", listfile, "--ckpt_dir", run_dir,
                "--which_ckpt", "model_best", "--outdir", out, "--skip_fusion", "--max_h",
                str(H), "--max_w", str(W), "--ndepths", str(NDEPTH_FULL), "--num_view",
                str(PIPE_NUM_VIEW)] + cli_device, "training_run_test")
            run2_s, test_s = run2.result(), test.result()
        recs = read_records(run_dir)
        crops = [tuple(msa.scales[::-1][i % len(msa.scales)]) for i in range(steps)]
        epochs = {e: check_epoch_records(recs, e, crops,
                                         range(1 + (e - 1) * steps, 1 + e * steps), card,
                                         validated=e == 1)
                  for e in (1, 2)}
        names = {c["name"] for c in epochs[1]["checkpoint"]}
        if names != {"model_step", "model_best", "model_last"}:
            raise RuntimeError(f"epoch 1 saved {sorted(names)}")
        for name in names:
            for ext in (".pth", ".meta.json"):
                if not os.path.isfile(os.path.join(run_dir, name + ext)):
                    raise RuntimeError(f"no {name}{ext} in the run dir")
        resume = [r for r in recs if r["kind"] == "resume"]
        want = {"kind": "resume", "name": "model_last", "global_step": steps,
                "start_epoch": 2, "skip_batches": 0}
        if resume != [want]:
            raise RuntimeError(f"resume records {resume}, want [{want}]")
        first_lr = epochs[2]["step"][0]["lr"]
        want_lr = cfg.optimizer.lr * warmup_cosine_factor(
            steps, cfg.optimizer.warmup_steps, 2 * steps, cfg.optimizer.min_lr)
        if not math.isclose(first_lr, want_lr, rel_tol=1e-9):
            raise RuntimeError(f"the resumed run's first LR {first_lr}, want schedule({steps}) "
                               f"{want_lr}")
        profile = [r for r in recs if r["kind"] == "profile"]
        if len(profile) != 1 or profile[0]["steps"] != RUN_PROFILE[1]:
            raise RuntimeError(f"profile records {profile}")
        profile = profile[0]
        idle = ("not measured (the profiler saw no device events)"
                if profile["idle_share"] is None else f"{profile['idle_share']:.3f}")
        print(f"training run: epoch 1 in {run1_s:.1f} s, --resume (epoch 2) in {run2_s:.1f} s; "
              f"resumed at epoch 2, global step {steps}, first LR {first_lr:.4e} = "
              f"schedule({steps}); profile window of steps {profile['first_step'] + 1}-"
              f"{profile['first_step'] + profile['steps']}: {profile['wall_ms']:.1f} ms wall, "
              f"{profile['kernel_ms'] or 0:.1f} ms of kernels, device idle share {idle} [{card}]",
              flush=True)

        subphase("12c")
        # 12c. model_last restored in this process equals the file bit for bit.
        class Epoch:
            def __len__(self):
                return steps

        trainer = Trainer(cfg, Epoch(), device=device,
                          logger=type("Quiet", (), {"info": lambda s, m: None})())
        trainer.init_state()
        trainer.restore("model_last")
        saved = torch.load(os.path.join(run_dir, "model_last.pth"), map_location="cpu",
                           weights_only=False)
        def same(a, b):
            return bit_equal(torch, a.cpu().reshape(-1), b.reshape(-1))

        unequal = [k for k, v in trainer.model.state_dict().items()
                   if not same(v, saved["state_dict"][k])]
        opt = trainer.optimizer.state_dict()["state"]
        for i, st in saved["optimizer"]["state"].items():
            unequal += [f"optimizer {i} {k}" for k in ("exp_avg", "exp_avg_sq", "step")
                        if not same(opt[i][k], st[k])]
        if unequal or len(opt) != len(saved["optimizer"]["state"]):
            raise RuntimeError(f"restored state differs from model_last: {unequal[:8]}")
        print(f"model_last restored: {len(saved['state_dict'])} tensors (parameters and BN "
              f"buffers) and the AdamW moments of {len(opt)} tensors bit-equal to the file")

        subphase("12d")
        # 12d. The test CLI's files (12b ran it on the committed JPEG scan),
        # against make_infer_fn. First the dataset's samples of the JPEG scan
        # against those of its PNG twin (the committed cv2 decodes), bit for
        # bit; then the CLI's launches. The CLI computes in bf16, its
        # default: make_infer_fn of the bf16 model.
        twin = write_jpeg_scan(os.path.join(root, "eval_png"), png_twin=True)
        ds = MVSEvalDataset(eval_data, ["scan1"], nviews=PIPE_NUM_VIEW, ndepths=NDEPTH_FULL,
                            interval_scale=1.06, max_h=H, max_w=W)
        ds_png = MVSEvalDataset(twin, ["scan1"], nviews=PIPE_NUM_VIEW, ndepths=NDEPTH_FULL,
                                interval_scale=1.06, max_h=H, max_w=W)
        unequal = []
        for i in (0, len(ds) - 1):  # between them every view of the scan
            a, b = collate([ds[i]]), collate([ds_png[i]])
            for k in ("imgs", "depth_values", "depth_gt", "mask"):
                if not np.array_equal(a[k], b[k]):
                    unequal.append(f"{i} {k}")
            unequal += [f"{i} {k}" for k in a["proj_matrices"]
                        if not np.array_equal(a["proj_matrices"][k], b["proj_matrices"][k])]
        scan_h, scan_w = jpeg_manifest()["scan_hw"]
        print(f"JPEG scan ({len(ds)} views, {scan_w}x{scan_h} resized to {W}x{H}): the eval "
              f"dataset's samples 0 and {len(ds) - 1} against its PNG twin's: "
              + ("bit-equal" if not unequal else f"DIFFER in {unequal}"), flush=True)
        if unequal:
            raise RuntimeError("the eval dataset reads the JPEG scan otherwise than its PNG twin")
        cli_counts = check_cli_launches("training_run_test", eval_specs, len(ds))
        print(f"test CLI launches over {len(ds)} requests: {json.dumps(cli_counts)} "
              f"({len(ds)} x per request)", flush=True)
        best = build_model(cfg.arch, device=device, dtype=torch.bfloat16)
        load_reference_checkpoint(os.path.join(run_dir, "model_best.pth"), best)
        sample = collate([ds[0]])
        depth, conf, _ = make_infer_fn(best)(
            sample["imgs"], {k: sample["proj_matrices"][k] for k in STAGES},
            sample["depth_values"])
        gap_d = float(np.abs(read_pfm(os.path.join(out, "scan1", "depth_est", "00000000.pfm"))[0]
                             - depth[0].cpu().numpy()).max())
        gap_c = float(np.abs(np.load(os.path.join(out, "scan1", "confidence", "00000000.npy"))
                             - conf[0].cpu().numpy()).max())
        print(f"test CLI on model_best ({test_s:.1f} s beside the resumed run, bf16): view 0 "
              f"against make_infer_fn of "
              f"the restored bf16 model: depth {gap_d:.3e}, confidence {gap_c:.3e} (tolerance "
              f"{E2E_DEPTH_ATOL:g}, {E2E_CONF_ATOL:g})", flush=True)
        if gap_d > E2E_DEPTH_ATOL or gap_c > E2E_CONF_ATOL:
            raise RuntimeError("the test CLI's view 0 disagrees with make_infer_fn")
        del best, depth, conf
        torch.cuda.empty_cache()

        subphase("12e")
        # 12e. The kernels at the run's new shapes: one validation batch (B=8,
        # 512x640) and one training micro-batch at 1024x1280.
        dkw = dict(nviews=cfg.data.nviews, ndepths=cfg.data.num_depths,
                   interval_scale=cfg.data.interval_scale, crop=cfg.data.crop,
                   augment=cfg.data.augment, aug_args=vars(cfg.data.aug_args),
                   height=cfg.data.height, width=cfg.data.width, multi_scale=True,
                   multi_scale_args={"scales": msa.scales, "resize_range": msa.resize_range},
                   resize_scale=cfg.data.resize_scale, batch_size=cfg.data.batch_size)
        val_batch = next(iter(MVSLoader(DTUMVSDataset(data, listfile, "val", **dkw),
                                        cfg.data.batch_size, shuffle=False, drop_last=False)))
        train_ds = DTUMVSDataset(data, listfile, "train", **dkw)
        train_ds.reset_dataset(np.arange(len(train_ds)))  # barrel 0: the largest crop
        micro = collate([train_ds[0]])
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        trainer.model.eval()
        val_calls, _ = record_calls(torch, eval_specs, trainer._eval_forward, val_batch)
        train_calls, _ = record_calls(torch, train_specs, trainer.step,
                                      trainer._train_batch(micro))
        rows = {}
        vb, _, vh, vw, _ = val_batch["imgs"].shape
        for name, calls in list(val_calls.items()) + list(train_calls.items()):
            spec = eval_specs.get(name) or train_specs[name]
            want = spec["per_request"] if name in eval_specs else len(cfg.arch.ndepths)
            if len(calls) != want:
                raise RuntimeError(f"{name}: recorded {len(calls)} calls, want {want}")
            shape = (f"val B={vb} {vh}x{vw}" if name in eval_specs
                     else f"micro-batch {micro['imgs'].shape[2]}x{micro['imgs'].shape[3]}")
            rows[name] = [check_kernel(torch, card, name, spec,
                                       f"{shape} {call_label(name, i, args)}", args, kwargs)
                          for i, (args, kwargs) in enumerate(calls)]
        del val_calls, train_calls

        subphase("12f")
        # 12f. The crop sweep: at each crop size one training micro-batch of 1
        # sample and one eval forward of 1 sample, all outputs finite.
        sweep = []
        infer = make_infer_fn(trainer.model)
        for h, w in msa.scales[::-2]:  # every other crop size, from the largest
            cuda_build.reset_launches()
            t0 = time.perf_counter()
            metrics = trainer.step(synthetic_batch(torch, 1, cfg.data.nviews, h, w, device=device,
                                                   with_gt=True))
            torch.cuda.synchronize()
            train_ms = (time.perf_counter() - t0) * 1e3
            bad = [n for n, p in trainer.model.named_parameters()
                   if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
            trainer.model.eval()
            t0 = time.perf_counter()
            d, c, _ = infer(*synthetic_request(torch, 1, cfg.data.nviews, h, w, device=device))
            torch.cuda.synchronize()
            eval_ms = (time.perf_counter() - t0) * 1e3
            counts = dict(cuda_build.LAUNCHES)
            want = {n: c for n, c in dict(TRAIN_PER_MICRO, **EVAL_PER_BATCH).items() if c}
            if not math.isfinite(metrics["loss"]) or bad or not (
                    bool(torch.isfinite(d).all()) and bool(torch.isfinite(c).all())):
                raise RuntimeError(f"crop {h}x{w}: non-finite loss, gradients {bad[:4]} or outputs")
            if counts != want:
                raise RuntimeError(f"crop {h}x{w}: launches {counts}, want {want}")
            sweep.append({"crop": [h, w], "train_ms": train_ms, "eval_ms": eval_ms,
                          "loss": metrics["loss"]})
        subphase(None)
        print(f"crop sweep, 1 sample, {cfg.data.nviews} views (training micro-batch ms / eval "
              "forward ms): "
              + ", ".join(f"{r['crop'][0]}x{r['crop'][1]} {r['train_ms']:.0f}/{r['eval_ms']:.0f}"
                          for r in sweep) + f"; all finite [{card}]", flush=True)
        launches = dict(cli_counts)
        for r in recs:
            for name, n in r.get("launches", {}).items():
                launches[name] = launches.get(name, 0) + n
        details = {"records": recs, "run_s": [run1_s, run2_s], "test_cli_s": test_s,
                   "test_cli_launches": cli_counts, "jpeg_scan_vs_png_twin": unequal,
                   "view0_gap": [gap_d, gap_c], "profile": profile, "sweep": sweep,
                   "rows_by_filter": filters, "first_lr": first_lr}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"rows": rows, "launches": launches, "details": details}



# DINOMVSNet (phase 13): configs/config_mvsformer-p.json's model served and
# trained as phases 4-11 serve and train TwinMVSNet.
DINO_CONFIG = "configs/config_mvsformer-p.json"
# The -p config's arch as this phase holds it: vit_small (384 wide, 12
# blocks, 6 heads, patch 16) on the 0.5x images, the attention fusion, fix.
DINO_ARCH = ("dino", "vit_small", 16, 0.5, True, True, [32, 16, 8, 4], [8, 16, 32, 64], "ce")


def dino_phase(torch, card, eval_specs, device="cuda"):
    """Phase 13. `eval_specs`: phase 4's K1-K6 specs; DINOMVSNet launches
    K6 no time. Returns {"rows": K1-K5's checked launches, "launches": one
    request's and one training step's counts, "details"}."""
    import copy
    import math
    import shutil

    import numpy as np

    from mvsformer_torch.config import load_config, save_config
    from mvsformer_torch.data.eval_dataset import MVSEvalDataset
    from mvsformer_torch.data.loader import collate
    from mvsformer_torch.infer import STAGES, make_infer_fn
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.ops import cuda_build
    from mvsformer_torch.train.step import TrainStep
    from mvsformer_torch.utils.pfm import read_pfm

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(here, DINO_CONFIG))
    arch, va = cfg.arch, cfg.arch.vit_args
    if (arch.model_type, va.vit_arch, va.patch_size, va.rescale, va.att_fusion, arch.fix,
            arch.ndepths, arch.feat_chs, arch.depth_type) != DINO_ARCH:
        raise RuntimeError(f"{DINO_CONFIG} no longer gives the model this phase holds")
    specs = {n: dict(s, per_request=0 if n == "gsa_attention" else s["per_request"])
             for n, s in eval_specs.items()}

    # 13a. The model.
    t0 = time.perf_counter()
    model = build_model(arch, device=device)
    random_init_(model, torch.Generator().manual_seed(0))
    vit = model.vit
    print(f"DINOMVSNet ({DINO_CONFIG}): {va.vit_arch} {vit.embed_dim} wide, "
          f"{len(vit.blocks)} blocks, {vit.num_heads} heads, patch {vit.patch_size}, fp32, "
          f"{sum(p.numel() for p in model.parameters())} parameters, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    request = synthetic_request(torch, B, V, H, W, device=device)
    fn = make_infer_fn(model, tmps=(5.0, 5.0, 5.0, 1.0))

    # 13b. The DTU request: one warm-up, then timed requests with the counts
    # set to 0 just before each and read just after.
    fn(*request)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], None
    for _ in range(N_REQUESTS):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        depth, conf, _ = fn(*request)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = dict(cuda_build.LAUNCHES)
        for name, spec in specs.items():
            if counts.get(name, 0) != spec["per_request"]:
                raise RuntimeError(f"DINO {name}: {counts.get(name, 0)} launches in a "
                                   f"request, want {spec['per_request']}")
        launches = launches or counts
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mean_s = sum(times) / len(times)
    print(f"DINO launches per request, the same in each of {N_REQUESTS}: {launches}")
    print("DINO requests: " + ", ".join(f"{t * 1e3:.2f}" for t in times)
          + f" ms; mean {mean_s * 1e3:.2f} ms, {B / mean_s:.4f} depth-maps/s, peak memory "
          f"{peak_gb:.3f} GB [{card}]", flush=True)
    layers = layer_breakdown(torch, model, fn, request)
    print("DINO layers (device ms, one request): " + json.dumps(
        {k: round(v, 3) for k, v in layers.items()}))
    busy_ms, wall_ms, top = device_busy(torch, fn, request)
    if busy_ms is None:
        print(f"DINO profiled request: {wall_ms:.2f} ms wall; device busy share not measured "
              f"(the profiler saw no device events)")
    else:
        print(f"DINO profiled request: {wall_ms:.2f} ms wall, {busy_ms:.2f} ms of kernels, "
              f"device idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} [{card}]")
        for name, t in top:
            print(f"  {t:9.3f} ms  {name[:110]}")

    # 13c-d. The outputs, and K1-K5 against their plain versions on the
    # tensors this forward fed them, at every launch of one request.
    recorded, _ = record_calls(torch, specs, fn, *request)
    print("DINO " + check_outputs(torch, depth, conf, recorded["depth_decode"],
                                  specs["depth_decode"]["kernel"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = {}
    for name, calls in recorded.items():
        if len(calls) != specs[name]["per_request"]:
            raise RuntimeError(f"DINO {name}: recorded {len(calls)} calls, "
                               f"want {specs[name]['per_request']}")
        if calls:
            rows[name] = [check_kernel(torch, card, name, specs[name],
                                       "DINO " + call_label(name, i, args), args, kwargs)
                          for i, (args, kwargs) in enumerate(calls)]
    del recorded

    # 13e. The __graft_entry__ request on the card and on the CPU.
    e2e = small_request_errors(torch, model, make_infer_fn)
    e2e_ok = all(e <= (E2E_DEPTH_ATOL if k == "refined_depth" else E2E_CONF_ATOL)
                 for k, e in e2e.items())
    print(f"DINO request {E2E_SHAPE} on the card against the CPU: max_abs_err "
          + ", ".join(f"{k} {e:.3e}" for k, e in e2e.items())
          + f" (tolerance depth {E2E_DEPTH_ATOL:g}, confidence {E2E_CONF_ATOL:g}) "
          + ("ok" if e2e_ok else "FAILED"), flush=True)
    if not e2e_ok:
        raise RuntimeError("the DINO forward on the card disagrees with the CPU forward")

    # 13g. The test CLI on the committed JPEG scan in the Tanks-and-Temples
    # layout (`--dataset tt`: images padded by 4 rows, cy shifted), from a
    # checkpoint in the reference's layout, against make_infer_fn on
    # MVSEvalDataset(dataset="tt").
    root = os.path.join(here, "build", "dino_pipeline")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        eval_data = write_jpeg_scan(os.path.join(root, "eval"))
        listfile = os.path.join(root, "scans.txt")
        with open(listfile, "w") as f:
            f.write("scan1\n")
        torch.save({"state_dict": model.state_dict()}, os.path.join(root, "dino.pth"))
        save_config(cfg, os.path.join(root, "config.json"))
        out = os.path.join(root, "test_out")
        test_s = run_cli("mvsformer_torch.test", [
            "--testpath", eval_data, "--testlist", listfile, "--ckpt_dir", root,
            "--torch_ckpt", os.path.join(root, "dino.pth"), "--outdir", out, "--skip_fusion",
            "--max_h", str(H), "--max_w", str(W), "--ndepths", str(NDEPTH_FULL),
            "--num_view", str(PIPE_NUM_VIEW), "--dtype", "fp32", "--dataset", "tt"]
            + ([] if device == "cuda" else ["--device", device]), "dino_test")
        ds = MVSEvalDataset(eval_data, ["scan1"], nviews=PIPE_NUM_VIEW, ndepths=NDEPTH_FULL,
                            interval_scale=1.06, max_h=H, max_w=W, dataset="tt")
        tt_counts = check_cli_launches("dino_test", specs, len(ds))
        sample = collate([ds[0]])
        d0, c0, _ = fn(sample["imgs"], {k: sample["proj_matrices"][k] for k in STAGES},
                       sample["depth_values"])
        gap_d = float(np.abs(read_pfm(os.path.join(out, "scan1", "depth_est", "00000000.pfm"))[0]
                             - d0[0].cpu().numpy()).max())
        gap_c = float(np.abs(np.load(os.path.join(out, "scan1", "confidence", "00000000.npy"))
                             - c0[0].cpu().numpy()).max())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"DINO test CLI, --dataset tt on the JPEG scan ({test_s:.1f} s; launches "
          f"{json.dumps(tt_counts)}, {len(ds)} x per request): view 0 against make_infer_fn: "
          f"depth {gap_d:.3e}, confidence {gap_c:.3e} (tolerance {E2E_DEPTH_ATOL:g}, "
          f"{E2E_CONF_ATOL:g})", flush=True)
    if gap_d > E2E_DEPTH_ATOL or gap_c > E2E_CONF_ATOL:
        raise RuntimeError("the test CLI's DINO view 0 disagrees with make_infer_fn")
    del model, fn, request, depth, conf, d0, c0
    torch.cuda.empty_cache()

    # 13f. Training at the JAX package's training shape, `fix` on.
    sbm = cfg.data.multi_scale_args.scale_batch_map
    if cfg.data.batch_size != TRAIN_B or int(sbm[str(TRAIN_H)]) != TRAIN_MICRO:
        raise RuntimeError(f"{DINO_CONFIG} no longer gives the training shape")
    n_micro = TRAIN_B // TRAIN_MICRO
    per_step = {n: (len(arch.ndepths) * n_micro if n in TRAIN_PER_MICRO else 0)
                for n in list(specs) + list(TRAIN_PER_MICRO)}
    model = build_model(arch, device=device, train=True)
    random_init_(model, torch.Generator().manual_seed(1))
    step = TrainStep(model, cfg, seed=0)
    vit_before = {k: v.clone() for k, v in model.vit.state_dict().items()}
    batch = synthetic_batch(torch, TRAIN_B, TRAIN_V, TRAIN_H, TRAIN_W, device=device,
                            with_gt=True)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_times, metrics, step_launches = [], [], None
    for _ in range(N_STEPS):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        metrics.append(step(batch))
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        counts = dict(cuda_build.LAUNCHES)
        if {n: counts.get(n, 0) for n in per_step} != per_step or set(counts) - set(per_step):
            raise RuntimeError(f"DINO training step launches {counts}, want {per_step}")
        step_launches = step_launches or counts
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mean_step = sum(step_times) / len(step_times)
    if not all(math.isfinite(v) for m in metrics for k, v in m.items() if k.startswith("loss")):
        raise RuntimeError("non-finite DINO training loss")
    bad = bad_gradients(torch, model)
    with_grad = [n for n, p in model.vit.named_parameters()
                 if p.requires_grad or p.grad is not None]
    moved = [k for k, v in model.vit.state_dict().items()
             if not bit_equal(torch, v, vit_before[k])]
    if bad or with_grad or moved:
        raise RuntimeError(f"DINO training: bad gradients {bad[:8]}, ViT tensors with a "
                           f"gradient {with_grad[:8]}, moved {moved[:8]}")
    print(f"DINO training ({TRAIN_B} as {n_micro} micro-batches of {TRAIN_MICRO}, {TRAIN_V} "
          f"views, {TRAIN_H}x{TRAIN_W}, {NDEPTH_FULL} depths, fix): steps "
          + ", ".join(f"{t * 1e3:.2f}" for t in step_times)
          + f" ms; mean {mean_step * 1e3:.2f} ms, {1 / mean_step:.4f} train-steps/s, peak memory "
          f"{train_peak_gb:.2f} GB; launches per step {step_launches}; loss "
          f"{metrics[-1]['loss']:.5f}; all {len(trainable)} trainable gradients finite and "
          f"non-zero (but those zero in exact arithmetic: {zero_gradients(torch, model)}); the "
          f"ViT's {len(vit_before)} tensors took no gradient and are bit-equal "
          f"after {N_STEPS + 1} steps [{card}]", flush=True)
    del model, step, batch
    torch.cuda.empty_cache()

    # One fp32 step on the card against the CPU at phase 10's shape.
    sb, sv, sh, sw = STEP_SHAPE
    small = copy.deepcopy(cfg)
    small.optimizer.warmup_steps = 0
    small.data.multi_scale_args.scale_batch_map = {str(sh): 1}
    cpu_model = build_model(small.arch, device="cpu", train=True)
    random_init_(cpu_model, torch.Generator().manual_seed(2))
    card_model = copy.deepcopy(cpu_model).to(device)
    before = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    t0 = time.perf_counter()
    card_metrics = TrainStep(card_model, small, seed=0)(
        synthetic_batch(torch, sb, sv, sh, sw, device=device, with_gt=True))
    cpu_metrics = TrainStep(cpu_model, small, seed=0)(
        synthetic_batch(torch, sb, sv, sh, sw, device="cpu", with_gt=True))
    ok, step_errs, lines = compare_steps(torch, card_model, cpu_model, before, card_metrics,
                                         cpu_metrics, small.optimizer)
    print(f"DINO training step {STEP_SHAPE} on the card against the CPU "
          f"({time.perf_counter() - t0:.1f} s): loss {card_metrics['loss']:.6f} / "
          f"{cpu_metrics['loss']:.6f}; worst errors "
          + ", ".join(f"{k} {v:.3e}" for k, v in step_errs.items())
          + " (phase 10's bounds) " + ("ok" if ok else "FAILED"), flush=True)
    for line in lines[-20:]:
        print(f"  {line}")
    if not ok:
        raise RuntimeError("the DINO training step on the card disagrees with the CPU step")

    total = dict(launches)
    for n, c in step_launches.items():
        total[n] = total.get(n, 0) + c
    return {"rows": rows, "launches": total, "details": {
        "request_ms": [t * 1e3 for t in times], "depth_maps_per_s": B / mean_s,
        "peak_memory_gb": peak_gb, "launches": launches, "layers_ms": layers,
        "profiled_wall_ms": wall_ms, "profiled_kernel_ms": busy_ms, "top_kernels": top,
        "e2e_small_errors": e2e, "test_cli_s": test_s, "view0_gap": [gap_d, gap_c],
        "test_cli_tt_launches": tt_counts,
        "step_ms": [t * 1e3 for t in step_times], "train_steps_per_s": 1 / mean_step,
        "train_peak_memory_gb": train_peak_gb, "step_launches": step_launches,
        "metrics": metrics, "card_vs_cpu_step": step_errs}}


# The cascade's variants (phase 14): the depth, norm and fusion types the
# JAX package supports beside the default's, served at the DTU request and
# trained at phase 8's shape. Each config is the default ModelConfig with
# these fields set.
VARIANT_EVALS = {
    "cnn/re/GN": dict(depth_type="re", norm_type="GN"),
    "epipole/was/BN": dict(fusion_type="epipole", depth_type="was"),
    "epipoleV2/mixup_ce/BN": dict(fusion_type="epipoleV2", depth_type="mixup_ce"),
}
# Launches a request: K1 every stage; K2 under cnn fusion with BN only (GN,
# IN and the epipole fusions have no kernel visibility CNN); K3 for ce and
# was only; K4 and K5 under BN only; K6 at every GSA block.
VARIANT_LAUNCHES = {
    "cnn/re/GN": {"warp_group_corr": 4, "visibility_net": 0, "depth_decode": 0,
                  "encoder_head": 0, "fpn_level": 0, "gsa_attention": 9},
    "epipole/was/BN": {"warp_group_corr": 4, "visibility_net": 0, "depth_decode": 4,
                       "encoder_head": 1, "fpn_level": 3, "gsa_attention": 9},
    "epipoleV2/mixup_ce/BN": {"warp_group_corr": 4, "visibility_net": 0, "depth_decode": 0,
                              "encoder_head": 1, "fpn_level": 3, "gsa_attention": 9},
}
VIEW_CHUNK = 2  # (b) again with eval_view_chunk: the backbone over views 2 + 2 + 1
VARIANT_STEPS = {
    "re/GN/mask_out_range": dict(depth_type="re", norm_type="GN", mask_out_range=True),
    "was": dict(depth_type="was"),
    "mixup_ce": dict(depth_type="mixup_ce"),
}


def check_variant_outputs(torch, model, depth, conf):
    """Phase 5's checks for a variant, whose decode (re, mixup_ce) may leave
    the request's depth range where its stage's hypotheses do: finite
    outputs of the request's shape, confidence in (0, 1], and each stage's
    depth, from one more forward, within that stage's hypotheses. Raises on
    a failure; returns the line to print."""
    cmin, cmax = check_confidence(torch, depth, conf)
    with torch.inference_mode():
        out = model(*synthetic_request(torch, B, V, H, W, device=depth.device),
                    tmp=[5.0, 5.0, 5.0, 1.0])
    for i in range(len(model.fusions)):
        st = out[f"stage{i + 1}"]
        lo, hi = float(st["depth_values"].min()), float(st["depth_values"].max())
        if float(st["depth"].min()) < lo - 1e-3 or float(st["depth"].max()) > hi + 1e-3:
            raise RuntimeError(f"stage {i + 1}: depth outside its hypotheses [{lo}, {hi}]")
    return (f"outputs ok: depth [{float(depth.min()):.3f}, {float(depth.max()):.3f}] within "
            f"the last stage's hypotheses, conf [{cmin:.6f}, {cmax:.6f}]")


def variants_phase(torch, card, eval_specs, device="cuda"):
    """Phase 14. `eval_specs`: phase 4's K1-K6 specs. Returns {"rows": K1's
    and K3's checked launches in the epipole request and K4's, K5's and K6's
    in the chunked one, "launches": one request's of each config and one
    step's of each, "details"}."""
    import copy
    import math

    from mvsformer_torch.config import Config, ModelConfig
    from mvsformer_torch.infer import make_infer_fn
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.ops import cuda_build
    from mvsformer_torch.train.step import TrainStep

    t_phase = time.perf_counter()
    request = synthetic_request(torch, B, V, H, W, device=device)
    details, total, rows = {}, {}, {}

    def serve(model, name, want):
        """One warm-up and one timed request, the counts set to 0 just
        before it and read just after; the outputs checked."""
        fn = make_infer_fn(model, tmps=(5.0, 5.0, 5.0, 1.0))
        fn(*request)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        depth, conf, _ = fn(*request)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {n: dict(cuda_build.LAUNCHES).get(n, 0) for n in eval_specs}
        if counts != want:
            raise RuntimeError(f"variant {name}: launches {counts} in a request, want {want}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        line = check_variant_outputs(torch, model, depth, conf)
        print(f"variant {name}: request {ms:.2f} ms, {B / ms * 1e3:.4f} depth-maps/s, peak "
              f"memory {peak_gb:.3f} GB; launches {counts}; {line} [{card}]", flush=True)
        return fn, depth, conf, {"request_ms": ms, "peak_memory_gb": peak_gb, "launches": counts}

    # 14a. Each eval config at the DTU request; 14b. K1 and K3 against their
    # plain versions at every launch of one request of the epipole model.
    chunk_ref = None
    for name, kw in VARIANT_EVALS.items():
        model = build_model(ModelConfig(**kw), device=device)
        random_init_(model, torch.Generator().manual_seed(0))
        fn, depth, conf, det = serve(model, name, VARIANT_LAUNCHES[name])
        det["layers_ms"] = layer_breakdown(torch, model, fn, request)
        print(f"variant {name} layers (device ms, one request): " + json.dumps(
            {k: round(v, 3) for k, v in det["layers_ms"].items()}))
        for n, c in det["launches"].items():
            total[n] = total.get(n, 0) + c
        if name == "epipole/was/BN":
            specs = {n: eval_specs[n] for n in ("warp_group_corr", "depth_decode")}
            recorded, _ = record_calls(torch, specs, fn, *request)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            for n, calls in recorded.items():
                if len(calls) != VARIANT_LAUNCHES[name][n]:
                    raise RuntimeError(f"variant {name} {n}: recorded {len(calls)} calls")
                rows[n] = [check_kernel(torch, card, n, specs[n],
                                        f"{name} " + call_label(n, i, args), args, kwargs)
                           for i, (args, kwargs) in enumerate(calls)]
            del recorded
            chunk_ref = (model.state_dict(), depth, conf, det["peak_memory_gb"])
        details[name] = det
        del model, fn, depth, conf
        torch.cuda.empty_cache()

    # 14c. The epipole model again over view chunks: its kernels against
    # their plain versions, and the request against the whole one.
    state, ref_depth, ref_conf, ref_peak = chunk_ref
    model = build_model(ModelConfig(**VARIANT_EVALS["epipole/was/BN"],
                                    eval_view_chunk=VIEW_CHUNK), device=device)
    model.load_state_dict(state)
    n_chunks = -(-V // VIEW_CHUNK)
    want = {n: c * (n_chunks if n in ("encoder_head", "fpn_level", "gsa_attention") else 1)
            for n, c in VARIANT_LAUNCHES["epipole/was/BN"].items()}
    fn, depth, conf, det = serve(model, f"epipole/was/BN eval_view_chunk={VIEW_CHUNK}", want)
    # K4, K5 and K6 against their plain versions at every launch of one
    # chunked request: they see batches of VIEW_CHUNK and of the last
    # chunk's views here, and of all V views everywhere else.
    specs = {n: eval_specs[n] for n in ("encoder_head", "fpn_level", "gsa_attention")}
    recorded, _ = record_calls(torch, specs, fn, *request)
    for n, calls in recorded.items():
        if len(calls) != want[n]:
            raise RuntimeError(f"variant view chunks {n}: recorded {len(calls)} calls, "
                               f"want {want[n]}")
        per_chunk = want[n] // n_chunks
        rows[n] = [check_kernel(torch, card, n, specs[n],
                                f"view chunk {i // per_chunk + 1} B={args[0].shape[0]} "
                                + call_label(n, i % per_chunk, args), args, kwargs)
                   for i, (args, kwargs) in enumerate(calls)]
    del recorded, fn
    gap_d, gap_c = max_err(depth, ref_depth), max_err(conf, ref_conf)
    ok = gap_d <= E2E_DEPTH_ATOL and gap_c <= E2E_CONF_ATOL
    print(f"variant epipole/was/BN over view chunks of {VIEW_CHUNK} against the whole request: "
          f"depth {gap_d:.3e}, confidence {gap_c:.3e} (tolerance {E2E_DEPTH_ATOL:g}, "
          f"{E2E_CONF_ATOL:g}); peak memory {det['peak_memory_gb']:.3f} GB chunked, "
          f"{ref_peak:.3f} GB whole [{card}] " + ("ok" if ok else "FAILED"), flush=True)
    if not ok:
        raise RuntimeError("the request over view chunks disagrees with the whole request")
    details["view_chunks"] = dict(det, depth_gap=gap_d, conf_gap=gap_c)
    del model, state, chunk_ref, ref_depth, ref_conf, depth, conf
    torch.cuda.empty_cache()

    # 14d. A training step of each config at phase 8's shape.
    batch = synthetic_batch(torch, TRAIN_B, TRAIN_V, TRAIN_H, TRAIN_W, device=device,
                            with_gt=True)
    n_micro = TRAIN_B // TRAIN_MICRO
    per_step = {n: (4 * n_micro if n in TRAIN_PER_MICRO else 0)
                for n in list(eval_specs) + list(TRAIN_PER_MICRO)}
    for name, kw in VARIANT_STEPS.items():
        cfg = Config()
        for k, v in kw.items():
            setattr(cfg.arch, k, v)
        model = build_model(cfg.arch, device=device, train=True)
        random_init_(model, torch.Generator().manual_seed(1))
        step = TrainStep(model, cfg, seed=0)
        step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(cuda_build.LAUNCHES)
        if {n: counts.get(n, 0) for n in per_step} != per_step or set(counts) - set(per_step):
            raise RuntimeError(f"variant step {name}: launches {counts}, want {per_step}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        bad = bad_gradients(torch, model)
        losses = [v for k, v in metrics.items() if k.startswith("loss")]
        if bad or not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"variant step {name}: loss {metrics['loss']}, bad gradients "
                               f"{bad[:8]}")
        print(f"variant step {name} ({TRAIN_B} as {n_micro} micro-batches of {TRAIN_MICRO}, "
              f"{TRAIN_V} views, {TRAIN_H}x{TRAIN_W}, {NDEPTH_FULL} depths): {ms:.2f} ms, "
              f"peak memory {peak_gb:.2f} GB; launches {counts}; loss {metrics['loss']:.5f}; "
              f"all {len(grads_of(model))} trainable gradients finite and non-zero (but those "
              f"zero in exact arithmetic: {zero_gradients(torch, model)}) [{card}]",
              flush=True)
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        details[f"step {name}"] = {"step_ms": ms, "peak_memory_gb": peak_gb,
                                   "launches": counts, "metrics": metrics}
        del model, step
        torch.cuda.empty_cache()
    del batch

    # 14e. One fp32 step of (a)'s config on the card against the CPU at
    # phase 10's shape.
    sb, sv, sh, sw = STEP_SHAPE
    small = Config()
    for k, v in VARIANT_EVALS["cnn/re/GN"].items():
        setattr(small.arch, k, v)
    small.arch.vit_args.drop_path_rate = 0.0
    small.optimizer.warmup_steps = 0
    small.data.multi_scale_args.scale_batch_map = {str(sh): 1}
    cpu_model = build_model(small.arch, device="cpu", train=True)
    random_init_(cpu_model, torch.Generator().manual_seed(2))
    card_model = copy.deepcopy(cpu_model).to(device)
    before = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    t0 = time.perf_counter()
    card_metrics = TrainStep(card_model, small, seed=0)(
        synthetic_batch(torch, sb, sv, sh, sw, device=device, with_gt=True))
    cpu_metrics = TrainStep(cpu_model, small, seed=0)(
        synthetic_batch(torch, sb, sv, sh, sw, device="cpu", with_gt=True))
    ok, step_errs, lines = compare_steps(torch, card_model, cpu_model, before, card_metrics,
                                         cpu_metrics, small.optimizer)
    print(f"variant cnn/re/GN training step {STEP_SHAPE} on the card against the CPU "
          f"({time.perf_counter() - t0:.1f} s): loss {card_metrics['loss']:.6f} / "
          f"{cpu_metrics['loss']:.6f}; worst errors "
          + ", ".join(f"{k} {v:.3e}" for k, v in step_errs.items())
          + " (phase 10's bounds) " + ("ok" if ok else "FAILED"), flush=True)
    for line in lines[-20:]:
        print(f"  {line}")
    if not ok:
        raise RuntimeError("the GN training step on the card disagrees with the CPU step")
    details["card_vs_cpu_step"] = step_errs
    details["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 14 (the variants): {details['phase_s']:.1f} s", flush=True)
    return {"rows": rows, "launches": total, "details": details}


# The bf16 mode (phase 15): the models built with `dtype=torch.bfloat16`,
# the JAX package's default (`build_model(cfg, dtype=jnp.bfloat16)`, both
# CLIs' `--dtype bf16`): bf16 convolutions and matmuls with fp32
# parameters, and the fp32 islands (projections, hypotheses, warp inputs,
# correlation, view weights and sum, logits, decode, losses, norms'
# statistics, softmaxes). K1, K3, K7 and K8 take fp32 as ever; K2, K4, K5
# and K6 are fp32 islands: their wrappers cast the bf16 inputs up, launch
# the fp32 kernel and cast the outputs down (K2's weight stays fp32).
BF16_MULT = 2.0            # the card's bf16 output against the CPU's, in the CPU's own
                           # bf16-vs-fp32 gaps (tests/test_torch_bf16.py's rule): the
                           # mean difference over pixels and a gradient group's L2
BF16_MAX_MULT = 4.0        # the same for a maximum over pixels and for the RMS over a
                           # step's five losses: a ratio of two draws of one rounding
                           # noise in an extreme value or in five scalars passes 2 a few
                           # times in a hundred (an H100 read 1.75 at a maximum)
BF16_FLOPS_PER_S = 989.4e12  # dense BF16 on the tensor cores, the H100 SXM's peak
BF16_GRAD_FLOOR = 1e-3     # of a gradient group's relative L2 and 1 - cosine
BF16_GRAD_GAP_MAX = 0.8    # a group whose bf16-vs-fp32 gap is larger is not compared: fail
BF16_GRAD_L2_MAX = 0.9     # a group's relative L2 error, whatever the gap: below the 1.0 of a
                           # zero gradient, the 1.41 of an unrelated one of the same norm
BF16_NORM_FLOOR = 0.1      # of a group's norm ratio, beside BF16_MULT x the gap's
ISLANDS = ("visibility_net", "encoder_head", "fpn_level", "gsa_attention")
STEP_GROUPS = ("encoder", "vit", "decoder_vit", "decoder", "fusions.0", "fusions.1",
               "fusions.2", "fusions.3")


def bf16_gap_check(got, want, ref32, floor, what):
    """`got` (the card's bf16 output) against `want` (the CPU's bf16 output)
    within BF16_MULT times the CPU's gap |want - ref32| plus `floor` in the
    mean of the absolute differences, and BF16_MAX_MULT times it in their
    maximum. Returns (ok, text)."""
    got, want, ref32 = (t.detach().float().cpu() for t in (got, want, ref32))
    err, gap = (got - want).abs(), (want - ref32).abs()
    ok = (float(err.mean()) <= BF16_MULT * float(gap.mean()) + floor
          and float(err.max()) <= BF16_MAX_MULT * float(gap.max()) + floor)
    return ok, (f"{what} mean {float(err.mean()):.3e} (gap {float(gap.mean()):.3e}), max "
                f"{float(err.max()):.3e} (gap {float(gap.max()):.3e})")


def bf16_bound_ms(nbytes, tensor_macs):
    """An island's least time as a bf16 body: its bytes at 2 B an element
    (the cost functions count 4) over the memory rate, and its tensor-core
    multiply-adds, one product each, over the dense BF16 rate. Returns (ms,
    the term that binds)."""
    times = {"bytes": nbytes / 2 / HBM_BYTES_PER_S,
             "operations": 2 * tensor_macs / BF16_FLOPS_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def island_casts(torch, name, spec, args, kwargs):
    """(up ms, down ms) of one island launch by CUDA events: every bf16
    tensor argument cast to fp32, and every output of the fp32 kernel cast
    to bf16 (K2's weight is not cast)."""
    from mvsformer_torch.ops import cuda_build

    ups = [t for t in tensors_of(args) if t.dtype == torch.bfloat16]
    with torch.no_grad():
        outs = tensors_of(spec["kernel"](*cuda_build.up_cast(args), **kwargs))
        up_ms = time_ms(torch, lambda: [t.float() for t in ups])
        down_ms = (0.0 if name == "visibility_net"
                   else time_ms(torch, lambda: [t.to(torch.bfloat16) for t in outs]))
    return up_ms, down_ms


def entropy_agreement_hooks(torch, model, views, shares):
    """Forward pre-hooks that record in `shares`, per stage and micro-batch,
    the share of pixels at which the `views` source views' entropy maps,
    the inputs of the stage's visibility CNN (a training forward calls it
    once per view, in turn), are equal. At random weights a stage's
    correlation is almost flat over depth, so its bf16 entropy rounds to
    log(D)'s bf16 value at most pixels of every view: where the maps agree
    the views' weights are equal and their terms in the CNN's gradient
    cancel, exactly in exact arithmetic where they agree everywhere (but
    for the 1e-6 in the view mean's denominator). The JAX package casts the
    entropy to bf16 too."""
    pending = {}

    def note(i, ent):
        pending.setdefault(i, []).append(ent.detach().clone())
        if len(pending[i]) == views:
            maps = torch.stack(pending.pop(i))
            shares.setdefault(i, []).append(float((maps == maps[:1]).all(0).float().mean()))
    return [stage.vis.register_forward_pre_hook(lambda m, a, i=i: note(i, a[0]))
            for i, stage in enumerate(model.fusions) if hasattr(stage, "vis")]


def group_l2(torch, model, names):
    return torch.cat([dict(model.named_parameters())[n].grad.detach().float().cpu().reshape(-1)
                      for n in names])


def grad_group_check(got, want, ref32=None, bound=None):
    """A gradient group `got` against `want` (the reference's bf16
    gradient), with `ref32` (its fp32 one) for the gap; flat arrays. Holds
    the relative L2 error to BF16_MULT times the gap plus BF16_GRAD_FLOOR
    and under BF16_GRAD_L2_MAX, 1 - cosine to BF16_MULT times the gap's,
    and the norm ratio's distance from 1 to BF16_MULT times the gap's plus
    BF16_NORM_FLOOR; a gap over BF16_GRAD_GAP_MAX fails. With `bound`
    instead of `ref32` (two fp32 gradients), each of the three is held to
    `bound`. A zero gradient (cosine taken as 0), an unrelated or a negated
    one, and one scaled by 1/2 or 3/2 fail (`grad_mutants`). Returns (ok,
    readings)."""
    import numpy as np

    got, want = (np.asarray(x, np.float64).ravel() for x in (got, want))
    norm = np.linalg.norm

    def cos(a, b):
        n = norm(a) * norm(b)
        return float(a @ b / n) if n > 0 else 0.0

    r = {"err": float(norm(got - want) / norm(want)), "cos": cos(got, want),
         "norm": float(norm(got) / norm(want))}
    if bound is not None:
        return (r["err"] <= bound and 1 - r["cos"] <= bound
                and abs(r["norm"] - 1) <= bound), r
    ref32 = np.asarray(ref32, np.float64).ravel()
    r.update(gap=float(norm(want - ref32) / norm(ref32)), cos_gap=cos(want, ref32),
             norm_gap=float(norm(want) / norm(ref32)))
    ok = (r["gap"] <= BF16_GRAD_GAP_MAX
          and r["err"] <= min(BF16_MULT * r["gap"] + BF16_GRAD_FLOOR, BF16_GRAD_L2_MAX)
          and 1 - r["cos"] <= BF16_MULT * (1 - r["cos_gap"]) + BF16_GRAD_FLOOR
          and abs(r["norm"] - 1) <= BF16_MULT * abs(r["norm_gap"] - 1) + BF16_NORM_FLOOR)
    return ok, r


def grad_mutants(got):
    """Wrong gradients that `grad_group_check` must reject: {name: array}."""
    import numpy as np

    got = np.asarray(got, np.float64).ravel()
    noise = np.random.default_rng(0).standard_normal(got.shape)
    return {"zero": np.zeros_like(got),
            "random": noise * np.linalg.norm(got) / np.linalg.norm(noise),
            "negated": -got, "half": got / 2, "x1.5": got * 1.5}


def vis_noise_only(model, shares):
    """The visibility CNNs' tensors whose bf16 gradient may be all zero,
    from `entropy_agreement_hooks`' shares. Where a stage's views' entropy
    maps agree at every pixel of every micro-batch, its whole CNN: the
    views' weights are equal and their terms cancel in exact arithmetic.
    Where they agree at more than 0.9 of the pixels, the last conv's
    one-element bias: its gradient is a sum over the views of one bf16
    scalar each (the conv computes in bf16), which cancel but for the few
    pixels that differ, and such scalars can round to a sum of exactly zero
    (an H100 read an all-zero `fusions.1.vis.3.bias` at phase 8's shape,
    where that stage's maps agree at 0.985-0.987 of the pixels). Every
    other tensor of the CNNs stays under the non-zero check."""
    names = set()
    for i, s in shares.items():
        prefix = f"fusions.{i}.vis."
        if min(s) == 1.0:
            names |= {n for n, _ in model.named_parameters() if n.startswith(prefix)}
        elif min(s) > 0.9:
            names.add(prefix + "3.bias")
    return names


@contextlib.contextmanager
def pinned_schedules(samples):
    """Within the block, the cascade's hypothesis schedulers (the stages
    after the first) record each call's result in `samples` if it is empty
    on entry, else return `samples[i]` at the i-th call. Steps that replay
    one record see the same hypotheses at every stage, so that an argmax
    flip of a nearly flat stage under another rounding does not move the
    next stage's window."""
    from mvsformer_torch.ops import hypotheses

    replay, calls = bool(samples), []

    def pinned(fn):
        def call(depth, *args, **kwargs):
            out = fn(depth, *args, **kwargs)
            if replay:
                out = samples[len(calls)].to(out.device, out.dtype)
            else:
                samples.append(out.detach().cpu())
            calls.append(1)
            return out
        return call

    saved = {n: getattr(hypotheses, n) for n in ("schedule_inverse_range", "schedule_range")}
    try:
        for n, fn in saved.items():
            setattr(hypotheses, n, pinned(fn))
        yield
    finally:
        for n, fn in saved.items():
            setattr(hypotheses, n, fn)
    if replay and len(calls) != len(samples):
        raise RuntimeError(f"replayed {len(calls)} schedules of {len(samples)} recorded")


def bf16_phase(torch, card, specs, device="cuda"):
    """Phase 15. `specs`: phase 4's K1-K6 specs. Returns {"rows": each
    kernel's checked launches at the bf16 request, "launches": one bf16
    request's, one DINO bf16 request's and one bf16 step's counts,
    "details"}."""
    import copy
    import math

    from mvsformer_torch.config import Config, ModelConfig, load_config
    from mvsformer_torch.infer import make_infer_fn
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.ops import cuda_build
    from mvsformer_torch.train.step import TrainStep

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    # 15a. TwinMVSNet at the default ModelConfig, bf16, phase 4's weights.
    m32 = build_model(ModelConfig(), device=device)
    random_init_(m32, torch.Generator().manual_seed(0))
    m16 = build_model(ModelConfig(), device=device, dtype=bf16)
    m16.load_state_dict(m32.state_dict())
    request = synthetic_request(torch, B, V, H, W, device=device)
    fn16, fn32 = make_infer_fn(m16), make_infer_fn(m32)
    t0 = time.perf_counter()
    fn16(*request)
    torch.cuda.synchronize()
    print(f"bf16: TwinMVSNet alt_gvt_small, compute dtype {m16.compute_dtype}, parameters "
          f"{sorted({str(p.dtype) for p in m16.parameters()})}; warm-up request "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], None
    for _ in range(N_REQUESTS):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        depth, conf, _ = fn16(*request)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = dict(cuda_build.LAUNCHES)
        for name, spec in specs.items():
            if counts.get(name, 0) != spec["per_request"]:
                raise RuntimeError(f"bf16 {name}: {counts.get(name, 0)} launches in a request, "
                                   f"want {spec['per_request']}")
        launches = launches or counts
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mean_s = sum(times) / len(times)
    print(f"bf16 launches per request, the same in each of {N_REQUESTS}: {launches}")
    print("bf16 requests: " + ", ".join(f"{t * 1e3:.2f}" for t in times)
          + f" ms; mean {mean_s * 1e3:.2f} ms, {B / mean_s:.4f} depth-maps/s, peak memory "
          f"{peak_gb:.3f} GB (timed requests) [{card}]", flush=True)
    d32, c32, _ = fn32(*request)
    gap = {"depth_max": float((depth - d32).abs().max()),
           "depth_mean": float((depth - d32).abs().mean()),
           "conf_max": float((conf - c32).abs().max()),
           "conf_mean": float((conf - c32).abs().mean())}
    print("bf16 request against the fp32 request on the same weights: "
          + ", ".join(f"{k} {v:.4e}" for k, v in gap.items()), flush=True)
    del d32, c32
    layers = layer_breakdown(torch, m16, fn16, request)
    print("bf16 layers (device ms, one request): " + json.dumps(
        {k: round(v, 3) for k, v in layers.items()}))
    busy_ms, wall_ms, top = device_busy(torch, fn16, request)
    if busy_ms is None:
        print(f"bf16 profiled request: {wall_ms:.2f} ms wall; device busy share not measured "
              f"(the profiler saw no device events)")
    else:
        print(f"bf16 profiled request: {wall_ms:.2f} ms wall, {busy_ms:.2f} ms of kernels, "
              f"device idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} [{card}]")
        for name, t in top:
            print(f"  {t:9.3f} ms  {name[:110]}")

    # 15b. The outputs; every kernel at every launch of one bf16 request
    # against its plain version (the islands on their inputs cast up, before
    # the output cast), and each island's casts.
    recorded, (depth, conf, _) = record_calls(torch, specs, fn16, *request)
    print("bf16 " + check_outputs(torch, depth, conf, recorded["depth_decode"],
                                  specs["depth_decode"]["kernel"]))
    for name, calls in recorded.items():
        if len(calls) != specs[name]["per_request"]:
            raise RuntimeError(f"bf16 {name}: recorded {len(calls)} calls, "
                               f"want {specs[name]['per_request']}")
        first = {calls[0][0][0].dtype}
        want = {bf16} if name in ISLANDS else {torch.float32}
        if {c[0][0].dtype for c in calls} != want or (name not in ISLANDS and any(
                t.dtype != torch.float32 for c in calls
                for t in tensors_of(c[0]) if t.is_floating_point())):
            raise RuntimeError(f"bf16 {name}: inputs {first}, want {want}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, islands = {}, {}
    for name, calls in recorded.items():
        spec = specs[name]
        rows[name] = [check_kernel(torch, card, name, spec, "bf16 " + call_label(name, i, args),
                                   cuda_build.up_cast(args), kwargs)
                      for i, (args, kwargs) in enumerate(calls)]
        if name not in ISLANDS:
            continue
        casts = [island_casts(torch, name, spec, args, kwargs) for args, kwargs in calls]
        b16 = [bf16_bound_ms(r["bytes"], r["tensor_macs"]) for r in rows[name]]
        islands[name] = {"launches": len(calls), "up_ms": sum(c[0] for c in casts),
                         "down_ms": sum(c[1] for c in casts),
                         "kernel_ms": sum(r["ms"] for r in rows[name]),
                         "bound_ms": sum(r["bound_ms"] for r in rows[name]),
                         "bf16_bound_ms": sum(b[0] for b in b16),
                         "bf16_bound_by": max(("bytes", "operations"), key=lambda k: sum(
                             b[0] for b in b16 if b[1] == k))}
        i = islands[name]
        print(f"bf16 island {name}: {i['launches']} launches a request; casts up "
              f"{i['up_ms']:.4f} ms, down {i['down_ms']:.4f} ms; the fp32 kernel "
              f"{i['kernel_ms']:.4f} ms (bound {i['bound_ms']:.4f}); a bf16 body's bound "
              f"{i['bf16_bound_ms']:.4f} ms "
              f"({i['bf16_bound_by']}) [{card}]", flush=True)
    del recorded

    # 15c. The __graft_entry__ request: the card's bf16 forward against the
    # CPU's, within BF16_MULT times the CPU's own bf16-vs-fp32 gap.
    cpu16, cpu32 = copy.deepcopy(m16).cpu(), copy.deepcopy(m32).cpu()
    got = make_infer_fn(m16)(*synthetic_request(torch, *E2E_SHAPE, device=device))
    want = make_infer_fn(cpu16)(*synthetic_request(torch, *E2E_SHAPE, device="cpu"))
    ref = make_infer_fn(cpu32)(*synthetic_request(torch, *E2E_SHAPE, device="cpu"))
    del cpu16, cpu32
    checks = [bf16_gap_check(got[0], want[0], ref[0], E2E_DEPTH_ATOL, "refined_depth"),
              bf16_gap_check(got[1], want[1], ref[1], E2E_CONF_ATOL, "photometric_confidence")]
    checks += [bf16_gap_check(g, w, r, E2E_CONF_ATOL, f"stage{i + 1}_confidence")
               for i, (g, w, r) in enumerate(zip(got[2], want[2], ref[2]))]
    e2e_ok = all(ok for ok, _ in checks) and bool(torch.isfinite(got[0]).all())
    print(f"bf16 request {E2E_SHAPE} on the card against the CPU (bound {BF16_MULT:g} x the "
          f"CPU's bf16-vs-fp32 gap in the mean, {BF16_MAX_MULT:g} x at the max, + depth "
          f"{E2E_DEPTH_ATOL:g} / confidence {E2E_CONF_ATOL:g}): " + "; ".join(t for _, t in checks)
          + (" ok" if e2e_ok else " FAILED"), flush=True)
    if not e2e_ok:
        raise RuntimeError("the bf16 forward on the card disagrees with the CPU's")
    del m16, m32, fn16, fn32, request, depth, conf, got
    torch.cuda.empty_cache()

    # 15d. DINOMVSNet (-p) in bf16: the DTU request, launches as phase 13's.
    here = os.path.dirname(os.path.abspath(__file__))
    arch = load_config(os.path.join(here, DINO_CONFIG)).arch
    dspecs = {n: dict(s, per_request=0 if n == "gsa_attention" else s["per_request"])
              for n, s in specs.items()}
    dino = build_model(arch, device=device, dtype=bf16)
    random_init_(dino, torch.Generator().manual_seed(0))
    dfn = make_infer_fn(dino)
    request = synthetic_request(torch, B, V, H, W, device=device)
    dfn(*request)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dtimes, dlaunches = [], None
    for _ in range(N_REQUESTS):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        depth, conf, _ = dfn(*request)
        torch.cuda.synchronize()
        dtimes.append(time.perf_counter() - t0)
        counts = dict(cuda_build.LAUNCHES)
        for name, spec in dspecs.items():
            if counts.get(name, 0) != spec["per_request"]:
                raise RuntimeError(f"bf16 DINO {name}: {counts.get(name, 0)} launches in a "
                                   f"request, want {spec['per_request']}")
        dlaunches = dlaunches or counts
    dpeak_gb = torch.cuda.max_memory_allocated() / 1e9
    dmean = sum(dtimes) / len(dtimes)
    drecorded, _ = record_calls(torch, {"depth_decode": dspecs["depth_decode"]}, dfn, *request)
    print("bf16 DINO " + check_outputs(torch, depth, conf, drecorded["depth_decode"],
                                       specs["depth_decode"]["kernel"]))
    print(f"bf16 DINO launches per request, the same in each of {N_REQUESTS}: {dlaunches}; "
          "requests " + ", ".join(f"{t * 1e3:.2f}" for t in dtimes)
          + f" ms; mean {dmean * 1e3:.2f} ms, peak memory {dpeak_gb:.3f} GB [{card}]",
          flush=True)
    del dino, dfn, request, depth, conf, drecorded
    torch.cuda.empty_cache()

    # 15e. The bf16 training step at phase 8's shape.
    cfg = Config()
    sbm = cfg.data.multi_scale_args.scale_batch_map
    if cfg.data.batch_size != TRAIN_B or int(sbm[str(TRAIN_H)]) != TRAIN_MICRO:
        raise RuntimeError("the default DataConfig no longer gives the training shape")
    n_micro = TRAIN_B // TRAIN_MICRO
    per_step = {n: len(cfg.arch.ndepths) * n_micro for n in TRAIN_PER_MICRO}
    model = build_model(cfg.arch, device=device, train=True, dtype=bf16)
    random_init_(model, torch.Generator().manual_seed(1))
    step = TrainStep(model, cfg, seed=0)
    batch = synthetic_batch(torch, TRAIN_B, TRAIN_V, TRAIN_H, TRAIN_W, device=device,
                            with_gt=True)
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_times, metrics, step_launches, agree = [], [], None, {}
    hooks = entropy_agreement_hooks(torch, model, TRAIN_V - 1, agree)
    try:
        for _ in range(N_STEPS):
            torch.cuda.synchronize()
            cuda_build.reset_launches()
            t0 = time.perf_counter()
            metrics.append(step(batch))
            torch.cuda.synchronize()
            step_times.append(time.perf_counter() - t0)
            counts = dict(cuda_build.LAUNCHES)
            if counts != per_step:
                raise RuntimeError(f"bf16 training step launches {counts}, want {per_step}")
            step_launches = step_launches or counts
    finally:
        for h in hooks:
            h.remove()
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mean_step = sum(step_times) / len(step_times)
    if not all(math.isfinite(v) for m in metrics for k, v in m.items() if k.startswith("loss")):
        raise RuntimeError("non-finite bf16 training loss")
    agreement = {f"stage{i + 1}": [min(s), max(s)] for i, s in sorted(agree.items())}
    bad = bad_gradients(torch, model, zero_ok=vis_noise_only(model, agree))
    zero = zero_gradients(torch, model)
    not_f32 = [n for n, p in model.named_parameters() if p.dtype != torch.float32]
    not_f32 += [n for n, b in model.named_buffers() if b.is_floating_point()
                and b.dtype != torch.float32]
    moments = [t for st in step.optimizer.state.values() for t in st.values()
               if torch.is_tensor(t) and t.dim() > 0]
    if bad or not_f32 or not moments or any(t.dtype != torch.float32 for t in moments):
        raise RuntimeError(f"bf16 training: bad gradients {bad[:8]}, tensors not fp32 "
                           f"{not_f32[:8]}")
    print(f"bf16 training ({TRAIN_B} as {n_micro} micro-batches of {TRAIN_MICRO}, {TRAIN_V} "
          f"views, {TRAIN_H}x{TRAIN_W}, {NDEPTH_FULL} depths): steps "
          + ", ".join(f"{t * 1e3:.2f}" for t in step_times)
          + f" ms; mean {mean_step * 1e3:.2f} ms, {1 / mean_step:.4f} train-steps/s, peak "
          f"memory {train_peak_gb:.2f} GB; launches per step {step_launches}; loss "
          f"{metrics[-1]['loss']:.5f}; {len(grads_of(model))} trainable gradients finite and "
          f"fp32, and non-zero but {zero} (zero in exact arithmetic, or a visibility CNN's "
          f"noise where its views' bf16 entropy maps agree at this share of pixels, min and "
          f"max over the micro-batches: {agreement}); parameters, buffers and {len(moments)} AdamW "
          f"moments fp32 [{card}]", flush=True)
    del model, step, batch
    torch.cuda.empty_cache()

    # 15f. One bf16 step on the card against the CPU at phase 10's shape,
    # within BF16_MULT times the CPU's own bf16-vs-fp32 gap; the three steps
    # see the CPU bf16 step's hypotheses at every stage (`pinned_schedules`).
    sb, sv, sh, sw = STEP_SHAPE
    small = Config()
    small.arch.vit_args.drop_path_rate = 0.0
    small.optimizer.warmup_steps = 0
    small.data.multi_scale_args.scale_batch_map = {str(sh): 1}
    cpu16 = build_model(small.arch, device="cpu", train=True, dtype=bf16)
    random_init_(cpu16, torch.Generator().manual_seed(2))
    cpu32 = build_model(small.arch, device="cpu", train=True)
    cpu32.load_state_dict(cpu16.state_dict())
    card16 = copy.deepcopy(cpu16).to(device)
    t0 = time.perf_counter()
    step_metrics, samples = {}, []
    # On an H100 host's CPU oneDNN's bf16 Conv3d weight gradient is not
    # deterministic and often not finite at stage 2's 2x4x4 bottleneck
    # (`python -m mvsformer_torch.bf16_cpu_check`), so the CPU bf16 step
    # runs PyTorch's own kernels.
    for key, mdl, dev in (("cpu16", cpu16, "cpu"), ("cpu32", cpu32, "cpu"),
                          ("card", card16, device)):
        with pinned_schedules(samples), torch.backends.mkldnn.flags(enabled=key != "cpu16"):
            step_metrics[key] = TrainStep(mdl, small, seed=0)(
                synthetic_batch(torch, sb, sv, sh, sw, device=dev, with_gt=True))
    keys = ["loss"] + [k for k in step_metrics["cpu16"] if k.startswith("loss_")]
    loss = {k: torch.tensor([step_metrics[k][n] for n in keys], dtype=torch.float64)
            for k in step_metrics}
    rms = lambda x: float(x.pow(2).mean().sqrt())
    loss_err, loss_gap = rms(loss["card"] - loss["cpu16"]), rms(loss["cpu16"] - loss["cpu32"])
    ok = loss_err <= BF16_MAX_MULT * loss_gap + 1e-6 * abs(float(loss["cpu32"][0]))
    lines = [f"losses' RMS {loss_err:.3e} (gap {loss_gap:.3e})"]
    step_errs = {"loss_rms": loss_err, "loss_rms_gap": loss_gap}
    names = [n for n, p in cpu16.named_parameters() if p.requires_grad]
    passed_mutants = []
    for group in STEP_GROUPS:
        members = [n for n in names if n == group or n.startswith(group + ".")]
        g_card, g16, g32 = (group_l2(torch, mdl, members).double().numpy()
                            for mdl in (card16, cpu16, cpu32))
        group_ok, r = grad_group_check(g_card, g16, g32)
        step_errs[group] = r
        ok = ok and group_ok
        passed_mutants += [f"{group} {k}" for k, g in grad_mutants(g_card).items()
                           if grad_group_check(g, g16, g32)[0]]
        lines.append(f"{group} L2 {r['err']:.3f} (gap {r['gap']:.3f}), cosine {r['cos']:.4f} "
                     f"(gap {r['cos_gap']:.4f}), norm ratio {r['norm']:.4f} (gap "
                     f"{r['norm_gap']:.4f})")
    stats = [n for n, _ in cpu16.named_buffers() if n.endswith(("running_mean", "running_var"))]
    bufs = [dict(m.named_buffers()) for m in (card16, cpu16, cpu32)]
    cat = [torch.cat([b[n].float().cpu().reshape(-1) for n in stats]) for b in bufs]
    stats_ok, stats_text = bf16_gap_check(cat[0], cat[1], cat[2], 1e-6, "running stats")
    ok = ok and stats_ok and not passed_mutants
    print(f"bf16 training step {STEP_SHAPE} on the card against the CPU, the hypotheses "
          f"pinned ({time.perf_counter() - t0:.1f} s; bounds per group: relative L2 "
          f"{BF16_MULT:g} x the CPU's bf16-vs-fp32 gap + {BF16_GRAD_FLOOR:g} and at most "
          f"{BF16_GRAD_L2_MAX:g}, 1 - cosine {BF16_MULT:g} x the gap's + {BF16_GRAD_FLOOR:g}, "
          f"the norm ratio's distance from 1 {BF16_MULT:g} x the gap's + {BF16_NORM_FLOOR:g}, "
          f"a gap at most {BF16_GRAD_GAP_MAX:g}; {BF16_MAX_MULT:g} x + 1e-6 in the losses' RMS; "
          f"the running stats' mean {BF16_MULT:g} x and max {BF16_MAX_MULT:g} x, + 1e-6): "
          + "; ".join(lines) + f"; {stats_text}; the bounds reject zero, random, negated, "
          f"half and 1.5 x card gradients in every group: "
          + (f"no, {passed_mutants}" if passed_mutants else "yes") + " "
          + ("ok" if ok else "FAILED"), flush=True)
    if not ok:
        raise RuntimeError("the bf16 training step on the card disagrees with the CPU's")
    step_errs["running_stats"] = stats_text
    del card16, cpu16, cpu32
    torch.cuda.empty_cache()

    total = dict(launches)
    for counts in (dlaunches, step_launches):
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
    details = {
        "request_ms": [t * 1e3 for t in times], "depth_maps_per_s": B / mean_s,
        "peak_memory_gb": peak_gb, "launches": launches, "gap_to_fp32": gap,
        "layers_ms": layers, "profiled_wall_ms": wall_ms, "profiled_kernel_ms": busy_ms,
        "top_kernels": top, "islands": islands, "e2e_small": [t for _, t in checks],
        "dino_request_ms": [t * 1e3 for t in dtimes], "dino_peak_memory_gb": dpeak_gb,
        "dino_launches": dlaunches, "step_ms": [t * 1e3 for t in step_times],
        "train_steps_per_s": 1 / mean_step, "train_peak_memory_gb": train_peak_gb,
        "step_launches": step_launches, "metrics": metrics, "zero_gradients": zero,
        "entropy_agreement": agreement, "card_vs_cpu_step": step_errs,
        "phase_s": time.perf_counter() - t_phase}
    print(f"phase 15 (bf16): {details['phase_s']:.1f} s", flush=True)
    return {"rows": rows, "launches": total, "details": details}


# The process grid (phase 16): data and view parallelism over torch.distributed,
# two ranks of one card over gloo (NCCL puts one rank on a card), each rank a
# process that torchrun starts. Two ranks sharing one card say nothing of
# scaling: this phase checks that the grid computes the serial function.
PAR_RANKS = 2
PAR_TIMEOUT_S = 420            # each torchrun launch, its ranks' start included
# The grid's step against the serial step, per layer group: relative L2, 1 -
# cosine and |norm ratio - 1| within phase 10's L2 bound. fp32 at random
# weights: a rank's BN moments and the gradients' mean are summed in
# another order, and an argmax flip moves the next stage's window (on the
# CPU at 128x128 the grid read up to 6.6e-3 where images moved by 1e-6 of
# their value move the serial step by up to 3.3e-3); every mutant lies at
# 0.5 or further.
PAR_GRAD_BOUND = STEP_GRAD_L2
PAR_TRAIN_VIEWS = 3            # x 7 lights: 21 samples, padded to 11 a rank
PAR_TRAIN_HW = (128, 128)      # 16d's crops (multiples of 64); the images PAR_TRAIN_IMG_HW
PAR_TRAIN_IMG_HW = (300, 400)


GRID_CONSTANTS = ("B", "V", "H", "W", "NDEPTH_FULL", "TRAIN_B", "TRAIN_MICRO", "TRAIN_V",
                  "TRAIN_H", "TRAIN_W")


def _grid_job(out):
    """What the ranks of 16a-16c read: where to write, and the shapes they
    run at, this module's constants in the parent (which a rehearsal
    shrinks)."""
    return {"out": out, "constants": {k: globals()[k] for k in GRID_CONSTANTS}}


def _rank_share(torch, batch, d, data, micro):
    """Data rank d's samples of a batch whose micro-batches of `micro`
    samples split over `data` ranks: its micro / data samples of each."""
    from mvsformer_torch.train.step import _map

    n = batch["imgs"].shape[0]
    per = micro // data
    idx = torch.tensor([m + d * per + j for m in range(0, n, micro) for j in range(per)],
                       device=batch["imgs"].device)
    return _map(batch, lambda t: t.index_select(0, idx))


def _par_config(norm, micro):
    """Phase 8's Config without drop path (a rank draws its masks for its
    own samples), under `norm`, with `micro` samples a micro-batch."""
    from mvsformer_torch.config import Config

    cfg = Config()
    cfg.arch.vit_args.drop_path_rate = 0.0
    cfg.arch.norm_type = norm
    cfg.data.multi_scale_args.scale_batch_map = {str(TRAIN_H): micro}
    return cfg


def parallel_rank(job_path, card, device_name):
    """One rank of 16a-16c and 16e, started by torchrun: join the gloo
    group on `device_name` (every rank on one card), then
    16a: the DTU request at view 2 (phase 4's model and weights), K1-K6
    held to their plain versions at rank 0's launches; 16b: phase 8's step
    at data 2 with SyncBN (micro-batches of TRAIN_MICRO / 2 a rank); 16c:
    the step at view 2 under GN (K7/K8 held at rank 0's launches); 16e:
    the DTU request at depth 2, K1-K6 held at every rank's launches. A rank
    checks while the other waits at a barrier. Each run with the launch
    counts set to 0 just before it; the results go to <out>/rank<r>.pt."""
    import torch
    import torch.distributed as dist

    from mvsformer_torch.config import ModelConfig
    from mvsformer_torch.infer import make_infer_fn
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.ops import cuda_build
    from mvsformer_torch.parallel.mesh import init_distributed, make_layout
    from mvsformer_torch.train.step import TrainStep

    with open(job_path) as f:
        job = json.load(f)
    globals().update(job["constants"])
    device = init_distributed("gloo", device_name)
    rank = dist.get_rank()
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def peak_gb():
        return torch.cuda.max_memory_allocated(device) / 1e9 if on_card else 0.0

    def driven(fn, *args):
        """fn(*args) with the counts set to 0 just before and read just after."""
        sync()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        return out, dict(cuda_build.LAUNCHES), (time.perf_counter() - t0) * 1e3

    res = {"rank": rank}

    # 16a. The request at view 2.
    layout = make_layout(1, PAR_RANKS)
    model = build_model(ModelConfig(), device=device, layout=layout)
    random_init_(model, torch.Generator().manual_seed(0))
    fn = make_infer_fn(model, tmps=(5.0, 5.0, 5.0, 1.0))
    imgs, projs, dv = synthetic_request(torch, B, V, H, W, device=device)
    fn(imgs, projs, dv)  # warm-up
    k16 = eval_kernel_specs(model)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    (rec, (depth, conf, _)), counts, ms = driven(record_calls, torch, k16, fn, imgs, projs, dv)
    res["16a"] = {"depth": depth.cpu(), "conf": conf.cpu(), "launches": counts, "ms": ms,
                  "peak_gb": peak_gb(),
                  "k1_shapes": [list(a[1].shape) for a, _ in rec["warp_group_corr"]]}
    # K1-K6 at view rank 0's launches, timed with the card to itself: the
    # other rank waits at the barriers. TF32 off, as phase 6 checks: the
    # plain versions' cuDNN convs would run in TF32 by default.
    dist.barrier()
    if rank == 0 and on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res["16a"]["rows"] = {name: [check_kernel(torch, card, name, k16[name],
                                                  "view rank 0 " + call_label(name, i, a), a, k)
                                     for i, (a, k) in enumerate(calls)]
                              for name, calls in rec.items()}
    dist.barrier()
    del model, fn, rec, imgs, projs, dv, depth, conf
    if on_card:
        torch.cuda.empty_cache()

    # 16b. The step at data 2, SyncBN: this rank's TRAIN_MICRO / 2 samples of each
    # micro-batch, as micro-batches of that many.
    def step_run(layout, norm, micro, share):
        cfg = _par_config(norm, micro)
        model = build_model(cfg.arch, device=device, train=True, layout=layout)
        random_init_(model, torch.Generator().manual_seed(1))
        step = TrainStep(model, cfg, seed=0)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        recorded, k78 = None, train_kernel_specs(None)
        if rank == 0 and norm == "GN" and on_card:
            (recorded, metrics), counts, ms = driven(record_calls, torch, k78, step, share)
        else:
            metrics, counts, ms = driven(step, share)
        out = {"metrics": metrics, "launches": counts, "first_ms": ms, "peak_gb": peak_gb(),
               "grads": {n: p.grad.detach().to("cpu", copy=True)
                         for n, p in model.named_parameters() if p.grad is not None},
               "buffers": {n: t.detach().to("cpu", copy=True) for n, t in model.named_buffers()
                           if t.is_floating_point()}}
        _, _, out["ms"] = driven(step, share)  # a second step, timed
        dist.barrier()  # K7/K8's checks below time the card without the other rank
        if recorded is not None:
            nst = len(cfg.arch.ndepths)
            out["rows"] = {name: [check_kernel(
                torch, card, name, k78[name], f"view rank 0 micro{i // nst + 1} "
                + call_label(name, i % nst, a), a, k) for i, (a, k) in enumerate(calls)]
                for name, calls in recorded.items()}
        dist.barrier()
        return out

    batch = synthetic_batch(torch, TRAIN_B, TRAIN_V, TRAIN_H, TRAIN_W, device=device,
                            with_gt=True)
    layout = make_layout(PAR_RANKS, 1)
    res["16b"] = step_run(layout, "BN", TRAIN_MICRO // PAR_RANKS,
                          _rank_share(torch, batch, layout.data_index, PAR_RANKS, TRAIN_MICRO))
    if on_card:
        torch.cuda.empty_cache()
    # 16c. The step at view 2 under GN: every sample, the reference and half the sources.
    res["16c"] = step_run(make_layout(1, PAR_RANKS), "GN", TRAIN_MICRO, batch)
    del batch
    if on_card:
        torch.cuda.empty_cache()

    # 16e. The request at depth 2 (phase 4's model and weights): every rank
    # computes the whole volume and regularises its half of each stage's
    # depth hypotheses (the halo exchange by all_gather over gloo), then
    # decodes the gathered logits. K1-K6 held to their plain versions at
    # every launch of every rank, one rank at a time.
    layout = make_layout(1, 1, PAR_RANKS)
    model = build_model(ModelConfig(), device=device, layout=layout)
    random_init_(model, torch.Generator().manual_seed(0))
    fn = make_infer_fn(model, tmps=(5.0, 5.0, 5.0, 1.0))
    imgs, projs, dv = synthetic_request(torch, B, V, H, W, device=device)
    fn(imgs, projs, dv)  # warm-up
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    (rec, (depth, conf, _)), counts, ms = driven(record_calls, torch, k16, fn, imgs, projs, dv)
    res["16e"] = {"depth": depth.cpu(), "conf": conf.cpu(), "launches": counts, "ms": ms,
                  "peak_gb": peak_gb(), "rows": {}}
    dist.barrier()
    for r in range(PAR_RANKS):
        if rank == r and on_card:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            res["16e"]["rows"] = {name: [check_kernel(
                torch, card, name, k16[name], f"depth rank {r} " + call_label(name, i, a), a, k)
                for i, (a, k) in enumerate(calls)] for name, calls in rec.items()}
        dist.barrier()
    del model, fn, rec, imgs, projs, dv, depth, conf
    torch.save(res, os.path.join(job["out"], f"rank{rank}.pt"))
    dist.destroy_process_group()


class Torchrun:
    """`python -m torch.distributed.run --standalone --nproc_per_node
    <nproc> <args>`, started from the repo's root in a session of its own,
    its output to chiprun_out/<log_name>.log; a thread notes when it ends.
    `wait` gives it until `timeout` seconds after its start, then kills the
    whole session (torchrun and its ranks); it raises if any rank failed
    and returns the launch's seconds. Several may run at once (each
    --standalone launch takes a free port of its own)."""

    def __init__(self, args, log_name, nproc=PAR_RANKS, timeout=PAR_TIMEOUT_S):
        here = os.path.dirname(os.path.abspath(__file__))
        os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
        self.args, self.timeout = args, timeout
        self.log = os.path.join(here, "chiprun_out", f"{log_name}.log")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={nproc}"] + args
        self.t0, self.t_end = time.perf_counter(), None
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(cmd, cwd=here, stdout=f, stderr=subprocess.STDOUT,
                                         start_new_session=True)
        self.watch = threading.Thread(target=self._end, daemon=True)
        self.watch.start()

    def _end(self):
        self.proc.wait()
        self.t_end = time.perf_counter()

    def wait(self):
        import signal

        left = self.timeout - (time.perf_counter() - self.t0)
        try:
            rc = self.proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
            rc = None
        self.watch.join()
        seconds = self.t_end - self.t0
        if rc != 0:
            with open(self.log) as f:
                print(f.read()[-8000:], file=sys.stderr)
            raise RuntimeError(f"torchrun {' '.join(self.args[:3])} ... "
                               + ("passed its time limit" if rc is None else f"exited {rc}"))
        return seconds

    def kill(self):
        """End the session if it still runs (a failure elsewhere)."""
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()


def serial_ddp_grads(torch, model, batch, micro, shards, arch):
    """The serial model's step on `batch` with the data-parallel loss:
    micro-batches of `micro` samples, each one training forward (BN over
    the whole micro-batch, as SyncBN gives the data ranks) whose loss is
    the mean of its `shards` equal shards' masked means
    (tests/test_parallel.py:60-76); the gradients summed over the
    micro-batches and divided by their number. -> (loss, {param: grad})."""
    from mvsformer_torch import fp32_math
    from mvsformer_torch.ops.losses import total_loss
    from mvsformer_torch.train.step import STAGE_KEYS, _map

    keys = STAGE_KEYS[:len(arch.ndepths)]
    n_micro, per = batch["imgs"].shape[0] // micro, micro // shards
    model.train()
    model.zero_grad(set_to_none=True)
    loss_sum = 0.0
    with fp32_math():
        for m in range(n_micro):
            mb = _map(batch, lambda t: t[m * micro:(m + 1) * micro])
            out = model(mb["imgs"], mb["proj_matrices"], mb["depth_values"])
            loss = 0.0
            for i in range(shards):
                sl = slice(i * per, (i + 1) * per)
                o = {k: {f: t[sl] for f, t in out[k].items()} for k in keys}
                dv = mb["depth_values"][sl]
                part, _ = total_loss(o, {k: mb["depth_gt"][k][sl] for k in keys},
                                     {k: mb["mask"][k][sl] for k in keys}, dv[:, 1] - dv[:, 0],
                                     depth_type=arch.depth_type, focal=arch.focal,
                                     gamma=arch.gamma, inverse_depth=arch.inverse_depth,
                                     mask_out_range=arch.mask_out_range, stage_keys=keys)
                loss = loss + part / shards
            loss.backward()
            loss_sum += float(loss.detach())
    grads = {n: p.grad.detach() / n_micro for n, p in model.named_parameters()
             if p.grad is not None}
    return loss_sum / n_micro, grads


def compare_grid_step(torch, card, label, got, want_loss, want_grads, want_buffers):
    """A grid step's averaged gradients against the serial ones, per layer
    group by `grad_group_check` at PAR_GRAD_BOUND (its mutants rejected),
    the loss at STEP_LOSS_RTOL and the running statistics at phase 10's
    bounds. Raises on a failure; returns the readings."""
    import numpy as np

    m = got["metrics"]
    loss_err = abs(m["loss"] - want_loss) / abs(want_loss)
    if set(got["grads"]) != set(want_grads):
        raise RuntimeError(f"{label}: the ranks' gradients name other tensors than the "
                           f"serial step's")
    groups = {}
    for g in STEP_GROUPS:
        names = sorted(n for n in want_grads if n.startswith(g + "."))
        if not names:
            continue
        a = torch.cat([got["grads"][n].double().reshape(-1) for n in names]).numpy()
        bb = torch.cat([want_grads[n].double().cpu().reshape(-1) for n in names]).numpy()
        ok, r = grad_group_check(a, bb, bound=PAR_GRAD_BOUND)
        caught = [k for k, mut in grad_mutants(a).items()
                  if not grad_group_check(mut, bb, bound=PAR_GRAD_BOUND)[0]]
        r.update(ok=ok, mutants_rejected=len(caught))
        groups[g] = r
        if not ok or len(caught) != len(grad_mutants(a)):
            raise RuntimeError(f"{label} {g}: gradients {r} against the serial step "
                               f"(bound {PAR_GRAD_BOUND:g}; mutants rejected {caught})")
    stats = {n: float((got["buffers"][n] - t.cpu()).abs().max()
                      / (STEP_STATS_ATOL + STEP_STATS_RTOL * t.abs().max().cpu()))
             for n, t in want_buffers.items()}
    worst_stat = max(stats, key=stats.get, default=None)
    stats_err = stats.get(worst_stat, 0.0)
    print(f"{label}: loss {m['loss']:.6f} against the serial {want_loss:.6f} ({loss_err:.2e} "
          f"relative, bound {STEP_LOSS_RTOL:g}); gradients per group (relative L2 / 1 - cosine"
          f" / norm ratio, bound {PAR_GRAD_BOUND:g}, 5 mutants rejected in each): "
          + ", ".join(f"{g} {r['err']:.2e}/{1 - r['cos']:.1e}/{r['norm']:.5f}"
                      for g, r in groups.items())
          + f"; running statistics at {stats_err:.3f} of phase 10's bound (the worst "
          f"{worst_stat}) [{card}]", flush=True)
    if loss_err > STEP_LOSS_RTOL or stats_err > 1.0 or not np.isfinite(m["grad_norm"]):
        raise RuntimeError(f"{label}: the loss or the running statistics disagree with the "
                           f"serial step")
    return {"loss_err": loss_err, "groups": groups, "stats_err_of_bound": stats_err}


def parallel_phase(torch, card, specs, serial, device="cuda"):
    """Phase 16. `specs`: phase 4's K1-K6 specs; `serial`: phase 4's
    request's (depth, confidence). Returns {"rows": the kernels' checked
    launches at the ranks' shapes, "launches": the ranks' launches in their
    driven runs, "details": ...}."""
    import math
    import shutil

    import numpy as np

    from mvsformer_torch.config import Config, save_config
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.train.step import TrainStep
    from mvsformer_torch.utils.pfm import read_pfm

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    dev_arg = device if device == "cpu" else "cuda:0"
    rows, launches = {}, {}

    def add_launches(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    try:
        # 16a-16c: one torchrun launch of two ranks (the kernels are built: phase 2).
        job = os.path.join(root, "job.json")
        with open(job, "w") as f:
            json.dump(_grid_job(root), f)
        ranks_s = Torchrun([os.path.join(here, "chip_smoke.py"), "--parallel-rank", job, card,
                            dev_arg], "parallel_ranks").wait()
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                 for r in range(PAR_RANKS)]
        print(f"16a-16c: {PAR_RANKS} gloo ranks on {dev_arg} in {ranks_s:.1f} s "
              f"(their start included) [{card}]", flush=True)

        # 16a. Against phase 4's serial request.
        errs = []
        for r in ranks:
            a = r["16a"]
            errs.append((float((a["depth"] - serial[0].cpu()).abs().max()),
                         float((a["conf"] - serial[1].cpu()).abs().max())))
            want = {n: s["per_request"] for n, s in specs.items()} if device != "cpu" else {}
            if a["launches"] != want:
                raise RuntimeError(f"16a rank {r['rank']}: launches {a['launches']}, "
                                   f"want {want}")
            add_launches(a["launches"])
            print(f"16a rank {r['rank']}: request {a['ms']:.1f} ms (gloo all-reduces of the view "
                  f"sums included), peak {a['peak_gb']:.3f} GB; launches {a['launches']}; K1 "
                  f"source shapes [B, Vs, h, w, C] {a['k1_shapes']} [{card}]", flush=True)
        rows.update(ranks[0]["16a"].get("rows", {}))
        worst_d, worst_c = max(e[0] for e in errs), max(e[1] for e in errs)
        # The ranks regularise the same all-reduced volume, but cuDNN's
        # transposed 3D convs are not deterministic (ROADMAP C): the ranks
        # agree within the same bounds, not bit for bit.
        between = (max(float((r["16a"]["depth"] - ranks[0]["16a"]["depth"]).abs().max())
                       for r in ranks),
                   max(float((r["16a"]["conf"] - ranks[0]["16a"]["conf"]).abs().max())
                       for r in ranks))
        print(f"16a view 2 against phase 4's serial request: depth {worst_d:.3e}, confidence "
              f"{worst_c:.3e}; the ranks against each other: depth {between[0]:.3e}, "
              f"confidence {between[1]:.3e} (bounds {E2E_DEPTH_ATOL:g}, {E2E_CONF_ATOL:g})",
              flush=True)
        if max(worst_d, between[0]) > E2E_DEPTH_ATOL or max(worst_c, between[1]) > E2E_CONF_ATOL:
            raise RuntimeError("16a: the view-split request disagrees with the serial one")

        # 16b and 16c. Against the serial step on the same weights and batch.
        batch = synthetic_batch(torch, TRAIN_B, TRAIN_V, TRAIN_H, TRAIN_W, device=device,
                                with_gt=True)
        checks = {}
        for key, norm, data in (("16b", "BN", PAR_RANKS), ("16c", "GN", 1)):
            cfg = _par_config(norm, TRAIN_MICRO)
            model = build_model(cfg.arch, device=device, train=True)
            random_init_(model, torch.Generator().manual_seed(1))
            if data > 1:
                loss, grads = serial_ddp_grads(torch, model, batch, TRAIN_MICRO, data, cfg.arch)
            else:
                loss = TrainStep(model, cfg, seed=0)(batch)["loss"]
                grads = {n: p.grad.detach() for n, p in model.named_parameters()
                         if p.grad is not None}
            buffers = {n: t.detach() for n, t in model.named_buffers() if t.is_floating_point()}
            want_train = {"warp_corr_fwd": 0, "warp_corr_bwd": 0} if device == "cpu" else {
                n: len(cfg.arch.ndepths) * TRAIN_B // TRAIN_MICRO
                for n in ("warp_corr_fwd", "warp_corr_bwd")}
            for r in ranks:
                got = r[key]
                counts = {n: got["launches"].get(n, 0) for n in want_train}
                extra = {n: c for n, c in got["launches"].items() if n not in want_train}
                if counts != want_train or extra:
                    raise RuntimeError(f"{key} rank {r['rank']}: launches {got['launches']}, "
                                       f"want {want_train}")
                add_launches(got["launches"])
                print(f"{key} rank {r['rank']} ({norm}, "
                      + (f"data {data}: {TRAIN_B // data} samples as micro-batches of "
                         f"{TRAIN_MICRO // data}" if data > 1 else
                         f"view {PAR_RANKS}: {TRAIN_B} samples, 1 + "
                         f"{(TRAIN_V - 1) // PAR_RANKS} views")
                      + f"): first step {got['first_ms']:.1f} ms, second {got['ms']:.1f} ms, "
                      f"peak {got['peak_gb']:.2f} GB; launches {got['launches']}; loss "
                      f"{got['metrics']['loss']:.6f}, grad norm {got['metrics']['grad_norm']:.5f}"
                      f" [{card}]", flush=True)
                checks.setdefault(key, []).append(compare_grid_step(
                    torch, card, f"{key} rank {r['rank']}", got, loss, grads, buffers))
            del model, grads, buffers
            if device != "cpu":
                torch.cuda.empty_cache()
        for name, rs in ranks[0]["16c"].get("rows", {}).items():
            rows[name] = rs

        # 16e. Against phase 4's serial request, launches on every rank.
        errs_e = []
        for r in ranks:
            e = r["16e"]
            errs_e.append((float((e["depth"] - serial[0].cpu()).abs().max()),
                           float((e["conf"] - serial[1].cpu()).abs().max())))
            want = {n: s["per_request"] for n, s in specs.items()} if device != "cpu" else {}
            if e["launches"] != want:
                raise RuntimeError(f"16e rank {r['rank']}: launches {e['launches']}, "
                                   f"want {want}")
            add_launches(e["launches"])
            for name, rs in e["rows"].items():
                rows[name] = rows.get(name, []) + rs
            print(f"16e rank {r['rank']} (depth {PAR_RANKS}): request {e['ms']:.1f} ms "
                  f"(recorded), peak {e['peak_gb']:.3f} GB; "
                  f"launches {e['launches']}; depth {errs_e[-1][0]:.3e}, confidence "
                  f"{errs_e[-1][1]:.3e} from phase 4's serial request [{card}]", flush=True)
        between_e = (max(float((r["16e"]["depth"] - ranks[0]["16e"]["depth"]).abs().max())
                         for r in ranks),
                     max(float((r["16e"]["conf"] - ranks[0]["16e"]["conf"]).abs().max())
                         for r in ranks))
        worst_e = (max(e[0] for e in errs_e), max(e[1] for e in errs_e))
        print(f"16e depth {PAR_RANKS} against phase 4's serial request: depth {worst_e[0]:.3e}, "
              f"confidence {worst_e[1]:.3e}; the ranks against each other: depth "
              f"{between_e[0]:.3e}, confidence {between_e[1]:.3e} (bounds {E2E_DEPTH_ATOL:g}, "
              f"{E2E_CONF_ATOL:g})", flush=True)
        if (max(worst_e[0], between_e[0]) > E2E_DEPTH_ATOL
                or max(worst_e[1], between_e[1]) > E2E_CONF_ATOL):
            raise RuntimeError("16e: the depth-slab request disagrees with the serial one")
        ranks_meta = [{k: r[k] for k in ("16a", "16b", "16c", "16e")} for r in ranks]
        for r in ranks_meta:
            for k in ("16b", "16c"):
                r[k] = {f: v for f, v in r[k].items() if f not in ("grads", "buffers", "rows")}
            for k in ("16a", "16e"):
                r[k] = {f: v for f, v in r[k].items() if f not in ("depth", "conf", "rows")}
        del batch, ranks

        # 16d. The CLIs under torchrun: the three launches run at once, beside
        # the serial test CLI in this process (their times overlap).
        import dataclasses

        data = os.path.join(root, "dtu")
        write_dtu_train_tree(data, PAR_TRAIN_VIEWS, img_hw=PAR_TRAIN_IMG_HW)
        eval_data = write_dtu_scan(os.path.join(root, "eval"))
        listfile = os.path.join(root, "scans.txt")
        with open(listfile, "w") as f:
            f.write("scan1\n")
        cfg = Config()
        cfg.data.datapath = data
        cfg.data.train_data_list = cfg.data.val_data_list = listfile
        cfg.data.height, cfg.data.width = PAR_TRAIN_HW
        cfg.data.resize_scale = 0.5
        cfg.data.multi_scale_args.scales = [list(PAR_TRAIN_HW)]
        cfg.trainer.epochs, cfg.trainer.logging_every = 1, 1
        cfg.trainer.save_dir = os.path.join(root, "saved")
        configs = {}
        # data 2: batch 8, 4 a rank as 2 micro-batches; NCCL, world 1: batch 16 as 4.
        for name, batch, micro in (("grid", 8, 2), ("nccl", 16, 4)):
            cfg.name, cfg.data.batch_size = name, batch
            cfg.data.multi_scale_args.scale_batch_map = {str(PAR_TRAIN_HW[0]): micro}
            configs[name] = os.path.join(root, f"{name}.json")
            save_config(cfg, configs[name])
        model = build_model(cfg.arch, device="cpu")
        random_init_(model, torch.Generator().manual_seed(0))
        ckpt = os.path.join(root, "model.pth")
        torch.save({"state_dict": model.state_dict()}, ckpt)
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump({"arch": dataclasses.asdict(cfg.arch)}, f)
        del model

        def test_args(out):
            return ["--testpath", eval_data, "--testlist", listfile, "--ckpt_dir", root,
                    "--torch_ckpt", ckpt, "--outdir", out, "--skip_fusion", "--max_h", str(H),
                    "--max_w", str(W), "--ndepths", str(NDEPTH_FULL), "--num_view",
                    str(PIPE_NUM_VIEW), "--dtype", "fp32"]

        nccl = device != "cpu"
        dev_flag = ["--device", dev_arg]
        launches_16d = {
            "train": Torchrun(["-m", "mvsformer_torch.train", "--config", configs["grid"],
                               "--data_parallel", str(PAR_RANKS), "--dist_backend", "gloo"]
                             + dev_flag, "parallel_train_cli"),
            "test": Torchrun(["-m", "mvsformer_torch.test"] + test_args(
                os.path.join(root, "grid_out")) + ["--view_parallel", str(PAR_RANKS),
                                                   "--dist_backend", "gloo"] + dev_flag,
                "parallel_test_cli"),
            "depth": Torchrun(["-m", "mvsformer_torch.test"] + test_args(
                os.path.join(root, "depth_out")) + ["--depth_parallel", str(PAR_RANKS),
                                                    "--dist_backend", "gloo"] + dev_flag,
                "parallel_depth_cli"),
            "nccl": Torchrun(["-m", "mvsformer_torch.train", "--config", configs["nccl"],
                              "--dist_backend", "nccl" if nccl else "gloo", "--dtype", "fp32"]
                             + ([] if nccl else dev_flag), "parallel_nccl_cli", nproc=1)}
        try:
            from mvsformer_torch import test as test_cli

            t0 = time.perf_counter()
            test_cli.main(test_args(os.path.join(root, "serial")) + ["--device", dev_arg])
            serial_s = time.perf_counter() - t0
            cli_s = {k: run.wait() for k, run in launches_16d.items()}
        finally:
            for run in launches_16d.values():
                run.kill()

        # The train CLI at data 2: rank 0 alone writes the run dir.
        run_dir = os.path.join(cfg.trainer.save_dir, "models", "grid")
        recs = read_records(run_dir)
        steps = [r for r in recs if r["kind"] == "step"]
        # 21 samples padded to 22: 11 a rank, 2 steps of 4 (dropping 3).
        want_steps = (PAR_TRAIN_VIEWS * DTU_LIGHTS + 1) // PAR_RANKS // (8 // PAR_RANKS)
        files = sorted(os.listdir(run_dir))
        want_files = sorted(["config.json", "info.log", "train_log.jsonl", "model_best.pth",
                             "model_best.meta.json", "model_last.pth", "model_last.meta.json"])
        if ([r["global_step"] for r in steps] != list(range(1, want_steps + 1))
                or not all(math.isfinite(r["loss"]) for r in steps)
                or [r["kind"] for r in recs].count("val") != 1 or files != want_files):
            raise RuntimeError(f"16d train CLI at data {PAR_RANKS}: records "
                               f"{[(r['kind'], r.get('global_step')) for r in recs]}, files "
                               f"{files}")
        val = next(r for r in recs if r["kind"] == "val")
        for r in recs:
            add_launches(r.get("launches", {}))
        print(f"16d train CLI, data {PAR_RANKS} (gloo, {dev_arg}, bf16, the CLI's default): "
              f"{cli_s['train']:.1f} s; "
              f"{len(steps)} steps, each recorded once by rank 0 (loss "
              + ", ".join(f"{r['loss']:.5f}" for r in steps) + f"; ms "
              + ", ".join(f"{r['ms']:.0f}" for r in steps)
              + f"), one validation (mean error {val['mean_error']:.4f}); the run dir holds "
              f"one set: {files} [{card}]", flush=True)

        # The test CLI at view 2 against the serial CLI, on phase 11's plane scan.
        def tree(top):
            return sorted(os.path.relpath(os.path.join(d, f), top)
                          for d, _, fs in os.walk(top) for f in fs)

        def cli_gaps(out, what, key):
            """The files of a test CLI run under torchrun against the serial
            CLI's: the same names, depth and confidence within phase 7's
            bounds."""
            one, two = tree(os.path.join(root, "serial")), tree(os.path.join(root, out))
            if one != two or not one:
                raise RuntimeError(f"16d test CLI: the {what} run wrote {len(two)} files, the "
                                   f"serial one {len(one)}, or other names")
            gaps = [0.0, 0.0]
            for f in one:
                if f.endswith(".pfm"):
                    a, b = (read_pfm(os.path.join(root, d, f))[0] for d in ("serial", out))
                    gaps[0] = max(gaps[0], float(np.abs(a - b).max()))
                elif f.endswith(".npy"):
                    a, b = (np.load(os.path.join(root, d, f)) for d in ("serial", out))
                    gaps[1] = max(gaps[1], float(np.abs(a - b).max()))
            print(f"16d test CLI, {what} (gloo, {dev_arg}, fp32, {PIPE_NUM_VIEW} views a "
                  f"request at {H}x{W}): {cli_s[key]:.1f} s (serial {serial_s:.1f} s in this "
                  f"process); the same {len(one)} files; depth {gaps[0]:.3e}, confidence "
                  f"{gaps[1]:.3e} from the serial CLI's (bounds {E2E_DEPTH_ATOL:g}, "
                  f"{E2E_CONF_ATOL:g}) [{card}]", flush=True)
            if gaps[0] > E2E_DEPTH_ATOL or gaps[1] > E2E_CONF_ATOL:
                raise RuntimeError(f"16d: the {what} test CLI disagrees with the serial one")
            return gaps

        gaps = cli_gaps("grid_out", f"view {PAR_RANKS}", "test")
        depth_gaps = cli_gaps("depth_out", f"depth {PAR_RANKS}", "depth")

        # The train CLI at world 1 on NCCL, one step.
        recs = read_records(os.path.join(cfg.trainer.save_dir, "models", "nccl"))
        steps = [r for r in recs if r["kind"] == "step"]
        if len(steps) != 1 or not math.isfinite(steps[0]["loss"]):
            raise RuntimeError(f"16d train CLI on nccl: {recs}")
        for r in recs:
            add_launches(r.get("launches", {}))
        where = "cuda:LOCAL_RANK" if nccl else dev_arg
        print(f"16d train CLI, world 1 on {'nccl' if nccl else 'gloo'} ({where}): "
              f"{cli_s['nccl']:.1f} s; one step, loss {steps[0]['loss']:.5f}; its validation "
              f"all-reduced on the backend [{card}]", flush=True)
        details = {"ranks_s": ranks_s, "16a_errors": errs, "16a_between_ranks": between,
                   "16a": [{k: r["16a"][k] for k in ("ms", "peak_gb", "launches", "k1_shapes")}
                           for r in ranks_meta],
                   "16bc_ranks": [{k: {f: r[k][f] for f in ("first_ms", "ms", "peak_gb",
                                                            "launches", "metrics")}
                                   for k in ("16b", "16c")} for r in ranks_meta],
                   "16bc": checks,
                   "16e_errors": errs_e, "16e_between_ranks": between_e,
                   "16e": [{k: r["16e"][k] for k in ("ms", "peak_gb", "launches")}
                           for r in ranks_meta],
                   "train_cli_s": cli_s["train"], "test_cli_s": cli_s["test"],
                   "serial_test_cli_s": serial_s, "test_cli_gaps": gaps,
                   "depth_cli_s": cli_s["depth"], "depth_cli_gaps": depth_gaps,
                   "nccl_cli_s": cli_s["nccl"],
                   "phase_s": time.perf_counter() - t_phase}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 16 (the process grid): {details['phase_s']:.1f} s [{card}]", flush=True)
    return {"rows": rows, "launches": launches, "details": details}


# The rest of the model variants (phase 17, ROADMAP A6): multi_scale for both
# models, DINO's decoder without the attention fusion, `remat_backbone`, the
# cross-view ViT and the similarity diagnostic. Each eval config is seeded by
# `random_init_`; the DINO ones are configs/config_mvsformer-p.json's arch
# with the field set.
A6_EVALS = {
    "twin multi_scale": ("twin", dict(multi_scale=True)),
    "dino multi_scale": ("dino", dict(multi_scale=True)),
    "dino att_fusion=false": ("dino", dict(att_fusion=False)),
}
# Launches a request: K5 runs the top-down FPN levels only, which the
# multi-scale FPN (FPNDecoderV2) does not have; K6 runs in the Twins backbone.
A6_LAUNCHES = {
    "twin multi_scale": {"warp_group_corr": 4, "visibility_net": 4, "depth_decode": 4,
                         "encoder_head": 1, "fpn_level": 0, "gsa_attention": 9},
    "dino multi_scale": {"warp_group_corr": 4, "visibility_net": 4, "depth_decode": 4,
                         "encoder_head": 1, "fpn_level": 0, "gsa_attention": 0},
    "dino att_fusion=false": {"warp_group_corr": 4, "visibility_net": 4, "depth_decode": 4,
                              "encoder_head": 1, "fpn_level": 3, "gsa_attention": 0},
}
A6_CHECKED = ("warp_group_corr", "visibility_net", "depth_decode", "encoder_head",
              "gsa_attention")  # at every launch of the Twins multi-scale request
A6_TIMED_STEPS = 2                # after the compared one, which warms each model up
# The remat step's gradients against the plain step's, per layer group
# (relative L2, 1 - cosine, |norm ratio - 1|), both steps with deterministic
# cuDNN: without it the forward is not bit-reproducible, some stage 3-4
# depths move from run to run and the next stage's windows with them, and
# any two steps, plain or remat, differ by 2e-3 to 4e-2. With it an H100
# read 1.4e-6 to 1.0e-5 for every pair (K8's atomics), and a remat that does
# not replay the drop path's generator 1e-1 or more in the backbone
# (`python -m mvsformer_torch.remat_probe`).
A6_REMAT_GRAD_L2 = 1e-4
CROSS_VIEWS = V                   # DINOViT(cross_att=True, nview=5)
CROSS_SMALL_HW = (128, 192)       # the ViT input of the card-vs-CPU check (an 8x12 grid)
CROSS_RTOL_OF_SCALE = 1e-4        # tokens and attention, card against CPU, fp32
SIM_SHARE = 0.8                   # of the pixels, the CPU's sim_depth pick is the card's
SIM_ATOL = 1e-5                   # elsewhere, the CPU's cosine sum at the card's pick
                                  # within this of its maximum (tests/test_torch_multiscale.py)


@contextlib.contextmanager
def deterministic_math(torch):
    """Within the block, cuDNN's deterministic algorithms and PyTorch's
    deterministic implementations (an op without one warns)."""
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def a6_config(kind, over):
    """The ModelConfig of an A6 cell: the default one (Twins) or the -p
    config's arch (DINO), with `over` set (att_fusion on the ViT's
    fields)."""
    import dataclasses

    from mvsformer_torch.config import ModelConfig, load_config

    if kind == "twin":
        cfg = ModelConfig()
    else:
        cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       DINO_CONFIG)).arch
    vit = {k: v for k, v in over.items() if k == "att_fusion"}
    cfg = dataclasses.replace(cfg, **{k: v for k, v in over.items() if k not in vit})
    cfg.vit_args = dataclasses.replace(cfg.vit_args, **vit)
    return cfg


def gate_cross_blocks_(torch, vit, generator):
    """Non-zero gates (alpha1 in [0.5, 1.5], alpha2 in [-1.5, -0.5]) and a
    token-type table ~ N(0, 1) from `generator` in each cross block: with
    its zero-initialised gates a cross block is the identity. -> the
    number of cross blocks."""
    from mvsformer_torch.models.cross_attention import CrossBlock

    blocks = [m for m in vit.modules() if isinstance(m, CrossBlock)]
    with torch.no_grad():
        for blk in blocks:
            u = torch.rand(2, generator=generator)
            blk.alpha1.fill_(0.5 + float(u[0]))
            blk.alpha2.fill_(-0.5 - float(u[1]))
            w = blk.tok_embeddings.weight
            w.copy_(torch.randn(w.shape, generator=generator).to(w.device))
    return len(blocks)


def similarity_agreement(got_sim_depth, dv, sims):
    """One stage's sim_depth [B, H, W] of one side against the other side's
    hypotheses `dv` [B, D, H, W] and summed cosine volume `sims` [B, D, H,
    W] (CPU tensors): (the share of pixels where the other side's argmax
    is the hypothesis nearest `got_sim_depth`, the other side's largest
    shortfall at that hypothesis below its maximum). Argmax ties flip
    under either side's rounding, so both are held: the share to SIM_SHARE
    or more, the shortfall to SIM_ATOL or less."""
    pick = (dv - got_sim_depth[:, None]).abs().argmin(dim=1, keepdim=True)
    share = float((pick == sims.argmax(dim=1, keepdim=True)).float().mean())
    shortfall = float((sims.max(dim=1).values - sims.gather(1, pick)[:, 0]).max())
    return share, shortfall


def variants_a6_phase(torch, card, eval_specs, device="cuda"):
    """Phase 17. `eval_specs`: phase 4's K1-K6 specs. Returns {"rows":
    K1-K4's and K6's checked launches in the Twins multi-scale request,
    "launches": one request's of each config and one timed step's of each
    remat setting, "details"}."""
    import copy
    import math

    from mvsformer_torch import fp32_math
    from mvsformer_torch.config import Config
    from mvsformer_torch.infer import make_infer_fn
    from mvsformer_torch.models import stagenet
    from mvsformer_torch.models.dino import build_vit
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.ops import cuda_build
    from mvsformer_torch.train.step import TrainStep

    t_phase = time.perf_counter()
    request = synthetic_request(torch, B, V, H, W, device=device)
    details, total, rows = {}, {}, {}

    def add(counts):
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c

    # 17a-c. Each config at the DTU request, and on the card against the CPU
    # at E2E_SHAPE; K1-K4 and K6 at every launch of the Twins request; the
    # Twins request with the similarity on the card against the CPU.
    for name, (kind, over) in A6_EVALS.items():
        model = build_model(a6_config(kind, over), device=device)
        random_init_(model, torch.Generator().manual_seed(0))
        fn = make_infer_fn(model, tmps=(5.0, 5.0, 5.0, 1.0))
        fn(*request)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        depth, conf, _ = fn(*request)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {n: dict(cuda_build.LAUNCHES).get(n, 0) for n in eval_specs}
        if counts != A6_LAUNCHES[name]:
            raise RuntimeError(f"{name}: launches {counts} in a request, "
                               f"want {A6_LAUNCHES[name]}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        add(counts)
        line = check_variant_outputs(torch, model, depth, conf)
        print(f"{name} ({type(model.decoder_vit).__name__}, {type(model.decoder).__name__}): "
              f"request {ms:.2f} ms, {B / ms * 1e3:.4f} depth-maps/s, peak memory "
              f"{peak_gb:.3f} GB; launches {counts}; {line} [{card}]", flush=True)
        det = {"request_ms": ms, "peak_memory_gb": peak_gb, "launches": counts}
        if kind == "twin":
            det["layers_ms"] = layer_breakdown(torch, model, fn, request)
            print(f"{name} layers (device ms, one request): " + json.dumps(
                {k: round(v, 3) for k, v in det["layers_ms"].items()}))
            specs = {n: eval_specs[n] for n in A6_CHECKED}
            recorded, _ = record_calls(torch, specs, fn, *request)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            for n, calls in recorded.items():
                if len(calls) != A6_LAUNCHES[name][n]:
                    raise RuntimeError(f"{name} {n}: recorded {len(calls)} calls")
                rows[n] = [check_kernel(torch, card, n, specs[n],
                                        f"{name} " + call_label(n, i, args), args, kwargs)
                           for i, (args, kwargs) in enumerate(calls)]
            del recorded
        e2e = small_request_errors(torch, model, make_infer_fn)
        e2e_ok = all(e <= (E2E_DEPTH_ATOL if k == "refined_depth" else E2E_CONF_ATOL)
                     for k, e in e2e.items())
        print(f"{name} request {E2E_SHAPE} on the card against the CPU: max_abs_err "
              + ", ".join(f"{k} {e:.3e}" for k, e in e2e.items())
              + f" (tolerance depth {E2E_DEPTH_ATOL:g}, confidence {E2E_CONF_ATOL:g}) "
              + ("ok" if e2e_ok else "FAILED"), flush=True)
        if not e2e_ok:
            raise RuntimeError(f"{name}: the forward on the card disagrees with the CPU's")
        det["e2e_small_errors"] = e2e
        if kind == "twin":
            # The similarity diagnostic, card against CPU, at E2E_SHAPE.
            cpu_model = copy.deepcopy(model).cpu()
            sums, original = [], stagenet.cosine_similarity_volume

            def record(*args):
                sums.append(original(*args))
                return sums[-1]

            with torch.inference_mode():
                got = model(*synthetic_request(torch, *E2E_SHAPE, device=device),
                            tmp=[5.0, 5.0, 5.0, 1.0], want_similarity=True)
                stagenet.cosine_similarity_volume = record
                try:
                    want = cpu_model(*synthetic_request(torch, *E2E_SHAPE, device="cpu"),
                                     tmp=[5.0, 5.0, 5.0, 1.0], want_similarity=True)
                finally:
                    stagenet.cosine_similarity_volume = original
            views = E2E_SHAPE[1] - 1
            sim = [similarity_agreement(got[f"stage{i + 1}"]["sim_depth"].cpu(),
                                        want[f"stage{i + 1}"]["depth_values"],
                                        sum(sums[i * views:(i + 1) * views]))
                   for i in range(len(model.fusions))]
            sim_ok = all(s >= SIM_SHARE and d <= SIM_ATOL for s, d in sim)
            gap = max_err(got["refined_depth"].cpu(), want["refined_depth"])
            print(f"{name} with want_similarity {E2E_SHAPE} on the card against the CPU: "
                  f"sim_depth per stage (share of pixels with the CPU's pick, its largest "
                  f"cosine shortfall at the card's) "
                  + ", ".join(f"{s:.4f}/{d:.2e}" for s, d in sim)
                  + f" (at least {SIM_SHARE:g}, at most {SIM_ATOL:g}); refined depth "
                  f"{gap:.3e} ({E2E_DEPTH_ATOL:g}) [{card}] "
                  + ("ok" if sim_ok and gap <= E2E_DEPTH_ATOL else "FAILED"), flush=True)
            if not sim_ok or gap > E2E_DEPTH_ATOL:
                raise RuntimeError(f"{name}: the similarity request disagrees with the CPU's")
            det["similarity"] = sim
            del cpu_model, got, want, sums
        details[name] = det
        del model, fn, depth, conf
        torch.cuda.empty_cache()

    # 17d. The Twins multi-scale step at phase 8's shape, remat off and on:
    # the same weights and generator seed (drop path 0.2). The first step
    # of each, with deterministic algorithms, is compared, the next
    # A6_TIMED_STEPS timed.
    batch = synthetic_batch(torch, TRAIN_B, TRAIN_V, TRAIN_H, TRAIN_W, device=device,
                            with_gt=True)
    n_micro = TRAIN_B // TRAIN_MICRO
    per_step = {n: (4 * n_micro if n in TRAIN_PER_MICRO else 0)
                for n in list(eval_specs) + list(TRAIN_PER_MICRO)}
    state, grads, first_loss = None, {}, {}
    for label, remat in (("plain", False), ("remat", True)):
        cfg = Config()
        cfg.arch.multi_scale, cfg.arch.remat_backbone = True, remat
        model = build_model(cfg.arch, device=device, train=True)
        if state is None:
            random_init_(model, torch.Generator().manual_seed(1))
            state = copy.deepcopy(model.state_dict())
        else:
            model.load_state_dict(state)
        step = TrainStep(model, cfg, seed=0)
        with deterministic_math(torch):
            first_loss[label] = step(batch)["loss"]
        grads[label] = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                        if p.grad is not None}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(A6_TIMED_STEPS):
            cuda_build.reset_launches()
            t0 = time.perf_counter()
            metrics = step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            counts = dict(cuda_build.LAUNCHES)
            if ({n: counts.get(n, 0) for n in per_step} != per_step
                    or set(counts) - set(per_step)):
                raise RuntimeError(f"multi_scale step (remat {remat}): launches {counts}, "
                                   f"want {per_step}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        bad = bad_gradients(torch, model)
        if bad or not all(math.isfinite(v) for k, v in metrics.items() if k.startswith("loss")):
            raise RuntimeError(f"multi_scale step (remat {remat}): loss {metrics['loss']}, "
                               f"bad gradients {bad[:8]}")
        add(counts)
        print(f"twin multi_scale step, remat_backbone {remat} ({TRAIN_B} as {n_micro} "
              f"micro-batches of {TRAIN_MICRO}, {TRAIN_V} views, {TRAIN_H}x{TRAIN_W}, "
              f"{NDEPTH_FULL} depths, drop path {model.vit.blocks[-1][-1].drop_path_rate:g} "
              f"in the last block): " + ", ".join(f"{t:.2f}" for t in times)
              + f" ms, peak memory {peak_gb:.2f} GB; launches {counts} a step; loss "
              f"{metrics['loss']:.5f} [{card}]", flush=True)
        details[f"step remat {remat}"] = {"step_ms": times, "peak_memory_gb": peak_gb,
                                          "launches": counts, "metrics": metrics}
        del model, step
        torch.cuda.empty_cache()
    del batch
    groups = {}
    for g in STEP_GROUPS:
        names = sorted(n for n in grads["plain"] if n.startswith(g + "."))
        a, b = (torch.cat([grads[k][n].double().reshape(-1) for n in names]).cpu().numpy()
                for k in ("remat", "plain"))
        ok, r = grad_group_check(a, b, bound=A6_REMAT_GRAD_L2)
        caught = [k for k, mut in grad_mutants(a).items()
                  if not grad_group_check(mut, b, bound=A6_REMAT_GRAD_L2)[0]]
        groups[g] = dict(r, ok=ok, mutants_rejected=len(caught))
        if not ok or len(caught) != len(grad_mutants(a)):
            raise RuntimeError(f"remat step {g}: gradients {r} against the plain step "
                               f"(bound {A6_REMAT_GRAD_L2:g}; mutants rejected {caught})")
    print("twin multi_scale step, remat against plain with deterministic cuDNN, gradients "
          f"per group (relative L2 / 1 - cosine / norm ratio, bound {A6_REMAT_GRAD_L2:g}, 5 "
          f"mutants rejected in each): "
          + ", ".join(f"{g} {r['err']:.2e}/{1 - r['cos']:.1e}/{r['norm']:.7f}"
                      for g, r in groups.items())
          + "; first-step losses " + ", ".join(f"{k} {v:.7f}" for k, v in first_loss.items())
          + f" [{card}]", flush=True)
    details["remat_grads"] = dict(groups, first_loss=first_loss)
    del grads, state

    # 17e. DINOViT with the cross-view blocks (5 views a sample, non-zero
    # gates, epipoles): card against CPU at a reduced size, the DTU request's
    # ViT input (5 x 576 x 768) timed on the card, with and without them.
    vit = build_vit("vit_small", cross_att=True, nview=CROSS_VIEWS)
    gen = torch.Generator().manual_seed(5)
    random_init_(vit, gen)
    n_cross = gate_cross_blocks_(torch, vit, gen)
    epipoles = torch.randn((1, CROSS_VIEWS - 1, 2), generator=gen) * 100
    x = torch.randn((CROSS_VIEWS, 3) + CROSS_SMALL_HW, generator=gen)
    card_vit = copy.deepcopy(vit).to(device).eval()
    with torch.no_grad(), fp32_math():
        want = vit(x, epipoles)
        got = card_vit(x.to(device), epipoles.to(device))
    errs = [max_err(g.cpu(), w) / max(1.0, float(w.abs().max())) for g, w in zip(got, want)]
    ok = max(errs) <= CROSS_RTOL_OF_SCALE and all(bool(torch.isfinite(g).all()) for g in got)
    plain = build_vit("vit_small").to(device).eval()
    plain.load_state_dict(card_vit.state_dict(), strict=False)
    full = torch.randn((CROSS_VIEWS, 3, H // 2, W // 2), generator=gen).to(device)
    epi_full = epipoles.to(device)
    with torch.no_grad(), fp32_math():
        cross_ms = time_ms(torch, lambda: card_vit(full, epi_full), reps=3)
        plain_ms = time_ms(torch, lambda: plain(full), reps=3)
        tok, _ = card_vit(full, epi_full)
    if not bool(torch.isfinite(tok).all()):
        raise RuntimeError("the cross-view ViT's tokens are not finite at the DTU size")
    print(f"DINOViT cross_att ({n_cross} cross blocks, {CROSS_VIEWS} views, non-zero gates, "
          f"epipoles) {CROSS_VIEWS}x3x{CROSS_SMALL_HW[0]}x{CROSS_SMALL_HW[1]} on the card "
          f"against the CPU: tokens {errs[0]:.2e}, attention {errs[1]:.2e} of scale "
          f"(tolerance {CROSS_RTOL_OF_SCALE:g}) {'ok' if ok else 'FAILED'}; at "
          f"{CROSS_VIEWS}x3x{H // 2}x{W // 2} {cross_ms:.2f} ms, without the cross blocks "
          f"{plain_ms:.2f} ms [{card}]", flush=True)
    if not ok:
        raise RuntimeError("the cross-view ViT on the card disagrees with the CPU's")
    details["cross_vit"] = {"errs_of_scale": errs, "ms": cross_ms, "plain_ms": plain_ms,
                            "blocks": n_cross}
    del vit, card_vit, plain, full, tok
    torch.cuda.empty_cache()
    details["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 17 (the variants of A6): {details['phase_s']:.1f} s", flush=True)
    return {"rows": rows, "launches": total, "details": details}


# The training options no shipped config sets (phase 18, ROADMAP A4): the
# focal ce loss (gamma 2) with a global-norm clip that binds, and DINO's
# layer decay with the ViT trained (fix off). The clip at phase 8's shape
# is about a tenth of the global norm its step reads at random weights
# (1.9), and 1e-2 at phase 10's small shape: each binds, which the phase
# checks.
OPT_CLIP = {"full": 0.2, "small": 1e-2}
OPT_GAMMA = 2.0


def options_config(over_arch=None, over_opt=None, base=None):
    """Phase 8's Config (or `base`) with `over_arch` / `over_opt` set."""
    from mvsformer_torch.config import Config

    cfg = base if base is not None else Config()
    for k, v in (over_arch or {}).items():
        setattr(cfg.arch, k, v)
    for k, v in (over_opt or {}).items():
        setattr(cfg.optimizer, k, v)
    return cfg


def clipped_norm(torch, model) -> float:
    """The global norm of the gradients a step left (after its clip)."""
    return float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in model.parameters() if p.grad is not None])))


def options_small(cfg):
    """`cfg` at phase 10's shape: drop path 0, no warmup, micro-batches of 1."""
    cfg.arch.vit_args.drop_path_rate = 0.0
    cfg.optimizer.warmup_steps = 0
    cfg.data.multi_scale_args.scale_batch_map = {str(STEP_SHAPE[2]): 1}
    return cfg


def layer_decay_config():
    """18c's config: the -p config (DINO, layer decay) at phase 10's
    shape, the ViT trained (`fix` off)."""
    from mvsformer_torch.config import load_config

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = options_small(load_config(os.path.join(here, DINO_CONFIG)))
    cfg.arch.fix = False
    return cfg


def worst_of_scale(got, want):
    """(the largest max |got - want| / max |want| over the tensors whose
    norm exceeds 1e-4, that tensor's name): compare_steps' reading."""
    worst, at = 0.0, None
    for n, w in want.items():
        if float(w.norm()) > 1e-4:
            e = float((got[n].cpu().to(w.dtype) - w).abs().max()) / float(w.abs().max())
            if e > worst:
                worst, at = e, n
    return worst, at


def options_step_pair(torch, label, cfg, seed, card, device="cuda", card_math=None,
                      arbiter=False):
    """One step of `cfg` at phase 10's shape from the same weights
    (`random_init_` at `seed`) on the card, under `card_math(torch)` (a
    context; by default `deterministic_math`), and on the CPU, compared by
    compare_steps at phase 10's bounds. With `arbiter`, also a float64 CPU
    step from the same weights: the largest gradient error of scale of the
    card's and of the CPU's fp32 step against it (which of the two fp32
    steps the card-CPU gap comes from). Prints the readings; returns
    (card model, CPU model, card step, CPU step, the weights before,
    details with "ok")."""
    import copy

    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.train.step import TrainStep

    sb, sv, sh, sw = STEP_SHAPE
    cpu_model = build_model(cfg.arch, device="cpu", train=True)
    random_init_(cpu_model, torch.Generator().manual_seed(seed))
    card_model = copy.deepcopy(cpu_model).to(device)
    model64 = copy.deepcopy(cpu_model).double() if arbiter else None
    before = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    t0 = time.perf_counter()
    card_step, cpu_step = TrainStep(card_model, cfg, seed=0), TrainStep(cpu_model, cfg, seed=0)
    with (card_math or deterministic_math)(torch):
        card_m = card_step(synthetic_batch(torch, sb, sv, sh, sw, device=device, with_gt=True))
    cpu_m = cpu_step(synthetic_batch(torch, sb, sv, sh, sw, device="cpu", with_gt=True))
    ok, errs, lines = compare_steps(torch, card_model, cpu_model, before, card_m, cpu_m,
                                    cfg.optimizer)
    print(f"{label} step {STEP_SHAPE} on the card against the CPU "
          f"({time.perf_counter() - t0:.1f} s): loss {card_m['loss']:.6f} / "
          f"{cpu_m['loss']:.6f}; grad norm {card_m['grad_norm']:.5f} / "
          f"{cpu_m['grad_norm']:.5f} before the clip, {clipped_norm(torch, card_model):.5f}"
          f" / {clipped_norm(torch, cpu_model):.5f} after it; worst errors "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (phase 10's bounds) " + ("ok" if ok else "FAILED") + f" [{card}]", flush=True)
    for line in lines[-10:]:
        print(f"  {line}")
    details = {"ok": ok, "errors": errs, "card": card_m, "cpu": cpu_m}
    if arbiter:
        TrainStep(model64, cfg, seed=0)(
            synthetic_batch(torch, sb, sv, sh, sw, device="cpu", with_gt=True))
        g64 = grads_of(model64)
        card_g, cpu_g = grads_of(card_model), grads_of(cpu_model)
        pair = worst_of_scale(card_g, cpu_g)
        card64, cpu64 = worst_of_scale(card_g, g64), worst_of_scale(cpu_g, g64)
        at = pair[1] or card64[1]  # the two fp32 steps may agree exactly (the CPU twice)
        w64 = g64[at]
        at_card = float((card_g[at].cpu().double() - w64).abs().max()) / float(w64.abs().max())
        at_cpu = float((cpu_g[at].double() - w64).abs().max()) / float(w64.abs().max())
        print(f"  against a float64 CPU step: card {card64[0]:.3e} of scale (at {card64[1]}), "
              f"CPU fp32 {cpu64[0]:.3e} (at {cpu64[1]}); at {at}, where the card and the CPU "
              f"differ most ({pair[0]:.3e}): card {at_card:.3e}, CPU fp32 {at_cpu:.3e}",
              flush=True)
        details["arbiter"] = {"card": card64, "cpu": cpu64, "pair": pair,
                              "at_pair": [at_card, at_cpu]}
        del model64
    return card_model, cpu_model, card_step, cpu_step, before, details


def options_phase(torch, card, device="cuda"):
    """Phase 18: (a) one fp32 step at phase 8's shape with focal (gamma 2)
    and a binding `grad_norm` clip, K7/K8 held to their plain versions at
    every launch; (b) the same options at phase 10's shape, card against
    CPU at phase 10's bounds; (c) DINOMVSNet (the -p config's arch, fix
    off) at phase 10's shape with `layer_decay`: every group's LR and a
    block's update, card against CPU. (b) and (c) run under deterministic
    cuDNN (`options_step_pair`). Returns {"rows", "launches", "details"}."""
    import math

    from mvsformer_torch.config import Config
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.ops import cuda_build
    from mvsformer_torch.train.step import TrainStep

    t_phase = time.perf_counter()
    on_card = device != "cpu"
    nstages = len(Config().arch.ndepths)
    n_micro = TRAIN_B // TRAIN_MICRO
    specs = train_kernel_specs(per_step=nstages * n_micro)
    focal = {"focal": True, "gamma": OPT_GAMMA}

    # 18a. Phase 8's step with focal and the clip.
    cfg = options_config(focal, {"grad_norm": OPT_CLIP["full"]})
    model = build_model(cfg.arch, device=device, train=True)
    random_init_(model, torch.Generator().manual_seed(1))
    step = TrainStep(model, cfg, seed=0)
    batch = synthetic_batch(torch, TRAIN_B, TRAIN_V, TRAIN_H, TRAIN_W, device=device,
                            with_gt=True)
    step(batch)  # warm-up
    if on_card:
        torch.cuda.synchronize()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    recorded, metrics = record_calls(torch, specs, step, batch)
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(cuda_build.LAUNCHES)
    after = clipped_norm(torch, model)
    want = {n: (sp["per_step"] if on_card else 0) for n, sp in specs.items()}
    if {n: launches.get(n, 0) for n in specs} != want or set(launches) - set(specs):
        raise RuntimeError(f"18a: launches {launches}, want {want}")
    clip = OPT_CLIP["full"]
    if not (math.isfinite(metrics["loss"]) and metrics["grad_norm"] > clip
            and abs(after - clip) <= 1e-4 * clip):
        raise RuntimeError(f"18a: loss {metrics['loss']}, grad norm {metrics['grad_norm']} "
                           f"before the clip and {after} after it, clip {clip}")
    print(f"18a focal (gamma {OPT_GAMMA:g}) step, {TRAIN_B} as {n_micro} micro-batches of "
          f"{TRAIN_MICRO}, {TRAIN_V} views, {TRAIN_H}x{TRAIN_W}: {step_ms:.1f} ms (recorded), "
          f"loss {metrics['loss']:.5f}; grad norm {metrics['grad_norm']:.5f} before the clip, "
          f"{after:.5f} after it (grad_norm {clip:g}); launches {launches} [{card}]", flush=True)
    rows = {}
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rows = {name: [check_kernel(torch, card, name, sp, f"focal micro{i // nstages + 1} "
                                    + call_label(name, i % nstages, a), a, k)
                       for i, (a, k) in enumerate(recorded[name])]
                for name, sp in specs.items()}
    details = {"18a": {"ms": step_ms, "metrics": metrics, "norm_after_clip": after,
                       "launches": launches}}
    del recorded, model, step, batch
    if on_card:
        torch.cuda.empty_cache()

    # 18b and 18c. Card against CPU at phase 10's shape.
    cfg = options_small(options_config(focal, {"grad_norm": OPT_CLIP["small"]}))
    card_model, cpu_model, _, _, _, details["18b"] = options_step_pair(
        torch, "18b focal + clip", cfg, 2, card, device)
    if not details["18b"]["ok"]:
        raise RuntimeError("18b: the step on the card disagrees with the CPU step")
    if not details["18b"]["cpu"]["grad_norm"] > OPT_CLIP["small"]:
        raise RuntimeError("18b: the clip did not bind")
    del card_model, cpu_model

    # 18c. DINO with layer decay: the -p config's arch, the ViT trained.
    cfg = layer_decay_config()
    card_model, cpu_model, card_step, cpu_step, before, details["18c"] = options_step_pair(
        torch, f"18c DINO layer decay {cfg.optimizer.layer_decay:g}", cfg, 3, card, device)
    if not details["18c"]["ok"]:
        raise RuntimeError("18c: the step on the card disagrees with the CPU step")
    groups = {}  # each group's LR in the step (warmup 0: the schedule's factor is 1)
    for gc, gp, lc, lp in zip(card_step.optimizer.param_groups, cpu_step.optimizer.param_groups,
                              card_step.scheduler.base_lrs, cpu_step.scheduler.base_lrs):
        if gc["group"] != gp["group"] or lc != lp or gc["lr"] != gp["lr"]:
            raise RuntimeError(f"18c: group {gc['group']} LR {lc} on the card, "
                               f"{gp['group']} {lp} on the CPU")
        groups[gc["group"]] = lc
    depth = len(cpu_model.vit.blocks)
    vit_lr, decay = cfg.optimizer.vit_lr, cfg.optimizer.layer_decay
    for i in range(depth):
        want_lr = vit_lr * decay ** (depth - i)
        if not math.isclose(groups[f"vit_decay_layer{i + 1}"], want_lr, rel_tol=1e-12):
            raise RuntimeError(f"18c: block {i}'s LR {groups[f'vit_decay_layer{i + 1}']}, "
                               f"want {want_lr}")
    # Block 0's qkv weight: the first Adam step moves each entry by its
    # group's LR times the gradient's sign (plus the decay), on both sides.
    name = "vit.blocks.0.attn.qkv.weight"
    lr0 = groups["vit_decay_layer1"]
    p_card = dict(card_model.named_parameters())[name].detach().cpu() - before[name]
    p_cpu = dict(cpu_model.named_parameters())[name].detach() - before[name]
    g = dict(cpu_model.named_parameters())[name].grad
    sure = (g.abs() >= 0.1 * g.abs().max()) & (g.abs() >= 1e-6)  # far above Adam's eps
    if not bool(sure.any()):
        raise RuntimeError(f"18c: {name} took no gradient far above Adam's eps")
    upd_err = float((p_card[sure] - p_cpu[sure]).abs().max())
    moved = float(p_cpu[sure].abs().median())
    print(f"18c groups: {len(groups)}, the same LRs on the card and the CPU, block i at vit_lr "
          f"x {decay:g}^({depth} - i) ({lr0:.4e} for block 0, {groups['rest']:.4e} for the "
          f"cascade); {name}: card against CPU {upd_err:.3e} where the gradient's sign is "
          f"certain, median move {moved:.4e} ({moved / lr0:.4f} of its LR) [{card}]",
          flush=True)
    if upd_err > STEP_UPDATE_OF_LR * lr0 or not 0.5 <= moved / lr0 <= 1.5:
        raise RuntimeError(f"18c: {name} moved {moved} against its LR {lr0} "
                           f"(card against CPU {upd_err})")
    details["18c"].update(groups=groups, block0_update_err=upd_err, block0_median_move=moved)
    details["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 18 (the training options): {details['phase_s']:.1f} s [{card}]", flush=True)
    return {"rows": rows, "launches": launches, "details": details}


# The accuracy gates (phase 19): the JAX package's four gates
# (tests/test_geometric_e2e.py, tests/test_convergence.py) with their
# scenes, configuration, learning rates, step counts, evaluation cadence and
# thresholds, trained by the port. The analytic-plane gates: a textured
# fronto-parallel plane at z = 77 seen by 5 cameras x-translated by 4 units,
# rendered at 128x128 (the committed JPEG views, tools/make_gate_fixtures.py)
# and served at 64x64 over 16 depths from 40 in steps of 5.
GATE_FIXTURES = os.path.join("tests", "fixtures", "gates")
GATE_NV = 5
GATE_IMG = 128                 # the views' size (square)
GATE_HW = 64                   # served at max_h = max_w = 64
GATE_FX = 200.0                # at the views' size; the DTU cam files hold 4 K
GATE_TX = 4.0                  # view v at x = 4 v
GATE_DEPTH = 77.0              # off the grid, between hypotheses 75 and 80
GATE_DMIN, GATE_DITV, GATE_ND = 40.0, 5.0, 16
GATE_TT_FAR = 60.0             # the T&T long-range cams' depth_min, past the plane by this
GATE_TT_PAD = 4                # rows the T&T loader pads at top and bottom: out of the loss
GATE_NUM_VIEW = 3
GATE_LR, GATE_STEPS, GATE_EVAL_EVERY = 6e-4, 120, 8
GATE_TMPS = (5.0, 5.0, 5.0, 1.0)
GATE_SEED = 0                  # random_init_'s seed on the card (the CPU tests start from JAX's)
# The convergence gates' scenes (tests/test_convergence.py make_scene): a
# 64x64 reference view of a blurred-noise texture and 2 sources at x = 2, 4.
CONV_HW = 64
CONV_FX = 80.0
CONV_PAD = 32
CONV_BASELINE = 2.0
CONV_NSRC = 2
CONV_WINDOW = CONV_HW + 8      # texture columns a scene reads (the sources shift < 6 px)
CONV_DEPTHS = (55.0, 70.0, 90.0, 105.0)  # rng 0: the loss gate's batch of 4
CONV_DEPTH1 = 75.0                       # rng 1: the overfit gate's scene
CONV_LOSS = dict(lr=2e-4, steps=24)
CONV_FIT = dict(lr=4e-4, steps=60, eval_every=10)
# Launches of the gates' model (GN: no K2, K4, K5) a training step (one
# micro-batch) and an eval forward; K3 under ce only.
GATE_STEP_LAUNCHES = {"warp_corr_fwd": 4, "warp_corr_bwd": 4}
GATE_EVAL_LAUNCHES = {"warp_group_corr": 4, "gsa_attention": 9}
GATE_CLI_TIMEOUT_S = 300
GATE_STAGES = ("stage1", "stage2", "stage3", "stage4")


def gate_manifest():
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, GATE_FIXTURES, "manifest.json")) as f:
        return json.load(f)


def gate_file(name, sha256):
    """The bytes of a committed gate fixture, held to its manifest digest."""
    import hashlib

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, GATE_FIXTURES, name), "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != sha256:
        raise RuntimeError(f"{GATE_FIXTURES}/{name}: not the file its manifest names")
    return data


def gate_views():
    """The five committed JPEG views of the analytic-plane gates (bytes)."""
    views = gate_manifest()["views"]
    return [gate_file(name, views[name]["sha256"]) for name in sorted(views)]


def gate_intrinsics():
    import numpy as np

    c = GATE_IMG / 2
    return np.array([[GATE_FX, 0, c], [0, GATE_FX, c], [0, 0, 1]], np.float32)


def write_gate_pairs(path):
    """pair.txt: every other view a source, nearest first."""
    with open(path, "w") as f:
        f.write(f"{GATE_NV}\n")
        for ref in range(GATE_NV):
            srcs = sorted((v for v in range(GATE_NV) if v != ref), key=lambda v: abs(v - ref))
            f.write(f"{ref}\n{len(srcs)} "
                    + " ".join(f"{s} {100 - i}" for i, s in enumerate(srcs)) + "\n")


def gate_extrinsic(v):
    import numpy as np

    ext = np.eye(4, dtype=np.float32)
    ext[0, 3] = GATE_TX * v
    return ext


def write_plane_scan(root, views):
    """The DTU gate's eval layout under `root` (tests/test_geometric_e2e.py
    `_make_plane_scan`) by the port's writers: scan1/pair.txt,
    scan1/images/*.jpg (`views`, JPEG streams), scan1/cams/*_cam.txt (4 K,
    depth_min 40, interval 5) and, beside `root`, Depths_raw/scan1 (the
    plane's depth everywhere, an all-255 mask). Returns `root`."""
    import numpy as np

    from mvsformer_torch.utils.cams import CameraParams, write_cam_file
    from mvsformer_torch.utils.image import write_png
    from mvsformer_torch.utils.pfm import save_pfm

    scan = os.path.join(root, "scan1")
    gt = os.path.join(os.path.dirname(root.rstrip("/")), "Depths_raw", "scan1")
    for d in (os.path.join(scan, "images"), os.path.join(scan, "cams"), gt):
        os.makedirs(d, exist_ok=True)
    write_gate_pairs(os.path.join(scan, "pair.txt"))
    K = gate_intrinsics()
    for v, data in enumerate(views):
        with open(os.path.join(scan, "images", f"{v:0>8}.jpg"), "wb") as f:
            f.write(data)
        write_cam_file(os.path.join(scan, "cams", f"{v:0>8}_cam.txt"),
                       CameraParams(gate_extrinsic(v), 4.0 * K, GATE_DMIN, GATE_DITV))
        save_pfm(os.path.join(gt, f"depth_map_{v:0>4}.pfm"),
                 np.full((GATE_IMG, GATE_IMG), GATE_DEPTH, np.float32))
        write_png(os.path.join(gt, f"depth_visual_{v:0>4}.png"),
                  np.full((GATE_IMG, GATE_IMG), 255, np.uint8))
    return root


def write_plane_scan_tt(root, views):
    """The T&T gate's eval layout under `root` (`_make_plane_scan_tt`):
    scan1/pair.txt, scan1/images/*.jpg (`views`), scan1/cams/ with the
    full-size K and `dmin ditv nd` but depth_min 60 past the plane's range
    (wrong on purpose: only the short-range cams recover the plane), and
    short_range_cameras/cams_scan1/ with the right range. Returns `root`."""
    from mvsformer_torch.utils.cams import CameraParams, write_cam_file

    scan = os.path.join(root, "scan1")
    short = os.path.join(root, "short_range_cameras", "cams_scan1")
    for d in (os.path.join(scan, "images"), os.path.join(scan, "cams"), short):
        os.makedirs(d, exist_ok=True)
    write_gate_pairs(os.path.join(scan, "pair.txt"))
    K = gate_intrinsics()
    for v, data in enumerate(views):
        with open(os.path.join(scan, "images", f"{v:0>8}.jpg"), "wb") as f:
            f.write(data)
        write_cam_file(os.path.join(scan, "cams", f"{v:0>8}_cam.txt"),
                       CameraParams(gate_extrinsic(v), K, GATE_DMIN + GATE_TT_FAR, GATE_DITV,
                                    num_depth=float(GATE_ND)))
        write_cam_file(os.path.join(short, f"{v:0>8}_cam.txt"),
                       CameraParams(gate_extrinsic(v), K, GATE_DMIN, GATE_DITV,
                                    num_depth=float(GATE_ND)))
    return root


def plane_scene(win, depth):
    """tests/test_convergence.py `make_scene(rng, depth)` from the window of
    its texture that the scene reads (`win`, [64, CONV_WINDOW, 3] float32,
    the texture from its padded corner): (imgs [3, 64, 64, 3], projs
    {stageK: [3, 2, 4, 4]}, depth values [16], gt and mask {stageK}), bit
    for bit. The sources are the JAX `bilinear_sample` of the texture at
    the reference's pixels shifted by the disparity along x: on integer
    rows only the two taps of a row weigh, by 1 - wx and wx."""
    import numpy as np

    h = w = CONV_HW
    K = np.array([[CONV_FX, 0, w / 2], [0, CONV_FX, h / 2], [0, 0, 1]], np.float32)
    imgs, cams = [win[:, :w]], [np.eye(4, dtype=np.float32)]
    for v in range(CONV_NSRC):
        tx = CONV_BASELINE * (v + 1)
        px = np.arange(w, dtype=np.float32) + CONV_PAD + CONV_FX * tx / depth
        x0 = np.floor(px)
        wx = px - x0
        col = x0.astype(np.int64) - CONV_PAD
        if col.min() < 0 or col.max() + 1 >= win.shape[1]:
            raise ValueError(f"depth {depth}: the sources read past the texture window")
        imgs.append(win[:, col] * (1.0 - wx)[:, None] + win[:, col + 1] * wx[:, None])
        ext = np.eye(4, dtype=np.float32)
        ext[0, 3] = tx
        cams.append(ext)
    projs = {}
    for s, scale in zip(range(1, 5), (1 / 8, 1 / 4, 1 / 2, 1.0)):
        p = np.zeros((len(imgs), 2, 4, 4), np.float32)
        for v, ext in enumerate(cams):
            p[v, 0] = ext
            p[v, 1, :3, :3] = K * scale
            p[v, 1, 2, 2] = 1.0
            p[v, 1, 3, 3] = 1.0
        projs[f"stage{s}"] = p
    dv = np.linspace(40.0, 120.0, 16, dtype=np.float32)
    gt = {f"stage{i + 1}": np.full((h // sc, w // sc), depth, np.float32)
          for i, sc in enumerate((8, 4, 2, 1))}
    mask = {k: np.ones_like(v) for k, v in gt.items()}
    return np.stack(imgs), projs, dv, gt, mask


def plane_scenes():
    """The convergence gates' committed scenes: ([the loss gate's 4 scenes,
    rng 0 at CONV_DEPTHS], the overfit gate's scene, rng 1 at CONV_DEPTH1),
    each as `make_scene` returns it."""
    import io

    import numpy as np

    m = gate_manifest()["scenes"]
    tex = np.load(io.BytesIO(gate_file("scenes.npz", m["file_sha256"])))
    return ([plane_scene(t, d) for t, d in zip(tex["rng0"], CONV_DEPTHS)],
            plane_scene(tex["rng1"][0], CONV_DEPTH1))


def gate_config(depth_type):
    """The gates' ModelConfig (tests/test_model.py tiny_cfg: full-width
    alt_gvt_small, feat_chs 8/16/32/64, ndepths 8/4/4/2, GN), drop path 0."""
    from mvsformer_torch.config import ModelConfig

    cfg = ModelConfig(ndepths=[8, 4, 4, 2], depth_interals_ratio=[4.0, 2.67, 1.5, 1.0],
                      feat_chs=[8, 16, 32, 64], base_ch=8, depth_type=depth_type,
                      inverse_depth=True, fusion_type="cnn", norm_type="GN")
    cfg.vit_args.drop_path_rate = 0.0
    return cfg


def gate_batch(torch, imgs, projs, dv, gt, mask, device):
    """numpy arrays -> the gate loop's batch of float32 tensors on `device`."""
    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return {"imgs": t(imgs), "projs": {k: t(v) for k, v in projs.items()}, "dv": t(dv),
            "gt": {k: t(v) for k, v in gt.items()}, "mask": {k: t(v) for k, v in mask.items()}}


def plane_batch(torch, ds, device, pad_rows=0):
    """Every reference view of the gate's eval dataset as one batch
    (`_collate_train_batch`): gt the plane's depth at each stage's size,
    the mask 1 but for `pad_rows` rows at top and bottom of every stage."""
    import numpy as np

    from mvsformer_torch.data.loader import collate

    b = collate([ds[i] for i in range(len(ds))])
    n = len(ds)
    gt = {f"stage{i + 1}": np.full((n, GATE_HW // sc, GATE_HW // sc), GATE_DEPTH, np.float32)
          for i, sc in enumerate((8, 4, 2, 1))}
    mask = {k: np.ones_like(v) for k, v in gt.items()}
    if pad_rows:
        for m in mask.values():
            m[:, :pad_rows] = 0.0
            m[:, -pad_rows:] = 0.0
    projs = {k: v for k, v in b["proj_matrices"].items() if k in GATE_STAGES}
    return gate_batch(torch, b["imgs"], projs, b["depth_values"], gt, mask, device)


def scenes_batch(torch, scenes, device):
    """make_scene tuples -> one batch, a sample each."""
    import numpy as np

    parts = list(zip(*scenes))
    stack = lambda dicts: {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}  # noqa: E731
    return gate_batch(torch, np.stack(parts[0]), stack(parts[1]), np.stack(parts[2]),
                      stack(parts[3]), stack(parts[4]), device)


def gate_eval(torch, model, batch):
    """The eval forward of the gates (stage temperatures 5, 5, 5, 1):
    refined depth [B, H, W]."""
    with torch.inference_mode():
        out = model(batch["imgs"], batch["projs"], batch["dv"], tmp=list(GATE_TMPS))
    return out["refined_depth"]


def snapshot(model):
    """A copy of the model's state that the optimiser's in-place updates
    do not reach (a state_dict holds the live tensors)."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def gate_train(torch, model, batch, lr, steps, depth_type, eval_err=None, eval_every=0,
               run=None):
    """The JAX gates' loop: optax.adam(lr) (betas 0.9 / 0.999, eps 1e-8
    outside the root, no decay) over every parameter, as torch's Adam; a
    training forward and `total_loss(depth_type)` a step. With `eval_err`
    (model -> float, run in eval mode), the error before the first step and
    every `eval_every` steps, and a snapshot of the weights at the best.
    `run(kind, fn)` runs each "step" and "eval" (default: fn()). Returns
    {"losses", "errors", "best_err", "best_step", "best_state"}."""
    from mvsformer_torch.ops.losses import total_loss

    run = run or (lambda kind, fn: fn())
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    itv = batch["dv"][:, 1] - batch["dv"][:, 0]

    def evaluate():
        model.eval()
        try:
            return float(run("eval", lambda: eval_err(model)))
        finally:
            model.train()

    def step():
        out = model(batch["imgs"], batch["projs"], batch["dv"])
        loss, _ = total_loss(out, batch["gt"], batch["mask"], itv, depth_type=depth_type)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return float(loss.detach())

    model.train()
    res = {"losses": [], "errors": [], "best_err": None, "best_step": 0, "best_state": None}
    if eval_err is not None:
        res["best_err"] = evaluate()
        res["errors"].append(res["best_err"])
        res["best_state"] = snapshot(model)
    for i in range(steps):
        res["losses"].append(run("step", step))
        if eval_err is not None and (i + 1) % eval_every == 0:
            e = evaluate()
            res["errors"].append(e)
            if e < res["best_err"]:
                res["best_err"], res["best_step"], res["best_state"] = e, i + 1, snapshot(model)
    return res


def plane_eval_err(torch, batch):
    """The analytic-plane gates' eval error: the mean |depth - 77| over the
    loss mask's stage-4 pixels (all of them in the DTU gate)."""
    m = batch["mask"]["stage4"]

    def err(model):
        e = (gate_eval(torch, model, batch) - GATE_DEPTH).abs()
        return (e * m).sum() / m.sum()
    return err


def pipeline_thresholds(metrics, n_points, zerr):
    """The JAX pipeline gates' thresholds after `save_depth` and fusion:
    [(what, value, "<" or ">", limit)]. `metrics` None (T&T) skips the
    depth-metric protocol's three."""
    import numpy as np

    rows = []
    if metrics is not None:
        rows += [("abs_depth_error", metrics["abs_depth_error"], "<", 0.5 * GATE_DITV),
                 ("thres2mm_error", metrics["thres2mm_error"], "<", 0.25),
                 ("thres8mm_error", metrics["thres8mm_error"], "<", 0.05)]
    rows += [("points", n_points, ">", 0.2 * GATE_NV * GATE_HW * GATE_HW),
             ("median |z - 77|", float(np.median(zerr)) if len(zerr) else float("inf"), "<",
              0.5 * GATE_DITV),
             ("mean |z - 77|", float(np.mean(zerr)) if len(zerr) else float("inf"), "<",
              GATE_DITV)]
    return rows


def thresholds_met(rows):
    return all(v > lim if op == ">" else v < lim for _, v, op, lim in rows)


def format_thresholds(rows):
    return ", ".join(f"{what} {v:.4g} ({op} {lim:.4g})" for what, v, op, lim in rows)


def read_depth_metrics(path):
    with open(path) as f:
        return {k: float(v) for k, v in (line.split(": ") for line in f if ": " in line)}


def gate_runner(torch, card, label, specs, want, rows, launches, on_card):
    """run(kind, fn) for gate_train and the in-process requests: the launch
    counts set to 0 just before each run of fn and read just after it, held
    to `want[kind]` (nothing on the CPU, whose tensors launch no kernel) and
    added to `launches`; the first run of each kind records its kernels'
    calls, and on the card each is held to its plain version (rows[name])."""
    from mvsformer_torch.ops import cuda_build

    seen = set()

    def run(kind, fn):
        kind_specs = {n: specs[n] for n in want[kind]}
        first = kind not in seen
        seen.add(kind)
        if on_card:
            torch.cuda.synchronize()
        cuda_build.reset_launches()
        if first:
            recorded, out = record_calls(torch, kind_specs, fn)
        else:
            out = fn()
            if on_card:
                torch.cuda.synchronize()
        got = dict(cuda_build.LAUNCHES)
        expect = want[kind] if on_card else {}
        if got != expect:
            raise RuntimeError(f"{label} {kind}: launches {got}, want {expect}")
        for n, c in got.items():
            launches[n] = launches.get(n, 0) + c
        if first and on_card:
            for name, calls in recorded.items():
                rows.setdefault(name, []).extend(
                    check_kernel(torch, card, name, specs[name],
                                 f"{label} {kind} " + call_label(name, i, a), a, k)
                    for i, (a, k) in enumerate(calls))
        return out
    return run


def gate_specs(eval_specs):
    """K1, K3, K6 (of phase 4's `eval_specs`) and K7, K8: the kernels the
    gates' model launches, with their plain versions and checks."""
    names = ("warp_group_corr", "depth_decode", "gsa_attention")
    return dict({n: eval_specs[n] for n in names}, **train_kernel_specs(None))


def pipeline_gate(torch, card, kind, root, specs, rows, launches, device="cuda"):
    """One analytic-plane gate, `kind` "dtu" (pcd fusion, the depth-metric
    protocol) or "tt" (short-range cams, dpcd fusion): train the re model
    on every reference view of the eval dataset, save the best weights as
    a checkpoint of the port's with the gate's config.json, then serve and
    fuse them with `python -m mvsformer_torch.test` (fp32; the DTU gate
    also in bf16) and hold the metrics and the PLY to the JAX gate's
    thresholds. Returns its details."""
    import numpy as np

    from mvsformer_torch.config import Config, save_config
    from mvsformer_torch.data.eval_dataset import MVSEvalDataset
    from mvsformer_torch.data.loader import collate
    from mvsformer_torch.infer import make_infer_fn
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.train.checkpoint import CheckpointManager
    from mvsformer_torch.utils.pfm import read_pfm
    from mvsformer_torch.utils.ply import read_ply

    t0 = time.perf_counter()
    on_card = device != "cpu"
    tt = kind == "tt"
    label = f"gate {kind}"
    views = gate_views()
    kw = dict(nviews=GATE_NUM_VIEW, ndepths=GATE_ND, max_h=GATE_HW, max_w=GATE_HW)
    if tt:
        data = write_plane_scan_tt(os.path.join(root, "tteval"), views)
        kw.update(dataset="tt", interval_scale={"scan1": 1.0}, use_short_range=True)
    else:
        data = write_plane_scan(os.path.join(root, "eval"), views)
        kw.update(dataset="dtu", interval_scale=1.0)
    ds = MVSEvalDataset(data, ["scan1"], **kw)
    batch = plane_batch(torch, ds, device, pad_rows=GATE_TT_PAD if tt else 0)
    if tt and abs(float(batch["dv"][0, 0]) - GATE_DMIN) > 1e-4:
        raise RuntimeError(f"{label}: short-range cams not routed: the depths start at "
                           f"{float(batch['dv'][0, 0])}, want {GATE_DMIN}")
    cfg = Config()
    cfg.arch = gate_config("re")
    model = build_model(cfg.arch, device=device, train=True)
    random_init_(model, torch.Generator().manual_seed(GATE_SEED))
    want = {"step": GATE_STEP_LAUNCHES, "eval": GATE_EVAL_LAUNCHES,
            "request": GATE_EVAL_LAUNCHES}
    run = gate_runner(torch, card, label, specs, want, rows, launches, on_card)
    with deterministic_math(torch) if on_card else contextlib.nullcontext():
        res = gate_train(torch, model, batch, GATE_LR, GATE_STEPS, "re",
                         eval_err=plane_eval_err(torch, batch), eval_every=GATE_EVAL_EVERY,
                         run=run)
    train_s = time.perf_counter() - t0
    traj = [round(e, 3) for e in res["errors"]]
    print(f"{label}: {GATE_STEPS} Adam steps ({train_s:.1f} s), loss {res['losses'][0]:.4f} -> "
          f"{res['losses'][-1]:.4f}; eval error every {GATE_EVAL_EVERY} steps {traj}; best "
          f"{res['best_err']:.4f} at step {res['best_step']} (< {0.5 * GATE_DITV:g}) [{card}]",
          flush=True)
    if not (np.isfinite(res["best_err"]) and res["best_err"] < 0.5 * GATE_DITV):
        raise RuntimeError(f"{label}: the overfit never reached sub-interval depth: "
                           f"best {res['best_err']}, trajectory {traj}")

    # The best weights, loaded back: their error and view 0's request, to
    # hold the CLI's output to (the CLI must serve the best weights, not the
    # last).
    model.load_state_dict(res["best_state"])
    model.eval()
    again = float(plane_eval_err(torch, batch)(model))
    first = collate([ds[0]])
    fn = make_infer_fn(model, GATE_TMPS)
    d0, c0, _ = run("request", lambda: fn(first["imgs"], {k: first["proj_matrices"][k]
                                                          for k in GATE_STAGES},
                                          first["depth_values"]))
    if abs(again - res["best_err"]) > E2E_DEPTH_ATOL:
        raise RuntimeError(f"{label}: the best weights loaded back give {again}, "
                           f"not {res['best_err']}")
    ckpt_dir = os.path.join(root, f"ckpt_{kind}")
    manager = CheckpointManager(ckpt_dir, monitor="min eval_err")
    manager.step(res["best_step"], res["best_err"], {"state_dict": res["best_state"]})
    save_config(cfg, os.path.join(ckpt_dir, "config.json"))
    listfile = os.path.join(root, "scans.txt")
    with open(listfile, "w") as f:
        f.write("scan1\n")
    fusion = (["--filter_method", "dpcd", "--dist_base", "2.0", "--rel_diff_base", "150",
               "--use_short_range", "--interval_scale", "scan1:1.0"] if tt else
              ["--filter_method", "pcd", "--thres_view", "2", "--thres_disp", "1.0",
               "--interval_scale", "1.0"])
    details = {"train_s": train_s, "losses": res["losses"], "errors": res["errors"],
               "best_err": res["best_err"], "best_step": res["best_step"],
               "best_err_reloaded": again, "cli": {}}
    gate_ok = True
    for dtype in ("fp32",) if tt else ("fp32", "bf16"):
        out = os.path.join(root, f"out_{kind}_{dtype}")
        log = f"gate_{kind}_{dtype}"
        cli_s = run_cli("mvsformer_torch.test", [
            "--dataset", kind, "--testpath", data, "--testlist", listfile, "--ckpt_dir",
            ckpt_dir, "--which_ckpt", "model_best", "--outdir", out, "--num_view",
            str(GATE_NUM_VIEW), "--ndepths", str(GATE_ND), "--max_h", str(GATE_HW), "--max_w",
            str(GATE_HW), "--dtype", dtype, "--prob_threshold", "0.3", "--fusion_src_views",
            "4"] + fusion + ([] if on_card else ["--device", device]), log,
            timeout=GATE_CLI_TIMEOUT_S)
        counts = check_cli_launches(log, {n: {"per_request": c if on_card else 0}
                                          for n, c in GATE_EVAL_LAUNCHES.items()}, len(ds))
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
        for v in range(GATE_NV):
            for sub, suf in (("depth_est", ".pfm"), ("confidence", ".npy"),
                             ("cams", "_cam.txt"), ("images", ".jpg")):
                if not os.path.exists(os.path.join(out, "scan1", sub, f"{v:0>8}{suf}")):
                    raise RuntimeError(f"{label} {dtype}: no {sub}/{v:0>8}{suf}")
        metric_file = os.path.join(out, "depth_metric.txt")
        if tt == os.path.exists(metric_file):
            raise RuntimeError(f"{label} {dtype}: depth_metric.txt "
                               + ("written without ground truth" if tt else "missing"))
        metrics = None if tt else read_depth_metrics(metric_file)
        pts, _ = read_ply(os.path.join(out, "scan1.ply"))
        zerr = np.abs(pts[:, 2] - GATE_DEPTH)
        checks = pipeline_thresholds(metrics, len(pts), zerr)
        gap = float(np.abs(read_pfm(os.path.join(out, "scan1", "depth_est", "00000000.pfm"))[0]
                           - d0[0].cpu().numpy()).max())
        gap_c = float(np.abs(np.load(os.path.join(out, "scan1", "confidence", "00000000.npy"))
                             - c0[0].cpu().numpy()).max())
        ok = thresholds_met(checks)
        if dtype == "fp32":
            # The CLI serves the best weights: its view 0 is this process's.
            ok = ok and gap <= E2E_DEPTH_ATOL and gap_c <= E2E_CONF_ATOL
        gate_ok = gate_ok and ok
        print(f"{label} test CLI --dtype {dtype} ({cli_s:.1f} s; launches "
              f"{json.dumps(counts)}): {format_thresholds(checks)}; view 0 against the best "
              f"weights in this process: depth {gap:.3e}, confidence {gap_c:.3e}"
              + (f" (tolerance {E2E_DEPTH_ATOL:g}, {E2E_CONF_ATOL:g})" if dtype == "fp32" else
                 "") + f" {'ok' if ok else 'FAILED'} [{card}]", flush=True)
        details["cli"][dtype] = {"s": cli_s, "launches": counts, "metrics": metrics,
                                 "points": len(pts), "median_zerr": float(np.median(zerr)),
                                 "mean_zerr": float(np.mean(zerr)), "view0_depth_gap": gap,
                                 "view0_conf_gap": gap_c, "ok": ok}
    if not gate_ok:
        raise RuntimeError(f"{label}: the test CLI's output misses the gate's thresholds")
    details["s"] = time.perf_counter() - t0
    return details


def convergence_gates(torch, card, specs, rows, launches, device="cuda"):
    """The two convergence gates on the committed scenes: the loss over 4
    planar scenes must fall (late < 0.85 early over 24 steps), and the
    overfit of one must pass through sub-interval eval depth (best < 1.5
    intervals and < 0.15 of the first error over 60 steps). ce decode, so
    the eval launches K3. Returns their details."""
    import numpy as np

    from mvsformer_torch.models.mvsformer import build_model, random_init_

    on_card = device != "cpu"
    scenes, one = plane_scenes()
    want = {"step": GATE_STEP_LAUNCHES,
            "eval": dict(GATE_EVAL_LAUNCHES, depth_decode=4)}
    details = {}
    with deterministic_math(torch) if on_card else contextlib.nullcontext():
        t0 = time.perf_counter()
        batch = scenes_batch(torch, scenes, device)
        model = build_model(gate_config("ce"), device=device, train=True)
        random_init_(model, torch.Generator().manual_seed(GATE_SEED))
        run = gate_runner(torch, card, "gate loss", specs, want, rows, launches, on_card)
        res = gate_train(torch, model, batch, CONV_LOSS["lr"], CONV_LOSS["steps"], "ce",
                         run=run)
        h = res["losses"]
        early, late = float(np.mean(h[:4])), float(np.mean(h[-4:]))
        ok = bool(np.isfinite(h).all()) and late < 0.85 * early
        print(f"gate loss ({len(scenes)} scenes, {CONV_LOSS['steps']} steps, "
              f"{time.perf_counter() - t0:.1f} s): losses {[round(x, 4) for x in h]}; "
              f"early {early:.4f}, late {late:.4f} (< 0.85 early: {0.85 * early:.4f}) "
              f"{'ok' if ok else 'FAILED'} [{card}]", flush=True)
        if not ok:
            raise RuntimeError(f"gate loss: the loss did not learn: {early} -> {late}")
        details["loss"] = {"losses": h, "early": early, "late": late,
                           "s": time.perf_counter() - t0}
        del model, batch

        t0 = time.perf_counter()
        batch = scenes_batch(torch, [one], device)
        itv = float(batch["dv"][0, 1] - batch["dv"][0, 0])
        model = build_model(gate_config("ce"), device=device, train=True)
        random_init_(model, torch.Generator().manual_seed(GATE_SEED))
        run = gate_runner(torch, card, "gate overfit", specs, want, rows, launches, on_card)

        def err(m):
            return (gate_eval(torch, m, batch) - CONV_DEPTH1).abs().mean()

        res = gate_train(torch, model, batch, CONV_FIT["lr"], CONV_FIT["steps"], "ce",
                         eval_err=err, eval_every=CONV_FIT["eval_every"], run=run)
        err0, best = res["errors"][0], res["best_err"]
        ok = bool(np.isfinite(best)) and best < 1.5 * itv and best < 0.15 * err0
        print(f"gate overfit ({CONV_FIT['steps']} steps, {time.perf_counter() - t0:.1f} s): "
              f"eval error every {CONV_FIT['eval_every']} steps "
              f"{[round(e, 3) for e in res['errors']]}; best {best:.4f} (< 1.5 intervals "
              f"{1.5 * itv:.4f}, < 0.15 x {err0:.4f}) {'ok' if ok else 'FAILED'} [{card}]",
              flush=True)
        if not ok:
            raise RuntimeError(f"gate overfit: best error {best} (first {err0}, interval {itv})")
        details["overfit"] = {"losses": res["losses"], "errors": res["errors"], "best": best,
                              "err0": err0, "s": time.perf_counter() - t0}
    return details


def gates_phase(torch, card, eval_specs, device="cuda"):
    """Phase 19: the four accuracy gates. `eval_specs`: phase 4's K1-K6
    specs. Returns {"rows", "launches", "details"}."""
    import shutil

    t_phase = time.perf_counter()
    on_card = device != "cpu"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    specs = gate_specs(eval_specs)
    rows, launches, details = {}, {}, {}
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "gates")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    subphase = subphase_clock("19a")
    try:
        details["dtu"] = pipeline_gate(torch, card, "dtu", root, specs, rows, launches, device)
        subphase("19b")
        details["tt"] = pipeline_gate(torch, card, "tt", root, specs, rows, launches, device)
        subphase("19c")
        details["convergence"] = convergence_gates(torch, card, specs, rows, launches, device)
        subphase(None)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    details["launches"] = launches
    details["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 19 (the accuracy gates): {details['phase_s']:.1f} s; launches {launches} "
          f"[{card}]", flush=True)
    return {"rows": rows, "launches": launches, "details": details}


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--parallel-rank"]:  # one rank of phase 16, started by torchrun
        parallel_rank(*sys.argv[2:5])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from mvsformer_torch.config import ModelConfig
    from mvsformer_torch.infer import make_infer_fn
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.ops import cuda_build, fpn_level

    t_script = time.perf_counter()
    stamps = [("start", t_script)]  # (the phase that ends here, when)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # 2. Build the kernels.
    t0 = time.perf_counter()
    report = cuda_build.build()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s ({', '.join(report)})")
    for name, rep in report.items():
        for line in rep["ptxas"].splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    occupancy = {f"{cl}/{co}": cuda_build.library("fpn_level").fpn_level_blocks_per_sm(cl, co)
                 for cl, co in fpn_level.LEVELS}
    print(f"fpn_level resident blocks per SM, by (cl/co): {occupancy}")
    if min(occupancy.values()) < 2:
        raise RuntimeError("fpn_level: fewer than two blocks share an SM")
    vis_blocks = cuda_build.library("vis_net").visibility_net_blocks_per_sm()
    print(f"visibility_net resident blocks per SM: {vis_blocks}")
    if vis_blocks < 3:
        raise RuntimeError("visibility_net: fewer than three blocks share an SM")
    warp_lib = cuda_build.library("warp_corr")
    warp_blocks = {f"{k} C={c} D={d}": warp_lib.warp_corr_blocks_per_sm(c, d, k == "K1")
                   for k in ("K1", "K7") for c, d in ((64, 32), (32, 16), (16, 8), (8, 4))}
    print(f"warp_group_corr (K1) and warp_corr_fwd (K7) resident blocks per SM: {warp_blocks}")
    if min(warp_blocks.values()) < 4:
        raise RuntimeError("warp_corr: fewer than four blocks share an SM")
    bwd_lib = cuda_build.library("warp_corr_bwd")
    bwd_blocks = {f"C={c} D={d}": bwd_lib.warp_corr_bwd_blocks_per_sm(c, d)
                  for c, d in ((64, 32), (32, 16), (16, 8), (8, 4))}
    print(f"warp_corr_bwd (K8) resident blocks per SM: {bwd_blocks}")
    if min(bwd_blocks.values()) < 3:
        raise RuntimeError("warp_corr_bwd: fewer than three blocks share an SM")
    head_blocks = cuda_build.library("encoder_head").encoder_head_blocks_per_sm()
    print(f"encoder_head (K4) resident blocks per SM: {head_blocks}")
    if head_blocks < 2:
        raise RuntimeError("encoder_head: fewer than two blocks share an SM")
    gsa_blocks = cuda_build.library("gsa_attention").gsa_attention_blocks_per_sm()
    print(f"gsa_attention (K6) resident blocks per SM: {gsa_blocks}")
    if gsa_blocks < 4:
        raise RuntimeError("gsa_attention: fewer than four blocks share an SM")

    # 3. The model.
    t0 = time.perf_counter()
    cfg = ModelConfig()
    model = build_model(cfg, device="cuda")
    random_init_(model, torch.Generator().manual_seed(0))
    print(f"model: TwinMVSNet alt_gvt_small fp32, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"built in {time.perf_counter() - t0:.1f} s")
    imgs, projs, dv = synthetic_request(torch)
    fn = make_infer_fn(model, tmps=(5.0, 5.0, 5.0, 1.0))
    nstages = len(cfg.ndepths)

    specs = eval_kernel_specs(model)

    # 4a. Warm-up request.
    t0 = time.perf_counter()
    fn(imgs, projs, dv)
    torch.cuda.synchronize()
    print(f"warm-up request: {time.perf_counter() - t0:.3f} s")

    # 4b. Timed requests. Each drives the main path once: every launch count
    # is set to 0 just before it and read just after it.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], None
    for _ in range(N_REQUESTS):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        depth, conf, stage_confs = fn(imgs, projs, dv)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = dict(cuda_build.LAUNCHES)
        for name, spec in specs.items():
            if counts.get(name, 0) != spec["per_request"]:
                raise RuntimeError(f"{name}: {counts.get(name, 0)} launches in a request, "
                                   f"want {spec['per_request']}")
        launches = launches or counts
    print(f"launches per request, the same in each of {N_REQUESTS} requests: {launches}")
    for i, t in enumerate(times):
        print(f"request {i}: {t * 1e3:.2f} ms, {B / t:.4f} depth-maps/s [{card}]")
    mean_s = sum(times) / len(times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"mean request: {mean_s * 1e3:.2f} ms, {B / mean_s:.4f} depth-maps/s, "
          f"peak memory {peak_gb:.2f} GB (timed requests) [{card}]")

    # 4c. One more request, recording each kernel's inputs at every call and
    # the TF32 flags the forward runs under (it must turn them off: the model
    # is fp32, and phase 7 checks it at fp32).
    recorded = {name: [] for name in specs}
    tf32_seen = set()

    def recorder(name, fn_):
        def wrapped(*args, **kwargs):
            recorded[name].append((args, kwargs))
            tf32_seen.add((torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32))
            return fn_(*args, **kwargs)
        return wrapped

    originals = {name: getattr(spec["owner"], name) for name, spec in specs.items()}
    for name, spec in specs.items():
        setattr(spec["owner"], name, recorder(name, originals[name]))
    try:
        fn(imgs, projs, dv)
        torch.cuda.synchronize()
    finally:
        for name, spec in specs.items():
            setattr(spec["owner"], name, originals[name])
    for name, calls in recorded.items():
        if len(calls) != specs[name]["per_request"]:
            raise RuntimeError(f"{name}: recorded {len(calls)} calls, "
                               f"want {specs[name]['per_request']}")
    print(f"tf32 (matmul, cudnn): {torch.backends.cuda.matmul.allow_tf32}, "
          f"{torch.backends.cudnn.allow_tf32} outside the forward, "
          f"{sorted(tf32_seen)} inside it")
    if tf32_seen != {(False, False)}:
        raise RuntimeError("the fp32 forward ran with TF32 on")

    # 4d. Where the device time goes in one request (not counted above).
    layers = layer_breakdown(torch, model, fn, (imgs, projs, dv))
    print("layers (device ms, one request): " + json.dumps(
        {k: round(v, 3) for k, v in layers.items()}))
    busy_ms, wall_ms, top = device_busy(torch, fn, (imgs, projs, dv))
    if busy_ms is None:
        print(f"profiled request: {wall_ms:.2f} ms wall; device busy share not measured "
              f"(the profiler saw no device events)")
    else:
        print(f"profiled request: {wall_ms:.2f} ms wall, {busy_ms:.2f} ms of kernels, "
              f"device idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} [{card}]")
        for name, t in top:
            print(f"  {t:9.3f} ms  {name[:110]}")

    # 5. Outputs.
    print(check_outputs(torch, depth, conf, recorded["depth_decode"], originals["depth_decode"]))

    # 6. Kernels against their plain versions, TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def check(name, label, args, kwargs):
        return check_kernel(torch, card, name, specs[name], label, args, kwargs)

    per_call = {name: [check(name, call_label(name, i, args), args, kwargs)
                       for i, (args, kwargs) in enumerate(calls)]
                for name, calls in recorded.items()}
    ref, src, src_projs, ref_proj, dv4 = recorded["warp_group_corr"][-1][0][:5]
    one_view = check("warp_group_corr", "stage4 V=1",
                     (ref, src[:, :1].contiguous(), src_projs[:, :1].contiguous(),
                      ref_proj, dv4), recorded["warp_group_corr"][-1][1])
    two_samples = check("warp_group_corr", "stage1 B=2",
                        k1_two_samples(torch, *recorded["warp_group_corr"][0][0][:5]),
                        recorded["warp_group_corr"][0][1])
    print("warp_group_corr (K1) ms per stage: "
          + " / ".join(f"{r['ms']:.4f}" for r in per_call["warp_group_corr"])
          + f"; {sum(r['ms'] for r in per_call['warp_group_corr']):.4f} per request [{card}]")
    k6 = per_call["gsa_attention"]
    k6_ms, k6_bound = sum(r["ms"] for r in k6), sum(r["bound_ms"] for r in k6)
    print("gsa_attention (K6) ms per launch: " + " / ".join(f"{r['ms']:.4f}" for r in k6)
          + f"; {k6_ms:.4f} per request, {k6_bound / k6_ms:.1%} of its {k6_bound:.4f} ms "
          f"bound; scaled_dot_product_attention {sum(r['library_ms'] for r in k6):.4f} "
          f"[{card}]")

    # 7. End to end against the plain versions on the CPU, small request.
    e2e = small_request_errors(torch, model, make_infer_fn)
    e2e_ok = all(e <= (E2E_DEPTH_ATOL if k == "refined_depth" else E2E_CONF_ATOL)
                 for k, e in e2e.items())
    print(f"request {E2E_SHAPE} on the card against the CPU: max_abs_err "
          + ", ".join(f"{k} {e:.3e}" for k, e in e2e.items())
          + f" (tolerance depth {E2E_DEPTH_ATOL:g}, confidence {E2E_CONF_ATOL:g}) "
          + ("ok" if e2e_ok else "FAILED"), flush=True)
    if not e2e_ok:
        raise RuntimeError("the forward on the card disagrees with the CPU forward")

    kernels = [kernel_row(name, spec, per_call[name], launches.get(name, 0))
               for name, spec in specs.items()]

    stamps.append(("1-7 (build, the request, the kernels)", time.perf_counter()))
    # 8-10. Training.
    del fn, model, recorded
    torch.cuda.empty_cache()
    train = training_phase(torch, card, eval_kernels=tuple(specs))
    kernels += train.pop("kernels")

    stamps.append(("8-10 (training)", time.perf_counter()))
    # 11. The DTU test pipeline.
    torch.cuda.empty_cache()
    pipeline = pipeline_phase(torch, card, specs)

    stamps.append(("11 (pipeline)", time.perf_counter()))
    # 12. The training run through the CLI, its kernels at the run's shapes,
    # the crop sweep.
    torch.cuda.empty_cache()
    run = training_run_phase(torch, card, specs)

    stamps.append(("12 (training run)", time.perf_counter()))
    # 13. DINOMVSNet served and trained.
    torch.cuda.empty_cache()
    dino = dino_phase(torch, card, specs)

    stamps.append(("13 (DINO)", time.perf_counter()))
    # 14. The cascade's variants served and trained.
    torch.cuda.empty_cache()
    variants = variants_phase(torch, card, specs)

    stamps.append(("14 (variants)", time.perf_counter()))
    # 15. The bf16 mode: both models served and TwinMVSNet trained.
    torch.cuda.empty_cache()
    bf16 = bf16_phase(torch, card, specs)

    stamps.append(("15 (bf16)", time.perf_counter()))
    # 16. The process grid: data and view parallelism, the ranks on this card.
    torch.cuda.empty_cache()
    grid = parallel_phase(torch, card, specs, serial=(depth, conf))

    stamps.append(("16 (the grid)", time.perf_counter()))
    # 17. The rest of the model variants (A6).
    torch.cuda.empty_cache()
    a6 = variants_a6_phase(torch, card, specs)

    stamps.append(("17 (A6)", time.perf_counter()))
    # 18. The training options no shipped config sets: focal, the clip,
    # DINO's layer decay.
    torch.cuda.empty_cache()
    options = options_phase(torch, card)

    stamps.append(("18 (training options)", time.perf_counter()))
    # 19. The four accuracy gates: trained here, served by the test CLI.
    torch.cuda.empty_cache()
    gates = gates_phase(torch, card, specs)

    stamps.append(("19 (the accuracy gates)", time.perf_counter()))
    # Each kernel's entry sums its checks and launches over the phases.
    all_specs = dict(specs, **train_kernel_specs(None))
    checked = dict(per_call, **train["per_call"])
    total = {row["name"]: row["launches"] for row in kernels}
    for phase in (run, dino, variants, bf16, grid, a6, options, gates):
        for name, rows in phase["rows"].items():
            checked[name] = checked[name] + rows
        for name, n in phase["launches"].items():
            total[name] = total.get(name, 0) + n
    kernels = [kernel_row(name, all_specs[name], checked[name], total[name])
               for name in all_specs]

    phase_s = {label: t - stamps[i][1] for i, (label, t) in enumerate(stamps[1:])}
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f"; the script so far {time.perf_counter() - t_script:.1f} s [{card}]", flush=True)
    details = {
        "card": card, "device": kind, "torch": torch.__version__, "phase_s": phase_s,
        "cuda": torch.version.cuda, "build_s": build_s, "k5_blocks_per_sm": occupancy,
        "k2_blocks_per_sm": vis_blocks, "k4_blocks_per_sm": head_blocks,
        "k6_blocks_per_sm": gsa_blocks,
        "request_ms": [t * 1e3 for t in times], "depth_maps_per_s": B / mean_s,
        "peak_memory_gb": peak_gb, "launches": launches, "layers_ms": layers,
        "profiled_wall_ms": wall_ms, "profiled_kernel_ms": busy_ms, "top_kernels": top,
        "per_call": per_call, "k1_one_view": one_view, "k1_two_samples": two_samples,
        "warp_blocks_per_sm": warp_blocks, "k8_blocks_per_sm": bwd_blocks,
        "e2e_small_errors": e2e,
        "shape": {"B": B, "V": V, "H": H, "W": W, "depths": NDEPTH_FULL},
        "training": train,
        "pipeline": pipeline,
        "training_run": dict(run["details"], rows=run["rows"], launches=run["launches"]),
        "dino": dict(dino["details"], rows=dino["rows"], launches=dino["launches"]),
        "variants": dict(variants["details"], rows=variants["rows"],
                         launches=variants["launches"]),
        "bf16": dict(bf16["details"], rows=bf16["rows"], launches=bf16["launches"]),
        "parallel": dict(grid["details"], rows=grid["rows"], launches=grid["launches"]),
        "variants_a6": dict(a6["details"], rows=a6["rows"], launches=a6["launches"]),
        "options": dict(options["details"], rows=options["rows"],
                        launches=options["launches"]),
        "gates": dict(gates["details"], rows=gates["rows"]),
    }
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
