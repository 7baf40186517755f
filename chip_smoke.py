"""Drive the PyTorch/CUDA port (l4p_tpu_torch) once on a CUDA card.

    python3 chip_smoke.py        # from the repository root, one card

Phases; a failed check fails the run (non-zero exit, no result lines):
  1. build the kernels (csrc/flash_attention.cu, fused_keys.cu,
     fused_upscale.cu, fused_encoder.cu, resize.cu, qk_norm_rope.cu) with
     nvcc for sm_90a, one
     nvcc per library, all started together, and print the build seconds and
     ptxas lines;
  2. hold each kernel against its plain PyTorch version and time both,
     beside its bound (the larger of its FLOP over the bf16 peak and its
     bytes, each input read once and each output written once, over the
     memory rate) and, where one PyTorch call computes the same function,
     that call's time: the attention at the default encoder's shape (2
     windows x 16 heads, 2048 tokens, D=88), at bench.py's fused shape (5
     windows x 16 heads) and at streaming's one window (1 x 16 heads), each
     beside scaled_dot_product_attention, and at N=512, D=64; t2i_flash and i2t_ln_t2i at the track head's N=128 queries,
     P=2048, C=1408, K=48 and at a ragged N=3, P=1000, both also against
     their plain versions on fp32 copies of the bf16 operands (the kernel no
     farther from them than the plain version, KEYS_WITNESS_SLACK); the
     track head's five PE products a window and query chunk (3 spe, 2 per;
     ops/conv.py:einsum_fp32 on the tensor cores) at N=192 and 128, P=2048,
     C=1408, K=48, each a contiguous (N, P, K) within TRACK_PRODUCT_BAND of
     the fp32 einsum, one count a product, and device ms in turns with the
     fp32 einsum and its .contiguous() copy beside the bf16 bound;
     fused_upscale_hypernet at N=128, P=2048, C=1408, d1=352, d2=176, M=3
     and at N=3, P=1000, each also against the plain version on fp32
     copies of its bf16 operands (the kernel no farther from it than the
     plain version, UPSCALE_WITNESS_SLACK); fused_encoder_blocks at x (2,
     2048, 1408), 40 blocks, hook ends (14, 21, 28, 36, 40), and at a ragged
     E=256, D=64, N=300, 2 blocks, one band per hook, the giant one also
     against the plain version on fp32 copies of its bf16 blocks and tokens
     (per hook, the kernel path no farther from it than the plain path,
     ENCODER_WITNESS_SLACK); the blocks' GEMM alone at each of a giant
     block's four products (qkv, proj, fc1, fc2) at M = 4096 and 10240,
     against its plain version (GEMM_BAND) and beside torch.matmul (timed
     through its launch thunk and through the gemm_nt wrapper); all bf16;
     interpolate_trilinear at the DPT heads' five resizes (2 windows a head
     call, bf16, channels_last_3d, align_corners), equal to F.interpolate
     bit for bit, its device ms beside F.interpolate's (the plain version
     and the one library call are that one call) and the bytes bound; the
     session phases 4, 7 and 10 check its launches: 5 a head call of flow,
     depth and dyn_mask (four fusion upsamples and the final resize), 2 of
     camray's, whose last two fusions and final resize keep the size;
     VGGT's cell (64 frames of 294 x 518): the attention prologue
     (qk_norm_rope: q/k LayerNorm, 2D RoPE, the q/k/v layout) at its frame
     (64, 782) and global (1, 50048) calls, with and without each of the
     norm and the rotation, against its plain version (v bit for bit, q and
     k within QK_NORM_ROPE_TOL) and timed in turns with it beside its bytes
     bound; the attention at its frame (64,
     16, 782, 64) and global (1, 16, 50048, 64) shapes against the plain
     version computed 1024 queries at a time (max |error| over max |plain|,
     VGGT_ATTENTION_TOL) and beside scaled_dot_product_attention; the
     resize kernel at its DPT heads' five bilinear resizes (an 8-frame
     chunk, bf16, channels_last, align_corners) equal to F.interpolate bit
     for bit; one launch a call; then one request of VGGT-1B at the cell's
     shapes through InferenceSession, its launches counted (an attention
     launch a transformer block; 5 resizes a DPT head call of 8 frames; a
     prologue launch an aggregator block, 48) and its
     outputs finite; Video Depth Anything's cell (110 frames of 518 x 924):
     the attention at its four motion modules' temporal calls ((9768, 8,
     32, 32), 78,144 sequences over the grid's y and z, also equal bit for
     bit to two launches over its halves; (2442, 8, 32, 128), (627, 8, 32,
     128), (2442, 8, 32, 32)) and its encoder's (32, 16, 2443, 64), against
     the plain version (max |error| within VDA_ATTENTION_TOL of max
     |plain|, below the mean |plain|), one launch a call; then one request of VDA-L at the cell's
     shapes through InferenceSession, the counts set to 0 just before (5
     windows: 40 temporal and 120 encoder attention launches, 130 resizes,
     no prologue) and its depth finite;
  3. build the released giant model (ViT-giant encoder, flow/depth/dyn_mask
     and camray DPT heads, the track head, configs/model.yaml values) with
     random bf16 weights from a seeded generator, tracking 128 queries per
     chunk;
  4. serve uint8 dense requests of 48, 32 and 16 frames (3 of each, after a
     warm-up), checking shapes, finiteness, depth > 0 and that the encoder
     attention ran on its kernel 40 times per encoded window chunk;
  5. time the stages of the 48-frame dense request (encode, heads, stitch);
  6. serve the 48-frame dense request with the plain attention and hold the
     outputs against the kernel path's (SLICE_TOL);
  7. serve 48-frame requests with four tasks (flow_2d_backward, track_2d,
     depth, dyn_mask) at 128 and 64 queries (3 each, after a warm-up) and
     once at 160 queries (two chunks of 128, padded); half the queries start
     at t = 0.5, half spread over the video. Checks: output keys and shapes,
     finite values, depth > 0, tracks inside the frame, and each kernel's
     launch count against its formula;
  8. time the stages of the 48-frame, 128-query request;
  9. serve that request on the plain path (plain attention and the plain
     versions of the track head's three kernels) and hold all six outputs
     against the kernel path's (SLICE_TOL, TRACK_BANDS); then the bands'
     witness: WITNESS_REQUESTS more requests (their own videos and queries),
     each on both paths and on each path again with the attention in fp32,
     holding the kernel path's tracks no farther from their fp32 run than the
     plain path's on average (WITNESS_SLACK) and each of the first
     TRACK_BAND_REQUESTS requests' kernel path against its plain path within
     TRACK_BANDS (the requests beyond them logged);
 10. bench.py's request as bench.py runs it: 48 frames, intrinsics as
     bench.py builds them, 128 queries, all five tasks and the joint Sim(3)
     stitch on the config as loaded, whose encoder is the default one (a
     warm-up and 3 timed requests), checking outputs and every kernel's
     launches: the attention 40 times per encoded window chunk,
     fused_encoder_blocks never, the track kernels as in phase 7, and
     einsum_fp32's tensor-core products (15 a window and query chunk: 75);
     then a second, labelled point: the same request with encoder.fused_encoder=True
     (a warm-up and 3 timed requests): fused_encoder_blocks once (7 launches
     per block inside), the attention wrapper never;
 11. the stage times of bench.py's request (encode, dense heads, camray
     rays, camera solve, stitch, track), the encode stage on the fused
     encoder, peak memory;
 12. the fused point on the plain path (plain encoder blocks, attention and
     track kernels): the encoder hooks within FUSED_ENCODER_BANDS, flow and
     dyn_mask within SLICE_TOL, the tracks within TRACK_BANDS; the poses, K
     and the jointly stitched depth finite, their difference printed;
 13. the camera solve and the joint stitch of the fused point's rays and
     depth, once on the card and once on the CPU with the same draws, held
     within GEOMETRY_TOL; every RANSAC's chosen hypothesis is compared and
     the two best inlier counts printed;
 14. the same on a synthetic trajectory at the request's sizes (5 windows of
     16 frames, 16 x 16 rays, 224 x 224 depth, each window in its own
     Sim(3) frame), where the random weights' rays of phase 13 give the
     RANSACs few inliers: card against CPU within GEOMETRY_TOL, and against
     the truth (TRUTH_BANDS): the estimated intrinsics, the window poses and
     the stitched depth in window 0's frame;
 15. `python3 -m l4p_tpu_torch.bench --iters 3` in a subprocess (its own
     process, so its launches are not counted here; it serves phase 10's
     path at 192 frames x 128 queries and 48 x 64): its JSON line printed
     and checked (keys, value finite and > 0, 0 < mfu <= 1.05,
     model_tflops_per_video equal to l4p_tpu_torch.utils.flops's count);
 16. bidirectional tracking, estimation_directions (1, -1): the four-task
     48-frame x 128-query request with every query spread over the video,
     the counts set to 0 just before it (the attention and each track
     kernel launched twice as often as forward only), timed in turns with
     the forward-only request; the forward-only and backward-only (-1,)
     requests against their plain paths (SLICE_TOL, TRACK_BANDS, whose vis
     scale is the -10 a direction leaves before a query), and the
     bidirectional tracks equal to the merge of those two;
 17. a camera_rays head (the released camray head's class swapped for
     VideoMAECameraDPTHead) beside the dense tasks, 48 frames: raw 16 x 16
     rays, launch counts, kernel path against plain path (SLICE_TOL);
 18. streaming (StreamingL4P) of bench.py's 48-frame five-task request
     (the released camray head estimates K once, the mode in which JAX's
     streaming equals its offline run) in pushes of one stride, ms per
     stride printed and launch counts checked; held against the offline
     session that encodes and runs the heads one window at a time, as
     streaming does, on the plain path (plain attention and track kernels:
     flow, dyn_mask within SLICE_TOL, the tracks within TRACK_BANDS, depth
     and the camray outputs finite with their difference printed, as in
     phase 12) and equal bit for bit to the same session's kernel path;
     printed beside the default offline session; whole-video times of both;
 19. the model end to end in bf16 against fp32: BF16_WINDOWS 16-frame
     windows of QUERY_CHUNK queries through forward_single_window, each (a)
     in bf16 with every kernel, (b) in bf16 on the plain path and (c) in
     fp32 on the plain path from the same weights upcast; flow, depth,
     dyn_mask, camray's raw ray map and the tracks compared, (a) within
     BF16_ENVELOPE of (c) wherever (b) is and no farther from (c) than (b)
     on average (WITNESS_SLACK); each run's camera solve printed;
 20. run_sequence on bench.py's request (numpy in, numpy out,
     write_artifacts=False), offline in turns with the session and then
     streamed: launch counts, the streamed outputs against the offline ones
     by phase 18's rules, wall times;
 21. the data pipeline at DAVIS's 480 x 854 (resize, centre crop, queries,
     collate) into run_sequence; the point maps on the card against the CPU
     (POINT_MAP_TOL); the point-cloud, camera and 3D-track PLYs and their
     vertex counts; panel frames for flow, depth and dyn_mask (the track
     panel and the mp4 need cv2, which this phase never calls);
 22. `python3 -m l4p_tpu_torch.stream_bench --windows 8` in a subprocess,
     its line checked; the native preprocessing library built with g++,
     each entry point against its numpy version;
 23. the five configs of l4p_tpu_torch.eval_protocol (depth on one
     16-frame window without the joint alignment; the dense tasks, tracks,
     tracks + depth and all five tasks on 48 frames) on their synthetic
     batches with QUERY_CHUNK queries: a warm-up and REPEATS timed requests
     each, seconds and frames/s printed, every kernel's launches against the
     formulas of phases 7 and 10, outputs checked and held against the plain
     path (SLICE_TOL; the joint chain's depth and camray outputs finite, as
     in phase 12), and the metrics finite and equal on the card and on the
     CPU from the same outputs (EVAL_METRIC_TOL). On the protocol's float
     noise video, with every query at t = 0.5 (no -10 vis fill to scale the
     bands), either path moves past TRACK_BANDS when only its attention goes
     to fp32, so the tracks are held three ways (the spreads against
     TRACK_BANDS printed): each track kernel's every call of one request,
     served again bit for bit, against its plain version on the same
     operands (KEYS_BAND, UPSCALE_BAND) and against the plain version on
     their fp32 copies (HeldTrackKernels: the kernel no farther from it than
     the plain version, KEYS_WITNESS_SLACK, UPSCALE_WITNESS_SLACK); the
     kernel path against the kernel attention with the plain track kernels,
     whose mean 99th percentile must stay within WITNESS_SLACK of the plain
     path's against its fp32-attention run; and phase 9's witness, each
     path against its own fp32-attention run (WITNESS_SLACK); both means
     over WITNESS_REQUESTS of the protocol's synthetic batches (seed 0 the
     eval's own; the others served once on the track task alone and shared
     by the track configs);
 24. the giant encoder with the option branches, two models with seeded
     bf16 weights: (a) cosine attention, LayerScale 0.1, learnable
     positions and the camera embedding at the input, added; (b) the
     embedding on the outputs, concatenated. The dense tasks on 48 frames
     with bench.py's intrinsics and the eval protocol's trajectory as
     extrinsics, timed in turns with the default encoder, the attention's
     launches counted (the kernel takes cosine attention at scale 1), each held
     against its plain path (SLICE_TOL); fused_encoder with (a) raises;
 25. training (l4p_tpu_torch/train.py, trainer.py) at the giant model's
     width: (a) each kernel's autograd Function on a training step's
     operands (the attention at (1, 16, 2048, 88), the two-way transformer
     and the upscale at 32 queries, the 40 fused blocks at (1, 2048,
     1408)): its outputs hang off the Function's node, and the gradients
     of a fit of its outputs (grad_of_fit) for every input and parameter
     are held against the plain path (FUNCTION_GRAD_BAND) and, against the
     plain path on fp32 copies of the same values, no farther from it than
     the plain path (GRAD_WITNESS_SLACK); (b) configs/model.yaml's five
     tasks on one synthetic 16-frame window with 32 queries: the first
     step's gradients on the kernel path against the plain path (plain
     attention and track kernels; STEP_GRAD_L2, STEP_GRAD_BAND), every
     block's qkv.weight with a gradient, then three train steps on the
     kernel path at the trainer's schedule, each launching the attention
     40 times and t2i_flash, i2t_ln_t2i and fused_upscale_hypernet 1, 2
     and 1 times, the losses finite; (c) a step on the fused encoder
     (fused_encoder_blocks once) and three with the encoder frozen (its
     weights bit for bit unchanged); (d) Trainer.fit for two steps with the
     encoder frozen, its checkpoint restored into a second model bit for
     bit; ms per step and peak memory printed;
 26. VideoMAE pretraining (models/mae.py, pretrain_mae.py) at the giant
     registry entry's width, batch 2, mask ratio 0.9, bf16: (a) the
     attention at the MAE's two shapes, the encoder's 208 visible tokens
     (2, 16, 208, 88) and the decoder's 2048 (2, 8, 2048, 64): forward
     against its plain version and timed beside it, its bound and
     scaled_dot_product_attention, one launch a call, and the gradients of
     its Function held as phase 25 (a) holds them; (b) from one seeded
     model and one set of batches and masks, the first step's loss and
     gradients on the kernel path against the plain path (MAE_LOSS_TOL,
     MAE_STEP_GRAD_L2, MAE_STEP_GRAD_BAND), each of the 48 attention
     outputs of a forward hanging off FlashAttentionFunction, then three
     pretraining steps on each path (AdamW at the CLI's defaults), 48
     launches a step on the kernel path and none on the plain one, the
     losses within MAE_LOSS_TOL; ms per step (mean of steps 2-3, the first
     apart) and peak memory printed, and a JSON line of the MAE readings;
     (c) `python3 -m l4p_tpu_torch.pretrain_mae --size giant --steps 3
     --batch 2` and `--adafactor --steps 1` in their own processes (exit 0,
     a finite loss a step), the first's ckpt.pt overlaid on the giant L4P
     encoder through load_video_encoder_ckpt: every tensor of every block
     equal to the file's;
 27. multi-GPU (l4p_tpu_torch.parallel): (a) the kernels at the shapes a
     rank of a mesh gives them, each against its plain version and timed
     beside its bound and, where phase 2 has one, its library call: the
     attention at (2, 8, 2048, 88) and (1, 8, 2048, 88) (the default
     encoder's chunks at 8 of 16 heads, a model axis of 2), t2i_flash,
     i2t_ln_t2i and fused_upscale_hypernet at N = 64 and 32 (the track
     chunk of 128 queries over a data axis of 2 and 4), with phase 2's
     witnesses; each kernel's launches a rank at data axes of 2 and 4
     printed; (b) `chip_smoke.py --tp-encoder` in two processes on this card
     under torchrun (a (1, 2) mesh, gloo, which reduces CUDA tensors): the
     giant encoder on bench.py's 48-frame token windows split over the
     model axis against one process, per hook end (TP_ENCODER_BANDS), both
     against the one-process encoder in fp32 (ENCODER_WITNESS_SLACK), the
     launches a rank, and both encode times; (c) bench.py's all-task
     request through InferenceSession(mesh=) on an NCCL group of one rank
     against the session without a mesh, in turns (SLICE_TOL, TRACK_BANDS,
     bit for bit printed), each kernel's launches against its formula; (d)
     with two or more cards, `python -m l4p_tpu_torch.parallel.dryrun
     --device cuda` and `chip_smoke.py --multi-card` on min(4, cards) cards
     under torchrun (NCCL): the request held against (c)'s outputs, the
     launches a rank, and frames/s at 192 x 128; with one card a line says
     that it did not run. A JSON line holds the phase's readings;
 28. SAM 2 (`compare_sam2`): the attention kernel at memory attention's
     shapes, one head of 256 over 28,736 and over 4,096 keys for 8
     objects, and at Hiera's eight shapes of head dim 72 on a chunk of 8
     frames (windows of 64 and 16 tokens, q-pooled windows with fewer
     queries than keys, the global 4,096), against its plain version
     (SAM2_ATTENTION_TOL), its device ms beside the plain version's,
     scaled_dot_product_attention's and the bound; the resize kernel at the
     mask logits' fp32 upsample (8, 1, 256, 256) -> 1024^2 against
     F.interpolate (SAM2_RESIZE_TOL); one request of the benchmark's SAM 2
     cell (64 frames at 1024^2, 8 objects) through the cell's driver with
     its launches counted (888 attention: 8 chunks x 48 Hiera blocks + 63
     frames x 8 memory-attention calls; 64 resizes; 0 prologue), its
     readings against the reference within the cell's limits, the memory
     tokens it attended against the bank's count, its seconds and peak
     memory. A JSON line holds the phase's readings.
With an argument (`--tp-encoder`, `--multi-card FILE`) the script is one
rank of phase 27's runs, which torchrun starts.
Every line with a number names the card and its power limit. The last two
lines are the kernels' record and {"ok": true, "device": {...}}. A kernel's
`launches` is its count over bench.py's request (phase 10's first point,
the counts set to 0 just before it), fused_encoder_blocks' over the fused
point, the path that runs it (phases 16-18 and 20 check their own counts); fused_encoder_blocks' entry also holds
`products`, each block product's kernel ms beside torch.matmul's and the
gemm_nt wrapper's.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# max |kernel - plain| for N(0, 1) q, k, v in bf16: both round the
# probabilities and the output to bf16, the kernel before normalising, the
# plain version after, so they differ by about one bf16 step of the output
KERNEL_TOL = 8e-3
# track-head kernels: max |kernel - plain| <= band * max |plain| on the same
# bf16 inputs. Both round the same points to bf16 (probabilities, GELU
# outputs, new keys) but sum in other orders, so a rounded value can land one
# bf16 step (2^-8 relative) apart and carry on; the bands are about twice
# the largest ratio the card measured
KEYS_BAND = 2e-2
UPSCALE_BAND = 2e-2
# the track head's products on the tensor cores (ops/conv.py:einsum_fp32)
# against the fp32 einsum of the same bf16 operands: max |error| over max
# |fp32|. Both sum exact products in fp32 in other orders (about 1e-6); a
# reduction in bf16 would read about 4e-3
TRACK_PRODUCT_BAND = 1e-4
# t2i_flash and i2t_ln_t2i (the new keys and the next wsum) and their plain
# versions against the plain versions on fp32 copies of the same bf16
# operands: the kernel's mean |error| must stay within this factor of the
# plain version's. Both round the same points to bf16 (the probabilities,
# the exponentials, the new keys) and differ in the order of their fp32
# sums; the gpu tests measured ratios of 0.68, 1.00 and 0.92 on an H100
KEYS_WITNESS_SLACK = 1.1
# the upscale kernel and its plain version against the plain version on fp32
# copies of the same bf16 operands: the kernel's mean |error| must stay within
# this factor of the plain version's. Both round the GELU outputs to bf16 at
# the same points and differ only in the order of their fp32 sums
UPSCALE_WITNESS_SLACK = 1.1
# fused_encoder_blocks, per hook end: max |kernel - plain| <= band * max
# |plain hook|. Both round q/k/v, GELU outputs and every residual add to bf16
# but sum in other orders, and the kernel's attention divides by the softmax
# sum after P.V where the plain version normalises first, so values land a
# bf16 step apart and the difference grows through the blocks. Measured on
# an H100 at the giant shape 1.65e-2, 1.84e-2, 2.13e-2, 2.52e-2, 2.39e-2,
# and 6.1e-3, 5.2e-3 at the ragged one; the bands are about twice that
FUSED_ENCODER_BANDS = {14: 3.5e-2, 21: 4e-2, 28: 4.5e-2, 36: 5e-2, 40: 5e-2}
RAGGED_ENCODER_BAND = 1.2e-2
# fused_encoder_blocks and its plain version against the plain version on
# fp32 copies of the same bf16 blocks and tokens (no bf16 rounding anywhere,
# TF32 off): per hook, the kernel path's mean |error| must stay within this
# factor of the plain path's. Both round the same points to bf16 and differ
# in the order of their fp32 sums and where the attention normalises
ENCODER_WITNESS_SLACK = 1.1
# the blocks' GEMM (gemm_nt) against its plain version on the same bf16
# operands: max |kernel - plain| <= GEMM_BAND * max |plain|; both round
# acc + bias once and sum K in other orders
GEMM_BAND = 2e-2
# per output: max |kernel path - plain path| <= SLICE_TOL * max |plain|. The
# two paths differ only in the kernels' bf16 rounding; through 40 blocks
# and the DPT heads that gave 0.7-1.5% of each output's largest value (a few
# bf16 steps) on an H100, and the band is about twice that
SLICE_TOL = 3e-2
# the track outputs against their plain path, as (max, 99th percentile) of
# |kernel path - plain path| over each output's largest value. Most entries
# agree to a bf16 step; a query whose re-query frame or heatmap peak moves
# carries the change through its later windows, so the largest differences
# sit on few entries, and which queries move changes from request to
# request. Over chip_smoke's two requests and the witness's first six (below),
# the largest readings on an H100 were max 2.3e-3 / 4.1e-3 / 4.9e-2 and
# 99th percentile 1.47e-4 / 9.1e-4 / 7.5e-3 (traj / vis / depth); the bands
# are about twice that. (The earlier mma.sync attention measured 5.8e-5 /
# 3.5e-4 99th percentiles on chip_smoke's request and reached 1.65e-4 /
# 1.2e-3 on the witness's six.)
TRACK_BANDS = {"track_2d_traj_est_bn2t": (5e-3, 3e-4), "track_2d_vis_est_bn1t": (8e-3, 1.8e-3),
               "track_2d_depth_est_bn1t": (9e-2, 1.5e-2)}
# the witness of those bands (phase 9): WITNESS_REQUESTS more requests, each
# served by both paths and by each path again with its attention in fp32
# (fp32_attention). Per track output, the kernel path's mean 99th
# percentile against its fp32 run must stay within WITNESS_SLACK times the
# plain path's, so a band wide enough for two bf16 attentions cannot hide a
# kernel that is the less accurate one (the earlier mma.sync kernel read
# 1.19 / 1.2 / 1.0). A request's 99th percentile is a step or two of the
# output's rounding, and which requests take the larger step is redrawn by
# any change of fp32 summation order anywhere on the track path: on an H100
# one request's ratio ranged 0.35-1.38, and the means of four disjoint sets
# of six requests from one tree 0.40-1.23, so six requests could not decide.
# Resampling 24 requests of one tree, a mean over 48 passes 1.25 in fewer
# than 1 in 1000 draws. Phase 23 holds the eval protocol's tracks over as
# many of its synthetic batches (seed 0 each eval's own)
WITNESS_REQUESTS = 48
# TRACK_BANDS are held on the witness's first six requests, those they were
# set from. Over all 48, requests 17, 27 and 33 exceed them on an H100 (99th
# pct up to 7.4e-4 / 2.2e-3 / 2.3e-2) before and after any change of the
# track head's summation order; phase 9 logs which, for the bands' sizing
TRACK_BAND_REQUESTS = 6
WITNESS_SLACK = 1.25
# the camera solve and the joint stitch on the card against the CPU, on the
# same rays, depth and draws, fp32: max |card - CPU| <= GEOMETRY_TOL * max
# |CPU| per output. cuSOLVER and LAPACK reach the same SVD, eigh and QR
# solutions to fp32 rounding, which the homography refits and the Sim(3)
# chain carry from window to window
GEOMETRY_TOL = 1e-3
# the synthetic trajectory's solve against its truth: max |error| of the
# estimated K and of the window poses over their largest value, and the
# median of |stitched depth / true depth - 1|. The rays carry 1e-3 noise and
# the depth 1% noise (whose own median is 6.7e-3); the CPU measured 1.5e-3,
# 1.65e-3 and 6.8e-3, and the bands are about twice that
TRUTH_BANDS = {"K": 3e-3, "poses": 3.5e-3, "depth": 1.4e-2}
FRAMES = (48, 32, 16)
REPEATS = 3  # timed requests per video length / query count
TRACK_FRAMES = 48
QUERY_CHUNK = 128  # queries per track chunk (the benchmark's 48-frame, 128-query point)
TRACK_QUERIES = (128, 64)
PADDED_QUERIES = 160  # two chunks of 128, the second padded
DENSE_KEYS = {"flow_2d_backward_est_b2thw": 2, "depth_est_b1thw": 1, "dyn_mask_est_b1thw": 1}
TRACK_KEYS = {"track_2d_traj_est_bn2t": 2, "track_2d_vis_est_bn1t": 1, "track_2d_depth_est_bn1t": 1}
CAMRAY_KEYS = {"traj3d_est_b16t": 16, "traj3d_intrinsics_est_b16t": 16}
# phase 19: the bf16 model against fp32, per output: the reference's envelope
# for its bf16 model against the fp32 torch oracle (PARITY.md), over
# BF16_WINDOWS windows
BF16_ENVELOPE = 1e-2
BF16_WINDOWS = 3
# phases 21-22: DAVIS's frame size, the pipeline's frames (two windows), and
# the point maps on the card against the CPU (fp32, TF32 off), relative to
# the largest CPU value
DAVIS_HW = (480, 854)
PIPELINE_FRAMES = 24
POINT_MAP_TOL = 1e-5
# phase 23: each eval metric on the card against the CPU from the same
# outputs, |card - CPU| <= EVAL_METRIC_TOL * (1 + |CPU|): fp32 sums in
# another order and cuSOLVER's inverses for the poses, while the medians and
# the counts are the same; the H100 measured <= 1.05e-7 over the five
# configs, and one pixel crossing a threshold of the 2.4 M a metric counts
# moves it 4e-7
EVAL_METRIC_TOL = 1e-6
# phase 25 (training): GRADIENT_QUERIES queries of one 16-frame window, as
# scripts/train_step_tpu.py's default. (a) per kernel Function, the
# gradients of 0.5 |out A - target|^2 (grad_of_fit) for all its inputs and
# parameters together, the kernel path against the plain path: |kernel -
# plain| / |plain| (L2 over every entry) <= FUNCTION_GRAD_BAND. The
# backward recomputes the plain version, so the two differ only through the
# forward's output (the cotangent); the H100 measured 2.2e-3 (attention),
# 2.6e-4 (upscale), 4.1e-3 (two-way transformer), 2.2e-3 (fused encoder).
# Against the plain path on fp32 copies of the same values, the kernel
# path's L1 distance within GRAD_WITNESS_SLACK of the plain path's
# (measured 0.999, 1.00, 1.04, 1.02). (b) the first train step's
# gradients, kernel path against plain path: the L2 distance over all of
# them <= STEP_GRAD_L2 of the plain path's (measured 5.8e-3, 6.3e-3), and the
# median parameter's max |kernel - plain| <= STEP_GRAD_BAND of its max
# |plain| (8.0e-3, 8.2e-3). The bands are about twice the readings
GRADIENT_QUERIES = 32
FUNCTION_GRAD_BAND = 1e-2
GRAD_WITNESS_SLACK = 1.25
STEP_GRAD_BAND = 2e-2
STEP_GRAD_L2 = 1.5e-2
# phase 26 (VideoMAE pretraining, giant, batch 2, ratio 0.9): the first
# step's loss and every step's on the kernel path against the plain path,
# |kernel - plain| / |plain| <= MAE_LOSS_TOL; the first step's gradients,
# the L2 distance over all of them <= MAE_STEP_GRAD_L2 of the plain path's
# and the median parameter's max |kernel - plain| <= MAE_STEP_GRAD_BAND of
# its max |plain|. The two paths differ only in the 48 attention outputs'
# bf16 rounding (the backward recomputes the plain version); the H100
# measured losses 5.3e-6, 6.8e-6 and 1.7e-6 apart, gradients 2.1e-3 (L2) and
# 4.2e-3 (median parameter), and the bands are about twice that
MAE_BATCH = 2
MAE_MASK_RATIO = 0.9
MAE_STEPS = 3
MAE_LOSS_TOL = 1.5e-5
MAE_STEP_GRAD_L2 = 5e-3
MAE_STEP_GRAD_BAND = 1e-2
# phase 27 (multi-GPU). (b) the giant encoder split over a model axis of 2
# (two processes on the one card, gloo) against one process, per hook end:
# max |TP - one process| <= band * max |one process|. Both round q/k/v, the
# GELU outputs and every residual add to bf16 at the same points; the split
# proj and fc2 sum their fp32 partials in another order before their one
# rounding, so values land a bf16 step apart and the difference grows
# through the blocks, as the fused encoder's does. Measured on an H100
# 1.72e-2, 2.10e-2, 2.10e-2, 2.97e-2, 3.04e-2; the bands are about twice
# that. Both against the one-process encoder in fp32 (plain attention, TF32
# off): the TP encoder's mean |error| within ENCODER_WITNESS_SLACK of the
# one-process encoder's, per hook end
TP_ENCODER_BANDS = {14: 3.5e-2, 21: 4.5e-2, 28: 4.5e-2, 36: 6e-2, 40: 6e-2}
# (a) the kernels at the shapes a rank gives them: the default encoder's
# chunk of 2 windows at 8 heads (a model axis of 2) and its last chunk of 1,
# and the track chunk of 128 queries over a data axis of 2 and of 4
SHARD_ATTENTION_SHAPES = ((2, 8, 2048, 88), (1, 8, 2048, 88))
SHARD_QUERIES = (64, 32)
# (b) the TP encoder's timed requests (the first one cold): each takes
# seconds, its all-reduces going through the host
TP_REPS = 2
# (d) cards a multi-card run takes at most, and the frames of its fps reading (bench.py's 192 x 128 point)
MULTI_CARDS = 4
MULTI_CARD_FRAMES = 192
# NVIDIA's H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 rate
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate(kernel, plain, iters: int):
    """(kernel ms, plain ms), timed plain / kernel / kernel / plain in one process."""
    t_plain1 = time_ms(plain, iters)
    t_k1 = time_ms(kernel, iters)
    t_k2 = time_ms(kernel, iters)
    t_plain2 = time_ms(plain, iters)
    return (t_k1 + t_k2) / 2, (t_plain1 + t_plain2) / 2


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flop: float, moved: float) -> dict:
    """The least time the card could take: FLOP over the bf16 peak or bytes
    over the memory rate, whichever is larger."""
    t_ops, t_bytes = flop / PEAK_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def bound_text(rec: dict) -> str:
    return (f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"({100 * rec['bound_ms'] / rec['ms']:.1f}% of it reached)")


class Checks:
    """Collects failed checks, so one run reports every phase's numbers."""

    def __init__(self, log):
        self.log, self.failed = log, []

    def expect(self, ok: bool, what: str) -> None:
        if not ok:
            self.log(f"FAILED: {what}")
            self.failed.append(what)


def compare_attention(FA, shape, gen, log, checks, library: bool) -> dict:
    """q, k, v in the layout both encoder paths hand the kernel (rows padded
    to FA.kernel_row_pitch(D)); scaled_dot_product_attention on the same
    tensors."""
    b, h, n, d = shape
    q, k, v = (FA.kernel_layout(torch.randn(shape, generator=gen, device="cuda").bfloat16()) for _ in range(3))
    scale = d ** -0.5
    out = FA.flash_attention(q, k, v, scale)
    plain = FA.flash_attention_plain(q, k, v, scale)
    exact = FA.flash_attention_plain(q.float(), k.float(), v.float(), scale)  # fp32 from the same bf16 inputs
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    # how far each bf16 path is from the fp32 result: the kernel and the
    # plain version round at other points, and neither should be the worse
    off = {name: ((x.float() - exact).abs().mean().item(), (x.float() - exact).abs().max().item())
           for name, x in (("kernel", out), ("plain", plain))}
    del exact
    ms, plain_ms = alternate(lambda: FA.flash_attention(q, k, v, scale),
                             lambda: FA.flash_attention_plain(q, k, v, scale), 20)
    flop = 4 * b * h * n * n * d
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound(flop, nbytes(q, k, v, out)),
           "library_ms": None}
    if library:
        rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 20)
    lib = f", scaled_dot_product_attention {rec['library_ms']:.4f} ms" if library else ""
    log(f"attention {shape} bf16 against fp32 on the same inputs: mean / max |error| kernel "
        f"{off['kernel'][0]:.3g} / {off['kernel'][1]:.3g}, plain {off['plain'][0]:.3g} / {off['plain'][1]:.3g}")
    log(f"attention {shape} bf16: max|kernel-plain| {err:.3g} (tol {KERNEL_TOL}); "
        f"kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms{lib}; {bound_text(rec)}")
    checks.expect(math.isfinite(err) and err <= KERNEL_TOL, f"attention kernel vs plain at {shape}: {err}")
    return rec


def compare_track_kernel(name, kernel, plain, args, band, iters, log, checks, flop, keys_traffic=None,
                         library=None) -> dict:
    """Holds `kernel(*args)` against `plain(*args)` (one tensor or a tuple)
    within band * max|plain| for each output, then times both, and
    `library()`, one PyTorch call of the same function, where there is one."""
    outs, refs = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    errs, ratios = [], []
    for o, r in zip(outs, refs):
        checks.expect(o.shape == r.shape and bool(torch.isfinite(o).all()),
                      f"{name}: kernel output {tuple(o.shape)} is not finite or not {tuple(r.shape)}")
        err = (o.float() - r.float()).abs().max().item()
        errs.append(err)
        ratios.append(err / r.float().abs().max().item())
    moved = nbytes(*(a for a in args if isinstance(a, torch.Tensor)), *outs)
    del outs, refs
    ms, plain_ms = alternate(lambda: kernel(*args), lambda: plain(*args), iters)
    rec = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, **bound(flop, moved),
           "library_ms": None if library is None else time_ms(library, iters)}
    rate = f", {flop / ms / 1e9:.1f} TFLOP/s"
    if keys_traffic:
        rate += f", {keys_traffic / ms / 1e6:.0f} GB/s of keys traffic"
    lib = "" if library is None else f", one library call {rec['library_ms']:.4f} ms"
    log(f"{name} src{tuple(args[0].shape)} bf16: max|kernel-plain| {', '.join(f'{e:.4g}' for e in errs)} = "
        f"{', '.join(f'{x:.3g}' for x in ratios)} x max|plain| (band {band}); "
        f"kernel {ms:.4f} ms{rate}, plain {plain_ms:.4f} ms{lib}; {bound_text(rec)}")
    checks.expect(all(math.isfinite(x) and x <= band for x in ratios),
                  f"{name} disagrees with its plain version at {tuple(args[0].shape)}: {ratios}")
    return rec


def keys_operands(n, p, c, k, gen, k2=None):
    """The two-way transformer kernels' operands with the factored prep's
    magnitudes: unit keys, logits of order one, K tokens of 8 heads; the
    next t2i's st and spe (shared with t2i_flash's) have K2 (default K)."""
    def r(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    k2 = k if k2 is None else k2
    keys, st, spe = r(n, p, c), r(n, c, k2, scale=c ** -0.5), r(n, p, k2, dtype=torch.float32)
    i2t = (keys, r(n, c, k, scale=c ** -0.5), r(n, p, k, dtype=torch.float32), r(n, k, c, scale=0.2),
           r(c, scale=0.1), 1.0 + r(c, scale=0.1), r(c, scale=0.1), st, spe)
    return (keys, st, spe), i2t


def keys_witness(FK, t2i_args, i2t_args, heads, log, checks) -> None:
    """t2i_flash and i2t_ln_t2i and their plain versions against the plain
    versions on fp32 copies of the same bf16 operands (no bf16 rounding
    anywhere): each kernel output no farther from it than the plain
    version's, within KEYS_WITNESS_SLACK on the mean |error|."""
    runs = {"t2i_flash": (FK.t2i_flash(*t2i_args), FK.t2i_flash_plain(*t2i_args),
                          FK.t2i_flash_plain(*(a.float() for a in t2i_args)))}
    kernel, plain = FK.i2t_ln_t2i(*i2t_args, heads), FK.i2t_ln_t2i_plain(*i2t_args, heads)
    exact = FK.i2t_ln_t2i_plain(*(a.float() for a in i2t_args), heads)
    runs.update({f"i2t_ln_t2i {what}": (kernel[i], plain[i], exact[i]) for i, what in enumerate(("keys", "wsum"))})
    torch.cuda.synchronize()
    for name, (out, ref, ex) in runs.items():
        off = {who: ((x.float() - ex).abs().mean().item(), (x.float() - ex).abs().max().item())
               for who, x in (("kernel", out), ("plain", ref))}
        ratio = off["kernel"][0] / off["plain"][0]
        log(f"{name} keys{tuple(t2i_args[0].shape)} bf16 against fp32 on the same inputs: mean / max |error| "
            f"kernel {off['kernel'][0]:.3g} / {off['kernel'][1]:.3g}, plain {off['plain'][0]:.3g} / "
            f"{off['plain'][1]:.3g} (mean ratio {ratio:.3g}, within {KEYS_WITNESS_SLACK})")
        checks.expect(math.isfinite(ratio) and ratio <= KEYS_WITNESS_SLACK,
                      f"{name} is farther from fp32 than its plain version at {tuple(t2i_args[0].shape)}: {off}")


def upscale_operands(n, p, c, d1, d2, m, gen):
    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=gen.device) * scale).bfloat16()

    return (r(n, p, c), r(c, d1, 2, 2, 2, scale=c ** -0.5), r(d1, scale=0.1), 1.0 + r(d1, scale=0.1),
            r(d1, scale=0.1), r(d1, d2, 1, 2, 2, scale=d1 ** -0.5), r(d2, scale=0.1), r(n, m, d2, scale=0.1))


def upscale_witness(FU, args, log, checks) -> None:
    """The upscale kernel and its plain version against the plain version on
    fp32 copies of the same bf16 operands (no bf16 rounding anywhere): the
    kernel must be no farther from it than the plain version, within
    UPSCALE_WITNESS_SLACK on the mean |error|."""
    out, plain = FU.fused_upscale_hypernet(*args), FU.fused_upscale_hypernet_plain(*args)
    exact = FU.fused_upscale_hypernet_plain(*(a.float() for a in args))
    torch.cuda.synchronize()
    off = {name: ((x - exact).abs().mean().item(), (x - exact).abs().max().item())
           for name, x in (("kernel", out), ("plain", plain))}
    ratio = off["kernel"][0] / off["plain"][0]
    log(f"fused_upscale_hypernet src{tuple(args[0].shape)} bf16 against fp32 on the same inputs: mean / max |error| "
        f"kernel {off['kernel'][0]:.3g} / {off['kernel'][1]:.3g}, plain {off['plain'][0]:.3g} / "
        f"{off['plain'][1]:.3g} (mean ratio {ratio:.3g}, within {UPSCALE_WITNESS_SLACK})")
    checks.expect(math.isfinite(ratio) and ratio <= UPSCALE_WITNESS_SLACK,
                  f"fused_upscale_hypernet is farther from fp32 than its plain version at "
                  f"{tuple(args[0].shape)}: {off}")


def encoder_operands(cfg, b, n, gen):
    """The encoder's blocks in bf16 with Xavier weights and random biases and
    LayerNorm affines, so every bias and affine path runs, and tokens x."""
    from l4p_tpu_torch.models.encoder import VideoEncoder

    enc = VideoEncoder(cfg, device="cuda", dtype=torch.bfloat16).eval()
    enc.init_weights(gen)
    with torch.no_grad():
        for name, p in enc.blocks.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
            elif "norm" in name:
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen, device="cuda"))
    return enc.blocks, torch.randn((b, n, cfg.embed_dim), generator=gen, device="cuda").bfloat16()


def encoder_flop(cfg, b: int, n: int, depth: int) -> float:
    """qkv, proj, fc1, fc2 and the attention's two products, per block."""
    e, hidden = cfg.embed_dim, cfg.mlp_hidden
    return depth * b * (2 * n * e * 3 * e + 2 * n * e * e + 4 * n * e * hidden + 4 * n * n * e)


def encoder_witness(FE, blocks, x, cfg, ends, out, ref, log, checks) -> None:
    """The kernel path's hooks `out` and the bf16 plain path's `ref` against
    fused_encoder_blocks_plain on fp32 copies of the same bf16 blocks and
    tokens: per hook, the kernel's mean |error| within ENCODER_WITNESS_SLACK
    of the plain path's."""
    import copy

    exact = FE.fused_encoder_blocks_plain(copy.deepcopy(blocks[: ends[-1]]).float(), x.float(), cfg, ends)
    for i, e in enumerate(ends):
        off = {name: (t[:, i].float() - exact[:, i]).abs() for name, t in (("kernel", out), ("plain", ref))}
        mean = {name: d.mean().item() for name, d in off.items()}
        top = {name: d.max().item() for name, d in off.items()}
        ratio, top_ratio = mean["kernel"] / mean["plain"], top["kernel"] / top["plain"]
        log(f"fused_encoder_blocks hook {e} against fp32 on the same inputs: mean / max |error| kernel "
            f"{mean['kernel']:.4g} / {top['kernel']:.4g}, plain {mean['plain']:.4g} / {top['plain']:.4g}; ratio "
            f"mean {ratio:.3g}, max {top_ratio:.3g} (mean within {ENCODER_WITNESS_SLACK})")
        checks.expect(math.isfinite(ratio) and ratio <= ENCODER_WITNESS_SLACK,
                      f"fused_encoder_blocks hook {e} is farther from fp32 than its plain version: {mean}")


def compare_fused_encoder(FE, cfg, b, n, ends, bands, gen, iters, log, checks, witness: bool = False) -> dict:
    blocks, x = encoder_operands(cfg, b, n, gen)
    with torch.no_grad():
        before = FE.fused_encoder_blocks.kernel_launches
        out = FE.fused_encoder_blocks(blocks, x, cfg, ends)
        torch.cuda.synchronize()
        inner = FE.fused_encoder_blocks.kernel_launches - before
        ref = FE.fused_encoder_blocks_plain(blocks, x, cfg, ends)
        ratios = []
        for i, e in enumerate(ends):
            checks.expect(bool(torch.isfinite(out[:, i]).all()), f"fused_encoder_blocks hook {e} is not finite")
            ratios.append((out[:, i].float() - ref[:, i].float()).abs().max().item()
                          / ref[:, i].float().abs().max().item())
        err = (out.float() - ref.float()).abs().max().item()
        if witness:
            encoder_witness(FE, blocks, x, cfg, ends, out, ref, log, checks)
        del ref
        ms, plain_ms = alternate(lambda: FE.fused_encoder_blocks(blocks, x, cfg, ends),
                                 lambda: FE.fused_encoder_blocks_plain(blocks, x, cfg, ends), iters)
    flop = encoder_flop(cfg, b, n, ends[-1])
    weights = nbytes(*(p for blk in blocks[: ends[-1]] for p in blk.parameters()))
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound(flop, weights + nbytes(x, out)),
           "library_ms": None}
    log(f"fused_encoder_blocks x{tuple(x.shape)} bf16, {ends[-1]} blocks, ends {ends}: {inner} launches inside; "
        f"max|kernel-plain| / max|plain| per hook "
        f"{', '.join(f'{e}: {r:.3g} (band {bands[e]})' for e, r in zip(ends, ratios))}; kernel {ms:.4f} ms "
        f"({flop / ms / 1e9:.1f} TFLOP/s, {ms / b:.4f} ms per window), plain {plain_ms:.4f} ms; {bound_text(rec)}")
    checks.expect(inner == FE.LAUNCHES_PER_BLOCK * ends[-1], f"fused_encoder_blocks made {inner} launches inside")
    checks.expect(all(math.isfinite(r) and r <= bands[e] for e, r in zip(ends, ratios)),
                  f"fused_encoder_blocks disagrees with its plain version at {tuple(x.shape)}: {ratios}")
    return rec


# (name, epilogue, N, K) of a giant block's four products (E = 1408, MLP 6144)
BLOCK_PRODUCTS = (("qkv", "QKV", 4224, 1408), ("proj", "RESIDUAL", 1408, 1408), ("fc1", "GELU", 6144, 1408),
                  ("fc2", "RESIDUAL", 1408, 6144))


# the DPT heads' five resizes at a head call of 2 windows: the four fusion
# upsamples (256 channels) and the final resize to the window (128)
DPT_RESIZES = (((2, 256, 4, 8, 8), (8, 16, 16)), ((2, 256, 8, 16, 16), (16, 32, 32)),
               ((2, 256, 16, 32, 32), (16, 64, 64)), ((2, 256, 16, 64, 64), (16, 128, 128)),
               ((2, 128, 16, 128, 128), (16, 224, 224)))
RESIZES_PER_HEAD_CALL = {"camray": 2, "camera_rays": 2}  # the others' DPT: 5
# VGGT's cell (portbench/traffic/vggt-64f-294x518.json): frame and global
# attention; the DPT heads' five bilinear resizes of an 8-frame chunk
VGGT_ATTENTION = ((64, 16, 782, 64), (1, 16, 50048, 64))
VGGT_RESIZES = (((8, 256, 11, 19), (21, 37)), ((8, 256, 21, 37), (42, 74)), ((8, 256, 42, 74), (84, 148)),
                ((8, 256, 84, 148), (168, 296)), ((8, 128, 168, 296), (294, 518)))
# the attention kernel against its plain version at VGGT's shapes, max
# |error| over max |plain|
VGGT_ATTENTION_TOL = 0.02
# the attention prologue (ops/qk_norm_rope.py) at a frame and a global block's call: max |kernel - plain| of q and k
QK_NORM_ROPE_TOL = 0.0625
# Video Depth Anything's cell (portbench/traffic/vda-110f-518x924.json): the
# temporal attention of its four motion modules at 518 x 924 (37 x 66
# patches), B*H = positions x 8 heads over 32 frames: MM3 (9768 positions
# of refinenet3's output, 78,144 sequences: the grid's z), MM0 (2442), MM1
# (627) and MM2 (2442); then the encoder's spatial attention, 32 frames of
# 2443 tokens
VDA_ATTENTION = ((9768, 8, 32, 32), (2442, 8, 32, 128), (627, 8, 32, 128), (2442, 8, 32, 32), (32, 16, 2443, 64))
VDA_FRAMES, VDA_HW = 110, (518, 924)
# max |kernel - plain| over max |plain| at VDA's shapes: an H100 read
# 0.0035-0.0057 (one bf16 step of the largest outputs); at about 2x that,
# the tolerance is a fifth of the temporal calls' mean |plain| (0.21) and a
# quarter of the encoder's (0.027), below a typical output value
VDA_ATTENTION_TOL = 0.0125
# SAM 2's memory attention: one head of 256 over the full bank (7 memories of 4,096 tokens and 16 pointers of
# 4 tokens) and over 4,096 keys (the self-attention), 8 objects; then Hiera's calls at head dim 72 on a chunk of
# ENCODE_CHUNK = 8 frames of 1024^2, (B, H, Nq, D) and Nk: stage 1's windows of 64 tokens, block 2's q-pooled
# windows (16 queries over 64 keys), stage 2's windows of 16, block 8's (4 over 16), stage 3's windows of 256,
# the global blocks' 4,096 tokens, block 44's (64 over 256) and stage 4's windows of 64; the band relative to
# max |plain|, as VGGT's
SAM2_ATTENTION = (((8, 1, 4096, 256), 28736), ((8, 1, 4096, 256), 4096),
                  ((8192, 2, 64, 72), 64), ((8192, 4, 16, 72), 64), ((8192, 4, 16, 72), 16), ((8192, 8, 4, 72), 16),
                  ((128, 8, 256, 72), 256), ((8, 8, 4096, 72), 4096), ((128, 16, 64, 72), 256),
                  ((128, 16, 64, 72), 64))
SAM2_ATTENTION_TOL = 0.03
# the chosen mask logits of 8 objects to the image's size, fp32, against F.interpolate: max |error| over max
# |plain| (fp32 rounding of a 4-tap weighted sum)
SAM2_RESIZE, SAM2_RESIZE_TOL = ((8, 1, 256, 256), (1024, 1024)), 1e-5
SAM2_CELL, SAM2_SEED = "sam2_1_l-64f-1024-8obj", 2 ** 31 + 25


def device_ms(fn, iters: int = 20) -> float:
    """fn's device time: the launches queue behind a sleeping kernel, so the
    host's time to launch them is not counted."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_resizes(RS, dev, log, checks) -> list:
    """interpolate_trilinear at DPT_RESIZES in bf16, channels_last_3d as the
    DPT trunk's convs hand it over: equal to F.interpolate, device ms in turns
    with it (F.interpolate, kernel, kernel, F.interpolate). Its inputs come
    from a generator of its own, so the later phases draw what they drew
    before it was added."""
    gen = torch.Generator(device=dev).manual_seed(18)
    rows, total = [], [0.0, 0.0, 0.0]
    for shape, size in DPT_RESIZES:
        x = torch.randn(shape, generator=gen, device=gen.device).bfloat16().contiguous(
            memory_format=torch.channels_last_3d)
        kernel = functools.partial(RS.interpolate_trilinear, x, size, True)
        plain = functools.partial(F.interpolate, x, size=size, mode="trilinear", align_corners=True)
        checks.expect(torch.equal(kernel(), plain()),
                      f"interpolate_trilinear {shape} -> {size} differs from F.interpolate")
        p1, k1, k2, p2 = device_ms(plain), device_ms(kernel), device_ms(kernel), device_ms(plain)
        rec = {"shape": list(shape), "size": list(size), "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
               **bound(0.0, (x.numel() + shape[0] * shape[1] * math.prod(size)) * x.element_size())}
        rec["library_ms"] = rec["plain_ms"]
        for i, key in enumerate(("ms", "plain_ms", "bound_ms")):
            total[i] += rec[key]
        log(f"interpolate_trilinear {tuple(shape)} -> {size} bf16: kernel {rec['ms']:.4f} ms, F.interpolate (the "
            f"plain version and the one library call) {rec['plain_ms']:.4f} ms; {bound_text(rec)}")
        rows.append(rec)
        del x
    log(f"interpolate_trilinear, the five resizes of a head call: kernel {total[0]:.4f} ms, F.interpolate "
        f"{total[1]:.4f} ms, bound {total[2]:.4f} ms")
    return rows


def resize_launches(cfg, tasks, frames: int) -> int:
    """interpolate_trilinear's launches for one request: each DPT head runs
    its windows dense_window_chunk at a time, RESIZES_PER_HEAD_CALL a call."""
    from l4p_tpu_torch.models.l4p import num_windows

    calls = math.ceil(num_windows(cfg, frames) / cfg.dense_window_chunk)
    heads = [t for t in tasks if t in cfg.head_dict]
    return calls * sum(RESIZES_PER_HEAD_CALL.get(t, 5) for t in heads)


def compare_qk_norm_rope(QNR, gen, log, checks) -> list:
    """The attention prologue at VGGT's frame and global calls ((64, 782)
    and (1, 50048) tokens, 16 heads of 64) with the norm and the rotation,
    the norm alone and the rotation alone: v bit for bit, q and k within
    QK_NORM_ROPE_TOL of the plain version on the card, one launch a call,
    and device ms in turns with the plain version (the chain the block ran
    before the kernel: upcasts, F.layer_norm, the rotation, casts, v's copy)
    beside the bound (q, k, v read and written once, the norms and table)."""
    from l4p_tpu_torch.models.vggt import frame_positions

    rope = QNR.Rope2D(frame_positions(21, 37, 5, gen.device), 64, 100.0)
    rows = []
    for b, n in ((64, 782), (1, 50048)):
        qkv = (2 * torch.randn((b, n, 3 * 16 * 64), generator=gen, device=gen.device) + 0.5).bfloat16()
        norms = tuple(((1 + 0.3 * torch.randn(64, generator=gen, device=gen.device)) if i % 2 == 0 else
                       0.2 * torch.randn(64, generator=gen, device=gen.device)).bfloat16() for i in range(4))
        for norm, rot in ((True, True), (True, False), (False, True)):
            ns, table = (norms if norm else None), (rope if rot else None)
            before = QNR.qk_norm_rope.launches
            got = QNR.qk_norm_rope(qkv, 16, 1e-6, ns, table)
            torch.cuda.synchronize()
            launches = QNR.qk_norm_rope.launches - before
            plain_args = (16, 1e-6, qkv, *(ns or (None,) * 4), *((rope.cos, rope.sin) if rot else (None, None)))
            want = QNR.qk_norm_rope_plain(*plain_args)
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got[:2], want[:2]))
            differ = sum((g != w).sum().item() for g, w in zip(got[:2], want[:2])) / (2 * got[0].numel())
            exact_v = torch.equal(got[2], want[2])
            moved = nbytes(qkv, *got, *(ns or ()), *((rope.cos, rope.sin) if rot else ()))
            del got, want
            kernel = functools.partial(QNR.qk_norm_rope, qkv, 16, 1e-6, ns, table)
            plain = functools.partial(QNR.qk_norm_rope_plain, *plain_args)
            p1, k1, k2, p2 = device_ms(plain, 10), device_ms(kernel, 10), device_ms(kernel, 10), device_ms(plain, 10)
            r = {"shape": [b, n, 16, 64], "norm": norm, "rope": rot, "max_abs_err": err, "share_differing": differ,
                 "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, **bound(0.0, moved)}
            log(f"qk_norm_rope {(b, n, 16, 64)} norm={norm} rope={rot}: max|kernel-plain| {err:.4g} of q/k "
                f"(tol {QK_NORM_ROPE_TOL}), {100 * differ:.4f}% of q/k values differ, v equal {exact_v}, "
                f"{launches} launch; kernel {r['ms']:.4f} ms ({moved / r['ms'] / 1e6:.0f} GB/s), plain chain "
                f"{r['plain_ms']:.4f} ms; {bound_text(r)}")
            checks.expect(launches == 1 and exact_v and math.isfinite(err) and err <= QK_NORM_ROPE_TOL,
                          f"qk_norm_rope {(b, n)} norm={norm} rope={rot}: {launches} launches, v equal {exact_v}, "
                          f"q/k error {err}")
            rows.append(r)
        del qkv
    return rows


def track_products(cfg, frames: int, n_queries: int) -> dict:
    """einsum_fp32's tensor-core products in one request's track stage: per
    window and query chunk, depth + 1 t2i preparations (s, spe) and finishes
    (outh) and depth i2t preparations (r, per, v2) of models/sam.py; the PE
    products are spe and per."""
    from l4p_tpu_torch.models.l4p import num_windows

    depth = cfg.track.sam.sam_head_depth
    calls = num_windows(cfg, frames) * math.ceil(n_queries / QUERY_CHUNK)
    return {"all": calls * (6 * depth + 3), "pe": calls * (2 * depth + 1)}


def compare_track_products(CONV, dev, log, checks) -> list:
    """The five PE products of a track window and query chunk (3 spe =
    s . pe^T, 2 per = pe . r; models/sam.py) at N = 192 and 128, P = 2048,
    C = 1408, K = 48: einsum_fp32 on the tensor cores against the fp32
    einsum and its .contiguous() copy that they replace, each within
    TRACK_PRODUCT_BAND of the fp32 einsum's max, one count a product, device
    ms in turns (fp32, route, route, fp32) beside the bf16 bound. Inputs
    from a generator of their own."""
    gen = torch.Generator(device=dev).manual_seed(24)
    p, c, k, rows = 2048, 1408, 48, []
    pe = torch.randn((c, p), generator=gen, device=dev).bfloat16().t()  # pos_src: a transposed view
    for n in (192, 128):
        prods = [("nkc,pc->npk", (torch.randn((n, k, c), generator=gen, device=dev) * c ** -0.5).bfloat16(), pe)
                 for _ in range(3)]
        prods += [("pc,nck->npk", pe, (torch.randn((n, c, k), generator=gen, device=dev) * c ** -0.5).bfloat16())
                  for _ in range(2)]
        before = CONV.einsum_fp32.launches
        errs = []
        for spec, x, w in prods:
            got, want = CONV.einsum_fp32(spec, x, w), torch.einsum(spec, x.float(), w.float())
            checks.expect(got.is_contiguous() and got.shape == (n, p, k),
                          f"{spec} at N={n}: the result is not a contiguous (N, P, K)")
            errs.append((got - want).abs().max().item() / want.abs().max().item())
            del got, want
        launches = CONV.einsum_fp32.launches - before

        def route():
            return [CONV.einsum_fp32(spec, x, w).contiguous() for spec, x, w in prods]

        def fp32():
            return [torch.einsum(spec, x.float(), w.float()).contiguous() for spec, x, w in prods]

        f1, r1, r2, f2 = device_ms(fp32, 10), device_ms(route, 10), device_ms(route, 10), device_ms(fp32, 10)
        rec = {"n": n, "p": p, "c": c, "k": k, "max_err": max(errs), "ms": (r1 + r2) / 2, "fp32_ms": (f1 + f2) / 2,
               **bound(5 * 2 * n * k * c * p, 5 * (n * p * k * 4 + n * c * k * 2) + p * c * 2)}
        log(f"track head PE products x5 at N={n}, P={p}, C={c}, K={k}: tensor cores {rec['ms']:.4f} ms, fp32 einsum "
            f"+ copy {rec['fp32_ms']:.4f} ms; max|route - fp32| / max|fp32| {rec['max_err']:.3g} (band "
            f"{TRACK_PRODUCT_BAND}); {launches} counted; {bound_text(rec)}")
        checks.expect(launches == len(prods) and rec["max_err"] <= TRACK_PRODUCT_BAND,
                      f"PE products at N={n}: {launches} counted, error {rec['max_err']}")
        rows.append(rec)
        del prods
    return rows


def hold_attention(FA, shape, gen, label: str, log, halves: bool = False) -> dict:
    """The attention kernel at `shape` (bf16 N(0, 1) q, k, v from `gen`)
    against its plain version computed 1024 queries at a time: max |error|,
    max and mean |plain|, launches, ms beside scaled_dot_product_attention
    and the bound. With `halves`, also whether the launch equals two
    launches over the halves of B (each within the grid's y) bit for bit."""
    b, h, n, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device=gen.device).bfloat16() for _ in range(3))
    scale = d ** -0.5
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v, scale)
    launches = FA.flash_attention.launches - before
    err = top = total = 0.0
    for i in range(0, n, 1024):  # a row's softmax is its own: the plain version a block of queries at a time
        plain = FA.flash_attention_plain(q[:, :, i:i + 1024], k, v, scale).float()
        err = max(err, (out[:, :, i:i + 1024].float() - plain).abs().max().item())
        top = max(top, plain.abs().max().item())
        total += plain.abs().sum().item()
        del plain
    mean = total / out.numel()
    ms = time_ms(lambda: FA.flash_attention(q, k, v, scale), 10)
    r = {"shape": list(shape), "max_abs_err": err, "max_abs_plain": top, "mean_abs_plain": mean, "ms": ms,
         "launches": launches, "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 10),
         **bound(4 * b * h * n * n * d, nbytes(q, k, v, out))}
    split = ""
    if halves:
        m = b // 2
        r["equals_halves"] = torch.equal(out, torch.cat([FA.flash_attention(q[:m], k[:m], v[:m], scale),
                                                         FA.flash_attention(q[m:], k[m:], v[m:], scale)]))
        split = f", equal to two launches over halves of B {r['equals_halves']}"
    log(f"attention {shape} bf16 ({label}): max|kernel-plain| {err:.3g} = {err / top:.3g} of max|plain| {top:.3g} "
        f"= {err / mean:.3g} of mean|plain| {mean:.3g}, {launches} launch{split}; kernel {ms:.4f} ms "
        f"({4 * b * h * n * n * d / ms / 1e9:.1f} TFLOP/s), scaled_dot_product_attention {r['library_ms']:.4f} ms; "
        f"{bound_text(r)}")
    del q, k, v, out
    return r


def compare_vggt_kernels(FA, RS, dev, log, checks) -> dict:
    """The prologue, attention and resize kernels at VGGT's cell's shapes,
    and one VGGT-1B request at them (phase 2's docstring). Inputs and
    weights from generators of their own, so the later phases draw what
    they drew before it was added."""
    from l4p_tpu_torch.config import VGGT_TASKS, VGGTConfig
    from l4p_tpu_torch.inference import InferenceSession
    from l4p_tpu_torch.models.vggt import VGGT
    from l4p_tpu_torch.ops import qk_norm_rope as QNR
    from portbench.weights import seeded_state_dict

    gen = torch.Generator(device=dev).manual_seed(19)
    rec = {"attention": [], "resize": [], "qk_norm_rope": compare_qk_norm_rope(QNR, torch.Generator(
        device=dev).manual_seed(22), log, checks)}
    for shape in VGGT_ATTENTION:
        r = hold_attention(FA, shape, gen, "VGGT", log)
        checks.expect(math.isfinite(r["max_abs_err"]) and r["max_abs_err"] <= VGGT_ATTENTION_TOL * r["max_abs_plain"],
                      f"attention kernel vs plain at {shape}: {r['max_abs_err']} against max|plain| "
                      f"{r['max_abs_plain']}")
        checks.expect(r["launches"] == 1, f"attention {shape}: {r['launches']} launches, expected 1")
        rec["attention"].append(r)
    for shape, size in VGGT_RESIZES:
        x = torch.randn(shape, generator=gen, device=dev).bfloat16().contiguous(memory_format=torch.channels_last)
        before = RS.interpolate_trilinear.launches
        got = RS.interpolate_bilinear(x, size, True)
        launches = RS.interpolate_trilinear.launches - before
        checks.expect(launches == 1 and torch.equal(got, F.interpolate(x, size=size, mode="bilinear",
                                                                       align_corners=True)),
                      f"interpolate_bilinear {shape} -> {size}: {launches} launches, or differs from F.interpolate")
        kernel = functools.partial(RS.interpolate_bilinear, x, size, True)
        plain = functools.partial(F.interpolate, x, size=size, mode="bilinear", align_corners=True)
        p1, k1, k2, p2 = device_ms(plain), device_ms(kernel), device_ms(kernel), device_ms(plain)
        r = {"shape": list(shape), "size": list(size), "ms": (k1 + k2) / 2, "library_ms": (p1 + p2) / 2,
             **bound(0.0, (x.numel() + shape[0] * shape[1] * math.prod(size)) * x.element_size())}
        log(f"interpolate_bilinear {shape} -> {size} bf16 (VGGT): {launches} launch, kernel {r['ms']:.4f} ms, "
            f"F.interpolate {r['library_ms']:.4f} ms; {bound_text(r)}")
        rec["resize"].append(r)
        del x, got
    cfg = VGGTConfig()
    frames, hw = 64, (294, 518)
    model = VGGT(cfg, device=dev, dtype=torch.bfloat16).eval()
    model.load_state_dict(seeded_state_dict(model, 19, dev, torch.bfloat16), strict=True)  # the benchmark's scales
    video = torch.randint(0, 256, (1, frames, *hw, 3), generator=gen, device=dev, dtype=torch.uint8)
    before = FA.flash_attention.launches, RS.interpolate_trilinear.launches, QNR.qk_norm_rope.launches
    out = InferenceSession(cfg, VGGT_TASKS, dev)(model, {"rgb_u8_bthw3": video})
    torch.cuda.synchronize()
    got = (FA.flash_attention.launches - before[0], RS.interpolate_trilinear.launches - before[1],
           QNR.qk_norm_rope.launches - before[2])
    want = (cfg.embed_depth + 2 * cfg.depth + cfg.camera_iterations * cfg.camera_trunk_depth,
            2 * math.ceil(frames / cfg.frames_chunk_size) * 5, 2 * cfg.depth)
    bad = [key for key in ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf")
           if not bool(out[key].isfinite().all())]
    log(f"VGGT-1B request, {frames} frames of {hw}: {got[0]} attention, {got[1]} resize and {got[2]} qk_norm_rope "
        f"launches (expected {want}); outputs not finite: {bad or 'none'}")
    checks.expect(got == want, f"VGGT request launches {got}, expected {want}")
    checks.expect(not bad, f"VGGT request: outputs not finite {bad}")
    rec["request_launches"] = list(got)
    del model, out, video
    torch.cuda.empty_cache()
    return rec


def compare_vda_kernels(FA, RS, dev, log, checks) -> dict:
    """The attention kernel at Video Depth Anything's cell's shapes, and one
    request of VDA-L at them (phase 2's docstring). Inputs and weights from
    generators of their own, so the later phases draw what they drew before
    it was added."""
    from l4p_tpu_torch.config import VDA_TASKS, VDAConfig
    from l4p_tpu_torch.inference import InferenceSession
    from l4p_tpu_torch.models.vda import (INFER_LEN, MICRO_BATCH, VideoDepthAnything, load_upstream_state_dict,
                                          upstream_name, window_frames)
    from l4p_tpu_torch.ops import qk_norm_rope as QNR
    from portbench.drivers.vda import POSITIVE
    from portbench.drivers.vggt import seeded_weights

    gen = torch.Generator(device=dev).manual_seed(23)
    rec = {"attention": []}
    for shape in VDA_ATTENTION:
        r = hold_attention(FA, shape, gen, "VDA", log, halves=shape[0] * shape[1] > 65535)
        checks.expect(math.isfinite(r["max_abs_err"]) and r["max_abs_err"] <= VDA_ATTENTION_TOL * r["max_abs_plain"],
                      f"attention kernel vs plain at {shape}: {r['max_abs_err']} against max|plain| "
                      f"{r['max_abs_plain']}")
        checks.expect(r["launches"] == 1 and r.get("equals_halves", True),
                      f"attention {shape}: {r['launches']} launches, expected 1; equal to the halves' launches "
                      f"{r.get('equals_halves')}")
        rec["attention"].append(r)
    cfg = VDAConfig()
    model = VideoDepthAnything(cfg, device=dev, dtype=torch.bfloat16).eval()
    w = seeded_weights(model, 23, dev, torch.bfloat16, upstream_name)  # the benchmark driver's weights
    w.update({k: w[k].abs() for k in POSITIVE})
    w.update({k: v for k, v in model.state_dict().items() if k.endswith(".pe")})
    load_upstream_state_dict(model, w)
    del w
    video = torch.randint(0, 256, (1, VDA_FRAMES, *VDA_HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    sess = InferenceSession(cfg, VDA_TASKS, dev)
    torch.cuda.synchronize()
    for fn in (FA.flash_attention, RS.interpolate_trilinear, QNR.qk_norm_rope):
        fn.launches = 0
    t0 = time.perf_counter()
    out = sess(model, {"rgb_u8_bthw3": video})["depth"]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = (FA.flash_attention.launches, RS.interpolate_trilinear.launches, QNR.qk_norm_rope.launches)
    # a window: the encoder's blocks and 2 temporal attentions a motion module; refinenet4 and refinenet3
    # resize once, then each chunk of MICRO_BATCH frames refinenet2, refinenet1 and the output resize
    nw = len(window_frames(VDA_FRAMES))
    temporal = nw * len(model.head.motion_modules) * cfg.motion_attention_blocks
    want = (nw * cfg.encoder.depth + temporal, nw * (2 + 3 * INFER_LEN // MICRO_BATCH), 0)
    finite = bool(out.isfinite().all())
    log(f"VDA-L request, {VDA_FRAMES} frames of {VDA_HW} ({nw} windows): {got[0]} attention ({temporal} temporal, "
        f"{got[0] - temporal} encoder), {got[1]} resize and {got[2]} qk_norm_rope launches (expected {want}); depth "
        f"{tuple(out.shape)}, finite {finite}; {seconds:.3f} s cold")
    checks.expect(got == want, f"VDA request launches {got}, expected {want}")
    checks.expect(finite and tuple(out.shape) == (1, VDA_FRAMES, *VDA_HW), f"VDA request: depth {tuple(out.shape)}, "
                  f"finite {finite}")
    rec["request_launches"] = list(got)
    del model, out, video, sess
    torch.cuda.empty_cache()
    return rec


def compare_sam2(FA, RS, dev, log, checks) -> dict:
    """Phase 28: the attention kernel at SAM 2's memory-attention shapes
    (one head of 256) and Hiera's (head dim 72: windows, q-pooled windows,
    the global blocks) against its plain version, with the device ms of the
    kernel, the plain version and scaled_dot_product_attention beside the
    bound; the resize kernel at the mask logits' fp32 upsample against
    F.interpolate; one request of the benchmark's SAM 2 cell (the driver's
    model, weights and request) with its attention, resize and prologue
    launches counted against the model's calls, held against the reference
    within the cell's limits, the memory tokens it attended against the
    bank's count, its seconds and the peak memory. Callable alone after
    `_build.build_all` of the attention and resize libraries."""
    from l4p_tpu_torch.models.sam2 import ENCODE_CHUNK, Sam2, bank_order
    from l4p_tpu_torch.ops import qk_norm_rope as QNR
    from portbench import manifest as mf
    from portbench.drivers import sam2 as drv
    from portbench.drivers._common import checks as limit_checks
    from portbench.run import Context

    gen = torch.Generator(device=dev).manual_seed(25)
    rec = {"attention": []}
    for shape, nk in SAM2_ATTENTION:
        b, h, nq, d = shape
        q = torch.randn(shape, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, h, nk, d), generator=gen, device=dev).bfloat16() for _ in range(2))
        scale = d ** -0.5
        before = FA.flash_attention.launches
        out = FA.flash_attention(q, k, v, scale)
        launches = FA.flash_attention.launches - before
        err = top = 0.0
        for i in range(0, nq, 1024):
            plain = FA.flash_attention_plain(q[:, :, i:i + 1024], k, v, scale).float()
            err = max(err, (out[:, :, i:i + 1024].float() - plain).abs().max().item())
            top = max(top, plain.abs().max().item())
            del plain
        flop = 4 * b * h * nq * nk * d
        r = {"shape": [*shape[:3], nk, d], "max_abs_err": err, "max_abs_plain": top, "launches": launches,
             "ms": device_ms(lambda: FA.flash_attention(q, k, v, scale), 10),
             "plain_ms": device_ms(lambda: FA.flash_attention_plain(q, k, v, scale), 2),
             "library_ms": device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 10),
             **bound(flop, nbytes(q, k, v, out))}
        log(f"SAM 2 {'memory attention' if d == 256 else 'Hiera'} (B, H, Nq, Nk, D) = {tuple(r['shape'])} bf16: "
            f"max|kernel-plain| {err:.3g} = "
            f"{err / top:.3g} of max|plain| {top:.3g}, {launches} launch; kernel {r['ms']:.4f} ms "
            f"({flop / r['ms'] / 1e9:.1f} TFLOP/s), plain {r['plain_ms']:.3f} ms, scaled_dot_product_attention "
            f"{r['library_ms']:.4f} ms (device ms); {bound_text(r)}")
        checks.expect(launches == 1 and math.isfinite(err) and err <= SAM2_ATTENTION_TOL * top,
                      f"SAM 2 attention {tuple(r['shape'])}: {launches} launches, max|kernel-plain| {err} against "
                      f"max|plain| {top}")
        rec["attention"].append(r)
        del q, k, v, out
    torch.cuda.empty_cache()
    (shape, size) = SAM2_RESIZE
    x = 8 * torch.randn(shape, generator=gen, device=dev)
    before = RS.interpolate_trilinear.launches
    got = RS.interpolate_bilinear(x, size)
    launches = RS.interpolate_trilinear.launches - before
    plain = F.interpolate(x, size=size, mode="bilinear", align_corners=False)
    err, top = (got - plain).abs().max().item(), plain.abs().max().item()
    r = {"shape": list(shape), "size": list(size), "max_abs_err": err, "max_abs_plain": top, "launches": launches,
         "ms": device_ms(lambda: RS.interpolate_bilinear(x, size), 10),
         "library_ms": device_ms(lambda: F.interpolate(x, size=size, mode="bilinear", align_corners=False), 10),
         **bound(0, nbytes(x, got))}
    log(f"SAM 2 mask upsample {shape} -> {size} fp32: max|kernel-F.interpolate| {err:.3g} = {err / top:.3g} of "
        f"max|plain| {top:.3g}, {launches} launch; kernel {r['ms']:.4f} ms, F.interpolate {r['library_ms']:.4f} ms "
        f"(device ms); {bound_text(r)}")
    checks.expect(launches == 1 and math.isfinite(err) and err <= SAM2_RESIZE_TOL * top,
                  f"SAM 2 resize {shape} -> {size}: {launches} launches, max|kernel-plain| {err} against max|plain| "
                  f"{top}")
    rec["resize"] = r
    del x, got, plain
    bench = mf.Manifest.load()
    cell = bench.cell(SAM2_CELL)
    tr = bench.traffic(cell["traffic"])
    ctx = Context(cell, tr, bench.config_path(cell["config"]), bench.limits(SAM2_CELL), SAM2_SEED, 0.0, False, dev)
    served = drv.Cell(ctx)  # the model, its weights and two warm requests
    served.sample = served.sample[:1]
    Sam2.memory_tokens = 0
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    for fn in (FA.flash_attention, RS.interpolate_trilinear, QNR.qk_norm_rope):
        fn.launches = 0
    t0 = time.perf_counter()
    served.serve_sample()
    seconds = time.perf_counter() - t0
    got = (FA.flash_attention.launches, RS.interpolate_trilinear.launches, QNR.qk_norm_rope.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    cfg, frames = served.cfg, tr["frames"]
    # Hiera's blocks once a chunk of frames, memory attention's self- and cross-attention a layer on every frame
    # after the clicked one; one mask upsample a frame
    hiera = -(-frames // ENCODE_CHUNK) * sum(cfg.stages)
    want = (hiera + (frames - 1) * 2 * cfg.memory_layers, frames, 0)
    log(f"SAM 2 request: {got[0]} attention ({hiera} Hiera, {got[0] - hiera} memory attention), {got[1]} resize and "
        f"{got[2]} qk_norm_rope launches (expected {want})")
    checks.expect(got == want, f"SAM 2 request launches {got}, expected {want}")
    split, p = cfg.d_model // cfg.mem_dim, cfg.feat_size ** 2
    want_tokens = tr["objects"] * sum(len(m) * p + len(q) * split for m, q in
                                      (bank_order(f, cfg.num_maskmem - 1, min(frames, cfg.max_obj_ptrs) - 1)
                                       for f in range(1, frames)))
    log(f"SAM 2 request, {frames} frames of {tr['size']}^2, {tr['objects']} objects: {seconds:.3f} s "
        f"({frames / seconds:.1f} frames/s), memory tokens attended {Sam2.memory_tokens} (the bank's count "
        f"{want_tokens}), peak memory {peak / 2 ** 30:.2f} GiB")
    checks.expect(Sam2.memory_tokens == want_tokens, f"SAM 2 memory tokens {Sam2.memory_tokens}, expected "
                  f"{want_tokens}")
    got = limit_checks(served.readings()[0], ctx.limits)
    for name, c in got.items():
        log(f"SAM 2 against the reference: {name} {c['value']:.4g} (limit {c['limit']})")
        checks.expect(math.isfinite(c["value"]) and c["value"] <= c["limit"],
                      f"SAM 2 {name} {c['value']} above its limit {c['limit']}")
    rec.update(seconds=seconds, memory_tokens=Sam2.memory_tokens, peak_bytes=peak, request_launches=list(got),
               readings={k: c["value"] for k, c in got.items()})
    del served
    torch.cuda.empty_cache()
    return rec


def compare_block_products(FE, gen, log, checks) -> dict:
    """The blocks' GEMM (gemm_nt) alone at each product of a giant block, at
    M = 4096 (2 windows of 2048 tokens) and M = 10240 (the all-task request's
    5 windows), against its plain version and timed beside one torch.matmul
    of the same operands (a yardstick the port never calls). The kernel is
    timed through its launch thunk, as fused_encoder_blocks launches it, and
    again through the gemm_nt wrapper, whose checks cost host time per call
    that a short product cannot hide (printed beside it). Returns {"name M":
    {"ms", "matmul_ms", "wrapper_ms"}}."""
    from l4p_tpu_torch.ops.flash_attention import kernel_row_pitch

    out_rec = {}
    for m in (4096, 10240):
        for name, epi_name, n, k in BLOCK_PRODUCTS:
            epilogue = getattr(FE, epi_name)
            a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
            w = (torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5).bfloat16()
            bias = (0.1 * torch.randn((n,), generator=gen, device="cuda")).bfloat16()
            qkv = dict(tokens=2048, heads=16, head_dim=88) if epi_name == "QKV" else {}
            if qkv:
                out = torch.zeros((3, m // 2048, 16, 2048, kernel_row_pitch(88)), device="cuda", dtype=torch.bfloat16)
            else:
                out = torch.randn((m, n), generator=gen, device="cuda").bfloat16()
            ref = FE.gemm_nt_plain(a, w, bias, epilogue, out.clone(), **qkv)
            got = FE.gemm_nt(a, w, bias, epilogue, out.clone(), **qkv)
            torch.cuda.synchronize()
            if qkv:
                got, ref = got[..., :88], ref[..., :88]
            ratio = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
            del got, ref
            shape = (qkv.get("tokens", 1), qkv.get("heads", 1), qkv.get("head_dim", 2))
            args = (*FE.gemm_args(a, w, bias, out, None, epilogue, *shape), torch.cuda.current_stream().cuda_stream)
            launch = lambda: FE.GEMM(*args)  # noqa: E731
            ms, mm_ms = alternate(launch, lambda: torch.matmul(a, w.t()), 20)
            wrapper = lambda: FE.gemm_nt(a, w, bias, epilogue, out, **qkv)  # noqa: E731
            wrapper_ms = time_ms(wrapper, 20)
            t0 = time.perf_counter()
            for _ in range(20):
                wrapper()
            host_ms = (time.perf_counter() - t0) / 20 * 1e3
            torch.cuda.synchronize()
            flop = 2 * m * n * k
            log(f"gemm_nt {name} ({m} x {k}) . ({n} x {k})^T {epi_name} bf16: max|kernel-plain| / max|plain| "
                f"{ratio:.3g} (band {GEMM_BAND}); kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s), torch.matmul "
                f"{mm_ms:.4f} ms ({flop / mm_ms / 1e9:.1f} TFLOP/s, kernel / matmul {ms / mm_ms:.3g}); bound "
                f"{flop / PEAK_FLOPS * 1e3:.4f} ms by operations; through the gemm_nt wrapper {wrapper_ms:.4f} ms, "
                f"its host time {host_ms:.4f} ms a call")
            checks.expect(math.isfinite(ratio) and ratio <= GEMM_BAND,
                          f"gemm_nt {name} at M={m} disagrees with its plain version: {ratio}")
            out_rec[f"{name} M={m}"] = {"ms": ms, "matmul_ms": mm_ms, "wrapper_ms": wrapper_ms}
            del a, w, bias, out
    return out_rec


def check_outputs(out: dict, want: dict, frames: int, hw, checks, queries=None) -> None:
    """Keys, shapes, finite values, depth > 0; with `queries` (1, N, 3) the
    track outputs too: depth > 0 from each query's frame on (earlier frames
    keep the buffer's 0) and tracks inside the frame."""
    if set(out) != set(want):
        raise AssertionError(f"output keys {sorted(out)}, expected {sorted(want)}")
    n_queries = 0 if queries is None else queries.shape[1]
    for key, c in want.items():
        x = out[key]
        if key.startswith("track_2d"):
            shape = (1, n_queries, c, frames)
        elif key.startswith("traj3d"):
            shape = (1, c, frames)
        else:
            shape = (1, c, frames, *hw)
        checks.expect(tuple(x.shape) == shape, f"{key} has shape {tuple(x.shape)}, expected {shape}")
        checks.expect(bool(torch.isfinite(x).all()), f"{key} is not finite")
    if "depth_est_b1thw" in want:
        checks.expect(bool((out["depth_est_b1thw"] > 0).all()), "depth is not positive")
    if queries is not None:
        started = torch.arange(frames, device=queries.device) + 0.5 >= queries[0, :, :1]  # (N, T)
        checks.expect(bool((out["track_2d_depth_est_bn1t"][0, :, 0][started] > 0).all()),
                      "track depth is not positive")
        traj = out["track_2d_traj_est_bn2t"]  # (1, N, 2, T) as (x, y) pixels
        checks.expect(not (traj.min() < 0 or (traj[:, :, 0] > hw[1]).any() or (traj[:, :, 1] > hw[0]).any()),
                      "tracks leave the frame")


def track_queries(n: int, frames: int, hw, gen, dev) -> dict:
    """Half the queries at t = 0.5 (the benchmark's), half spread over the
    video so the validity, label and re-query logic runs; (t, x, y)."""
    first = n // 2
    t = torch.cat([torch.full((first,), 0.5, device=dev),
                   torch.rand(n - first, generator=gen, device=dev) * (frames - 1)])
    x = 4 + torch.rand(n, generator=gen, device=dev) * (hw[1] - 8)
    y = 4 + torch.rand(n, generator=gen, device=dev) * (hw[0] - 8)
    return {"track_2d_pointquerries_bn3": torch.stack([t, x, y], -1)[None],
            "track_2d_pointlabels_bn": torch.ones((1, n), device=dev)}


def bench_intrinsics(frames: int, hw, dev) -> torch.Tensor:
    """(1, 4, 4, T) pixel intrinsics as bench.py builds them: focal = width,
    principal point at the centre."""
    k = torch.diag(torch.tensor([float(hw[1]), float(hw[0]), 1.0, 1.0], device=dev))
    k[0, 2], k[1, 2] = hw[1] / 2, hw[0] / 2
    return k[None, :, :, None].expand(1, 4, 4, frames).contiguous()


def near_rotations(n: int, gen: torch.Generator, mild: float = 0.1) -> torch.Tensor:
    """n rotations near the identity, so the cameras face forward."""
    q = torch.linalg.qr(torch.randn((n, 3, 3), generator=gen))[0]
    r = (1 - mild) * torch.eye(3) + mild * q * torch.sign(torch.linalg.det(q))[:, None, None]
    u, _, vh = torch.linalg.svd(r)
    return u @ vh


def synthetic_trajectory(nw: int, ws: int, stride: int, hw, ray_hw, gen: torch.Generator):
    """One camera trajectory over (nw - 1) * stride + ws frames, each window
    seen through its own Sim(3) (scale 0.7-1.5), built on the CPU: per-window
    Plucker rays (nw, 1, 6, ws, rh, rw) of the true cameras (unit directions,
    1e-3 noise), depth (nw, 1, 1, ws, H, W) with 1% noise, the pixel
    intrinsics (1, 4, 4, T) as bench.py builds them, the true window poses
    (nw, 1, 16, ws) and the scene's depth in window 0's frame (1, 1, T, H, W)."""
    from l4p_tpu_torch.geometry.core import _pixel_grid, denormalize_intrinsics, normalize_intrinsics

    t_total = (nw - 1) * stride + ws
    k_px = bench_intrinsics(t_total, hw, "cpu")
    rot = near_rotations(t_total + nw, gen)
    cam_t_world = torch.eye(4).repeat(t_total, 1, 1)
    cam_t_world[:, :3, :3] = rot[:t_total]
    cam_t_world[:, :3, 3] = torch.rand((t_total, 3), generator=gen) - 0.5
    pose = torch.linalg.inv(cam_t_world)
    depth = 1 + 4 * torch.rand((1, 1, t_total, *hw), generator=gen)
    k_ray = denormalize_intrinsics(normalize_intrinsics(k_px, *hw), *ray_hw)[0, :3, :3, 0]
    d_cam = _pixel_grid(*ray_hw) @ torch.linalg.inv(k_ray).T
    d_cam = d_cam / torch.linalg.vector_norm(d_cam, dim=-1, keepdim=True)
    rays, depths, poses, scales = [], [], [], []
    for i in range(nw):
        lo = i * stride
        s = 0.7 + 0.8 * torch.rand((), generator=gen)
        g = torch.eye(4)
        g[:3, :3] = s * rot[t_total + i]
        g[:3, 3] = 0.6 * torch.rand(3, generator=gen) - 0.3
        p = torch.linalg.inv(g) @ pose[lo: lo + ws]
        p[:, :3, :3] *= s
        d = torch.einsum("tij,hwj->thwi", p[:, :3, :3], d_cam)
        m = torch.linalg.cross(p[:, None, None, :3, 3].expand_as(d), d, dim=-1)
        r = torch.cat([d, m], -1).permute(3, 0, 1, 2)
        rays.append(r + 1e-3 * torch.randn(r.shape, generator=gen))
        depths.append(depth[:, :, lo: lo + ws] / s * (1 + 0.01 * torch.randn((1, 1, ws, *hw), generator=gen)))
        poses.append(p.permute(1, 2, 0).reshape(1, 16, ws))
        scales.append(s)
    return torch.stack(rays)[:, None], torch.stack(depths), k_px, torch.stack(poses), depth / scales[0]


def spread(out: torch.Tensor, ref: torch.Tensor):
    """(max, 99th percentile) of |out - ref| over max |ref|."""
    diff, scale = (out.float() - ref.float()).abs(), ref.float().abs().max().item()
    return diff.max().item() / scale, diff.flatten().quantile(0.99).item() / scale


def fp32_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The attention in fp32 from the same bf16 q, k, v, rounded to bf16 once
    at the end: the witness both bf16 attentions are held against."""
    from l4p_tpu_torch.ops.flash_attention import flash_attention_plain

    return flash_attention_plain(q.float(), k.float(), v.float(), scale).to(q.dtype)


def track_witness(P, FA, model, cfg, dev, n_requests: int, log) -> dict:
    """Serves `n_requests` four-task requests on the default encoder, each a
    random 48-frame uint8 video with QUERY_CHUNK queries (track_queries)
    from its own seed, four times: the kernel path, the plain path (plain
    attention and track kernels), and each of them again with the attention
    in fp32 (fp32_attention). Returns, per track output, one (max, 99th
    percentile) `spread` per request of each path against its fp32 run
    ("kernel", "plain") and of the kernel path against the plain path
    ("kernel - plain"), and logs each."""
    hw = tuple(cfg.window_size[1:])
    tasks = P.SLICE_TASKS
    sessions = {
        "kernel": P.InferenceSession(cfg, tasks, dev),
        "plain": P.InferenceSession(cfg, tasks, dev, attention=FA.flash_attention_plain, track_kernels=P.PLAIN),
        "kernel fp32": P.InferenceSession(cfg, tasks, dev, attention=fp32_attention),
        "plain fp32": P.InferenceSession(cfg, tasks, dev, attention=fp32_attention, track_kernels=P.PLAIN),
    }
    rows = {key: {"kernel": [], "plain": [], "kernel - plain": []} for key in TRACK_KEYS}
    for r in range(n_requests):
        gen = torch.Generator(device=dev).manual_seed(100 + r)
        video = torch.randint(0, 256, (1, TRACK_FRAMES, *hw, 3), generator=gen, device=dev, dtype=torch.uint8)
        request = {"rgb_u8_bthw3": video, **track_queries(QUERY_CHUNK, TRACK_FRAMES, hw, gen, dev)}
        out = {name: sess(model, request) for name, sess in sessions.items()}
        for key, row in rows.items():
            got = {"kernel": spread(out["kernel"][key], out["kernel fp32"][key]),
                   "plain": spread(out["plain"][key], out["plain fp32"][key]),
                   "kernel - plain": spread(out["kernel"][key], out["plain"][key])}
            for what, v in got.items():
                row[what].append(v)
            log(f"witness request {r} {key}, (max, 99th pct) / output max: against its fp32-attention run "
                f"kernel path ({got['kernel'][0]:.3g}, {got['kernel'][1]:.3g}), plain path ({got['plain'][0]:.3g}, "
                f"{got['plain'][1]:.3g}); kernel path against plain path ({got['kernel - plain'][0]:.3g}, "
                f"{got['kernel - plain'][1]:.3g})")
        del out
    return rows


def eval_track_witness(P, model, cfg, frames: int, dev, seeds, log) -> dict:
    """Phase 23's track witness on more of the eval protocol's synthetic
    batches (float noise video, every query at t = 0.5, QUERY_CHUNK
    queries): each batch of `seeds` served on the track task by the kernel
    path, the plain path, the kernel attention with the plain track
    kernels, and each path again with the attention in fp32. Returns, per
    track output, one (max, 99th percentile) `spread` per batch of each
    path against its fp32 run ("kernel", "plain") and of the kernel path
    against the plain track kernels ("track"), and logs each."""
    from l4p_tpu_torch import eval_protocol as EP
    from l4p_tpu_torch.ops import flash_attention as FA

    hw, tasks = tuple(cfg.window_size[1:]), ("track_2d",)
    sessions = {
        "kernel": P.InferenceSession(cfg, tasks, dev),
        "plain": P.InferenceSession(cfg, tasks, dev, attention=FA.flash_attention_plain, track_kernels=P.PLAIN),
        "plain track kernels": P.InferenceSession(cfg, tasks, dev, track_kernels=P.PLAIN),
        "kernel fp32": P.InferenceSession(cfg, tasks, dev, attention=fp32_attention),
        "plain fp32": P.InferenceSession(cfg, tasks, dev, attention=fp32_attention, track_kernels=P.PLAIN),
    }
    rows = {key: {"kernel": [], "plain": [], "track": []} for key in TRACK_KEYS}
    for seed in seeds:
        batch = EP.synthetic_batch(frames, *hw, n_queries=QUERY_CHUNK, seed=seed, tasks=tasks)
        data = {k: torch.as_tensor(v, device=dev) for k, v in batch.items() if not isinstance(v, str)}
        out = {name: sess(model, data) for name, sess in sessions.items()}
        for key, row in rows.items():
            got = {"kernel": spread(out["kernel"][key], out["kernel fp32"][key]),
                   "plain": spread(out["plain"][key], out["plain fp32"][key]),
                   "track": spread(out["kernel"][key], out["plain track kernels"][key])}
            for what, v in got.items():
                row[what].append(v)
            log(f"eval witness batch {seed} {key}, (max, 99th pct) / output max: against its fp32-attention run "
                f"kernel path ({got['kernel'][0]:.3g}, {got['kernel'][1]:.3g}), plain path ({got['plain'][0]:.3g}, "
                f"{got['plain'][1]:.3g}); kernel path against the plain track kernels ({got['track'][0]:.3g}, "
                f"{got['track'][1]:.3g})")
        del out, data
    return rows


class HeldTrackKernels:
    """The track head's kernels (a TrackKernels) with every call
    also run by their plain versions (`plain`) on the same operands and on
    fp32 copies of them. Per kernel output it keeps the largest max|kernel -
    plain| / max|plain| of any call and the mean |error| of the kernel and of
    the plain version against the fp32 run, summed over the calls. The
    kernel's result goes on, so the request follows the kernel path."""

    def __init__(self, kernels, plain):
        self.calls, self.rows = {}, {}
        self.kernels = type(kernels)(
            self._wrap("t2i_flash", kernels.t2i, plain.t2i, ("",), KEYS_BAND, KEYS_WITNESS_SLACK),
            self._wrap("i2t_ln_t2i", kernels.i2t, plain.i2t, (" keys", " wsum"), KEYS_BAND, KEYS_WITNESS_SLACK),
            self._wrap("fused_upscale_hypernet", kernels.upscale, plain.upscale, ("",), UPSCALE_BAND,
                       UPSCALE_WITNESS_SLACK))

    def _wrap(self, name, kernel, plain, parts, band, slack):
        def call(*args):
            out = kernel(*args)
            ref = plain(*args)
            exact = plain(*(a.float() if isinstance(a, torch.Tensor) else a for a in args))
            self.calls[name] = self.calls.get(name, 0) + 1
            tup = (lambda x: x if isinstance(x, tuple) else (x,))
            for part, o, r, e in zip(parts, tup(out), tup(ref), tup(exact)):
                row = self.rows.setdefault(name + part, {"band": band, "slack": slack, "max": 0.0, "kernel": 0.0,
                                                         "plain": 0.0})
                o, r = o.float(), r.float()
                row["max"] = max(row["max"], (o - r).abs().max().item() / r.abs().max().item())
                row["kernel"] += (o - e).abs().mean().item()
                row["plain"] += (r - e).abs().mean().item()
            return out
        return call

    def check(self, what: str, want_calls: dict, log, checks) -> None:
        checks.expect(self.calls == want_calls, f"{what}: track kernel calls {self.calls}, expected {want_calls}")
        for name, row in self.rows.items():
            ratio = row["kernel"] / row["plain"] if row["plain"] else (math.inf if row["kernel"] else 1.0)
            log(f"{what} {name} over its {self.calls[name.split()[0]]} calls: max|kernel - plain| / max|plain| "
                f"{row['max']:.3g} (band {row['band']}); summed mean |error| against fp32 on the same operands "
                f"kernel {row['kernel']:.4g}, plain {row['plain']:.4g} (ratio {ratio:.3g}, within {row['slack']})")
            checks.expect(math.isfinite(row["max"]) and row["max"] <= row["band"],
                          f"{what} {name} disagrees with its plain version: {row['max']}")
            checks.expect(math.isfinite(ratio) and ratio <= row["slack"],
                          f"{what} {name} is farther from fp32 than its plain version: {row}")


def rel_diff(a: torch.Tensor, b: torch.Tensor):
    """(max |a - b|, max |b|) in fp32 on b's device."""
    a, b = a.to(b.device).float(), b.float()
    return (a - b).abs().max().item(), b.abs().max().item()


def spread_queries(n: int, frames: int, hw, gen, dev) -> dict:
    """n queries (t, x, y) with every t spread over the video, so that both
    tracking directions run for most of them."""
    t = torch.rand(n, generator=gen, device=dev) * (frames - 1)
    x = 4 + torch.rand(n, generator=gen, device=dev) * (hw[1] - 8)
    y = 4 + torch.rand(n, generator=gen, device=dev) * (hw[0] - 8)
    return {"track_2d_pointquerries_bn3": torch.stack([t, x, y], -1)[None],
            "track_2d_pointlabels_bn": torch.ones((1, n), device=dev)}


def hold_outputs(log, checks, key: str, out: torch.Tensor, ref: torch.Tensor, what: str,
                 pair: str = "kernel path - plain path") -> None:
    """`out` against `ref` (by default the kernel path against the plain
    path): SLICE_TOL, or TRACK_BANDS for the track outputs."""
    diff = (out.float() - ref.float()).abs()
    err, scale = diff.max().item(), ref.float().abs().max().item()
    text = f"{what} {key}: max|{pair}| {err:.4g}"
    if key in TRACK_BANDS:
        band, p99_band = (b * scale for b in TRACK_BANDS[key])
        p99 = diff.flatten().quantile(0.99).item()
        log(f"{text} (band {band:.3g}), median {diff.median().item():.4g}, 99th pct {p99:.4g} "
            f"(band {p99_band:.3g}), output max {scale:.4g}")
        ok = math.isfinite(err) and err <= band and p99 <= p99_band
    else:
        band = SLICE_TOL * scale
        log(f"{text} (band {band:.3g}, output max {scale:.4g})")
        ok = math.isfinite(err) and err <= band
    checks.expect(ok, f"{what} {key}: {pair} differ by {err}")


def run_bench(log, checks, cfg) -> None:
    """Phase 15: the port's bench.py in its own process; its line checked."""
    from l4p_tpu_torch.utils.flops import alltask_video_flops

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "l4p_tpu_torch.bench", "--iters", "3"], capture_output=True,
                          text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    log(f"python3 -m l4p_tpu_torch.bench --iters 3: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    try:
        line = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        checks.expect(False, f"bench printed no JSON line: {proc.stdout[-500:]} {proc.stderr[-1500:]}")
        return
    log(f"bench line: {json.dumps(line)}")
    d = line.get("detail", {})
    want = {"frames", "seconds_per_video", "compile_seconds", "tasks", "device", "model_tflops_per_video", "mfu",
            "encoder_tflops_per_video", "secondary", "card"}
    checks.expect(proc.returncode == 0 and want <= set(d), f"bench failed or lacks keys {want - set(d)}")
    value, mfu = line.get("value", 0.0), d.get("mfu", 0.0)
    checks.expect(math.isfinite(value) and value > 0 and 0 < mfu <= 1.05, f"bench value {value}, mfu {mfu}")
    frames = d.get("frames", 192)
    c = dataclasses.replace(cfg, track=dataclasses.replace(cfg.track, max_queries=128))
    flop = round(alltask_video_flops(c, d.get("tasks", []), frames, 128)["total"] / 1e12, 2)
    checks.expect(d.get("model_tflops_per_video") == flop,
                  f"bench model_tflops_per_video {d.get('model_tflops_per_video')}, the flops module {flop}")
    checks.expect("error" not in d.get("secondary", {"error": "absent"}), f"bench secondary: {d.get('secondary')}")


def bf16_against_fp32(P, model, cfg, dev, log, checks, requests: int = BF16_WINDOWS) -> None:
    """Phase 19: the model end to end in bf16 against fp32. Each of
    `requests` 16-frame windows (its own uint8 video, QUERY_CHUNK queries)
    goes through forward_single_window three times: (a) bf16 with every
    kernel, (b) bf16 on the plain path, (c) fp32 on the plain path with the
    same weights upcast (TF32 off). The camray head is read as camera_rays,
    so its raw ray map is compared; the camera solve of each run's rays is
    printed only, as a bf16 step moves the RANSAC's choice. Per output and
    window, (a) stays within BF16_ENVELOPE of (c) wherever (b) does; over
    the windows, (a)'s mean |error| stays within WITNESS_SLACK of (b)'s."""
    import copy

    from l4p_tpu_torch.models.ingest import IMAGENET_MEAN, IMAGENET_STD
    from l4p_tpu_torch.models.l4p import forward_single_window, window_cameras
    from l4p_tpu_torch.ops.flash_attention import flash_attention_plain

    rays_head = dataclasses.replace(cfg.head_dict["camray"], kind="camera_rays")
    cfg_rays = dataclasses.replace(cfg, heads=tuple((n, rays_head if n == "camray" else h) for n, h in cfg.heads))
    tasks = (*P.DENSE_TASKS, "camray", "track_2d")
    img_info = tuple(cfg.window_size)
    ws, hw = img_info[0], img_info[1:]
    plain = dict(attention=flash_attention_plain, track_kernels=P.PLAIN)
    runs = {"a": (model, {}), "b": (model, plain), "c": (copy.deepcopy(model).float(), plain)}
    mean = torch.tensor(IMAGENET_MEAN, device=dev)[None, :, None, None, None]
    std = torch.tensor(IMAGENET_STD, device=dev)[None, :, None, None, None]
    sums = {}
    for r in range(requests):
        gen = torch.Generator(device=dev).manual_seed(200 + r)
        u8 = torch.randint(0, 256, (1, 3, ws, *hw), generator=gen, device=dev, dtype=torch.uint8)
        data = {"rgb_b3thw": (u8.float() / 255 - mean) / std, **track_queries(QUERY_CHUNK, ws, hw, gen, dev)}
        outs, secs = {}, {}
        for name, (m, kw) in runs.items():
            t0 = time.perf_counter()
            outs[name] = forward_single_window(m, cfg_rays, data, tasks, dev, **kw)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        log(f"bf16 against fp32, window {r} ({ws} frames x {QUERY_CHUNK} queries through forward_single_window): "
            f"(a) bf16 kernels {secs['a']:.4f} s, (b) bf16 plain {secs['b']:.4f} s, (c) fp32 plain {secs['c']:.4f} s")
        ref = outs["c"]
        for key in ref:
            diff = {name: (outs[name][key].float() - ref[key].float()).abs() for name in ("a", "b")}
            top = {name: d.max().item() for name, d in diff.items()}
            scale = ref[key].float().abs().max().item()
            acc = sums.setdefault(key, {"mean a": 0.0, "mean b": 0.0, "max a": 0.0, "max b": 0.0, "scale": 0.0})
            for name in ("a", "b"):
                acc[f"mean {name}"] += diff[name].mean().item() / requests
                acc[f"max {name}"] = max(acc[f"max {name}"], top[name])
            acc["scale"] = max(acc["scale"], scale)
            inside = top["b"] <= BF16_ENVELOPE
            log(f"bf16 against fp32, window {r} {key}: max|(a) - (c)| {top['a']:.4g}, max|(b) - (c)| {top['b']:.4g} "
                f"(the plain bf16 path {'meets' if inside else 'misses'} the {BF16_ENVELOPE} envelope), output max "
                f"{scale:.4g}")
            checks.expect(math.isfinite(top["a"]) and (top["a"] <= BF16_ENVELOPE or not inside),
                          f"bf16 kernel path {key} is {top['a']} from fp32 where the plain bf16 path is within "
                          f"{BF16_ENVELOPE} ({top['b']})")
        for name, out in outs.items():
            pose, k, _ = window_cameras(out[f"{rays_head.task_name}_est_b6thw"].float(), cfg.head_dict["camray"],
                                        img_info, None, 0, 1, None, P.RandomDraws())
            focal = [round(k[0, i, 0].item(), 3) for i in (0, 5)]
            log(f"bf16 against fp32, window {r}, the camera solve of ({name})'s rays: frame-0 pose rows "
                f"{[round(v, 4) for v in pose[0, :12, 0].tolist()]}, fx, fy {focal}, "
                f"finite {bool(torch.isfinite(pose).all() and torch.isfinite(k).all())}")
        del outs, data
    for key, acc in sums.items():
        ratio = acc["mean a"] / max(acc["mean b"], 1e-30)
        log(f"bf16 against fp32 over {requests} windows, {key}: mean|error| (a) bf16 kernels {acc['mean a']:.4g}, "
            f"(b) bf16 plain {acc['mean b']:.4g} (ratio {ratio:.3g}, within {WITNESS_SLACK}); max|error| (a) "
            f"{acc['max a']:.4g}, (b) {acc['max b']:.4g}; output max {acc['scale']:.4g}")
        checks.expect(math.isfinite(ratio) and ratio <= WITNESS_SLACK,
                      f"bf16 kernel path {key} is farther from fp32 than the plain bf16 path: {acc}")
    del runs
    torch.cuda.empty_cache()


def run_sequence_phase(P, model, cfg, dev, log, checks, reset_counts, counts, expected) -> None:
    """Phase 20: run_sequence on bench.py's request (TRACK_FRAMES frames,
    QUERY_CHUNK queries, five tasks; numpy on the host, as a collated batch
    is) with write_artifacts=False, offline in turns with the session on the
    same request already on the card, then streamed: each kernel's launches
    against the session's formula, the streamed outputs against the offline
    ones by phase 18's rules, the wall times."""
    from l4p_tpu_torch.bench import bench_request
    from l4p_tpu_torch.inference import run_sequence
    from l4p_tpu_torch.models.l4p import num_windows

    n_q, hw = QUERY_CHUNK, tuple(cfg.window_size[1:])
    batch = bench_request(cfg, P.ALL_TASKS, TRACK_FRAMES, n_q)
    data = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    sess = P.InferenceSession(cfg, P.ALL_TASKS, dev)
    run_sequence(model, cfg, P.ALL_TASKS, batch, "", "warm-up", device=dev, write_artifacts=False)
    times, outs = {"session": [], "run_sequence": []}, {}
    for which in ("session", "run_sequence", "run_sequence", "session"):
        reset_counts()
        t0 = time.perf_counter()
        if which == "session":
            sess(model, data)
            torch.cuda.synchronize()
        else:  # returns numpy arrays: ends on the host
            outs["offline"] = run_sequence(model, cfg, P.ALL_TASKS, batch, "", "bench request", device=dev,
                                           write_artifacts=False)
        times[which].append(time.perf_counter() - t0)
        got, want = counts(), expected(n_q, False)
        checks.expect(got == want, f"{which} launches {got} on bench.py's request, expected {want}")
    reset_counts()
    t0 = time.perf_counter()
    outs["streamed"] = run_sequence(model, cfg, P.ALL_TASKS, batch, "", "bench request", device=dev,
                                    write_artifacts=False, stream=True)
    stream_s = time.perf_counter() - t0
    got = counts()
    want = {**expected(n_q, False), "flash_attention": cfg.encoder.depth * num_windows(cfg, TRACK_FRAMES)}
    checks.expect(got == want, f"streamed run_sequence launches {got}, expected {want}")
    log(f"run_sequence on bench.py's request ({TRACK_FRAMES} frames x {n_q} queries, five tasks), in turns with the "
        f"session: session {', '.join(f'{t:.4f}' for t in times['session'])} s, run_sequence offline "
        f"{', '.join(f'{t:.4f}' for t in times['run_sequence'])} s; run_sequence streamed {stream_s:.4f} s "
        f"(launches {got})")
    outs = {name: {k: torch.from_numpy(v) for k, v in out.items()} for name, out in outs.items()}
    for out in outs.values():
        check_outputs(out, {**DENSE_KEYS, **TRACK_KEYS, **CAMRAY_KEYS}, TRACK_FRAMES, hw, checks,
                      data["track_2d_pointquerries_bn3"].cpu())
    for key, ref in outs["offline"].items():
        got_t = outs["streamed"][key]
        if key in ("depth_est_b1thw", *CAMRAY_KEYS):
            # the RANSACs pick among hypotheses by inlier counts, which a bf16 step can change (phase 12)
            err, scale = rel_diff(got_t, ref)
            log(f"run_sequence streamed {key} (joint Sim(3) chain) against offline: max|diff| {err:.4g} = "
                f"{err / max(scale, 1e-30):.3g} x max|offline|, both finite: {bool(torch.isfinite(ref).all())}")
            checks.expect(bool(torch.isfinite(ref).all()), f"offline run_sequence {key} is not finite")
        else:
            hold_outputs(log, checks, key, got_t, ref, "run_sequence", "streamed - offline")


def ply_vertices(path: str) -> int:
    """A binary PLY's vertex count, checked against its size (float xyz and,
    when declared, uchar rgb per vertex)."""
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode().splitlines()
    n = int(next(ln for ln in header if ln.startswith("element vertex")).split()[-1])
    if len(raw) - end != n * (15 if "property uchar red" in header else 12):
        raise ValueError(f"{path}: {len(raw) - end} bytes of data for {n} vertices")
    return n


def pipeline_phase(P, model, cfg, dev, log, checks) -> None:
    """Phase 21: the data pipeline and the writers that need no cv2. Seeded
    uint8 frames at DAVIS's 480 x 854 through an in-memory L4PDataset (the
    short side resized to the model's 224, the centre cropped to 224 x 224,
    128 random queries, collate), then
    run_sequence on the card; the point maps on the card against the CPU
    (POINT_MAP_TOL); the point-cloud, camera and 3D-track PLYs written to a
    temporary directory, their vertex counts checked; `panel_frames` for
    flow, depth and dyn_mask. The track panel and the mp4 need cv2, which
    this machine may lack: they are never called here."""
    import tempfile

    import numpy as np

    from l4p_tpu_torch.data.dataset import L4PData, L4PDataset, collate
    from l4p_tpu_torch.geometry.core import generate_3d_track_point_map, generate_point_map
    from l4p_tpu_torch.inference import run_sequence
    from l4p_tpu_torch.utils import vis

    class Frames(L4PDataset):
        """One video (3, T, H, W) in [0, 1] with a source's dummy K."""

        def __init__(self, rgb, **kw):
            super().__init__(**kw)
            self.rgb = rgb

        def __len__(self):
            return 1

        def getitem_helper(self, index):
            _, t, h, w = self.rgb.shape
            k = np.array([[min(h, w), 0, w / 2, 0], [0, min(h, w), h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
            return L4PData(rgb_b3thw=self.rgb, intrinsics_b44t=np.tile(k[:, :, None], (1, 1, t)), seq_name="frames")

    rng = np.random.default_rng(21)
    u8 = rng.integers(0, 256, (3, PIPELINE_FRAMES, *DAVIS_HW), dtype=np.uint8)
    hw = tuple(cfg.window_size[1:])
    # the short side resized to the model's, then the centre cropped to its square
    resized = (hw[0], round(DAVIS_HW[1] * hw[0] / DAVIS_HW[0]))
    t0 = time.perf_counter()
    batch = collate(Frames(u8.astype(np.float32) / 255, resize_size=resized, crop_size=(PIPELINE_FRAMES, *hw),
                           center_crop=True, rng=np.random.default_rng(0))[0])
    prep_s = time.perf_counter() - t0
    checks.expect(batch["rgb_u8_bthw3"].shape == (1, PIPELINE_FRAMES, *hw, 3)
                  and batch["track_2d_pointquerries_bn3"].shape == (1, 128, 3),
                  f"the pipeline's batch: frames {batch['rgb_u8_bthw3'].shape}, queries "
                  f"{batch['track_2d_pointquerries_bn3'].shape}")
    t0 = time.perf_counter()
    out = run_sequence(model, cfg, P.ALL_TASKS, batch, "", "frames", device=dev, write_artifacts=False)
    run_s = time.perf_counter() - t0
    check_outputs({k: torch.from_numpy(v) for k, v in out.items()}, {**DENSE_KEYS, **TRACK_KEYS, **CAMRAY_KEYS},
                  PIPELINE_FRAMES, hw, checks, torch.from_numpy(batch["track_2d_pointquerries_bn3"]))
    t = PIPELINE_FRAMES
    cams = [torch.from_numpy(out[k]).reshape(1, 4, 4, t) for k in ("traj3d_intrinsics_est_b16t", "traj3d_est_b16t")]
    maps = {"generate_point_map": (generate_point_map, (torch.from_numpy(out["depth_est_b1thw"]), *cams)),
            "generate_3d_track_point_map": (generate_3d_track_point_map,
                                            (torch.from_numpy(out["track_2d_traj_est_bn2t"]),
                                             torch.from_numpy(out["track_2d_depth_est_bn1t"]), *cams))}
    for name, (fn, args) in maps.items():
        err, scale = rel_diff(fn(*(a.to(dev) for a in args)), fn(*args))
        log(f"{name} on the card against the CPU: max|diff| {err:.4g} = {err / max(scale, 1e-30):.3g} x max|CPU| "
            f"(tolerance {POINT_MAP_TOL})")
        checks.expect(math.isfinite(err) and err <= POINT_MAP_TOL * scale, f"{name} card against CPU: {err}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        clouds = vis.generate_4d_visualization(batch, out, tmp, stride=4, device=dev)
        cameras = vis.generate_camera_trajectory_ply(out, f"{tmp}/cameras.ply", hw)
        tracks = vis.generate_3d_track_ply(batch, out, tmp, device=dev)
        ply_s = time.perf_counter() - t0
        depth = out["depth_est_b1thw"][0, 0]
        want = [int(((depth[i] > 0.05) & (depth[i] < 20.0)).sum()) for i in range(0, t, 4)]
        want_tracks = [int((out["track_2d_vis_est_bn1t"][0, :, 0, i] > 0).sum()) for i in range(t)]
        got = ([ply_vertices(p) for p in clouds], ply_vertices(cameras), [ply_vertices(p) for p in tracks])
        log(f"PLYs: {len(clouds)} point clouds ({got[0]} vertices), cameras ({got[1]}), {len(tracks)} track frames "
            f"({sum(got[2])} vertices in all) in {ply_s:.3f} s")
        checks.expect(got == (want, t * (1 + 8 * 12), want_tracks),
                      f"PLY vertex counts {got}, expected {(want, t * 97, want_tracks)}")
    t0 = time.perf_counter()
    frames = vis.panel_frames(batch, out, ("flow_2d_backward", "depth", "dyn_mask"))
    panel_s = time.perf_counter() - t0
    checks.expect(frames.shape == (t, hw[0], 4 * hw[1], 3) and frames.dtype == np.uint8,
                  f"panel frames {frames.shape} {frames.dtype}")
    log(f"data pipeline: {PIPELINE_FRAMES} frames of {DAVIS_HW} (resized to {resized}, cropped to {hw}) to a batch "
        f"in {prep_s:.3f} s (host), run_sequence "
        f"{run_s:.4f} s, panel frames {frames.shape} in {panel_s:.3f} s (host)")


def tools_phase(log, checks) -> None:
    """Phase 22: `python3 -m l4p_tpu_torch.stream_bench --windows 8` in its
    own process (its line checked), then the native preprocessing library
    built with g++ and each entry point held against its numpy version at
    DAVIS's frame size."""
    import numpy as np

    from l4p_tpu_torch.native import lib as NL

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "l4p_tpu_torch.stream_bench", "--windows", "8"], capture_output=True,
                          text=True, timeout=600)
    log(f"python3 -m l4p_tpu_torch.stream_bench --windows 8: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        line = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        checks.expect(False, f"stream_bench printed no JSON line: {proc.stdout[-500:]} {proc.stderr[-1500:]}")
        line = None
    if line is not None:
        log(f"stream_bench line: {json.dumps(line)}")
        want = {"metric", "value", "unit", "sustained_input_fps", "latency_frames", "compile_s", "device", "card"}
        numbers = [line.get("value"), line.get("sustained_input_fps"), *line.get("compile_s", {}).values()]
        checks.expect(proc.returncode == 0 and want <= set(line),
                      f"stream_bench failed or lacks keys {want - set(line)}")
        checks.expect(all(isinstance(x, float) and math.isfinite(x) and x > 0 for x in numbers),
                      f"stream_bench numbers {numbers}")
    t0 = time.perf_counter()
    NL.build()
    log(f"native preprocessing library built with g++ in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(22)
    frames = rng.integers(0, 256, (PIPELINE_FRAMES, *DAVIS_HW, 3), dtype=np.uint8)
    planes = rng.standard_normal((3 * PIPELINE_FRAMES, *DAVIS_HW)).astype(np.float32)
    video = rng.standard_normal((3, PIPELINE_FRAMES, 224, 224)).astype(np.float32)
    mean, std = np.array([0.485, 0.456, 0.406], np.float32), np.array([0.229, 0.224, 0.225], np.float32)
    # normalize as tests/test_native.py; bilinear: the same float32 positions, products fused or not by g++
    cases = {"normalize_video": ((frames, mean, std), 1e-5), "resize_planes bilinear": ((planes, (224, 224)), 1e-5),
             "resize_planes nearest": ((planes, (224, 224), "nearest"), 0.0), "mirror_pad_time": ((video,), 0.0)}
    for name, (args, tol) in cases.items():
        fn = name.split()[0]
        times = {}
        for which in ("", "_plain"):
            t0 = time.perf_counter()
            times[which] = (getattr(NL, fn + which)(*args), time.perf_counter() - t0)
        got, ref = times[""][0], times["_plain"][0]
        ok = got.shape == ref.shape and bool(np.all(np.abs(got - ref) <= tol + tol * np.abs(ref)))
        log(f"native {name} {args[0].shape}: max|native - numpy| {float(np.abs(got - ref).max()):.3g} (tolerance "
            f"{tol} absolute + relative); native {times[''][1] * 1e3:.1f} ms, numpy {times['_plain'][1] * 1e3:.1f} ms "
            f"(host)")
        checks.expect(ok, f"native {name} disagrees with its numpy version")


def eval_phase(P, model, cfg, dev, log, checks, reset_counts, counts) -> None:
    """Phase 23: the five eval configs of l4p_tpu_torch.eval_protocol on the
    giant model, each a warm-up and REPEATS timed requests of its synthetic
    batch (QUERY_CHUNK queries) with the counts checked, then the plain
    path, and for the tracks each path with its attention in fp32; the
    metrics on the card against the CPU's from the same outputs."""
    from l4p_tpu_torch import eval_protocol as EP
    from l4p_tpu_torch.metrics import l4p_metrics
    from l4p_tpu_torch.models.l4p import num_windows
    from l4p_tpu_torch.ops import flash_attention as FA

    hw = tuple(cfg.window_size[1:])
    witness = {}  # the track witness's further batches, by frame count: the track configs share them
    for name, tasks, extra in EP.CONFIGS:
        frames = EP.config_frames(cfg, extra)
        batch = EP.synthetic_batch(frames, *hw, n_queries=QUERY_CHUNK, tasks=tasks)
        nw = num_windows(cfg, frames)
        per_request = {"flash_attention": cfg.encoder.depth * math.ceil(nw / cfg.enc_window_chunk),
                       "t2i_flash": 0, "i2t_ln_t2i": 0, "fused_upscale_hypernet": 0, "fused_encoder_blocks": 0}
        if "track_2d" in tasks:
            per_request.update(t2i_flash=nw, i2t_ln_t2i=2 * nw, fused_upscale_hypernet=nw)  # one chunk of 128
        reset_counts()
        data, out, metrics = EP.run_config(model, cfg, name, tasks, batch, dev, iters=REPEATS)
        got = counts()
        want = {k: (REPEATS + 1) * c for k, c in per_request.items()}
        checks.expect(got == want, f"eval {name}: launches {got}, expected {want}")
        seconds = metrics.pop("seconds")
        keys = {**({k: c for k, c in DENSE_KEYS.items() if k.split("_est")[0] in tasks}),
                **(TRACK_KEYS if "track_2d" in tasks else {}), **(CAMRAY_KEYS if "camray" in tasks else {})}
        check_outputs(out, keys, frames, hw, checks, data.get("track_2d_pointquerries_bn3"))
        log(f"eval {name} ({frames} frames, tasks {list(tasks)}, {nw} windows, launches a request {per_request}): "
            f"{seconds:.4f} s = {frames / seconds:.2f} frames/s (mean of {REPEATS} after a warm-up)")
        cpu, _ = l4p_metrics({k: v.cpu() for k, v in data.items()}, {k: v.cpu() for k, v in out.items()})
        checks.expect(set(cpu) == set(metrics) and len(metrics) > 0, f"eval {name}: metrics {sorted(metrics)}")
        worst = 0.0
        for k, v in metrics.items():
            c = cpu[k].item()
            err = abs(v - c) / (1 + abs(c))
            worst = max(worst, err)
            checks.expect(math.isfinite(v) and err <= EVAL_METRIC_TOL, f"eval {name} {k}: card {v}, CPU {c}")
        log(f"eval {name} metrics on the card: {json.dumps({k: round(v, 6) for k, v in metrics.items()})}; "
            f"largest |card - CPU| / (1 + |CPU|) {worst:.3g} (band {EVAL_METRIC_TOL})")
        before = counts()
        run_cfg = EP.config_for(cfg, name)
        ref = P.InferenceSession(run_cfg, tasks, dev, attention=FA.flash_attention_plain,
                                 track_kernels=P.PLAIN)(model, data)
        torch.cuda.synchronize()
        checks.expect(counts() == before, f"eval {name}: the plain path launched a kernel")
        if "track_2d" in tasks:
            # each track kernel call of the request held on its own operands; the request served again
            held = HeldTrackKernels(P.KERNELS, P.PLAIN)
            again = P.InferenceSession(run_cfg, tasks, dev, track_kernels=held.kernels)(model, data)
            track_kernels = ("t2i_flash", "i2t_ln_t2i", "fused_upscale_hypernet")
            held.check(f"eval {name}", {k: per_request[k] for k in track_kernels}, log, checks)
            checks.expect(all(torch.equal(again[k], out[k]) for k in TRACK_KEYS),
                          f"eval {name}: the held request's tracks differ from the kernel path's")
            # the kernel attention with the plain track kernels: the paths differ only in the track kernels
            attn_k = P.InferenceSession(run_cfg, tasks, dev, track_kernels=P.PLAIN)(model, data)
            # each path against itself with the attention in fp32 (phase 9's witness)
            fp32 = {path: P.InferenceSession(run_cfg, tasks, dev, attention=fp32_attention, **kw)(model, data)
                    for path, kw in (("kernel", {}), ("plain", {"track_kernels": P.PLAIN}))}
            del again, held
            if frames not in witness:
                witness[frames] = eval_track_witness(P, model, run_cfg, frames, dev, range(1, WITNESS_REQUESTS), log)
        for key, r in ref.items():
            if key in TRACK_KEYS:
                kernel, plain = spread(out[key], fp32["kernel"][key]), spread(r, fp32["plain"][key])
                both, track = spread(out[key], r), spread(out[key], attn_k[key])
                log(f"eval {name} {key}, (max, 99th pct) / output max {r.float().abs().max().item():.4g}: kernel "
                    f"path - plain path ({both[0]:.3g}, {both[1]:.3g}) (TRACK_BANDS {TRACK_BANDS[key]}); kernel "
                    f"path - plain track kernels ({track[0]:.3g}, {track[1]:.3g}); against its fp32-attention "
                    f"run, kernel path ({kernel[0]:.3g}, {kernel[1]:.3g}), plain path ({plain[0]:.3g}, "
                    f"{plain[1]:.3g})")
                # phase 9's witness on this batch and the further ones: mean 99th percentiles
                rows = {what: [got[1]] + [p99 for _, p99 in witness[frames][key][what]]
                        for what, got in (("kernel", kernel), ("plain", plain), ("track", track))}
                mean = {what: sum(v) / len(v) for what, v in rows.items()}
                log(f"eval {name} {key} over {WITNESS_REQUESTS} batches: mean 99th pct / output max, kernel path "
                    f"against its fp32-attention run {mean['kernel']:.3g}, against the plain track kernels "
                    f"{mean['track']:.3g}, plain path against its fp32-attention run {mean['plain']:.3g} (ratios "
                    f"{mean['kernel'] / mean['plain']:.3g}, {mean['track'] / mean['plain']:.3g}, within "
                    f"{WITNESS_SLACK})")
                checks.expect(math.isfinite(both[0]) and mean["kernel"] <= WITNESS_SLACK * mean["plain"],
                              f"eval {name} {key}: the kernel path is farther from its fp32-attention run than the "
                              f"plain path: {mean}")
                checks.expect(math.isfinite(track[0]) and mean["track"] <= WITNESS_SLACK * mean["plain"],
                              f"eval {name} {key}: the track kernels move the tracks farther than the plain "
                              f"path's attention precision does: {mean}")
            elif "camray" in tasks and key in ("depth_est_b1thw", *CAMRAY_KEYS):
                # the RANSACs pick among hypotheses by inlier counts, which a bf16 step can change (phase 12)
                err, scale = rel_diff(out[key], r)
                log(f"eval {name} {key} (joint Sim(3) chain): max|kernel path - plain path| {err:.4g} = "
                    f"{err / max(scale, 1e-30):.3g} x max|plain|, both finite: {bool(torch.isfinite(r).all())}")
                checks.expect(bool(torch.isfinite(r).all()), f"eval {name}: plain-path {key} is not finite")
            else:
                hold_outputs(log, checks, key, out[key], r, f"eval {name}")
        del data, out, ref


def options_phase(P, cfg, video, dev, log, checks, reset_counts, counts, default_model) -> None:
    """Phase 24: the giant encoder with the option branches in two models,
    (a) cosine attention + LayerScale 0.1 + learnable positions + the
    camera embedding at the input, added, and (b) the embedding on the
    outputs, concatenated; the dense tasks at 48 frames with bench.py's
    intrinsics and the eval protocol's trajectory as extrinsics, timed in
    turns with the default encoder, launch counts checked, each held
    against its plain path; fused_encoder with cos_attn refused."""
    from l4p_tpu_torch.eval_protocol import synthetic_extrinsics
    from l4p_tpu_torch.models.l4p import num_windows
    from l4p_tpu_torch.ops import flash_attention as FA

    frames = video.shape[1]
    hw = tuple(cfg.window_size[1:])
    nw = num_windows(cfg, frames)
    request = {"rgb_u8_bthw3": video, "intrinsics_b44t": bench_intrinsics(frames, hw, dev),
               "extrinsics_b44t": torch.as_tensor(synthetic_extrinsics(frames), device=dev)}
    options = {"(a) cos_attn + init_values 0.1 + learnable positions + input/add embedding": dict(
                   cos_attn=True, init_values=0.1, use_learnable_pos_emb=True, cam_emb_placed_at="input",
                   cam_emb_type="add"),
               "(b) output/concat embedding": dict(cam_emb_placed_at="output", cam_emb_type="concat")}
    models = {"default encoder": (cfg, default_model)}
    for label, enc in options.items():
        c = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, **enc))
        m = P.L4P(c, device=dev, dtype=torch.bfloat16).eval()
        m.init_weights(torch.Generator(device=dev).manual_seed(24))
        models[label] = (c, m)
    sessions = {label: P.InferenceSession(c, P.DENSE_TASKS, dev) for label, (c, _) in models.items()}
    for label, sess in sessions.items():
        sess(models[label][1], request)  # warm-up
    want = cfg.encoder.depth * math.ceil(nw / cfg.enc_window_chunk)
    times = {label: [] for label in sessions}
    outs = {}
    order = list(sessions) + list(reversed(sessions))
    for label in order * 2:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[label] = sessions[label](models[label][1], request)
        torch.cuda.synchronize()
        times[label].append(time.perf_counter() - t0)
        got = counts()
        checks.expect(got["flash_attention"] == want and sum(got.values()) == want,
                      f"{label}: launches {got}, expected {want} attention launches")
    for label, ts in times.items():
        log(f"dense request {frames} frames, {label} ({nw} windows, {want} attention launches): "
            f"{', '.join(f'{t:.4f}' for t in ts)} s (in turns); best {min(ts):.4f} s = {frames / min(ts):.2f} frames/s")
    for label, (c, m) in models.items():
        if label == "default encoder":
            continue
        check_outputs(outs[label], DENSE_KEYS, frames, hw, checks)
        ref = P.InferenceSession(c, P.DENSE_TASKS, dev, attention=FA.flash_attention_plain)(m, request)
        for key, r in ref.items():
            hold_outputs(log, checks, key, outs[label][key], r, f"options {label}")
        del ref
    c_a, m_a = models[next(iter(options))]
    fused = dataclasses.replace(c_a, encoder=dataclasses.replace(c_a.encoder, fused_encoder=True))
    try:
        P.InferenceSession(fused, P.DENSE_TASKS, dev)(m_a, request)
        checks.expect(False, "fused_encoder with cos_attn was not refused")
    except ValueError as e:
        log(f"fused_encoder with cos_attn and LayerScale refused: {e}")
        checks.expect("cos_attn" in str(e), f"fused_encoder's refusal does not name cos_attn: {e}")
    del models, sessions, outs


def grad_of_fit(outs, leaves):
    """The gradients of sum_i 0.5 |outs_i A_i - t_i|^2 (in fp32) for `leaves`,
    None where an output does not depend on a leaf: A_i (last dim, last dim)
    and t_i N(0, 1) from fixed seeds, the same on every path, as a head
    reads the outputs. A loss on the outputs themselves measures noise: the
    exact gradient of 0.5 |LayerNorm(x)|^2 is 0, and a bf16 backward
    cancels it only for the forward output it recomputes (the plain path's,
    not the kernel's)."""
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = 0
    for i, o in enumerate(outs):
        gen = torch.Generator(device=o.device).manual_seed(i)
        c = o.shape[-1]
        mix = torch.randn((c, c), generator=gen, device=o.device) / math.sqrt(c)
        target = torch.randn(o.shape, generator=gen, device=o.device)
        loss = loss + 0.5 * (o.float() @ mix - target).square().sum()
    return torch.autograd.grad(loss, leaves, allow_unused=True)


def grad_gap(grads, ref):
    """|grads - ref| over all their entries together, None counting as 0:
    (the L2 norm of the difference over ref's, the L1 norm over ref's).
    Summed over entries, so a gradient that is 0 in exact arithmetic (the
    two-way transformer's k biases, whose softmax shift drops out) weighs
    as little as its size."""
    l2 = l1 = r2 = r1 = 0.0
    for g, r in zip(grads, ref):
        if r is None:
            continue
        r = r.float()
        d = r if g is None else g.float() - r
        l2, l1 = l2 + d.square().sum().item(), l1 + d.abs().sum().item()
        r2, r1 = r2 + r.square().sum().item(), r1 + r.abs().sum().item()
    return math.sqrt(l2 / r2), l1 / r1


def hold_function_grads(name, function, run, log, checks) -> None:
    """Phase 25 (a): run(path) -> (outputs, leaves) for path 'kernel',
    'plain' and 'fp32' (the plain path on fp32 copies of the same values);
    the kernel path's outputs must hang off `function`'s node and have a
    gradient wherever the plain path's have one."""
    grads = {}
    for path in ("kernel", "plain", "fp32"):
        outs, leaves = run(path)
        if path == "kernel":
            nodes = {type(o.grad_fn).__name__ for o in (outs if isinstance(outs, tuple) else (outs,))}
            checks.expect(nodes == {function._backward_cls.__name__},
                          f"training {name}: the kernel path's outputs hang off {nodes}, not {function.__name__}")
            if None in {o.grad_fn for o in (outs if isinstance(outs, tuple) else (outs,))}:
                return
        grads[path] = grad_of_fit(outs, leaves)
        del outs, leaves
    torch.cuda.synchronize()
    band, _ = grad_gap(grads["kernel"], grads["plain"])
    _, kernel_off = grad_gap(grads["kernel"], grads["fp32"])
    _, plain_off = grad_gap(grads["plain"], grads["fp32"])
    ratio = kernel_off / plain_off if plain_off else (math.inf if kernel_off else 1.0)
    log(f"training {name}: {len(grads['kernel'])} gradients of 0.5|out A - target|^2, |kernel path - plain path| / "
        f"|plain| "
        f"(L2 over all) {band:.3g} (band {FUNCTION_GRAD_BAND}); L1 distance to the fp32 plain path over its L1: "
        f"kernel {kernel_off:.4g}, plain {plain_off:.4g} (ratio {ratio:.3g}, within {GRAD_WITNESS_SLACK})")
    checks.expect([g is None for g in grads["kernel"]] == [g is None for g in grads["plain"]],
                  f"training {name}: the kernel path has gradients where the plain path has none or the reverse")
    checks.expect(math.isfinite(band) and band <= FUNCTION_GRAD_BAND,
                  f"training {name}: kernel-path gradients differ from the plain path's by {band}")
    checks.expect(math.isfinite(ratio) and ratio <= GRAD_WITNESS_SLACK,
                  f"training {name}: kernel-path gradients farther from fp32 than the plain path's: {ratio}")


def function_cases(P, model, cfg, gen):
    """Phase 25 (a)'s four Functions, each run(path) on a training step's
    operands at the model's widths (one window, GRADIENT_QUERIES queries):
    the model's weights, bf16 operands from `gen`."""
    import copy

    from l4p_tpu_torch.models import sam as PS
    from l4p_tpu_torch.ops import flash_attention as FA
    from l4p_tpu_torch.ops import fused_encoder as FE
    from l4p_tpu_torch.ops import fused_upscale as FU

    n, ecfg, sam = GRADIENT_QUERIES, cfg.encoder, cfg.track.sam
    p, c, e = sam.num_video_tokens, sam.embed_dim, ecfg.embed_dim

    def leaves(tensors, path):
        return [t.detach().to(torch.float32 if path == "fp32" else t.dtype).requires_grad_() for t in tensors]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).bfloat16()

    qkv = [rnd(1, ecfg.num_heads, ecfg.num_tokens, ecfg.head_dim) for _ in range(3)]

    def attention(path):
        xs = leaves(qkv, path)
        fn = FA.flash_attention if path == "kernel" else FA.flash_attention_plain
        return fn(*xs, ecfg.head_dim ** -0.5), xs

    up = upscale_operands(n, p, c, *sam.decode_dims, cfg.track.num_mask_tokens, gen)

    def upscale(path):
        xs = leaves(up, path)
        fn = FU.fused_upscale_hypernet if path == "kernel" else FU.fused_upscale_hypernet_plain
        return fn(*xs), xs

    head = model.task_heads["track_2d"]
    tf = head.mask_decoder.transformer
    tf32 = copy.deepcopy(tf).float()
    pe = PS.dense_pe(head.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix, sam)
    pe = pe.reshape(1, c, -1).transpose(1, 2)[0].bfloat16()
    tokens = cfg.track.num_mask_tokens + cfg.track.num_prompt_points + int(cfg.track.prompt_using_features)
    two_way = (rnd(n, tokens, c), rnd(n, p, c), pe)

    def transformer(path):
        q, k, pe_ = leaves(two_way, path)
        module = tf32 if path == "fp32" else tf
        out = PS.twoway_streamed(module, sam, q, k, q, pe_, PS.KERNELS if path == "kernel" else PS.PLAIN)
        return out, [q, k, pe_, *module.parameters()]

    blocks = model.video_encoder.blocks
    blocks32 = copy.deepcopy(blocks).float()
    x = rnd(1, ecfg.num_tokens, e)
    ends = tuple(sorted({h for h in cfg.all_hooks if h > 0} | {ecfg.depth}))

    def encoder(path):
        (x_,) = leaves([x], path)
        module = blocks32 if path == "fp32" else blocks
        fn = FE.fused_encoder_blocks if path == "kernel" else FE.fused_encoder_blocks_plain
        return fn(module, x_, ecfg, ends), [x_, *module.parameters()]

    return {f"flash_attention {tuple(qkv[0].shape)}": (FA.FlashAttentionFunction, attention),
            f"fused_upscale_hypernet src {tuple(up[0].shape)}": (FU.FusedUpscaleFunction, upscale),
            f"two-way transformer ({n} queries, keys {tuple(two_way[1].shape)})": (PS.TwoWayStreamedFunction,
                                                                                  transformer),
            f"fused_encoder_blocks x {tuple(x.shape)}, {ecfg.depth} blocks": (FE.FusedEncoderFunction, encoder)}


def giant_train_batch(cfg, n: int, seed: int, dev) -> dict:
    """scripts/train_step_tpu.py's synthetic single-window batch with n
    queries, from default_rng(seed), on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t, h, w = cfg.window_size
    k = np.tile(np.diag([224.0, 224.0, 1, 1]).astype(np.float32)[None, :, :, None], (1, 1, 1, t))
    k[:, 0, 2] = k[:, 1, 2] = 112.0
    batch = {
        "rgb_b3thw": rng.standard_normal((1, 3, t, h, w)).astype(np.float32),
        "intrinsics_b44t": k,
        "extrinsics_b44t": np.tile(np.eye(4, dtype=np.float32)[None, :, :, None], (1, 1, 1, t)),
        "depth_b1thw": rng.uniform(1, 5, (1, 1, t, h, w)).astype(np.float32),
        "flow_2d_backward_b2thw": rng.standard_normal((1, 2, t, h, w)).astype(np.float32),
        "dyn_mask_b1thw": (rng.uniform(size=(1, 1, t, h, w)) > 0.5).astype(np.float32),
        "track_2d_pointquerries_bn3": np.stack([rng.uniform(0, t, (1, n)), rng.uniform(8, w - 8, (1, n)),
                                                rng.uniform(8, h - 8, (1, n))], -1).astype(np.float32),
        "track_2d_pointlabels_bn": np.ones((1, n), np.float32),
        "track_2d_traj_bn2t": rng.uniform(0, w, (1, n, 2, t)).astype(np.float32),
        "track_2d_vis_bn1t": np.ones((1, n, 1, t), np.float32),
        "track_2d_depth_bn1t": rng.uniform(1, 5, (1, n, 1, t)).astype(np.float32),
        "track_2d_valid_bn1t": np.ones((1, n, 1, t), np.float32),
    }
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def training_phase(P, model, cfg, dev, log, checks, reset_counts, counts) -> None:
    """Phase 25: training at the giant model's width (the module docstring
    says what each part holds). Trains `model` in place."""
    import tempfile

    from l4p_tpu_torch import train as T
    from l4p_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(25)
    # (a) each Function's gradients
    for name, (function, run) in function_cases(P, model, cfg, gen).items():
        hold_function_grads(name, function, run, log, checks)
        torch.cuda.empty_cache()
    # (b) the first step's gradients, kernel path against plain path; then three steps
    tasks = P.ALL_TASKS
    n = GRADIENT_QUERIES
    batches = [giant_train_batch(cfg, n, seed, dev) for seed in range(3)]
    names, params = zip(*model.named_parameters())
    per_step = {"flash_attention": cfg.encoder.depth, "t2i_flash": 1, "i2t_ln_t2i": 2, "fused_upscale_hypernet": 1,
                "fused_encoder_blocks": 0}
    grads = {}
    for path, kw in (("kernel", {}), ("plain", dict(attention=FA.flash_attention_plain, track_kernels=P.PLAIN))):
        reset_counts()
        loss, losses = T.l4p_loss(model, cfg, batches[0], tasks, **kw)
        grads[path] = torch.autograd.grad(loss, params, allow_unused=True)
        got = counts()
        want = per_step if path == "kernel" else {k: 0 for k in per_step}
        checks.expect(got == want, f"training {path} path: launches {got}, expected {want}")
        log(f"training first step, {path} path: loss {loss.item():.6g} "
            f"({', '.join(f'{k} {v.item():.5g}' for k, v in losses.items())})")
        del loss, losses
        torch.cuda.empty_cache()
    rel = sorted((((gp.float() if gk is None else gk.float() - gp.float()).abs().max()
                   / gp.float().abs().max()).item(), nm)
                 for nm, gk, gp in zip(names, *grads.values()) if gp is not None and gp.abs().max() > 0)
    l2, _ = grad_gap(grads["kernel"], grads["plain"])
    median = rel[len(rel) // 2][0]
    log(f"training first step's gradients, kernel path against plain path over {len(rel)} parameters: "
        f"max|kernel - plain| / max|plain| median {median:.3g} (band {STEP_GRAD_BAND}), largest "
        f"{', '.join(f'{nm} {r:.3g}' for r, nm in rel[-3:])}; relative L2 over all {l2:.3g} (band {STEP_GRAD_L2})")
    checks.expect(math.isfinite(l2) and l2 <= STEP_GRAD_L2 and median <= STEP_GRAD_BAND,
                  f"training: the first step's gradients differ from the plain path's (L2 {l2}, median {median})")
    kernel = dict(zip(names, grads["kernel"]))
    dead = [i for i in range(cfg.encoder.depth)
            if kernel[f"video_encoder.blocks.{i}.attn.qkv.weight"] is None
            or not kernel[f"video_encoder.blocks.{i}.attn.qkv.weight"].abs().max() > 0]
    checks.expect(not dead, f"training: blocks {dead} got no qkv.weight gradient on the kernel path")
    log(f"training: every one of the {cfg.encoder.depth} blocks' qkv.weight has a non-zero gradient: {not dead}")
    del grads, kernel
    torch.cuda.empty_cache()

    def steps(label, run_cfg, count, optimizer, want):
        times = []
        for i in range(count):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, losses = T.train_step(model, optimizer, batches[i % len(batches)], run_cfg, tasks)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            checks.expect(math.isfinite(loss.item()), f"training {label} step {i}: loss {loss.item()}")
            checks.expect(counts() == want, f"training {label} step {i}: launches {counts()}, expected {want}")
            log(f"training {label} step {i}: loss {loss.item():.6g} "
                f"({', '.join(f'{k} {v.item():.5g}' for k, v in losses.items())}), {times[-1]:.1f} ms")
        return times

    torch.cuda.reset_peak_memory_stats()
    # the trainer's defaults: peak 1e-4 after a 1000-step warm-up from 4e-6
    optimizer = T.make_optimizer(model, lr=1e-4, total_steps=10000, mask=T.trainable_mask(model, cfg))
    full = steps("full", cfg, 3, optimizer, per_step)
    peak_full = torch.cuda.max_memory_allocated() / 2 ** 30
    # (c) the fused encoder, then the frozen encoder
    cfg_f = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, fused_encoder=True))
    fused = steps("fused encoder", cfg_f, 1, optimizer,
                  {**per_step, "flash_attention": 0, "fused_encoder_blocks": 1})
    del optimizer
    torch.cuda.empty_cache()
    cfg_z = dataclasses.replace(cfg, freeze_video_encoder=True)
    encoder_before = {k: v.clone() for k, v in model.video_encoder.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    optimizer = T.make_optimizer(model, lr=1e-4, total_steps=10000, mask=T.trainable_mask(model, cfg_z))
    frozen = steps("frozen encoder", cfg_z, 3, optimizer, per_step)
    peak_frozen = torch.cuda.max_memory_allocated() / 2 ** 30
    same = all(torch.equal(v, encoder_before[k]) for k, v in model.video_encoder.state_dict().items())
    checks.expect(same, "training: a frozen encoder weight changed")
    del optimizer, encoder_before
    log(f"training ms per step (mean of steps 2-3; {n} queries, 16 frames, five tasks): full "
        f"{sum(full[1:]) / 2:.1f} (peak {peak_full:.2f} GiB), fused encoder {fused[0]:.1f} (first step), frozen "
        f"encoder {sum(frozen[1:]) / 2:.1f} (peak {peak_frozen:.2f} GiB); frozen encoder bit for bit: {same}")
    # (d) Trainer.fit with the encoder frozen, its checkpoint restored into a second model
    with tempfile.TemporaryDirectory() as out:
        trainer = P.Trainer(cfg_z, tasks, P.TrainerConfig(max_steps=2, log_every=1, ckpt_every=100, out_dir=out),
                            device=dev)
        t0 = time.perf_counter()
        _, optimizer, step = trainer.fit(model, iter(b for b in batches))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        second = P.L4P(cfg, device=dev, dtype=torch.bfloat16)
        restored, opt2, step2 = trainer.restore(f"{out}/ckpt_{step:07d}.pt", second)
        state, back = model.state_dict(), restored.state_dict()
        bitwise = (step2 == step == 2 and set(state) == set(back) and all(torch.equal(state[k], back[k]) for k in state)
                   and opt2.count == optimizer.count and all(torch.equal(optimizer.mu[k], opt2.mu[k])
                                                             and torch.equal(optimizer.nu[k], opt2.nu[k])
                                                             for k in optimizer.mu))
        size = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out)) / 2 ** 30
    log(f"training Trainer.fit: 2 steps with the encoder frozen and the checkpoint ({size:.2f} GiB) in "
        f"{fit_s:.2f} s; restored into a second model bit for bit (weights, moments, step): {bitwise}")
    checks.expect(bitwise, "training: Trainer.restore did not give back the checkpoint bit for bit")
    del second, restored, opt2, optimizer
    for p in model.parameters():
        p.requires_grad_(True)
    torch.cuda.empty_cache()


def mae_attention_case(FA, shape, gen):
    """Phase 26 (a): run(path) for hold_function_grads at an MAE shape, q, k
    and v the strided views of one (B, N, 3, H, D) product, as a block hands
    them over."""
    b, h, n, d = shape
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device=gen.device).bfloat16()

    def run(path):
        leaf = qkv.detach().to(torch.float32 if path == "fp32" else torch.bfloat16).requires_grad_()
        fn = FA.flash_attention if path == "kernel" else FA.flash_attention_plain
        return fn(*leaf.permute(2, 0, 3, 1, 4), d ** -0.5), [leaf]

    return run


def mae_phase(model, dev, log, checks, reset_counts, counts) -> dict:
    """Phase 26: VideoMAE pretraining at the giant registry entry's width (the
    module docstring says what each part holds). Overlays the CLI's
    encoder checkpoint on `model`'s encoder. Returns the MAE's readings."""
    import copy
    import statistics
    import tempfile

    from l4p_tpu_torch import load_video_encoder_ckpt
    from l4p_tpu_torch import pretrain_mae as PT
    from l4p_tpu_torch.models import mae as PM
    from l4p_tpu_torch.ops import flash_attention as FA
    from l4p_tpu_torch.train import make_mae_optimizer

    cfg = PM.mae_registry("giant")
    t, h, w = cfg.encoder.tokens_thw
    n_vis = t * (h * w - int(h * w * MAE_MASK_RATIO))
    shapes = ((MAE_BATCH, cfg.encoder.num_heads, n_vis, cfg.encoder.head_dim),
              (MAE_BATCH, cfg.decoder_num_heads, cfg.encoder.num_tokens, cfg.decoder_cfg.head_dim))
    # (a) the attention at the two shapes
    gen = torch.Generator(device=dev).manual_seed(26)
    attention = {}
    for shape in shapes:
        attention[str(shape)] = compare_attention(FA, shape, gen, log, checks, library=True)
        reset_counts()
        FA.flash_attention(*(torch.randn(shape, generator=gen, device=dev).bfloat16() for _ in range(3)), 0.125)
        checks.expect(counts()["flash_attention"] == 1, f"MAE attention {shape}: {counts()} launches for one call")
        hold_function_grads(f"MAE flash_attention {shape}", FA.FlashAttentionFunction,
                            mae_attention_case(FA, shape, gen), log, checks)
    torch.cuda.empty_cache()
    # (b) the first step on both paths, then three steps on each
    t0 = time.perf_counter()
    kernel_model = PM.MAE(cfg, device=dev, dtype=torch.bfloat16)
    kernel_model.init_weights(torch.Generator(device=dev).manual_seed(26))
    plain_model = copy.deepcopy(kernel_model)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in kernel_model.parameters())
    log(f"MAE giant: {n_params / 1e9:.4f} B parameters (decoder MLP {cfg.decoder_cfg.mlp_hidden}, head "
        f"{cfg.decoder_num_classes}), {n_vis} visible of {cfg.encoder.num_tokens} tokens, built in "
        f"{time.perf_counter() - t0:.2f} s")
    masks = torch.Generator().manual_seed(1)
    batches = PT.synthetic_batches(cfg.encoder, MAE_BATCH)
    steps = [(torch.as_tensor(next(batches), device=dev).bfloat16(),
              *(i.to(dev) for i in PM.tube_mask_indices(masks, cfg.encoder, MAE_BATCH, MAE_MASK_RATIO)))
             for _ in range(MAE_STEPS)]
    per_forward = cfg.encoder.depth + cfg.decoder_depth
    nodes = []

    def traced(q, k, v, scale):
        out = FA.flash_attention(q, k, v, scale)
        nodes.append(type(out.grad_fn).__name__)
        return out

    paths = {"kernel": (kernel_model, FA.flash_attention, per_forward), "plain": (plain_model,
                                                                                 FA.flash_attention_plain, 0)}
    grads, first = {}, {}
    for path, (m, attn, want) in paths.items():
        reset_counts()
        loss = PM.mae_pretrain_loss(m, *steps[0], attention=traced if path == "kernel" else attn)
        grads[path] = torch.autograd.grad(loss, list(m.parameters()))
        checks.expect(counts()["flash_attention"] == want,
                      f"MAE first step, {path} path: {counts()['flash_attention']} attention launches, expected {want}")
        first[path] = loss.item()
    function_node = FA.FlashAttentionFunction._backward_cls.__name__
    checks.expect(len(nodes) == per_forward and set(nodes) == {function_node},
                  f"MAE kernel path: attention outputs hang off {sorted(set(nodes))} ({len(nodes)} calls)")
    names = [n for n, _ in kernel_model.named_parameters()]
    rel = sorted((((gk.float() - gp.float()).abs().max() / gp.float().abs().max()).item(), n)
                 for n, gk, gp in zip(names, grads["kernel"], grads["plain"]) if gp.abs().max() > 0)
    l2, _ = grad_gap(grads["kernel"], grads["plain"])
    median = rel[len(rel) // 2][0]
    loss_gap = abs(first["kernel"] - first["plain"]) / abs(first["plain"])
    log(f"MAE first step: loss kernel path {first['kernel']:.6g}, plain path {first['plain']:.6g} (relative "
        f"{loss_gap:.3g}, tol {MAE_LOSS_TOL}); all {per_forward} attention outputs hang off {function_node}: "
        f"{set(nodes) == {function_node}}; gradients over {len(rel)} parameters, relative L2 {l2:.3g} (band "
        f"{MAE_STEP_GRAD_L2}), max|kernel - plain| / max|plain| median {median:.3g} (band {MAE_STEP_GRAD_BAND}), "
        f"largest {', '.join(f'{n} {r:.3g}' for r, n in rel[-3:])}")
    checks.expect(math.isfinite(loss_gap) and loss_gap <= MAE_LOSS_TOL, f"MAE first step's losses {first}")
    checks.expect(math.isfinite(l2) and l2 <= MAE_STEP_GRAD_L2 and median <= MAE_STEP_GRAD_BAND,
                  f"MAE first step's gradients differ from the plain path's (L2 {l2}, median {median})")
    del grads
    torch.cuda.empty_cache()
    losses, times, peaks = {}, {}, {}
    for path, (m, attn, want) in paths.items():
        # the CLI's defaults at --steps 3: lr 1.5e-4 after a 10-step warm-up from 0
        optimizer = make_mae_optimizer(dict(m.named_parameters()), 1.5e-4, MAE_STEPS, 10)
        torch.cuda.reset_peak_memory_stats()
        losses[path], times[path] = [], []
        for i, (x, vis, mask) in enumerate(steps):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = PT.pretrain_step(m, optimizer, x, vis, mask, attention=attn)
            torch.cuda.synchronize()
            times[path].append(1e3 * (time.perf_counter() - t0))
            losses[path].append(loss.item())
            checks.expect(counts()["flash_attention"] == want and math.isfinite(losses[path][-1]),
                          f"MAE {path} step {i}: loss {losses[path][-1]}, {counts()['flash_attention']} attention "
                          f"launches, expected {want}")
        peaks[path] = torch.cuda.max_memory_allocated() / 2 ** 30
        del optimizer
        torch.cuda.empty_cache()
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses["kernel"], losses["plain"])]
    ms = {path: statistics.mean(t[1:]) for path, t in times.items()}
    log(f"MAE pretraining steps: losses kernel path {losses['kernel']}, plain path {losses['plain']} (relative "
        f"{', '.join(f'{g:.3g}' for g in gaps)}, tol {MAE_LOSS_TOL}); ms per step (mean of steps 2-3): kernel path "
        f"{ms['kernel']:.1f}, plain path {ms['plain']:.1f}; first step {times['kernel'][0]:.1f} / "
        f"{times['plain'][0]:.1f} ms; peak memory {peaks['kernel']:.2f} / {peaks['plain']:.2f} GiB")
    checks.expect(all(math.isfinite(g) and g <= MAE_LOSS_TOL for g in gaps), f"MAE steps' losses {losses}")
    del kernel_model, plain_model, steps
    torch.cuda.empty_cache()
    # (c) the CLI in its own process; its checkpoint on the L4P encoder
    with tempfile.TemporaryDirectory() as out:
        runs = {"adamw": (MAE_STEPS, []), "adafactor": (1, ["--adafactor"])}
        cli = {}
        for name, (n_steps, extra) in runs.items():
            args = ["--size", "giant", "--batch", str(MAE_BATCH), "--steps", str(n_steps), *extra]
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "l4p_tpu_torch.pretrain_mae", *args, "--log-every", "1",
                                   "--out-dir", os.path.join(out, name)], capture_output=True, text=True, timeout=600)
            cli[name] = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
            log(f"python3 -m l4p_tpu_torch.pretrain_mae {' '.join(args)}: exit {proc.returncode} in "
                f"{time.perf_counter() - t0:.1f} s; {cli[name]}")
            checks.expect(proc.returncode == 0 and len(cli[name]) == n_steps
                          and all(math.isfinite(r["loss"]) for r in cli[name]),
                          f"pretrain_mae {' '.join(args)} failed: {proc.stdout[-500:]} {proc.stderr[-1500:]}")
        path = os.path.join(out, "adamw", "ckpt.pt")
        if os.path.exists(path):
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
            enc = model.video_encoder
            load_video_encoder_ckpt(enc, path)
            state = enc.state_dict()
            covered = set(ckpt) == {f"encoder.{k}" for k in state}
            same = covered and all(torch.equal(v.cpu(), ckpt[f"encoder.{k}"].to(v.dtype)) for k, v in state.items())
            log(f"pretrain_mae's ckpt.pt ({os.path.getsize(path) / 2 ** 30:.2f} GiB) on the giant L4P encoder: "
                f"the file holds every encoder tensor {covered}; all {len(state)} tensors ({cfg.encoder.depth} blocks) "
                f"equal the file's: {same}")
            checks.expect(same, "pretrain_mae's checkpoint did not overlay every tensor of the L4P giant encoder")
    return {"flash_attention": {"launches_per_forward": per_forward, "shapes": attention},
            "ms_per_step": ms, "first_step_ms": {p: t[0] for p, t in times.items()}, "peak_gib": peaks,
            "losses": losses, "first_step_grad_l2": l2, "cli": cli}


def giant_model(P, dev):
    """(cfg, model): the released giant model with random bf16 weights from
    a generator seeded 0 on the card (phase 3's), tracking QUERY_CHUNK
    queries a chunk; every process that builds it gets the same weights."""
    cfg = P.L4PConfig()
    cfg = dataclasses.replace(cfg, track=dataclasses.replace(cfg.track, max_queries=QUERY_CHUNK))
    model = P.L4P(cfg, device=dev, dtype=torch.bfloat16).eval()
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    return cfg, model


def launch_counts(cfg, frames: int, n_queries: int, n_data: int = 1, rank: int = 0) -> dict:
    """Each kernel's launches on data rank `rank` of `n_data` for one request
    of `frames` frames and `n_queries` queries on the default encoder: the
    attention 40 times a chunk of its windows, the track kernels once (i2t
    twice) a window and chunk, on its share of each chunk's queries."""
    from l4p_tpu_torch.models.l4p import num_windows
    from l4p_tpu_torch.parallel.mesh import row_counts

    nw = num_windows(cfg, frames)
    chunks = math.ceil(n_queries / QUERY_CHUNK)
    mine = row_counts(nw, n_data)[rank]
    return {"flash_attention": cfg.encoder.depth * math.ceil(mine / cfg.enc_window_chunk),
            "t2i_flash": nw * chunks, "i2t_ln_t2i": 2 * nw * chunks, "fused_upscale_hypernet": nw * chunks,
            "fused_encoder_blocks": 0}


def fps_request(cfg, dev) -> dict:
    """bench.py's 192 x 128 point: MULTI_CARD_FRAMES uint8 frames, their
    intrinsics and QUERY_CHUNK queries at t = 0.5, from a generator seeded 15."""
    gen = torch.Generator(device=dev).manual_seed(15)
    hw, frames = tuple(cfg.window_size[1:]), MULTI_CARD_FRAMES
    xy = 4 + torch.rand((1, QUERY_CHUNK, 2), generator=gen, device=dev) * (hw[0] - 8)
    return {"rgb_u8_bthw3": torch.randint(0, 256, (1, frames, *hw, 3), generator=gen, device=dev, dtype=torch.uint8),
            "intrinsics_b44t": bench_intrinsics(frames, hw, dev),
            "track_2d_pointquerries_bn3": torch.cat([torch.full((1, QUERY_CHUNK, 1), 0.5, device=dev), xy], -1),
            "track_2d_pointlabels_bn": torch.ones((1, QUERY_CHUNK), device=dev)}


def best_fps(sess, model, request, barrier=None) -> tuple:
    """(best frames/s, the REPEATS request times) after a first request."""
    sess(model, request)
    times = []
    for _ in range(REPEATS):
        if barrier is not None:
            barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess(model, request)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return request["rgb_u8_bthw3"].shape[1] / min(times), times


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def torchrun(n: int, *args: str, timeout: float) -> subprocess.CompletedProcess:
    """`args` (a module after -m, or this script) on n local processes under torchrun."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node", str(n),
           "--master_addr", "localhost", "--master_port", str(free_port()), *args]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)


def tagged_json(proc: subprocess.CompletedProcess, tag: str):
    """The JSON object a child printed after `tag`, or None."""
    for line in proc.stdout.splitlines():
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    return None


def child_log(log, proc: subprocess.CompletedProcess, what: str) -> None:
    """The lines a child logged, and the end of its errors where it failed."""
    for line in proc.stdout.splitlines():
        if line.startswith("[") or line.startswith("FAILED"):
            log(f"{what}: {line}")
    if proc.returncode:
        log(f"{what}: exit {proc.returncode}; stderr: {proc.stderr[-4000:]}")


def tp_encoder_rank() -> int:
    """Phase 27 (b), one of two processes on the one card (torchrun): the
    giant encoder on bench.py's 48-frame token windows, in one process on
    rank 0 and then split over a (1, 2) mesh with gloo (which reduces CUDA
    tensors); rank 0 holds each hook end against the one-process encoder and
    prints `TP_ENCODER {json}`."""
    if not torch.cuda.is_available():
        print("chip_smoke --tp-encoder: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import torch.distributed as dist

    import l4p_tpu_torch as P
    from l4p_tpu_torch.models import l4p as PL
    from l4p_tpu_torch.models.encoder import VideoEncoder
    from l4p_tpu_torch.ops import flash_attention as FA
    from l4p_tpu_torch.parallel import mesh as PM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = PM.make_mesh(1, 2, device="cuda:0", backend="gloo")
    rank, dev = dist.get_rank(), torch.device("cuda")
    card = card_line()

    def log(msg: str) -> None:
        print(f"[{card}] [tp rank {rank}] {msg}", flush=True)

    try:
        cfg = P.L4PConfig()
        enc = VideoEncoder(cfg.encoder, device=dev, dtype=torch.bfloat16).eval()
        enc.init_weights(torch.Generator(device=dev).manual_seed(0))
        hw = tuple(cfg.window_size[1:])
        video = torch.randint(0, 256, (1, TRACK_FRAMES, *hw, 3), generator=torch.Generator(device=dev).manual_seed(27),
                              device=dev, dtype=torch.uint8)
        nw = PL.num_windows(cfg, TRACK_FRAMES)

        def timed(run, reps: int = REPEATS):
            times = []
            for _ in range(reps):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                dist.barrier()
                times.append(time.perf_counter() - t0)
            return out, times

        with torch.inference_mode():
            exact = None
            if rank == 0:  # the one-process encoder's warm-up and its fp32 witness, rank 1 idle
                PL.encode_windows(enc, cfg, rgb_u8_bthw3=video)
                enc32 = copy.deepcopy(enc).float()
                exact = PL.encode_windows(enc32, cfg, rgb_u8_bthw3=video, attention=FA.flash_attention_plain)
                del enc32
                torch.cuda.empty_cache()
            one, t_one = timed(lambda: PL.encode_windows(enc, cfg, rgb_u8_bthw3=video) if rank == 0 else None)
            PM.shard_params(enc, mesh)
            before = P.flash_attention.launches
            tp, t_tp = timed(lambda: PL.encode_windows(enc, cfg, rgb_u8_bthw3=video, mesh=mesh), TP_REPS)
            launches = (P.flash_attention.launches - before) // TP_REPS
        want = cfg.encoder.depth * math.ceil(nw / cfg.enc_window_chunk)
        failed = [] if launches == want else [f"{launches} attention launches a request on rank {rank}, expected {want}"]
        if rank == 0:
            rec = {"one_process_s": t_one, "tp2_s": t_tp, "hooks": {}, "witness": {}}
            feats = {**{h: (tp["hooks"][h], one["hooks"][h], exact["hooks"][h]) for h in one["hooks"]},
                     cfg.encoder.depth: (tp["final"], one["final"], exact["final"])}
            for h, (a, b, ex) in feats.items():
                err, scale = rel_diff(a, b)
                band = TP_ENCODER_BANDS[h]
                rec["hooks"][h] = err / scale
                what = "output" if h == cfg.encoder.depth else "hook"
                log(f"giant encoder {what} {h} ({nw} windows, 48 frames), model axis of 2 against one process: "
                    f"max|TP - one| {err:.4g} = {err / scale:.3g} x max|one| (band {band})")
                if not (math.isfinite(err) and err <= band * scale):
                    failed.append(f"TP encoder hook {h} differs from one process by {err / scale:.3g} of its max")
                off = {who: (x.float() - ex).abs().mean().item() for who, x in (("tp", a), ("one", b))}
                ratio = off["tp"] / off["one"]
                rec["witness"][h] = ratio
                log(f"giant encoder {what} {h} against fp32 (plain attention): mean |error| TP {off['tp']:.4g}, one "
                    f"process {off['one']:.4g} (ratio {ratio:.3g}, within {ENCODER_WITNESS_SLACK})")
                if not (math.isfinite(ratio) and ratio <= ENCODER_WITNESS_SLACK):
                    failed.append(f"TP encoder hook {h} is farther from fp32 than one process: {off}")
            log(f"giant encoder, 48 frames ({nw} windows, {want} attention launches a rank): one process "
                f"{', '.join(f'{t:.4f}' for t in t_one)} s, model axis of 2 on this one card (gloo; the first cold) "
                f"{', '.join(f'{t:.4f}' for t in t_tp)} s")
            rec["failed"] = failed
            print("TP_ENCODER " + json.dumps(rec), flush=True)
        for f in failed:
            log(f"FAILED: {f}")
        return 1 if failed else 0
    finally:
        dist.destroy_process_group()


def multi_card_rank(path: str) -> int:
    """Phase 27 (d), one process a card (torchrun, NCCL): the giant model on
    a (cards, 1) mesh serves the all-task request saved at `path`, held
    against the one-card session's outputs saved there; each kernel's
    launches on this rank against its formula; then fps at bench.py's 192
    x 128 point. Rank 0 prints `MULTI_CARD {json}`."""
    if not torch.cuda.is_available():
        print("chip_smoke --multi-card: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import torch.distributed as dist

    import l4p_tpu_torch as P
    from l4p_tpu_torch.ops import fused_encoder as FE
    from l4p_tpu_torch.ops import fused_keys as FK
    from l4p_tpu_torch.ops import fused_upscale as FU
    from l4p_tpu_torch.parallel import mesh as PM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = PM.make_mesh(device="cuda")
    rank, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    failed = []

    def log(msg: str) -> None:
        print(f"[{card}] [card {rank} of {n}] {msg}", flush=True)

    counters = {"flash_attention": P.flash_attention, "t2i_flash": FK.t2i_flash, "i2t_ln_t2i": FK.i2t_ln_t2i,
                "fused_upscale_hypernet": FU.fused_upscale_hypernet, "fused_encoder_blocks": FE.fused_encoder_blocks}
    try:
        saved = torch.load(path, map_location=dev, weights_only=True)
        cfg, model = giant_model(P, dev)
        sess = P.InferenceSession(cfg, P.ALL_TASKS, dev, mesh=mesh)
        request = saved["request"]
        sess(model, request)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sess(model, request)
        torch.cuda.synchronize()
        t_req = time.perf_counter() - t0
        got = {name: fn.launches for name, fn in counters.items()}
        want = launch_counts(cfg, TRACK_FRAMES, QUERY_CHUNK, n, rank)
        if got != want:
            failed.append(f"launches {got} on card {rank}, expected {want}")
        if rank == 0:
            for key, ref in saved["outputs"].items():
                if key in ("depth_est_b1thw", *CAMRAY_KEYS):
                    err, scale = rel_diff(out[key], ref)
                    log(f"{key} on {n} cards against one card: max|diff| {err:.4g} = {err / scale:.3g} x max (the "
                        f"RANSACs pick by inlier counts; finite: {bool(torch.isfinite(out[key]).all())})")
                    if not bool(torch.isfinite(out[key]).all()):
                        failed.append(f"{key} on {n} cards is not finite")
                else:
                    checks = Checks(log)
                    hold_outputs(log, checks, key, out[key], ref, f"{n} cards", "n cards - one card")
                    failed += checks.failed
        frames = MULTI_CARD_FRAMES
        fps, times = best_fps(sess, model, fps_request(cfg, dev), dist.barrier)
        if rank == 0:
            log(f"all-task request {TRACK_FRAMES} x {QUERY_CHUNK} on {n} cards: {t_req:.4f} s; {frames} x "
                f"{QUERY_CHUNK}: {', '.join(f'{t:.4f}' for t in times)} s, best {fps:.2f} frames/s")
            print("MULTI_CARD " + json.dumps({"cards": n, "request_s": t_req, "frames": frames, "times": times,
                                              "fps": fps, "launches_rank0": got, "failed": failed}), flush=True)
        for f in failed:
            log(f"FAILED: {f}")
        return 1 if failed else 0
    finally:
        dist.destroy_process_group()


def multi_gpu_phase(P, model, cfg, request, dev, log, checks, reset_counts, counts) -> dict:
    """Phase 27: (a) the kernels at the shapes a rank gives them, (b) the
    giant encoder split over a model axis of 2 on this card (two processes,
    gloo), (c) bench.py's all-task request through InferenceSession on an
    NCCL group of one rank against the session without a mesh, (d) with two
    or more cards, the dry run and that request on min(4, cards) cards.
    Returns the readings."""
    import tempfile

    import torch.distributed as dist

    from l4p_tpu_torch.ops import flash_attention as FA
    from l4p_tpu_torch.ops import fused_keys as FK
    from l4p_tpu_torch.ops import fused_upscale as FU
    from l4p_tpu_torch.parallel import mesh as PM

    rec = {"kernels": {}}
    # (a) the kernels at the shard-local shapes
    gen = torch.Generator(device=dev).manual_seed(27)
    for shape in SHARD_ATTENTION_SHAPES:
        rec["kernels"][f"flash_attention {shape}"] = compare_attention(FA, shape, gen, log, checks, library=True)
    heads, p, c, k = 8, 2048, 1408, 48
    for n in SHARD_QUERIES:
        t2i_args, i2t_args = keys_operands(n, p, c, k, gen)
        keys, st, spe = t2i_args
        q_t, bias_t = st.transpose(1, 2).contiguous(), spe.transpose(1, 2).bfloat16().contiguous()
        rec["kernels"][f"t2i_flash N={n}"] = compare_track_kernel(
            "t2i_flash", FK.t2i_flash, FK.t2i_flash_plain, t2i_args, KEYS_BAND, 10, log, checks,
            flop=4 * n * p * c * k, keys_traffic=n * p * c * 2,
            library=lambda: F.scaled_dot_product_attention(q_t, keys, keys, bias_t, scale=1.0))
        rec["kernels"][f"i2t_ln_t2i N={n}"] = compare_track_kernel(
            "i2t_ln_t2i", lambda *a: FK.i2t_ln_t2i(*a, heads), lambda *a: FK.i2t_ln_t2i_plain(*a, heads), i2t_args,
            KEYS_BAND, 10, log, checks, flop=8 * n * p * c * k, keys_traffic=2 * n * p * c * 2)
        keys_witness(FK, t2i_args, i2t_args, heads, log, checks)
        del t2i_args, i2t_args, keys, st, spe, q_t, bias_t
        args = upscale_operands(n, p, c, 352, 176, 3, gen)
        rec["kernels"][f"fused_upscale_hypernet N={n}"] = compare_track_kernel(
            "fused_upscale_hypernet", FU.fused_upscale_hypernet, FU.fused_upscale_hypernet_plain, args, UPSCALE_BAND,
            5, log, checks, flop=2 * n * p * 8 * (c * 352 + 4 * 352 * 176) + 2 * n * 3 * p * 32 * 176)
        upscale_witness(FU, args, log, checks)
        del args
    for nd in (2, 4):
        per_rank = [launch_counts(cfg, TRACK_FRAMES, QUERY_CHUNK, nd, r) for r in range(nd)]
        log(f"launches a rank for a {TRACK_FRAMES}-frame x {QUERY_CHUNK}-query request on a data axis of {nd} "
            f"({QUERY_CHUNK // nd} queries a chunk a rank): {per_rank}")
    torch.cuda.empty_cache()

    # (b) the giant encoder over a model axis of 2, two processes on this card
    t0 = time.perf_counter()
    proc = torchrun(2, os.path.abspath(__file__), "--tp-encoder", timeout=600)
    child_log(log, proc, "phase 27b")
    tp = tagged_json(proc, "TP_ENCODER")
    checks.expect(proc.returncode == 0 and tp is not None and not tp["failed"],
                  f"phase 27b: exit {proc.returncode}, {tp and tp['failed']}")
    rec["tp_encoder"] = tp
    log(f"phase 27b took {time.perf_counter() - t0:.1f} s")

    # (c) an NCCL group of one rank through InferenceSession(mesh=)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0, world_size=1)
        try:
            mesh = PM.make_mesh(1, 1, device=dev)
            sess_m = P.InferenceSession(cfg, P.ALL_TASKS, dev, mesh=mesh)
            sess = P.InferenceSession(cfg, P.ALL_TASKS, dev)
            sess_m(model, request)
            times, want = {"mesh": [], "none": []}, launch_counts(cfg, TRACK_FRAMES, QUERY_CHUNK)
            outs = {}
            for which in ("none", "mesh", "mesh", "none"):
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[which] = (sess_m if which == "mesh" else sess)(model, request)
                torch.cuda.synchronize()
                times[which].append(time.perf_counter() - t0)
                checks.expect(counts() == want, f"phase 27c: launches {counts()} ({which}), expected {want}")
        finally:
            dist.destroy_process_group()
    same = all(torch.equal(outs["mesh"][key], outs["none"][key]) for key in outs["none"])
    log(f"all-task request {TRACK_FRAMES} x {QUERY_CHUNK} through an NCCL group of one rank: "
        f"{', '.join(f'{t:.4f}' for t in times['mesh'])} s; without a mesh {', '.join(f'{t:.4f}' for t in times['none'])}"
        f" s (in turns); launches {want}; outputs equal bit for bit: {same}")
    for key, r in outs["none"].items():
        hold_outputs(log, checks, key, outs["mesh"][key], r, "one-rank NCCL session", "mesh - no mesh")
    rec["one_rank_nccl"] = {"mesh_s": times["mesh"], "none_s": times["none"], "bitwise": same}

    # (d) two or more cards
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"phase 27d did not run: this machine has {cards} card; it runs the dry run and the session on "
            f"min({MULTI_CARDS}, cards) cards where there are two or more")
        rec["multi_card"] = None
        return rec
    n = min(MULTI_CARDS, cards)
    t0 = time.perf_counter()
    with torch.inference_mode():
        fps1, times1 = best_fps(sess, model, fps_request(cfg, dev))
    log(f"all-task request {MULTI_CARD_FRAMES} x {QUERY_CHUNK} on one card, no mesh: "
        f"{', '.join(f'{t:.4f}' for t in times1)} s, best {fps1:.2f} frames/s")
    torch.cuda.empty_cache()
    proc = torchrun(n, "-m", "l4p_tpu_torch.parallel.dryrun", "--device", "cuda", timeout=600)
    child_log(log, proc, "phase 27d dryrun")
    line = [x for x in proc.stdout.splitlines() if x.startswith("dryrun OK")]
    log(f"dryrun on {n} cards: exit {proc.returncode}: {line}")
    checks.expect(proc.returncode == 0 and len(line) == 1, f"phase 27d: the dry run on {n} cards failed")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "request.pt")
        torch.save({"request": {k: v.cpu() for k, v in request.items()},
                    "outputs": {k: v.cpu() for k, v in outs["none"].items()}}, path)
        proc = torchrun(n, os.path.abspath(__file__), "--multi-card", path, timeout=900)
    child_log(log, proc, "phase 27d session")
    multi = tagged_json(proc, "MULTI_CARD")
    checks.expect(proc.returncode == 0 and multi is not None and not multi["failed"],
                  f"phase 27d session: exit {proc.returncode}, {multi and multi['failed']}")
    rec["multi_card"] = multi
    rec["one_card_fps"] = fps1
    log(f"phase 27d took {time.perf_counter() - t0:.1f} s")
    return rec


def main() -> int:
    if len(sys.argv) > 1:
        if sys.argv[1] == "--tp-encoder":
            return tp_encoder_rank()
        if sys.argv[1] == "--multi-card" and len(sys.argv) == 3:
            return multi_card_rank(sys.argv[2])
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; run it with none", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's smoke run needs a CUDA card",
              file=sys.stderr)
        return 1
    import l4p_tpu_torch as P
    from l4p_tpu_torch import _build
    from l4p_tpu_torch.geometry import core as GC
    from l4p_tpu_torch.models import l4p as PL
    from l4p_tpu_torch.ops import conv as CONV
    from l4p_tpu_torch.ops import flash_attention as FA
    from l4p_tpu_torch.ops import fused_encoder as FE
    from l4p_tpu_torch.ops import fused_keys as FK
    from l4p_tpu_torch.ops import fused_upscale as FU
    from l4p_tpu_torch.ops import qk_norm_rope as QNR
    from l4p_tpu_torch.ops import resize as RS

    card = card_line()
    print(f"card: {card}", flush=True)

    def log(msg: str) -> None:
        print(f"[{card}] {msg}", flush=True)

    checks = Checks(log)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    # fp32 reference lanes in full fp32: no TF32 in matmuls or cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. build, one nvcc per library, all at once
    libraries = {FA.NAME: FA.SOURCES, FK.NAME: FK.SOURCES, FU.NAME: FU.SOURCES, FE.NAME: FE.SOURCES,
                 RS.NAME: RS.SOURCES, QNR.NAME: QNR.SOURCES}
    t0 = time.perf_counter()
    seconds = _build.build_all(libraries)
    log(f"built {len(libraries)} kernel libraries in {time.perf_counter() - t0:.2f} s wall: "
        + ", ".join(f"{name} {s:.2f} s" for name, s in seconds.items()))
    for name, sources in libraries.items():
        for line in _build.build_log(name, sources).splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "C75")):
                log(f"ptxas {name}: {line.strip()}")

    # 2. each kernel against its plain version
    gen = torch.Generator(device=dev).manual_seed(0)
    record = {"flash_attention": compare_attention(FA, (2, 16, 2048, 88), gen, log, checks, library=True)}
    compare_attention(FA, (5, 16, 2048, 88), gen, log, checks, library=True)  # the fused encoder's 80 heads
    compare_attention(FA, (1, 16, 2048, 88), gen, log, checks, library=True)  # streaming's one window
    compare_attention(FA, (1, 8, 512, 64), gen, log, checks, library=False)
    heads = 8
    for n, p, c, k, giant in ((QUERY_CHUNK, 2048, 1408, 48, True), (3, 1000, 128, 48, False)):
        t2i_args, i2t_args = keys_operands(n, p, c, k, gen)
        iters = 10 if giant else 20
        keys_bytes = n * p * c * 2
        # t2i is softmax over P of (keys . st + spe) applied to keys: one
        # scaled_dot_product_attention with q = st^T, k = v = keys and the
        # bias as its mask, cast to bf16 (the call takes no fp32 mask with
        # bf16 q), prepared outside the timed call
        keys, st, spe = t2i_args
        q_t, bias_t = st.transpose(1, 2).contiguous(), spe.transpose(1, 2).bfloat16().contiguous()
        # t2i reads keys once; i2t reads them and writes the new keys once
        r = compare_track_kernel("t2i_flash", FK.t2i_flash, FK.t2i_flash_plain, t2i_args, KEYS_BAND, iters, log,
                                 checks, flop=4 * n * p * c * k, keys_traffic=keys_bytes,
                                 library=lambda: F.scaled_dot_product_attention(q_t, keys, keys, bias_t, scale=1.0))
        r2 = compare_track_kernel("i2t_ln_t2i", lambda *a: FK.i2t_ln_t2i(*a, heads),
                                  lambda *a: FK.i2t_ln_t2i_plain(*a, heads), i2t_args, KEYS_BAND, iters, log,
                                  checks, flop=4 * n * p * c * k + 4 * n * p * c * k, keys_traffic=2 * keys_bytes)
        keys_witness(FK, t2i_args, i2t_args, heads, log, checks)
        if giant:
            record["t2i_flash"], record["i2t_ln_t2i"] = r, r2
        del t2i_args, i2t_args, keys, st, spe, q_t, bias_t
    products = compare_track_products(CONV, dev, log, checks)
    for n, p, c, d1, d2, giant in ((QUERY_CHUNK, 2048, 1408, 352, 176, True), (3, 1000, 64, 24, 12, False)):
        m = 3
        args = upscale_operands(n, p, c, d1, d2, m, gen)
        # deconv1 (8 offsets), deconv2 (4 offsets each), the hypernetwork dots
        flop = 2 * n * p * 8 * (c * d1 + 4 * d1 * d2) + 2 * n * m * p * 32 * d2
        r = compare_track_kernel("fused_upscale_hypernet", FU.fused_upscale_hypernet, FU.fused_upscale_hypernet_plain,
                                 args, UPSCALE_BAND, 5 if giant else 20, log, checks, flop=flop)
        upscale_witness(FU, args, log, checks)
        if giant:
            record["fused_upscale_hypernet"] = r
        del args
    record["fused_encoder_blocks"] = compare_fused_encoder(
        FE, P.GIANT, 2, 2048, (14, 21, 28, 36, 40), FUSED_ENCODER_BANDS, gen, 5, log, checks, witness=True)
    small = P.EncoderConfig(embed_dim=256, num_heads=4, depth=2, mlp_ratio=4.0)
    compare_fused_encoder(FE, small, 2, 300, (1, 2), {1: RAGGED_ENCODER_BAND, 2: RAGGED_ENCODER_BAND}, gen, 20,
                          log, checks)
    record["fused_encoder_blocks"]["products"] = compare_block_products(FE, gen, log, checks)
    resizes = compare_resizes(RS, dev, log, checks)
    vggt = compare_vggt_kernels(FA, RS, dev, log, checks)
    vda = compare_vda_kernels(FA, RS, dev, log, checks)
    torch.cuda.empty_cache()

    # 3. the released giant model, random bf16 weights
    t0 = time.perf_counter()
    cfg, model = giant_model(P, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_track = sum(p.numel() for p in model.task_heads["track_2d"].parameters())
    log(f"giant model: {n_params / 1e9:.3f} B parameters ({n_track / 1e6:.1f} M in the track head), "
        f"heads {sorted(model.task_heads)}, built in {time.perf_counter() - t0:.2f} s")

    hw = tuple(cfg.window_size[1:])
    videos = {
        t: torch.randint(0, 256, (1, t, *hw, 3), generator=gen, device=dev, dtype=torch.uint8) for t in FRAMES
    }
    dense_tasks = P.DENSE_TASKS
    sess = P.InferenceSession(cfg, dense_tasks, dev)
    t0 = time.perf_counter()
    sess(model, {"rgb_u8_bthw3": videos[FRAMES[0]]})  # chunks of 2 and of 1 window
    torch.cuda.synchronize()
    log(f"warm-up dense request ({FRAMES[0]} frames, first cuDNN/cuBLAS use of each shape): "
        f"{time.perf_counter() - t0:.3f} s")

    counters = {"flash_attention": FA.flash_attention, "t2i_flash": FK.t2i_flash, "i2t_ln_t2i": FK.i2t_ln_t2i,
                "fused_upscale_hypernet": FU.fused_upscale_hypernet,
                "fused_encoder_blocks": FE.fused_encoder_blocks}

    def reset_counts() -> None:
        for fn in counters.values():
            fn.launches = 0

    def counts() -> dict:
        return {name: fn.launches for name, fn in counters.items()}

    # 4. the dense path: requests through the session, counting kernel launches
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    outputs = {}
    for frames in FRAMES:
        nw = PL.num_windows(cfg, frames)
        want = cfg.encoder.depth * math.ceil(nw / cfg.enc_window_chunk)
        times = []
        want_resizes = resize_launches(cfg, dense_tasks, frames)
        for _ in range(REPEATS):
            before, resizes_before = FA.flash_attention.launches, RS.interpolate_trilinear.launches
            t0 = time.perf_counter()
            out = sess(model, {"rgb_u8_bthw3": videos[frames]})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got = FA.flash_attention.launches - before
            checks.expect(got == want, f"{got} kernel launches for {frames} frames, expected {want}")
            got = RS.interpolate_trilinear.launches - resizes_before
            checks.expect(got == want_resizes, f"{got} resize launches for {frames} frames, expected {want_resizes}")
            check_outputs(out, DENSE_KEYS, frames, hw, checks)
        outputs[frames] = out
        best = min(times)
        log(f"dense request {frames} frames ({nw} windows, {want} attention kernel launches each): "
            f"{', '.join(f'{t:.4f}' for t in times)} s; best {best:.4f} s = {frames / best:.2f} frames/s")
    checks.expect(FA.flash_attention.launches > 0, "the dense path never launched the attention kernel")
    log(f"peak device memory over the dense requests: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 5. where the time of the 48-frame dense request goes
    with torch.inference_mode():
        data = videos[FRAMES[0]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = PL.encode_windows(model.video_encoder, cfg, rgb_u8_bthw3=data)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dense = {t: PL.run_dense_head(model.task_heads[t], enc["hooks"], tuple(cfg.window_size),
                                      cfg.dense_window_chunk) for t in dense_tasks}
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        PL.stitch_dense_outputs(cfg, dense_tasks, dense, cfg.window_stride_t, FRAMES[0])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del enc, dense
    log(f"48-frame dense stages: encode {t1 - t0:.4f} s, dense heads {t2 - t1:.4f} s, stitch {t3 - t2:.4f} s")

    hold = functools.partial(hold_outputs, log, checks)

    # 6. the kernel path against the plain-attention path
    before = FA.flash_attention.launches
    ref = P.InferenceSession(cfg, dense_tasks, dev, attention=FA.flash_attention_plain)(
        model, {"rgb_u8_bthw3": videos[FRAMES[0]]})
    torch.cuda.synchronize()
    checks.expect(FA.flash_attention.launches == before, "the plain-attention session launched the kernel")
    for key, r in ref.items():
        hold(key, outputs[FRAMES[0]][key], r, "48-frame")
    del outputs, ref

    # 7. the track path: four tasks through the session, counting every kernel
    tasks = P.SLICE_TASKS
    sess = P.InferenceSession(cfg, tasks, dev)
    video = videos[TRACK_FRAMES]
    nw = PL.num_windows(cfg, TRACK_FRAMES)
    requests = {n: {"rgb_u8_bthw3": video, **track_queries(n, TRACK_FRAMES, hw, gen, dev)}
                for n in (*TRACK_QUERIES, PADDED_QUERIES)}
    t0 = time.perf_counter()
    sess(model, requests[TRACK_QUERIES[0]])
    torch.cuda.synchronize()
    log(f"warm-up track request ({TRACK_FRAMES} frames, {TRACK_QUERIES[0]} queries): {time.perf_counter() - t0:.3f} s")

    def expected(n_queries: int, fused: bool) -> dict:
        chunks = math.ceil(n_queries / QUERY_CHUNK)
        return {"flash_attention": 0 if fused else cfg.encoder.depth * math.ceil(nw / cfg.enc_window_chunk),
                "t2i_flash": nw * chunks, "i2t_ln_t2i": 2 * nw * chunks, "fused_upscale_hypernet": nw * chunks,
                "fused_encoder_blocks": 1 if fused else 0}

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    track_out = None
    for n in (*TRACK_QUERIES, PADDED_QUERIES):
        times = []
        for _ in range(REPEATS if n in TRACK_QUERIES else 1):
            before, resizes_before = counts(), RS.interpolate_trilinear.launches
            t0 = time.perf_counter()
            out = sess(model, requests[n])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got = {name: c - before[name] for name, c in counts().items()}
            checks.expect(got == expected(n, False), f"kernel launches {got} at {n} queries, "
                                                     f"expected {expected(n, False)}")
            got = RS.interpolate_trilinear.launches - resizes_before
            want = resize_launches(cfg, tasks, TRACK_FRAMES)
            checks.expect(got == want, f"{got} resize launches at {n} queries, expected {want}")
            check_outputs(out, {**DENSE_KEYS, **TRACK_KEYS}, TRACK_FRAMES, hw, checks,
                          requests[n]["track_2d_pointquerries_bn3"])
        if n == TRACK_QUERIES[0]:
            track_out = out
        best = min(times)
        log(f"track request {TRACK_FRAMES} frames x {n} queries ({math.ceil(n / QUERY_CHUNK)} chunk(s), {nw} windows, "
            f"launches {expected(n, False)}): {', '.join(f'{t:.4f}' for t in times)} s; best {best:.4f} s = "
            f"{TRACK_FRAMES / best:.2f} frames/s, {n * TRACK_FRAMES / best:.0f} query-frames/s")
    track_counts = counts()
    missing = [name for name, c in track_counts.items() if c == 0 and name != "fused_encoder_blocks"]
    checks.expect(not missing, f"the track path never launched {missing}")
    log(f"peak device memory over the track requests: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 8. where the time of the 48-frame, 128-query request goes
    data = requests[TRACK_QUERIES[0]]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = PL.encode_windows(model.video_encoder, cfg, rgb_u8_bthw3=video)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dense = {t: PL.run_dense_head(model.task_heads[t], enc["hooks"], tuple(cfg.window_size),
                                      cfg.dense_window_chunk) for t in dense_tasks}
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        PL.stitch_dense_outputs(cfg, dense_tasks, dense, cfg.window_stride_t, TRACK_FRAMES)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        PL.run_track_chunked(model.task_heads["track_2d"], enc["final"], data["track_2d_pointquerries_bn3"],
                             data["track_2d_pointlabels_bn"], cfg.window_stride_t)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        del enc, dense
    log(f"{TRACK_FRAMES}-frame {TRACK_QUERIES[0]}-query stages: encode {t1 - t0:.4f} s, dense heads "
        f"{t2 - t1:.4f} s, stitch {t3 - t2:.4f} s, track {t4 - t3:.4f} s ({(t4 - t3) / nw * 1e3:.1f} ms/window)")

    # 9. the kernel path against the plain path, all six outputs
    before = counts()
    t0 = time.perf_counter()
    ref = P.InferenceSession(cfg, tasks, dev, attention=FA.flash_attention_plain, track_kernels=P.PLAIN)(model, data)
    torch.cuda.synchronize()
    log(f"plain-path request {TRACK_FRAMES} frames x {TRACK_QUERIES[0]} queries: {time.perf_counter() - t0:.4f} s")
    checks.expect(counts() == before, "the plain-path session launched a kernel")
    for key, r in ref.items():
        hold(key, track_out[key], r, f"{TRACK_FRAMES}-frame {TRACK_QUERIES[0]}-query")
    del ref, track_out
    # the witness of TRACK_BANDS: more requests, each path also against itself with the attention in fp32
    for key, rows in track_witness(P, FA, model, cfg, dev, WITNESS_REQUESTS, log).items():
        mean = {what: sum(p99 for _, p99 in v) / len(v) for what, v in rows.items()}
        worst = tuple(max(v[i] for v in rows["kernel - plain"][:TRACK_BAND_REQUESTS]) for i in range(2))
        beyond = [r for r, v in enumerate(rows["kernel - plain"])
                  if v[0] > TRACK_BANDS[key][0] or v[1] > TRACK_BANDS[key][1]]
        ratio = mean["kernel"] / mean["plain"]
        log(f"witness {key} over {WITNESS_REQUESTS} requests: mean 99th pct / output max against its fp32-attention "
            f"run, kernel path {mean['kernel']:.3g}, plain path {mean['plain']:.3g} (ratio {ratio:.3g}, within "
            f"{WITNESS_SLACK}); kernel path against plain path over the first {TRACK_BAND_REQUESTS}, largest (max, "
            f"99th pct) ({worst[0]:.3g}, {worst[1]:.3g}) (bands {TRACK_BANDS[key]}); requests beyond the bands "
            f"(logged, not held): {beyond}")
        checks.expect(ratio <= WITNESS_SLACK, f"{key}: the kernel path is farther from its fp32-attention run than "
                                              f"the plain path: {mean}")
        checks.expect(worst[0] <= TRACK_BANDS[key][0] and worst[1] <= TRACK_BANDS[key][1],
                      f"{key}: a witness request's kernel path differs from its plain path by {worst}")

    # 10. bench.py's request as bench.py runs it (the config as loaded: the
    # default encoder), then the same request on the whole-encoder kernels
    cfg_f = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, fused_encoder=True))
    n_q = TRACK_QUERIES[0]
    intr = bench_intrinsics(TRACK_FRAMES, hw, dev)
    request = {**requests[n_q], "intrinsics_b44t": intr}

    products_read = {}  # einsum_fp32's count on each all-task request, by point

    def serve_all_task(c, label: str):
        """A warm-up, then REPEATS timed all-task requests on config `c` with
        every count set to 0 just before them, checking outputs and launches;
        returns (the last output, the counts, the launches inside
        fused_encoder_blocks)."""
        sess_a = P.InferenceSession(c, P.ALL_TASKS, dev)
        fused = c.encoder.fused_encoder
        t0 = time.perf_counter()
        sess_a(model, request)
        torch.cuda.synchronize()
        log(f"warm-up all-task request ({TRACK_FRAMES} frames, {n_q} queries, {label}): "
            f"{time.perf_counter() - t0:.3f} s")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        inner0 = FE.fused_encoder_blocks.kernel_launches
        times = []
        want_products = track_products(c, TRACK_FRAMES, n_q)["all"]
        products_read[label] = []
        for _ in range(REPEATS):
            before, resizes_before = counts(), RS.interpolate_trilinear.launches
            products_before = CONV.einsum_fp32.launches
            t0 = time.perf_counter()
            out = sess_a(model, request)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got = {name: c_ - before[name] for name, c_ in counts().items()}
            checks.expect(got == expected(n_q, fused), f"kernel launches {got} on the all-task request ({label}), "
                                                       f"expected {expected(n_q, fused)}")
            got = RS.interpolate_trilinear.launches - resizes_before
            want = resize_launches(c, P.ALL_TASKS, TRACK_FRAMES)
            checks.expect(got == want, f"{got} resize launches on the all-task request ({label}), expected {want}")
            got = CONV.einsum_fp32.launches - products_before
            products_read[label].append(got)
            checks.expect(got == want_products, f"{got} tensor-core products (einsum_fp32) on the all-task request "
                                                f"({label}), expected {want_products}")
            check_outputs(out, {**DENSE_KEYS, **TRACK_KEYS, **CAMRAY_KEYS}, TRACK_FRAMES, hw, checks,
                          request["track_2d_pointquerries_bn3"])
        got_counts = counts()
        inner = FE.fused_encoder_blocks.kernel_launches - inner0
        best = min(times)
        log(f"all-task request {TRACK_FRAMES} frames x {n_q} queries, tasks {P.ALL_TASKS}, {label}, joint "
            f"alignment ({nw} windows, launches {expected(n_q, fused)}, {inner // REPEATS} kernel launches inside "
            f"fused_encoder_blocks, {want_products} tensor-core products): {', '.join(f'{t:.4f}' for t in times)} s; "
            f"best {best:.4f} s = "
            f"{TRACK_FRAMES / best:.2f} frames/s, {n_q * TRACK_FRAMES / best:.0f} query-frames/s")
        log(f"peak device memory over the all-task requests ({label}): "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return out, got_counts, inner

    _, main_counts, _ = serve_all_task(cfg, "bench.py's path: default encoder")
    missing = [name for name, c in main_counts.items() if c == 0 and name != "fused_encoder_blocks"]
    checks.expect(not missing, f"bench.py's request never launched {missing}")
    all_out, fused_counts, inner = serve_all_task(cfg_f, "second point: fused encoder")
    want_inner = REPEATS * FE.LAUNCHES_PER_BLOCK * cfg.encoder.depth
    checks.expect(inner == want_inner, f"fused_encoder_blocks made {inner} launches inside, expected {want_inner}")
    checks.expect(fused_counts["fused_encoder_blocks"] > 0, "the fused point never launched fused_encoder_blocks")

    # 11. where the time of bench.py's request goes
    img_info = tuple(cfg.window_size)
    stride = cfg.window_stride_t
    hcfg = cfg.head_dict["camray"]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = PL.encode_windows(model.video_encoder, cfg, rgb_u8_bthw3=video)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dense = {t: PL.run_dense_head(model.task_heads[t], enc["hooks"], img_info, cfg.dense_window_chunk)
                 for t in dense_tasks}
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rays = PL.run_dense_head(model.task_heads["camray"], enc["hooks"], img_info, cfg.dense_window_chunk).float()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        pose_w, intr_w = PL.camray_windows_to_cameras(rays, hcfg, img_info, intr, stride, P.RandomDraws())
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        PL.stitch_dense_outputs(cfg, P.ALL_TASKS, dense, stride, TRACK_FRAMES, pose_w, intr_w, P.RandomDraws())
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        PL.run_track_chunked(model.task_heads["track_2d"], enc["final"], request["track_2d_pointquerries_bn3"],
                             request["track_2d_pointlabels_bn"], stride)
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        del enc
        torch.cuda.synchronize()
        t7 = time.perf_counter()
        hooks_kernel = PL.encode_windows(model.video_encoder, cfg_f, rgb_u8_bthw3=video)["hooks"]
        torch.cuda.synchronize()
        t8 = time.perf_counter()
        # the fused point's rays and depth, which phase 13 solves on the card and the CPU
        rays = PL.run_dense_head(model.task_heads["camray"], hooks_kernel, img_info, cfg.dense_window_chunk).float()
        depth_f = PL.run_dense_head(model.task_heads["depth"], hooks_kernel, img_info, cfg.dense_window_chunk)
        del dense
    log(f"all-task {TRACK_FRAMES}-frame {n_q}-query stages (bench.py's path): encode {t1 - t0:.4f} s (default "
        f"encoder; the fused encoder took {t8 - t7:.4f} s), dense heads {t2 - t1:.4f} s, camray rays {t3 - t2:.4f} s, "
        f"camera solve {t4 - t3:.4f} s, stitch {t5 - t4:.4f} s, track {t6 - t5:.4f} s")

    # 12. the fused point's request on the plain path
    with torch.inference_mode():
        hooks_plain = PL.encode_windows(model.video_encoder, cfg_f, rgb_u8_bthw3=video,
                                        attention=FA.flash_attention_plain,
                                        encoder_blocks=FE.fused_encoder_blocks_plain)["hooks"]
    for h in sorted(hooks_kernel):
        err, scale = rel_diff(hooks_kernel[h], hooks_plain[h])
        what = "normed output" if h == cfg.encoder.depth else "hook"
        log(f"all-task encoder {what} {h} ({nw} windows, fused point): max|kernel - plain| {err:.4g} = "
            f"{err / scale:.3g} x max|plain| (band {FUSED_ENCODER_BANDS[h]})")
        checks.expect(math.isfinite(err) and err <= FUSED_ENCODER_BANDS[h] * scale,
                      f"encoder hook {h} of the all-task request differs from the plain path by {err}")
    del hooks_kernel, hooks_plain
    before = counts()
    t0 = time.perf_counter()
    ref = P.InferenceSession(cfg_f, P.ALL_TASKS, dev, attention=FA.flash_attention_plain, track_kernels=P.PLAIN,
                             encoder_blocks=FE.fused_encoder_blocks_plain)(model, request)
    torch.cuda.synchronize()
    log(f"plain-path all-task request (fused point): {time.perf_counter() - t0:.4f} s")
    checks.expect(counts() == before, "the plain-path all-task session launched a kernel")
    for key, r in ref.items():
        if key in ("depth_est_b1thw", *CAMRAY_KEYS):
            # the Sim(3) and homography RANSACs pick among hypotheses by
            # inlier counts, which a bf16 step can change: finite, difference printed
            err, scale = rel_diff(all_out[key], r)
            log(f"all-task {key} (fused point, joint Sim(3) chain): max|kernel path - plain path| {err:.4g} = "
                f"{err / scale:.3g} x max|plain|, both finite: {bool(torch.isfinite(r).all())}")
            checks.expect(bool(torch.isfinite(r).all()), f"plain-path {key} is not finite")
        else:
            hold(key, all_out[key], r, "all-task (fused point)")
    del ref, all_out

    # 13. the camera solve and the joint stitch on the card and on the CPU
    def card_and_cpu(what: str, rays_w, intr_k, depth_w) -> dict:
        """The camera solve and the joint stitch on the card and on the CPU
        with the same draws; returns the CPU's results."""
        trace, results = {}, {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            GC.RANSAC_TRACE = []
            with torch.inference_mode():
                pose_d, intr_d = PL.camray_windows_to_cameras(rays_w.to(d), hcfg, img_info, intr_k.to(d), stride,
                                                              P.RandomDraws())
                joint = PL.stitch_dense_outputs(cfg, ("depth", "camray"), {"depth": depth_w.to(d)}, stride,
                                                TRACK_FRAMES, pose_d, intr_d, P.RandomDraws())
            pose_key, k_key = CAMRAY_KEYS
            results[where] = {"window poses": pose_d, "window K": intr_d, "stitched depth": joint["depth_est_b1thw"],
                              "stitched poses": joint[pose_key], "stitched K": joint[k_key]}
            trace[where] = GC.RANSAC_TRACE
        GC.RANSAC_TRACE = None
        checks.expect(len(trace["card"]) == len(trace["cpu"]), f"{what}: the card and the CPU ran other RANSACs")
        for i, ((cnt_g, best_g), (cnt_c, best_c)) in enumerate(zip(trace["card"], trace["cpu"])):
            top_g, top_c = cnt_g.topk(2, dim=-1).values.tolist(), cnt_c.topk(2, dim=-1).values.tolist()
            which = "homography (window 0)" if i == 0 else f"Sim(3) window step {i}"
            log(f"{what} RANSAC {which}: chosen hypothesis card {best_g.tolist()} / CPU {best_c.tolist()}, two "
                f"best inlier counts card {top_g} / CPU {top_c} of {cnt_g.shape[-1]} hypotheses")
        for key, cpu_val in results["cpu"].items():
            err, scale = rel_diff(results["card"][key], cpu_val)
            log(f"{what} {key}: max|card - CPU| {err:.4g} = {err / max(scale, 1e-30):.3g} x max|CPU| "
                f"(band {GEOMETRY_TOL})")
            checks.expect(math.isfinite(err) and err <= GEOMETRY_TOL * scale,
                          f"{what} {key} on the card differs from the CPU by {err}")
        return results["cpu"]

    card_and_cpu("model's rays:", rays, intr, depth_f)

    # 14. the same on a synthetic trajectory, against its truth
    ray_hw = tuple(hcfg.dpt.output_size[1:])
    syn_rays, syn_depth, syn_k, syn_pose, syn_truth = synthetic_trajectory(
        nw, cfg.window_size[0], stride, hw, ray_hw, torch.Generator().manual_seed(3))
    cpu = card_and_cpu("synthetic trajectory:", syn_rays, syn_k, syn_depth)
    ws = cfg.window_size[0]
    k_err, k_max = rel_diff(cpu["window K"][0], syn_k[..., :ws].reshape(1, 16, ws))
    p_err, p_max = rel_diff(cpu["window poses"], syn_pose)
    ratio = (cpu["stitched depth"] / syn_truth - 1).abs().flatten()
    ratio_med, ratio_p99 = ratio.median().item(), ratio.quantile(0.99).item()
    log(f"synthetic trajectory against its truth: window-0 K {k_err:.4g} = {k_err / k_max:.3g} x max|K|, window "
        f"poses {p_err:.4g} = {p_err / p_max:.3g} x max|pose|, stitched depth / true depth - 1: median "
        f"{ratio_med:.4g}, 99th pct {ratio_p99:.4g} (bands {TRUTH_BANDS})")
    checks.expect(k_err <= TRUTH_BANDS["K"] * k_max and p_err <= TRUTH_BANDS["poses"] * p_max
                  and ratio_med <= TRUTH_BANDS["depth"],
                  f"the synthetic trajectory's solve is off its truth: K {k_err}, poses {p_err}, depth {ratio_med}")

    # 15. bench.py's port in its own process
    run_bench(log, checks, cfg)
    torch.cuda.empty_cache()

    # 16. bidirectional tracking, in turns with forward-only tracking
    def with_dirs(dirs):
        return dataclasses.replace(cfg, track=dataclasses.replace(cfg.track, estimation_directions=dirs))

    bi_request = {"rgb_u8_bthw3": video, **spread_queries(n_q, TRACK_FRAMES, hw, gen, dev)}
    bi_queries = bi_request["track_2d_pointquerries_bn3"]
    sess_fwd, sess_bi = P.InferenceSession(cfg, tasks, dev), P.InferenceSession(with_dirs((1, -1)), tasks, dev)
    sess_bi(model, bi_request)  # warm-up
    times, outs = {"forward": [], "bidirectional": []}, {}
    for which in ("forward", "bidirectional", "bidirectional", "forward"):
        reset_counts()
        t0 = time.perf_counter()
        outs[which] = (sess_fwd if which == "forward" else sess_bi)(model, bi_request)
        torch.cuda.synchronize()
        times[which].append(time.perf_counter() - t0)
        got = counts()
        want = {name: (2 if which == "bidirectional" else 1) * c for name, c in expected(n_q, False).items()}
        checks.expect(got == want, f"{which} request launches {got}, expected {want}")
        check_outputs(outs[which], {**DENSE_KEYS, **TRACK_KEYS}, TRACK_FRAMES, hw, checks, bi_queries)
    log(f"{TRACK_FRAMES}-frame {n_q}-query request with every query spread, in turns: forward only "
        f"{', '.join(f'{t:.4f}' for t in times['forward'])} s, bidirectional "
        f"{', '.join(f'{t:.4f}' for t in times['bidirectional'])} s (launches {counts()})")
    checks.expect(bool((outs["bidirectional"]["track_2d_depth_est_bn1t"] > 0).all()),
                  "bidirectional track depth is not positive before the queries' frames")
    # each direction's kernel path against its plain path. TRACK_BANDS are relative to an output's
    # largest value, which for vis is the -10 its frames before a query keep in one direction, so
    # the bands hold the two directions' outputs; the bidirectional output is their merge
    outs["backward"] = P.InferenceSession(with_dirs((-1,)), tasks, dev)(model, bi_request)
    before = counts()
    for which, dirs in (("forward", (1,)), ("backward", (-1,))):
        ref = P.InferenceSession(with_dirs(dirs), tasks, dev, attention=FA.flash_attention_plain,
                                 track_kernels=P.PLAIN)(model, bi_request)
        for key, r in ref.items():
            if which == "forward" or key in TRACK_KEYS:
                hold(key, outs[which][key], r, f"{which} tracks of the bidirectional request:")
        del ref
    torch.cuda.synchronize()
    checks.expect(counts() == before, "the plain-path sessions launched a kernel")
    merged = PL.merge_directions({k: outs["forward"][k] for k in TRACK_KEYS},
                                 {k: outs["backward"][k] for k in TRACK_KEYS}, bi_queries, TRACK_FRAMES)
    same = all(torch.equal(merged[k], outs["bidirectional"][k]) for k in TRACK_KEYS)
    log(f"bidirectional tracks equal the merge of the forward-only and backward-only requests' tracks: {same}")
    checks.expect(same, "the bidirectional tracks are not the merge of the two directions' tracks")
    del outs, merged

    # 17. a camera_rays head: the released camray head read as VideoMAECameraDPTHead
    rays_head = dataclasses.replace(cfg.head_dict["camray"], kind="camera_rays")
    cfg_rays = dataclasses.replace(cfg, heads=tuple((n, rays_head if n == "camray" else h) for n, h in cfg.heads))
    rays_tasks = (*dense_tasks, "camray")
    rays_key = f"{rays_head.task_name}_est_b6thw"
    reset_counts()
    t0 = time.perf_counter()
    out = P.InferenceSession(cfg_rays, rays_tasks, dev)(model, {"rgb_u8_bthw3": video})
    torch.cuda.synchronize()
    rays_s = time.perf_counter() - t0
    got = counts()
    want = {**{name: 0 for name in counters}, "flash_attention": expected(n_q, False)["flash_attention"]}
    checks.expect(got == want, f"camera_rays request launches {got}, expected {want}")
    ray_shape = (1, 6, TRACK_FRAMES, *rays_head.dpt.output_size[1:])
    checks.expect(tuple(out[rays_key].shape) == ray_shape and bool(torch.isfinite(out[rays_key]).all()),
                  f"{rays_key} has shape {tuple(out[rays_key].shape)}, expected {ray_shape}, or is not finite")
    log(f"camera_rays request {TRACK_FRAMES} frames, tasks {rays_tasks}: {rays_s:.4f} s, {rays_key} "
        f"{tuple(out[rays_key].shape)}")
    ref = P.InferenceSession(cfg_rays, rays_tasks, dev, attention=FA.flash_attention_plain)(
        model, {"rgb_u8_bthw3": video})
    for key, r in ref.items():
        hold(key, out[key], r, "camera_rays request")
    del ref, out

    # 18. streaming bench.py's request in strides, against the offline session
    frames_np = video.cpu().numpy()
    intr_np = intr.cpu().numpy()
    stream = P.StreamingL4P(model, cfg, P.ALL_TASKS, dev, request["track_2d_pointquerries_bn3"])
    stream.warmup()
    reset_counts()
    emits, push_ms = [], []
    t_all = time.perf_counter()
    for t0_ in range(0, TRACK_FRAMES, stride):
        t0 = time.perf_counter()
        got = stream.push(frames_np[:, t0_: t0_ + stride], intr_np[..., t0_: t0_ + stride])
        torch.cuda.synchronize()
        push_ms.append((time.perf_counter() - t0) * 1e3)
        emits += got
    emits.append(stream.flush())
    streamed = P.assemble_emissions(emits)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t_all
    got = counts()
    want = {**expected(n_q, False), "flash_attention": cfg.encoder.depth * nw}
    checks.expect(got == want, f"streaming launches {got}, expected {want}")
    check_outputs(streamed, {**DENSE_KEYS, **TRACK_KEYS, **CAMRAY_KEYS}, TRACK_FRAMES, hw, checks,
                  request["track_2d_pointquerries_bn3"])
    cfg_one = dataclasses.replace(cfg, enc_window_chunk=1, dense_window_chunk=1)
    offline = {}
    for name, c in (("one window at a time", cfg_one), ("default", cfg)):
        sess_o = P.InferenceSession(c, P.ALL_TASKS, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        offline[name] = sess_o(model, request)
        torch.cuda.synchronize()
        offline[name + " s"] = time.perf_counter() - t0
    log(f"streaming {TRACK_FRAMES} frames x {n_q} queries, five tasks, pushes of {stride} frames: ms per push "
        f"{', '.join(f'{t:.1f}' for t in push_ms)} (a window runs from the second push on; "
        f"{sum(push_ms[1:]) / len(push_ms[1:]):.1f} ms per stride), whole video {stream_s:.4f} s; offline session "
        f"{offline['default s']:.4f} s (one window at a time: {offline['one window at a time s']:.4f} s)")
    # the kernels at streaming's shapes (the encoder at batch 1, the track carry) against their
    # plain versions: the offline session one window at a time on the plain path
    before = counts()
    plain = P.InferenceSession(cfg_one, P.ALL_TASKS, dev, attention=FA.flash_attention_plain,
                               track_kernels=P.PLAIN)(model, request)
    torch.cuda.synchronize()
    checks.expect(counts() == before, "the plain-path one-window session launched a kernel")
    for key, r in plain.items():
        if key in ("depth_est_b1thw", *CAMRAY_KEYS):
            # the RANSACs pick among hypotheses by inlier counts, which a bf16 step can change
            # (phase 12): finite, difference printed
            err, scale = rel_diff(streamed[key], r)
            log(f"streaming {key} (joint Sim(3) chain) against the plain path one window at a time: max|diff| "
                f"{err:.4g} = {err / max(scale, 1e-30):.3g} x max|plain|, both finite: "
                f"{bool(torch.isfinite(r).all())}")
            checks.expect(bool(torch.isfinite(r).all()), f"plain-path one-window {key} is not finite")
        else:
            hold(key, streamed[key], r, "streaming against the plain path one window at a time:")
    del plain
    # the stream runs the offline session's one-window steps: equal to its kernel path bit for bit
    for key, r in offline["one window at a time"].items():
        same = torch.equal(streamed[key], r)
        err, scale = rel_diff(streamed[key], r)
        log(f"streaming {key} against the offline session's kernel path one window at a time: bit for bit "
            f"{same}, max|diff| {err:.4g}")
        checks.expect(same, f"streaming {key} differs from the offline session one window at a time by {err}")
    for key, r in offline["default"].items():
        err, scale = rel_diff(streamed[key], r)
        log(f"streaming {key} against the default offline session: max|diff| {err:.4g} = "
            f"{err / max(scale, 1e-30):.3g} x max|offline|")
    del offline, streamed, emits, stream
    torch.cuda.empty_cache()

    # 19. the model in bf16, kernels on and off, against fp32
    bf16_against_fp32(P, model, cfg, dev, log, checks)
    # 20. run_sequence, offline and streamed, on bench.py's request
    run_sequence_phase(P, model, cfg, dev, log, checks, reset_counts, counts, expected)
    # 21. the data pipeline and the writers that need no cv2
    pipeline_phase(P, model, cfg, dev, log, checks)
    # 22. stream_bench in its own process; the native preprocessing library
    tools_phase(log, checks)
    # 23. the five eval configs, kernel path against plain path, metrics card against CPU
    t0 = time.perf_counter()
    eval_phase(P, model, cfg, dev, log, checks, reset_counts, counts)
    torch.cuda.empty_cache()
    # 24. the encoder's option branches at giant width and depth
    options_phase(P, cfg, videos[TRACK_FRAMES], dev, log, checks, reset_counts, counts, model)
    torch.cuda.empty_cache()
    log(f"phases 23-24 took {time.perf_counter() - t0:.1f} s")
    # 25. training: each kernel's Function, train steps, Trainer.fit with save / restore
    t0 = time.perf_counter()
    training_phase(P, model, cfg, dev, log, checks, reset_counts, counts)
    log(f"phase 25 took {time.perf_counter() - t0:.1f} s")
    # 26. VideoMAE pretraining: the attention at the MAE's shapes, steps on both paths, the CLI
    t0 = time.perf_counter()
    mae = mae_phase(model, dev, log, checks, reset_counts, counts)
    print(json.dumps({"card": card, "mae": mae}), flush=True)
    log(f"phase 26 took {time.perf_counter() - t0:.1f} s")
    # 27. multi-GPU: the kernels at a rank's shapes, tensor parallelism on this card, a one-rank NCCL session
    t0 = time.perf_counter()
    multi = multi_gpu_phase(P, model, cfg, request, dev, log, checks, reset_counts, counts)
    print(json.dumps({"card": card, "multi_gpu": multi}), flush=True)
    log(f"phase 27 took {time.perf_counter() - t0:.1f} s")

    # 28. SAM 2: the attention kernel at head dim 256, one request of its cell against the reference
    t0 = time.perf_counter()
    sam2 = compare_sam2(FA, RS, dev, log, checks)
    print(json.dumps({"card": card, "sam2": sam2}), flush=True)
    log(f"phase 28 took {time.perf_counter() - t0:.1f} s")

    log(f"chip_smoke phases took {time.perf_counter() - t_start:.1f} s")
    if checks.failed:
        print(f"chip_smoke: {len(checks.failed)} check(s) failed: {checks.failed}", file=sys.stderr)
        return 1

    replaces = {"flash_attention": "l4p_tpu/ops/flash_attention.py:22",
                "t2i_flash": "l4p_tpu/ops/fused_keys.py:94",
                "i2t_ln_t2i": "l4p_tpu/ops/fused_keys.py:100",
                "fused_upscale_hypernet": "l4p_tpu/ops/fused_upscale.py:104",
                "fused_encoder_blocks": "l4p_tpu/ops/fused_encoder.py:175"}
    sources = {"flash_attention": "flash_attention.cu", "t2i_flash": "fused_keys.cu", "i2t_ln_t2i": "fused_keys.cu",
               "fused_upscale_hypernet": "fused_upscale.cu", "fused_encoder_blocks": "fused_encoder.cu"}
    launches = {**main_counts, "fused_encoder_blocks": fused_counts["fused_encoder_blocks"]}
    print(json.dumps({"card": card, "interpolate_trilinear": {
        "route": "cuda", "source": "l4p_tpu_torch/csrc/resize.cu", "replaces": None, "resizes": resizes}}))
    print(json.dumps({"card": card, "vggt": vggt}))
    print(json.dumps({"card": card, "vda": vda}))
    print(json.dumps({"card": card, "einsum_fp32": {
        "route": "torch.bmm(out_dtype=float32)", "source": "l4p_tpu_torch/ops/conv.py",
        "products_per_request": track_products(cfg, TRACK_FRAMES, TRACK_QUERIES[0]),
        "products_read": products_read, "pe_products": products}}))
    print(json.dumps({"card": card, "kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"l4p_tpu_torch/csrc/{sources[name]}",
        "replaces": replaces[name],
        "launches": launches[name],
        **record[name],
    } for name in counters]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
