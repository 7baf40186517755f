"""Drive the PyTorch/CUDA port (l4p_tpu_torch) once on a CUDA card.

    python3 chip_smoke.py        # from the repository root, one card

Phases; a failed check fails the run (non-zero exit, no result lines):
  1. build the kernels (csrc/flash_attention.cu, fused_keys.cu,
     fused_upscale.cu, fused_encoder.cu) with nvcc for sm_90a, one nvcc per
     library, all started together, and print the build seconds and ptxas
     lines;
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
     farther from them than the plain version, KEYS_WITNESS_SLACK);
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
     plain path's on average (WITNESS_SLACK) and every request's kernel path
     against its plain path within TRACK_BANDS;
 10. bench.py's request as bench.py runs it: 48 frames, intrinsics as
     bench.py builds them, 128 queries, all five tasks and the joint Sim(3)
     stitch on the config as loaded, whose encoder is the default one (a
     warm-up and 3 timed requests), checking outputs and every kernel's
     launches: the attention 40 times per encoded window chunk,
     fused_encoder_blocks never, the track kernels as in phase 7; then a
     second, labelled point: the same request with encoder.fused_encoder=True
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
     whose 99th percentile must stay within WITNESS_SLACK of the plain
     path's against its fp32-attention run; and phase 9's witness, each
     path against its own fp32-attention run (WITNESS_SLACK);
 24. the giant encoder with the option branches, two models with seeded
     bf16 weights: (a) cosine attention, LayerScale 0.1, learnable
     positions and the camera embedding at the input, added; (b) the
     embedding on the outputs, concatenated. The dense tasks on 48 frames
     with bench.py's intrinsics and the eval protocol's trajectory as
     extrinsics, timed in turns with the default encoder, the attention's
     launches counted (the kernel takes cosine attention at scale 1), each held
     against its plain path (SLICE_TOL); fused_encoder with (a) raises.
Every line with a number names the card and its power limit. The last two
lines are the kernels' record and {"ok": true, "device": {...}}. A kernel's
`launches` is its count over bench.py's request (phase 10's first point,
the counts set to 0 just before it), fused_encoder_blocks' over the fused
point, the path that runs it (phases 16-18 and 20 check their own counts); fused_encoder_blocks' entry also holds
`products`, each block product's kernel ms beside torch.matmul's and the
gemm_nt wrapper's.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
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
# request. Over chip_smoke's two requests and the witness's six (below),
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
# kernel that is the less accurate one; one request's ratio ranged 0.35-1.38
# on an H100 (the kernel's means 0.65 / 0.44 / 0.94 of the plain path's,
# the earlier mma.sync kernel's 1.19 / 1.2 / 1.0)
WITNESS_REQUESTS = 6
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
        return (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()

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
            launch = FE._gemm_call(FE._kernels()[1], a, w, bias, out, None, epilogue, *shape,
                                   torch.cuda.current_stream().cuda_stream)
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
        for key, r in ref.items():
            if key in TRACK_KEYS:
                kernel, plain = spread(out[key], fp32["kernel"][key]), spread(r, fp32["plain"][key])
                both, track = spread(out[key], r), spread(out[key], attn_k[key])
                log(f"eval {name} {key}, (max, 99th pct) / output max {r.float().abs().max().item():.4g}: kernel "
                    f"path - plain path ({both[0]:.3g}, {both[1]:.3g}) (TRACK_BANDS {TRACK_BANDS[key]}); kernel "
                    f"path - plain track kernels ({track[0]:.3g}, {track[1]:.3g}); against its fp32-attention "
                    f"run, kernel path ({kernel[0]:.3g}, {kernel[1]:.3g}), plain path ({plain[0]:.3g}, "
                    f"{plain[1]:.3g}) (99th pcts within {WITNESS_SLACK}x the plain path's)")
                checks.expect(math.isfinite(both[0]) and kernel[1] <= WITNESS_SLACK * plain[1],
                              f"eval {name} {key}: the kernel path is farther from its fp32-attention run than the "
                              f"plain path: {kernel} against {plain}")
                checks.expect(math.isfinite(track[0]) and track[1] <= WITNESS_SLACK * plain[1],
                              f"eval {name} {key}: the track kernels move the tracks farther than the plain "
                              f"path's attention precision does: {track} against {plain}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's smoke run needs a CUDA card",
              file=sys.stderr)
        return 1
    import l4p_tpu_torch as P
    from l4p_tpu_torch import _build
    from l4p_tpu_torch.geometry import core as GC
    from l4p_tpu_torch.models import l4p as PL
    from l4p_tpu_torch.ops import flash_attention as FA
    from l4p_tpu_torch.ops import fused_encoder as FE
    from l4p_tpu_torch.ops import fused_keys as FK
    from l4p_tpu_torch.ops import fused_upscale as FU

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
    libraries = {FA.NAME: FA.SOURCES, FK.NAME: FK.SOURCES, FU.NAME: FU.SOURCES, FE.NAME: FE.SOURCES}
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
    torch.cuda.empty_cache()

    # 3. the released giant model, random bf16 weights
    cfg = P.L4PConfig()
    cfg = dataclasses.replace(cfg, track=dataclasses.replace(cfg.track, max_queries=QUERY_CHUNK))
    t0 = time.perf_counter()
    model = P.L4P(cfg, device=dev, dtype=torch.bfloat16).eval()
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
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
        for _ in range(REPEATS):
            before = FA.flash_attention.launches
            t0 = time.perf_counter()
            out = sess(model, {"rgb_u8_bthw3": videos[frames]})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got = FA.flash_attention.launches - before
            checks.expect(got == want, f"{got} kernel launches for {frames} frames, expected {want}")
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
            before = counts()
            t0 = time.perf_counter()
            out = sess(model, requests[n])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got = {name: c - before[name] for name, c in counts().items()}
            checks.expect(got == expected(n, False), f"kernel launches {got} at {n} queries, "
                                                     f"expected {expected(n, False)}")
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
        worst = tuple(max(v[i] for v in rows["kernel - plain"]) for i in range(2))
        ratio = mean["kernel"] / mean["plain"]
        log(f"witness {key} over {WITNESS_REQUESTS} requests: mean 99th pct / output max against its fp32-attention "
            f"run, kernel path {mean['kernel']:.3g}, plain path {mean['plain']:.3g} (ratio {ratio:.3g}, within "
            f"{WITNESS_SLACK}); kernel path against plain path, largest (max, 99th pct) ({worst[0]:.3g}, "
            f"{worst[1]:.3g}) (bands {TRACK_BANDS[key]})")
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
        for _ in range(REPEATS):
            before = counts()
            t0 = time.perf_counter()
            out = sess_a(model, request)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got = {name: c_ - before[name] for name, c_ in counts().items()}
            checks.expect(got == expected(n_q, fused), f"kernel launches {got} on the all-task request ({label}), "
                                                       f"expected {expected(n_q, fused)}")
            check_outputs(out, {**DENSE_KEYS, **TRACK_KEYS, **CAMRAY_KEYS}, TRACK_FRAMES, hw, checks,
                          request["track_2d_pointquerries_bn3"])
        got_counts = counts()
        inner = FE.fused_encoder_blocks.kernel_launches - inner0
        best = min(times)
        log(f"all-task request {TRACK_FRAMES} frames x {n_q} queries, tasks {P.ALL_TASKS}, {label}, joint "
            f"alignment ({nw} windows, launches {expected(n_q, fused)}, {inner // REPEATS} kernel launches inside "
            f"fused_encoder_blocks): {', '.join(f'{t:.4f}' for t in times)} s; best {best:.4f} s = "
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
