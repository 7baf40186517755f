"""Drive the PyTorch/CUDA port (l4p_tpu_torch) once on a CUDA card.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each of which raises (non-zero exit) when it fails:
  1. build the kernels (csrc/flash_attention.cu, fused_keys.cu,
     fused_upscale.cu) with nvcc for sm_90a, one nvcc per library, all
     started together, and print the build seconds and ptxas lines;
  2. hold each kernel against its plain PyTorch version and time both: the
     attention at the encoder's shape (2 windows x 16 heads, 2048 tokens,
     D=88) and at N=512, D=64; t2i_flash and i2t_ln_t2i at the track head's
     N=128 queries, P=2048, C=1408, K=48 and at a ragged N=3, P=1000;
     fused_upscale_hypernet at N=128, P=2048, C=1408, d1=352, d2=176, M=3
     and at N=3, P=1000; all bf16, each within the band stated below;
  3. build the released giant model (ViT-giant encoder, flow/depth/dyn_mask
     DPT heads and the track head, configs/model.yaml values) with random
     bf16 weights from a seeded generator, tracking 128 queries per chunk;
  4. serve uint8 dense requests of 48, 32 and 16 frames (3 of each, after a
     warm-up), checking shapes, finiteness, depth > 0 and that the encoder
     attention ran on its kernel 40 times per encoded window chunk;
  5. time the stages of the 48-frame dense request (encode, heads, stitch);
  6. serve the 48-frame dense request with the plain attention and hold the
     outputs against the kernel path's (SLICE_TOL);
  7. serve 48-frame requests with all four tasks (flow_2d_backward,
     track_2d, depth, dyn_mask) at 128 and 64 queries (3 each, after a
     warm-up) and once at 160 queries (two chunks of 128, padded); half the
     queries start at t = 0.5, half spread over the video. Checks: output
     keys and shapes, finite values, depth > 0, tracks inside the frame, and
     each kernel's launch count against its formula;
  8. time the stages of the 48-frame, 128-query request (encode, dense
     heads, stitch, track);
  9. serve that request on the plain path (plain attention and the plain
     versions of the track head's three kernels) and hold all six outputs
     against the kernel path's (SLICE_TOL, TRACK_BANDS).
Every line with a number names the card and its power limit. The last two
lines are the kernels' record and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

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
# per output: max |kernel path - plain path| <= SLICE_TOL * max |plain|. The
# two paths differ only in the kernels' bf16 rounding; through 40 blocks
# and the DPT heads that gave 0.7-1.5% of each output's largest value (a few
# bf16 steps) on an H100, and the band is about twice that
SLICE_TOL = 3e-2
# the track outputs against their plain path, as (max, 99th percentile) of
# |kernel path - plain path| over each output's largest value. Most entries
# agree to a bf16 step; a query whose re-query frame or heatmap peak moves
# carries the change through its later windows, so the largest differences
# sit on few entries. The first card run measured max 2.4e-3 / 3.7e-3 /
# 4.5e-2 and 99th percentile 5.8e-5 / 3.5e-4 / 7.5e-3 (traj / vis / depth);
# the bands are about twice that
TRACK_BANDS = {"track_2d_traj_est_bn2t": (5e-3, 1.2e-4), "track_2d_vis_est_bn1t": (8e-3, 7e-4),
               "track_2d_depth_est_bn1t": (9e-2, 1.5e-2)}
FRAMES = (48, 32, 16)
REPEATS = 3  # timed requests per video length / query count
TRACK_FRAMES = 48
QUERY_CHUNK = 128  # queries per track chunk (the benchmark's 48-frame, 128-query point)
TRACK_QUERIES = (128, 64)
PADDED_QUERIES = 160  # two chunks of 128, the second padded
DENSE_KEYS = {"flow_2d_backward_est_b2thw": 2, "depth_est_b1thw": 1, "dyn_mask_est_b1thw": 1}
TRACK_KEYS = {"track_2d_traj_est_bn2t": 2, "track_2d_vis_est_bn1t": 1, "track_2d_depth_est_bn1t": 1}


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


def compare_kernel(FA, shape, gen, log) -> dict:
    b, h, n, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
    scale = d ** -0.5
    out = FA.flash_attention(q, k, v, scale)
    plain = FA.flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    ms, plain_ms = alternate(lambda: FA.flash_attention(q, k, v, scale),
                             lambda: FA.flash_attention_plain(q, k, v, scale), 20)
    tflops = 4 * b * h * n * n * d / ms / 1e9
    log(f"attention {shape} bf16: max|kernel-plain| {err:.3g} (tol {KERNEL_TOL}); "
        f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms")
    if not math.isfinite(err) or err > KERNEL_TOL:
        raise AssertionError(f"kernel disagrees with the plain version at {shape}: {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def compare_track_kernel(name, kernel, plain, args, band, iters, log, flop=None, nbytes=None) -> dict:
    """Holds `kernel(*args)` against `plain(*args)` (one tensor or a tuple)
    within band * max|plain| for each output, then times both."""
    outs, refs = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    errs, ratios = [], []
    for o, r in zip(outs, refs):
        if o.shape != r.shape or not torch.isfinite(o).all():
            raise AssertionError(f"{name}: kernel output {tuple(o.shape)} is not finite or not {tuple(r.shape)}")
        err = (o.float() - r.float()).abs().max().item()
        errs.append(err)
        ratios.append(err / r.float().abs().max().item())
    del outs, refs
    ms, plain_ms = alternate(lambda: kernel(*args), lambda: plain(*args), iters)
    shape = tuple(args[0].shape)
    rate = ""
    if flop:
        rate += f", {flop / ms / 1e9:.1f} TFLOP/s"
    if nbytes:
        rate += f", {nbytes / ms / 1e6:.0f} GB/s of keys traffic"
    log(f"{name} src{shape} bf16: max|kernel-plain| {', '.join(f'{e:.4g}' for e in errs)} = "
        f"{', '.join(f'{x:.3g}' for x in ratios)} x max|plain| (band {band}); "
        f"kernel {ms:.4f} ms{rate}, plain {plain_ms:.4f} ms")
    if not all(math.isfinite(x) and x <= band for x in ratios):
        raise AssertionError(f"{name} disagrees with its plain version at {shape}: {ratios}")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}


def keys_operands(n, p, c, k, gen):
    """The two-way transformer kernels' operands with the factored prep's
    magnitudes: unit keys, logits of order one, K tokens of 8 heads."""
    def r(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    keys, st, spe = r(n, p, c), r(n, c, k, scale=c ** -0.5), r(n, p, k, dtype=torch.float32)
    i2t = (keys, r(n, c, k, scale=c ** -0.5), r(n, p, k, dtype=torch.float32), r(n, k, c, scale=0.2),
           r(c, scale=0.1), 1.0 + r(c, scale=0.1), r(c, scale=0.1), st, spe)
    return (keys, st, spe), i2t


def upscale_operands(n, p, c, d1, d2, m, gen):
    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()

    return (r(n, p, c), r(c, d1, 2, 2, 2, scale=c ** -0.5), r(d1, scale=0.1), 1.0 + r(d1, scale=0.1),
            r(d1, scale=0.1), r(d1, d2, 1, 2, 2, scale=d1 ** -0.5), r(d2, scale=0.1), r(n, m, d2, scale=0.1))


def check_outputs(out: dict, want: dict, frames: int, hw, queries=None) -> None:
    """Keys, shapes, finite values, depth > 0; with `queries` (1, N, 3) the
    track outputs too: depth > 0 from each query's frame on (earlier frames
    keep the buffer's 0) and tracks inside the frame."""
    if set(out) != set(want):
        raise AssertionError(f"output keys {sorted(out)}, expected {sorted(want)}")
    n_queries = 0 if queries is None else queries.shape[1]
    for key, c in want.items():
        x = out[key]
        shape = (1, n_queries, c, frames) if key.startswith("track_2d") else (1, c, frames, *hw)
        if tuple(x.shape) != shape:
            raise AssertionError(f"{key} has shape {tuple(x.shape)}, expected {shape}")
        if not torch.isfinite(x).all():
            raise AssertionError(f"{key} is not finite")
    if not (out["depth_est_b1thw"] > 0).all():
        raise AssertionError("depth is not positive")
    if queries is not None:
        started = torch.arange(frames, device=queries.device) + 0.5 >= queries[0, :, :1]  # (N, T)
        if not (out["track_2d_depth_est_bn1t"][0, :, 0][started] > 0).all():
            raise AssertionError("track depth is not positive")
        traj = out["track_2d_traj_est_bn2t"]  # (1, N, 2, T) as (x, y) pixels
        if traj.min() < 0 or (traj[:, :, 0] > hw[1]).any() or (traj[:, :, 1] > hw[0]).any():
            raise AssertionError("tracks leave the frame")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's smoke run needs a CUDA card",
              file=sys.stderr)
        return 1
    import l4p_tpu_torch as P
    from l4p_tpu_torch import _build
    from l4p_tpu_torch.models import l4p as PL
    from l4p_tpu_torch.ops import flash_attention as FA
    from l4p_tpu_torch.ops import fused_keys as FK
    from l4p_tpu_torch.ops import fused_upscale as FU

    card = card_line()
    print(f"card: {card}", flush=True)

    def log(msg: str) -> None:
        print(f"[{card}] {msg}", flush=True)

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    # fp32 reference lanes in full fp32: no TF32 in matmuls or cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. build, one nvcc per library, all at once
    libraries = {FA.NAME: FA.SOURCES, FK.NAME: FK.SOURCES, FU.NAME: FU.SOURCES}
    t0 = time.perf_counter()
    seconds = _build.build_all(libraries)
    log(f"built {len(libraries)} kernel libraries in {time.perf_counter() - t0:.2f} s wall: "
        + ", ".join(f"{name} {s:.2f} s" for name, s in seconds.items()))
    for name, sources in libraries.items():
        for line in _build.build_log(name, sources).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas {name}: {line.strip()}")

    # 2. each kernel against its plain version
    gen = torch.Generator(device=dev).manual_seed(0)
    record = {"flash_attention": compare_kernel(FA, (2, 16, 2048, 88), gen, log)}
    compare_kernel(FA, (1, 8, 512, 64), gen, log)
    heads = 8
    for n, p, c, k, giant in ((QUERY_CHUNK, 2048, 1408, 48, True), (3, 1000, 128, 48, False)):
        t2i_args, i2t_args = keys_operands(n, p, c, k, gen)
        iters = 10 if giant else 20
        keys_bytes = n * p * c * 2
        # t2i reads keys twice; i2t reads them, writes the new keys, reads them again
        r = compare_track_kernel("t2i_flash", FK.t2i_flash, FK.t2i_flash_plain, t2i_args, KEYS_BAND, iters, log,
                                 nbytes=2 * keys_bytes)
        r2 = compare_track_kernel("i2t_ln_t2i", lambda *a: FK.i2t_ln_t2i(*a, heads),
                                  lambda *a: FK.i2t_ln_t2i_plain(*a, heads), i2t_args, KEYS_BAND, iters, log,
                                  nbytes=3 * keys_bytes)
        if giant:
            record["t2i_flash"], record["i2t_ln_t2i"] = r, r2
        del t2i_args, i2t_args
    for n, p, c, d1, d2, giant in ((QUERY_CHUNK, 2048, 1408, 352, 176, True), (3, 1000, 64, 24, 12, False)):
        args = upscale_operands(n, p, c, d1, d2, 3, gen)
        flop = 2 * n * p * 8 * (c * d1 + 4 * d1 * d2)
        r = compare_track_kernel("fused_upscale_hypernet", FU.fused_upscale_hypernet, FU.fused_upscale_hypernet_plain,
                                 args, UPSCALE_BAND, 5 if giant else 20, log, flop=flop)
        if giant:
            record["fused_upscale_hypernet"] = r
        del args
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
        f"built in {time.perf_counter() - t0:.2f} s")

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
                "fused_upscale_hypernet": FU.fused_upscale_hypernet}

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
            if got != want:
                raise AssertionError(f"{got} kernel launches for {frames} frames, expected {want}")
            check_outputs(out, DENSE_KEYS, frames, hw)
        outputs[frames] = out
        best = min(times)
        log(f"dense request {frames} frames ({nw} windows, {want} attention kernel launches each): "
            f"{', '.join(f'{t:.4f}' for t in times)} s; best {best:.4f} s = {frames / best:.2f} frames/s")
    dense_counts = counts()
    if dense_counts["flash_attention"] == 0:
        raise AssertionError("the dense path never launched the attention kernel")
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

    # 6. the kernel path against the plain-attention path
    before = FA.flash_attention.launches
    ref = P.InferenceSession(cfg, dense_tasks, dev, attention=FA.flash_attention_plain)(
        model, {"rgb_u8_bthw3": videos[FRAMES[0]]})
    torch.cuda.synchronize()
    if FA.flash_attention.launches != before:
        raise AssertionError("the plain-attention session launched the kernel")
    for key, r in ref.items():
        err = (outputs[FRAMES[0]][key].float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        band = SLICE_TOL * scale
        log(f"48-frame {key}: max|kernel path - plain path| {err:.4g} (band {band:.3g}, output max {scale:.4g})")
        if not math.isfinite(err) or err > band:
            raise AssertionError(f"{key}: kernel path differs from the plain path by {err}")
    del outputs, ref

    # 7. the track path: all four tasks through the session, counting every kernel
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

    def expected(n_queries: int) -> dict:
        chunks = math.ceil(n_queries / QUERY_CHUNK)
        return {"flash_attention": cfg.encoder.depth * math.ceil(nw / cfg.enc_window_chunk),
                "t2i_flash": nw * chunks, "i2t_ln_t2i": 2 * nw * chunks, "fused_upscale_hypernet": nw * chunks}

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
            if got != expected(n):
                raise AssertionError(f"kernel launches {got} at {n} queries, expected {expected(n)}")
            check_outputs(out, {**DENSE_KEYS, **TRACK_KEYS}, TRACK_FRAMES, hw,
                          requests[n]["track_2d_pointquerries_bn3"])
        if n == TRACK_QUERIES[0]:
            track_out = out
        best = min(times)
        log(f"track request {TRACK_FRAMES} frames x {n} queries ({math.ceil(n / QUERY_CHUNK)} chunk(s), {nw} windows, "
            f"launches {expected(n)}): {', '.join(f'{t:.4f}' for t in times)} s; best {best:.4f} s = "
            f"{TRACK_FRAMES / best:.2f} frames/s, {n * TRACK_FRAMES / best:.0f} query-frames/s")
    track_counts = counts()
    missing = [name for name, c in track_counts.items() if c == 0]
    if missing:
        raise AssertionError(f"the track path never launched {missing}")
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
    if counts() != before:
        raise AssertionError("the plain-path session launched a kernel")
    for key, r in ref.items():
        diff = (track_out[key].float() - r.float()).abs()
        err = diff.max().item()
        scale = r.float().abs().max().item()
        what = f"{TRACK_FRAMES}-frame {TRACK_QUERIES[0]}-query {key}: max|kernel path - plain path| {err:.4g}"
        if key in TRACK_BANDS:
            band, p99_band = (b * scale for b in TRACK_BANDS[key])
            p99 = diff.flatten().quantile(0.99).item()
            log(f"{what} (band {band:.3g}), median {diff.median().item():.4g}, 99th pct {p99:.4g} "
                f"(band {p99_band:.3g}), output max {scale:.4g}")
            ok = math.isfinite(err) and err <= band and p99 <= p99_band
        else:
            band = SLICE_TOL * scale
            log(f"{what} (band {band:.3g}, output max {scale:.4g})")
            ok = math.isfinite(err) and err <= band
        if not ok:
            raise AssertionError(f"{key}: kernel path differs from the plain path by {err}")
    log(f"chip_smoke phases took {time.perf_counter() - t_start:.1f} s")

    replaces = {"flash_attention": "l4p_tpu/ops/flash_attention.py:22",
                "t2i_flash": "l4p_tpu/ops/fused_keys.py:94",
                "i2t_ln_t2i": "l4p_tpu/ops/fused_keys.py:100",
                "fused_upscale_hypernet": "l4p_tpu/ops/fused_upscale.py:104"}
    sources = {"flash_attention": "flash_attention.cu", "t2i_flash": "fused_keys.cu", "i2t_ln_t2i": "fused_keys.cu",
               "fused_upscale_hypernet": "fused_upscale.cu"}
    print(json.dumps({"card": card, "kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"l4p_tpu_torch/csrc/{sources[name]}",
        "replaces": replaces[name],
        "launches": track_counts[name],
        **record[name],
    } for name in counters]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
