"""Drive the PyTorch/CUDA port (l4p_tpu_torch) once on a CUDA card.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each of which raises (non-zero exit) when it fails:
  1. build csrc/flash_attention.cu with nvcc (sm_90a) and load it;
  2. hold the attention kernel against its plain PyTorch version at the
     encoder's shape (2 windows x 16 heads, 2048 tokens, D=88, bf16) and at
     N=512, D=64, and time both;
  3. build the released giant model (ViT-giant encoder + flow/depth/dyn_mask
     DPT heads, configs/model.yaml values) with random bf16 weights from a
     seeded generator;
  4. serve uint8 requests of 48, 32 and 16 frames (3 of each, after a
     warm-up) through InferenceSession, checking shapes, finiteness,
     depth > 0 and that the encoder attention ran on the kernel 40 times per
     encoded window chunk;
  5. time the stages of the 48-frame request (encode, heads, stitch);
  6. serve the 48-frame request again with the plain attention and hold the
     outputs against the kernel path's within a bf16 band (SLICE_TOL).
Every line with a number names the card and its power limit. The last two
lines are the kernels' record and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
# per output: max |kernel path - plain path| <= SLICE_TOL * max |plain|. The
# two paths differ only in the attention's bf16 rounding; through 40 blocks
# and the DPT heads that gave 0.7-1.5% of each output's largest value (a few
# bf16 steps) on an H100, and the band is about twice that
SLICE_TOL = 3e-2
FRAMES = (48, 32, 16)
REPEATS = 3  # timed requests per video length


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


def compare_kernel(FA, shape, gen, log) -> dict:
    b, h, n, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
    scale = d ** -0.5
    out = FA.flash_attention(q, k, v, scale)
    plain = FA.flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    # alternate plain / kernel / kernel / plain in one process
    t_plain1 = time_ms(lambda: FA.flash_attention_plain(q, k, v, scale))
    t_k1 = time_ms(lambda: FA.flash_attention(q, k, v, scale))
    t_k2 = time_ms(lambda: FA.flash_attention(q, k, v, scale))
    t_plain2 = time_ms(lambda: FA.flash_attention_plain(q, k, v, scale))
    ms, plain_ms = (t_k1 + t_k2) / 2, (t_plain1 + t_plain2) / 2
    tflops = 4 * b * h * n * n * d / ms / 1e9
    log(f"attention {shape} bf16: max|kernel-plain| {err:.3g} (tol {KERNEL_TOL}); "
        f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms")
    if not math.isfinite(err) or err > KERNEL_TOL:
        raise AssertionError(f"kernel disagrees with the plain version at {shape}: {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_outputs(out: dict, frames: int, hw) -> None:
    want = {"flow_2d_backward_est_b2thw": 2, "depth_est_b1thw": 1, "dyn_mask_est_b1thw": 1}
    if set(out) != set(want):
        raise AssertionError(f"output keys {sorted(out)}")
    for key, c in want.items():
        x = out[key]
        if tuple(x.shape) != (1, c, frames, *hw):
            raise AssertionError(f"{key} has shape {tuple(x.shape)}")
        if not torch.isfinite(x).all():
            raise AssertionError(f"{key} is not finite")
    if not (out["depth_est_b1thw"] > 0).all():
        raise AssertionError("depth is not positive")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's smoke run needs a CUDA card",
              file=sys.stderr)
        return 1
    import l4p_tpu_torch as P
    from l4p_tpu_torch import _build
    from l4p_tpu_torch.models import l4p as PL
    from l4p_tpu_torch.ops import flash_attention as FA

    card = card_line()
    print(f"card: {card}", flush=True)

    def log(msg: str) -> None:
        print(f"[{card}] {msg}", flush=True)

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    # fp32 reference lanes in full fp32: no TF32 in matmuls or cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. build
    t0 = time.perf_counter()
    FA._kernel()
    log(f"built {FA.SOURCES[0]} in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log(FA.NAME, FA.SOURCES).splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    # 2. kernel vs plain
    gen = torch.Generator(device=dev).manual_seed(0)
    giant_attn = compare_kernel(FA, (2, 16, 2048, 88), gen, log)
    compare_kernel(FA, (1, 8, 512, 64), gen, log)

    # 3. the released giant model, random bf16 weights
    cfg, tasks = P.L4PConfig(), P.SLICE_TASKS
    t0 = time.perf_counter()
    model = P.L4P(cfg, device=dev, dtype=torch.bfloat16).eval()
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"giant model: {n_params / 1e9:.3f} B parameters, built in {time.perf_counter() - t0:.2f} s")

    hw = tuple(cfg.window_size[1:])
    videos = {
        t: torch.randint(0, 256, (1, t, *hw, 3), generator=gen, device=dev, dtype=torch.uint8) for t in FRAMES
    }
    sess = P.InferenceSession(cfg, tasks, dev)
    t0 = time.perf_counter()
    sess(model, {"rgb_u8_bthw3": videos[FRAMES[0]]})  # chunks of 2 and of 1 window
    torch.cuda.synchronize()
    log(f"warm-up request ({FRAMES[0]} frames, first cuDNN/cuBLAS use of each shape): "
        f"{time.perf_counter() - t0:.3f} s")

    # 4. the main path: requests through the session, counting kernel launches
    torch.cuda.reset_peak_memory_stats()
    FA.flash_attention.launches = 0
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
            check_outputs(out, frames, hw)
        outputs[frames] = out
        best = min(times)
        log(f"request {frames} frames ({nw} windows, {want} attention kernel launches each): "
            f"{', '.join(f'{t:.4f}' for t in times)} s; best {best:.4f} s = {frames / best:.2f} frames/s")
    main_launches = FA.flash_attention.launches
    if main_launches == 0:
        raise AssertionError("the main path never launched the attention kernel")
    log(f"peak device memory over the requests: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 5. where the time of the 48-frame request goes
    with torch.inference_mode():
        data = videos[FRAMES[0]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = PL.encode_windows(model.video_encoder, cfg, rgb_u8_bthw3=data)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dense = {t: PL.run_dense_head(model.task_heads[t], enc["hooks"], tuple(cfg.window_size),
                                      cfg.dense_window_chunk) for t in tasks}
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        PL.stitch_dense_outputs(cfg, tasks, dense, cfg.window_stride_t, FRAMES[0])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del enc, dense
    log(f"48-frame stages: encode {t1 - t0:.4f} s, dense heads {t2 - t1:.4f} s, stitch {t3 - t2:.4f} s")

    # 6. the kernel path against the plain-attention path
    before = FA.flash_attention.launches
    ref = P.InferenceSession(cfg, tasks, dev, attention=FA.flash_attention_plain)(
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

    print(json.dumps({"card": card, "kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "l4p_tpu_torch/csrc/flash_attention.cu",
        "replaces": "l4p_tpu/ops/flash_attention.py:22",
        "launches": main_launches,
        **giant_attn,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
