"""Where the time of one request of the PyTorch/CUDA port goes, on a CUDA card.

    python3 scripts/profile_port.py                       # bench.py's request: five tasks, default encoder
    python3 scripts/profile_port.py --fused-encoder       # the same request on the whole-encoder kernels
    python3 scripts/profile_port.py --both                # both points in one process, timed in turns
    python3 scripts/profile_port.py --frames 192          # bench.py's headline point

Builds the released giant model (configs/model.yaml values) with random bf16
weights from a seeded generator, serves bench.py's all-task request on the
config as loaded, whose encoder is the default one (48 uint8 frames,
bench.py's intrinsics, 128 queries, the five tasks), twice to warm up,
times TIMED requests on the host clock (each ending in a synchronise), then
traces one request with torch.profiler. With --both the same model serves
the default point and the fused point (encoder.fused_encoder), the timed
requests alternating between them. Prints, per point, the requests' times
and peak device memory, the traced request's wall time under the profiler,
the device's busy time (the kernels' summed device time; the port runs on
one stream) and idle share, and device time by kernel name. Every line
names the card and its power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import bench_intrinsics, card_line, track_queries  # noqa: E402

TIMED = 3  # requests timed without the profiler, after two warm-ups


def profile(sess, model, request, point: str, label: str, top: int, card: str) -> bool:
    """Traces one request; prints wall, busy and idle time and the top
    kernels by device time. False if the profiler saw no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sess(model, request)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0:
            rows.append((evt.self_device_time_total / 1e3, evt.count, evt.key))
    if not rows:
        print("profile_port: the profiler recorded no device time", file=sys.stderr)
        return False
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[{card}] {label}, {point} encoder: wall {wall:.1f} ms under the profiler, kernels busy {busy:.1f} ms, "
          f"device idle {100 * (1 - busy / wall):.1f}%")
    for ms, count, name in rows[:top]:
        print(f"[{card}] {point}: {ms:9.2f} ms {100 * ms / busy:5.1f}% x{count:<6d} {name[:150]}")
    return True


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--fused-encoder", action="store_true",
                    help="the whole-encoder kernels (encoder.fused_encoder) instead of bench.py's default encoder")
    ap.add_argument("--both", action="store_true", help="the default and the fused point, timed in turns")
    ap.add_argument("--top", type=int, default=25, help="kernel names to print")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA card", file=sys.stderr)
        return 1
    import l4p_tpu_torch as P

    card = card_line()
    dev = torch.device("cuda")
    cfg = P.L4PConfig()
    cfg = dataclasses.replace(cfg, track=dataclasses.replace(cfg.track, max_queries=args.queries))
    model = P.L4P(cfg, device=dev, dtype=torch.bfloat16).eval()
    gen = torch.Generator(device=dev).manual_seed(0)
    model.init_weights(gen)
    hw = tuple(cfg.window_size[1:])
    t, n = args.frames, args.queries
    request = {"rgb_u8_bthw3": torch.randint(0, 256, (1, t, *hw, 3), generator=gen, device=dev, dtype=torch.uint8),
               "intrinsics_b44t": bench_intrinsics(t, hw, dev), **track_queries(n, t, hw, gen, dev)}
    fused = (False, True) if args.both else (args.fused_encoder,)
    points = {("fused" if f else "default"): P.InferenceSession(
        dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, fused_encoder=f)), P.ALL_TASKS, dev)
        for f in fused}
    label = f"{t} frames x {n} queries, tasks {P.ALL_TASKS}"
    times = {point: [] for point in points}
    peak = {}
    for point, sess in points.items():
        for _ in range(2):
            sess(model, request)
        torch.cuda.synchronize()
    order = list(points)
    for rep in range(TIMED):
        for point in order if rep % 2 == 0 else order[::-1]:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            points[point](model, request)
            torch.cuda.synchronize()
            times[point].append((time.perf_counter() - t0) * 1e3)
            peak[point] = max(peak.get(point, 0), torch.cuda.max_memory_allocated())
    for point in points:
        print(f"[{card}] {t} frames x {n} queries, {point} encoder: requests "
              f"{', '.join(f'{x:.1f}' for x in times[point])} ms, best {min(times[point]):.1f} ms; peak device "
              f"memory {peak[point] / 2**30:.2f} GiB")
    for point, sess in points.items():
        if not profile(sess, model, request, point, label, args.top, card):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
