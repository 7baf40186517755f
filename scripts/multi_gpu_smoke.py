"""chip_smoke.py's phase 27 (multi-GPU) alone.

    python3 scripts/multi_gpu_smoke.py     # from the repository root; one card, or 2-4 for part (d)

Builds the four kernel libraries and the released giant model with random
bf16 weights (chip_smoke's phase 3), makes bench.py's all-task request (48
uint8 frames, their intrinsics, 128 queries) and runs chip_smoke's
`multi_gpu_phase`: (a) the kernels at the shapes a rank gives them, (b) the
giant encoder split over two processes on the first card against one
process, (c) the request on a one-rank NCCL mesh against no mesh, and (d)
where the machine has two or more cards the dry run and the request on
min(4, cards) cards, with frames/s at 192 x 128 on one card and on all of
them. Prints the phase's lines, its JSON record, and exits 1 if a check
failed. Every line names the card and its power limit.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as CS  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("multi_gpu_smoke: torch.cuda.is_available() is false; it needs a CUDA card", file=sys.stderr)
        return 1
    import l4p_tpu_torch as P
    from l4p_tpu_torch import _build
    from l4p_tpu_torch.ops import flash_attention as FA
    from l4p_tpu_torch.ops import fused_encoder as FE
    from l4p_tpu_torch.ops import fused_keys as FK
    from l4p_tpu_torch.ops import fused_upscale as FU

    card = CS.card_line()

    def log(msg: str) -> None:
        print(f"[{card}] {msg}", flush=True)

    checks = CS.Checks(log)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all({FA.NAME: FA.SOURCES, FK.NAME: FK.SOURCES, FU.NAME: FU.SOURCES, FE.NAME: FE.SOURCES})
    log(f"built the kernel libraries in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    cfg, model = CS.giant_model(P, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    hw = tuple(cfg.window_size[1:])
    request = {"rgb_u8_bthw3": torch.randint(0, 256, (1, CS.TRACK_FRAMES, *hw, 3), generator=gen, device=dev,
                                             dtype=torch.uint8),
               **CS.track_queries(CS.QUERY_CHUNK, CS.TRACK_FRAMES, hw, gen, dev),
               "intrinsics_b44t": CS.bench_intrinsics(CS.TRACK_FRAMES, hw, dev)}
    counters = {"flash_attention": FA.flash_attention, "t2i_flash": FK.t2i_flash, "i2t_ln_t2i": FK.i2t_ln_t2i,
                "fused_upscale_hypernet": FU.fused_upscale_hypernet, "fused_encoder_blocks": FE.fused_encoder_blocks}

    def reset_counts() -> None:
        for fn in counters.values():
            fn.launches = 0

    def counts() -> dict:
        return {name: fn.launches for name, fn in counters.items()}

    t0 = time.perf_counter()
    rec = CS.multi_gpu_phase(P, model, cfg, request, dev, log, checks, reset_counts, counts)
    print(json.dumps({"card": card, "multi_gpu": rec}), flush=True)
    log(f"phase 27 took {time.perf_counter() - t0:.1f} s; failed checks: {checks.failed}")
    return 1 if checks.failed else 0


if __name__ == "__main__":
    sys.exit(main())
