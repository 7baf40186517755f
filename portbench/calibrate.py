"""The readings the correctness limits are set from (limits/<cell>.json):
the program's numbers on each of `--seeds` and the control's (the reference
under fp8 products) on each of `--control-seeds`, at the cell's own sizes
and requests, in one process. Needs the card the cell runs on; the
benchmark's own runs never call it.

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,... --control-seeds 1,2,3 [--out file.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import manifest as mf
from portbench.drivers._common import free
from portbench.run import Context, fixed_cache_dirs


def readings(bench: mf.Manifest, workload: str, seed: int, control: bool, device="cuda", dtype=None) -> dict:
    cell = bench.cell(workload)
    traffic = bench.traffic(cell["traffic"])
    ctx = Context(cell, traffic, bench.config_path(cell["config"]), {}, seed, 0.0, False, torch.device(device),
                  dtype, time.perf_counter())
    served = mf.driver(traffic["driver"]).Cell(ctx)
    served.serve_sample()
    prog, ctl = served.readings(control)
    del served
    free(ctx.device)
    return {"seed": seed, "program": prog, "control": ctl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    fixed_cache_dirs(mf.ROOT)
    bench = mf.Manifest.load()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    recs = []
    for seed in seeds + sorted(ctl - set(seeds)):
        t0 = time.perf_counter()
        rec = readings(bench, args.workload, seed, seed in ctl)
        rec["seconds"] = time.perf_counter() - t0
        if seed not in seeds:
            rec["program"] = None
        print(json.dumps(rec), flush=True)
        recs.append(rec)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(recs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
