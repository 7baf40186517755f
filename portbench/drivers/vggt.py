"""Offline scene requests to VGGT through `InferenceSession.__call__`: a
closed loop with one client, each request one scene of uint8 frames from
the seed.

Traffic keys: `frames`, `height`, `width`, `tasks` (of camera, depth,
world_points), `sample` (requests compared with the reference, drawn from
the seed among the first `sample_from`) and `slice_requests` (requests in
the traced slice).

End-to-end: `video_fps`, the frames of every request completed in the
window over the window's time; the window closes when the first request
that ends at or after `--seconds` completes, and not before the sampled
requests have been served. A request that raises, or answers a pose
encoding, depth, point map or confidence that is not finite, is failed
(`intrinsic` is not checked: f = (size / 2) / tan(fov / 2) is infinite
where the camera head's ReLU'd field of view is 0, as a random head's is).

Weights are drawn per tensor from (seed, name) at portbench/weights.py's
scales, so the program and the reference get the same tensors whatever
order their modules register them in.

The comparison (`readings`): the sampled requests' depth (rms error of log
depth), point maps (relative L2), pose encodings (max abs error) and the
last aggregator output (`tokens`, relative L2) against the reference's own
forward; and stages from the program's own inputs: the camera head on the
program's camera tokens (`camera.pose`, max abs error), and the attention
of the first and the last frame and global blocks on the program's input
tokens (`frame0.attn`, `global0.attn`, ..., relative L2 of the heads'
outputs before the output projection and LayerScale, where random frames
and LayerScale gains of 0.02 leave the end-to-end numbers blind to global
attention).
"""

from __future__ import annotations

import json
import random
import time
import traceback
from typing import Dict

import torch

from portbench import trace
from portbench.drivers._common import all_finite, checks, dtype_of, free, nonfinite, rel_l2, rms_err, worst
from portbench.reference import vggt as ref
from portbench.stats import derive_seed, rate
from portbench.weights import ONE, layout
from portbench.work.vggt_flops import vggt_request_flops

CHECKED = ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf")


def seeded_weights(module, seed: int, device, dtype, rename=None) -> Dict[str, torch.Tensor]:
    """{name: tensor} for the module's state dict, each drawn U(-1, 1) from
    its own generator seeded by (seed, name), then scaled as layout() says;
    `rename` maps the module's names to the ones drawn and returned."""
    out = {}
    for name, shape, scale in layout(module):
        name = rename(name) if rename else name
        g = torch.Generator(device=device).manual_seed(derive_seed(seed, "weights", name))
        t = torch.empty(shape, device=device, dtype=dtype).uniform_(-1.0, 1.0, generator=g)
        out[name] = t.fill_(1.0) if scale == ONE else t.mul_(scale)
    return out


class Requests:
    """Request i of a seed: the same frames on every call, made on the device."""

    def __init__(self, seed: int, frames: int, height: int, width: int, device):
        self.seed, self.shape, self.device = seed, (1, frames, height, width, 3), device

    def __call__(self, i: int) -> Dict[str, torch.Tensor]:
        g = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, "request", i))
        return {"rgb_u8_bthw3": torch.randint(0, 256, self.shape, generator=g, device=self.device, dtype=torch.uint8)}


def stage_blocks(depth: int):
    """(name, kind, index) of the aggregator blocks compared from the
    program's inputs: the first and the last of each kind."""
    return [(f"{kind}{i}.attn", kind, i) for i in sorted({0, depth - 1}) for kind in ("frame", "global")]


class Tap:
    """Keeps, for one request, the last aggregator output, the camera
    head's input tokens (forward hooks on the program's modules), and for
    each of `stage_blocks` its input tokens and its attention's output (a
    pre-hook hands the block the session's attention function wrapped)."""

    def __init__(self, model):
        self.model, self.rec, self.hooks = model, {"blocks": {}}, []

    def __enter__(self):
        agg, last = self.model.aggregator, self.model.cfg.depth - 1

        def aggregator(mod, args, out):
            self.rec["tokens"] = out[last]

        def camera(mod, args, out):
            self.rec["camera_tokens"] = args[0]

        def block(name):
            def hook(mod, args, kwargs):
                x, attention = args[0], args[1]

                def tapped(q, k, v, scale):
                    o = attention(q, k, v, scale)
                    self.rec["blocks"][name] = (x, o)
                    return o

                return (x, tapped, *args[2:]), kwargs
            return hook

        self.hooks = [agg.register_forward_hook(aggregator), self.model.camera_head.register_forward_hook(camera)]
        for name, kind, i in stage_blocks(self.model.cfg.depth):
            blk = getattr(agg, f"{kind}_blocks")[i]
            self.hooks.append(blk.register_forward_pre_hook(block(name), with_kwargs=True))
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()
        return False


class Cell:
    """Set-up on construction: the program's VGGT with seeded weights, its
    session and two warm requests at the cell's shapes."""

    def __init__(self, ctx):
        from l4p_tpu_torch.config import load_model_config
        from l4p_tpu_torch.inference import InferenceSession
        from l4p_tpu_torch.models.vggt import VGGT, load_upstream_state_dict, upstream_name

        self.ctx, tr = ctx, ctx.traffic
        with open(ctx.config_path) as f:
            self.config = json.load(f)
        self.dtype = dtype_of(ctx, self.config)
        self.cfg, _ = load_model_config(str(ctx.config_path))
        self.tasks = tuple(tr["tasks"])
        dev = ctx.device
        self.requests = Requests(ctx.seed, tr["frames"], tr["height"], tr["width"], dev)
        ctx.mark("the program's modules")
        self.model = VGGT(self.cfg, device=dev, dtype=self.dtype).eval()
        self._sync()
        ctx.mark("the program's model built")
        load_upstream_state_dict(self.model, self._weights(self.model, self.dtype, upstream_name))
        self.session = InferenceSession(self.cfg, self.tasks, dev)
        self._sync()
        ctx.mark("the seeded weights loaded")
        rng = random.Random(derive_seed(ctx.seed, "sample"))
        self.sample = sorted(rng.sample(range(tr["sample_from"]), tr["sample"]))
        self.kept: Dict[int, tuple] = {}
        self.flops_per_request = vggt_request_flops(self.cfg, self.tasks, tr["frames"], tr["height"],
                                                    tr["width"])["total"]
        self._next = 0
        for i in (-1, -2):
            self.session(self.model, self.requests(i))
            self._sync()
            ctx.mark(f"warm request {i}")

    def _weights(self, model, dtype, rename=None):
        return seeded_weights(model, self.ctx.seed, self.ctx.device, dtype, rename)

    def _sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _serve(self, i: int):
        if i not in self.sample:
            return self.session(self.model, self.requests(i))
        with Tap(self.model) as tap:
            out = self.session(self.model, self.requests(i))
        self.kept[i] = (out, tap.rec)
        return out

    def window(self, seconds: float):
        from portbench.run import Window

        attempted = raised = 0
        flags, seconds_each = [], []
        t0 = last = time.perf_counter()
        while True:
            i = self._next
            self._next += 1
            attempted += 1
            try:
                out = self._serve(i)
                flags.append(all_finite(out[k] for k in CHECKED if k in out))
                del out
            except Exception:  # noqa: BLE001 - a request that raises is counted as failed, the loop goes on
                raised += 1
                self.ctx.log(f"request {i} raised:\n{traceback.format_exc()}")
            self._sync()
            now = time.perf_counter()
            seconds_each.append(now - last)
            last, elapsed = now, now - t0
            if elapsed >= seconds and self._next > max(self.sample):
                break
        failed = raised + sum(1 for f in flags if not bool(f))
        done = attempted - failed
        self.ctx.log("seconds a request: " + " ".join(f"{x:.4f}" for x in seconds_each))
        return Window(attempted, failed, elapsed, {"video_fps": rate(done * self.ctx.traffic["frames"], elapsed)},
                      flops=done * self.flops_per_request)

    def traced_slice(self):
        from l4p_tpu_torch.ops import flash_attention as fa

        sess = self.session
        spans = trace.Spans()
        attention = sess.attention
        sess.attention = spans.wrap("attention", attention, op=True)
        before = fa.flash_attention.launches
        n = self.ctx.traffic["slice_requests"]
        try:
            with trace.profiled(self.ctx.device) as box:
                for _ in range(n):
                    i = self._next
                    self._next += 1
                    self.session(self.model, self.requests(i))
        finally:
            sess.attention = attention
        if fa.flash_attention.launches - before != spans.calls["attention"]:
            raise RuntimeError(f"attention: {spans.calls['attention']} wrapped calls, "
                               f"{fa.flash_attention.launches - before} kernel launches")
        self.ctx.log(f"trace: {box['trace_bytes']} bytes, exported and read in {box['export_s']:.2f} s")
        return spans, trace.Reduced(box["events"]), n

    def serve_sample(self):
        """The sampled requests alone, served as the window serves them (for
        the readings that the limits are set from)."""
        for i in self.sample:
            self._serve(i)
        self._sync()

    def release(self):
        """Frees the program's state; keeps what the check compares."""
        self.model = self.session = None
        free(self.ctx.device)

    def readings(self, control: bool = False):
        """The numbers compared, each at its worst sampled request; with
        `control`, the control's numbers beside them."""
        self.release()
        with torch.inference_mode():
            return self._readings(control)

    def _readings(self, control: bool):
        from portbench.reference.l4p.ops.lowp import fp8_products

        ref.plain_fp32()
        with torch.device(self.ctx.device):
            model = ref.VGGT(ref.read_config(self.ctx.config_path)).eval()
        model.load_state_dict({k: v.float() for k, v in self._weights(model, self.dtype).items()}, strict=True)
        progs, ctls = [], []
        for i in self.sample:
            out, rec = self.kept[i]
            frames = self.requests(i)["rgb_u8_bthw3"]
            want = model(frames, self.tasks)
            for side, o in (("program", out), ("reference", want)):
                bad = nonfinite({k: v for k, v in o.items() if k != "intrinsic"})
                if bad:
                    self.ctx.log(f"request {i}: the {side}'s outputs hold values that are not finite: {bad}")
            nums = self.numbers(out, rec["tokens"], want)
            cam = rec.get("camera_tokens")
            if cam is not None:
                want_pose = model.camera_head(cam.float())
                nums["camera.pose"] = max_abs(out["pose_enc"], want_pose)
            stages = self.stages(model, rec["blocks"], frames.shape)
            nums.update({k: rel_l2(o, want_o) for k, (o, want_o) in stages.items()})
            progs.append(nums)
            if control:
                with fp8_products():
                    low = model(frames, self.tasks)
                    low_pose = model.camera_head(cam.float()) if cam is not None else None
                    low_stages = {k: v[1] for k, v in self.stages(model, rec["blocks"], frames.shape).items()}
                nums = self.numbers(low, low["tokens"], want)
                if low_pose is not None:
                    nums["camera.pose"] = max_abs(low_pose, want_pose)
                nums.update({k: rel_l2(low_stages[k], want_o) for k, (_, want_o) in stages.items()})
                ctls.append(nums)
                del low, low_stages
            del want, stages
        del model
        free(self.ctx.device)
        return worst(progs), (worst(ctls) if control else None)

    @staticmethod
    def stages(model, blocks, shape) -> Dict[str, tuple]:
        """{name: (the program's heads' outputs (B, N, C), the reference's
        from the same input tokens)} for each tapped block."""
        b, s, h, w, _ = shape
        pos = model.aggregator.positions(b * s, h, w, next(model.parameters()).device)
        out = {}
        for name, kind, i in stage_blocks(model.cfg.depth):
            if name not in blocks:
                continue
            x, o = blocks[name]
            blk = getattr(model.aggregator, f"{kind}_blocks")[i]
            n = x.shape[1]
            want = blk.attn.heads(blk.norm1(x.float()), pos.reshape(x.shape[0], n, 2))
            out[name] = (o.transpose(1, 2).reshape(want.shape), want)
        return out

    @staticmethod
    def numbers(out, tokens, want) -> Dict[str, float]:
        nums = {"tokens": rel_l2(tokens, want["tokens"])}
        if "depth" in want:
            nums["depth"] = rms_err(out["depth"].log(), want["depth"].log())
        if "world_points" in want:
            nums["world_points"] = rel_l2(out["world_points"], want["world_points"])
        if "pose_enc" in want:
            nums["pose_enc"] = max_abs(out["pose_enc"], want["pose_enc"])
        return nums

    def check(self):
        missing = [i for i in self.sample if i not in self.kept]
        if missing:  # an answer that never came: nothing to compare, and not correct
            self.release()
            return {"unanswered": {"value": float(len(missing)), "limit": 0.0}}
        return checks(self.readings()[0], self.ctx.limits)


def max_abs(prog: torch.Tensor, want: torch.Tensor) -> float:
    p, r = prog.detach().double(), want.detach().double().to(prog.device)
    if p.shape != r.shape:
        raise ValueError(f"shape {tuple(p.shape)} against the reference's {tuple(r.shape)}")
    return (p - r).abs().max().item()
