"""Offline clip requests to Video Depth Anything through
`InferenceSession.__call__`: a closed loop with one client, each request one
clip of uint8 frames from the seed, served in windows and stitched.

Traffic keys: `frames` (the clip's length), `height`, `width`, `tasks`
(`depth`), `sample` (requests compared with the reference, drawn from the
seed among the first `sample_from`) and `slice_requests` (requests in the
traced slice).

End-to-end: `video_fps`, the clip frames of every request completed in the
window over the window's time (a clip's frames, not the windows' encoded
ones); the window closes when the first request that ends at or after
`--seconds` completes, and not before the sampled requests have been
served. A request that raises, or answers a depth that is not finite, is
failed.

Weights are drawn per tensor from (seed, name) at portbench/weights.py's
scales, as for VGGT (drivers/vggt.py), but for the motion modules'
frame-position tables (`pos_encoder.pe`), which are upstream's formula on
both sides, and the depth head's last convolution (`POSITIVE`), whose
weights and bias are the draws' magnitudes: on a random head of either sign
the model's final ReLU leaves every pixel of a clip 0 for about half the
seeds, where a trained head answers a positive relative depth.

The comparison (`readings`), each at its worst sampled request: the
stitched clip (`depth`) and window 0's raw depth (`window0.depth`), relative
L2 against the reference's own inference of the same frames; the stitch's
fits (`stitch.scale`: the largest relative error of a window's scale;
`stitch.shift`: the largest error of a window's shift over the root mean
square of the program's clip depth) of the reference's stitch run on the
program's own raw window outputs, against the program's; and each motion
module's first temporal attention in window 0 (`motion0.attn` ..
`motion3.attn`, relative L2 of the heads' outputs before `to_out`),
recomputed by the reference from the program's own input to that block:
random frames and seeded gains can leave the end-to-end numbers blind to
the temporal path.
"""

from __future__ import annotations

import json
import math
import random
import time
import traceback
from typing import Dict

import torch

from portbench import trace
from portbench.drivers._common import all_finite, checks, dtype_of, free, nonfinite, rel_l2, worst
from portbench.drivers.vggt import Requests, seeded_weights
from portbench.reference import vda as ref
from portbench.stats import derive_seed, rate
from portbench.work.vda_flops import vda_request_flops

TABLE = ".pe"  # the frame-position tables: upstream's formula, not drawn
# the depth head's last convolution, drawn positive (its magnitudes at weights.py's scales)
POSITIVE = ("head.scratch.output_conv2.2.weight", "head.scratch.output_conv2.2.bias")


class Tap:
    """Keeps, for one request, the windows' raw depth and the stitch's fits
    (the program's `stitch_windows` wrapped), and for each motion module
    the input tokens of its first transformer block and the output of that
    block's first attention call, in the first window (a pre-hook hands the
    block the session's attention function wrapped)."""

    def __init__(self, model):
        self.model, self.rec, self.hooks = model, {"motion": {}}, []

    def __enter__(self):
        from l4p_tpu_torch.models import vda

        self.module, self.stitch = vda, vda.stitch_windows

        def stitch(windows, length):
            out = self.stitch(windows, length)
            self.rec["windows"], self.rec["fits"] = [w.clone() for w in windows], out[1]
            return out

        def block(i):
            def hook(mod, args, kwargs):
                if i in self.rec["motion"]:
                    return None
                x, attention = args[0], args[1]

                def tapped(q, k, v, scale):
                    o = attention(q, k, v, scale)
                    self.rec["motion"].setdefault(i, (x, o))
                    return o

                return (x, tapped, *args[2:]), kwargs
            return hook

        vda.stitch_windows = stitch
        for i, mm in enumerate(self.model.head.motion_modules):
            blk = mm.temporal_transformer.transformer_blocks[0]
            self.hooks.append(blk.register_forward_pre_hook(block(i), with_kwargs=True))
        return self

    def __exit__(self, *exc):
        self.module.stitch_windows = self.stitch
        for h in self.hooks:
            h.remove()
        return False


class Cell:
    """Set-up on construction: the program's model with seeded weights, its
    session and two warm requests at the cell's shapes."""

    def __init__(self, ctx):
        from l4p_tpu_torch.config import load_model_config
        from l4p_tpu_torch.inference import InferenceSession
        from l4p_tpu_torch.models.vda import VideoDepthAnything, load_upstream_state_dict, upstream_name

        self.ctx, tr = ctx, ctx.traffic
        with open(ctx.config_path) as f:
            self.config = json.load(f)
        self.dtype = dtype_of(ctx, self.config)
        self.cfg, _ = load_model_config(str(ctx.config_path))
        self.tasks = tuple(tr["tasks"])
        dev = ctx.device
        self.requests = Requests(ctx.seed, tr["frames"], tr["height"], tr["width"], dev)
        ctx.mark("the program's modules")
        self.model = VideoDepthAnything(self.cfg, device=dev, dtype=self.dtype).eval()
        self._sync()
        ctx.mark("the program's model built")
        load_upstream_state_dict(self.model, self._weights(self.model, self.dtype, upstream_name))
        self.session = InferenceSession(self.cfg, self.tasks, dev)
        self._sync()
        ctx.mark("the seeded weights loaded")
        rng = random.Random(derive_seed(ctx.seed, "sample"))
        self.sample = sorted(rng.sample(range(tr["sample_from"]), tr["sample"]))
        self.kept: Dict[int, tuple] = {}
        self.flops_per_request = vda_request_flops(self.cfg, tr["frames"], tr["height"], tr["width"])["total"]
        self._next = 0
        for i in (-1, -2):
            self.session(self.model, self.requests(i))
            self._sync()
            ctx.mark(f"warm request {i}")

    def _weights(self, model, dtype, rename=None):
        """The seeded tensors, the depth head's last convolution positive,
        and the module's own frame-position tables."""
        out = seeded_weights(model, self.ctx.seed, self.ctx.device, dtype, rename)
        for k in POSITIVE:
            out[k] = out[k].abs()
        out.update({(rename(k) if rename else k): v for k, v in model.state_dict().items() if k.endswith(TABLE)})
        return out

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
                flags.append(all_finite([out["depth"]]))
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
            model = ref.VideoDepthAnything(ref.read_config(self.ctx.config_path)).eval()
        model.load_state_dict({k: v.float() for k, v in self._weights(model, self.dtype).items()}, strict=True)
        progs, ctls = [], []
        for i in self.sample:
            out, rec = self.kept[i]
            frames = self.requests(i)["rgb_u8_bthw3"]
            want_depth, want_windows, _ = model.infer_video_depth(frames)
            bad = nonfinite({"program": out["depth"], "reference": want_depth})
            if bad:
                self.ctx.log(f"request {i}: values that are not finite: {bad}")
            rms = out["depth"].double().square().mean().sqrt().item()
            ref_fits = self.fits(rec["windows"], frames.shape[1])
            stages = self.stages(model, rec["motion"])
            nums = self.numbers(out["depth"], rec["windows"][0][0], want_depth, want_windows[0])
            nums.update(self.fit_errors(rec["fits"], ref_fits, rms))
            nums.update({k: rel_l2(o, want_o) for k, (o, want_o) in stages.items()})
            progs.append(nums)
            if control:
                with fp8_products():
                    low_depth, low_windows, _ = model.infer_video_depth(frames)
                    low_fits = self.fits(rec["windows"], frames.shape[1])
                    low_stages = {k: v[1] for k, v in self.stages(model, rec["motion"]).items()}
                nums = self.numbers(low_depth, low_windows[0], want_depth, want_windows[0])
                nums.update(self.fit_errors(low_fits, ref_fits, rms))
                nums.update({k: rel_l2(low_stages[k], want_o) for k, (_, want_o) in stages.items()})
                ctls.append(nums)
                del low_depth, low_windows, low_stages
            del want_depth, want_windows, stages
        del model
        free(self.ctx.device)
        return worst(progs), (worst(ctls) if control else None)

    @staticmethod
    def fits(windows, length: int) -> torch.Tensor:
        """The reference's stitch run on the program's raw windows (each (1,
        T, H, W)): its fits (1, n - 1, 2)."""
        return ref.align([f for w in windows for f in w[0].float()], length)[1][None]

    @staticmethod
    def stages(model, motion) -> Dict[str, tuple]:
        """{name: (the program's heads' outputs (P, T, C), the reference's
        from the same block input)} for each tapped motion module."""
        out = {}
        for i, (x, o) in sorted(motion.items()):
            blk = model.head.motion_modules[i].temporal_transformer.transformer_blocks[0]
            p, t, c = x.shape
            up = x.float().view(1, p, t, c).transpose(1, 2).reshape(t, p, c)  # (b d) f c -> (b f) d c, b = 1
            want = blk.attention_blocks[0].heads_out(blk.norms[0](up), video_length=t)
            out[f"motion{i}.attn"] = (o.transpose(1, 2).reshape(p, t, c), want)
        return out

    @staticmethod
    def numbers(depth, window0, want_depth, want_window0) -> Dict[str, float]:
        return {"depth": rel_l2(depth, want_depth), "window0.depth": rel_l2(window0, want_window0)}

    @staticmethod
    def fit_errors(got: torch.Tensor, want: torch.Tensor, rms: float) -> Dict[str, float]:
        """The largest relative error of a window's scale, and of its shift
        over the clip depth's root mean square; nothing for a one-window clip."""
        if not want.numel():
            return {}
        got, want = got.double(), want.double().to(got.device)
        scale = ((got[..., 0] - want[..., 0]).abs() / want[..., 0].abs()).max().item()
        shift = (got[..., 1] - want[..., 1]).abs().max().item() / rms if rms > 0 else math.inf
        return {"stitch.scale": scale if math.isfinite(scale) else math.inf, "stitch.shift": shift}

    def check(self):
        missing = [i for i in self.sample if i not in self.kept]
        if missing:  # an answer that never came: nothing to compare, and not correct
            self.release()
            return {"unanswered": {"value": float(len(missing)), "limit": 0.0}}
        return checks(self.readings()[0], self.ctx.limits)
