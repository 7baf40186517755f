"""Offline requests through `InferenceSession.__call__`: a closed loop with
one client, each request one clip of uint8 frames from the seed.

Traffic keys: `frames`, `queries` (0: no track_2d), `tasks`,
`query_margin_px` (query positions uniform in [margin, size - margin], times
uniform over the clip's frames), `sample` (requests compared with the
reference, drawn from the seed among the first `sample_from`), and
`slice_requests` (clips in the traced slice).

End-to-end: `video_fps`, the frames of every clip completed in the window
over the window's time; the window closes when the first clip that ends at
or after `--seconds` completes, and not before the sampled clips have been
served (at the cells' sizes the first six take about six seconds).

The comparison goes stage by stage (`readings`): the encoder and the heads
against the reference's own forward of the sampled requests; the camera
solve, the stitch and two steps of the track scan recomputed by the
reference from the program's own inputs to them (with random weights the
RANSACs flip between hypotheses on rounding); the track outputs against
the steps that emitted them.
"""

from __future__ import annotations

import random
import time
import traceback
from typing import Dict, Tuple

import torch

from portbench import trace
from portbench.drivers._common import (all_finite, checks, dtype_of, free, nonfinite, plain_fp32, rel_l2,
                                       rms_err, worst)
from portbench.reference.l4p.models.l4p import RandomDraws
from portbench.stats import derive_seed, rate
from portbench.weights import seeded_state_dict
from portbench.work.flops import alltask_video_flops

SHORT = {
    "flow_2d_backward_est_b2thw": "flow",
    "depth_est_b1thw": "depth",
    "dyn_mask_est_b1thw": "dyn_mask",
    "traj3d_est_b16t": "pose",
    "traj3d_intrinsics_est_b16t": "intrinsics",
    "track_2d_traj_est_bn2t": "track_xy",
    "track_2d_vis_est_bn1t": "track_vis",
    "track_2d_depth_est_bn1t": "track_depth",
}
STAGES = ("encode_windows", "run_dense_head", "camray_windows_to_cameras", "stitch_dense_outputs",
          "run_track_chunked")


def read_config(path):
    import json

    with open(path) as f:
        return json.load(f)


class Requests:
    """Request i of a seed: the same tensors on every call, made on the device."""

    def __init__(self, seed: int, frames: int, queries: int, hw: Tuple[int, int], margin: float, device):
        self.seed, self.frames, self.queries, self.hw, self.margin, self.device = (
            seed, frames, queries, hw, margin, device)
        h, w = hw
        k = torch.diag(torch.tensor([float(w), float(h), 1.0, 1.0]))
        k[0, 2], k[1, 2] = w / 2, h / 2
        self.intrinsics = k[None, :, :, None].expand(1, 4, 4, frames).contiguous().to(device)

    def __call__(self, i: int) -> Dict[str, torch.Tensor]:
        g = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, "request", i))
        h, w = self.hw
        data = {"rgb_u8_bthw3": torch.randint(0, 256, (1, self.frames, h, w, 3), generator=g, device=self.device,
                                              dtype=torch.uint8),
                "intrinsics_b44t": self.intrinsics}
        if self.queries:
            n, m = self.queries, self.margin
            t = torch.randint(0, self.frames, (1, n, 1), generator=g, device=self.device).float()
            u = torch.rand((1, n, 2), generator=g, device=self.device)
            xy = m + u * torch.tensor([w - 2 * m, h - 2 * m], device=self.device)
            data["track_2d_pointquerries_bn3"] = torch.cat([t, xy], -1)
            data["track_2d_pointlabels_bn"] = torch.ones((1, n), device=self.device)
        return data


class Cell:
    """Set-up on construction: the program's model with seeded weights, its
    session and two warm requests at the cell's shapes."""

    def __init__(self, ctx):
        from l4p_tpu_torch.config import load_model_config
        from l4p_tpu_torch.inference import InferenceSession
        from l4p_tpu_torch.models.l4p import L4P

        self.ctx, tr = ctx, ctx.traffic
        self.config = read_config(ctx.config_path)
        self.dtype = dtype_of(ctx, self.config)
        self.tasks = tuple(tr["tasks"])
        self.cfg, _ = load_model_config(str(ctx.config_path))
        dev = ctx.device
        self.requests = Requests(ctx.seed, tr["frames"], tr["queries"], tuple(self.cfg.window_size[1:]),
                                 tr["query_margin_px"], dev)
        self.draws = RandomDraws(derive_seed(ctx.seed, "draws"))
        ctx.mark("the program's modules")
        self.model = L4P(self.cfg, device=dev, dtype=self.dtype).eval()
        self._sync()
        ctx.mark("the program's model built")
        weights = self._weights(self.model, self.dtype)
        self._sync()
        ctx.mark("the seeded weights")
        self.model.load_state_dict(weights, strict=True)
        del weights
        self.session = InferenceSession(self.cfg, self.tasks, dev, draws=self.draws)
        self._sync()
        ctx.mark("the weights loaded")
        rng = random.Random(derive_seed(ctx.seed, "sample"))
        self.sample = sorted(rng.sample(range(tr["sample_from"]), tr["sample"]))
        nw = (tr["frames"] - self.cfg.window_size[0]) // self.cfg.window_stride_t + 1
        self.track_windows = (0, rng.randrange(1, nw)) if nw > 1 else (0,)  # track steps compared
        self.kept: Dict[int, Dict[str, torch.Tensor]] = {}
        self.flops_per_clip = alltask_video_flops(self.cfg, self.tasks, tr["frames"], tr["queries"])["total"]
        self._next = 0
        for i in (-1, -2):
            self.session(self.model, self.requests(i))
            self._sync()
            ctx.mark(f"warm request {i}")

    def _weights(self, model, dtype):
        return seeded_state_dict(model, derive_seed(self.ctx.seed, "weights"), self.ctx.device,
                                 dtype)

    def _sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

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
                if i in self.sample:
                    with self.tap() as tap:
                        out = self.session(self.model, self.requests(i))
                    self.kept[i] = (out, tap.rec)
                else:
                    out = self.session(self.model, self.requests(i))
                flags.append(all_finite(out.values()))
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
        fps = rate(done * self.ctx.traffic["frames"], elapsed)
        self.ctx.log("seconds a request: " + " ".join(f"{x:.4f}" for x in seconds_each))
        return Window(attempted, failed, elapsed, {"video_fps": fps}, flops=done * self.flops_per_clip)

    def traced_slice(self):
        import l4p_tpu_torch.inference as inference
        from l4p_tpu_torch.models.sam import TrackKernels
        from l4p_tpu_torch.ops import flash_attention as fa
        from l4p_tpu_torch.ops import fused_keys as fk
        from l4p_tpu_torch.ops import fused_upscale as fu

        sess = self.session
        spans = trace.Spans()
        for name in STAGES:
            spans.patch(inference, name)
        attention, kernels = sess.attention, sess.track_kernels
        sess.attention = spans.wrap("attention", attention, op=True)
        sess.track_kernels = TrackKernels(spans.wrap("t2i", kernels.t2i, op=True),
                                          spans.wrap("i2t", kernels.i2t, op=True),
                                          spans.wrap("upscale", kernels.upscale, op=True))
        counters = {"attention": fa.flash_attention, "t2i": fk.t2i_flash, "i2t": fk.i2t_ln_t2i,
                    "upscale": fu.fused_upscale_hypernet}
        before = {k: f.launches for k, f in counters.items()}
        n = self.ctx.traffic["slice_requests"]
        try:
            with trace.profiled(self.ctx.device) as box:
                for j in range(n):
                    i = self._next
                    self._next += 1
                    self.session(self.model, self.requests(i))
        finally:
            spans.restore()
            sess.attention, sess.track_kernels = attention, kernels
        for k, f in counters.items():
            if f.launches - before[k] != spans.calls[k]:
                raise RuntimeError(f"{k}: {spans.calls[k]} wrapped calls, {f.launches - before[k]} kernel launches")
        for name in STAGES:
            if name not in ("camray_windows_to_cameras", "run_track_chunked") and not spans.calls[name]:
                raise RuntimeError(f"no call of {name} in the traced slice")
        self.ctx.log(f"trace: {box['trace_bytes']} bytes, exported and read in {box['export_s']:.2f} s")
        return spans, trace.Reduced(box["events"]), n

    def reference(self):
        """The plain fp32 reference's session and model, on the same weights
        and draws."""
        from portbench.reference.l4p.config import load_model_config
        from portbench.reference.l4p.inference import InferenceSession
        from portbench.reference.l4p.models.l4p import L4P

        plain_fp32()
        cfg, _ = load_model_config(str(self.ctx.config_path))
        model = L4P(cfg, device=self.ctx.device, dtype=torch.float32).eval()
        model.load_state_dict({k: v.float() for k, v in self._weights(model, self.dtype).items()}, strict=True)
        return InferenceSession(cfg, self.tasks, self.ctx.device, draws=self.draws), model, cfg

    def serve_sample(self):
        """The sampled requests alone, served as the window serves them (for
        the readings that the limits are set from)."""
        import l4p_tpu_torch.inference as inference

        for i in self.sample:
            with self.tap() as tap:
                out = self.session(self.model, self.requests(i))
            self.kept[i] = (out, tap.rec)
        self._sync()

    def tap(self):
        import l4p_tpu_torch.inference as inference
        import l4p_tpu_torch.models.track as track

        return Tap(inference, track, self.track_windows)

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
        import portbench.reference.l4p.inference as ref_inference
        from portbench.reference.l4p.models.l4p import camray_windows_to_cameras, stitch_dense_outputs
        from portbench.reference.l4p.models.track import init_track_carry, track_window_step
        from portbench.reference.l4p.ops.lowp import fp8_products, tf32_products

        sess, model, cfg = self.reference()
        progs, ctls = [], []
        for i in self.sample:
            out, rec = self.kept[i]
            data = self.requests(i)
            with Tap(ref_inference) as tap:
                ref = sess(model, data)
            for side, o in (("program", out), ("reference", ref)):
                bad = nonfinite(o)
                if bad:
                    self.ctx.log(f"request {i}: the {side}'s outputs hold values that are not finite: {bad}")
            ref_rec = tap.rec
            nums = self.network_numbers(out, rec, ref, ref_rec)
            low = {}
            if control:
                with Tap(ref_inference) as tap, fp8_products():
                    low_out = sess(model, data)
                low = self.network_numbers(low_out, tap.rec, ref, ref_rec)
                del low_out
            hcfg, stride, t = cfg.head_dict.get("camray"), cfg.window_stride_t, self.requests.frames
            img = tuple(cfg.window_size)
            if "rays" in rec:
                def solve():
                    return camray_windows_to_cameras(rec["rays"], hcfg, img, data["intrinsics_b44t"], stride, self.draws)
                r_pose, r_k = solve()
                nums.update(self.geometry_numbers("solve", rec["solve"], (r_pose, r_k)))
                if control:
                    with tf32_products():
                        low.update(self.geometry_numbers("solve", solve(), (r_pose, r_k)))
            if "stitch" in rec:
                def stitch():
                    return stitch_dense_outputs(cfg, *rec["stitch"], draws=self.draws)
                r_st = stitch()
                nums.update(self.stitch_numbers(rec["stitched"], r_st))
                if control:
                    with tf32_products():
                        low.update(self.stitch_numbers(stitch(), r_st))
            for w, carry, enc, queries, stride_, (p_carry, p_emit) in rec["steps"]:
                head = model.task_heads["track_2d"]
                if w == 0:  # the start: the reference's own initial carry
                    carry = init_track_carry(head, cfg.track, queries, enc.shape[1], torch.float32)
                to32 = {k: v.float() if v.is_floating_point() else v for k, v in carry.items()}

                def step():
                    return track_window_step(head, cfg.track, dict(to32), enc.float(), queries, w, stride_)
                r_carry, r_emit = step()
                nums = worst([nums, self.track_numbers(p_emit, p_carry, r_emit, r_carry),
                              {"track.assembled": self.assembled(out, p_emit, w, stride_)}])
                if control:
                    with fp8_products():
                        l_carry, l_emit = step()
                    low = worst([low, self.track_numbers(l_emit, l_carry, r_emit, r_carry)])
            progs.append(nums)
            ctls.append(low)
            del ref, ref_rec
        del sess, model
        free(self.ctx.device)
        return worst(progs), (worst(ctls) if control else None)

    @staticmethod
    def network_numbers(out, rec, ref, ref_rec) -> Dict[str, float]:
        """The encoder and the dense heads against the reference's own forward:
        the flow and dyn_mask outputs (their windows' frames, as the stitch
        passes them), the depth and camray heads' per-window outputs, which
        the camera solve and the stitch take, and the encoder's final
        features, which the track stage takes."""
        nums = {f"{SHORT[k]}.abs": rms_err(out[k], ref[k]) for k in ref if SHORT.get(k) in ("flow", "dyn_mask")}
        for kind in ("depth", "camray"):
            if kind in ref_rec["windows"]:
                nums[f"windows.{kind}"] = rel_l2(rec["windows"][kind], ref_rec["windows"][kind])
        if "features" in ref_rec:
            nums["features"] = rel_l2(rec["features"], ref_rec["features"])
        return nums

    @staticmethod
    def geometry_numbers(stage, prog, ref) -> Dict[str, float]:
        return {f"{stage}.pose": rel_l2(prog[0], ref[0]), f"{stage}.intrinsics": rel_l2(prog[1], ref[1])}

    @staticmethod
    def stitch_numbers(prog, ref) -> Dict[str, float]:
        """The Sim(3) chain's depth and poses (its intrinsics are the camera
        solve's, passed through)."""
        return {f"stitch.{SHORT[k]}": rel_l2(prog[k], ref[k]) for k in ref if SHORT.get(k) in ("depth", "pose")}

    @staticmethod
    def assembled(out, emit, w: int, stride: int) -> float:
        """The request's track outputs at window w's frames against the frames
        that step w emitted (its first query chunk): 0 where the scan's output
        is assembled from its steps as they are."""
        got = 0.0
        for key, name in (("traj", "_traj_"), ("vis", "_vis_"), ("depth", "_depth_")):
            full = next((v for k, v in out.items() if k.startswith("track_2d") and name in k), None)
            if full is not None and key in emit:
                n = emit[key].shape[1]
                got = max(got, rel_l2(full[:, :n, ..., w * stride: (w + 1) * stride], emit[key]))
        return got

    @staticmethod
    def track_numbers(p_emit, p_carry, r_emit, r_carry) -> Dict[str, float]:
        """One step of the track scan: the frames it emits and the carry it
        hands the next window (its visibility buffer holds the emitted
        visibility, compared as such)."""
        out = {f"track.{n}": rel_l2(p_emit[k], r_emit[k]) for k, n in (("traj", "xy"), ("depth", "depth"))
               if k in r_emit}
        if "vis" in r_emit:
            out["track.vis.abs"] = rms_err(p_emit["vis"], r_emit["vis"])
        out["carry.track"] = max(rel_l2(p_carry[k], v) for k, v in r_carry.items()
                                 if v.is_floating_point() and k != "vis")
        return out

    def check(self):
        missing = [i for i in self.sample if i not in self.kept]
        if missing:  # an answer that never came: nothing to compare, and not correct
            self.release()
            return {"unanswered": {"value": float(len(missing)), "limit": 0.0}}
        return checks(self.readings()[0], self.ctx.limits)


class Tap:
    """Records, for one request, what the session hands its stages and gets
    back: the encoder's final features, each dense head's per-window
    outputs, the camera solve's rays and cameras, the stitch's inputs and
    outputs, and the track scan's steps at `windows` (carry in, features, queries; carry out and the
    frames emitted). Inputs a stage could change in place are cloned."""

    def __init__(self, module, track_module=None, windows=()):
        self.module, self.track_module, self.windows = module, track_module, set(windows)
        self.rec = {"windows": {}, "steps": []}
        self._undo = []

    def _patch(self, name, fn, owner=None):
        owner = owner or self.module
        original = getattr(owner, name)
        setattr(owner, name, fn(original))
        self._undo.append((owner, name, original))

    def __enter__(self):
        rec = self.rec

        def encode(f):
            def g(*a, **k):
                out = f(*a, **k)
                rec["features"] = out["final"]
                return out
            return g

        def dense(f):
            def g(head, *a, **k):
                out = f(head, *a, **k)
                rec["windows"][head.hcfg.kind] = out
                return out
            return g

        def solve(f):
            def g(rays, hcfg, img, intr, stride, draws):
                rec["rays"] = rays.clone()
                out = f(rays, hcfg, img, intr, stride, draws)
                rec["solve"] = out
                return out
            return g

        def stitch(f):
            def g(cfg, tasks, dense_outs, stride, t, pose_w=None, intr_w=None, draws=None):
                clone = lambda x: None if x is None else x.clone()
                rec["stitch"] = (tasks, {k: v.clone() for k, v in dense_outs.items()}, stride, t, clone(pose_w),
                                 clone(intr_w))
                out = f(cfg, tasks, dense_outs, stride, t, pose_w, intr_w, draws)
                rec["stitched"] = out
                return out
            return g

        def step(f):
            def g(head, cfg, carry, enc, queries, window, stride, *a):
                taken = window in self.windows
                if taken:
                    carry_in = {k: v.clone() for k, v in carry.items()}
                out = f(head, cfg, carry, enc, queries, window, stride, *a)
                if taken:
                    rec["steps"].append((window, carry_in, enc, queries, stride, out))
                return out
            return g

        for name, fn in (("encode_windows", encode), ("run_dense_head", dense), ("camray_windows_to_cameras", solve),
                         ("stitch_dense_outputs", stitch)):
            self._patch(name, fn)
        if self.track_module is not None:
            self._patch("track_window_step", step, self.track_module)
        return self

    def __exit__(self, *exc):
        for owner, name, original in reversed(self._undo):
            setattr(owner, name, original)
        return False
