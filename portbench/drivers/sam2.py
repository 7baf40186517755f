"""Offline clip requests to SAM 2.1 through `InferenceSession.__call__`: a
closed loop with one client, each request one clip of seeded uint8 frames
at the network's size and `objects` objects, each clicked once (positive)
on frame 0 at (x, y) uniform in [click_lo, click_hi] pixels from the
request's seed, propagated forward over the whole clip.

Traffic keys: `frames`, `size`, `objects`, `click_lo`, `click_hi`, `tasks`
(`masks`), `sample` (requests compared with the reference, drawn from the
seed among the first `sample_from`) and `slice_requests` (requests in the
traced slice).

End-to-end: `video_fps`, the clip frames of every request completed in the
window over the window's time; the window closes when the first request
that ends at or after `--seconds` completes, and not before the sampled
requests have been served. A request that raises, or answers mask logits
or object scores that are not finite, is failed.

Weights are drawn per tensor from (seed, name) at portbench/weights.py's
scales, as for VGGT (drivers/vggt.py), under upstream's names, but for the
object-score head's last bias (`PRESENT`), drawn as 1 plus its draw's
magnitude: a random head says "absent" for about half the objects, and an
absent object's masks are a constant, its memories one embedding.

The comparison (`readings`), each number a relative L2 at its worst
sampled request:
- the clicked frame end to end from the image and the clicks: the
  reference's top features (`encode.top`), its three candidate masks
  (`frame0.masks`), IoU predictions (`frame0.iou`) and object scores
  (`frame0.score`); with the program's choices (the mask the program's IoU
  picks, the presence its score says), the mask logits at the image's size
  (`frame0.mask_logits`); the new memory (`frame0.memory`) from the
  reference's features and the program's chosen mask logits, which the
  clicked frame binarises (the reference's own logits would binarise
  differently wherever a logit lies within rounding of 0);
- at two frames drawn from the seed, `early` (before the bank is full:
  frames 1 to num_maskmem - 1) and `steady` (every memory and pointer slot
  in use), each stage from the program's own inputs: memory attention
  (`<f>.attn`) on the program's top features and the memory bank the
  reference assembles, with upstream's choice of frames and its temporal
  encodings, from the program's memories and pointers of every earlier
  frame, and that bank against the program's own (`<f>.bank`: its memory
  and pointer tokens in their order, equal where right; `<f>.bank_pos`:
  their spatial, temporal and pointer encodings); layer 0's
  cross-attention call from the program's own q, k and v (`<f>.cross`:
  the kernel over every key of the bank, against the reference's blocked
  attention, whose output the control rounds to fp8 as its out_proj takes
  it: the rounding of q, k and v alone averages out over the bank's
  keys, where the program's bf16 output does not; memory attention's
  output, after four residual layers, hardly moves with which keys it
  read); the decoder
  (`<f>.masks`, `<f>.iou`, `<f>.score`) on the program's
  memory-conditioned features and skips; the memory encoder (`<f>.memory`)
  on the program's top features, chosen mask and score.
"""

from __future__ import annotations

import json
import random
import time
import traceback
from typing import Dict

import torch

from portbench import trace
from portbench.drivers._common import all_finite, checks, dtype_of, free, nonfinite, rel_l2, worst
from portbench.drivers.vggt import seeded_weights
from portbench.reference import sam2 as ref
from portbench.stats import derive_seed, rate
from portbench.work.sam2_flops import sam2_request_flops

# the object-score head's last bias: 1 + the draw's magnitude, so that clicked objects are present
PRESENT = "sam_mask_decoder.pred_obj_score_head.layers.2.bias"
OUTPUTS = ("mask_logits_btnhw", "object_score_logits_btn")


class Requests:
    """Request i of a seed: the same frames and clicks on every call, made on the device."""

    def __init__(self, seed: int, tr: Dict, device):
        self.seed, self.tr, self.device = seed, tr, device

    def __call__(self, i: int) -> Dict[str, torch.Tensor]:
        tr, dev = self.tr, self.device
        g = torch.Generator(device=dev).manual_seed(derive_seed(self.seed, "request", i))
        frames = torch.randint(0, 256, (1, tr["frames"], tr["size"], tr["size"], 3), generator=g, device=dev,
                               dtype=torch.uint8)
        g = torch.Generator(device=dev).manual_seed(derive_seed(self.seed, "clicks", i))
        lo, hi = tr["click_lo"], tr["click_hi"]
        coords = lo + (hi - lo) * torch.rand((1, tr["objects"], 1, 2), generator=g, device=dev)
        labels = torch.ones((1, tr["objects"], 1), device=dev, dtype=torch.int64)
        return {"rgb_u8_bthw3": frames, "point_coords_bnk2": coords, "point_labels_bnk": labels, "prompt_frame": 0}


class Tap:
    """Keeps, for one request, what the comparison reads: the top features,
    skips and decoder outputs of frame 0 and of the sampled frames (the
    model's stage methods wrapped on the instance; a decode call starts a
    frame), memory attention's output there (a forward hook) and its layer 0
    cross-attention call's q, k, v and output (a pre-hook hands memory
    attention the session's attention function wrapped: the second call of
    a frame), and every frame's memory and pointer up to the last sampled
    frame."""

    def __init__(self, model, frames):
        self.model, self.frames, self.last = model, set(frames), max(frames)
        self.rec: Dict[int, Dict] = {}
        self.frame, self.hooks = -1, []

    def __enter__(self):
        m = self.model
        decode, encode_memory = m.decode, m.encode_memory

        def kept():
            return self.rec.setdefault(self.frame, {})

        def tapped_decode(*args):
            self.frame += 1
            out = decode(*args)
            if self.frame <= self.last:
                kept()["pointer"] = out[4]
                if self.frame in self.frames:
                    kept()["decode"], kept()["skips"] = (args[0], out), args[1]
            return out

        def tapped_memory(*args):
            out = encode_memory(*args)
            if self.frame <= self.last:
                kept()["memory"] = out
                if self.frame in self.frames:
                    kept()["top"], kept()["chosen"] = args[0], args[1]
            return out

        def attention(mod, args, out):  # before the frame's decode: the frame it serves is the next
            if self.frame + 1 in self.frames:
                self.rec.setdefault(self.frame + 1, {}).update(attn=out, bank=args[2:4])

        def cross(mod, args):  # layer 0: its self-attention, then its cross-attention
            if self.frame + 1 not in self.frames:
                return None
            fn, calls = args[5], []

            def tapped(q, k, v, scale):
                o = fn(q, k, v, scale)
                calls.append(1)
                if len(calls) == 2:
                    self.rec.setdefault(self.frame + 1, {})["cross"] = (q, k, v, o)
                return o

            return (*args[:5], tapped)

        m.decode, m.encode_memory = tapped_decode, tapped_memory
        self.hooks = [m.memory_attention.register_forward_hook(attention),
                      m.memory_attention.register_forward_pre_hook(cross)]
        return self

    def __exit__(self, *exc):
        for name in ("decode", "encode_memory"):
            delattr(self.model, name)
        for h in self.hooks:
            h.remove()
        return False


class Cell:
    """Set-up on construction: the program's model with seeded weights, its
    session and two warm requests at the cell's shapes."""

    def __init__(self, ctx):
        from l4p_tpu_torch.config import load_model_config
        from l4p_tpu_torch.inference import InferenceSession
        from l4p_tpu_torch.models.sam2 import Sam2, load_upstream_state_dict, upstream_name

        self.ctx, tr = ctx, ctx.traffic
        with open(ctx.config_path) as f:
            self.config = json.load(f)
        self.dtype = dtype_of(ctx, self.config)
        self.cfg, _ = load_model_config(str(ctx.config_path))
        self.tasks = tuple(tr["tasks"])
        dev = ctx.device
        self.requests = Requests(ctx.seed, tr, dev)
        ctx.mark("the program's modules")
        self.model = Sam2(self.cfg, device=dev, dtype=self.dtype).eval()
        self._sync()
        ctx.mark("the program's model built")
        load_upstream_state_dict(self.model, self._weights(self.model, self.dtype, upstream_name))
        self.session = InferenceSession(self.cfg, self.tasks, dev)
        self._sync()
        ctx.mark("the seeded weights loaded")
        rng = random.Random(derive_seed(ctx.seed, "sample"))
        self.sample = sorted(rng.sample(range(tr["sample_from"]), tr["sample"]))
        rng = random.Random(derive_seed(ctx.seed, "frames"))
        t = tr["frames"]
        self.stage_frames = {"early": rng.randint(1, min(self.cfg.num_maskmem - 1, t - 1)),
                             "steady": rng.randint(min(max(self.cfg.num_maskmem, self.cfg.max_obj_ptrs), t - 1), t - 1)}
        self.kept: Dict[int, tuple] = {}
        self.flops_per_request = sam2_request_flops(self.cfg, t, tr["objects"])["total"]
        self._next = 0
        for i in (-1, -2):
            self.session(self.model, self.requests(i))
            self._sync()
            ctx.mark(f"warm request {i}")

    def _weights(self, model, dtype, rename=None):
        out = seeded_weights(model, self.ctx.seed, self.ctx.device, dtype, rename)
        out[PRESENT] = 1.0 + out[PRESENT].abs()
        return out

    def _sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _serve(self, i: int):
        if i not in self.sample:
            return self.session(self.model, self.requests(i))
        with Tap(self.model, [0, *self.stage_frames.values()]) as tap:
            out = self.session(self.model, self.requests(i))
        self.kept[i] = (out["mask_logits_btnhw"][0, 0].clone(), tap.rec)  # frame 0's logits: the rest is not compared
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
                flags.append(all_finite([out[k] for k in OUTPUTS]))
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
            model = ref.SAM2Base(ref.read_config(self.ctx.config_path)).eval()
        model.load_state_dict({k: v.float() for k, v in self._weights(model, self.dtype).items()}, strict=True)
        progs, ctls = [], []
        for i in self.sample:
            out, rec = self.kept[i]
            data = self.requests(i)
            want = self.reference(model, data, rec)
            bad = nonfinite({"program": out, **want})
            if bad:
                self.ctx.log(f"request {i}: values that are not finite: {bad}")
            progs.append(self.numbers(self.program(out, rec), want))
            if control:
                with fp8_products():
                    low = self.reference(model, data, rec)
                ctls.append(self.numbers(low, want))
                del low
            del want
        del model
        free(self.ctx.device)
        return worst(progs), (worst(ctls) if control else None)

    def program(self, frame0, rec) -> Dict[str, torch.Tensor]:
        """The program's values of every compared number; `frame0` its mask logits on frame 0."""
        vals = {"encode.top": rec[0]["top"].flatten(1, 2)[0]}
        for name, f in (("frame0", 0), *self.stage_frames.items()):
            r = rec[f]
            masks, iou, score, _, _ = r["decode"][1]
            vals[f"{name}.masks"], vals[f"{name}.iou"], vals[f"{name}.score"] = masks[:, 1:], iou[:, 1:], score
            vals[f"{name}.memory"] = r["memory"]
            if f:
                vals[f"{name}.attn"], vals[f"{name}.cross"] = r["attn"], r["cross"][3]
                vals[f"{name}.bank"], vals[f"{name}.bank_pos"] = r["bank"][0], r["bank"][1][0]
        vals["frame0.mask_logits"] = frame0
        return vals

    def reference(self, model, data, rec) -> Dict[str, torch.Tensor]:
        """The reference's values of every compared number (the module's docstring)."""
        t, size = data["rgb_u8_bthw3"].shape[1], self.cfg.image_size
        coords, labels = data["point_coords_bnk2"][0], data["point_labels_bnk"][0]
        n = coords.shape[0]
        vals = {}
        # frame 0 from the image and the clicks
        feats, pos, sizes = model.features(model.forward_image(data["rgb_u8_bthw3"][:, 0]))
        vals["encode.top"] = feats[-1][:, 0]
        high_res = [x.permute(1, 2, 0).view(x.size(1), x.size(2), *s) for x, s in zip(feats[:-1], sizes[:-1])]
        pix = model.condition(0, feats, pos, sizes, {}, t).expand(n, -1, -1, -1)
        heads = model._forward_sam_heads(pix, {"point_coords": coords.float(), "point_labels": labels}, high_res, True)
        vals["frame0.masks"], vals["frame0.iou"] = heads["candidates"], heads["ious"]
        vals["frame0.score"] = heads["object_score_logits"]
        _, iou, score, _, _ = rec[0]["decode"][1]
        best = iou[:, 1:].argmax(-1)  # the program's choices
        low = heads["candidates"][torch.arange(n, device=best.device), best][:, None]
        low = torch.where(score[:, :, None, None] > 0, low, torch.full_like(low, ref.NO_OBJ_SCORE))
        high = torch.nn.functional.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
        vals["frame0.mask_logits"] = high[:, 0]
        mem, _ = model._encode_new_memory(feats, sizes, rec[0]["chosen"].float(), score.float(), True)
        vals["frame0.memory"] = mem.flatten(2).transpose(1, 2)
        # the sampled frames' stages from the program's own inputs
        mem_pos = model.memory_encoder.position_encoding(mem)
        curr_pos = pos[-1].expand(-1, n, -1)
        bank = {j: {"maskmem_features": r["memory"].float().transpose(1, 2).reshape(n, -1, *sizes[-1]),
                    "maskmem_pos_enc": [mem_pos], "obj_ptr": r["pointer"].float()}
                for j, r in rec.items() if "memory" in r}
        for name, f in self.stage_frames.items():
            r = rec[f]
            top, (s0, s1) = r["top"], r["skips"]
            memory, memory_pos, n_ptr = model.memory_bank(f, bank, t, n)
            curr = top.float().flatten(1, 2).transpose(0, 1).expand(-1, n, -1)
            attn = model.memory_attention(curr=curr, curr_pos=curr_pos, memory=memory, memory_pos=memory_pos,
                                          num_obj_ptr_tokens=n_ptr)
            vals[f"{name}.attn"] = attn.transpose(0, 1)
            vals[f"{name}.bank"], vals[f"{name}.bank_pos"] = memory.transpose(0, 1), memory_pos[:, 0]
            q, k, v, _ = r["cross"]
            vals[f"{name}.cross"] = ref.q8(ref.attention(q.float(), k.float(), v.float()))
            heads = model._forward_sam_heads(r["decode"][0].float(), None, [s0.float(), s1.float()], True)
            vals[f"{name}.masks"], vals[f"{name}.iou"] = heads["candidates"], heads["ious"]
            vals[f"{name}.score"] = heads["object_score_logits"]
            _, _, score, _, _ = r["decode"][1]
            top_seq = [top.float().flatten(1, 2).transpose(0, 1)]
            mem, _ = model._encode_new_memory(top_seq, sizes[-1:], r["chosen"].float(), score.float(), False)
            vals[f"{name}.memory"] = mem.flatten(2).transpose(1, 2)
        return vals

    @staticmethod
    def numbers(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> Dict[str, float]:
        return {k: rel_l2(got[k], want[k]) for k in want}

    def check(self):
        missing = [i for i in self.sample if i not in self.kept]
        if missing:  # an answer that never came: nothing to compare, and not correct
            self.release()
            return {"unanswered": {"value": float(len(missing)), "limit": 0.0}}
        return checks(self.readings()[0], self.ctx.limits)
