"""Online (streaming) all-task inference (counterpart of l4p_tpu/streaming.py).

Every cross-window dependency of the model is causal: the depth and Sim(3)
chains align each window to the previous aligned one, the camray head keeps
window 0's intrinsics solve, and the tracker carries its re-queries, prompt
features and token memory forward. So frames can be pushed as they arrive:
frame f is final once window floor(f / stride) has run (the stitchers' "last
writer wins"), and each `stride` frames pushed give `stride` final frames of
every task. `StreamingL4P` runs, per window, the one-window steps the
offline session loops over (`window_cameras`, `align_window` and
`window_frames`, `track_window_step`), with the carry as a dict of tensors
on the device, so its outputs equal `InferenceSession`'s on the same frames
and draws (with RandomDraws also in the variable-K camray mode, whose draws
are named by window).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from l4p_tpu_torch.config import L4PConfig
from l4p_tpu_torch.inference import DENSE_TASKS, InferenceSession
from l4p_tpu_torch.models.encoder import AttentionFn, EncoderBlocksFn
from l4p_tpu_torch.models.l4p import (
    Draws,
    align_window,
    encode_windows,
    flow_key,
    merge_query_chunks,
    query_chunks,
    run_dense_head,
    window_cameras,
    window_frames,
    window_tail,
)
from l4p_tpu_torch.models.sam import KERNELS, TrackKernels
from l4p_tpu_torch.models.track import TRACK_BUFFERS, init_track_carry, track_outputs, track_tail, track_window_step
from l4p_tpu_torch.ops.flash_attention import flash_attention
from l4p_tpu_torch.ops.fused_encoder import fused_encoder_blocks


def assemble_emissions(emits: Sequence[Optional[Dict[str, torch.Tensor]]]) -> Dict[str, torch.Tensor]:
    """Per-window emissions (and the flush tail) -> whole-video outputs,
    shaped as the offline session returns them."""
    emits = [e for e in emits if e is not None]
    starts = [e["t0"] for e in emits]
    if not emits or starts != sorted(starts):
        raise ValueError(f"emissions must be non-empty and in stream order, got starts {starts}")
    return {k: torch.cat([e[k] for e in emits], dim=-1 if k.endswith(("_bn2t", "_bn1t")) else 2)
            for k in emits[0] if k != "t0"}


def _to(tree, device):
    """A copy of the carry's tensors on `device` (dicts and lists walked;
    None, window 0's K in the modes that keep none, stays None)."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return None if tree is None else tree.to(device, copy=True)


class StreamingL4P:
    """Push uint8 frames in, get final per-frame outputs back one window at
    a time::

        s = StreamingL4P(model, cfg, tasks, "cuda", queries_bn3)
        for chunk in camera:                        # any chunk sizes
            for emit in s.push(chunk, intrinsics):  # each covers `stride` frames from emit["t0"]
                ...
        tail = s.flush()                            # the last window's frames after its first stride

    As in the JAX package: tracking forward in time only, queries declared
    up front, intrinsics with every push or none, the frames pushed in all
    tiling the window grid (checked at flush), no camera_rays head and no
    Plucker camera embedding (pushes carry no extrinsics).
    `draws`, `attention`, `track_kernels` and `encoder_blocks` are the
    session's."""

    def __init__(self, model: nn.Module, cfg: L4PConfig, tasks: Sequence[str], device: Union[str, torch.device],
                 queries_bn3=None, draws: Optional[Draws] = None,
                 attention: AttentionFn = flash_attention, track_kernels: TrackKernels = KERNELS,
                 encoder_blocks: EncoderBlocksFn = fused_encoder_blocks):
        heads = cfg.head_dict
        for t in tasks:
            if t in heads and heads[t].kind == "camera_rays":
                raise NotImplementedError(f"the camera_rays head {t!r} has no streaming stitcher")
        if "track_2d" in tasks and cfg.track is not None and tuple(cfg.track.estimation_directions) != (1,):
            raise ValueError("streaming tracking is forward-only (causality)")
        if cfg.encoder.cam_emb_placed_at is not None:
            raise NotImplementedError(
                f"streaming takes no extrinsics for the Plucker camera embedding (cam_emb_placed_at "
                f"{cfg.encoder.cam_emb_placed_at!r}); serve such a config with the offline InferenceSession")
        # the session checks the tasks and heads and holds the model and the kernels
        self._session = InferenceSession(cfg, tasks, device, attention, track_kernels, encoder_blocks, draws)
        self.model = self._session.model(model)
        self.cfg, self.tasks, self.device = cfg, self._session.tasks, self._session.device
        self.draws = self._session.draws
        self.ws, self.stride = cfg.window_size[0], cfg.window_stride_t
        self.h, self.w = cfg.window_size[1:]
        self._dense_tasks = tuple(t for t in self.tasks if t != "track_2d")

        # host-side frame buffer, trimmed as windows complete; _buf_t counts every frame pushed
        self._frames: List[np.ndarray] = []  # each (B, t, H, W, 3) uint8
        self._intr: List[Optional[np.ndarray]] = []
        self._buf_t = 0
        self._w = 0  # the next window
        self._flushed = False
        self._has_intr: Optional[bool] = None  # intrinsics with every push or never
        # the previous window's aligned outputs, camray's window-0 K and the track carry, built by window 0
        self._carry: Optional[Dict] = None

        self._q0 = None
        if "track_2d" in self.tasks:
            if queries_bn3 is None:
                raise ValueError("track_2d requires queries at session start")
            q = torch.as_tensor(queries_bn3, device=self.device)
            self._n_queries = q.shape[1]
            self._q0 = query_chunks(q, cfg.track.max_queries)

    # -- one window --------------------------------------------------------

    @torch.inference_mode()
    def _step(self, rgb_u8: np.ndarray, intr: Optional[np.ndarray]) -> Dict[str, torch.Tensor]:
        cfg, tasks, model, s, w = self.cfg, self.tasks, self.model, self.stride, self._w
        heads = cfg.head_dict
        sess, dev = self._session, self.device
        img_info = (self.ws, self.h, self.w)
        enc = encode_windows(model.video_encoder, cfg, None, torch.as_tensor(rgb_u8, device=dev), sess.attention,
                             sess.encoder_blocks)
        hooks, final = enc["hooks"], enc["final"][0]
        del enc
        chunk = cfg.dense_window_chunk
        cur = {t: run_dense_head(model.task_heads[t], hooks, img_info, chunk)[0] for t in tasks if t in DENSE_TASKS}
        prev = self._carry or {}
        carry: Dict = {}
        if "camray" in tasks:
            rays = run_dense_head(model.task_heads["camray"], hooks, img_info, chunk)[0]
            k_in = None if intr is None else torch.as_tensor(intr, device=dev)
            cur["pose"], cur["intrinsics"], carry["k0"] = window_cameras(rays, heads["camray"], img_info, k_in, w, None,
                                                                         prev.get("k0"), self.draws)
            del rays
        del hooks
        carry["aligned"] = align_window(cfg, self._dense_tasks, cur, prev.get("aligned"), w, s, self.draws)
        emit = {"t0": w * s, **window_frames(carry["aligned"], prev.get("aligned"), s, flow_key(cfg))}
        if self._q0 is not None:
            tcfg, head = cfg.track, model.task_heads["track_2d"]
            chunks = prev.get("track") or [init_track_carry(head, tcfg, q, final.shape[1], final.dtype)
                                            for q in self._q0]
            steps = [track_window_step(head, tcfg, c, final, q, w, s, sess.track_kernels)
                     for c, q in zip(chunks, self._q0)]
            carry["track"] = [c for c, _ in steps]
            emit.update(self._track_emit([e for _, e in steps]))
        self._carry = carry
        return emit

    def _track_emit(self, parts: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        """Per-chunk track buffers -> the session's keys, padding dropped."""
        return track_outputs(self.cfg.track, {k: merge_query_chunks(torch.stack([p[k] for p in parts]),
                                                                     self._n_queries) for k in TRACK_BUFFERS})

    # -- host-side frame plumbing ---------------------------------------------

    def push(self, rgb_u8_bthw3: np.ndarray,
             intrinsics_b44t: Optional[np.ndarray] = None) -> List[Dict[str, torch.Tensor]]:
        """Append frames (B, t, H, W, 3) uint8 and run every window that
        becomes complete: one emission per window, each `stride` final frames
        from emission['t0']. The buffer keeps at most a window and a stride of
        frames past the next window's start."""
        if self._flushed:
            raise RuntimeError("session already flushed")
        rgb = np.asarray(rgb_u8_bthw3)
        if rgb.dtype != np.uint8:
            raise TypeError(f"push expects uint8 frames, got {rgb.dtype}")
        if rgb.ndim != 5 or rgb.shape[-1] != 3:
            raise ValueError(f"push expects (B,t,H,W,3), got shape {rgb.shape}")
        if tuple(rgb.shape[2:4]) != (self.h, self.w):
            raise ValueError(f"frames are {tuple(rgb.shape[2:4])}, the model takes {(self.h, self.w)} only")
        if self._frames and rgb.shape[0] != self._frames[0].shape[0]:
            raise ValueError(f"push batch {rgb.shape[0]} disagrees with earlier frames' {self._frames[0].shape[0]}")
        if self._has_intr is None:
            self._has_intr = intrinsics_b44t is not None
        elif self._has_intr != (intrinsics_b44t is not None):
            raise ValueError("intrinsics must come with every push or never")
        self._frames.append(rgb)
        self._intr.append(None if intrinsics_b44t is None else np.asarray(intrinsics_b44t))
        self._buf_t += rgb.shape[1]
        emissions = []
        while self._buf_t >= self._w * self.stride + self.ws:
            start = self._w * self.stride
            emissions.append(self._step(*self._window_slice(start, self.ws)))
            self._w += 1
            self._trim()
        return emissions

    def _frame0_abs(self) -> int:
        return self._buf_t - sum(r.shape[1] for r in self._frames)

    def _window_slice(self, start: int, length: int):
        """Frames [start, start + length) from the chunk list, and their intrinsics."""
        rgb_parts, intr_parts = [], []
        off = self._frame0_abs()
        for rgb, intr in zip(self._frames, self._intr):
            lo, hi = max(start - off, 0), min(start + length - off, rgb.shape[1])
            if lo < hi:
                rgb_parts.append(rgb[:, lo:hi])
                if intr is not None:
                    intr_parts.append(intr[..., lo:hi])
            off += rgb.shape[1]
        return np.concatenate(rgb_parts, axis=1), np.concatenate(intr_parts, axis=3) if intr_parts else None

    def _trim(self) -> None:
        """Drops buffered chunks that end before the next window's start."""
        start = self._w * self.stride
        while self._frames and self._frame0_abs() + self._frames[0].shape[1] <= start:
            self._frames.pop(0)
            self._intr.pop(0)

    def flush(self) -> Optional[Dict[str, torch.Tensor]]:
        """The last window's frames after its first stride. Raises, and stays
        open for more frames, if frames pushed since the last window do not
        complete one: the offline session's tiling rule."""
        if self._flushed:
            return None
        if self._w == 0:
            raise ValueError(f"no window completed ({self._buf_t} frames < {self.ws})")
        leftover = self._buf_t - ((self._w - 1) * self.stride + self.ws)
        if leftover:
            raise ValueError(f"{leftover} trailing frames do not tile the window grid "
                             f"(window {self.ws} / stride {self.stride}); pad the stream")
        self._flushed = True
        s, carry = self.stride, self._carry
        emit = {"t0": self._w * s, **window_tail(carry["aligned"], s)}
        if self._q0 is not None:
            emit.update(self._track_emit([track_tail(c, s) for c in carry["track"]]))
        return emit

    def warmup(self, batch_size: int = 1, with_intrinsics: bool = True) -> None:
        """Runs window 0 and one later window on zero frames (building the
        kernels and the libraries' handles before traffic), then restores the
        session as it was."""
        state = self.get_state()
        try:
            t = self.ws + self.stride
            intr = None
            if with_intrinsics:
                intr = np.broadcast_to(np.eye(4, dtype=np.float32)[None, :, :, None], (batch_size, 4, 4, t)).copy()
            self.push(np.zeros((batch_size, t, self.h, self.w, 3), np.uint8), intr)
        finally:
            self.set_state(state)

    # -- checkpoint and resume ------------------------------------------------

    def _draws_id(self):
        return type(self.draws).__name__, getattr(self.draws, "seed", None)

    def get_state(self) -> Dict:
        """A snapshot of the session: the carry (copied to the host) and the
        frame buffer. set_state restores it bit for bit."""
        return {
            "carry": None if self._carry is None else _to(self._carry, "cpu"),
            "w": self._w,
            "buf_t": self._buf_t,
            "frames": [f.copy() for f in self._frames],
            "intr": [None if i is None else i.copy() for i in self._intr],
            "flushed": self._flushed,
            "has_intr": self._has_intr,
            # the draws seed the camera solve and the Sim(3) chain: a resume under others would diverge
            "draws": self._draws_id(),
        }

    def set_state(self, state: Dict) -> None:
        """Restores a get_state() snapshot of a session with the same model,
        config, tasks, queries and draws (the draws are checked)."""
        if state["draws"] != self._draws_id():
            raise ValueError(f"snapshot was taken under other draws {state['draws']}, this session has "
                             f"{self._draws_id()}: construct it with the same draws to resume bit for bit")
        self._carry = None if state["carry"] is None else _to(state["carry"], self.device)
        self._w, self._buf_t = state["w"], state["buf_t"]
        self._frames = [f.copy() for f in state["frames"]]
        self._intr = [None if i is None else i.copy() for i in state["intr"]]
        self._flushed, self._has_intr = state["flushed"], state["has_intr"]
