"""The promptable point-track head: one window and the causal sliding-window
scan (counterpart of l4p_tpu/models/track.py).

Queries are the decoder's batch axis. The windowed scan is a Python loop of
`track_window_step` over windows, whose carry is the re-queries, the prompt
features and labels, the kept half of the per-query token memory and
window-length output buffers; each step emits the frames no later window
writes, so the offline scan and streaming (l4p_tpu_torch/streaming.py) run
the same step. The JAX package's lax.scan exists for XLA's compiler.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from l4p_tpu_torch.config import TrackConfig
from l4p_tpu_torch.models.sam import (
    KERNELS,
    MaskDecoder,
    PromptEncoder,
    TrackKernels,
    dense_pe,
    mask_decoder_apply,
    prompt_encoder_apply,
)
from l4p_tpu_torch.ops.conv import linear
from l4p_tpu_torch.ops.misc import apply_fn
from l4p_tpu_torch.ops.resize import interp_matrix
from l4p_tpu_torch.utils import profiling

XY_CHUNK = 32  # queries per full-resolution heatmap (the heatmap is the head's largest tensor)
TRACK_BUFFERS = ("traj", "vis", "depth")  # the windowed scan's per-frame outputs


class TrackHead(nn.Module):
    """`task_heads.track_2d` of the released checkpoint: prompt encoder,
    mask decoder, prompt-feature projection and the token memory's mask
    token and projection."""

    def __init__(self, cfg: TrackConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        c, kw = cfg.sam.embed_dim, dict(device=device, dtype=dtype)
        self.prompt_encoder = PromptEncoder(cfg.sam, cfg.prompt_using_features, **kw)
        self.mask_decoder = MaskDecoder(cfg.sam, cfg.num_mask_tokens, **kw)
        if cfg.prompt_using_features:
            self.prompt_feature_linear_layer = nn.Linear(c, c, **kw)
        if cfg.attend_to_past:
            self.processed_video_mask_token = nn.Embedding(1, c, **kw)
            self.processed_video_features_proj = nn.Linear(c, c, **kw)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` with the distributions of the JAX
        package's init_track_params: Linear and deconv weights and biases
        uniform in +-1/sqrt(fan_in), LayerNorms at unit scale and zero shift,
        embeddings and the Fourier matrix standard normal. The never-read
        `iou_token` and `no_mask_embed` are zero."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.ConvTranspose3d)):
                fan_in = mod.weight.shape[1] if isinstance(mod, nn.Linear) else mod.weight[:, 0].numel()
                a = 1.0 / math.sqrt(fan_in)
                mod.weight.uniform_(-a, a, generator=generator)
                mod.bias.uniform_(-a, a, generator=generator)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(generator=generator)
        self.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix.normal_(generator=generator)
        self.prompt_encoder.no_mask_embed.weight.zero_()
        self.mask_decoder.iou_token.weight.zero_()


def softargmax_xy(logits_nthw: torch.Tensor) -> torch.Tensor:
    """Soft-argmax over H x W on pixel centres (+0.5): (N, T, H, W) ->
    (N, T, 2) as (x, y), in fp32."""
    n, t, h, w = logits_nthw.shape
    lf = logits_nthw.reshape(n, t, h * w).float()
    z = torch.exp(lf - lf.amax(dim=-1, keepdim=True))
    dev = lf.device
    grid_x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5).expand(h, w).reshape(-1)
    grid_y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None].expand(h, w).reshape(-1)
    s = z.sum(-1)
    return torch.stack([(z * grid_x).sum(-1) / s, (z * grid_y).sum(-1) / s], dim=-1)


@functools.lru_cache(maxsize=64)
def interp_weights(n_in: int, n_out: int, column_means: bool, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """interp_matrix(n_in, n_out, align_corners=False), or its column means,
    rounded to `dtype` and held in fp32 on `device`. Made once a shape: a
    copy from host memory waits for the device, and every window of the
    scan reads them."""
    m = interp_matrix(n_in, n_out, False)
    with torch.inference_mode(False):  # read by training steps too
        return torch.as_tensor(m.mean(axis=0) if column_means else m, device=device).to(dtype).float()


def track_forward_item(head: TrackHead, cfg: TrackConfig, enc_features: torch.Tensor, queries_n3: torch.Tensor,
                       labels_n: torch.Tensor, prompt_features_nc: Optional[torch.Tensor] = None,
                       prompt_feature_labels_n: Optional[torch.Tensor] = None,
                       kernels: TrackKernels = KERNELS) -> Dict[str, torch.Tensor]:
    """One window of one batch item; enc_features (P, C) shared or (N, P, C)
    per query."""
    sam = cfg.sam
    sparse = prompt_encoder_apply(
        head.prompt_encoder, sam, queries_n3[:, None], labels_n[:, None],
        None if prompt_features_nc is None else prompt_features_nc[:, None],
        None if prompt_feature_labels_n is None else prompt_feature_labels_n[:, None],
    )
    img = enc_features if enc_features.dim() == 3 else enc_features[None]
    pe = dense_pe(head.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix, sam)
    # prompts are computed in the queries' fp32, the decoder runs in the image's dtype
    logits, processed = mask_decoder_apply(head.mask_decoder, sam, img, pe, sparse.to(img.dtype), kernels=kernels)

    tid = cfg.token_ids
    out: Dict[str, torch.Tensor] = {}
    # xy: the heatmap upsampled to full resolution (align_corners=False), per chunk of queries
    xy = logits[:, tid["xy"]]
    out["traj_nt2"] = torch.cat([
        softargmax_xy(F.interpolate(xy[i: i + XY_CHUNK, None], size=tuple(cfg.image_size), mode="trilinear",
                                    align_corners=False)[:, 0])
        for i in range(0, xy.shape[0], XY_CHUNK)
    ])
    if cfg.estimate_vis or cfg.estimate_depth:
        # the spatial mean of a linear upsample is a weighted mean of the low-resolution map
        # (column means of the interpolation matrices); time keeps per-frame values
        t2, h2, w2 = logits.shape[-3:]
        big_t, big_h, big_w = cfg.image_size
        dt, dev = logits.dtype, logits.device
        wh = interp_weights(h2, big_h, True, dt, dev)
        ww = interp_weights(w2, big_w, True, dt, dev)
        mt = interp_weights(t2, big_t, False, dt, dev)
        spatial = torch.einsum("nmthw,h,w->nmt", logits.float(), wh, ww).to(dt)
        per_frame = torch.einsum("nmt,Tt->nmT", spatial.float(), mt).to(dt)
        if cfg.estimate_vis:
            out["vis_nt"] = apply_fn(per_frame[:, tid["vis"]], cfg.vis_fn)
        if cfg.estimate_depth:
            out["depth_nt"] = apply_fn(per_frame[:, tid["depth"]], cfg.depth_fn)
    if cfg.prompt_using_features:
        lin = head.prompt_feature_linear_layer
        out["prompt_features_nc"] = linear(processed["io_features"][:, tid["prompt_feat"]], lin.weight, lin.bias)
    if cfg.attend_to_past:
        # only the last te/2 token steps survive into the next window's memory: slice, then
        # project, emitting the compute dtype (track.py:280-300 of the JAX package)
        enc = processed["enc_features"]
        te = sam.image_embedding_size[0]
        n, pn, c = enc.shape
        kept = enc.reshape(n, te, pn // te, c)[:, te // 2:].reshape(n, pn // 2, c)
        proj = head.processed_video_features_proj
        out["enc_history_kept_npc"] = torch.matmul(kept, proj.weight.to(kept.dtype).t()) + proj.bias.to(kept.dtype)
    return out


def track_forward(head: TrackHead, cfg: TrackConfig, enc_features: torch.Tensor, queries_bn3: torch.Tensor,
                  labels_bn: torch.Tensor, prompt_features_bnc: Optional[torch.Tensor] = None,
                  prompt_feature_labels_bn: Optional[torch.Tensor] = None,
                  kernels: TrackKernels = KERNELS) -> Dict[str, torch.Tensor]:
    """One window for each batch item: enc_features (B, P, C) or
    (B, N, P, C) -> {task}_traj_est_bn2t etc."""
    items = [
        track_forward_item(
            head, cfg, enc_features[i], queries_bn3[i], labels_bn[i],
            None if prompt_features_bnc is None else prompt_features_bnc[i],
            None if prompt_feature_labels_bn is None else prompt_feature_labels_bn[i], kernels,
        )
        for i in range(enc_features.shape[0])
    ]
    item = {k: torch.stack([it[k] for it in items]) for k in items[0]}
    t = cfg.task_name
    out = {f"{t}_traj_est_bn2t": item["traj_nt2"].transpose(2, 3)}
    if cfg.estimate_vis:
        out[f"{t}_vis_est_bn1t"] = item["vis_nt"][:, :, None]
    if cfg.estimate_depth:
        out[f"{t}_depth_est_bn1t"] = item["depth_nt"][:, :, None]
    if cfg.prompt_using_features:
        out[f"{t}_prompt_features_bnc"] = item["prompt_features_nc"]
    if cfg.attend_to_past:
        out[f"{t}_enc_history_kept_bnpc"] = item["enc_history_kept_npc"]
    return out


def init_track_carry(head: TrackHead, cfg: TrackConfig, queries_bn3: torch.Tensor, num_tokens: int,
                     mdtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The windowed scan's carry before window 0: the queries, the prompt
    features and labels, the token memory's kept half (the mask token) and
    window-length output buffers at their initial values (traj 0, vis -10,
    depth 0)."""
    b, n = queries_bn3.shape[:2]
    c, ws = cfg.sam.embed_dim, cfg.image_size[0]
    dtype, dev = queries_bn3.dtype, queries_bn3.device
    carry = {
        "queries": queries_bn3,
        "prompt_feats": torch.zeros((b, n, c), dtype=mdtype, device=dev),
        "prompt_labels": torch.zeros((b, n), dtype=dtype, device=dev),
        "traj": torch.zeros((b, n, 2, ws), dtype=dtype, device=dev),
        "vis": torch.full((b, n, 1, ws), -10.0, dtype=dtype, device=dev),
        "depth": torch.zeros((b, n, 1, ws), dtype=dtype, device=dev),
    }
    if cfg.attend_to_past:
        mask_tok = head.processed_video_mask_token.weight[0].to(mdtype)
        carry["history"] = mask_tok.expand(b, n, num_tokens // 2, c)
    return carry


def track_window_step(head: TrackHead, cfg: TrackConfig, carry: Dict[str, torch.Tensor], enc_bpc: torch.Tensor,
                      queries0_bn3: torch.Tensor, window: int, window_stride: int,
                      kernels: TrackKernels = KERNELS) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One window of the causal scan (reference forward_windowed_core,
    sparse_heads.py:213-495): window `window`'s final features (B, P, C) and
    the carry -> (the next carry, the `window_stride` frames from the
    window's start that no later window writes: TRACK_BUFFERS, traj (B, N,
    2, s), vis and depth (B, N, 1, s)). The output buffers cover the window's frames: the
    previous window's shifted by the stride, with initial values in the
    tail, which is what the reference's video-length buffers hold there.
    `queries0_bn3` are the input queries (the label rule compares them)."""
    b, p, c = enc_bpc.shape
    n = queries0_bn3.shape[1]
    ws, s = cfg.image_size[0], window_stride
    dtype, mdtype, dev = queries0_bn3.dtype, enc_bpc.dtype, queries0_bn3.device
    tname = cfg.task_name
    start = window * s
    cur_q = carry["queries"]
    frame_ids = torch.arange(ws, dtype=dtype, device=dev)
    # results exist at t >= query time
    valid_t = (frame_ids[None, None, :] + float(start) + 0.5 - cur_q[:, :, 0:1]) >= 0
    valid_bn1t = valid_t[:, :, None]
    valid_bn = valid_t.sum(-1) > 0
    # labels 0/1/2; the order matters: the equals-input pass sets 1 even for queries not
    # yet valid, then valid queries that are not the input get 2 (track.py:415-423)
    lab = valid_bn.to(dtype)
    if cfg.modify_pointlabels_for_windowing:
        eq_input = (cur_q == queries0_bn3).sum(-1) > 0
        lab = torch.where(eq_input, torch.ones_like(lab), lab)
        lab = torch.where(valid_bn & ~eq_input, torch.full_like(lab, 2.0), lab)
    q_off = cur_q.clone()
    q_off[:, :, 0] -= float(start)

    enc = enc_bpc
    if cfg.attend_to_past:
        # the carry holds the kept half of the token memory; the other half is the mask token
        mask_tok = head.processed_video_mask_token.weight[0].to(mdtype)
        first = enc[:, None, : p // 2] + carry["history"]
        second = (enc[:, p // 2:] + mask_tok)[:, None].expand(b, n, p - p // 2, c)
        enc = torch.cat([first, second], dim=2)
    out = track_forward(head, cfg, enc, q_off, lab, carry["prompt_feats"], carry["prompt_labels"], kernels)
    del enc

    def masked_write(key: str, vals: torch.Tensor) -> torch.Tensor:
        buf = carry[key]
        init = torch.zeros_like(buf[..., :s]) if key != "vis" else torch.full_like(buf[..., :s], -10.0)
        return torch.where(valid_bn1t, vals.to(buf.dtype), torch.cat([buf[..., s:], init], dim=-1))

    new = dict(carry)
    new["vis"] = masked_write("vis", out[f"{tname}_vis_est_bn1t"])
    new["traj"] = masked_write("traj", out[f"{tname}_traj_est_bn2t"])
    if cfg.estimate_depth:
        new["depth"] = masked_write("depth", out[f"{tname}_depth_est_bn1t"])
    if cfg.prompt_using_features:
        new["prompt_feats"] = torch.where(valid_bn[..., None], out[f"{tname}_prompt_features_bnc"].to(mdtype),
                                          carry["prompt_feats"])
        new["prompt_labels"] = torch.where(valid_bn, torch.ones_like(carry["prompt_labels"]), carry["prompt_labels"])
    if cfg.attend_to_past:
        new["history"] = out[f"{tname}_enc_history_kept_bnpc"].to(mdtype)
    # re-query at the frame of highest visibility inside the next overlap: the buffers' frames after the stride
    best = torch.argmax(new["vis"][:, :, 0, s:], dim=-1)  # the first maximum, as jnp.argmax
    best_xy = torch.take_along_dim(new["traj"][..., s:], best[:, :, None, None].expand(b, n, 2, 1), dim=-1)[..., 0]
    new_t = best.to(dtype) + float(start + s) + 0.5
    cand = torch.cat([new_t[..., None], best_xy], dim=-1)
    new["queries"] = torch.where((cand[..., 0] > cur_q[..., 0])[..., None], cand, cur_q)
    return new, {k: new[k][..., :s] for k in TRACK_BUFFERS}


def track_tail(carry: Dict[str, torch.Tensor], window_stride: int) -> Dict[str, torch.Tensor]:
    """The last window's frames after its first stride, which are final too."""
    return {k: carry[k][..., window_stride:] for k in TRACK_BUFFERS}


def track_outputs(cfg: TrackConfig, parts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{traj, vis, depth} buffers -> the session's track_2d output keys
    (depth only when the head estimates it)."""
    t = cfg.task_name
    out = {f"{t}_traj_est_bn2t": parts["traj"], f"{t}_vis_est_bn1t": parts["vis"]}
    if cfg.estimate_depth:
        out[f"{t}_depth_est_bn1t"] = parts["depth"]
    return out


def track_forward_windowed(head: TrackHead, cfg: TrackConfig, enc_final_wbpc: torch.Tensor,
                           queries_bn3: torch.Tensor, labels_bn: Optional[torch.Tensor], window_stride: int = 8,
                           kernels: TrackKernels = KERNELS, chunk: int = 0) -> Dict[str, torch.Tensor]:
    """Causal sliding-window tracking, forward direction: `track_window_step`
    over the windows of enc_final_wbpc (num_windows, B, P, C) -> traj (B, N,
    2, T), vis and depth (B, N, 1, T). Frames before a query's time keep the
    buffers' initial values. The labels are recomputed per window from the
    queries' validity, as the reference does. `chunk` (the query chunk's
    index) labels each window's span."""
    del labels_bn
    nw, _, p, _ = enc_final_wbpc.shape
    carry = init_track_carry(head, cfg, queries_bn3, p, enc_final_wbpc.dtype)
    emits = []
    for w in range(nw):
        with profiling.span("track.window", window=w, chunk=chunk):
            carry, emit = track_window_step(head, cfg, carry, enc_final_wbpc[w], queries_bn3, w, window_stride,
                                            kernels)
        emits.append(emit)
    emits.append(track_tail(carry, window_stride))
    return track_outputs(cfg, {k: torch.cat([e[k] for e in emits], dim=-1) for k in TRACK_BUFFERS})
