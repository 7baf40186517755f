"""The promptable point-track head: one window and the causal sliding-window
scan (counterpart of l4p_tpu/models/track.py).

Queries are the decoder's batch axis. The windowed scan is a Python loop
over windows whose carry is the re-queries, the prompt features and labels,
the kept half of the per-query token memory and the T-length output
buffers; the JAX package's lax.scan exists for XLA's compiler.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

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

XY_CHUNK = 32  # queries per full-resolution heatmap (the heatmap is the head's largest tensor)


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

        def weights(m):
            return torch.as_tensor(m, device=dev).to(dt).float()

        wh = weights(interp_matrix(h2, big_h, False).mean(axis=0))
        ww = weights(interp_matrix(w2, big_w, False).mean(axis=0))
        mt = weights(interp_matrix(t2, big_t, False))
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


def track_forward_windowed(head: TrackHead, cfg: TrackConfig, enc_final_wbpc: torch.Tensor,
                           queries_bn3: torch.Tensor, labels_bn: torch.Tensor, window_stride: int = 8,
                           kernels: TrackKernels = KERNELS) -> Dict[str, torch.Tensor]:
    """Causal sliding-window tracking, forward direction (reference
    forward_windowed_core, sparse_heads.py:213-495). enc_final_wbpc:
    (num_windows, B, P, C) -> traj (B, N, 2, T), vis and depth (B, N, 1, T).
    Frames before a query's time keep the buffers' initial values."""
    nw, b, p, c = enc_final_wbpc.shape
    n = queries_bn3.shape[1]
    ws = cfg.image_size[0]
    t_total = (nw - 1) * window_stride + ws
    dtype, mdtype, dev = queries_bn3.dtype, enc_final_wbpc.dtype, queries_bn3.device
    tname = cfg.task_name

    mask_tok = history = None
    if cfg.attend_to_past:
        # the carry holds the kept half of the token memory; the other half is the mask token
        mask_tok = head.processed_video_mask_token.weight[0].to(mdtype)
        history = mask_tok.expand(b, n, p // 2, c)
    cur_q = queries_bn3
    prompt_feats = torch.zeros((b, n, c), dtype=mdtype, device=dev)
    prompt_labels = torch.zeros((b, n), dtype=dtype, device=dev)
    traj = torch.zeros((b, n, 2, t_total), dtype=dtype, device=dev)
    vis = torch.full((b, n, 1, t_total), -10.0, dtype=dtype, device=dev)
    depth = torch.zeros((b, n, 1, t_total), dtype=dtype, device=dev)
    frame_ids = torch.arange(ws, dtype=dtype, device=dev)

    for w in range(nw):
        start = w * window_stride
        # results exist at t >= query time
        valid_t = (frame_ids[None, None, :] + float(start) + 0.5 - cur_q[:, :, 0:1]) >= 0
        valid_bn1t = valid_t[:, :, None]
        valid_bn = valid_t.sum(-1) > 0
        # labels 0/1/2; the order matters: the equals-input pass sets 1 even for queries not
        # yet valid, then valid queries that are not the input get 2 (track.py:415-423)
        lab = valid_bn.to(dtype)
        if cfg.modify_pointlabels_for_windowing:
            eq_input = (cur_q == queries_bn3).sum(-1) > 0
            lab = torch.where(eq_input, torch.ones_like(lab), lab)
            lab = torch.where(valid_bn & ~eq_input, torch.full_like(lab, 2.0), lab)
        q_off = cur_q.clone()
        q_off[:, :, 0] -= float(start)

        enc = enc_final_wbpc[w]
        if cfg.attend_to_past:
            first = enc[:, None, : p // 2] + history
            second = (enc[:, p // 2:] + mask_tok)[:, None].expand(b, n, p - p // 2, c)
            enc = torch.cat([first, second], dim=2)
        out = track_forward(head, cfg, enc, q_off, lab, prompt_feats, prompt_labels, kernels)
        del enc

        window = slice(start, start + ws)

        def masked_write(buf, vals):
            buf[..., window] = torch.where(valid_bn1t, vals.to(buf.dtype), buf[..., window])

        masked_write(vis, out[f"{tname}_vis_est_bn1t"])
        masked_write(traj, out[f"{tname}_traj_est_bn2t"])
        if cfg.estimate_depth:
            masked_write(depth, out[f"{tname}_depth_est_bn1t"])

        # the next window's carry (unused after the last window)
        if cfg.prompt_using_features:
            prompt_feats = torch.where(valid_bn[..., None], out[f"{tname}_prompt_features_bnc"].to(mdtype),
                                       prompt_feats)
            prompt_labels = torch.where(valid_bn, torch.ones_like(prompt_labels), prompt_labels)
        if cfg.attend_to_past:
            history = out[f"{tname}_enc_history_kept_bnpc"].to(mdtype)
        # re-query at the frame of highest visibility inside the next overlap
        next_start = start + window_stride
        overlap = slice(next_start, next_start + ws - window_stride)
        best = torch.argmax(vis[:, :, 0, overlap], dim=-1)  # the first maximum, as jnp.argmax
        best_xy = torch.take_along_dim(traj[..., overlap], best[:, :, None, None].expand(b, n, 2, 1), dim=-1)[..., 0]
        new_t = best.to(dtype) + float(next_start) + 0.5
        cand = torch.cat([new_t[..., None], best_xy], dim=-1)
        cur_q = torch.where((cand[..., 0] > cur_q[..., 0])[..., None], cand, cur_q)

    out = {f"{tname}_traj_est_bn2t": traj, f"{tname}_vis_est_bn1t": vis}
    if cfg.estimate_depth:
        out[f"{tname}_depth_est_bn1t"] = depth
    return out
