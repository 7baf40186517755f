"""Checkpoints: the model factory, the encoder overlay, and the JAX
package's parameter tree -> the port's state dict.

`prepare_model` (counterpart of l4p_tpu/config.py:229-252) builds the model
of a reference-schema YAML from a released Lightning `.ckpt` (strict) or
from seeded random weights, overlaid with an encoder-only checkpoint by
`load_video_encoder_ckpt` (l4p_tpu/config.py:255-301) when the YAML names
one. `params_from_jax` is the inverse of
`convert_encoder`/`convert_dpt`/`convert_track_head`
(l4p_tpu/checkpoint.py:71-110, :258-300, :308-385): keys come out in the
released checkpoint's layout without the Lightning `l4p_model.` prefix, so
`L4P(cfg).load_state_dict(sd, strict=True)` accepts them. The tree may hold
numpy arrays or anything `np.asarray` reads; heads that `cfg` does not
configure are ignored.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from l4p_tpu_torch.config import DPTConfig, EncoderConfig, L4PConfig, TrackConfig, load_model_config
from l4p_tpu_torch.models.dpt import rescale_kind
from l4p_tpu_torch.models.encoder import VideoEncoder
from l4p_tpu_torch.models.l4p import L4P

LIGHTNING_PREFIX = "l4p_model."


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _encoder_state(p: Mapping, cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    e, tt, ps = cfg.embed_dim, cfg.tubelet_size, cfg.patch_size
    sd = {
        "patch_embed.proj.weight": _t(p["patch_embed"]["weight"]).reshape(e, cfg.in_chans, tt, ps, ps),
        "patch_embed.proj.bias": _t(p["patch_embed"]["bias"]),
        "norm.weight": _t(p["norm"]["weight"]),
        "norm.bias": _t(p["norm"]["bias"]),
    }
    blocks = {k: _t(v) for k, v in p["blocks"].items()}
    names = {
        "norm1.weight": "norm1_w", "norm1.bias": "norm1_b",
        "attn.q_bias": "q_bias", "attn.v_bias": "v_bias",
        "attn.proj.weight": "proj_w", "attn.proj.bias": "proj_b",
        "norm2.weight": "norm2_w", "norm2.bias": "norm2_b",
        "mlp.fc1.weight": "fc1_w", "mlp.fc1.bias": "fc1_b",
        "mlp.fc2.weight": "fc2_w", "mlp.fc2.bias": "fc2_b",
    }
    if cfg.cos_attn:
        names["attn.scale"] = "attn_scale"
    if cfg.init_values > 0:
        names.update(gamma_1="gamma_1", gamma_2="gamma_2")
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        sd[pre + "attn.qkv.weight"] = blocks["qkv_w"][i].reshape(3 * e, e)  # (3, E, E) -> fused (3E, E)
        for ours, theirs in names.items():
            sd[pre + ours] = blocks[theirs][i]
    if cfg.use_learnable_pos_emb:
        sd["pos_embed"] = _t(p["pos_embed"])
    if cfg.cam_emb_placed_at is not None:
        sd["cam_emb.cam_emb_proj.weight"] = _t(p["cam_emb"]["weight"])
        sd["cam_emb.cam_emb_proj.bias"] = _t(p["cam_emb"]["bias"])
    return sd


def _dpt_state(p: Mapping, cfg: DPTConfig) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}

    def conv(name: str, q: Mapping) -> None:
        sd[name + ".weight"] = _t(q["weight"])
        if "bias" in q:
            sd[name + ".bias"] = _t(q["bias"])

    for i, sf in enumerate(cfg.actpost_scale_factors):
        conv(f"dpt.act_postprocess.{i}.0", p["act_postprocess"][i]["proj"])
        if rescale_kind(sf) != "id":
            conv(f"dpt.act_postprocess.{i}.1", p["act_postprocess"][i]["rescale"])
    for i in range(4):
        conv(f"dpt.scratch.layer{i + 1}_rn", p["layer_rn"][i])
        conv(f"dpt.scratch.layer_rn.{i}", p["layer_rn"][i])  # the released alias
        rn, pre = p["refinenet"][i], f"dpt.scratch.refinenet{i + 1}"
        for unit in ("resConfUnit1", "resConfUnit2"):
            conv(f"{pre}.{unit}.conv1", rn[unit]["conv1"])
            conv(f"{pre}.{unit}.conv2", rn[unit]["conv2"])
        conv(f"{pre}.out_conv", rn["out_conv"])
    conv("dpt.head1.0", p["head1"])
    conv("dpt.head2.0", p["head2_0"])
    conv("dpt.head2.2", p["head2_2"])
    return sd


def _track_state(p: Mapping, cfg: TrackConfig) -> Dict[str, torch.Tensor]:
    """The track head; stacked embeddings become one (1, C) entry each. The
    reference's `iou_token` and `no_mask_embed` have no JAX counterpart and
    are never read by the video forward: they come out as zeros."""
    sd: Dict[str, torch.Tensor] = {}

    def lin(name: str, q: Mapping) -> None:
        sd[name + ".weight"] = _t(q["weight"])
        sd[name + ".bias"] = _t(q["bias"])

    def rows(name: str, stacked, count: int) -> None:
        for i in range(count):
            sd[f"{name}.{i}.weight"] = _t(stacked)[i][None]

    pe = p["prompt_encoder"]
    gauss = _t(pe["pe_gaussian"])
    c = gauss.shape[1] * 2
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = gauss
    rows("prompt_encoder.point_embeddings", pe["point_embeddings"], cfg.sam.num_point_embeddings)
    sd["prompt_encoder.not_a_point_embed.weight"] = _t(pe["not_a_point_embed"])[None]
    sd["prompt_encoder.no_mask_embed.weight"] = torch.zeros((1, c), dtype=gauss.dtype)
    if cfg.prompt_using_features:
        rows("prompt_encoder.prompt_feature_embeddings", pe["prompt_feature_embeddings"], 2)

    md = p["mask_decoder"]
    sd["mask_decoder.mask_tokens.weight"] = _t(md["mask_tokens"])
    sd["mask_decoder.iou_token.weight"] = torch.zeros((1, c), dtype=gauss.dtype)
    tf = md["transformer"]
    attns = ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token")
    for i, layer in enumerate(tf["layers"]):
        pre = f"mask_decoder.transformer.layers.{i}."
        for a in attns:
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                lin(f"{pre}{a}.{proj}", layer[a][proj])
        for norm in ("norm1", "norm2", "norm3", "norm4"):
            lin(pre + norm, layer[norm])
        lin(pre + "mlp.lin1", layer["mlp"]["lin1"])
        lin(pre + "mlp.lin2", layer["mlp"]["lin2"])
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        lin(f"mask_decoder.transformer.final_attn_token_to_image.{proj}", tf["final_attn_token_to_image"][proj])
    lin("mask_decoder.transformer.norm_final_attn", tf["norm_final_attn"])
    up = md["upscale"]
    lin("mask_decoder.output_upscaling.0", up["deconv1"])
    lin("mask_decoder.output_upscaling.1", up["ln"])
    lin("mask_decoder.output_upscaling.3", up["deconv2"])
    for i, h in enumerate(md["hypernet"]):
        for j, layer in enumerate(h["layers"]):
            lin(f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}", layer)
    if cfg.prompt_using_features:
        lin("prompt_feature_linear_layer", p["prompt_feature_linear"])
    if cfg.attend_to_past:
        sd["processed_video_mask_token.weight"] = _t(p["processed_video_mask_token"])[None]
        lin("processed_video_features_proj", p["processed_video_features_proj"])
    return sd


def params_from_jax(tree: Mapping, cfg: L4PConfig) -> Dict[str, torch.Tensor]:
    """{'video_encoder': ..., 'task_heads': {task: ...}} -> state dict."""
    sd = {f"video_encoder.{k}": v for k, v in _encoder_state(tree["video_encoder"], cfg.encoder).items()}
    for name, hcfg in cfg.heads:
        for k, v in _dpt_state(tree["task_heads"][name], hcfg.dpt).items():
            sd[f"task_heads.{name}.task_head.{k}"] = v
    if cfg.track is not None:
        for k, v in _track_state(tree["task_heads"]["track_2d"], cfg.track).items():
            sd[f"task_heads.track_2d.{k}"] = v
    return sd


def released_state_dict(state_dict: Mapping[str, torch.Tensor], cfg: L4PConfig) -> Dict[str, torch.Tensor]:
    """A Lightning checkpoint's `state_dict` -> the port's keys: the
    `l4p_model.` prefix stripped (other keys kept, for the strict load to
    refuse). A configured head without a key raises KeyError naming it, as
    the JAX package's convert_l4p does (l4p_tpu/config.py:192-200). A
    learnable `pos_embed` longer than the encoder's tokens (a checkpoint of
    more frames) is cut to them, as convert_encoder does
    (l4p_tpu/checkpoint.py:124-125)."""
    sd = {k[len(LIGHTNING_PREFIX):] if k.startswith(LIGHTNING_PREFIX) else k: v for k, v in state_dict.items()}
    pos = "video_encoder.pos_embed"
    if cfg.encoder.use_learnable_pos_emb and pos in sd:
        sd[pos] = sd[pos][:, : cfg.encoder.num_tokens]
    prefixes = {name: f"task_heads.{name}.task_head." for name, _ in cfg.heads}
    if cfg.track is not None:
        prefixes["track_2d"] = "task_heads.track_2d."
    for name, pre in prefixes.items():
        if not any(k.startswith(pre) for k in sd):
            raise KeyError(f"checkpoint has no keys for configured head '{name}' (prefix '{LIGHTNING_PREFIX}{pre}')")
    return sd


def load_video_encoder_ckpt(encoder: VideoEncoder, path: Union[str, os.PathLike]) -> None:
    """Overlays an encoder-only torch checkpoint on `encoder`, in place: the
    reference's strict=False load (l4p_videomae.py:187-191; l4p_tpu/config.py:
    255-301). The file holds a state dict, raw or under 'state_dict', 'model'
    or 'module'; an 'encoder.' prefix (MAE pretraining) is dropped. Present
    tensors of the parameter's shape overlay it; a missing or mismatched one
    keeps the init, and a per-block tensor loads only when every block has
    it, as the JAX package stacks them. Extra keys are ignored. The options'
    tensors (cosine logit scales, LayerScale gains, a learnable `pos_embed`,
    cut to the encoder's tokens, and the camera projection) overlay by the
    same rules (l4p_tpu/checkpoint.py:182-201). A directory is the JAX
    package's own (orbax) checkpoint format, which needs JAX."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory: orbax checkpoints (scripts/pretrain_mae.py) are read by the JAX package; "
            "the port reads them once the MAE pretraining is ported")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "module"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    if not any(k.startswith("blocks.") for k in ckpt) and any(k.startswith("encoder.blocks.") for k in ckpt):
        ckpt = {k[len("encoder."):]: v for k, v in ckpt.items() if k.startswith("encoder.")}
    if encoder.cfg.use_learnable_pos_emb and "pos_embed" in ckpt:
        ckpt = {**ckpt, "pos_embed": ckpt["pos_embed"][:, : encoder.cfg.num_tokens]}
    params = encoder.state_dict()

    def fits(k: str) -> bool:
        return k in ckpt and tuple(ckpt[k].shape) == tuple(params[k].shape)

    per_block: Dict[str, list] = {}
    for k in params:
        m = re.fullmatch(r"blocks\.(\d+)\.(.+)", k)
        if m:
            per_block.setdefault(m.group(2), []).append(k)
        elif fits(k):
            params[k].copy_(ckpt[k])
    for keys in per_block.values():
        if all(fits(k) for k in keys):
            for k in keys:
                params[k].copy_(ckpt[k])


def prepare_model(path: Union[str, os.PathLike], ckpt_path: Optional[Union[str, os.PathLike]] = None,
                  max_queries: Optional[int] = None, dtype: torch.dtype = torch.bfloat16,
                  device: Union[str, torch.device] = "cuda") -> Tuple[L4P, L4PConfig, Tuple[str, ...]]:
    """The model of a reference-schema YAML, ready to serve: (model, cfg,
    tasks) (counterpart of l4p_tpu/config.py:229-252). With `ckpt_path`, the
    Lightning checkpoint's `state_dict` loads strictly (`released_state_dict`);
    without, random weights from `torch.Generator(device).manual_seed(0)`,
    overlaid with the YAML's `video_encoder_ckpt_path` when it names one.
    `max_queries` sets the track head's query chunk."""
    cfg, tasks = load_model_config(path)
    if max_queries is not None and cfg.track is not None:
        cfg = dataclasses.replace(cfg, track=dataclasses.replace(cfg.track, max_queries=max_queries))
    device = torch.device(device)
    model = L4P(cfg, device=device, dtype=dtype)
    with torch.no_grad():
        if ckpt_path is None:
            model.init_weights(torch.Generator(device=device).manual_seed(0))
            if cfg.video_encoder_ckpt_path:
                load_video_encoder_ckpt(model.video_encoder, cfg.video_encoder_ckpt_path)
        else:
            state = torch.load(ckpt_path, map_location="cpu", weights_only=True)["state_dict"]
            model.load_state_dict(released_state_dict(state, cfg), strict=True)
    return model.eval(), cfg, tasks
