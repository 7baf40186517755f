"""The JAX package's parameter tree -> the port's state dict.

The inverse of `convert_encoder`/`convert_dpt` (l4p_tpu/checkpoint.py:71-110,
:258-300): keys come out in the released checkpoint's layout without the
Lightning `l4p_model.` prefix, so `L4P(cfg).load_state_dict(sd, strict=True)`
accepts them. The tree may hold numpy arrays or anything `np.asarray` reads;
heads that `cfg` does not configure are ignored.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from l4p_tpu_torch.config import DPTConfig, EncoderConfig, L4PConfig
from l4p_tpu_torch.models.dpt import rescale_kind


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
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        sd[pre + "attn.qkv.weight"] = blocks["qkv_w"][i].reshape(3 * e, e)  # (3, E, E) -> fused (3E, E)
        for ours, theirs in names.items():
            sd[pre + ours] = blocks[theirs][i]
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


def params_from_jax(tree: Mapping, cfg: L4PConfig) -> Dict[str, torch.Tensor]:
    """{'video_encoder': ..., 'task_heads': {task: ...}} -> state dict."""
    sd = {f"video_encoder.{k}": v for k, v in _encoder_state(tree["video_encoder"], cfg.encoder).items()}
    for name, hcfg in cfg.heads:
        for k, v in _dpt_state(tree["task_heads"][name], hcfg.dpt).items():
            sd[f"task_heads.{name}.task_head.{k}"] = v
    return sd
