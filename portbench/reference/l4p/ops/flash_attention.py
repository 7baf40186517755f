"""The encoder attention of the reference: plain multi-head attention."""

from __future__ import annotations

import torch

from portbench.reference.l4p.ops.attention import mha


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    return mha(q, k, v, scale)


flash_attention = flash_attention_plain
