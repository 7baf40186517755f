"""Seeded weights made on the device, in the released state-dict names.

One uniform draw fills a flat buffer for every tensor of the state dict at
once; each tensor is then a view of it, scaled in place to the JAX
package's init distributions, which keep a deep random network's outputs
finite: the ViT encoder's matrices Xavier-uniform, with the fused qkv as
three square blocks; the heads' linear layers and convolutions uniform in
+-1/sqrt(fan_in); embeddings and the Fourier matrix with unit variance;
LayerNorm scales one; every other vector (biases) uniform in +-0.02. The
same seed gives the same tensors on the same device, so the program gets
them as they are served and the reference gets the same values in fp32,
made again after the program is freed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

TRANSFORMER = ("video_encoder.",)
UNIT_VARIANCE = ("embed", "gaussian")
ONE = 0.0  # the marker of a tensor set to one


def _scale(name: str, shape: Tuple[int, ...], mod: nn.Module) -> float:
    """The factor applied to U(-1, 1) for tensor `name` of module `mod`."""
    if len(shape) <= 1:
        return ONE if name.endswith("weight") and isinstance(mod, nn.LayerNorm) else 0.02
    if isinstance(mod, nn.Embedding) or any(k in name.rsplit(".", 1)[-1] for k in UNIT_VARIANCE):
        return math.sqrt(3.0)
    receptive = math.prod(shape[2:])
    if isinstance(mod, (nn.ConvTranspose3d, nn.ConvTranspose2d)):
        fan_in, fan_out = shape[0] * receptive, shape[1] * receptive
    else:
        fan_in, fan_out = math.prod(shape) // shape[0], shape[0] * receptive
    if name.startswith(TRANSFORMER):
        fan_out = shape[1] if name.endswith("qkv.weight") else shape[0]
        return math.sqrt(6.0 / (fan_in + fan_out))
    return 1.0 / math.sqrt(fan_in)


def layout(module: nn.Module) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, scale) of every floating tensor of the module's state dict."""
    owner = {}
    for mname, mod in module.named_modules():
        for pname, _ in list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False)):
            owner[f"{mname}.{pname}" if mname else pname] = mod
    return [(k, tuple(v.shape), _scale(k, tuple(v.shape), owner.get(k, module)))
            for k, v in module.state_dict().items() if v.is_floating_point()]


def seeded_state_dict(module: nn.Module, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor} for the module's state dict, views of one buffer."""
    items = layout(module)
    total = sum(math.prod(s) for _, s, _ in items)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, device=device, dtype=dtype).uniform_(-1.0, 1.0, generator=gen)
    out, off = {}, 0
    for name, shape, scale in items:
        n = math.prod(shape)
        t = flat[off: off + n].view(shape)
        off += n
        if scale == ONE:
            t.fill_(1.0)
        else:
            t.mul_(scale)
        out[name] = t
    return out
