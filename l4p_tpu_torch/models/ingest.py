"""uint8 video -> encoder tokens with the ImageNet normalisation folded into
the patch-embedding weights (counterpart of l4p_tpu/models/ingest.py).

The host ships raw uint8 frames; on the device one cast and one matmul
make the tokens, and the normalised float video never exists:
    W' = W * scale_c,  b' = b + W @ shift_c,  x_norm = x_u8 * scale_c + shift_c.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from l4p_tpu_torch.models.encoder import VideoEncoder, patchify
from l4p_tpu_torch.ops.conv import linear

# copied, not imported: the JAX package's data module imports jax
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def folded_patch_weights(proj: torch.nn.Module, mean: Optional[np.ndarray] = None,
                         std: Optional[np.ndarray] = None):
    """The patch embedding `proj` (a Conv3d or Conv2d with kernel == stride)
    as fp32 (W', b') that take uint8 pixels: W' = W * scale_c, b' = b + W @
    shift_c, the features in `patchify`'s order (c, dt, dh, dw)."""
    mean = IMAGENET_MEAN if mean is None else np.asarray(mean, np.float32)
    std = IMAGENET_STD if std is None else np.asarray(std, np.float32)
    device = proj.weight.device
    w_flat = proj.weight.flatten(1).float()  # (E, C*tt*p*p), feature order (c, dt, dh, dw)
    k_per_c = proj.weight[0, 0].numel()
    scale_k = torch.as_tensor(np.repeat(1.0 / (255.0 * std), k_per_c), dtype=torch.float32, device=device)
    shift_k = torch.as_tensor(np.repeat(-mean / std, k_per_c), dtype=torch.float32, device=device)
    return w_flat * scale_k, proj.bias.float() + w_flat @ shift_k


def ingest_video_tokens(
    encoder: VideoEncoder,
    rgb_u8_bthw3: torch.Tensor,
    mean: Optional[np.ndarray] = None,
    std: Optional[np.ndarray] = None,
    add_pos_embed: bool = True,
) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 -> (B, N_tokens, E) in the encoder's dtype.

    With add_pos_embed=False the caller adds the per-window position table
    (encode_windows tokenizes the whole video once, then slices windows)."""
    cfg = encoder.cfg
    dtype = encoder.patch_embed.proj.weight.dtype
    w_fold, b_fold = folded_patch_weights(encoder.patch_embed.proj, mean, std)
    x = patchify(rgb_u8_bthw3.to(dtype).permute(0, 4, 1, 2, 3), cfg)
    tok = linear(x, w_fold.to(dtype), b_fold.to(dtype))
    if add_pos_embed:
        tok = tok + encoder.pos_embed.to(dtype)
    return tok
