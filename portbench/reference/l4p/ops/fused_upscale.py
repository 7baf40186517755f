"""The track head's mask upscale and hypernetwork readout in the reference:
the plain version of the fused function."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.l4p.ops.lowp import q8

LN_EPS = 1e-6
PLAIN_CHUNK = 16  # queries per step of the plain version (bounds its fp32 temporaries)
# the kernel's padded widths of d1 and d2 (csrc/fused_upscale.cu kD1P, kD2P):
# the track head's 352 and 176 at C = 1408, and any narrower head zero-padded
D1P, D2P = 352, 176
MAX_M, MAX_OFFSETS = 4, 32  # mask tokens; k1 * k2 logits per (token, mask token)


def _dims(w1: torch.Tensor, w2: torch.Tensor):
    c, d1 = w1.shape[:2]
    d2 = w2.shape[1]
    return c, d1, d2, w1[0, 0].numel(), w2[0, 0].numel()


def fused_upscale_hypernet_plain(src, w1, b1, lnw, lnb, w2, b2, hyper) -> torch.Tensor:
    """src (N, P, C), w1 (C, d1, kt, kh, kw), w2 (d1, d2, lt, lh, lw),
    hyper (N, M, d2) -> (N, M, P, k1, k2) fp32. Products accumulate in fp32;
    the GELU outputs and the hypernetwork vectors are rounded to src's dtype,
    as the kernel rounds them."""
    n, p, _ = src.shape
    c, d1, d2, k1, k2 = _dims(w1, w2)
    dt = src.dtype
    wm1 = w1.flatten(2).permute(0, 2, 1).reshape(c, k1 * d1).to(dt).float()
    wm2 = w2.flatten(2).permute(0, 2, 1).reshape(d1, k2 * d2).to(dt).float()
    bias1 = b1.to(dt).float().repeat(k1)
    bias2 = b2.to(dt).float().repeat(k2)
    outs = []
    for i in range(0, n, PLAIN_CHUNK):
        x = torch.matmul(q8(src[i: i + PLAIN_CHUNK]).float(), q8(wm1)) + bias1
        x = F.layer_norm(x.unflatten(-1, (k1, d1)), (d1,), lnw.float(), lnb.float(), LN_EPS)
        x = F.gelu(x).to(dt).float()
        x = F.gelu(torch.matmul(q8(x), q8(wm2)) + bias2).to(dt).float()
        h = hyper[i: i + PLAIN_CHUNK].to(dt).float()
        outs.append(torch.einsum("npkld,nmd->nmpkl", x.unflatten(-1, (k2, d2)), h))
    return torch.cat(outs)


fused_upscale_hypernet = fused_upscale_hypernet_plain
