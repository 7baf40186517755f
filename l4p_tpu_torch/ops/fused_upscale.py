"""The mask decoder's upscale + hypernetwork contraction: a hand-written
Hopper kernel and its plain version.

`fused_upscale_hypernet` launches ``csrc/fused_upscale.cu``, which replaces
the Pallas TPU kernel ``l4p_tpu/ops/fused_upscale.py:_kernel`` (the
source's header says what bounds it on the card and how the design answers
that). Both deconvs of the upscale have kernel == stride, so each output
voxel depends on one token: per token and deconv1 offset (k1 of them) the
chain is src . W1[k1] + b1 -> LayerNorm(eps 1e-6) -> GELU -> . W2[k2] + b2
-> GELU -> dot with each mask token's hypernetwork vector. The result keeps
the offsets packed, (N, M, P, k1, k2) fp32, as the JAX package's
`fused_upscale_hypernet` and `_upscale_xla` return it. GELU is the exact
erf form in every dtype (the XLA path's; the TPU kernel's polynomial erf was
a Pallas workaround).

The wrapper runs the plain version on the CPU and the kernel on bf16
tensors on one CUDA device (`_build.route`, `_build.launch`), never falling
back, through `FusedUpscaleFunction`, whose backward recomputes the plain
version (ops/recompute.py), as `_fused_bwd` recomputes `_upscale_xla`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from l4p_tpu_torch import _build
from l4p_tpu_torch.ops.recompute import recomputing_function

NAME = "fused_upscale"
SOURCES = ("fused_upscale.cu",)
KERNEL = _build.kernel(NAME, SOURCES, "l4p_fused_upscale_bf16", "p" * 9 + "i" * 9 + "fp")
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
        x = torch.matmul(src[i: i + PLAIN_CHUNK].float(), wm1) + bias1
        x = F.layer_norm(x.unflatten(-1, (k1, d1)), (d1,), lnw.float(), lnb.float(), LN_EPS)
        x = F.gelu(x).to(dt).float()
        x = F.gelu(torch.matmul(x, wm2) + bias2).to(dt).float()
        h = hyper[i: i + PLAIN_CHUNK].to(dt).float()
        outs.append(torch.einsum("npkld,nmd->nmpkl", x.unflatten(-1, (k2, d2)), h))
    return torch.cat(outs)


def pack_weights(w1, b1, lnw, lnb, w2, b2):
    """Kernel layout: w1 -> (k1, D1P, C) and w2 -> (k2, D2P, D1P) bf16, one
    (n, k) row-major matrix per offset (the products' K-major B operands,
    read by TMA), with d1 zero-padded to D1P and d2 to D2P; vectors fp32.
    All padding is zero, which is exact: padded deconv1 columns are left out
    of the LayerNorm and come out of it as 0 (their LayerNorm weight and
    bias are 0), GELU(0) = 0, and the padded hypernetwork entries are 0."""
    c, d1, d2, k1, k2 = _dims(w1, w2)
    d1p, d2p = D1P, D2P
    dev = w1.device
    w1t = torch.zeros((k1, d1p, c), device=dev, dtype=torch.bfloat16)
    w1t[:, :d1] = w1.flatten(2).permute(2, 1, 0)
    w2t = torch.zeros((k2, d2p, d1p), device=dev, dtype=torch.bfloat16)
    w2t[:, :d2, :d1] = w2.flatten(2).permute(2, 1, 0)

    def vec(v, size, dtype=torch.float32):  # the deconv biases round to the compute dtype first
        out = torch.zeros(size, device=dev, dtype=torch.float32)
        out[: v.numel()] = v.to(dtype).float()
        return out

    bf16 = torch.bfloat16
    return w1t, vec(b1, d1p, bf16), vec(lnw, d1p), vec(lnb, d1p), w2t, vec(b2, d2p, bf16)


def launch_args(src, w1, b1, lnw, lnb, w2, b2, hyper):
    """(out, the C entry point's arguments but the stream, the tensors they
    point into) for operands the wrapper has checked: the packed weights,
    the zero-padded hypernetwork vectors and the (N, M, P, k1, k2) fp32
    output to be written. Keep the third item alive until the launch."""
    n, p, c = src.shape
    _, d1, _, k1, k2 = _dims(w1, w2)
    m = hyper.shape[1]
    packed = pack_weights(w1, b1, lnw, lnb, w2, b2)
    w1t, b1p, lnwp, lnbp, w2t, b2p = packed
    d1p, d2p = w1t.shape[1], w2t.shape[1]
    hyp = torch.zeros((n, m, d2p), device=src.device, dtype=torch.bfloat16)
    hyp[:, :, : hyper.shape[2]] = hyper
    out = torch.empty((n, m, p, k1, k2), device=src.device, dtype=torch.float32)
    args = (src.data_ptr(), w1t.data_ptr(), b1p.data_ptr(), lnwp.data_ptr(), lnbp.data_ptr(), w2t.data_ptr(),
            b2p.data_ptr(), hyp.data_ptr(), out.data_ptr(), n, p, c, d1, d1p, d2p, k1, k2, m, LN_EPS)
    return out, args, (*packed, hyp)


def _forward(src, w1, b1, lnw, lnb, w2, b2, hyper) -> torch.Tensor:
    n, p, c = src.shape
    cw, d1, d2, k1, k2 = _dims(w1, w2)
    m = hyper.shape[1]
    if cw != c or hyper.shape != (n, m, d2) or w2.shape[0] != d1 or any(
            v.shape != (d1,) for v in (b1, lnw, lnb)) or b2.shape != (d2,):
        raise ValueError(f"fused_upscale_hypernet: incompatible shapes src{tuple(src.shape)} w1{tuple(w1.shape)} "
                         f"w2{tuple(w2.shape)} hyper{tuple(hyper.shape)}")
    if _build.route("fused_upscale_hypernet", src, w1, b1, lnw, lnb, w2, b2, hyper) == "plain":
        return fused_upscale_hypernet_plain(src, w1, b1, lnw, lnb, w2, b2, hyper)
    if src.dtype != torch.bfloat16:
        raise TypeError(f"fused_upscale_hypernet: the kernel takes bf16 tokens, got {src.dtype}")
    if not src.is_contiguous():
        raise ValueError("fused_upscale_hypernet: src must be contiguous")
    if src.data_ptr() % 16:
        raise ValueError("fused_upscale_hypernet: src must be 16-byte aligned")
    if (c % 32 or d1 > D1P or d2 > D2P or m > MAX_M or k1 * k2 > MAX_OFFSETS or min(n, p, m) == 0
            or n > 65535):
        raise ValueError(f"fused_upscale_hypernet: unsupported shape src{tuple(src.shape)} d1={d1} d2={d2} M={m} "
                         f"k1={k1} k2={k2} (needs C % 32 == 0, d1 <= {D1P}, d2 <= {D2P}, 1 <= M <= {MAX_M}, "
                         f"k1 * k2 <= {MAX_OFFSETS})")
    out, args, _keep = launch_args(src, w1, b1, lnw, lnb, w2, b2, hyper)
    _build.launch(fused_upscale_hypernet, KERNEL, src.device, *args)
    return out


FusedUpscaleFunction = recomputing_function("FusedUpscaleFunction", _forward, fused_upscale_hypernet_plain)


def fused_upscale_hypernet(src, w1, b1, lnw, lnb, w2, b2, hyper) -> torch.Tensor:
    """(N, P, C) tokens -> (N, M, P, k1, k2) fp32 packed logits, differentiable
    in every operand; shapes as in `fused_upscale_hypernet_plain`."""
    return FusedUpscaleFunction.apply(src, w1, b1, lnw, lnb, w2, b2, hyper)


fused_upscale_hypernet.launches = 0  # kernel launches since the last reset
