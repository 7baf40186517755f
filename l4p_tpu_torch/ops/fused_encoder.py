"""All encoder blocks on pre-embedded tokens: the hand-written Hopper kernels
and their plain version.

`fused_encoder_blocks` runs ``csrc/fused_encoder.cu``, which replaces the
Pallas TPU kernel ``l4p_tpu/ops/fused_encoder.py:_encoder_kernel`` (the
source's header says what bounds it on the card and how the design answers
that): per block a LayerNorm row kernel, a bf16 GEMM whose epilogue writes
q/k/v head-major, the attention of ``csrc/attention.cuh``, a GEMM that adds
the projection onto the residual stream, a LayerNorm, a GEMM with the GELU
epilogue and a GEMM that adds the MLP output: 7 launches per block.
`fused_encoder_blocks_plain` runs the port's `Block` with the plain
attention. Both return the stack (B, len(hook_ends), N, E) whose entry i is
x after block hook_ends[i] - 1; the caller adds the final LayerNorm.

`fused_encoder_unsupported` is the one gate of the kernel path. For tensors
on the CPU the wrapper runs the plain version; for CUDA tensors it launches
the kernels or raises, never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from l4p_tpu_torch import _build
from l4p_tpu_torch.config import EncoderConfig
from l4p_tpu_torch.ops.conv import gelu, linear
from l4p_tpu_torch.ops.flash_attention import flash_attention_plain, kernel_row_pitch, launch_error

NAME = "fused_encoder"
SOURCES = ("fused_encoder.cu",)
MAX_HEAD_DIM = 96  # the fused path's attention pads D to 64 or 96 in shared memory
QKV, GELU, RESIDUAL = 0, 1, 2  # the GEMM epilogues of csrc/fused_encoder.cu
LAUNCHES_PER_BLOCK = 7


def fused_encoder_unsupported(cfg: EncoderConfig, dtype: torch.dtype, device: torch.device) -> Optional[str]:
    """The condition the kernel path does not meet, or None. bf16 is needed
    only on CUDA; the shape conditions hold on every device, so a CPU run
    refuses what the card would."""
    if device.type == "cuda" and dtype != torch.bfloat16:
        return f"the kernels take bf16 on CUDA, got {dtype}"
    e, heads, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    if heads * d != e:
        return f"embed_dim {e} is not num_heads {heads} x head_dim {d}"
    if d % 8 or d > MAX_HEAD_DIM:
        return f"head_dim {d} must be a multiple of 8 and at most {MAX_HEAD_DIM}"
    if e % 8 or cfg.mlp_hidden % 8:
        return f"embed_dim {e} and mlp width {cfg.mlp_hidden} must be multiples of 8 (16-byte cp.async rows)"
    return None


def _hook_ends(cfg: EncoderConfig, hook_ends: Sequence[int]) -> Tuple[int, ...]:
    ends = tuple(hook_ends)
    if not ends or list(ends) != sorted(set(ends)) or ends[0] < 1 or ends[-1] > cfg.depth:
        raise ValueError(f"hook_ends {ends} must rise strictly within 1..{cfg.depth}")
    return ends


def fused_encoder_blocks_plain(blocks: Sequence[torch.nn.Module], x: torch.Tensor, cfg: EncoderConfig,
                               hook_ends: Sequence[int]) -> torch.Tensor:
    """The port's `Block` math (models/encoder.py) with the plain attention."""
    ends = _hook_ends(cfg, hook_ends)
    feats = []
    for i, blk in enumerate(blocks[: ends[-1]]):
        x = blk(x, flash_attention_plain)
        if i + 1 in ends:
            feats.append(x)
    return torch.stack(feats, dim=1)


def _kernels():
    lib = _build.load(NAME, SOURCES)
    ln, gemm, attn = lib.l4p_ln_rows_bf16, lib.l4p_gemm_nt_bf16, lib.l4p_encoder_attention_bf16
    ln.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
    gemm.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    attn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    for fn in (ln, gemm, attn):
        fn.restype = ctypes.c_int
    return ln, gemm, attn


def _block_params(blk) -> Tuple[torch.Tensor, ...]:
    a = blk.attn
    qkv_bias = torch.cat([a.q_bias, torch.zeros_like(a.v_bias), a.v_bias])  # no k bias
    return (blk.norm1.weight, blk.norm1.bias, a.qkv.weight, qkv_bias, a.proj.weight, a.proj.bias,
            blk.norm2.weight, blk.norm2.bias, blk.mlp.fc1.weight, blk.mlp.fc1.bias, blk.mlp.fc2.weight,
            blk.mlp.fc2.bias)


def fused_encoder_blocks(blocks: Sequence[torch.nn.Module], x: torch.Tensor, cfg: EncoderConfig,
                         hook_ends: Sequence[int]) -> torch.Tensor:
    """x (B, N, E) tokens with the position table added -> (B, len(hook_ends),
    N, E); `blocks` are the encoder's `Block`s in the released names."""
    ends = _hook_ends(cfg, hook_ends)
    if x.dim() != 3 or x.shape[2] != cfg.embed_dim or len(blocks) < ends[-1] or min(x.shape) == 0:
        raise ValueError(f"fused_encoder_blocks: x{tuple(x.shape)} with {len(blocks)} blocks does not fit "
                         f"embed_dim {cfg.embed_dim}, ends {ends}")
    reason = fused_encoder_unsupported(cfg, x.dtype, x.device)
    if reason is not None:
        raise ValueError(f"fused_encoder_blocks: {reason}")
    params = [_block_params(blk) for blk in blocks[: ends[-1]]]
    devices = {x.device} | {p.device for ps in params for p in ps}
    if devices == {torch.device("cpu")}:
        return fused_encoder_blocks_plain(blocks, x, cfg, ends)
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"fused_encoder_blocks: x and the weights must lie on one CUDA device, got {devices}")
    if any(p.dtype != torch.bfloat16 or not p.is_contiguous() for ps in params for p in ps):
        raise ValueError("fused_encoder_blocks: the block weights must be contiguous bf16")
    b, n, e = x.shape
    m, heads, hd, hidden = b * n, cfg.num_heads, cfg.head_dim, cfg.mlp_hidden
    xw = x.contiguous().clone()  # the residual stream, updated in place by the RESIDUAL epilogues
    stack = torch.empty((len(ends), b, n, e), device=x.device, dtype=x.dtype)
    ln_out = torch.empty((b, n, e), device=x.device, dtype=x.dtype)
    qkv = torch.empty((3, b, heads, n, kernel_row_pitch(hd)), device=x.device, dtype=x.dtype)  # the QKV epilogue's rows
    attn_out = torch.empty((b, n, e), device=x.device, dtype=x.dtype)
    mlp_hidden = torch.empty((m, hidden), device=x.device, dtype=x.dtype)  # 126 MB at 5 giant windows
    ln, gemm, attn = _kernels()
    scale = float(hd ** -0.5)
    null = ctypes.c_void_p(None)

    def check(err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"fused_encoder_blocks: {what} launch failed: {launch_error(err)}")
        fused_encoder_blocks.kernel_launches += 1

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for i, (n1w, n1b, wqkv, bqkv, wp, bp, n2w, n2b, w1, b1, w2, b2) in enumerate(params):
            slot = ends.index(i + 1) if i + 1 in ends else None
            copy = stack[slot].data_ptr() if slot is not None else null
            check(ln(xw.data_ptr(), n1w.data_ptr(), n1b.data_ptr(), ln_out.data_ptr(), m, e, cfg.ln_eps, stream),
                  "ln1")
            check(gemm(ln_out.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), qkv.data_ptr(), null, m, 3 * e, e, QKV,
                       n, heads, hd, stream), "qkv")
            check(attn(qkv.data_ptr(), attn_out.data_ptr(), b, heads, n, hd, scale, stream), "attention")
            check(gemm(attn_out.data_ptr(), wp.data_ptr(), bp.data_ptr(), xw.data_ptr(), null, m, e, e, RESIDUAL,
                       n, heads, hd, stream), "proj")
            check(ln(xw.data_ptr(), n2w.data_ptr(), n2b.data_ptr(), ln_out.data_ptr(), m, e, cfg.ln_eps, stream),
                  "ln2")
            check(gemm(ln_out.data_ptr(), w1.data_ptr(), b1.data_ptr(), mlp_hidden.data_ptr(), null, m, hidden, e,
                       GELU, n, heads, hd, stream), "fc1")
            check(gemm(mlp_hidden.data_ptr(), w2.data_ptr(), b2.data_ptr(), xw.data_ptr(), copy, m, e, hidden,
                       RESIDUAL, n, heads, hd, stream), "fc2")
    fused_encoder_blocks.launches += 1
    return stack.transpose(0, 1)  # (B, K, N, E); each stack[:, i] stays contiguous


fused_encoder_blocks.launches = 0  # calls that ran on the kernels since the last reset
fused_encoder_blocks.kernel_launches = 0  # the kernel launches inside them (7 per block)


def linear_gelu_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return gelu(linear(a, w, bias))


def linear_gelu(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(M, K) x (N, K) -> gelu(a w^T + bias) (M, N): one launch of the blocks'
    GEMM with its GELU epilogue (the fc1 step), for checking and timing that
    GEMM on its own."""
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1] or bias.shape != (w.shape[0],):
        raise ValueError(f"linear_gelu: incompatible shapes a{tuple(a.shape)} w{tuple(w.shape)} bias{tuple(bias.shape)}")
    devices = {a.device, w.device, bias.device}
    if devices == {torch.device("cpu")}:
        return linear_gelu_plain(a, w, bias)
    if len(devices) != 1 or a.device.type != "cuda":
        raise ValueError(f"linear_gelu: operands must lie on one CUDA device, got {devices}")
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous() for t in (a, w, bias)):
        raise ValueError("linear_gelu: the kernel takes contiguous bf16 operands")
    (m, k), n = a.shape, w.shape[0]
    if k % 8 or n % 8:
        raise ValueError(f"linear_gelu: K {k} and N {n} must be multiples of 8")
    out = torch.empty((m, n), device=a.device, dtype=a.dtype)
    with torch.cuda.device(a.device):
        err = _kernels()[1](a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), ctypes.c_void_p(None), m,
                            n, k, GELU, 1, 1, 2, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"linear_gelu: kernel launch failed with CUDA error {err}")
    linear_gelu.launches += 1
    return out


linear_gelu.launches = 0
