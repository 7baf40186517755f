"""All encoder blocks on pre-embedded tokens: the hand-written Hopper kernels
and their plain version.

`fused_encoder_blocks` runs ``csrc/fused_encoder.cu``, which replaces the
Pallas TPU kernel ``l4p_tpu/ops/fused_encoder.py:_encoder_kernel`` (the
source's header says what bounds it on the card and how the design answers
that): per block a LayerNorm row kernel, a bf16 GEMM whose epilogue writes
q/k/v head-major, the attention of ``csrc/attention.cuh``, a GEMM that adds
the projection onto the residual stream, a LayerNorm, a GEMM with the GELU
epilogue and a GEMM that adds the MLP output: 7 launches per block
(`EncoderWorkspace.block_steps`). The GEMM (`gemm_nt`, wgmma on TMA-fed
tiles, persistent) takes the width of its output tiles from
`gemm_tile_width`. `fused_encoder_blocks_plain` runs the port's `Block`
with the plain attention. Both return the stack (B, len(hook_ends), N, E)
whose entry i is x after block hook_ends[i] - 1; the caller adds the final
LayerNorm.

`fused_encoder_unsupported` is the one gate of the kernel path. For tensors
on the CPU the wrappers run the plain versions; for CUDA tensors they
launch the kernels or raise, never fall back.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from l4p_tpu_torch import _build
from l4p_tpu_torch.config import EncoderConfig
from l4p_tpu_torch.ops.conv import gelu, linear
from l4p_tpu_torch.ops.flash_attention import flash_attention_plain, kernel_row_pitch, launch_error

NAME = "fused_encoder"
SOURCES = ("fused_encoder.cu",)
MAX_HEAD_DIM = 96  # the fused path's attention pads D to 64 or 96 in shared memory
QKV, GELU, RESIDUAL = 0, 1, 2  # the GEMM epilogues of csrc/fused_encoder.cu
GEMM_TILE_WIDTHS = (256, 176)  # the output tile widths the GEMM is built for, widest first
LAUNCHES_PER_BLOCK = 7


def gemm_tile_width(n: int) -> int:
    """The GEMM's output tile width for N columns: the widest of
    GEMM_TILE_WIDTHS that divides N, else the one that pads N the least
    (the wider on a tie). Giant widths: 4224 and 1408 -> 176, 6144 -> 256."""
    return min(GEMM_TILE_WIDTHS, key=lambda bn: (-(-n // bn) * bn - n, -bn))


def fused_encoder_unsupported(cfg: EncoderConfig, dtype: torch.dtype, device: torch.device) -> Optional[str]:
    """The condition the kernel path does not meet, or None. bf16 is needed
    only on CUDA; the option and shape conditions hold on every device, so a
    CPU run refuses what the card would. The blocks' options are refused as
    JAX's gate refuses them (l4p_tpu/ops/fused_encoder.py:97-98); the camera
    embedding and learnable positions act outside the blocks."""
    if device.type == "cuda" and dtype != torch.bfloat16:
        return f"the kernels take bf16 on CUDA, got {dtype}"
    if cfg.cos_attn:
        return "cos_attn: the kernels run the scaled dot-product attention, not the cosine one"
    if cfg.init_values > 0:
        return f"init_values {cfg.init_values}: the kernels have no LayerScale gains"
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
    gemm.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    attn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    for fn in (ln, gemm, attn):
        fn.restype = ctypes.c_int
    return ln, gemm, attn


def block_params(blk) -> Tuple[torch.Tensor, ...]:
    """A `Block`'s parameters in the order `EncoderWorkspace.block_steps` takes them."""
    a = blk.attn
    qkv_bias = torch.cat([a.q_bias, torch.zeros_like(a.v_bias), a.v_bias])  # no k bias
    return (blk.norm1.weight, blk.norm1.bias, a.qkv.weight, qkv_bias, a.proj.weight, a.proj.bias,
            blk.norm2.weight, blk.norm2.bias, blk.mlp.fc1.weight, blk.mlp.fc1.bias, blk.mlp.fc2.weight,
            blk.mlp.fc2.bias)


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(None) if t is None else t.data_ptr()


def _gemm_call(gemm, a, w, bias, out, copy_out, epilogue: int, tokens: int, heads: int, head_dim: int,
               stream) -> Callable[[], int]:
    """One launch of the GEMM entry point `gemm` as a thunk returning its error code."""
    (m, k), n = a.shape, w.shape[0]
    args = (a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), _ptr(copy_out), m, n, k, epilogue, tokens,
            heads, head_dim, gemm_tile_width(n), stream)
    return lambda: gemm(*args)


class EncoderWorkspace:
    """The buffers of one fused_encoder_blocks call on x (B, N, E): the
    residual stream (a copy of x, updated in place), the LayerNorm output,
    the QKV epilogue's head-major q/k/v rows, the attention output and the
    MLP hidden (126 MB at 5 giant windows)."""

    def __init__(self, x: torch.Tensor, cfg: EncoderConfig):
        b, n, e = x.shape
        self.cfg, self.b, self.n = cfg, b, n
        like = dict(device=x.device, dtype=x.dtype)
        self.x = x.contiguous().clone()
        self.ln_out = torch.empty((b * n, e), **like)
        self.qkv = torch.empty((3, b, cfg.num_heads, n, kernel_row_pitch(cfg.head_dim)), **like)
        self.attn_out = torch.empty((b * n, e), **like)
        self.hidden = torch.empty((b * n, cfg.mlp_hidden), **like)

    def block_steps(self, params: Sequence[torch.Tensor], copy_to: Optional[torch.Tensor] = None,
                    kernels=None) -> List[Tuple[str, Callable[[], int]]]:
        """One block's LAUNCHES_PER_BLOCK launches in order, each a (name,
        thunk returning the entry point's error code) on the current stream;
        the last also writes the new stream into `copy_to` if given."""
        n1w, n1b, wqkv, bqkv, wp, bp, n2w, n2b, w1, b1, w2, b2 = params
        ln, gemm, attn = kernels or _kernels()
        cfg, b, n = self.cfg, self.b, self.n
        m, e, heads, hd = b * n, cfg.embed_dim, cfg.num_heads, cfg.head_dim
        stream = torch.cuda.current_stream(self.x.device).cuda_stream
        x2 = self.x.view(m, e)
        scale = float(hd ** -0.5)

        def gemm_step(a, w, bias, out, epilogue, copy_out=None):
            return _gemm_call(gemm, a, w, bias, out, copy_out, epilogue, n, heads, hd, stream)

        return [
            ("ln1", lambda: ln(x2.data_ptr(), n1w.data_ptr(), n1b.data_ptr(), self.ln_out.data_ptr(), m, e,
                               cfg.ln_eps, stream)),
            ("qkv", gemm_step(self.ln_out, wqkv, bqkv, self.qkv, QKV)),
            ("attention", lambda: attn(self.qkv.data_ptr(), self.attn_out.data_ptr(), b, heads, n, hd, scale,
                                       stream)),
            ("proj", gemm_step(self.attn_out, wp, bp, x2, RESIDUAL)),
            ("ln2", lambda: ln(x2.data_ptr(), n2w.data_ptr(), n2b.data_ptr(), self.ln_out.data_ptr(), m, e,
                               cfg.ln_eps, stream)),
            ("fc1", gemm_step(self.ln_out, w1, b1, self.hidden, GELU)),
            ("fc2", gemm_step(self.hidden, w2, b2, x2, RESIDUAL, copy_to)),
        ]


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
    params = [block_params(blk) for blk in blocks[: ends[-1]]]
    devices = {x.device} | {p.device for ps in params for p in ps}
    if devices == {torch.device("cpu")}:
        return fused_encoder_blocks_plain(blocks, x, cfg, ends)
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"fused_encoder_blocks: x and the weights must lie on one CUDA device, got {devices}")
    if any(p.dtype != torch.bfloat16 or not p.is_contiguous() for ps in params for p in ps):
        raise ValueError("fused_encoder_blocks: the block weights must be contiguous bf16")
    b, n, e = x.shape
    stack = torch.empty((len(ends), b, n, e), device=x.device, dtype=x.dtype)
    kernels = _kernels()
    with torch.cuda.device(x.device):
        ws = EncoderWorkspace(x, cfg)
        for i, ps in enumerate(params):
            copy_to = stack[ends.index(i + 1)] if i + 1 in ends else None
            for what, step in ws.block_steps(ps, copy_to, kernels):
                err = step()
                if err != 0:
                    raise RuntimeError(f"fused_encoder_blocks: {what} launch failed: {launch_error(err)}")
                fused_encoder_blocks.kernel_launches += 1
    fused_encoder_blocks.launches += 1
    return stack.transpose(0, 1)  # (B, K, N, E); each stack[:, i] stays contiguous


fused_encoder_blocks.launches = 0  # calls that ran on the kernels since the last reset
fused_encoder_blocks.kernel_launches = 0  # the kernel launches inside them (7 per block)


def gemm_nt_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epilogue: int, out: torch.Tensor,
                  copy_out: Optional[torch.Tensor] = None, tokens: int = 1, heads: int = 1,
                  head_dim: int = 2) -> torch.Tensor:
    """`gemm_nt` in plain PyTorch, the port's `Block` steps: y = a w^T + bias
    rounded to a's dtype, then QKV: y as (3, M / tokens, heads, tokens,
    head_dim) into out[..., :head_dim]; GELU: out = gelu(y); RESIDUAL: out =
    out + y in place, also copied into `copy_out`. Returns out."""
    y = linear(a, w, bias)
    if epilogue == QKV:
        out[..., :head_dim] = y.view(-1, tokens, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    elif epilogue == GELU:
        out.copy_(gelu(y))
    elif epilogue == RESIDUAL:
        out.copy_(out + y)
        if copy_out is not None:
            copy_out.copy_(out)
    else:
        raise ValueError(f"gemm_nt: unknown epilogue {epilogue}")
    return out


def _gemm_out_shape(m: int, n: int, epilogue: int, tokens: int, heads: int, head_dim: int) -> Tuple[int, ...]:
    if epilogue == QKV:
        if tokens <= 0 or m % tokens or n != 3 * heads * head_dim or head_dim % 8:
            raise ValueError(f"gemm_nt: QKV needs M {m} a multiple of tokens {tokens}, head_dim {head_dim} a "
                             f"multiple of 8 and N {n} = 3 x heads {heads} x head_dim")
        return (3, m // tokens, heads, tokens, kernel_row_pitch(head_dim))
    if epilogue in (GELU, RESIDUAL):
        return (m, n)
    raise ValueError(f"gemm_nt: unknown epilogue {epilogue}")


def gemm_nt(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epilogue: int, out: torch.Tensor,
            copy_out: Optional[torch.Tensor] = None, tokens: int = 1, heads: int = 1,
            head_dim: int = 2) -> torch.Tensor:
    """(M, K) x (N, K) -> the blocks' GEMM with one of its epilogues (QKV,
    GELU, RESIDUAL; `gemm_nt_plain` says what each writes) into `out`: QKV
    (3, M / tokens, heads, tokens, kernel_row_pitch(head_dim)), whose pad
    columns are not written; GELU and RESIDUAL (M, N). One launch, for
    checking and timing the GEMM on its own. Returns out."""
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1] or bias.shape != (w.shape[0],):
        raise ValueError(f"gemm_nt: incompatible shapes a{tuple(a.shape)} w{tuple(w.shape)} bias{tuple(bias.shape)}")
    (m, k), n = a.shape, w.shape[0]
    want = _gemm_out_shape(m, n, epilogue, tokens, heads, head_dim)
    if out.shape != want or (copy_out is not None and (epilogue != RESIDUAL or copy_out.shape != want)):
        raise ValueError(f"gemm_nt: out{tuple(out.shape)} / copy_out do not fit epilogue {epilogue}: want {want}")
    tensors = [t for t in (a, w, bias, out, copy_out) if t is not None]
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return gemm_nt_plain(a, w, bias, epilogue, out, copy_out, tokens, heads, head_dim)
    if len(devices) != 1 or a.device.type != "cuda":
        raise ValueError(f"gemm_nt: operands must lie on one CUDA device, got {devices}")
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous() for t in tensors):
        raise ValueError("gemm_nt: the kernel takes contiguous bf16 operands")
    if k % 8 or n % 8:
        raise ValueError(f"gemm_nt: K {k} and N {n} must be multiples of 8 (16-byte TMA rows)")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _gemm_call(_kernels()[1], a, w, bias, out, copy_out, epilogue, tokens, heads, head_dim, stream)()
    if err != 0:
        raise RuntimeError(f"gemm_nt: kernel launch failed: {launch_error(err)}")
    gemm_nt.launches += 1
    return out


gemm_nt.launches = 0


def linear_gelu_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return gelu(linear(a, w, bias))
