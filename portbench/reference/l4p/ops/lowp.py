"""The control's lower precision: operands of the reference's products
rounded to fp8 (e4m3, one scale per tensor), as an fp8 path of the
program would round them.

`fp8_products()` turns the rounding on for the reference's linear layers,
convolutions, attention and the track head's products; off (the default)
every product is the plain fp32 one.
"""

from __future__ import annotations

import contextlib
import threading

import torch

E4M3_MAX = 448.0
_state = threading.local()


def enabled() -> bool:
    return getattr(_state, "fp8", False)


@contextlib.contextmanager
def fp8_products():
    before = enabled()
    _state.fp8 = True
    try:
        yield
    finally:
        _state.fp8 = before


def q8(t: torch.Tensor) -> torch.Tensor:
    """t unchanged, or, under fp8_products(), t rounded to e4m3 at a scale
    that maps its largest magnitude to the format's largest value. A
    gradient passes through the rounding unchanged."""
    if not enabled() or not t.is_floating_point():
        return t
    d = t.detach()
    scale = d.abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    rounded = ((d.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)
    return t + (rounded - d)  # the rounded value, with the gradient passed straight through


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero); any other tensor unchanged."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        return t
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).view(t.shape)


class _TF32Products(torch.overrides.TorchFunctionMode):
    """Rounds the float32 operands of every matrix product to TF32."""

    PRODUCTS = {torch.matmul, torch.mm, torch.bmm, torch.einsum, torch.Tensor.matmul, torch.Tensor.__matmul__,
                torch.Tensor.__rmatmul__}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.PRODUCTS:
            args = tuple([round_tf32(x) for x in a] if isinstance(a, (list, tuple)) else round_tf32(a)
                         for a in args)
        return func(*args, **kwargs)


def tf32_products():
    """The control of a float32 stage: its products as TF32 computes them."""
    return _TF32Products()
