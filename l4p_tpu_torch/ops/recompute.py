"""The kernels' backward passes: recompute the plain version and differentiate it.

Each kernel's entry point is a `torch.autograd.Function` made by
`recomputing_function`: its forward runs the kernel (the plain version for
tensors on the CPU) and saves its inputs, and its backward runs the plain
version on them under autograd and returns its gradients, as the JAX
package's custom VJPs do (l4p_tpu/ops/flash_attention.py:83 `_flash_bwd`,
ops/fused_upscale.py:291 `_fused_bwd`, ops/fused_encoder.py:456 `_fe_bwd`,
models/sam.py:475 `_twoway_streamed_bwd`). Nothing the kernel computed is
kept for the backward; a kernel written for the backward is a later step.

A module whose parameters the kernel reads passes them to the Function as
inputs (a Function returns gradients only for what `apply` was given), and
the plain version reads them back through `module_call`.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn as nn


def recompute_grads(plain: Callable, inputs: Sequence, needs: Sequence[bool], grads: Sequence) -> Tuple:
    """The gradients of `plain(*inputs)` (a tensor or a tuple of tensors)
    against the output gradients `grads`, for the inputs whose `needs` is
    true; None for the others. Nothing is recomputed when none needs one.
    An input the output does not depend on gets None (a zero gradient)."""
    if not any(needs):
        return (None,) * len(inputs)
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(n) if isinstance(x, torch.Tensor) else x for x, n in zip(inputs, needs)]
        out = plain(*xs)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        wanted = [x for x, n in zip(xs, needs) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs], allow_unused=True))
    return tuple(next(got) if n else None for n in needs)


def recomputing_function(name: str, forward: Callable, plain: Callable, consts: int = 0) -> type:
    """The autograd.Function class `name` whose apply(*args) returns
    forward(*args) and whose backward recomputes plain(*args): the first
    `consts` arguments are constants (no gradient), the others the tensors
    saved for the backward and differentiated."""

    def fwd(ctx, *args):
        ctx.consts = args[:consts]
        ctx.save_for_backward(*args[consts:])
        return forward(*args)

    def bwd(ctx, *grads):
        plain_of = lambda *xs: plain(*ctx.consts, *xs)  # noqa: E731
        return (None,) * consts + recompute_grads(plain_of, ctx.saved_tensors, ctx.needs_input_grad[consts:], grads)

    return type(name, (torch.autograd.Function,), {"forward": staticmethod(fwd), "backward": staticmethod(bwd),
                                                   "__module__": forward.__module__})


class _Call(nn.Module):
    def __init__(self, fn: Callable, module: nn.Module):
        super().__init__()
        self.fn, self.module = fn, module

    def forward(self, *args):
        return self.fn(self.module, *args)


def module_call(fn: Callable, module: nn.Module, names: Sequence[str], params: Sequence[torch.Tensor], *args):
    """fn(module, *args) with module's parameters `names` read as `params`
    (torch.func.functional_call; the module itself is not changed)."""
    return torch.func.functional_call(_Call(fn, module), {f"module.{n}": p for n, p in zip(names, params)}, args)
