"""The collectives of the port's (data, model) meshes, and the autograd
Functions that carry them through training (Megatron-LM's f and g operators,
arXiv:1909.08053 section 3; the all-reduces GSPMD inserts for the JAX
package's mesh, l4p_tpu/parallel/mesh.py).

- `CopyToModel`: identity forward, the gradient all-reduced over the model
  axis backward. It sits in front of the column-parallel products (qkv,
  fc1): each model rank feeds the same input to its own columns, so the
  input's gradient is the sum of the ranks' parts.
- `ReduceFromModel`: all-reduce forward, identity backward. It sits after
  the row-parallel products (proj, fc2), whose partial sums it adds.
- `GatherFromData`: the data ranks' row blocks concatenated forward, this
  rank's block of the gradient backward. Blocks may differ in length.

A group of None stands for one rank: every function here is then the
identity and runs no collective. Gloo reduces CUDA tensors but gathers only
CPU ones, so a gather over gloo goes through host copies.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def all_reduce_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Sums `t` over `group` in place; returns it."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_reduce_coalesced_(tensors: Iterable[torch.Tensor], group: Group) -> None:
    """Sums each tensor over `group` in place, one collective per dtype and
    device (the tensors flattened into one buffer and copied back)."""
    if group is None:
        return
    buckets = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


def all_gather(t: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """Every rank's `t` (all of one shape), in rank order."""
    if group is None:
        return [t]
    host = t.is_cuda and dist.get_backend(group) == "gloo"
    src = (t.cpu() if host else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts] if host else parts


class CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


class ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, counts, group, dim):
        rank = dist.get_rank(group)
        ctx.dim, ctx.offset, ctx.count = dim, sum(counts[:rank]), counts[rank]
        if x.shape[dim] != counts[rank]:
            raise ValueError(f"rank {rank} holds {x.shape[dim]} rows on dim {dim}, its count is {counts[rank]}")
        longest = max(counts)
        if x.shape[dim] < longest:
            pad = list(x.shape)
            pad[dim] = longest - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim)
        parts = all_gather(x, group)
        return torch.cat([p.narrow(dim, 0, c) for p, c in zip(parts, counts)], dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.offset, ctx.count), None, None, None


def copy_to_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group is None else CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group is None else ReduceFromModel.apply(x, group)


def gather_from_data(x: torch.Tensor, counts: Sequence[int], group: Group, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks of `counts[r]` rows each on `dim`, concatenated in rank order."""
    return x if group is None else GatherFromData.apply(x, list(counts), group, dim)
