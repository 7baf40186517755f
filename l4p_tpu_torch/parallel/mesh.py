"""Process-per-GPU meshes and the parameter split (counterpart of
l4p_tpu/parallel/mesh.py).

The JAX package lays a (data, model) mesh over its devices and lets GSPMD
shard one program. Here each GPU runs its own process (`torchrun`), the
mesh is a `torch.distributed` DeviceMesh with the same two dims, and each
process holds its shard:

  * `data` splits the windows at inference (`encode_windows`,
    `run_dense_head`), the queries of each track chunk
    (`run_track_chunked`) and the batch in training (`train_step`); the
    outputs are gathered over `data`, so every rank returns the whole result;
  * `model` splits the encoder's blocks as Megatron does (JAX's
    `encoder_param_specs`): q, k and v on their head-aligned output rows
    (with q_bias and v_bias), proj on its input columns, fc1 (and its bias)
    on its rows, fc2 on its columns. Each rank runs nh / nm heads and
    hidden / nm MLP columns, and the row-parallel partials are all-reduced
    in fp32 (models/encoder.py). Every other parameter is replicated.

`shard_params` cuts a whole model's weights to this rank's shard in place,
`gather_params` rebuilds the full state dict (the released checkpoint's
layout, which both packages read). `shard_rows` / `gather_rows` split an
axis over `data` and gather it back, for counts that need not divide (JAX
pads them): the first n % nd ranks take one row more, as numpy's
array_split.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from l4p_tpu_torch.parallel.comm import Group, all_gather, all_reduce_, gather_from_data

DATA, MODEL = "data", "model"

# a block parameter (below `blocks.{i}.`) -> the dim it splits on over `model`
# (l4p_tpu/parallel/mesh.py:39-57); `attn.qkv.weight` splits q, k and v apart
BLOCK_SPLITS = {
    "attn.qkv.weight": 0,
    "attn.q_bias": 0,
    "attn.v_bias": 0,
    "attn.proj.weight": 1,
    "mlp.fc1.weight": 0,
    "mlp.fc1.bias": 0,
    "mlp.fc2.weight": 1,
}
_BLOCK = re.compile(r"(?:^|\.)blocks\.\d+\.(.+)$")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device: Union[str, torch.device] = "cuda",
              backend: Optional[str] = None) -> DeviceMesh:
    """The (data, model) mesh over this job's processes. The default process
    group is started from the environment (`torchrun`'s RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) unless the caller started it. The backend is
    NCCL on `cuda`, gloo on `cpu`, or `backend`. On `cuda` the process takes
    the card `device` names, else card LOCAL_RANK modulo the card count
    (more processes than cards share them, which gloo allows and NCCL
    does not), before the group starts.
    `n_data` defaults to world size / n_model; n_data * n_model must be the
    world size (l4p_tpu/parallel/mesh.py:33)."""
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count()
        torch.cuda.set_device(index)
        torch.zeros(1, device="cuda")  # the context exists: DeviceMesh keeps the card chosen here
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"))
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} processes, the job has {world}")
    return init_device_mesh(device.type, (n_data, n_model), mesh_dim_names=(DATA, MODEL))


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    # by index: mesh[axis] builds a sub-mesh, ~0.2 ms a call, and the blocks ask per call
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 0 if mesh is None else mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def axis_group(mesh: Optional[DeviceMesh], axis: str) -> Group:
    """The process group of this rank's `axis`, None where it has one rank."""
    return None if axis_size(mesh, axis) == 1 else mesh.get_group(axis)


# --- the parameter split ----------------------------------------------------

def param_split(name: str) -> Optional[int]:
    """The dim parameter `name` splits on over `model`, None if replicated.
    Names are the state dict's (`video_encoder.blocks.{i}.attn.qkv.weight`,
    or `blocks.{i}...` of a bare encoder)."""
    m = _BLOCK.search(name)
    return None if m is None else BLOCK_SPLITS.get(m.group(1))


def encoder_param_specs(names) -> Dict[str, Optional[int]]:
    """{name: split dim or None} over `names` (a state dict or its keys, of
    a whole model or a bare encoder): the counterpart of JAX's
    encoder_param_specs and l4p_param_specs, which replicate everything
    outside the encoder's blocks."""
    return {n: param_split(n) for n in names}


def check_shardable(heads: int, hidden: int, n_model: int) -> None:
    """Raises ValueError naming what the model axis does not divide (JAX's
    _mesh_specs / flash_sharded_available gate, l4p_tpu/ops/flash_attention.py:146-170)."""
    bad = [f"{what} {n} % {n_model} != 0" for what, n in (("heads", heads), ("hidden", hidden)) if n % n_model]
    if bad:
        raise ValueError(f"the encoder does not split over a model axis of {n_model}: {', '.join(bad)}")


def shard_tensor(name: str, t: torch.Tensor, n_model: int, rank: int) -> torch.Tensor:
    """Rank `rank`'s shard of parameter `name` (a copy), `t` itself if
    replicated. The fused qkv weight (3E, E) gives rows [s E + r E/nm,
    s E + (r + 1) E/nm) of each of q, k and v (s = 0, 1, 2): JAX's (3, E, E)
    split on its output rows."""
    dim = param_split(name)
    if dim is None or n_model == 1:
        return t
    if name.endswith("attn.qkv.weight"):
        e = t.shape[0] // 3
        return t.view(3, e, -1)[:, rank * e // n_model: (rank + 1) * e // n_model].reshape(-1, t.shape[1]).clone()
    size = t.shape[dim] // n_model
    return t.narrow(dim, rank * size, size).clone()


def unshard_tensor(name: str, parts: List[torch.Tensor]) -> torch.Tensor:
    """The inverse of `shard_tensor` from every rank's shard, in rank order."""
    dim = param_split(name)
    if dim is None or len(parts) == 1:
        return parts[0]
    if name.endswith("attn.qkv.weight"):
        return torch.cat([p.view(3, -1, p.shape[1]) for p in parts], 1).reshape(-1, parts[0].shape[1])
    return torch.cat(parts, dim)


def shard_params(model: nn.Module, mesh: Optional[DeviceMesh]) -> nn.Module:
    """Cuts `model`'s split parameters to this rank's shard in place (each
    parameter's data replaced by its shard); returns the model."""
    from l4p_tpu_torch.models.encoder import VideoEncoder

    nm, r = axis_size(mesh, MODEL), axis_rank(mesh, MODEL)
    if nm == 1:
        return model
    for enc in (m for m in model.modules() if isinstance(m, VideoEncoder)):
        check_shardable(enc.cfg.num_heads, enc.cfg.mlp_hidden, nm)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if param_split(name) is not None:
                p.data = shard_tensor(name, p.data, nm, r)
    return model


def shard_state(state: Mapping[str, torch.Tensor], mesh: Optional[DeviceMesh]) -> Dict[str, torch.Tensor]:
    """A full state dict (or any name -> tensor map of the model's names) cut to this rank's shard."""
    nm, r = axis_size(mesh, MODEL), axis_rank(mesh, MODEL)
    return {n: shard_tensor(n, t, nm, r) for n, t in state.items()}


def gather_state(state: Mapping[str, torch.Tensor], mesh: Optional[DeviceMesh]) -> Dict[str, torch.Tensor]:
    """The inverse of `shard_state` on every rank of the model axis (a collective)."""
    group = axis_group(mesh, MODEL)
    return {n: t if param_split(n) is None or group is None else unshard_tensor(n, all_gather(t, group))
            for n, t in state.items()}


def gather_params(model: nn.Module, mesh: Optional[DeviceMesh]) -> Dict[str, torch.Tensor]:
    """The model's full state dict from this rank's shard (a collective over `model`)."""
    return gather_state(model.state_dict(), mesh)


def global_sq_sum(names: List[str], grads: List[torch.Tensor], mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """The squares of the whole model's gradients summed in fp32 (the
    global-norm clip's): the split parameters' (`names`, in the order of
    `grads`) summed over `model`, the replicated ones, equal on every model
    rank, counted once."""
    parts = [g.float().square().sum() for g in grads]
    split = [p for n, p in zip(names, parts) if param_split(n) is not None]
    rep = sum((p for n, p in zip(names, parts) if param_split(n) is None), torch.zeros((), device=grads[0].device))
    if not split:
        return rep
    return rep + all_reduce_(torch.stack(split).sum(), axis_group(mesh, MODEL))


# --- rows over `data` -----------------------------------------------------

def row_counts(n: int, parts: int) -> List[int]:
    """n rows over `parts` ranks: the first n % parts take one more."""
    return [n // parts + (i < n % parts) for i in range(parts)]


def row_range(n: int, mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """[lo, hi) of this data rank's rows of n."""
    counts = row_counts(n, axis_size(mesh, DATA))
    r = axis_rank(mesh, DATA)
    lo = sum(counts[:r])
    return lo, lo + counts[r]


def shard_rows(x: torch.Tensor, mesh: Optional[DeviceMesh], dim: int = 0) -> torch.Tensor:
    """This data rank's rows of `x` on `dim`."""
    lo, hi = row_range(x.shape[dim], mesh)
    return x.narrow(dim, lo, hi - lo)


def gather_rows(x: torch.Tensor, n: int, mesh: Optional[DeviceMesh], dim: int = 0) -> torch.Tensor:
    """The inverse of `shard_rows` for n rows in all (differentiable: the
    gradient goes back to each rank's rows)."""
    return gather_from_data(x, row_counts(n, axis_size(mesh, DATA)), axis_group(mesh, DATA), dim)
