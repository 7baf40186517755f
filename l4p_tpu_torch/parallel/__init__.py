"""Multi-GPU for the port: one process per GPU on torch.distributed
(counterpart of l4p_tpu/parallel/). `mesh` makes the (data, model) mesh and
splits the parameters, `comm` holds the collectives and their autograd
Functions, `dryrun` is the analog of `__graft_entry__.dryrun_multichip`
(`torchrun --standalone --nproc_per_node=N -m l4p_tpu_torch.parallel.dryrun`)."""

from l4p_tpu_torch.parallel.mesh import (
    DATA,
    MODEL,
    axis_group,
    axis_rank,
    axis_size,
    encoder_param_specs,
    gather_params,
    gather_rows,
    make_mesh,
    shard_params,
    shard_rows,
)

__all__ = ["DATA", "MODEL", "axis_group", "axis_rank", "axis_size", "encoder_param_specs", "gather_params",
           "gather_rows", "make_mesh", "shard_params", "shard_rows"]
