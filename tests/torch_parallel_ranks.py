"""The rank side of tests/test_torch_parallel.py: one process of a gloo job
on the CPU. It imports torch and the port, never JAX.

    python -m tests.torch_parallel_ranks JOBS_FILE RANK WORLD_SIZE

JOBS_FILE (written by the test with torch.save) maps a job's name to
(kind, (n_data, n_model), payload); each job runs on a mesh of that shape
and this rank's results go to out<RANK>.pt beside JOBS_FILE. The process
group meets through a file in the same directory, so parallel test
workers never share a port.
"""

from __future__ import annotations

import copy
import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from l4p_tpu_torch import L4P, InferenceSession, Trainer, TrainerConfig
from l4p_tpu_torch.models.encoder import RandomDropPath, VideoEncoder
from l4p_tpu_torch.parallel import comm
from l4p_tpu_torch.parallel.mesh import (
    DATA,
    MODEL,
    axis_group,
    axis_rank,
    gather_params,
    gather_rows,
    make_mesh,
    row_counts,
    shard_params,
    shard_rows,
)
from l4p_tpu_torch.train import make_optimizer, train_step, trainable_mask


def numpy_out(out: dict) -> dict:
    return {k: v.detach().float().numpy() for k, v in out.items()}


def model_of(p: dict, mesh) -> L4P:
    model = L4P(p["cfg"])
    model.load_state_dict(p["state"], strict=True)
    return shard_params(model, mesh)


def job_session(p: dict, mesh) -> dict:
    """InferenceSession(mesh=) on the payload's request; with `state_dict`
    the session loads and shards the state dict itself."""
    sess = InferenceSession(p["cfg"], p["tasks"], "cpu", mesh=mesh)
    return numpy_out(sess(p["state"] if p.get("state_dict") else model_of(p, mesh).eval(), p["data"]))


def job_encoder(p: dict, mesh) -> dict:
    """The encoder's hooks and output on this rank's rows of x, gathered over `data`."""
    enc = VideoEncoder(p["cfg"])
    enc.load_state_dict(p["state"], strict=True)
    shard_params(enc, mesh)
    x = shard_rows(torch.from_numpy(p["x"]), mesh)
    with torch.no_grad():
        out = enc(enc.embed(x), p["hooks"], mesh=mesh)
    n = p["x"].shape[0]
    return {**{f"hook {h}": gather_rows(f, n, mesh).numpy() for h, f in zip(p["hooks"], out["hooks"])},
            "final": gather_rows(out["final"], n, mesh).numpy()}


def job_train(p: dict, mesh) -> dict:
    """One train_step on the whole batch: the losses and every weight after
    it, gathered; with `drop_path_seed`, stochastic depth from
    RandomDropPath(seed, 0)."""
    model = model_of(p, mesh)
    opt = make_optimizer(model, lr=p["lr"], total_steps=p["total_steps"], mask=trainable_mask(model, p["cfg"]))
    draws = None if p.get("drop_path_seed") is None else RandomDropPath(p["drop_path_seed"], 0)
    batch = {k: torch.from_numpy(v) for k, v in p["batch"].items()}
    loss, losses = train_step(model, opt, batch, p["cfg"], p["tasks"], drop_path_draws=draws, mesh=mesh)
    return {"loss": float(loss), "losses": {k: float(v) for k, v in losses.items()},
            "state": {k: v.clone() for k, v in gather_params(model, mesh).items()}}


def job_fit(p: dict, mesh) -> dict:
    """Trainer.fit over the payload's batches, its last checkpoint, and the
    restore of that checkpoint into a fresh shard and optimizer: whether
    restore gave back this rank's weights and moments bit for bit."""
    trainer = Trainer(p["cfg"], p["tasks"], TrainerConfig(max_steps=len(p["batches"]), log_every=1, ckpt_every=10 ** 6,
                                                          val_every=10 ** 6, out_dir=p["out_dir"]),
                      metrics_fn=None, device="cpu", mesh=mesh)
    model = model_of(p, mesh)
    model, opt, step = trainer.fit(model, p["batches"])
    path = os.path.join(p["out_dir"], f"ckpt_{step:07d}.pt")
    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for q in fresh.parameters():
            q.zero_()
    fresh, opt2, step2 = trainer.restore(path, fresh)
    same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), fresh.state_dict().values()))
    same_opt = all(torch.equal(opt.mu[n], opt2.mu[n]) and torch.equal(opt.nu[n], opt2.nu[n]) for n in opt.mu)
    return {"path": path, "step": step2, "restored": same and same_opt and opt2.count == opt.count}


def job_collectives(p: dict, mesh) -> dict:
    """The collective Functions and the row split on this rank: each
    forward's value and each backward's gradient."""
    d, m = axis_rank(mesh, DATA), axis_rank(mesh, MODEL)
    gd, gm = axis_group(mesh, DATA), axis_group(mesh, MODEL)
    out = {"rank": (d, m)}
    # copy_to_model: identity forward; the gradient is summed over `model`
    x = torch.full((3,), float(d + 1), requires_grad=True)
    y = comm.copy_to_model(x, gm)
    (y * (m + 1)).sum().backward()
    out["copy"] = (y.detach().numpy(), x.grad.numpy())
    # reduce_from_model: the sum over `model` forward, identity backward
    x = torch.full((2,), float(m + 1), requires_grad=True)
    y = comm.reduce_from_model(x, gm)
    (y * 3).sum().backward()
    out["reduce"] = (y.detach().numpy(), x.grad.numpy())
    # 7 rows over `data`: 4 and 3 rows; the gradient of the gathered rows returns to their rank
    n = 7
    full = torch.arange(n * 2, dtype=torch.float32).view(n, 2)
    local = shard_rows(full, mesh).clone().requires_grad_()
    gathered = gather_rows(local, n, mesh)
    (gathered * torch.arange(n, dtype=torch.float32)[:, None]).sum().backward()
    out["rows"] = (local.shape[0], gathered.detach().numpy(), local.grad.numpy(), row_counts(n, 2))
    # two rows over four data ranks: two ranks hold none
    out["sparse"] = gather_rows(shard_rows(full[:2], mesh), 2, mesh).numpy() if mesh[DATA].size() == 4 else None
    t = torch.tensor([float(d)])
    comm.all_reduce_coalesced_([t], gd)
    out["data_sum"] = float(t)
    return out


JOBS = {"session": job_session, "encoder": job_encoder, "train": job_train, "fit": job_fit,
        "collectives": job_collectives}


def main(jobs_file: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    folder = os.path.dirname(os.path.abspath(jobs_file))
    dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=180))
    try:
        jobs = torch.load(jobs_file, weights_only=False)  # written by the test that started this process
        results = {}
        for name, (kind, shape, payload) in jobs.items():
            torch.manual_seed(0)
            np.random.seed(0)
            results[name] = JOBS[kind](payload, make_mesh(*shape, device="cpu"))
        torch.save(results, os.path.join(folder, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
