"""The loop driver (counterpart of l4p_tpu/trainer.py): training, validation
and prediction over a host data iterator, with the JAX trainer's
`TrainerConfig`, `config.json` and `scalars.jsonl` records
(`scalars/{phase}/{key}`, as the reference logs them, l4p.py:82-91), so the
two packages' logs can be compared line by line.

`fit` runs `train.train_step` on the model in place on the trainer's device
(the card unless the caller asks for the CPU), skipping the batches the
reference skips, and writes checkpoints (`save`: one `torch.save` file with
the model's state dict, the optimizer's state and the step, where the JAX
trainer writes an orbax directory) that `restore` reads back. Validation
and prediction run the port's `InferenceSession` under inference mode.

With a `mesh` (parallel.make_mesh) every rank of the job runs the trainer
on its shard of the model (parallel.shard_params, before the optimizer is
made): `fit` takes each whole batch and `train_step` splits it, `save`
gathers the weights and the optimizer's moments into one file that rank 0
writes (the released layout, loadable without a mesh), `restore` reads it
and takes this rank's shard, and only rank 0 writes the logs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Iterable, Iterator, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from l4p_tpu_torch.config import L4PConfig
from l4p_tpu_torch.inference import InferenceSession
from l4p_tpu_torch.metrics import l4p_metrics
from l4p_tpu_torch.models.encoder import RandomDropPath
from l4p_tpu_torch.models.l4p import L4P, Draws
from l4p_tpu_torch.parallel.mesh import gather_params, gather_state, shard_state
from l4p_tpu_torch.train import AdamW, make_optimizer, train_step, trainable_mask

Model = Union[nn.Module, Mapping[str, torch.Tensor]]


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int = 10000
    lr: float = 1e-4
    weight_decay: float = 0.05
    log_every: int = 50
    ckpt_every: int = 1000
    val_every: int = 1000
    out_dir: str = "runs/default"
    mesh_model_axis: int = 1


def do_data_sanity_checks(batch: Mapping) -> bool:
    """True for a batch whose tracks are all invalid, which training skips
    (reference l4p.py:41-52)."""
    valid = batch.get("track_2d_valid_bn1t")
    return valid is not None and float(torch.as_tensor(valid).sum()) == 0


class Trainer:
    """The JAX package's Trainer (l4p_tpu/trainer.py) on the port: `fit`,
    `save`, `restore`, `validate` and `predict`. `draws` gives the camera
    solve's and the joint stitch's random numbers (RandomDraws(0) by
    default); training's stochastic depth draws from RandomDropPath(0,
    step), one generator a step."""

    def __init__(self, model_cfg: L4PConfig, tasks: Sequence[str], trainer_cfg: TrainerConfig = TrainerConfig(),
                 metrics_fn: Optional[Callable] = l4p_metrics, device: Union[str, torch.device] = "cuda",
                 draws: Optional[Draws] = None, mesh=None):
        self.model_cfg = model_cfg
        self.tasks = tuple(tasks)
        self.cfg = trainer_cfg
        self.metrics_fn = metrics_fn
        self.device = torch.device(device)
        self.mesh = mesh
        self.is_main = mesh is None or dist.get_rank() == 0
        self.session = InferenceSession(model_cfg, self.tasks, self.device, draws=draws, mesh=mesh)
        os.makedirs(trainer_cfg.out_dir, exist_ok=True)
        self._log_path = os.path.join(trainer_cfg.out_dir, "scalars.jsonl")
        if self.is_main:
            # the resolved run config (LightningCLI's save_config, reference main.py:11)
            with open(os.path.join(trainer_cfg.out_dir, "config.json"), "w") as f:
                json.dump({"tasks": list(self.tasks), "trainer": dataclasses.asdict(trainer_cfg),
                           "model": repr(model_cfg)}, f, indent=2)

    def log(self, phase: str, step: int, scalars: Mapping[str, float]) -> None:
        if not self.is_main:
            return
        rec = {"step": step, **{f"scalars/{phase}/{k}": float(v) for k, v in scalars.items()}}
        with open(self._log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _forward(self, model: Model, batch: Mapping) -> tuple:
        """(the batch's arrays on the device, the session's outputs); string
        entries (a sequence name) are dropped, as the JAX trainer drops them."""
        data = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items() if not isinstance(v, str)}
        return data, self.session(model, data)

    @torch.inference_mode()
    def validate(self, model: Model, val_iter: Iterable[Mapping], step: int = 0, phase: str = "val") -> Dict:
        """Each batch's metrics (`metrics_fn(batch, outputs)`), averaged over
        the batches that have them, plus `num_batches`; logged under
        `phase` (l4p_tpu/trainer.py:166-181)."""
        agg: Dict[str, list] = {}
        n = 0
        for batch in val_iter:
            data, out = self._forward(model, batch)
            if self.metrics_fn is not None:
                m, _ = self.metrics_fn(data, out)
                for k, v in m.items():
                    agg.setdefault(k, []).append(float(v))
            n += 1
        scalars = {k: float(np.mean(v)) for k, v in agg.items()}
        scalars["num_batches"] = n
        self.log(phase, step, scalars)
        return scalars

    @torch.inference_mode()
    def predict(self, model: Model, data_iter: Iterable[Mapping]) -> Iterator[Dict[str, np.ndarray]]:
        """The outputs of each batch as float32 numpy arrays."""
        for batch in data_iter:
            yield {k: v.float().cpu().numpy() for k, v in self._forward(model, batch)[1].items()}

    def make_optimizer(self, model: L4P) -> AdamW:
        """The optimizer of `fit` over the parameters `trainable_mask` trains
        (which sets every parameter's requires_grad)."""
        return make_optimizer(model, lr=self.cfg.lr, total_steps=self.cfg.max_steps,
                              weight_decay=self.cfg.weight_decay, mask=trainable_mask(model, self.model_cfg))

    def save(self, model: L4P, optimizer: AdamW, step: int) -> str:
        """`out_dir/ckpt_<step>.pt`: the model's state dict, the optimizer's
        state and the step; under a mesh gathered whole (a collective) and
        written by rank 0."""
        path = os.path.join(self.cfg.out_dir, f"ckpt_{step:07d}.pt")
        state = optimizer.state_dict()
        state.update(mu=gather_state(state["mu"], self.mesh), nu=gather_state(state["nu"], self.mesh))
        ckpt = {"model": gather_params(model, self.mesh), "optimizer": state, "step": step}
        if self.is_main:
            torch.save(ckpt, path)
        if self.mesh is not None:
            dist.barrier()
        return path

    def restore(self, path: str, model: L4P, optimizer: Optional[AdamW] = None) -> Tuple[L4P, AdamW, int]:
        """Resume from a `save` file: the weights loaded into `model` (strictly),
        the state into `optimizer` (a new one of `make_optimizer` if None);
        returns (model, optimizer, step)."""
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        model.load_state_dict(shard_state(ckpt["model"], self.mesh), strict=True)
        optimizer = self.make_optimizer(model) if optimizer is None else optimizer
        state = ckpt["optimizer"]
        state.update(mu=shard_state(state["mu"], self.mesh), nu=shard_state(state["nu"], self.mesh))
        optimizer.load_state_dict(state)
        return model, optimizer, int(ckpt["step"])

    def fit(self, model: L4P, train_iter: Iterable[Mapping], val_iter: Optional[Callable[[], Iterable[Mapping]]] = None,
            optimizer: Optional[AdamW] = None, start_step: int = 0) -> Tuple[L4P, AdamW, int]:
        """Train `model` in place until `max_steps` or the end of `train_iter`
        (l4p_tpu/trainer.py:131-164): a batch whose tracks are all invalid is
        skipped; every `log_every` steps the loss, each task's loss and
        `steps_per_sec` go to scalars.jsonl under `scalars/train/`, every
        `ckpt_every` a checkpoint is saved and every `val_every` `val_iter()`
        is validated; a last checkpoint at the end. Returns (model,
        optimizer, step)."""
        optimizer = self.make_optimizer(model) if optimizer is None else optimizer
        step = start_step
        t0 = time.time()
        for batch in train_iter:
            if step >= self.cfg.max_steps:
                break
            if do_data_sanity_checks(batch):
                continue
            data = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items() if not isinstance(v, str)}
            loss, losses = train_step(model, optimizer, data, self.model_cfg, self.tasks,
                                      drop_path_draws=RandomDropPath(0, step), mesh=self.mesh)
            step += 1
            if step % self.cfg.log_every == 0:
                scalars = {"loss": float(loss), **{k: float(v) for k, v in losses.items()}}
                scalars["steps_per_sec"] = self.cfg.log_every / max(time.time() - t0, 1e-9)
                t0 = time.time()
                self.log("train", step, scalars)
            if step % self.cfg.ckpt_every == 0:
                self.save(model, optimizer, step)
            if val_iter is not None and step % self.cfg.val_every == 0:
                self.validate(model, val_iter(), step=step)
        self.save(model, optimizer, step)
        return model, optimizer, step
