"""The loop driver's forward-only side (counterpart of l4p_tpu/trainer.py):
validation and prediction over a host data iterator, with the JAX trainer's
`TrainerConfig`, `config.json` and `scalars.jsonl` records
(`scalars/{phase}/{key}`, as the reference logs them, l4p.py:82-91), so the
two packages' logs can be compared line by line.

The forward is the port's `InferenceSession` on the trainer's device (the
card unless the caller asks for the CPU), under inference mode. `fit`,
`save` and `restore` need the training side: losses, the optimizer and the
kernels' backward passes, which are ROADMAP.md queue 1's next item.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Iterable, Iterator, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from l4p_tpu_torch.config import L4PConfig
from l4p_tpu_torch.inference import InferenceSession
from l4p_tpu_torch.metrics import l4p_metrics
from l4p_tpu_torch.models.l4p import Draws

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
    return valid is not None and float(np.sum(np.asarray(valid))) == 0


class Trainer:
    """`validate` and `predict` of the JAX package's Trainer
    (l4p_tpu/trainer.py) on the port's session. `draws` gives the camera
    solve's and the joint stitch's random numbers (RandomDraws(0) by
    default)."""

    def __init__(self, model_cfg: L4PConfig, tasks: Sequence[str], trainer_cfg: TrainerConfig = TrainerConfig(),
                 metrics_fn: Optional[Callable] = l4p_metrics, device: Union[str, torch.device] = "cuda",
                 draws: Optional[Draws] = None):
        self.model_cfg = model_cfg
        self.tasks = tuple(tasks)
        self.cfg = trainer_cfg
        self.metrics_fn = metrics_fn
        self.device = torch.device(device)
        self.session = InferenceSession(model_cfg, self.tasks, self.device, draws=draws)
        os.makedirs(trainer_cfg.out_dir, exist_ok=True)
        self._log_path = os.path.join(trainer_cfg.out_dir, "scalars.jsonl")
        # the resolved run config (LightningCLI's save_config, reference main.py:11)
        with open(os.path.join(trainer_cfg.out_dir, "config.json"), "w") as f:
            json.dump({"tasks": list(self.tasks), "trainer": dataclasses.asdict(trainer_cfg),
                       "model": repr(model_cfg)}, f, indent=2)

    def log(self, phase: str, step: int, scalars: Mapping[str, float]) -> None:
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

    def fit(self, *args, **kwargs):
        raise NotImplementedError(
            "Trainer.fit needs the training side (losses, the optimizer, the kernels' backward passes), which is "
            "ROADMAP.md queue 1's next item, training; the JAX package's Trainer.fit (l4p_tpu/trainer.py) runs it")
