"""Dense-task inference session (counterpart of l4p_tpu/inference.py:25-181).

`InferenceSession(cfg, tasks, device)(model_or_state, data)` returns the same
keys and layouts as the JAX session for the tasks of this slice:
`flow_2d_backward_est_b2thw`, `depth_est_b1thw`, `dyn_mask_est_b1thw`, each
(B, C, T, H, W). `data` holds `rgb_u8_bthw3` (uint8, normalised on the device)
or `rgb_b3thw` (normalised float), as tensors or numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Union

import torch
import torch.nn as nn

from l4p_tpu_torch.config import L4PConfig
from l4p_tpu_torch.models.encoder import AttentionFn
from l4p_tpu_torch.models.l4p import L4P, encode_windows, run_dense_head, stitch_dense_outputs
from l4p_tpu_torch.ops.flash_attention import flash_attention

SLICE_TASKS = ("flow_2d_backward", "depth", "dyn_mask")


class InferenceSession:
    """`attention` replaces the encoder's attention kernel; tests pass
    `flash_attention_plain` to hold the kernel's path against the plain one."""

    def __init__(self, cfg: L4PConfig, tasks: Sequence[str], device: Union[str, torch.device],
                 attention: AttentionFn = flash_attention):
        self.tasks = tuple(tasks)
        unsupported = [t for t in self.tasks if t not in SLICE_TASKS]
        if unsupported:
            raise ValueError(f"tasks {unsupported} are not ported yet; the port serves {SLICE_TASKS}")
        missing = [t for t in self.tasks if t not in cfg.head_dict]
        if not self.tasks or missing:
            raise ValueError(f"no configured head for tasks {missing or self.tasks}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.attention = attention
        self._loaded = None  # (state dict, model built from it)

    def model(self, model_or_state: Union[nn.Module, Mapping[str, torch.Tensor]]) -> L4P:
        if isinstance(model_or_state, nn.Module):
            return model_or_state
        if self._loaded is None or self._loaded[0] is not model_or_state:
            dtype = next(iter(model_or_state.values())).dtype
            model = L4P(self.cfg, device=self.device, dtype=dtype)
            model.load_state_dict(model_or_state, strict=True)
            self._loaded = (model_or_state, model.eval())
        return self._loaded[1]

    @torch.inference_mode()
    def __call__(self, model_or_state, data: Mapping) -> Dict[str, torch.Tensor]:
        model = self.model(model_or_state)
        cfg = self.cfg
        rgb_u8 = data.get("rgb_u8_bthw3")
        rgb = data.get("rgb_b3thw") if rgb_u8 is None else None
        if rgb_u8 is None and rgb is None:
            raise ValueError("data needs 'rgb_u8_bthw3' or 'rgb_b3thw'")
        rgb_u8 = None if rgb_u8 is None else torch.as_tensor(rgb_u8, device=self.device)
        rgb = None if rgb is None else torch.as_tensor(rgb, device=self.device)
        t, *hw = rgb_u8.shape[1:4] if rgb_u8 is not None else rgb.shape[2:5]
        if tuple(hw) != tuple(cfg.window_size[1:]):
            raise ValueError(f"frames are {tuple(hw)}, the model takes {tuple(cfg.window_size[1:])} only")

        enc = encode_windows(model.video_encoder, cfg, rgb, rgb_u8, self.attention)
        hooks = enc["hooks"]
        del enc  # `final` feeds only the track head
        img_info = tuple(cfg.window_size)
        dense = {t: run_dense_head(model.task_heads[t], hooks, img_info, cfg.dense_window_chunk) for t in self.tasks}
        del hooks
        return stitch_dense_outputs(cfg, self.tasks, dense, cfg.window_stride_t, t)
