"""Training: the multi-task loss, the trainable parameters, AdamW with the
one-cycle schedule and global-norm clipping, and one optimization step
(counterpart of l4p_tpu/train.py).

The loss has the reference loss module's contract (l4p.py:69-71): one
window-length clip, a loss per task and their sum. The optimizer follows
optax's semantics, which the JAX package trains with, rather than
torch.optim's: `optax.clip_by_global_norm` (no epsilon on the norm), then
`optax.adamw` (moments in the parameters' dtype, weight decay decoupled and
scaled by the learning rate) on `optax.cosine_onecycle_schedule`, which
each update reads at the count of updates before it. VideoMAE pretraining
(pretrain_mae.py) trains with the same clip and AdamW on
`optax.warmup_cosine_decay_schedule`, or with `Adafactor` to
optax.adafactor's defaults.

The kernels of the forward (the encoder attention, the fused encoder, the
track head's three) are `torch.autograd.Function`s whose backward
recomputes their plain versions (ops/recompute.py).

`train_step(..., mesh=)` computes what the JAX package's step jitted over a
(data, model) mesh computes (__graft_entry__.dryrun_multichip): each data
rank takes its rows of the global batch, every mean divides by the count
over the whole batch (so the ranks' losses and gradients sum to the global
ones, however the valid masks fall), the gradients are summed over `data`,
the clip's norm counts each split parameter's squares over `model` once,
and stochastic depth draws its masks for the whole batch.
"""

from __future__ import annotations

import functools
import math
import operator
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from l4p_tpu_torch.config import L4PConfig
from l4p_tpu_torch.geometry.core import get_rays_plucker, normalize_intrinsics
from l4p_tpu_torch.models.encoder import AttentionFn, BatchRows, DropPathDraws, EncoderBlocksFn
from l4p_tpu_torch.models.l4p import L4P, dense_head_raw
from l4p_tpu_torch.models.sam import KERNELS, TrackKernels
from l4p_tpu_torch.models.track import track_forward
from l4p_tpu_torch.ops.flash_attention import flash_attention
from l4p_tpu_torch.ops.fused_encoder import fused_encoder_blocks
from l4p_tpu_torch.parallel.comm import Group, all_reduce_, all_reduce_coalesced_
from l4p_tpu_torch.parallel.mesh import DATA, axis_group, axis_size, global_sq_sum, row_range, shard_rows


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], group: Group = None) -> torch.Tensor:
    """The mean of x over the entries `mask` (broadcast to x) selects, all
    of them without one. With a data `group`, x is this rank's rows and the
    count is summed over the group: the ranks' results add up to the mean
    over the whole batch."""
    x = x.float()
    if group is None:
        if mask is None:
            return x.mean()
        m = mask.float().expand(x.shape)
        return (x * m).sum() / m.sum().clamp(min=1.0)
    if mask is None:
        total, count = x.sum(), x.new_tensor(float(x.numel()))
    else:
        m = mask.float().expand(x.shape)
        total, count = (x * m).sum(), m.sum().detach()
    return total / all_reduce_(count, group).clamp(min=1.0)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy: -y log sigmoid(x) - (1 - y) log sigmoid(-x)."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def _log_l1(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """|log max(pred, 1e-6) - log max(gt, 1e-6)|, each in its own dtype."""
    return (torch.log(pred.clamp(min=1e-6)) - torch.log(gt.clamp(min=1e-6))).abs()


def l4p_loss(model: L4P, cfg: L4PConfig, batch: Mapping[str, torch.Tensor], tasks: Sequence[str],
             drop_path_draws: Optional[DropPathDraws] = None, attention: AttentionFn = flash_attention,
             track_kernels: TrackKernels = KERNELS, encoder_blocks: EncoderBlocksFn = fused_encoder_blocks,
             mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {name: loss}) of one window-length clip (l4p_tpu/train.py:35-154),
    batch keys in the L4PData schema: log-L1 depth, L1 flow under its
    per-channel valid mask, BCE-with-logits dyn_mask, L1 camray rays against
    the Plucker rays of the ground-truth cameras in the first camera's
    frame, and the track's xy L1 over the image height, visibility BCE and
    log-L1 depth; each under its valid mask where the batch has one.

    `drop_path_draws` turns on stochastic depth (training steps pass one
    when drop_path_rate > 0), which also keeps the encoder off the fused
    kernels. With `freeze_video_encoder` and no `unfreeze_blocks` the
    encoder runs without autograd (JAX's stop_gradient on its parameters).
    `attention`, `track_kernels` and `encoder_blocks` replace the kernels,
    as in InferenceSession. With `mesh`, `batch` is this data rank's rows,
    each mean divides by its count over the `data` axis (the result is this
    rank's part of the whole batch's loss) and the encoder's blocks split
    over `model`."""
    group = axis_group(mesh, DATA)
    mean = functools.partial(_masked_mean, group=group)
    rgb = batch["rgb_b3thw"]
    if rgb.shape[2] != cfg.window_size[0]:
        raise ValueError(f"l4p_loss trains on single-window clips: T={rgb.shape[2]} != window "
                         f"{cfg.window_size[0]}; crop or sample clips to the window length in the data pipeline")
    img_info = tuple(rgb.shape[2:5])
    hooks = cfg.all_hooks
    enc = model.video_encoder
    frozen = cfg.freeze_video_encoder and cfg.unfreeze_blocks is None
    with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
        out = enc(enc.embed(rgb), hooks, attention, encoder_blocks if cfg.encoder.fused_encoder else None,
                  drop_path_draws=drop_path_draws, mesh=mesh)
    feats = dict(zip(hooks, out["hooks"]))
    heads = cfg.head_dict

    def dense(task: str) -> torch.Tensor:
        hcfg = heads[task]
        return dense_head_raw(model.task_heads[task].task_head, hcfg, [feats[h] for h in hcfg.dpt.hooks], img_info)

    losses: Dict[str, torch.Tensor] = {}
    for task in tasks:
        if task == "depth":
            losses["depth"] = mean(_log_l1(dense(task), batch["depth_b1thw"]), batch.get("depth_valid_b1thw"))
        elif task == "flow_2d_backward":
            losses["flow"] = mean((dense(task) - batch["flow_2d_backward_b2thw"]).abs(),
                                  batch.get("flow_2d_backward_valid_b2thw"))
        elif task == "dyn_mask":
            bce = sigmoid_binary_cross_entropy(dense(task).float(), batch["dyn_mask_b1thw"].float())
            losses["dyn_mask"] = mean(bce, batch.get("dyn_mask_valid_b1thw"))
        elif task == "camray":
            rays_pred = dense(task)
            k_norm = normalize_intrinsics(batch["intrinsics_b44t"].float(), img_info[1], img_info[2])
            rays_gt, _ = get_rays_plucker(k_norm, batch["extrinsics_b44t"].float(), tuple(rays_pred.shape[-2:]),
                                          make_first_cam_ref=True)
            t_gt, t_pred = rays_gt.shape[2], rays_pred.shape[2]
            if t_gt != t_pred:  # the GT frames at the head's tubelet times, truncated as astype(int32)
                idx = torch.linspace(0, t_gt - 1, t_pred, dtype=torch.float32).long()
                rays_gt = rays_gt[:, :, idx.to(rays_gt.device)]
            losses["camray"] = mean((rays_pred.float() - rays_gt).abs(), None)
        elif task == "track_2d":
            tcfg = cfg.track
            est = track_forward(model.task_heads["track_2d"], tcfg, out["final"], batch["track_2d_pointquerries_bn3"],
                                batch["track_2d_pointlabels_bn"], kernels=track_kernels)
            t = tcfg.task_name
            valid = batch.get("track_2d_valid_bn1t")
            losses["track_xy"] = mean((est[f"{t}_traj_est_bn2t"] - batch["track_2d_traj_bn2t"]).abs(),
                                      valid) / max(img_info[1], 1)
            if tcfg.estimate_vis and "track_2d_vis_bn1t" in batch:
                bce = sigmoid_binary_cross_entropy(est[f"{t}_vis_est_bn1t"].float(), batch["track_2d_vis_bn1t"].float())
                losses["track_vis"] = mean(bce, valid)
            if tcfg.estimate_depth and "track_2d_depth_bn1t" in batch:
                losses["track_depth"] = mean(_log_l1(est[f"{t}_depth_est_bn1t"], batch["track_2d_depth_bn1t"]),
                                             valid)
        else:
            raise ValueError(f"unknown task {task}")
    return functools.reduce(operator.add, losses.values()), losses


# parameters the forward never reads, kept so that the released state dict loads strictly
# (models/sam.py); the JAX package's tree has no leaves for them, and they do not train
NEVER_READ = ("task_heads.track_2d.prompt_encoder.no_mask_embed.weight",
              "task_heads.track_2d.mask_decoder.iou_token.weight")


def trainable_mask(model: L4P, cfg: L4PConfig) -> Dict[str, bool]:
    """Whether each of the model's parameters trains (l4p_tpu/train.py:157-202;
    the reference's requires_grad toggles, l4p_videomae.py:199-218):
    `freeze_video_encoder` freezes the encoder; `unfreeze_blocks` trains
    the listed blocks and the final norm again (an empty tuple the norm
    alone); `freeze_heads` freezes whole task heads. The sinusoid position
    table is a buffer, not a parameter; learnable positions train unless
    the encoder is frozen. NEVER_READ stays frozen."""
    mask = {}
    unfrozen = set(cfg.unfreeze_blocks or ())
    for name, _ in model.named_parameters():
        part, sub, *rest = name.split(".")
        if name in NEVER_READ:
            mask[name] = False
        elif part == "task_heads":
            mask[name] = sub not in cfg.freeze_heads
        elif not cfg.freeze_video_encoder:
            mask[name] = True
        elif sub == "blocks":
            mask[name] = int(rest[0]) in unfrozen
        else:  # the final norm trains with unfreeze_blocks; patch_embed, pos_embed, cam_emb stay frozen
            mask[name] = sub == "norm" and cfg.unfreeze_blocks is not None
    return mask


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0, final_div_factor: float = 1e4) -> Callable[[int], np.float32]:
    """optax.cosine_onecycle_schedule, evaluated as optax evaluates it (its
    piecewise cosine interpolation in float32): from peak / div_factor up to
    peak over the first int(pct_start * steps) counts, then down to
    peak / (div_factor * final_div_factor) at `transition_steps`, constant
    after."""
    bounds = np.array((0, int(pct_start * transition_steps), int(transition_steps)))
    values = np.cumprod((peak_value / div_factor, div_factor, 1.0 / (div_factor * final_div_factor)))
    sizes = bounds[1:] - bounds[:-1]

    def schedule(count: int) -> np.float32:
        count = np.int32(count)
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = ((count - bounds[:-1]).astype(np.int32) / sizes.astype(np.int32)).astype(np.float32)
        start, end = values[:-1], values[1:]
        interp = end.astype(np.float32) + ((start - end) / 2.0).astype(np.float32) * (
            np.cos(np.float32(math.pi) * pct) + np.float32(1))
        inside = ((bounds[:-1] <= count) & (count < bounds[1:])).astype(np.float32)
        return np.float32(inside.dot(interp) + np.float32(bounds[-1] <= count) * np.float32(values[-1]))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable[[int], np.float32]:
    """optax.warmup_cosine_decay_schedule, evaluated as optax evaluates it
    (in float32): linear from init_value to peak_value over warmup_steps
    counts, then a cosine from peak_value down to end_value at decay_steps,
    constant after."""
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"warmup_cosine_decay_schedule needs decay_steps > warmup_steps, got {decay_steps} and "
                         f"{warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    f32 = np.float32

    def schedule(count: int) -> np.float32:
        count = int(count)
        if count < warmup_steps:
            frac = f32(1) - f32(max(count, 0)) / f32(warmup_steps)
            return f32(init_value - peak_value) * frac + f32(peak_value)
        t = f32(min(count - warmup_steps, span))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(span)))
        return f32(peak_value) * (f32(1 - alpha) * decay + f32(alpha))

    return schedule


def clip_by_global_norm(params, grads: Sequence[Optional[torch.Tensor]], clip_norm: float,
                        sq_sum: Optional[Callable[[list], torch.Tensor]] = None) -> list:
    """optax.clip_by_global_norm over the gradients of `params` (a missing
    one counts as zero): unchanged below the threshold, else scaled onto it,
    with no epsilon; the norm sums the squares in fp32 (`sq_sum(grads)`
    where given: a mesh's, parallel.mesh.global_sq_sum)."""
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads) if sq_sum is None else sq_sum(grads))
    clip = norm >= clip_norm
    return [torch.where(clip, g / norm.to(g.dtype) * clip_norm, g) for g in grads]


class AdamW:
    """optax.chain(clip_by_global_norm(clip_norm), adamw(schedule, b1, b2,
    eps, weight_decay)) over `params` (name -> trainable tensor), updating
    them in place. Moments are kept in each parameter's dtype, and each
    constant meets a tensor in that dtype, as JAX rounds a Python scalar to
    the array's dtype; the clip's norm sums the squares in fp32. A missing
    gradient counts as zero (the parameter still decays, as optax decays a
    leaf whose gradient is zero)."""

    def __init__(self, params: Mapping[str, torch.Tensor], schedule: Callable[[int], np.float32],
                 weight_decay: float = 0.05, clip_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = dict(params)
        self.schedule, self.weight_decay, self.clip_norm = schedule, weight_decay, clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]],
             sq_sum: Optional[Callable[[list], torch.Tensor]] = None) -> None:
        """One update from the gradients of `params`, in their order;
        `sq_sum` gives the clip's squared norm (`clip_by_global_norm`)."""
        grads = clip_by_global_norm(self.params.values(), grads, self.clip_norm, sq_sum)
        lr = self.schedule(self.count)
        self.count += 1
        c1, c2 = (np.float32(1) - np.float32(b) ** np.float32(self.count) for b in (self.b1, self.b2))
        consts = {}  # dtype -> the step's constants as tensors of that dtype, made once a step
        for (name, p), g in zip(self.params.items(), grads):
            key = (p.dtype, p.device)
            if key not in consts:
                values = (1 - self.b1, self.b1, 1 - self.b2, self.b2, c1, c2, self.eps, self.weight_decay, -lr)
                consts[key] = torch.tensor([float(v) for v in values], dtype=torch.float32).to(
                    device=p.device, dtype=p.dtype).unbind()
            one_b1, b1, one_b2, b2, c1_t, c2_t, eps, wd, neg_lr = consts[key]
            mu = one_b1 * g + b1 * self.mu[name]
            nu = one_b2 * g.square() + b2 * self.nu[name]
            self.mu[name], self.nu[name] = mu, nu
            u = (mu / c1_t) / (torch.sqrt(nu / c2_t) + eps)
            p.copy_(p + neg_lr * (u + wd * p))

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state: Mapping) -> None:
        if set(state["mu"]) != set(self.params) or set(state["nu"]) != set(self.params):
            raise ValueError(f"optimizer state for {sorted(state['mu'])}, the optimizer trains {sorted(self.params)}")
        self.count = int(state["count"])
        for name, p in self.params.items():
            self.mu[name] = state["mu"][name].to(device=p.device, dtype=p.dtype)
            self.nu[name] = state["nu"][name].to(device=p.device, dtype=p.dtype)


class Adafactor:
    """optax.chain(clip_by_global_norm(1.0), adafactor(schedule)) with
    optax.adafactor's defaults over `params` (name -> trainable tensor),
    updating them in place. Per parameter: the second moments factored into
    row and column means over its two largest dims when the smaller of them
    has at least 128 entries (else kept whole), decayed at 1 - (count + 1)
    ** -0.8, with 1e-30 added to the squared gradients; the scaled update
    clipped to an RMS of at most 1, times the learning rate, times the
    parameter's RMS (at least 1e-3). The leaves are the state dict's
    tensors, so the RMS clip and the parameter scale act per tensor (the
    JAX package's tree stacks the blocks into one leaf: ROADMAP.md section
    3). Moments are kept in the parameters' dtype; a decay meets them in
    fp32, as optax's fp32 decay rate promotes them."""

    CLIP_NORM, DECAY_RATE, EPS, MIN_DIM_SIZE_TO_FACTOR, BLOCK_RMS, MIN_SCALE = 1.0, 0.8, 1e-30, 128, 1.0, 1e-3

    def __init__(self, params: Mapping[str, torch.Tensor], schedule: Callable[[int], np.float32]):
        self.params = dict(params)
        self.schedule = schedule
        self.count = 0
        self.factored = {n: self._factored_dims(p.shape) for n, p in self.params.items()}
        self.v_row, self.v_col, self.v = {}, {}, {}
        for n, p in self.params.items():
            dims = self.factored[n]
            if dims is None:
                self.v[n] = torch.zeros_like(p)
            else:
                shape = list(p.shape)
                self.v_row[n] = p.new_zeros(shape[:dims[1]] + shape[dims[1] + 1:])
                self.v_col[n] = p.new_zeros(shape[:dims[0]] + shape[dims[0] + 1:])

    @classmethod
    def _factored_dims(cls, shape) -> Optional[Tuple[int, int]]:
        """(d1, d0): the second largest and the largest dim, by optax's argsort; None when not factored."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < cls.MIN_DIM_SIZE_TO_FACTOR:
            return None
        return int(order[-2]), int(order[-1])

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """One update from the gradients of `params`, in their order."""
        grads = clip_by_global_norm(self.params.values(), grads, self.CLIP_NORM)
        lr = self.schedule(self.count)
        rate = float(np.float32(1) - np.float32(self.count + 1) ** np.float32(-self.DECAY_RATE))
        self.count += 1
        for (name, p), g in zip(self.params.items(), grads):
            sq = g.square() + self.EPS
            dims = self.factored[name]
            if dims is None:
                v = (rate * self.v[name].float() + (1 - rate) * sq.float()).to(p.dtype)
                self.v[name] = v
                u = g * v.pow(-0.5)
            else:
                d1, d0 = dims
                row = (rate * self.v_row[name].float() + (1 - rate) * sq.mean(d0).float()).to(p.dtype)
                col = (rate * self.v_col[name].float() + (1 - rate) * sq.mean(d1).float()).to(p.dtype)
                self.v_row[name], self.v_col[name] = row, col
                row_factor = (row / row.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)).pow(-0.5)
                u = g * row_factor.unsqueeze(d0) * col.pow(-0.5).unsqueeze(d1)
            u = u / torch.clamp(torch.sqrt(u.square().mean()) / self.BLOCK_RMS, min=1.0)
            u = torch.tensor(float(lr), dtype=p.dtype, device=p.device) * u
            rms = torch.sqrt(p.square().mean())
            p.copy_(p - u * torch.where(rms <= self.MIN_SCALE, torch.full_like(rms, self.MIN_SCALE), rms))


def make_mae_optimizer(params: Mapping[str, torch.Tensor], lr: float, steps: int, warmup: int,
                       weight_decay: float = 0.05) -> AdamW:
    """The VideoMAE pretraining optimizer (scripts/pretrain_mae.py:32-41):
    the global-norm clip at 1 and AdamW (b1 0.9, b2 0.95) on a linear
    warm-up from 0 to lr over max(warmup, 1) counts and a cosine down to lr
    / 100 at max(steps, warmup + 1)."""
    schedule = warmup_cosine_decay_schedule(0.0, lr, max(warmup, 1), max(steps, warmup + 1), lr * 1e-2)
    return AdamW(params, schedule, weight_decay, clip_norm=1.0, b1=0.9, b2=0.95)


def make_optimizer(model: L4P, lr: float = 1e-4, total_steps: int = 10000, weight_decay: float = 0.05,
                   pct_start: float = 0.1, clip_norm: float = 1.0, mask: Optional[Mapping[str, bool]] = None) -> AdamW:
    """AdamW + one-cycle schedule + global-norm clipping over the model's
    trainable parameters (l4p_tpu/train.py:237-264; reference
    configure_optimizers, l4p.py:111-126). `mask` (trainable_mask; None
    trains every parameter) also sets each parameter's requires_grad, so
    frozen parameters get no gradient, no moments and no decay, and stay
    bitwise unchanged. pct_start is raised so that the warm-up has a step
    (optax's schedule is NaN for an empty one)."""
    pct_start = max(pct_start, min(2.0 / max(total_steps, 2), 0.5))
    schedule = cosine_onecycle_schedule(max(total_steps, 4), lr, pct_start)
    trainable = {}
    for name, p in model.named_parameters():
        p.requires_grad_(True if mask is None else bool(mask[name]))
        if p.requires_grad:
            trainable[name] = p
    return AdamW(trainable, schedule, weight_decay, clip_norm)


def train_step(model: L4P, optimizer: AdamW, batch: Mapping[str, torch.Tensor], cfg: L4PConfig,
               tasks: Sequence[str], drop_path_draws: Optional[DropPathDraws] = None,
               attention: AttentionFn = flash_attention, track_kernels: TrackKernels = KERNELS,
               encoder_blocks: EncoderBlocksFn = fused_encoder_blocks,
               mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One optimization step on `batch` (l4p_tpu/train.py:267-284): the loss,
    its gradients for the optimizer's parameters, one update in place.
    Returns the loss and the per-task losses, detached.

    With `mesh` every rank passes the whole batch and the model's shard
    (parallel.shard_params): the rank takes its rows over `data`, its
    gradients are summed over `data`, the clip's norm counts every
    parameter once, and the losses returned are the whole batch's.
    `drop_path_draws` then draws each mask for the whole batch."""
    names, params = list(optimizer.params), list(optimizer.params.values())
    if mesh is None:
        loss, losses = l4p_loss(model, cfg, batch, tasks, drop_path_draws, attention, track_kernels, encoder_blocks)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        optimizer.step(grads)
        return loss.detach(), {k: v.detach() for k, v in losses.items()}
    n = batch["rgb_b3thw"].shape[0]
    if n < axis_size(mesh, DATA):
        raise ValueError(f"a batch of {n} clips leaves a rank of the {axis_size(mesh, DATA)} data ranks without one")
    local = {k: shard_rows(torch.as_tensor(v), mesh) for k, v in batch.items()}
    if drop_path_draws is not None:
        drop_path_draws = BatchRows(drop_path_draws, n, *row_range(n, mesh))
    loss, losses = l4p_loss(model, cfg, local, tasks, drop_path_draws, attention, track_kernels, encoder_blocks,
                            mesh)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    group = axis_group(mesh, DATA)
    all_reduce_coalesced_(grads, group)
    optimizer.step(grads, functools.partial(global_sq_sum, names, mesh=mesh))
    total = all_reduce_(torch.stack([loss.detach(), *(v.detach() for v in losses.values())]), group)
    return total[0], dict(zip(losses, total[1:]))
