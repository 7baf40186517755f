"""The port's training side against the JAX package's (fp32, CPU, the tiny
all-task config): l4p_loss per task and in total and every parameter's
gradient against jax.value_and_grad(l4p_loss); each kernel Function's
gradients against the JAX custom VJP (its kernel in interpret mode);
trainable_mask; the one-cycle schedule, the clip and AdamW against optax;
three train steps against JAX's; stochastic depth with JAX's masks.

The parameters of the two packages meet through params_from_jax, which maps
a JAX gradient tree onto the port's names as it maps a parameter tree. JAX
trains the prompt encoder's Fourier matrix (`pe_gaussian`) as a leaf; the
port keeps it a buffer, as upstream does (ROADMAP.md section 3), so the
JAX optimizer here runs with that leaf's mask at 0."""

import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l4p_tpu_torch import params_from_jax
from l4p_tpu_torch.models import encoder as PE
from l4p_tpu_torch.train import (AdamW, cosine_onecycle_schedule, l4p_loss, make_optimizer, train_step,
                                 trainable_mask)
from tests.test_torch_encoder import tiny_models
from tests.test_torch_ops import check, rand

torch.set_num_threads(1)
jax.config.update("jax_default_matmul_precision", "highest")

TASKS = ("flow_2d_backward", "track_2d", "depth", "dyn_mask", "camray")
# |port - JAX| <= tol * max|JAX| per parameter, + ZERO_GRAD * the largest gradient of the set
# for gradients that are 0 in exact arithmetic (the two-way transformer's k biases, whose
# softmax shift drops out: both packages leave fp32 noise there, measured 2.2e-6 where the
# largest gradient is 478). Measured <= 2.1e-5 on the DPT heads' last biases (sums of 3136
# pixels each), <= 7e-6 elsewhere
GRAD_TOL = 5e-5
ZERO_GRAD = 1e-8


def train_batch(seed: int = 0, t: int = 4, n: int = 5) -> dict:
    """One window of every task's ground truth at the tiny geometry (28 x 28),
    cameras a small random walk, a fifth of the track entries invalid."""
    rng = np.random.default_rng(seed)
    k = np.tile(np.diag([30.0, 30.0, 1, 1]).astype(np.float32)[None, :, :, None], (1, 1, 1, t))
    k[:, 0, 2] = k[:, 1, 2] = 14.0
    ext = np.tile(np.eye(4, dtype=np.float32)[None, :, :, None], (1, 1, 1, t))
    ext[0, :3, 3] = rng.standard_normal((3, t)) * 0.1
    return {
        "rgb_b3thw": rng.standard_normal((1, 3, t, 28, 28)).astype(np.float32),
        "intrinsics_b44t": k,
        "extrinsics_b44t": ext,
        "depth_b1thw": rng.uniform(1, 5, (1, 1, t, 28, 28)).astype(np.float32),
        "flow_2d_backward_b2thw": rng.standard_normal((1, 2, t, 28, 28)).astype(np.float32),
        "dyn_mask_b1thw": (rng.uniform(size=(1, 1, t, 28, 28)) > 0.5).astype(np.float32),
        "track_2d_pointquerries_bn3": np.stack(
            [rng.uniform(0, t, (1, n)), rng.uniform(2, 26, (1, n)), rng.uniform(2, 26, (1, n))], -1).astype(np.float32),
        "track_2d_pointlabels_bn": np.ones((1, n), np.float32),
        "track_2d_traj_bn2t": rng.uniform(0, 28, (1, n, 2, t)).astype(np.float32),
        "track_2d_vis_bn1t": (rng.uniform(size=(1, n, 1, t)) > 0.3).astype(np.float32),
        "track_2d_depth_bn1t": rng.uniform(1, 5, (1, n, 1, t)).astype(np.float32),
        "track_2d_valid_bn1t": (rng.uniform(size=(1, n, 1, t)) > 0.2).astype(np.float32),
    }


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=1)
def jax_value_and_grad():
    """jit(value_and_grad(l4p_loss)) of the tiny config over TASKS; one compile for every use."""
    from l4p_tpu.train import l4p_loss as jax_loss

    jcfg = tiny_models()[0]
    return jax.jit(jax.value_and_grad(lambda p, b: jax_loss(p, jcfg, b, TASKS), has_aux=True))


@functools.lru_cache(maxsize=1)
def jax_reference():
    """(loss, losses, gradient tree as numpy) of JAX at the tiny weights on train_batch(0)."""
    jparams = tiny_models()[1]
    (loss, losses), grads = jax_value_and_grad()(jparams, {k: jnp.asarray(v) for k, v in train_batch().items()})
    return float(loss), {k: float(v) for k, v in losses.items()}, jax.tree.map(np.asarray, grads)


def port_gradients(model, pcfg, batch, **kw):
    loss, losses = l4p_loss(model, pcfg, torch_batch(batch), TASKS, **kw)
    names, params = zip(*model.named_parameters())
    return loss, losses, dict(zip(names, torch.autograd.grad(loss, params, allow_unused=True)))


def hold_gradients(got: dict, want: dict, tol: float = GRAD_TOL) -> None:
    """Each port gradient (None = 0) against the JAX one mapped onto its name."""
    floor = ZERO_GRAD * max(want[name].abs().max().item() for name in got)
    for name, g in got.items():
        r = want[name].float()
        g = torch.zeros_like(r) if g is None else g
        err = (g - r).abs().max().item()
        assert err <= tol * r.abs().max().item() + floor, f"{name}: |port - JAX| {err:.3g}, max {r.abs().max():.3g}"


def test_l4p_loss_per_task_and_in_total_matches_jax():
    _, _, pcfg, model = tiny_models()
    ref_loss, ref_losses, _ = jax_reference()
    loss, losses = l4p_loss(model, pcfg, torch_batch(train_batch()), TASKS)
    assert set(losses) == set(ref_losses) == {"flow", "track_xy", "track_vis", "track_depth", "depth", "dyn_mask",
                                              "camray"}
    for k, v in ref_losses.items():
        check(losses[k].detach(), v, 1e-6, k)  # measured <= 4.9e-7 (dyn_mask), 2.3e-7 (flow)
    check(loss.detach(), ref_loss, 4e-7, "total")  # measured 1.6e-7


def test_every_parameter_gradient_matches_jax():
    """Every parameter of the five heads and the encoder, through the five
    kernel Functions' recomputes (the CPU wrappers run the plain versions)."""
    _, _, pcfg, model = tiny_models()
    _, _, grads = port_gradients(model, pcfg, train_batch())
    want = params_from_jax(jax_reference()[2], pcfg)
    assert len(grads) == len(list(model.parameters()))
    # no or a zero gradient exactly where JAX's is 0: refinenet4's first residual unit, the
    # prompt-feature and token-memory layers of later windows, the t2i k biases, label embeddings no
    # query carries, and the never-read iou_token and no_mask_embed, which JAX has no leaves for
    # (params_from_jax fills 0)
    zero = {n for n, g in grads.items() if g is None or not g.any()}
    assert zero == {n for n in grads if not want[n].any()} and len(zero) < len(grads) // 10, sorted(zero)
    hold_gradients(grads, want)


def test_loss_refuses_a_clip_that_is_not_one_window_and_unknown_tasks():
    _, _, pcfg, model = tiny_models()
    batch = torch_batch(train_batch(t=6))
    with pytest.raises(ValueError, match="single-window"):
        l4p_loss(model, pcfg, batch, ("depth",))
    with torch.no_grad(), pytest.raises(ValueError, match="unknown task"):
        l4p_loss(model, pcfg, torch_batch(train_batch()), ("depth", "normals"))


# --- each kernel Function against the JAX custom VJP ---------------------------

def flash_case():
    """q, k, v (2, 2, 256, 64) through JAX's flash_attention VJP (the Pallas
    kernel in interpret mode forward, `_flash_bwd` backward)."""
    from l4p_tpu.ops import flash_attention as JFA

    from l4p_tpu_torch.ops import flash_attention as FA

    scale = 64 ** -0.5
    jf = jax.custom_vjp(lambda q, k, v: JFA._flash_attention_impl(q, k, v, scale, 256, interpret=True))
    jf.defvjp(lambda q, k, v: (jf(q, k, v), (q, k, v)), lambda res, g: JFA._flash_bwd(scale, 256, res, g))
    args = [rand((2, 2, 256, 64), s) for s in (1, 2, 3)]
    return args, lambda p, *a: jf(*a), None, lambda *a: FA.flash_attention(*a, scale), FA.FlashAttentionFunction, None


def upscale_case():
    """tests/test_torch_fused_upscale's operands through JAX's
    fused_upscale_hypernet (the Pallas kernel in interpret mode forward,
    `_fused_bwd` backward), all eight differentiated."""
    from l4p_tpu.ops.fused_upscale import fused_upscale_hypernet as jax_upscale

    from l4p_tpu_torch.ops import fused_upscale as FU
    from tests.test_torch_fused_upscale import inputs

    return (list(inputs(0)), lambda p, *a: jax_upscale(*a, True), None, FU.fused_upscale_hypernet,
            FU.FusedUpscaleFunction, None)


def twoway_case():
    """test_torch_sam's transformer (C = 128, P = 256, 8 heads, N = 3) through
    JAX's _twoway_streamed (the fused-keys kernels in interpret mode
    forward, the factored path backward): queries, keys, their encodings
    and the transformer's parameters."""
    from l4p_tpu.models.sam import _twoway_streamed

    from l4p_tpu_torch.checkpoint import _track_state
    from l4p_tpu_torch.models import sam as PS
    from tests.test_torch_sam import models, twoway_inputs

    jcfg, params, pcfg, head = models()
    img, pos, tokens = twoway_inputs()
    tf = copy.deepcopy(head.mask_decoder.transformer)

    def names(grads):
        tree = jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, params))
        tree["mask_decoder"]["transformer"] = jax.tree.map(np.asarray, grads)
        pre = "mask_decoder.transformer."
        return {k[len(pre):]: v for k, v in _track_state(tree, pcfg).items() if k.startswith(pre)}

    return ([tokens, img, tokens.copy(), pos[0]], lambda p, *a: _twoway_streamed(jcfg.sam, True, p, *a),
            params["mask_decoder"]["transformer"], lambda *a: PS.twoway_streamed(tf, pcfg.sam, *a),
            PS.TwoWayStreamedFunction, (tf, names))


def encoder_case():
    """test_torch_fused_encoder's config (E = 256, 4 heads, 2 blocks, N =
    256) through JAX's fused_encoder_blocks (the Pallas whole-encoder
    kernel in interpret mode forward, `_fe_bwd` backward): x and the
    blocks' parameters."""
    from l4p_tpu.models.encoder import init_encoder_params
    from l4p_tpu.ops.fused_encoder import fused_encoder_blocks as jax_blocks

    from l4p_tpu_torch.checkpoint import _encoder_state
    from l4p_tpu_torch.ops import fused_encoder as FE
    from tests.test_torch_fused_encoder import jax_cfg, port_encoder

    jcfg = jax_cfg(mlp_ratio=2.0, depth=2)
    params = init_encoder_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    enc = port_encoder(jcfg, params)

    def names(grads):
        return {k[len("blocks."):]: v for k, v in _encoder_state(jax.tree.map(np.asarray, grads), enc.cfg).items()
                if k.startswith("blocks.")}

    return ([rand((2, 256, 256), 1)], lambda p, x: jax_blocks(p, x, jcfg, (1, 2)), params,
            lambda x: FE.fused_encoder_blocks(enc.blocks, x, enc.cfg, (1, 2)), FE.FusedEncoderFunction,
            (enc.blocks, names))


CASES = {"flash_attention": flash_case, "fused_upscale_hypernet": upscale_case, "twoway_streamed": twoway_case,
         "fused_encoder_blocks": encoder_case}


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_gradients_match_jax_custom_vjp(name):
    """Input gradients (and the module's parameter gradients) of each kernel
    Function against jax.vjp of the JAX kernel's custom VJP, on the same
    random cotangents; every output's grad_fn is the Function's node."""
    args, jax_fn, jparams, port_fn, function, module = CASES[name]()
    outs, vjp = jax.vjp(jax_fn, jparams, *(jnp.asarray(a) for a in args))
    outs = outs if isinstance(outs, tuple) else (outs,)
    cots = [rand(o.shape, 10 + i) for i, o in enumerate(outs)]
    ref_params, *ref = vjp(tuple(jnp.asarray(c) for c in cots) if len(cots) > 1 else jnp.asarray(cots[0]))
    xs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = port_fn(*xs)
    got = got if isinstance(got, tuple) else (got,)
    for o, r in zip(got, outs):
        assert isinstance(o.grad_fn, function._backward_cls), (name, o.grad_fn)
        check(o.detach(), r, 5e-6, f"{name} forward")  # measured <= 2.2e-6 (the fused encoder)
    params = dict(module[0].named_parameters()) if module is not None else {}
    grads = torch.autograd.grad(got, xs + list(params.values()), [torch.from_numpy(c) for c in cots],
                                allow_unused=True)
    for i, (g, r) in enumerate(zip(grads, ref)):
        r = torch.from_numpy(np.asarray(r))
        assert g is not None, f"{name}: no gradient for input {i}"
        err = (g - r).abs().max().item()
        # measured <= 6.0e-6 of each gradient's largest value (the two-way transformer's encodings)
        assert err <= 1.2e-5 * r.abs().max().item(), f"{name} input {i}: {err:.3g}"
    if module is not None:
        # measured <= 1.2e-5 (the two-way transformer's image-to-token q/k projections), 1.2e-6 (the blocks)
        hold_gradients(dict(zip(params, grads[len(xs):])), module[1](ref_params), tol=2.5e-5)


# --- trainable parameters ----------------------------------------------------

FREEZE_CASES = {"no flags": dict(), "freeze_video_encoder": dict(freeze_video_encoder=True),
                "unfreeze_blocks=()": dict(freeze_video_encoder=True, unfreeze_blocks=()),
                "unfreeze_blocks=(1,)": dict(freeze_video_encoder=True, unfreeze_blocks=(1,)),
                "freeze_heads": dict(freeze_heads=("depth", "track_2d"))}


@pytest.mark.parametrize("case", sorted(FREEZE_CASES))
def test_trainable_mask_matches_jax(case):
    """JAX's multipliers broadcast to each leaf and mapped onto the port's
    names: a port parameter trains where they are all 1, is frozen where
    they are all 0 (a leaf of stacked blocks is split per block)."""
    from l4p_tpu.train import trainable_mask as jax_mask

    jcfg, jparams, pcfg, model = tiny_models()
    flags = FREEZE_CASES[case]
    jcfg, pcfg = (dataclasses.replace(c, **flags) for c in (jcfg, pcfg))
    full = jax.tree.map(lambda m, p: np.broadcast_to(np.asarray(m, np.float32), p.shape), jax_mask(jparams, jcfg),
                        jparams)
    want = params_from_jax(full, pcfg)
    got = trainable_mask(model, pcfg)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, trains in got.items():
        m = want[name]
        assert bool((m == 1).all()) if trains else bool((m == 0).all()), (case, name)
    assert any(got.values())


# --- the optimizer against optax ----------------------------------------------

@pytest.mark.parametrize("total_steps", [1, 2, 3, 10, 100])
def test_schedule_matches_optax_at_every_step(total_steps):
    """make_optimizer's schedule (the pct_start clamp, max(total_steps, 4))
    against the optax schedule JAX's make_optimizer builds, at every count
    0..T+2, and the schedule alone at a few other settings."""
    import optax

    pct = max(0.1, min(2.0 / max(total_steps, 2), 0.5))
    ref = optax.cosine_onecycle_schedule(transition_steps=max(total_steps, 4), peak_value=1e-3, pct_start=pct)
    _, _, _, model = tiny_models()
    sched = make_optimizer(copy.deepcopy(model), lr=1e-3, total_steps=total_steps).schedule
    for i in range(max(total_steps, 4) + 3):
        # measured <= 1.2e-7 of the peak (float32 cos in XLA and in numpy)
        assert abs(float(sched(i)) - float(ref(i))) <= 3e-7 * 1e-3, (i, float(sched(i)), float(ref(i)))
    for t, pct in ((7, 0.3), (50, 0.25)):
        ref, mine = optax.cosine_onecycle_schedule(t, 2.0, pct), cosine_onecycle_schedule(t, 2.0, pct)
        assert max(abs(float(mine(i)) - float(ref(i))) for i in range(t + 3)) <= 3e-7 * 2.0


@pytest.mark.parametrize("scale", [100.0, 0.01])
def test_clip_and_adamw_match_optax(scale):
    """Three updates of a toy tree through JAX's make_optimizer (global-norm
    clip, then AdamW on the one-cycle schedule) and the port's AdamW, with
    gradients far above (scale 100) and below (0.01) the clip's norm of 1."""
    from l4p_tpu.train import make_optimizer as jax_optimizer

    shapes = {"a": (4, 5), "b": (7,), "c": (3, 2, 2)}
    params = {k: rand(s, i) for i, (k, s) in enumerate(shapes.items())}
    grads = [{k: rand(s, 10 * j + i) * scale for i, (k, s) in enumerate(shapes.items())} for j in range(3)]
    opt = jax_optimizer(lr=1e-2, total_steps=3, weight_decay=0.05)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    pct = max(0.1, min(2.0 / 3, 0.5))
    port = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    adamw = AdamW(port, cosine_onecycle_schedule(4, 1e-2, pct), weight_decay=0.05, clip_norm=1.0)
    for g in grads:
        norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))
        assert (norm > 1.0) == (scale > 1)
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        adamw.step([torch.from_numpy(g[k]) for k in port])
    for k in port:
        check(port[k], jp[k], 3e-8, k)  # measured <= 1.3e-8
    assert adamw.count == 3


def test_three_train_steps_match_jax():
    """Three train_steps of the port against JAX's (make_optimizer with its
    trainable_mask, pe_gaussian's entry at 0; lr 1e-3, three steps) on
    train_batch(0), (1), (2): the losses and every parameter after them."""
    import optax

    from l4p_tpu.train import make_optimizer as jax_optimizer
    from l4p_tpu.train import trainable_mask as jax_mask

    jcfg, jparams, pcfg, model = tiny_models()
    model = copy.deepcopy(model)
    mask = jax_mask(jparams, jcfg)
    mask["task_heads"]["track_2d"]["prompt_encoder"]["pe_gaussian"] = 0.0  # a buffer in the port
    opt = jax_optimizer(lr=1e-3, total_steps=3, mask=mask)
    state = opt.init(jparams)
    update = jax.jit(opt.update)
    port_opt = make_optimizer(model, lr=1e-3, total_steps=3, mask=trainable_mask(model, pcfg))
    assert "task_heads.track_2d.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix" not in port_opt.params
    noise = set()  # gradients 0 in exact arithmetic, of fp32 noise in both packages
    for seed in range(3):
        batch = train_batch(seed)
        (loss, _), grads = jax_value_and_grad()(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        g = params_from_jax(jax.tree.map(np.asarray, grads), pcfg)
        top = max(v.abs().max().item() for v in g.values())
        noise |= {n for n, v in g.items() if 0 < v.abs().max().item() < ZERO_GRAD * top}
        updates, state = update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        port_loss, _ = train_step(model, port_opt, torch_batch(batch), pcfg, TASKS)
        check(port_loss, float(loss), 5e-7, f"loss {seed}")  # measured <= 2.5e-7
    assert noise and all(".k_proj.bias" in n for n in noise), sorted(noise)
    want = params_from_jax(jax.tree.map(np.asarray, jparams), pcfg)
    for name, p in model.state_dict().items():
        if name in noise:
            # Adam scales noise of ~1e-10 by 1 / (|g| + eps): each step moves such a bias by up to lr
            assert (p - want[name]).abs().max() <= 3 * 1e-3, name
        else:
            check(p, want[name], 1.5e-6, name)  # measured <= 6.8e-7 (the mask decoder)


# --- stochastic depth ----------------------------------------------------------

class JaxDropPath:
    """The masks JAX's encoder draws from `key` (l4p_tpu/models/encoder.py:
    409-413, :268-282): block i's keys are split(key, depth)[i] folded with
    the branch, each mask bernoulli(1 - rate_i) over the batch."""

    def __init__(self, key, cfg):
        self.keys = jax.random.split(key, cfg.depth)
        self.keep_probs = (1.0 - jnp.linspace(0.0, cfg.drop_path_rate, cfg.depth)).astype(jnp.float32)

    def keep(self, block, branch, batch, keep_prob):
        m = jax.random.bernoulli(jax.random.fold_in(self.keys[block], branch), self.keep_probs[block], (batch, 1, 1))
        return torch.from_numpy(np.asarray(m).reshape(batch))


def drop_path_encoders(rate: float = 0.6):
    """(JAX config, JAX encoder params, port encoder) of the tiny model with drop_path_rate `rate`."""
    jcfg, jparams, pcfg, model = tiny_models()
    jenc = dataclasses.replace(jcfg.encoder, drop_path_rate=rate)
    enc = PE.VideoEncoder(dataclasses.replace(pcfg.encoder, drop_path_rate=rate))
    enc.load_state_dict(model.video_encoder.state_dict(), strict=True)
    return jenc, jparams["video_encoder"], enc


def test_drop_path_with_jax_masks_matches_jax_encoder():
    """Hooks, output and the encoder's parameter gradients of a random
    projection of the output, with JAX's masks from PRNGKey(3) injected,
    over a batch of 4 clips so that the masks differ across it."""
    from l4p_tpu.models.encoder import encoder_apply

    jenc, jp, enc = drop_path_encoders()
    x = rand((4, 3, 4, 28, 28), 1)
    w = rand((4, 8, 64), 2)
    key = jax.random.PRNGKey(3)

    def jax_fn(p):
        out = encoder_apply(p, jnp.asarray(x), jenc, hooks=(1, 4), drop_path_key=key)
        return (out["final"] * w).sum(), out

    (ref_s, ref), ref_g = jax.value_and_grad(jax_fn, has_aux=True)(jp)
    out = enc(enc.embed(torch.from_numpy(x)), (1, 4), drop_path_draws=JaxDropPath(key, jenc))
    for i, (a, b) in enumerate(zip(out["hooks"], ref["hooks"])):
        check(a.detach(), b, 4e-6, f"hook {i}")  # measured <= 1.8e-6, as without stochastic depth
    check(out["final"].detach(), ref["final"], 4e-6, "final")
    s = (out["final"] * torch.from_numpy(w)).sum()
    names, params = zip(*enc.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(s, params)))
    from l4p_tpu_torch.checkpoint import _encoder_state

    hold_gradients(grads, _encoder_state(jax.tree.map(np.asarray, ref_g), enc.cfg))
    dropped = [JaxDropPath(key, jenc).keep(i, b, 4, None) for i in range(4) for b in (0, 1)]
    assert not all(bool(m.all()) for m in dropped)  # some branch of some clip was dropped


def test_drop_path_is_identity_without_draws_and_random_with_them():
    """tests/test_droppath.py's checks on the port: no draws gives the
    rate-0 encoder bit for bit; two steps' draws give two outputs, one
    step's draws the same output twice."""
    _, _, enc = drop_path_encoders()
    zero = PE.VideoEncoder(dataclasses.replace(enc.cfg, drop_path_rate=0.0))
    zero.load_state_dict(enc.state_dict())
    tok = enc.embed(torch.from_numpy(rand((4, 3, 4, 28, 28), 1)))
    with torch.no_grad():
        assert torch.equal(enc(tok, (4,))["final"], zero(tok, (4,))["final"])
        o1, o2, o1b = (enc(tok, (4,), drop_path_draws=PE.RandomDropPath(0, s))["final"] for s in (1, 2, 1))
    assert (o1 - o2).abs().max() > 1e-6 and torch.equal(o1, o1b)


def test_drop_path_expectation_scale():
    """E[drop_path(x)] == x: each sample all 0 or all 1/keep, mean about 1."""
    keep_prob = torch.tensor(0.6)
    mask = PE.RandomDropPath(0, 0).keep(0, 0, 512, keep_prob)
    out = PE.drop_path(torch.ones((512, 3, 5)), mask, keep_prob)
    per_sample = out.reshape(512, -1)
    assert torch.equal(per_sample.min(1).values, per_sample.max(1).values)
    assert all(min(abs(v), abs(v - 1 / 0.6)) < 1e-6 for v in per_sample[:, 0].tolist())
    assert abs(out.mean().item() - 1.0) < 0.1


def test_drop_path_keeps_the_encoder_off_the_fused_kernels():
    """JAX's gate: with stochastic depth the blocks run one by one even under
    fused_encoder; without it the fused entry point runs."""
    _, _, enc = drop_path_encoders()
    calls = []

    def blocks_fn(*args):
        from l4p_tpu_torch.ops.fused_encoder import fused_encoder_blocks_plain

        calls.append(1)
        return fused_encoder_blocks_plain(*args)

    tok = enc.embed(torch.from_numpy(rand((1, 3, 4, 28, 28), 1)))
    with torch.no_grad():
        enc(tok, (4,), encoder_blocks=blocks_fn, drop_path_draws=PE.RandomDropPath(0, 0))
        assert calls == []
        enc(tok, (4,), encoder_blocks=blocks_fn)
        assert calls == [1]


def test_frozen_encoder_runs_without_autograd():
    """freeze_video_encoder without unfreeze_blocks: the encoder's outputs
    carry no graph (JAX's stop_gradient), so its Functions' backward never
    runs; the heads still get gradients."""
    _, _, pcfg, model = tiny_models()
    pcfg = dataclasses.replace(pcfg, freeze_video_encoder=True)
    _, _, grads = port_gradients(model, pcfg, train_batch())
    assert all(g is None for n, g in grads.items() if n.startswith("video_encoder."))
    assert grads["task_heads.depth.task_head.dpt.head2.0.bias"] is not None
