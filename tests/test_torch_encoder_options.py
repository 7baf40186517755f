"""The encoder's option branches against the JAX package (fp32, CPU, the
tiny config): cosine attention, LayerScale, learnable positions and the
Plucker camera embedding (input / output x add / concat), each through
encoder_apply and encode_windows on float and uint8 video; an all-task
session with the embedding against l4p_forward, bidirectional tracks
included; a strict round trip of a state dict holding every optional tensor;
the overlay of an encoder-only checkpoint; and the refusals (streaming,
the fused encoder, a missing camera)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l4p_tpu_torch import ALL_TASKS, L4P, InferenceSession, StreamingL4P, params_from_jax
from l4p_tpu_torch.checkpoint import load_video_encoder_ckpt, released_state_dict
from l4p_tpu_torch.models.l4p import encode_windows
from l4p_tpu_torch.ops import fused_encoder as FE
from tests.test_torch_camray import JaxDraws, cameras
from tests.test_torch_encoder import video_u8
from tests.test_torch_ops import check, port_config, rand

torch.set_num_threads(1)

# (id, encoder fields); the options' tensors are randomised below so that none sits at its init
OPTIONS = {
    "cos_attn": dict(cos_attn=True),
    "layer_scale": dict(init_values=0.1),
    "learnable_pos": dict(use_learnable_pos_emb=True),
    "cam_input_add": dict(cam_emb_placed_at="input", cam_emb_type="add"),
    "cam_input_concat": dict(cam_emb_placed_at="input", cam_emb_type="concat"),
    "cam_output_add": dict(cam_emb_placed_at="output", cam_emb_type="add"),
    "cam_output_concat": dict(cam_emb_placed_at="output", cam_emb_type="concat"),
}


def randomise_options(jparams, learnable_pos: bool, seed: int = 0):
    """The JAX params with the options' tensors drawn away from their init:
    logit scales in [1, 5.5] (above the 4.6052 clamp too), gains around
    +-0.1, learnable positions with noise; the camera projection is already
    random."""
    rng = np.random.default_rng(seed)
    enc = dict(jparams["video_encoder"])
    blocks = dict(enc["blocks"])
    if "attn_scale" in blocks:
        blocks["attn_scale"] = jnp.asarray(rng.uniform(1.0, 5.5, blocks["attn_scale"].shape).astype(np.float32))
    for g in ("gamma_1", "gamma_2"):
        if g in blocks:
            blocks[g] = jnp.asarray(0.1 * rng.standard_normal(blocks[g].shape).astype(np.float32))
    enc["blocks"] = blocks
    if learnable_pos:
        enc["pos_embed"] = enc["pos_embed"] + jnp.asarray(0.1 * rng.standard_normal(enc["pos_embed"].shape),
                                                          jnp.float32)
    return {**jparams, "video_encoder": enc}


def option_models(base, **enc_kw):
    """(JAX config, JAX params, port config, port model) of `base` (a JAX
    L4PConfig) with the encoder fields `enc_kw`, on the same weights."""
    from l4p_tpu.config import init_l4p_params

    jcfg = dataclasses.replace(base, encoder=dataclasses.replace(base.encoder, **enc_kw))
    jparams = randomise_options(init_l4p_params(jcfg, jax.random.PRNGKey(0), tasks=ALL_TASKS),
                                jcfg.encoder.use_learnable_pos_emb)
    pcfg = port_config(jcfg)
    model = L4P(pcfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), pcfg), strict=True)
    return jcfg, jparams, pcfg, model.eval()


# cosine attention's logit scales reach 100 and amplify fp32 rounding. Against a float64 run of
# JAX's functions, the port's hooks measured <= 5.4e-5 (encoder_apply) and 9.5e-6
# (encode_windows), JAX's own fp32 runs <= 5.4e-5 and 2.7e-5; the two fp32 runs differ by
# <= 2.7e-5 and are held at 7e-5
TOL = {"cos_attn": 7e-5}


@functools.lru_cache(maxsize=None)
def tiny_option_models(option: str):
    """The tiny config (MLP ratio 4, a width the fused gate takes) with one option."""
    from tests.test_l4p_forward import tiny_cfg

    base = tiny_cfg()
    base = dataclasses.replace(base, encoder=dataclasses.replace(base.encoder, mlp_ratio=4.0))
    return option_models(base, **OPTIONS[option])


def camera_inputs(t: int, hw=(28, 28), seed: int = 0):
    """Pixel intrinsics and cam_T_world extrinsics (1, 4, 4, t) of a
    synthetic trajectory."""
    k, e = cameras(1, t, seed)
    k_px = k.copy()
    k_px[:, 0] *= hw[1]
    k_px[:, 1] *= hw[0]
    k_px[:, :2, 2] -= 0.5
    return k_px.astype(np.float32), e.astype(np.float32)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_encoder_apply_matches_jax(option):
    """One window, hooks (0, 2, 4) and the final output, normalised cameras."""
    from l4p_tpu.models.encoder import encoder_apply

    jcfg, jparams, _, model = tiny_option_models(option)
    x = rand((2, 3, 4, 28, 28), 1)
    k, e = cameras(2, 4, seed=1)
    hooks = (0, 2, 4)
    ref = encoder_apply(jparams["video_encoder"], jnp.asarray(x), jcfg.encoder, hooks=hooks,
                        intrinsics_b44t=jnp.asarray(k), extrinsics_b44t=jnp.asarray(e))
    enc = model.video_encoder
    with torch.no_grad():
        out = enc(enc.embed(torch.from_numpy(x)), hooks, intrinsics_b44t=torch.from_numpy(k),
                  extrinsics_b44t=torch.from_numpy(e))
    tol = TOL.get(option, 5e-6)  # measured <= 2.7e-6 but for cos_attn
    for h, p, r in zip(hooks, out["hooks"], ref["hooks"]):
        check(p, r, tol, f"{option} hook {h}")
    check(out["final"], ref["final"], tol, f"{option} final")


@pytest.mark.parametrize("source", ["uint8", "float"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_encode_windows_matches_jax(option, source):
    """T = 8 at window 4 / stride 2: three windows in chunks of 2 + 1, each
    window's cameras sliced from the video's."""
    from l4p_tpu.models.l4p import encode_windows as jax_encode_windows

    jcfg, jparams, pcfg, model = tiny_option_models(option)
    k, e = camera_inputs(8, seed=2)
    if source == "uint8":
        u8 = video_u8(8, seed=2)
        ref = jax_encode_windows(jparams["video_encoder"], jcfg, None, jnp.asarray(k), jnp.asarray(e),
                                 rgb_u8_bthw3=jnp.asarray(u8))
        args = dict(rgb_u8_bthw3=torch.from_numpy(u8))
    else:
        x = rand((1, 3, 8, 28, 28), 2)
        ref = jax_encode_windows(jparams["video_encoder"], jcfg, jnp.asarray(x), jnp.asarray(k), jnp.asarray(e))
        args = dict(rgb_b3thw=torch.from_numpy(x))
    with torch.no_grad():
        out = encode_windows(model.video_encoder, pcfg, **args, intrinsics_b44t=torch.from_numpy(k),
                             extrinsics_b44t=torch.from_numpy(e))
    tol = TOL.get(option, 1.5e-5)  # measured <= 7.5e-6 but for cos_attn
    for h in ref["hooks"]:
        check(out["hooks"][h], ref["hooks"][h], tol, f"{option} hook {h}")
    check(out["final"], ref["final"], tol, f"{option} final")


def test_plucker_rays_and_pose_scaling_match_jax():
    from l4p_tpu.geometry import core as C
    from l4p_tpu_torch.geometry import core as PC

    k, e = cameras(2, 5, seed=3)
    for first_ref in (True, False):
        for norm in (False, True):
            ref, ref_s = C.get_rays_plucker(jnp.asarray(k), jnp.asarray(e), (3, 4), first_ref, norm)
            out, out_s = PC.get_rays_plucker(torch.from_numpy(k), torch.from_numpy(e), (3, 4), first_ref, norm)
            check(out, ref, 2.5e-7, f"rays first_ref={first_ref} normalize_dist={norm}")  # measured <= 1.1e-7
            assert (out_s is None) == (ref_s is None)
            if norm:
                check(out_s, ref_s, 2e-7, "scale")  # measured <= 8.9e-8
    rays, s = rand((2, 6, 3, 4, 5), 4), rand((2,), 5, 0.5, 2.0)
    check(PC.scale_rays_plucker(torch.from_numpy(rays), torch.from_numpy(s)),
          C.scale_rays_plucker(jnp.asarray(rays), jnp.asarray(s)), 0)
    check(PC.scale_extrinsics(torch.from_numpy(e), torch.from_numpy(s)),
          C.scale_extrinsics(jnp.asarray(e), jnp.asarray(s)), 0)


@functools.lru_cache(maxsize=None)
def camray_option_models(place: str):
    """test_torch_slice.fused_models' 8 x 8-ray config (the camray solve is
    well conditioned there) on the default encoder, with the camera
    embedding at `place` ('add')."""
    from tests.test_torch_slice import fused_models

    base = fused_models()[0]
    base = dataclasses.replace(base, encoder=dataclasses.replace(base.encoder, fused_encoder=False,
                                                                 flash_interpret=False))
    return option_models(base, cam_emb_placed_at=place, cam_emb_type="add")


@pytest.mark.parametrize("place,dirs", [("input", (1,)), ("output", (1, -1))])
def test_all_task_session_with_the_camera_embedding_matches_jax_forward(place, dirs):
    """bench.py's five tasks with the joint Sim(3) stitch on 12 frames (two
    windows of 8 at stride 4) and 5 queries, the embedding on the encoder's
    input, the extrinsics of a synthetic trajectory; tracks forward, and
    both ways (the backward pass encodes the flipped video with its cameras
    flipped). JAX's l4p_forward draws from PRNGKey(0), JaxDraws hands the
    port the same draws."""
    from l4p_tpu.models.l4p import l4p_forward
    from tests.test_torch_slice import all_task_request

    jcfg, jparams, pcfg, model = camray_option_models(place)
    jcfg = dataclasses.replace(jcfg, track=dataclasses.replace(jcfg.track, estimation_directions=dirs))
    pcfg = dataclasses.replace(pcfg, track=dataclasses.replace(pcfg.track, estimation_directions=dirs))
    data = all_task_request()
    data["extrinsics_b44t"] = cameras(1, 12, seed=5)[1]
    fwd = jax.jit(lambda p, d: l4p_forward(p, jcfg, d, ALL_TASKS))
    ref = fwd(jparams, {k: jnp.asarray(v) for k, v in data.items()})
    out = InferenceSession(pcfg, ALL_TASKS, "cpu", draws=JaxDraws.for_session())(model, data)
    assert set(out) == set(ref)
    # measured <= 3.4e-7 on the dense outputs and tracks; 8.6e-5 on the poses and 9.4e-5 on K
    # (pixels), which the homography RANSAC and RQ on rays from random weights amplify
    tol = {"traj3d_est_b16t": 1.8e-4, "traj3d_intrinsics_est_b16t": 1.9e-4}
    for k in ref:
        check(out[k], ref[k], tol.get(k, 7e-7), k)


def test_forward_single_window_passes_the_cameras():
    """forward_single_window with the embedding equals the session's one
    window: the encoder sees the same normalised intrinsics and extrinsics."""
    from l4p_tpu_torch.models.l4p import forward_single_window

    _, _, pcfg, model = tiny_option_models("cam_output_concat")
    k, e = camera_inputs(4, seed=6)
    data = {"rgb_b3thw": rand((1, 3, 4, 28, 28), 6), "intrinsics_b44t": k, "extrinsics_b44t": e}
    tasks = ("depth", "flow_2d_backward", "dyn_mask")
    one = forward_single_window(model, pcfg, data, tasks, "cpu")
    sess = InferenceSession(pcfg, tasks, "cpu")(model, data)
    for key, v in sess.items():
        assert torch.equal(one[key], v), key
    with pytest.raises(ValueError, match="extrinsics"):
        forward_single_window(model, pcfg, {k_: v for k_, v in data.items() if k_ != "extrinsics_b44t"}, tasks, "cpu")


def option_state(pcfg, seed: int = 7):
    """A port state dict with every optional tensor randomised and a
    learnable pos_embed longer than the encoder's tokens (a checkpoint of
    more frames), under the Lightning prefix."""
    model = L4P(pcfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith(("attn.scale", "gamma_1", "gamma_2")):
            v = torch.rand(v.shape, generator=g) + 0.05
        if k == "video_encoder.pos_embed":
            v = torch.cat([v, torch.randn((1, 16, v.shape[-1]), generator=g)], dim=1)
        sd[f"l4p_model.{k}"] = v
    return sd


ALL_OPTIONS = dict(cos_attn=True, init_values=0.1, use_learnable_pos_emb=True, cam_emb_placed_at="output",
                   cam_emb_type="concat")


def test_state_dict_with_every_optional_tensor_loads_strictly_in_both_packages():
    """One state dict: the port's strict load (released_state_dict cuts the
    longer pos_embed) and JAX's strict convert_l4p; both encoders then agree."""
    from l4p_tpu.config import convert_l4p
    from l4p_tpu.models.encoder import encoder_apply
    from tests.test_l4p_forward import tiny_cfg

    base = tiny_cfg()
    jcfg = dataclasses.replace(base, encoder=dataclasses.replace(base.encoder, **ALL_OPTIONS))
    pcfg = port_config(jcfg)
    sd = option_state(pcfg)
    assert sd["l4p_model.video_encoder.pos_embed"].shape[1] == pcfg.encoder.num_tokens + 16
    model = L4P(pcfg)
    model.load_state_dict(released_state_dict(sd, pcfg), strict=True)
    jparams = convert_l4p(sd, jcfg)  # strict: every key consumed
    for key in ("blocks.0.attn.scale", "blocks.3.gamma_2", "pos_embed", "cam_emb.cam_emb_proj.weight"):
        want = sd[f"l4p_model.video_encoder.{key}"]
        got = model.video_encoder.state_dict()[key]
        assert torch.equal(got, want[:, : pcfg.encoder.num_tokens] if key == "pos_embed" else want), key
    x = rand((1, 3, 4, 28, 28), 8)
    k, e = cameras(1, 4, seed=8)
    ref = encoder_apply(jparams["video_encoder"], jnp.asarray(x), jcfg.encoder, hooks=(1, 4),
                        intrinsics_b44t=jnp.asarray(k), extrinsics_b44t=jnp.asarray(e))
    enc = model.video_encoder
    with torch.no_grad():
        out = enc(enc.embed(torch.from_numpy(x)), (1, 4), intrinsics_b44t=torch.from_numpy(k),
                  extrinsics_b44t=torch.from_numpy(e))
    for p, r in zip(out["hooks"], ref["hooks"]):
        check(p, r, 5e-6, "hook")  # measured <= 2.0e-6


def test_encoder_checkpoint_overlay_carries_the_options(tmp_path):
    """load_video_encoder_ckpt against JAX's load_video_encoder_ckpt on an
    encoder-only file with every optional tensor (pos_embed longer)."""
    from l4p_tpu.config import load_video_encoder_ckpt as jax_overlay
    from l4p_tpu.models.encoder import init_encoder_params
    from tests.test_l4p_forward import tiny_cfg

    base = tiny_cfg()
    jcfg = dataclasses.replace(base, encoder=dataclasses.replace(base.encoder, **ALL_OPTIONS))
    pcfg = port_config(jcfg)
    prefix = "l4p_model.video_encoder."
    enc_sd = {k[len(prefix):]: v for k, v in option_state(pcfg, seed=9).items() if k.startswith(prefix)}
    torch.save({"model": enc_sd}, tmp_path / "enc.pth")
    init = init_encoder_params(jcfg.encoder, jax.random.PRNGKey(3))
    ref = jax_overlay(init, str(tmp_path / "enc.pth"), jcfg.encoder, dtype=jnp.float32)
    model = L4P(pcfg)
    model.init_weights(torch.Generator().manual_seed(3))
    load_video_encoder_ckpt(model.video_encoder, tmp_path / "enc.pth")
    got = params_from_jax(jax.tree.map(np.asarray, {"video_encoder": ref, "task_heads": {}}),
                          dataclasses.replace(pcfg, heads=(), track=None))
    mine = model.video_encoder.state_dict()
    for k, v in got.items():
        assert torch.equal(mine[k.removeprefix("video_encoder.")], v), k


def test_streaming_refuses_the_camera_embedding():
    _, _, pcfg, model = tiny_option_models("cam_input_add")
    with pytest.raises(NotImplementedError, match="camera embedding"):
        StreamingL4P(model, pcfg, ("depth",), "cpu")


@pytest.mark.parametrize("option,reason", [("cos_attn", "cos_attn"), ("layer_scale", "init_values")])
def test_fused_encoder_refuses_cos_attn_and_layer_scale(option, reason):
    """`fused_encoder: true` with an option the kernels lack raises, on the
    CPU as on the card; JAX's gate refuses the same two."""
    from l4p_tpu.ops.fused_encoder import fused_encoder_available

    jcfg, jparams, pcfg, model = tiny_option_models(option)
    assert not fused_encoder_available(jcfg.encoder, jparams["video_encoder"], 16)
    fused = dataclasses.replace(pcfg, encoder=dataclasses.replace(pcfg.encoder, fused_encoder=True))
    for dev in ("cpu", "cuda"):
        assert reason in FE.fused_encoder_unsupported(fused.encoder, torch.bfloat16, torch.device(dev))
    with pytest.raises(ValueError, match=reason):
        InferenceSession(fused, ("depth",), "cpu")(model, {"rgb_u8_bthw3": video_u8(4)})


@pytest.mark.parametrize("option", ["learnable_pos", "cam_input_add"])
def test_fused_encoder_takes_the_options_outside_the_blocks(option):
    """Learnable positions and the camera embedding act outside the blocks:
    the fused path (plain blocks on the CPU) equals the block loop."""
    _, _, pcfg, model = tiny_option_models(option)
    fused = dataclasses.replace(pcfg, encoder=dataclasses.replace(pcfg.encoder, fused_encoder=True))
    assert FE.fused_encoder_unsupported(fused.encoder, torch.float32, torch.device("cpu")) is None
    k, e = camera_inputs(8, seed=10)
    data = {"rgb_u8_bthw3": video_u8(8, seed=10), "intrinsics_b44t": k, "extrinsics_b44t": e}
    a = InferenceSession(pcfg, ("depth", "flow_2d_backward"), "cpu")(model, data)
    b = InferenceSession(fused, ("depth", "flow_2d_backward"), "cpu")(model, data)
    for key in a:
        check(b[key], a[key], 1e-7, key)  # measured <= 5e-8


def test_camera_embedding_without_extrinsics_raises():
    _, _, pcfg, model = tiny_option_models("cam_input_add")
    k, _ = camera_inputs(8)
    with pytest.raises(ValueError, match="extrinsics_b44t"):
        InferenceSession(pcfg, ("depth",), "cpu")(model, {"rgb_u8_bthw3": video_u8(8), "intrinsics_b44t": k})
