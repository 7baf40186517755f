"""The port end to end: its InferenceSession vs
l4p_tpu.inference.InferenceSession at the tiny config (fp32, CPU, T=8:
three windows) on the dense tasks and with track_2d, with the weights
carried across by params_from_jax; and the stitching functions against their
JAX counterparts."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l4p_tpu_torch import ALL_TASKS, L4P, SLICE_TASKS, InferenceSession, params_from_jax
from l4p_tpu_torch.models import l4p as PL
from tests.test_torch_encoder import tiny_models, video_u8
from tests.test_torch_ops import check, port_config, rand

torch.set_num_threads(1)

TASKS = ("depth", "dyn_mask", "flow_2d_backward")


@pytest.mark.parametrize("source", ["uint8", "float"])
def test_session_matches_jax_session(source):
    from l4p_tpu.inference import InferenceSession as JaxSession

    jcfg, jparams, pcfg, _ = tiny_models()
    if source == "uint8":
        data = {"rgb_u8_bthw3": video_u8(8, seed=3)}
    else:
        data = {"rgb_b3thw": rand((1, 3, 8, 28, 28), 3)}
    ref = JaxSession(jcfg, TASKS)(jparams, {k: jnp.asarray(v) for k, v in data.items()})
    state = params_from_jax(jax.tree.map(np.asarray, jparams), pcfg)
    out = InferenceSession(pcfg, TASKS, "cpu")(state, data)
    assert set(out) == set(ref) == {"depth_est_b1thw", "dyn_mask_est_b1thw", "flow_2d_backward_est_b2thw"}
    for k in ref:
        assert out[k].shape == (1, 2 if k.startswith("flow") else 1, 8, 28, 28)
        # measured <= 7.1e-7 on depth (exp and the disparity chain amplify),
        # <= 6.4e-8 on flow and dyn_mask
        check(out[k], ref[k], 1.5e-6, k)


def test_session_with_track_matches_jax_session():
    """All four tasks of the slice, with make_data's 5 queries over T = 8
    (three windows): the dense outputs as above and the three track outputs."""
    from l4p_tpu.inference import InferenceSession as JaxSession
    from tests.test_l4p_forward import make_data

    jcfg, jparams, pcfg, model = tiny_models()
    data = {k: np.asarray(v) for k, v in make_data(T=8, N=5, seed=4).items() if k != "intrinsics_b44t"}
    ref = JaxSession(jcfg, SLICE_TASKS)(jparams, {k: jnp.asarray(v) for k, v in data.items()})
    out = InferenceSession(pcfg, SLICE_TASKS, "cpu")(model, data)
    assert set(out) == set(ref) == {"depth_est_b1thw", "dyn_mask_est_b1thw", "flow_2d_backward_est_b2thw",
                                    "track_2d_traj_est_bn2t", "track_2d_vis_est_bn1t", "track_2d_depth_est_bn1t"}
    for k in ref:
        if k.startswith("track_2d"):
            assert out[k].shape == (1, 5, 2 if "traj" in k else 1, 8)
        # measured <= 6.0e-7 (depth), 3.8e-7 (traj, in pixels), 6e-8 (vis, track depth)
        check(out[k], ref[k], 1.5e-6, k)


def test_session_takes_a_module_or_its_state_dict():
    _, _, pcfg, model = tiny_models()
    data = {"rgb_u8_bthw3": torch.from_numpy(video_u8(6, seed=4))}
    sess = InferenceSession(pcfg, ("depth", "flow_2d_backward"), "cpu")
    a = sess(model, data)
    b = sess(model.state_dict(), data)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("tasks", [("depth", "optical_flow"), ("camray",), ()])
def test_session_refuses_tasks_outside_the_slice(tasks):
    """An unknown task, camray without a configured camray head, no task."""
    import dataclasses

    _, _, pcfg, _ = tiny_models()
    cfg = dataclasses.replace(pcfg, heads=tuple((n, h) for n, h in pcfg.heads if n != "camray"))
    with pytest.raises(ValueError):
        InferenceSession(cfg, tasks, "cpu")


def test_session_bidirectional_tracking_matches_jax():
    """estimation_directions (1, -1) on the four tasks of the slice against
    JAX l4p_forward (the JAX session refuses it): T = 8 (three windows), 11
    queries spread over the video in chunks of 8, so the flipped pass's query
    times, the merge at t + 0.5 >= q_t and the padding all run."""
    import dataclasses

    from l4p_tpu.models.l4p import l4p_forward
    from tests.test_l4p_forward import make_data

    jcfg, jparams, pcfg, model = tiny_models()
    jcfg = dataclasses.replace(jcfg, track=dataclasses.replace(jcfg.track, estimation_directions=(1, -1)))
    pcfg = dataclasses.replace(pcfg, track=dataclasses.replace(pcfg.track, estimation_directions=(1, -1)))
    data = {k: np.asarray(v) for k, v in make_data(T=8, N=11, seed=4).items() if k != "intrinsics_b44t"}
    ref = l4p_forward(jparams, jcfg, {k: jnp.asarray(v) for k, v in data.items()}, SLICE_TASKS)
    out = InferenceSession(pcfg, SLICE_TASKS, "cpu")(model, data)
    assert set(out) == set(ref)
    for k in ref:
        # measured <= 6.1e-7 (depth), 3.8e-7 (traj, in pixels)
        check(out[k], ref[k], 1.5e-6, k)


def test_session_refuses_other_frame_sizes():
    _, _, pcfg, model = tiny_models()
    data = {"rgb_u8_bthw3": np.zeros((1, 4, 42, 28, 3), np.uint8)}
    with pytest.raises(ValueError, match="frames are"):
        InferenceSession(pcfg, TASKS, "cpu")(model, data)


@pytest.mark.parametrize("flow_skip", [False, True])
def test_stitch_overwrite_matches_jax(flow_skip):
    from l4p_tpu.models.l4p import stitch_overwrite

    w = rand((3, 2, 2, 4, 3, 5), 0)  # (nw, B, C, ws, H, W), stride 2 -> T = 8
    out = PL.stitch_overwrite(torch.from_numpy(w), 2, 8, flow_skip)
    assert torch.equal(out, torch.from_numpy(np.array(stitch_overwrite(jnp.asarray(w), 2, 8, flow_skip))))


@pytest.mark.parametrize("align_type,pre_inverse", [("affine", True), ("affine", False), ("linear", False)])
def test_stitch_depth_aligned_matches_jax(align_type, pre_inverse):
    import dataclasses

    from l4p_tpu.models.l4p import stitch_depth_aligned

    jcfg, _, pcfg, _ = tiny_models()
    jh = dataclasses.replace(jcfg.head_dict["depth"], align_type=align_type, align_pre_inverse=pre_inverse)
    ph = dataclasses.replace(pcfg.head_dict["depth"], align_type=align_type, align_pre_inverse=pre_inverse)
    pcfg = dataclasses.replace(pcfg, heads=tuple((n, ph if n == "depth" else h) for n, h in pcfg.heads))
    w = rand((4, 2, 1, 4, 3, 5), 0, 0.5, 5.0)  # stride 2 -> T = 10
    # the port's depth chain is align_window's depth step inside stitch_dense_outputs
    out = PL.stitch_dense_outputs(pcfg, ("depth",), {"depth": torch.from_numpy(w)}, 2, 10)[f"{ph.task_name}_est_b1thw"]
    check(out, stitch_depth_aligned(jnp.asarray(w), 2, 10, jh), 7.5e-7)  # measured <= 3.7e-7


@functools.lru_cache(maxsize=1)
def fused_models():
    """A tiny config on which the JAX session takes its fused-encoder path
    (E = 128, 2 heads of 64, MLP 512, 112 x 112 frames, 8-frame windows at
    stride 4: N = 256 tokens, the Pallas kernel's tile), with the camray
    head and joint alignment; (JAX config, JAX params, port config, port
    model) on the same weights."""
    import dataclasses

    from l4p_tpu.config import init_l4p_params
    from l4p_tpu.models.sam import SamConfig
    from tests.test_l4p_forward import tiny_cfg

    base = tiny_cfg()
    enc = dataclasses.replace(base.encoder, img_size=112, embed_dim=128, num_heads=2, mlp_ratio=4.0, all_frames=8,
                              use_flash_attention=False, fused_encoder=True, flash_interpret=True)
    heads = []
    for name, h in base.heads:
        dpt = dataclasses.replace(h.dpt, dim_tokens=128)
        if name == "camray":
            dpt = dataclasses.replace(dpt, output_size=(8, 8, 8))
        heads.append((name, dataclasses.replace(h, dpt=dpt)))
    track = dataclasses.replace(base.track, image_size=(8, 112, 112), sam=SamConfig(
        embed_dim=128, image_embedding_size=(4, 8, 8), input_image_size=(8, 112, 112)))
    jcfg = dataclasses.replace(base, encoder=enc, window_size=(8, 112, 112), window_stride_t=4, heads=tuple(heads),
                               track=track, sim3_num_trials=128, sim3_min_samples=10)
    jparams = init_l4p_params(jcfg, jax.random.PRNGKey(0), tasks=ALL_TASKS)
    pcfg = port_config(jcfg)
    model = L4P(pcfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), pcfg), strict=True)
    return jcfg, jparams, pcfg, model.eval()


def all_task_request(t=12, n=5, seed=5):
    """uint8 frames, intrinsics built as bench.py builds them (bench.py:46-51,
    at 112 x 112) and n point queries."""
    rng = np.random.default_rng(seed)
    k = np.tile(np.diag([112.0, 112.0, 1, 1]).astype(np.float32)[None, :, :, None], (1, 1, 1, t))
    k[:, 0, 2] = k[:, 1, 2] = 56.0
    q = np.stack([rng.uniform(0, t, n), rng.uniform(0, 112, n), rng.uniform(0, 112, n)], -1).astype(np.float32)
    return {"rgb_u8_bthw3": rng.integers(0, 256, (1, t, 112, 112, 3), dtype=np.uint8), "intrinsics_b44t": k,
            "track_2d_pointquerries_bn3": q[None], "track_2d_pointlabels_bn": np.ones((1, n), np.float32)}


def test_all_task_session_with_fused_encoder_matches_jax_session():
    """bench.py's request: the five tasks with the fused encoder and the
    joint Sim(3) stitch, 12 frames (two windows), 5 queries, against the JAX
    session (its Pallas encoder kernel in interpret mode) with the JAX
    session's own random draws."""
    from l4p_tpu.inference import InferenceSession as JaxSession
    from l4p_tpu.models.encoder import fused_encoder_engaged
    from tests.test_torch_camray import JaxDraws

    jcfg, jparams, pcfg, model = fused_models()
    assert fused_encoder_engaged(jcfg.encoder, jparams["video_encoder"], 256, jnp.float32)
    data = all_task_request()
    ref = JaxSession(jcfg, ALL_TASKS)(jparams, {k: jnp.asarray(v) for k, v in data.items()})
    out = InferenceSession(pcfg, ALL_TASKS, "cpu", draws=JaxDraws.for_session())(model, data)
    assert set(out) == set(ref) == {
        "flow_2d_backward_est_b2thw", "depth_est_b1thw", "dyn_mask_est_b1thw", "traj3d_est_b16t",
        "traj3d_intrinsics_est_b16t", "track_2d_traj_est_bn2t", "track_2d_vis_est_bn1t", "track_2d_depth_est_bn1t"}
    # measured <= 2.0e-7 on the dense and track outputs; 1.0e-5 on the poses
    # and 2.7e-5 on K (pixels), which the homography RANSAC and RQ on rays
    # from random weights amplify
    tol = {"traj3d_est_b16t": 2.1e-5, "traj3d_intrinsics_est_b16t": 5.4e-5}
    for k in ref:
        check(out[k], ref[k], tol.get(k, 4e-7), k)
