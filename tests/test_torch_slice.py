"""The port end to end: its InferenceSession vs
l4p_tpu.inference.InferenceSession at the tiny config (fp32, CPU, T=8:
three windows) on the dense tasks and with track_2d, with the weights
carried across by params_from_jax; and the stitching functions against their
JAX counterparts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l4p_tpu_torch import SLICE_TASKS, InferenceSession, params_from_jax
from l4p_tpu_torch.models import l4p as PL
from tests.test_torch_encoder import tiny_models, video_u8
from tests.test_torch_ops import check, rand

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


@pytest.mark.parametrize("tasks", [("depth", "camray"), ("camray",), ()])
def test_session_refuses_tasks_outside_the_slice(tasks):
    _, _, pcfg, _ = tiny_models()
    with pytest.raises(ValueError):
        InferenceSession(pcfg, tasks, "cpu")


def test_session_refuses_bidirectional_tracking():
    import dataclasses

    _, _, pcfg, _ = tiny_models()
    cfg = dataclasses.replace(pcfg, track=dataclasses.replace(pcfg.track, estimation_directions=(1, -1)))
    with pytest.raises(ValueError, match="forward only"):
        InferenceSession(cfg, SLICE_TASKS, "cpu")


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
    w = rand((4, 2, 1, 4, 3, 5), 0, 0.5, 5.0)  # stride 2 -> T = 10
    out = PL.stitch_depth_aligned(torch.from_numpy(w), 2, 10, ph)
    check(out, stitch_depth_aligned(jnp.asarray(w), 2, 10, jh), 7.5e-7)  # measured <= 3.7e-7
