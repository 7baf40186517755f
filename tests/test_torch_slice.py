"""The dense-task slice end to end: the port's InferenceSession vs
l4p_tpu.inference.InferenceSession at the tiny config (fp32, CPU, T=8:
three windows), with the weights carried across by params_from_jax; and the
stitching functions against their JAX counterparts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l4p_tpu_torch import InferenceSession, params_from_jax
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


def test_session_takes_a_module_or_its_state_dict():
    _, _, pcfg, model = tiny_models()
    data = {"rgb_u8_bthw3": torch.from_numpy(video_u8(6, seed=4))}
    sess = InferenceSession(pcfg, ("depth", "flow_2d_backward"), "cpu")
    a = sess(model, data)
    b = sess(model.state_dict(), data)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("tasks", [("depth", "track_2d"), ("camray",), ()])
def test_session_refuses_tasks_outside_the_slice(tasks):
    _, _, pcfg, _ = tiny_models()
    with pytest.raises(ValueError):
        InferenceSession(pcfg, tasks, "cpu")


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
