"""Backward and bidirectional tracking in the port against the JAX package
(fp32, CPU, the tiny config, T = 8: three windows): the session with
estimation_directions (1, -1) or (-1,) against JAX l4p_forward (the JAX
session refuses both), and track_bidirectional against its JAX counterpart.
The weights are carried across by params_from_jax; queries are spread over
the video, so a query time off by one frame would show."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l4p_tpu_torch import ALL_TASKS, SLICE_TASKS, InferenceSession, track_bidirectional
from l4p_tpu_torch.models import l4p as PL
from tests.test_torch_camray import JaxDraws
from tests.test_torch_encoder import tiny_models
from tests.test_torch_ops import check

torch.set_num_threads(1)

# the poses and K as in the forward session (PERF.md §2's bands)
TOL = {"traj3d_est_b16t": 2.1e-5, "traj3d_intrinsics_est_b16t": 5.4e-5}


def with_directions(cfg, dirs):
    return dataclasses.replace(cfg, track=dataclasses.replace(cfg.track, estimation_directions=dirs))


def request(t=8, n=11, seed=6, source="uint8"):
    """t frames, intrinsics and n queries spread over the video (make_data's)."""
    from tests.test_l4p_forward import make_data

    data = {k: np.asarray(v) for k, v in make_data(T=t, N=n, seed=seed).items()}
    if source == "uint8":
        rng = np.random.default_rng(seed + 100)
        del data["rgb_b3thw"]
        data["rgb_u8_bthw3"] = rng.integers(0, 256, (1, t, 28, 28, 3), dtype=np.uint8)
    return data


@pytest.mark.parametrize("dirs,source", [((-1,), "uint8"), ((1, -1), "float")])
def test_session_directions_match_jax_forward(dirs, source):
    """The four slice tasks at the tiny config, T = 8 (three windows)."""
    from l4p_tpu.models.l4p import l4p_forward

    jcfg, jparams, pcfg, model = tiny_models()
    data = request(source=source)
    ref = l4p_forward(jparams, with_directions(jcfg, dirs), {k: jnp.asarray(v) for k, v in data.items()},
                      SLICE_TASKS)
    out = InferenceSession(with_directions(pcfg, dirs), SLICE_TASKS, "cpu")(model, data)
    assert set(out) == set(ref)
    for k in ref:
        # measured <= 4.5e-7 (traj, in pixels); depth 1.2e-6 on the float input (exp and the
        # disparity chain amplify)
        check(out[k], ref[k], 1.5e-6, k)


@pytest.mark.parametrize("dirs", [(1, -1), (-1,)])
def test_all_task_session_directions_match_jax_forward(dirs):
    """All five tasks with the JAX forward's own RANSAC draws
    (JaxDraws.for_session: fold_in 7 and 11 of PRNGKey(0)), on the config
    and request of the forward five-task parity test (test_torch_slice:
    E = 128, 112 x 112 frames, camray rays 8 x 8, the fused encoder; 12
    frames, two overlapping windows), with 11 queries spread over the video.
    The tiny config's 2 x 2 ray map gives the homography RANSAC four points,
    on which every hypothesis ties. The camera outputs do not depend on the
    track directions; this random-weight camera solve is ill-conditioned:
    on the default encoder or on 16 frames its poses read 5.1e-5 and its K
    2.1e-4 off JAX, forward-only tracking alike."""
    from l4p_tpu.models.l4p import l4p_forward
    from tests.test_torch_slice import all_task_request, fused_models

    jcfg, jparams, pcfg, model = fused_models()
    data = all_task_request(t=12, n=11, seed=5)
    jcfg = with_directions(jcfg, dirs)
    ref = jax.jit(lambda p, d: l4p_forward(p, jcfg, d, ALL_TASKS))(jparams, {k: jnp.asarray(v) for k, v in data.items()})
    out = InferenceSession(with_directions(pcfg, dirs), ALL_TASKS, "cpu", draws=JaxDraws.for_session())(model, data)
    assert set(out) == set(ref)
    for k in ref:
        # measured <= 4.0e-7 on the dense and track outputs; poses 9.8e-6, K 6.0e-6
        check(out[k], ref[k], TOL.get(k, 1.5e-6), k)


@pytest.mark.parametrize("dirs", [(1, -1), (-1,)])
def test_track_bidirectional_matches_jax(dirs):
    from l4p_tpu.models.l4p import track_bidirectional as jax_track_bidirectional

    jcfg, jparams, pcfg, model = tiny_models()
    data = request(seed=7)
    ref = jax_track_bidirectional(jparams, jcfg, {k: jnp.asarray(v) for k, v in data.items()}, directions=dirs)
    out = track_bidirectional(model, pcfg, data, "cpu", directions=dirs)
    assert set(out) == set(ref) == {"track_2d_traj_est_bn2t", "track_2d_vis_est_bn1t", "track_2d_depth_est_bn1t"}
    for k in ref:
        assert out[k].shape == (1, 11, 2 if "traj" in k else 1, 8)
        check(out[k], ref[k], 1.5e-6, k)  # measured <= 4.5e-7


def test_backward_pass_flips_query_times_and_merges_at_the_query():
    """T - t, not T - 1 - t; forward outputs from the query's frame on
    (t + 0.5 >= q_t), backward ones before it, as l4p.py:752-766 of the JAX
    package writes it."""
    q = torch.tensor([[[0.5, 3.0, 4.0], [5.5, 1.0, 2.0], [7.75, 0.0, 0.0]]])
    assert torch.equal(PL.flip_query_times(q, 8)[..., 0], torch.tensor([[7.5, 2.5, 0.25]]))
    assert torch.equal(q[..., 0], torch.tensor([[0.5, 5.5, 7.75]]))  # the input is not modified
    fwd = {"x": torch.ones((1, 3, 1, 8))}
    bwd = {"x": torch.zeros((1, 3, 1, 8))}
    merged = PL.merge_directions(fwd, bwd, q, 8)["x"][0, :, 0]
    t_ids = np.arange(8) + 0.5
    assert np.array_equal(merged.numpy(), (t_ids[None] - np.array([[0.5], [5.5], [7.75]]) >= 0).astype(np.float32))
    assert PL.merge_directions(None, bwd, q, 8) is bwd


@pytest.mark.parametrize("dirs", [(), (1, 1), (2,), (-1, 1, -1)])
def test_session_refuses_other_directions(dirs):
    _, _, pcfg, _ = tiny_models()
    with pytest.raises(ValueError, match="estimation_directions"):
        InferenceSession(with_directions(pcfg, dirs), SLICE_TASKS, "cpu")


def test_backward_pass_encodes_only_the_final_features():
    """The flipped pass asks the encoder for no hook (the dense heads ran on
    the forward pass); its final features equal those of a full encode."""
    _, _, pcfg, model = tiny_models()
    video = torch.from_numpy(request()["rgb_u8_bthw3"])
    with torch.no_grad():
        full = PL.encode_windows(model.video_encoder, pcfg, rgb_u8_bthw3=video)
        bare = PL.encode_windows(model.video_encoder, pcfg, rgb_u8_bthw3=video, hooks=())
    assert bare["hooks"] == {} and len(full["hooks"]) == 4
    assert torch.equal(bare["final"], full["final"])
