"""The port's forward_single_window against l4p_tpu's
l4p_forward_single_window (fp32, CPU): one window, no stitching, on every
task, with the weights carried across by params_from_jax and the JAX
function's own RANSAC draws (its camray solve draws from `key` itself)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l4p_tpu_torch import SLICE_TASKS, forward_single_window
from tests.test_torch_camray import JaxDraws
from tests.test_torch_encoder import tiny_models
from tests.test_torch_ops import check, rand

torch.set_num_threads(1)

TOL = {"traj3d_est_b16t": 2.1e-5, "traj3d_intrinsics_est_b16t": 5.4e-5}  # PERF.md §2's bands


def window_request(t, hw, n=5, seed=0):
    """One window of normalised float frames, pixel intrinsics (focal =
    width, centre at half of it) and n queries over the window."""
    rng = np.random.default_rng(seed)
    k = np.tile(np.diag([float(hw), float(hw), 1, 1]).astype(np.float32)[None, :, :, None], (1, 1, 1, t))
    k[:, 0, 2] = k[:, 1, 2] = hw / 2
    q = np.stack([rng.uniform(0, t, n), rng.uniform(0, hw, n), rng.uniform(0, hw, n)], -1).astype(np.float32)
    return {"rgb_b3thw": rand((1, 3, t, hw, hw), seed + 1), "intrinsics_b44t": k,
            "track_2d_pointquerries_bn3": q[None], "track_2d_pointlabels_bn": np.ones((1, n), np.float32)}


def jax_single_window(jparams, jcfg, data, tasks, key=None):
    from l4p_tpu.models.l4p import l4p_forward_single_window

    fn = jax.jit(lambda p, d, k: l4p_forward_single_window(p, jcfg, d, tasks, k))
    return fn(jparams, {k: jnp.asarray(v) for k, v in data.items()}, jax.random.PRNGKey(0) if key is None else key)


def test_single_window_matches_jax_on_the_slice_tasks():
    """The dense heads' raw window outputs and one window of tracks (the
    prompt-feature and memory outputs dropped) at the tiny config."""
    jcfg, jparams, pcfg, model = tiny_models()
    data = window_request(4, 28)
    ref = jax_single_window(jparams, jcfg, data, SLICE_TASKS)
    out = forward_single_window(model, pcfg, data, SLICE_TASKS, "cpu")
    assert set(out) == set(ref) == {"flow_2d_backward_est_b2thw", "depth_est_b1thw", "dyn_mask_est_b1thw",
                                    "track_2d_traj_est_bn2t", "track_2d_vis_est_bn1t", "track_2d_depth_est_bn1t"}
    for k in ref:
        check(out[k], ref[k], 1.5e-6, k)  # measured <= 2.6e-7


@pytest.mark.parametrize("mode", ["fixed", "input"])
def test_single_window_matches_jax_on_all_tasks(mode):
    """The five tasks on the five-task config of test_torch_slice (E = 128,
    one 8-frame window of 112 x 112, camray rays 8 x 8; the tiny config's
    2 x 2 ray map gives the homography RANSAC four points, on which every
    hypothesis ties), with K estimated once (the released head) or taken
    from the input. The per-frame mode's eight homography RANSACs on these
    random-weight rays pick other hypotheses than JAX's on near-ties; the
    next test holds all three modes on synthetic rays."""
    from tests.test_torch_ops import port_config
    from tests.test_torch_slice import fused_models

    jcfg, jparams, _, model = fused_models()
    use = mode == "input"
    heads = tuple((n, dataclasses.replace(h, use_intrinsics=use, fixed_intrinsics=not use) if n == "camray" else h)
                  for n, h in jcfg.heads)
    jcfg = dataclasses.replace(jcfg, heads=heads)
    pcfg = port_config(jcfg)
    tasks = ("flow_2d_backward", "track_2d", "depth", "dyn_mask", "camray")
    data = window_request(8, 112, seed=3)
    ref = jax_single_window(jparams, jcfg, data, tasks)
    out = forward_single_window(model, pcfg, data, tasks, "cpu", draws=JaxDraws(camray_key=jax.random.PRNGKey(0)))
    want = {"traj3d_est_b16t"} | ({"traj3d_intrinsics_est_b16t"} if not use else set())
    assert set(out) == set(ref) and want <= set(ref)
    # this window's K estimate reads 9.1e-5 off JAX (the session's request of
    # test_torch_slice: 2.7e-5, where PERF.md §2's 5.4e-5 comes from): the
    # homography solve on random-weight rays amplifies their 1e-7 difference
    tol = {**TOL, "traj3d_intrinsics_est_b16t": 1.8e-4}
    for k in ref:
        # measured <= 2.7e-7 on the dense and track outputs; poses 1.7e-5 (6.9e-6 from the input K)
        check(out[k], ref[k], tol.get(k, 1.5e-6), k)


@pytest.mark.parametrize("mode", ["fixed", "variable", "use_intrinsics"])
def test_single_window_cameras_match_jax_on_synthetic_rays(mode):
    """The single window's camera solve (window_cameras at window 0 of 1,
    as forward_single_window calls it) against the JAX single window's
    (camray_windows_to_cameras of one window, drawing from `key`), on the
    noisy rays of a synthetic trajectory (test_torch_camray)."""
    from l4p_tpu.geometry.core import denormalize_intrinsics
    from l4p_tpu.models.l4p import camray_windows_to_cameras
    from l4p_tpu_torch.models import l4p as PL
    from tests.test_torch_camray import cameras, camray_head, noisy_rays

    jh, ph = camray_head(mode)
    img = (4, 32, 48)
    rays, _ = noisy_rays(2, 4, 8, 8, seed=5)
    k, _ = cameras(2, 4, seed=6)
    intr = np.asarray(denormalize_intrinsics(jnp.asarray(k), img[1], img[2]))
    key = jax.random.PRNGKey(0)
    ref = camray_windows_to_cameras(jnp.asarray(rays)[None], jh, img, jnp.asarray(intr), 2, key)
    pose, k_out, _ = PL.window_cameras(torch.from_numpy(rays), ph, img, torch.from_numpy(intr), 0, 1, None,
                                       JaxDraws(camray_key=key))
    # the bands of test_torch_camray's three-window comparison; measured <= 1.1e-6 and 1.0e-5
    check(pose, ref[0][0], 3.2e-6, "pose")
    check(k_out, ref[1][0], 3.6e-5, "intrinsics")


def test_single_window_camera_rays_head_matches_jax():
    """A VideoMAECameraDPTHead (kind camera_rays) gives its raw rays, at
    camray's DPT output size (2 x 2 at the tiny config), no solve."""
    from tests.test_torch_factory import camera_rays_models

    jcfg, jparams, pcfg, model = camera_rays_models()
    data = window_request(4, 28)
    ref = jax_single_window(jparams, jcfg, data, ("rays", "depth"))
    out = forward_single_window(model, pcfg, data, ("rays", "depth"), "cpu")
    assert set(out) == set(ref) == {"rays_est_b6thw", "depth_est_b1thw"}
    assert out["rays_est_b6thw"].shape == (1, 6, 4, 2, 2)
    for k in ref:
        check(out[k], ref[k], 1.5e-6, k)  # measured <= 3.4e-8
