"""The port's metrics and pose helpers against the JAX package on the same
numpy inputs (fp32, CPU), so that metric parity stands apart from model
parity: even and odd valid counts for the depth medians, sparse masks,
mask logits at the 0.85 threshold, tracks without visibility or validity,
and rotations that take each of Shepperd's four branches, their ties, near
180 degrees and below 1e-12."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from l4p_tpu_torch import metrics as PM
from l4p_tpu_torch.geometry import core as PCORE
from tests.test_torch_camray import cameras
from tests.test_torch_ops import check, rand

torch.set_num_threads(1)

T = torch.from_numpy
J = jnp.asarray


def check_metrics(out, ref, tol, what=""):
    """The same keys, each value within tol * (1 + |ref|)."""
    assert set(out) == set(ref), what
    for k in ref:
        check(out[k], ref[k], tol, f"{what} {k}")


def mask(shape, keep, seed):
    return (np.random.default_rng(seed).random(shape) < keep).astype(np.float32)


def depth_case(case):
    """(pred, gt, valid) with the count of valid values even or odd."""
    shape = (2, 1, 3, 6, 8)  # 288 values, even
    pred, gt = rand(shape, 1, 0.2, 5.0), rand(shape, 2, 0.5, 8.0)
    if case == "all_even":
        return pred, gt, None
    valid = mask(shape, 0.3, 3)
    n = int(valid.sum())
    if case == "sparse_odd" and n % 2 == 0:
        valid.flat[np.flatnonzero(valid == 0)[0]] = 1.0
    if case == "sparse_even" and n % 2 == 1:
        valid.flat[np.flatnonzero(valid == 0)[0]] = 1.0
    return pred, gt, valid


@pytest.mark.parametrize("case", ["all_even", "sparse_even", "sparse_odd", "odd_count"])
@pytest.mark.parametrize("median_align", [True, False])
def test_depth_metrics_match_jax(case, median_align):
    from l4p_tpu.metrics import depth_metrics

    if case == "odd_count":
        pred, gt, valid = rand((1, 1, 3, 5, 7), 1, 0.2, 5.0), rand((1, 1, 3, 5, 7), 2, 0.5, 8.0), None  # 105 values
    else:
        pred, gt, valid = depth_case(case)
    if valid is not None:
        assert int(valid.sum()) % 2 == (case == "sparse_odd")
    ref = depth_metrics(J(pred), J(gt), None if valid is None else J(valid), median_align)
    out = PM.depth_metrics(T(pred), T(gt), None if valid is None else T(valid), median_align)
    check_metrics(out, ref, 1e-6, case)  # measured <= 2.9e-7


def test_even_count_median_is_the_mean_of_the_middle_two():
    """torch.median returns the lower middle value; jnp.median (and the
    port's metrics.median) the mean of the two."""
    x = rand((2, 1, 3, 6, 8), 4, 0.1, 3.0)
    v = mask(x.shape, 0.5, 5) > 0
    if int(v.sum()) % 2:
        v.flat[np.flatnonzero(~v)[0]] = True
    for m in (None, v):
        ref = float(jnp.median(J(x)) if m is None else jnp.nanmedian(jnp.where(J(m), J(x), jnp.nan)))
        out = float(PM.median(T(x), None if m is None else T(m)))
        lower = float(torch.median(T(x) if m is None else T(x)[T(m)]))
        assert out == pytest.approx(ref, rel=1e-7, abs=0)
        assert lower < ref
    assert torch.isnan(PM.median(T(x), T(np.zeros(x.shape, bool))))


@pytest.mark.parametrize("valid", ["none", "per_pixel", "per_channel"])
def test_flow_metrics_match_jax(valid):
    from l4p_tpu.metrics import flow_metrics

    pred, gt = rand((2, 2, 3, 6, 8), 6, -4, 4), rand((2, 2, 3, 6, 8), 7, -4, 4)
    v = {"none": None, "per_pixel": mask((2, 1, 3, 6, 8), 0.6, 8), "per_channel": mask((2, 2, 3, 6, 8), 0.7, 9)}[valid]
    ref = flow_metrics(J(pred), J(gt), None if v is None else J(v))
    out = PM.flow_metrics(T(pred), T(gt), None if v is None else T(v))
    check_metrics(out, ref, 1e-6, valid)  # measured <= 3.6e-7


def threshold_logits() -> np.ndarray:
    """fp32 logits around log(0.85 / 0.15) whose sigmoid lands at, just
    under and just over 0.85 in fp32, and the float32 neighbours of each."""
    x0 = np.float32(np.log(0.85 / 0.15))
    xs = [x0]
    for _ in range(6):
        xs += [np.nextafter(xs[-1], np.float32(10)), np.nextafter(xs[0], np.float32(-10))]
    return np.array(sorted(set(xs)), np.float32)


@pytest.mark.parametrize("valid", [False, True])
def test_dyn_mask_metrics_match_jax_at_the_threshold(valid):
    from l4p_tpu.metrics import dyn_mask_metrics

    near = threshold_logits()
    probs = 1.0 / (1.0 + np.exp(-near))
    assert (probs == np.float32(0.85)).any() or len(set(probs > 0.85)) == 2  # both sides of the threshold
    logits = rand((2, 1, 3, 6, 8), 10, -4, 4)
    logits.flat[: near.size * 8] = np.tile(near, 8)
    gt = mask(logits.shape, 0.5, 11)
    v = mask(logits.shape, 0.5, 12) if valid else None
    ref = dyn_mask_metrics(J(logits), J(gt), None if v is None else J(v))
    out = PM.dyn_mask_metrics(T(logits), T(gt), None if v is None else T(v))
    check_metrics(out, ref, 0)
    pred = PM.dyn_mask_metrics(T(logits[:, :, :1, :1, : near.size]), T(np.ones((2, 1, 1, 1, near.size), np.float32)))
    jpred = dyn_mask_metrics(J(logits[:, :, :1, :1, : near.size]), J(np.ones((2, 1, 1, 1, near.size), np.float32)))
    check_metrics(pred, jpred, 0, "the threshold logits alone")


@pytest.mark.parametrize("vis,valid", [(True, True), (False, True), (True, False), (False, False)])
def test_track_metrics_match_jax(vis, valid):
    """Errors spread over the 1-16 pixel thresholds; visibility and
    validity present or None (every point visible, valid, predicted
    visible)."""
    from l4p_tpu.metrics import track_metrics

    gt = rand((2, 7, 2, 9), 13, 0, 100)
    pred = gt + rand((2, 7, 2, 9), 14, -12, 12)
    pvis = rand((2, 7, 1, 9), 15) if vis else None
    gvis = mask((2, 7, 1, 9), 0.7, 16) if vis else None
    val = mask((2, 7, 1, 9), 0.8, 17) if valid else None
    args = (pred, pvis, gt, gvis, val)
    ref = track_metrics(*(None if a is None else J(a) for a in args))
    out = PM.track_metrics(*(None if a is None else T(a) for a in args))
    check_metrics(out, ref, 1e-7)  # measured <= 2.4e-8: counts and masked means of the same booleans


def test_pose_metrics_match_jax():
    from l4p_tpu.metrics import pose_metrics

    _, e_pred = cameras(2, 6, seed=18)
    _, e_gt = cameras(2, 6, seed=19)
    pred, gt = e_pred.reshape(2, 16, 6), e_gt.reshape(2, 16, 6)
    # rot_deg measured 1.7e-6 (1.5e-5 of 8.75 degrees): arccos of the fp32 trace at a few degrees
    # turns an ulp of the trace into ~2e-5 degrees; trans_rmse measured 0
    check_metrics(PM.pose_metrics(T(pred), T(gt)), pose_metrics(J(pred), J(gt)), 3.5e-6)
    same = PM.pose_metrics(T(pred), T(pred))
    assert float(same["pose/trans_rmse"]) < 1e-6 and float(same["pose/rot_deg"]) < 0.05


def full_batch(t=6, h=6, w=8, n=5, seed=20):
    """A batch with every task's ground truth and the outputs of a model."""
    _, ext = cameras(1, t, seed=seed)
    _, pose_est = cameras(1, t, seed=seed + 1)
    batch = {
        "depth_b1thw": rand((1, 1, t, h, w), seed, 0.5, 8.0), "depth_valid_b1thw": mask((1, 1, t, h, w), 0.5, seed),
        "flow_2d_backward_b2thw": rand((1, 2, t, h, w), seed + 2),
        "flow_2d_backward_valid_b2thw": mask((1, 2, t, h, w), 0.8, seed + 3),
        "dyn_mask_b1thw": mask((1, 1, t, h, w), 0.5, seed + 4),
        "track_2d_traj_bn2t": rand((1, n, 2, t), seed + 5, 0, 50), "track_2d_vis_bn1t": mask((1, n, 1, t), 0.7, seed),
        "track_2d_valid_bn1t": mask((1, n, 1, t), 0.9, seed + 6), "extrinsics_b44t": ext,
    }
    out = {
        "depth_est_b1thw": rand((1, 1, t, h, w), seed + 7, 0.2, 5.0),
        "flow_2d_backward_est_b2thw": rand((1, 2, t, h, w), seed + 8),
        "dyn_mask_est_b1thw": rand((1, 1, t, h, w), seed + 9),
        "track_2d_traj_est_bn2t": batch["track_2d_traj_bn2t"] + rand((1, n, 2, t), seed + 10, -9, 9),
        "track_2d_vis_est_bn1t": rand((1, n, 1, t), seed + 11),
        "traj3d_est_b16t": np.linalg.inv(pose_est.transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1).reshape(1, 16, t),
    }
    return batch, {k: v.astype(np.float32) for k, v in out.items()}


def test_l4p_metrics_matches_jax():
    from l4p_tpu.metrics import l4p_metrics

    batch, out = full_batch()
    ref, _ = l4p_metrics({k: J(v) for k, v in batch.items()}, {k: J(v) for k, v in out.items()})
    got, extra = PM.l4p_metrics(batch, {k: T(v) for k, v in out.items()})  # numpy batch, tensor outputs
    assert extra == {} and len(got) == 12
    check_metrics(got, ref, 3.5e-6)  # measured <= 1.8e-6 (rot_deg, as above), <= 1.3e-7 the others
    # only what the batch has ground truth for
    got, _ = PM.l4p_metrics({"depth_b1thw": batch["depth_b1thw"]}, {k: T(v) for k, v in out.items()})
    assert set(got) == {"depth/absrel", "depth/rmse", "depth/delta1"}


# --- the pose helpers --------------------------------------------------------

def axis_angle(axis, angle) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    k = axis / np.linalg.norm(axis)
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * kx @ kx).astype(np.float32)


def branch_rotations() -> np.ndarray:
    """Rotations for each Shepperd branch (w: small angles; x, y, z: near
    180 degrees about that axis), ties (90 degrees about x ties w and x; the
    identity-free diag(1, -1, -1) family), 180 degrees exactly, and the
    identity."""
    rng = np.random.default_rng(21)
    rs = [np.eye(3, dtype=np.float32), np.diag([1, -1, -1]).astype(np.float32),
          np.diag([-1, 1, -1]).astype(np.float32), np.diag([-1, -1, 1]).astype(np.float32)]
    for ax in np.eye(3):
        rs += [axis_angle(ax, np.pi / 2), axis_angle(ax, np.pi - 1e-3), axis_angle(ax + 0.05 * rng.standard_normal(3),
                                                                                   np.pi - 1e-4)]
    for _ in range(12):
        rs.append(axis_angle(rng.standard_normal(3), rng.uniform(0, np.pi)))
    rs += [axis_angle(rng.standard_normal(3), a) for a in (1e-3, 1e-6, 1e-13)]
    return np.stack(rs)


def test_rotmat_to_quat_and_rotvec_match_jax_on_every_branch():
    from l4p_tpu.geometry import core as C

    rs = branch_rotations()
    m = rs.astype(np.float64)
    cand = np.stack([1 + m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2], 1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                     1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2], 1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]], -1)
    assert set(np.argmax(cand, -1)) == {0, 1, 2, 3}  # every branch taken
    q = PCORE.rotmat_to_quat(T(rs))
    v = PCORE.rotmat_to_rotvec(T(rs))
    for i, r in enumerate(rs):
        check(q[i], C.rotmat_to_quat(J(r)), 2e-7, f"quat {i}")  # measured 0
        check(v[i], C.rotmat_to_rotvec(J(r)), 2e-7, f"rotvec {i}")  # measured 0
    assert bool((q[:, 0] >= 0).all())


def test_rotvec_to_rotmat_matches_jax_with_tiny_angles():
    from l4p_tpu.geometry import core as C

    rng = np.random.default_rng(22)
    vs = np.concatenate([rng.standard_normal((8, 3)), np.zeros((1, 3)), 1e-13 * rng.standard_normal((2, 3)),
                         (np.pi - 1e-4) * np.eye(3)]).astype(np.float32)
    r = PCORE.rotvec_to_rotmat(T(vs))
    for i, v in enumerate(vs):
        check(r[i], C.rotvec_to_rotmat(J(v)), 3e-7, f"rotvec {i}")  # measured <= 1.4e-7


def test_relative_poses_and_cam_t_ref_match_jax():
    from l4p_tpu.geometry import core as C

    _, e = cameras(2, 5, seed=23)
    check(PCORE.pose_to_rel_pose_b6t(T(e)), C.pose_to_rel_pose_b6t(J(e)), 2e-7, "rel_pose_b6t")  # measured <= 9e-8
    for ref_idx in (0, 3):
        check(PCORE.get_cam_T_ref(T(e), ref_idx), C.get_cam_T_ref(J(e), ref_idx), 2e-7, f"cam_T_ref {ref_idx}")
