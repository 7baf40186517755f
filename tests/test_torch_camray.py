"""The port's camray geometry and joint Sim(3) stitch vs the JAX package
(fp32, CPU), each fed the same RANSAC draws: the JAX functions draw from a
key, and `JaxDraws` hands the port exactly what they draw. Inputs are made
with numpy from a seed; synthetic cameras as in tests/test_geometry.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l4p_tpu_torch.geometry import alignment as PA
from l4p_tpu_torch.geometry import cameras as PCAM
from l4p_tpu_torch.geometry import core as PCORE
from l4p_tpu_torch.models import l4p as PL
from tests.test_torch_ops import check, port_config

torch.set_num_threads(1)

T = torch.from_numpy
J = jnp.asarray


class JaxDraws:
    """The port's `Draws` with the JAX package's numbers: the key derivation
    of camray_windows_to_cameras (split over batch items, or over windows
    and then items x frames; l4p_tpu/models/l4p.py:332, :351, cameras.py:267,
    :317) and of stitch_joint_depth_camray / sim3_overlap_solve (fold_in of
    the window step, keys_a / keys_b; l4p.py:447, alignment.py:207-208)."""

    def __init__(self, camray_key=None, sim3_key=None):
        self.camray_key, self.sim3_key = camray_key, sim3_key

    @classmethod
    def for_session(cls, key=None):
        """What l4p_tpu.inference.InferenceSession draws from `key` (PRNGKey(0))."""
        key = jax.random.PRNGKey(0) if key is None else key
        return cls(jax.random.fold_in(key, 7), jax.random.fold_in(key, 11))

    def homography_samples(self, window, num_windows, count, n, num_trials):
        from l4p_tpu.geometry.core import ransac_sample_indices

        key = self.camray_key if window is None else jax.random.split(self.camray_key, num_windows)[window]
        rows = [np.asarray(ransac_sample_indices(k, n, num_trials, 4)) for k in jax.random.split(key, count)]
        return torch.from_numpy(np.stack(rows).astype(np.int64))

    def sim3_draws(self, step, count, stride, n, num_trials, min_samples):
        return overlap_draws(jax.random.fold_in(self.sim3_key, step), count, stride, n, num_trials, min_samples)


def overlap_draws(key, count, stride, n, num_trials, min_samples):
    """What l4p_tpu's sim3_overlap_solve(..., key) draws: a phase from
    split(key, B), minimal samples from split(fold_in(key, 1), B)."""
    from l4p_tpu.geometry.core import ransac_sample_indices

    phase = [int(jax.random.randint(k, (), 0, stride)) for k in jax.random.split(key, count)]
    rows = [np.asarray(ransac_sample_indices(k, n, num_trials, min_samples))
            for k in jax.random.split(jax.random.fold_in(key, 1), count)]
    return torch.tensor(phase, dtype=torch.int64), torch.from_numpy(np.stack(rows).astype(np.int64))


def rotations(rng, n, mild=0.1):
    """Rotation matrices near the identity (forward-facing rays)."""
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    r = (1 - mild) * np.eye(3) + mild * q * np.sign(np.linalg.det(q))[:, None, None]
    u, _, vt = np.linalg.svd(r)
    return (u @ vt).astype(np.float32)


def cameras(b, t, seed=0):
    """Normalised intrinsics and cam_T_world extrinsics, each (B, 4, 4, T)."""
    rng = np.random.default_rng(seed)
    k = np.zeros((b, 4, 4, t), np.float32)
    k[:, 0, 0] = rng.uniform(0.8, 1.5, (b, 1))
    k[:, 1, 1] = rng.uniform(0.8, 1.5, (b, 1))
    k[:, 0, 2] = k[:, 1, 2] = 0.5
    k[:, 2, 2] = k[:, 3, 3] = 1.0
    e = np.zeros((b, t, 4, 4), np.float32)
    e[:, :, :3, :3] = rotations(rng, b * t).reshape(b, t, 3, 3)
    e[:, :, :3, 3] = rng.uniform(-0.5, 0.5, (b, t, 3))
    e[:, :, 3, 3] = 1.0
    return k, e.transpose(0, 2, 3, 1)


def noisy_rays(b, t, h, w, seed=0, noise=1e-3):
    """Plucker rays (B, 6, T, h, w) of a synthetic trajectory, with noise so
    that RANSAC has inliers and outliers to tell apart."""
    from l4p_tpu.geometry.core import get_rays_plucker

    k, e = cameras(b, t, seed)
    rays = np.asarray(get_rays_plucker(J(k), J(e), (h, w))[0])
    rng = np.random.default_rng(seed + 1)
    rays = rays + noise * rng.standard_normal(rays.shape).astype(np.float32)
    return rays.astype(np.float32), k


def homography_points(n=128, seed=0):
    rng = np.random.default_rng(seed)
    h_true = np.array([[1.2, 0.1, 0.05], [-0.08, 0.9, -0.1], [0.02, -0.01, 1.0]], np.float32)
    src = rng.uniform(-1, 1, (2, n, 2)).astype(np.float32)
    p = np.concatenate([src, np.ones((2, n, 1), np.float32)], -1) @ h_true.T
    dst = p[..., :2] / p[..., 2:3]
    out = rng.uniform(size=(2, n)) < 0.25
    dst[out] += rng.uniform(0.5, 2, (out.sum(), 2)).astype(np.float32)
    return src, dst.astype(np.float32)


# --- core --------------------------------------------------------------------

def test_ransac_sample_indices_rows_are_distinct():
    g = torch.Generator().manual_seed(0)
    idx = PCORE.ransac_sample_indices(g, 10, 7, 4)  # 2 samples per permutation, 4 permutations
    assert idx.shape == (7, 4) and idx.dtype == torch.int64
    assert all(len(set(row.tolist())) == 4 for row in idx)
    assert int(idx.min()) >= 0 and int(idx.max()) < 10
    with pytest.raises(ValueError):
        PCORE.ransac_sample_indices(g, 3, 5, 4)


def test_intrinsics_grid_and_plucker_match_jax():
    from l4p_tpu.geometry import core as C

    k, _ = cameras(2, 3)
    k_px = k * np.array([224, 224, 1, 1], np.float32)[None, :, None, None]
    check(PCORE.normalize_intrinsics(T(k_px), 224, 112), C.normalize_intrinsics(J(k_px), 224, 112), 0)
    check(PCORE.denormalize_intrinsics(T(k), 224, 112), C.denormalize_intrinsics(J(k), 224, 112), 0)
    np.testing.assert_array_equal(PCORE._pixel_grid(5, 7).numpy(), np.asarray(C._pixel_grid(5, 7)))
    rays, _ = noisy_rays(2, 3, 4, 5)
    for p, r in zip(PCORE.plucker_to_point_direction(T(rays)), C.plucker_to_point_direction(J(rays))):
        check(p, r, 5e-8)  # measured <= 2.5e-8


# --- cameras -----------------------------------------------------------------

def test_skew_lines_kabsch_and_rq_match_jax():
    from l4p_tpu.geometry import cameras as C

    rng = np.random.default_rng(0)
    pts, dirs = rng.standard_normal((2, 6, 50, 3)).astype(np.float32)
    p, d = PCAM.intersect_skew_lines_high_dim(T(pts), T(dirs))
    rp, rd = C.intersect_skew_lines_high_dim(J(pts), J(dirs))
    check(p, rp, 2.5e-7, "skew lines")  # measured 1.2e-7
    check(d, rd, 0, "directions")
    a, b = rng.standard_normal((2, 3, 4, 40, 3)).astype(np.float32)
    check(PCAM.kabsch_rotation(T(a), T(b)), C._kabsch_bt(J(a), J(b)), 1.1e-6, "kabsch")  # measured 5.5e-7
    m = rng.standard_normal((5, 3, 3)).astype(np.float32)
    kp, qp = PCAM.rq_decomposition_3x3(T(m))
    kr, qr = jax.vmap(C.rq_decomposition_3x3)(J(m))
    check(kp, kr, 7e-7, "rq R")  # measured 3.2e-7
    check(qp, qr, 3e-7, "rq Q")  # measured 1.4e-7


def test_homography_dlt_and_ransac_match_jax():
    from l4p_tpu.geometry import cameras as C
    from l4p_tpu.geometry.core import ransac_sample_indices

    src, dst = homography_points()
    w = np.random.default_rng(1).uniform(0, 1, (2, 128)).astype(np.float32)
    check(PCAM.homography_dlt(T(src), T(dst), T(w)), jax.vmap(C.homography_dlt)(J(src), J(dst), J(w)), 3e-6,
          "dlt")  # measured 1.5e-6
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    idx = np.stack([np.asarray(ransac_sample_indices(k, 128, 128, 4)) for k in keys]).astype(np.int64)
    valid = np.ones((2, 128), bool)
    valid[:, :10] = False
    ref = jax.vmap(lambda s, d, k, v: C.find_homography_ransac(s, d, k, 0.05, valid=v))(
        J(src), J(dst), keys, J(valid))
    check(PCAM.find_homography_ransac(T(src), T(dst), T(idx), 0.05, valid=T(valid)), ref, 1.1e-6, "ransac")  # measured 5.3e-7


def test_compute_optimal_rotation_intrinsics_matches_jax():
    from l4p_tpu.geometry import cameras as C
    from l4p_tpu.geometry.core import ransac_sample_indices

    rays, _ = noisy_rays(2, 1, 8, 8)
    dirs = rays[:, :3, 0].transpose(0, 2, 3, 1).reshape(2, 64, 3)
    pix = np.stack([*np.meshgrid(np.arange(8), np.arange(8), indexing="xy"), np.ones((8, 8))], -1).reshape(64, 3)
    ident = (pix / np.linalg.norm(pix, axis=-1, keepdims=True)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    idx = np.stack([np.asarray(ransac_sample_indices(k, 64, 128, 4)) for k in keys]).astype(np.int64)
    ref = jax.vmap(lambda d, k: C.compute_optimal_rotation_intrinsics(J(ident), d, k))(J(dirs), keys)
    out = PCAM.compute_optimal_rotation_intrinsics(T(ident).expand(2, -1, -1), T(dirs), T(idx))
    for name, p, r in zip(("R", "K", "H"), out, ref):
        check(p, r, 2e-5, name)  # measured <= 3.1e-6


def test_degenerate_rays_give_the_identity():
    """Too few rays with a usable z: R, K and H fall back to the identity
    (l4p_tpu/geometry/cameras.py:197-204)."""
    rays = np.zeros((1, 16, 3), np.float32)
    rays[..., 0] = 1.0  # z = 0 everywhere
    idx = PCORE.ransac_sample_indices(torch.Generator().manual_seed(0), 16, 8, 4)[None]
    for m in PCAM.compute_optimal_rotation_intrinsics(T(rays), T(rays), idx):
        assert torch.equal(m[0], torch.eye(3))


HEAD = dict(task_name="traj3d", kind="camray", out_nchan=6)


def camray_head(mode):
    from l4p_tpu.models.dpt import DPTConfig
    from l4p_tpu.models.l4p import DenseHeadConfig

    flags = {"use_intrinsics": (True, False), "fixed": (False, True), "variable": (False, False)}[mode]
    jh = DenseHeadConfig(**HEAD, dpt=DPTConfig(num_channels=6), use_intrinsics=flags[0], fixed_intrinsics=flags[1])
    return jh, port_config(dataclasses.replace(default_jax_cfg(), heads=(("camray", jh),))).head_dict["camray"]


def default_jax_cfg():
    from tests.test_l4p_forward import tiny_cfg

    return tiny_cfg()


@pytest.mark.parametrize("mode", ["use_intrinsics", "fixed", "variable"])
def test_camray_windows_to_cameras_matches_jax(mode):
    """Three windows of 4 frames at stride 2 on an 8 x 8 ray grid of a
    32 x 48 image, with the input intrinsics in image pixels."""
    from l4p_tpu.geometry.core import denormalize_intrinsics
    from l4p_tpu.models.l4p import camray_windows_to_cameras

    jh, ph = camray_head(mode)
    nw, b, ws, stride, img = 3, 2, 4, 2, (4, 32, 48)
    rays = np.stack([noisy_rays(b, ws, 8, 8, seed=w)[0] for w in range(nw)])
    k, _ = cameras(b, 8, seed=9)
    intr = np.asarray(denormalize_intrinsics(J(k), img[1], img[2]))
    key = jax.random.PRNGKey(2)
    ref = camray_windows_to_cameras(J(rays), jh, img, J(intr), stride, key)
    out = PL.camray_windows_to_cameras(T(rays), ph, img, T(intr), stride, JaxDraws(camray_key=key))
    # measured <= 1.6e-6 (pose) and 1.8e-5 (K, in pixels, variable mode) over the three modes
    check(out[0], ref[0], 3.2e-6, "pose")
    check(out[1], ref[1], 3.6e-5, "intrinsics")


# --- Sim(3) ------------------------------------------------------------------

def sim3_points(n=300, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((2, n, 3)).astype(np.float32)
    r = rotations(rng, 2, mild=1.0)
    dst = 0.7 * np.einsum("bij,bnj->bni", r, src) + np.array([1.0, 0.5, -0.3], np.float32)
    out = rng.uniform(size=(2, n)) < 0.3
    dst[out] += rng.uniform(0.5, 2, (out.sum(), 3))
    return src, dst.astype(np.float32)


def test_umeyama_and_sim3_ransac_match_jax():
    from l4p_tpu.geometry import alignment as A
    from l4p_tpu.geometry.core import ransac_sample_indices

    src, dst = sim3_points()
    w = np.random.default_rng(1).uniform(0, 1, (2, 300)).astype(np.float32)
    for p, r in zip(PA.umeyama_sim3(T(src), T(dst), T(w)), jax.vmap(A.umeyama_sim3)(J(src), J(dst), J(w))):
        check(p, r, 5e-7, "umeyama")  # measured 2.5e-7
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    idx = np.stack([np.asarray(ransac_sample_indices(k, 300, 64, 10)) for k in keys]).astype(np.int64)
    thr = np.array([0.05, 0.1], np.float32)
    ref = jax.vmap(lambda s, d, k, t: A.sim3_ransac(s, d, k, t, 10, 64))(J(src), J(dst), keys, J(thr))
    out = PA.sim3_ransac(T(src), T(dst), T(idx), T(thr))
    check(out[0], ref[0], 3e-7, "T")  # measured 1.5e-7
    check(out[1], ref[1], 1e-7, "s")  # measured 3.5e-8
    assert torch.equal(out[2], T(np.asarray(ref[2])))


def test_ransac_trace_keeps_each_solve_counts_and_choice():
    """With RANSAC_TRACE set, the homography and the Sim(3) RANSAC each
    append (inlier counts per hypothesis, chosen hypothesis); the choice is
    the first of the largest counts, and the trace changes no result."""
    src, dst = homography_points()
    idx = torch.stack([PCORE.ransac_sample_indices(torch.Generator().manual_seed(i), 128, 16, 4) for i in (0, 1)])
    s3, d3 = sim3_points()
    idx3 = torch.stack([PCORE.ransac_sample_indices(torch.Generator().manual_seed(i), 300, 8, 10) for i in (2, 3)])
    thr = torch.tensor([0.05, 0.1])
    plain = (PCAM.find_homography_ransac(T(src), T(dst), idx, 0.05), PA.sim3_ransac(T(s3), T(d3), idx3, thr))
    PCORE.RANSAC_TRACE = []
    try:
        traced = (PCAM.find_homography_ransac(T(src), T(dst), idx, 0.05), PA.sim3_ransac(T(s3), T(d3), idx3, thr))
        trace = PCORE.RANSAC_TRACE
    finally:
        PCORE.RANSAC_TRACE = None
    assert torch.equal(traced[0], plain[0]) and all(torch.equal(a, b) for a, b in zip(traced[1], plain[1]))
    assert [tuple(c.shape) for c, _ in trace] == [(2, 16), (2, 8)]
    for counts, best in trace:
        assert torch.equal(best, torch.argmax(counts, dim=-1))
        assert (counts.gather(1, best[:, None])[:, 0] == counts.max(-1).values).all()
    assert int(trace[0][0].max()) <= 128 and int(trace[1][0].max()) <= 300  # counts of points


def dlt_float64(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The Hartley-normalised DLT of one sample in float64 numpy, the null
    vector from an SVD of A (not of A^T A)."""
    def norm(p):
        m = p.mean(0)
        s = np.sqrt(2.0) / np.linalg.norm(p - m, axis=1).mean()
        return (p - m) * s, np.array([[s, 0, -m[0] * s], [0, s, -m[1] * s], [0, 0, 1]])

    (s_n, t_s), (d_n, t_d) = norm(src), norm(dst)
    rows = []
    for (x, y), (u, v) in zip(s_n, d_n):
        rows += [[-x, -y, -1, 0, 0, 0, u * x, u * y, u], [0, 0, 0, -x, -y, -1, v * x, v * y, v]]
    h = np.linalg.inv(t_d) @ np.linalg.svd(np.array(rows))[2][-1].reshape(3, 3) @ t_s
    return h / h[2, 2]


def test_homography_dlt_solves_in_float64():
    """fp32 4-point samples, ill-conditioned ones among them: H in fp32
    equal to a float64 DLT to fp32 rounding. Solving A^T A in fp32 is off by
    up to ~1e-3 of H on such samples, which moves transfer errors across
    the inlier threshold differently on two devices."""
    rng = np.random.default_rng(5)
    src = rng.uniform(0, 16, (64, 4, 2)).astype(np.float32)
    dst = (src + rng.normal(0, 0.5, src.shape)).astype(np.float32)
    h = PCAM.homography_dlt(torch.from_numpy(src), torch.from_numpy(dst))
    assert h.dtype == torch.float32
    ref = np.stack([dlt_float64(s.astype(np.float64), d.astype(np.float64)) for s, d in zip(src, dst)])
    err = np.abs(h.numpy() - ref).max(axis=(1, 2)) / np.abs(ref).max(axis=(1, 2))
    assert err.max() <= 1e-6, err.max()


def test_umeyama_degenerate_points_give_the_identity():
    tf, s = PA.umeyama_sim3(torch.ones((1, 5, 3)), torch.randn((1, 5, 3)))
    assert torch.equal(tf[0], torch.eye(4)) and float(s[0]) == 1.0


def overlap_scene(b=1, t=4, h=12, w=16, seed=0):
    """pred/target overlap dicts whose world points differ by a Sim(3)."""
    from l4p_tpu.geometry.core import denormalize_intrinsics

    rng = np.random.default_rng(seed)
    k, e = cameras(b, t, seed)
    k_px = np.asarray(denormalize_intrinsics(J(k), h, w))
    depth_t = rng.uniform(1, 5, (b, 1, t, h, w)).astype(np.float32)
    pose_t = np.linalg.inv(e.transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1).astype(np.float32)
    g = np.eye(4, dtype=np.float32)
    g[:3, :3] = 1.5 * rotations(rng, 1)[0]
    g[:3, 3] = [0.2, -0.1, 0.4]
    pose_p = np.einsum("ij,bjkt->bikt", np.linalg.inv(g), pose_t)
    pose_p[:, :3, :3] *= 1.5
    depth_p = depth_t / 1.5
    noise = lambda x: (x * (1 + 0.01 * rng.standard_normal(x.shape))).astype(np.float32)  # noqa: E731
    pred = {"depth": noise(depth_p), "camray": pose_p.reshape(b, 16, t).astype(np.float32), "camray_intrinsics": k_px}
    tgt = {"depth": depth_t, "camray": pose_t.reshape(b, 16, t), "camray_intrinsics": k_px}
    return pred, tgt


def test_sim3_overlap_solve_and_apply_match_jax():
    from l4p_tpu.geometry import alignment as A

    pred, tgt = overlap_scene()
    key = jax.random.PRNGKey(6)
    ref = A.sim3_overlap_solve({k: J(v) for k, v in pred.items()}, {k: J(v) for k, v in tgt.items()}, key,
                               min_samples=10, num_trials=32)
    n_keep, stride = PA.sim3_sample_counts(4, 12, 16)
    phase, idx = overlap_draws(key, 1, stride, n_keep, 32, 10)
    out = PA.sim3_overlap_solve({k: T(v) for k, v in pred.items()}, {k: T(v) for k, v in tgt.items()}, phase, idx)
    check(out["T"], ref["T"], 5e-7, "T")  # measured 2.4e-7
    check(out["s"], ref["s"], 1e-7, "s")  # measured 4.8e-8
    np.testing.assert_allclose(float(out["s"][0]), 1.5, rtol=2e-2)  # the scene's scale
    applied = PA.sim3_overlap_apply(out, {k: T(v) for k, v in pred.items()})
    ref_applied = A.sim3_overlap_apply(ref, {k: J(v) for k, v in pred.items()})
    for k in pred:
        check(applied[k], ref_applied[k], 6e-7, k)  # measured <= 3.0e-7


def window_scenes(nw, b, ws, stride, h, w, seed=0):
    """Per-window depth (nw, B, 1, ws, H, W), pose and K (nw, B, 16, ws) of
    one trajectory, each window seen through its own Sim(3) (as
    `overlap_scene` builds one pair) with 1% depth noise, so that
    consecutive windows agree on their overlap up to a Sim(3)."""
    from l4p_tpu.geometry.core import denormalize_intrinsics

    rng = np.random.default_rng(seed)
    t_total = (nw - 1) * stride + ws
    k, e = cameras(b, t_total, seed)
    k_px = np.asarray(denormalize_intrinsics(J(k), h, w))
    depth = rng.uniform(1, 5, (b, 1, t_total, h, w)).astype(np.float32)
    pose = np.linalg.inv(e.transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1)
    depths, poses, intrs = [], [], []
    for i in range(nw):
        lo, s = i * stride, rng.uniform(0.7, 1.5)
        g = np.eye(4)
        g[:3, :3] = s * rotations(rng, 1)[0]
        g[:3, 3] = rng.uniform(-0.3, 0.3, 3)
        p = np.einsum("ij,bjkt->bikt", np.linalg.inv(g), pose[..., lo: lo + ws])
        p[:, :3, :3] *= s
        depths.append(depth[:, :, lo: lo + ws] / s * (1 + 0.01 * rng.standard_normal((b, 1, ws, h, w))))
        poses.append(p.reshape(b, 16, ws))
        intrs.append(k_px[..., lo: lo + ws].reshape(b, 16, ws))
    return tuple(np.stack(x).astype(np.float32) for x in (depths, poses, intrs))


@pytest.mark.parametrize("joint", [True, False])
def test_stitch_dense_outputs_with_camray_matches_jax(joint):
    """Three windows of 4 frames at stride 2 (T = 8) of one trajectory: the
    joint Sim(3) chain on depth + camray, or the disparity chain and the pose
    overwrite."""
    from l4p_tpu.models.l4p import stitch_dense_outputs

    jcfg = dataclasses.replace(default_jax_cfg(), joint_alignment=joint)
    pcfg = port_config(jcfg)
    rng = np.random.default_rng(7)
    nw, b, ws, h, w, stride = 3, 1, 4, 12, 16, 2
    depth_w, pose_w, intr_w = window_scenes(nw, b, ws, stride, h, w)
    dense = {"depth": depth_w, "flow_2d_backward": rng.standard_normal((nw, b, 2, ws, h, w)).astype(np.float32)}
    tasks = ("flow_2d_backward", "depth", "camray")
    key = jax.random.PRNGKey(8)
    ref = stitch_dense_outputs(jcfg, tasks, {k: J(v) for k, v in dense.items()}, J(pose_w), J(intr_w), stride, 8,
                               key)
    out = PL.stitch_dense_outputs(pcfg, tasks, {k: T(v) for k, v in dense.items()}, stride, 8, T(pose_w),
                                  T(intr_w), JaxDraws.for_session(key))
    assert set(out) == set(ref) == {"flow_2d_backward_est_b2thw", "depth_est_b1thw", "traj3d_est_b16t",
                                    "traj3d_intrinsics_est_b16t"}
    for k in ref:
        # measured <= 6.2e-7 on depth, 2.7e-6 on the poses (translations of order 1)
        check(out[k], ref[k], 5.5e-6 if k.startswith("traj3d") else 1.3e-6, k)
    if joint:  # window 1, aligned, agrees with window 0 on their overlap (frames 2, 3) up to the 1% noise
        ratio = out["depth_est_b1thw"][0, 0, 2:4] / T(depth_w[0, 0, 0, 2:4])
        assert abs(float(ratio.median()) - 1) < 0.02
