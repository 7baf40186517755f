"""The port's writers (l4p_tpu_torch.utils.vis) against the JAX package's
(l4p_tpu.utils.vis) on the same numpy arrays: the colormap tables against
matplotlib, the uint8 panel frames (the track panel included) and the mp4s
they encode, the point-cloud, camera and 3D-track PLYs, and the viewer's
assets."""

import os
import re

import cv2
import matplotlib
import numpy as np
import pytest

from l4p_tpu.utils import vis as jvis
from l4p_tpu_torch.utils import vis as pvis

TASKS = ("flow_2d_backward", "track_2d", "depth", "dyn_mask", "camray")


def rotations(rng, n):
    q = np.linalg.qr(rng.standard_normal((n, 3, 3)))[0]
    return q * np.sign(np.linalg.det(q))[:, None, None]


def scene(t=6, h=24, w=32, n=7, seed=0, estimated_k=True):
    """A collated batch and run_sequence-shaped outputs: depth partly outside
    the (0.05, 20) clip, tracks partly outside the frame, vis logits of both
    signs, rigid poses, K near a 32-pixel focal."""
    rng = np.random.default_rng(seed)
    k = np.tile(np.array([[32.0, 0, 16, 0], [0, 30, 12, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)[None, :, :, None],
                (1, 1, 1, t))
    k[:, :2, :3] += rng.uniform(-0.5, 0.5, (1, 2, 3, t)).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32)[None], (t, 1, 1))
    pose[:, :3, :3], pose[:, :3, 3] = rotations(rng, t), rng.standard_normal((t, 3))
    batch = {"rgb_b3thw": rng.standard_normal((1, 3, t, h, w)).astype(np.float32),
             "rgb_mean_b3111": np.full((1, 3, 1, 1, 1), 0.45, np.float32),
             "rgb_std_b3111": np.full((1, 3, 1, 1, 1), 0.22, np.float32),
             "intrinsics_b44t": k}
    out = {"depth_est_b1thw": rng.uniform(0.01, 25.0, (1, 1, t, h, w)).astype(np.float32),
           "flow_2d_backward_est_b2thw": rng.normal(0, 3, (1, 2, t, h, w)).astype(np.float32),
           "dyn_mask_est_b1thw": rng.normal(0, 2, (1, 1, t, h, w)).astype(np.float32),
           "traj3d_est_b16t": pose.transpose(1, 2, 0).reshape(1, 16, t).copy(),
           "track_2d_traj_est_bn2t": np.stack([rng.uniform(-2, w + 2, (1, n, t)), rng.uniform(-2, h + 2, (1, n, t))],
                                              2).astype(np.float32),
           "track_2d_vis_est_bn1t": rng.normal(0, 1, (1, n, 1, t)).astype(np.float32),
           "track_2d_depth_est_bn1t": rng.uniform(0.5, 5, (1, n, 1, t)).astype(np.float32)}
    if estimated_k:
        out["traj3d_intrinsics_est_b16t"] = (k * rng.uniform(0.9, 1.1, k.shape).astype(np.float32)).reshape(1, 16, t)
    return batch, out


@pytest.mark.parametrize("name", ["turbo", "viridis", "hsv"])
def test_colormap_tables_equal_matplotlib(name):
    """The port's tables (turbo and viridis copied, hsv from its segments)
    and its index rule against matplotlib on values at, between, below and
    above the table's entries, in float32 and float64, NaN included."""
    cmap = matplotlib.colormaps[name]
    np.testing.assert_array_equal(pvis.colormap_table(name), (cmap(np.arange(256))[:, :3] * 255).astype(np.uint8))
    rng = np.random.default_rng(1)
    x = np.concatenate([np.arange(257) / 256, np.nextafter(np.arange(1, 257) / 256, 0), rng.uniform(-0.2, 1.2, 500),
                        [np.nan, -1e-9, 1.0, 1 + 1e-9]])
    for dtype in (np.float32, np.float64):
        xs = x.astype(dtype)
        np.testing.assert_array_equal(pvis.apply_colormap(xs, name), (cmap(xs)[..., :3] * 255).astype(np.uint8))
    for v in (0.0, 0.3, 1.0):  # a Python float, as the camera PLY colours time
        np.testing.assert_array_equal(pvis.apply_colormap(v, name), (np.array(cmap(v)[:3]) * 255).astype(np.uint8))


def test_colormap_image_equals_jax_with_edge_values():
    d = np.random.default_rng(2).uniform(0.0, 25.0, (16, 20)).astype(np.float32)
    d[0, :4] = [0.05, 20.0, np.nan, np.inf]
    np.testing.assert_array_equal(pvis.colormap_image(d), jvis.colormap_image(d))


class Capture:
    """cv2.VideoWriter's stand-in: keeps the frames it is given, as RGB."""

    frames = []

    def __init__(self, *args):
        Capture.frames = []

    def write(self, frame):
        Capture.frames.append(frame[:, :, ::-1].copy())

    def release(self):
        pass


@pytest.mark.parametrize("tasks,drop", [(TASKS, ()), (("depth", "track_2d"), ("track_2d_vis_est_bn1t",)),
                                        (("flow_2d_backward", "dyn_mask"), ())])
def test_panel_frames_equal_jax_frames(monkeypatch, tasks, drop):
    """The port's panel_frames against the frames JAX's
    generate_video_visualizations hands its video writer: every task, the
    track panel without vis (every point drawn), the dense panels alone."""
    batch, out = scene()
    out = {k: v for k, v in out.items() if k not in drop}
    monkeypatch.setattr(cv2, "VideoWriter", Capture)
    jvis.generate_video_visualizations(batch, out, tasks, "unused.mp4")
    got = pvis.panel_frames(batch, out, tasks)
    assert got.dtype == np.uint8 and got.shape == (6, 24, 32 * (1 + len([t for t in tasks if t != "camray"])), 3)
    np.testing.assert_array_equal(got, np.stack(Capture.frames))


def decode(path):
    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                return np.stack(frames)
            frames.append(frame)
    finally:
        cap.release()


def test_mp4s_decode_to_equal_frames(tmp_path):
    batch, out = scene(seed=3)
    paths = [f(batch, out, TASKS, str(tmp_path / name)) for f, name in
             ((jvis.generate_video_visualizations, "jax.mp4"), (pvis.generate_video_visualizations, "port.mp4"))]
    jax_frames, port_frames = decode(paths[0]), decode(paths[1])
    assert port_frames.shape == (6, 24, 32 * 5, 3)
    np.testing.assert_array_equal(port_frames, jax_frames)


def read_ply(path):
    """(header lines, structured vertices) of a binary PLY."""
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode().splitlines()
    n = int(re.search(r"element vertex (\d+)", "\n".join(header)).group(1))
    fields = [("xyz", np.float32, 3)] + ([("rgb", np.uint8, 3)] if "property uchar red" in header else [])
    assert len(raw) - end == n * np.dtype(fields).itemsize, path
    return header, np.frombuffer(raw[end:], np.dtype(fields), count=n)


@pytest.mark.parametrize("stride,estimated_k", [(4, True), (1, False)])
def test_plys_match_jax(tmp_path, stride, estimated_k):
    """Point clouds (every stride-th frame), the camera frusta and the 3D
    track points: the same files, headers, vertex counts and colours, and
    vertices within 1e-6 of the largest coordinate. Without an estimated K
    the input's is used (the camera PLY needs the estimate)."""
    batch, out = scene(seed=4, estimated_k=estimated_k)
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    jvis.generate_4d_visualization(batch, out, str(dirs["jax"]), stride=stride)
    jvis.generate_3d_track_ply(batch, out, str(dirs["jax"]))
    pvis.generate_4d_visualization(batch, out, str(dirs["port"]), stride=stride, device="cpu")
    pvis.generate_3d_track_ply(batch, out, str(dirs["port"]), device="cpu")
    if estimated_k:
        jvis.generate_camera_trajectory_ply(out, str(dirs["jax"] / "cameras.ply"), (24, 32))
        pvis.generate_camera_trajectory_ply(out, str(dirs["port"] / "cameras.ply"), (24, 32))
    names = sorted(os.listdir(dirs["jax"]))
    assert sorted(os.listdir(dirs["port"])) == names
    assert len([n for n in names if n.startswith("pointcloud")]) == len(range(0, 6, stride))
    assert len([n for n in names if n.startswith("tracks")]) == 6
    for name in names:
        (jh, jv), (ph, pv) = read_ply(dirs["jax"] / name), read_ply(dirs["port"] / name)
        assert ph == jh, name
        np.testing.assert_array_equal(pv["rgb"], jv["rgb"], err_msg=name)
        if len(jv):
            # measured <= 1.9e-7 of the largest coordinate (the point maps' inverse and einsums in float32)
            assert np.abs(pv["xyz"] - jv["xyz"]).max() <= 1e-6 * np.abs(jv["xyz"]).max(), name
    assert sum(len(read_ply(dirs["port"] / n)[1]) for n in names if n.startswith("tracks")) > 0


def test_viewer_assets_equal_jax(tmp_path):
    """index.html and files.json beside the PLYs, from both packages'
    serve_point_clouds (each server closed unserved)."""
    batch, out = scene(seed=5)
    for name, v in (("jax", jvis), ("port", pvis)):
        d = tmp_path / name
        v.write_ply(str(d / "pointcloud_0000.ply"), np.zeros((2, 3), np.float32))
        v.write_ply(str(d / "cameras.ply"), np.ones((1, 3), np.float32), np.full((1, 3), 7, np.uint8))
        v.serve_point_clouds(str(d), port=0).server_close()
    for asset in ("index.html", "files.json", "pointcloud_0000.ply", "cameras.ply"):
        assert (tmp_path / "port" / asset).read_bytes() == (tmp_path / "jax" / asset).read_bytes(), asset
