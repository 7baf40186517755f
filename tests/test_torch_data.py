"""The port's data pipeline (l4p_tpu_torch.data) against the JAX package's
(l4p_tpu.data): L4PDataset samples from one seed (mirror-pad, single-frame
repeat, resize, random and centre crops, query sampling, the causal valid
fix, uint8 emission), the DAVIS, Dycheck and video loaders on files this
test writes, collate and prefetch_dataset; and the loaders and the cv2
writers raising, naming the package, where PIL or cv2 is missing."""

import importlib
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from l4p_tpu.data import dataset as JD
from l4p_tpu.data import prefetch as JP
from l4p_tpu.data import sources as JS
from l4p_tpu_torch.data import dataset as PD
from l4p_tpu_torch.data import prefetch as PP
from l4p_tpu_torch.data import sources as PS


def raw_sample(t, h, w, seed, tracks=0):
    """Every key the pipeline moves: video, depth, masks, flows both ways,
    intrinsics, extrinsics, relative poses and, with `tracks`, ground-truth
    tracks."""
    rng = np.random.default_rng(seed)

    def video(c, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, (c, t, h, w)).astype(np.float32)

    k = np.tile(np.array([[w, 0, w / 2, 0], [0, h, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)[:, :, None],
                (1, 1, t))
    d = dict(rgb_b3thw=video(3), intrinsics_b44t=k, extrinsics_b44t=np.tile(np.eye(4, dtype=np.float32)[..., None],
                                                                         (1, 1, t)),
             rel_pose_b6t=rng.standard_normal((6, t)).astype(np.float32), depth_b1thw=video(1, 0.5, 5.0),
             depth_valid_b1thw=(video(1) > 0.2).astype(np.float32),
             instanceseg_b1thw=(video(1) > 0.4).astype(np.float32),
             dyn_mask_b1thw=(video(1) > 0.5).astype(np.float32), dyn_mask_valid_b1thw=np.ones((1, t, h, w), np.float32),
             flow_2d_backward_b2thw=video(2, -3, 3), flow_2d_backward_valid_b2thw=(video(2) > 0.1).astype(np.float32),
             flow_2d_forward_b2thw=video(2, -3, 3), flow_2d_forward_valid_b2thw=(video(2) > 0.1).astype(np.float32))
    if tracks:
        d.update(track_2d_traj_bn2t=np.stack([rng.uniform(0, w, (tracks, t)), rng.uniform(0, h, (tracks, t))],
                                             1).astype(np.float32),
                 track_2d_vis_bn1t=rng.random((tracks, 1, t)) > 0.3,
                 track_2d_depth_bn1t=rng.uniform(1, 4, (tracks, 1, t)).astype(np.float32),
                 track_2d_valid_bn1t=np.ones((tracks, 1, t), bool))
    return d


def in_memory(module, raw, seed=7, n=1, **kw):
    """An L4PDataset of `module` whose getitem_helper returns copies of
    `raw`, with its own seeded generator."""
    class InMemory(module.L4PDataset):
        def __len__(self):
            return n

        def getitem_helper(self, index):
            return module.L4PData(**{k: v.copy() for k, v in raw.items()}, seq_name=f"mem{index}")

    return InMemory(rng=np.random.default_rng(seed), **kw)


def assert_same(port, ref):
    assert set(port) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert port[k].dtype == v.dtype and port[k].shape == v.shape, k
            np.testing.assert_array_equal(port[k], v, err_msg=k)
        else:
            assert port[k] == v, k


CASES = {
    "resize, random crop, queries over the eroded mask": (
        (10, 60, 80), dict(resize_size=(32, 40), crop_size=(8, 24, 32),
                              track_2d_querry_sampling_version="uniform_over_seg", estimation_directions=[1])),
    "mirror-pad to the sample size, random queries, both directions": (
        (5, 24, 32), dict(crop_size=None, sample_size=(16, 24, 32), track_2d_traj_per_sample=9)),
    "one frame repeated, float video only": (
        (1, 24, 32), dict(crop_size=(4, 24, 32), emit_uint8=False, track_2d_traj_per_sample=5)),
    "nearest and trilinear resize modes, centre crop, uniform grid": (
        (8, 48, 64), dict(resize_size=(30, 40), crop_size=(8, 28, 36), center_crop=True,
                             resize_mode={"depth_b1thw": "trilinear"}, track_2d_querry_sampling_version="uniform",
                             track_2d_querry_sampling_spacing=0.1, estimation_directions=[-1])),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dataset_samples_equal_jax(case):
    shape, kw = CASES[case]
    raw = raw_sample(*shape, seed=len(case))
    if shape[0] == 1:  # a single frame has no flow (repeat_single_frame refuses one, as the reference does)
        raw = {k: v for k, v in raw.items() if not k.startswith("flow")}
    assert_same(in_memory(PD, raw, **kw)[0], in_memory(JD, raw, **kw)[0])


def test_ground_truth_tracks_and_their_queries_equal_jax():
    """generate_point_querries from one seed, then a sample whose tracks and
    queries the crop moves, drops and masks (resize and time crop)."""
    raw = raw_sample(12, 40, 48, seed=3, tracks=20)
    q = {name: m.L4PDataset(rng=np.random.default_rng(5)).generate_point_querries(raw["track_2d_traj_bn2t"],
                                                                                   raw["track_2d_vis_bn1t"])
         for name, m in (("port", PD), ("jax", JD))}
    np.testing.assert_array_equal(q["port"], q["jax"])
    raw.update(track_2d_pointquerries_bn3=q["jax"], track_2d_pointlabels_bn=np.ones(20, np.float32))
    kw = dict(resize_size=(30, 36), crop_size=(8, 24, 28), estimation_directions=[1])
    assert_same(in_memory(PD, raw, **kw)[0], in_memory(JD, raw, **kw)[0])


def test_collate_and_prefetch_equal_jax():
    raw = raw_sample(6, 24, 32, seed=4)
    kw = dict(crop_size=(4, 20, 28), center_crop=True, start_crop_time=True, track_2d_querry_sampling_version="uniform",
              track_2d_querry_sampling_spacing=0.2)
    port, ref = in_memory(PD, raw, n=3, **kw), in_memory(JD, raw, n=3, **kw)
    assert_same(PD.collate(port[0]), JD.collate(ref[0]))
    got = list(PP.prefetch_dataset(port, num_threads=2, buffer=2))
    want = list(JP.prefetch_dataset(ref, num_threads=2, buffer=2))
    assert [b["seq_name"] for b in got] == ["mem0", "mem1", "mem2"]
    for g, w in zip(got, want):
        assert_same(g, w)


def write_davis(root, seq, t, hw):
    rng = np.random.default_rng(8)
    (root / "JPEGImages/480p" / seq).mkdir(parents=True)
    (root / "Annotations/480p" / seq).mkdir(parents=True)
    for i in range(t):
        frame = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        Image.fromarray(frame).save(root / f"JPEGImages/480p/{seq}/{i:05d}.jpg")
        if i % 2 == 0:  # annotations for every other frame; the rest count as empty
            mask = (rng.random(hw) > 0.6).astype(np.uint8) * 255
            Image.fromarray(mask).save(root / f"Annotations/480p/{seq}/{i:05d}.png")


def write_dycheck(root, seq, t, hw):
    rng = np.random.default_rng(9)
    (root / seq / "dense" / "images").mkdir(parents=True)
    for i in range(t):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(root / seq / f"dense/images/{i:05d}.png")
    (root / seq / "calibration.txt").write_text("41.5 40.25 27.5 20.0 0 0\n")


def write_video(path, t, hw):
    rng = np.random.default_rng(10)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (hw[1], hw[0]))
    for _ in range(t):
        vw.write(rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    vw.release()


# the tiny config's window geometry, as the demo and the CLI pass it
GEOMETRY = dict(resize_size=(28, 28), sample_size=(4, 28, 28), length_multiply_of=2)


@pytest.mark.parametrize("source", ["DavisDataset", "DycheckDataset", "VideoDataset"])
def test_sources_equal_jax_on_written_files(tmp_path, source):
    """Each loader on files this test writes: a DAVIS tree of JPEGs with PNG
    masks, a Dycheck sequence of PNGs with its calibration.txt, an mp4."""
    if source == "DavisDataset":
        write_davis(tmp_path, "walk", 5, (40, 56))
        arg = str(tmp_path)
    elif source == "DycheckDataset":
        write_dycheck(tmp_path, "apple", 5, (40, 56))
        arg = str(tmp_path)
    else:
        write_video(tmp_path / "clip.mp4", 9, (40, 56))
        arg = [str(tmp_path / "clip.mp4")]
    port, ref = getattr(PS, source)(arg, **GEOMETRY), getattr(JS, source)(arg, **GEOMETRY)
    assert len(port) == len(ref) == 1
    sample = port[0]
    assert sample["rgb_u8_bthw3"].shape[1:3] == (28, 28)
    assert_same(sample, ref[0])


def test_loaders_and_cv2_writers_name_a_missing_package(tmp_path, monkeypatch):
    """With PIL and cv2 (and matplotlib) unimportable: the data modules and
    the writers still import, the panels that need no cv2 render, and the
    loaders, draw_tracks and the mp4 writer raise ImportError naming the
    package."""
    write_davis(tmp_path / "davis", "walk", 2, (40, 56))
    write_dycheck(tmp_path / "dycheck", "apple", 2, (40, 56))
    for name in ("cv2", "PIL", "matplotlib"):
        monkeypatch.setitem(sys.modules, name, None)
    for name in ("l4p_tpu_torch.data.sources", "l4p_tpu_torch.utils.vis"):
        monkeypatch.delitem(sys.modules, name, raising=False)  # imported anew below, under the mocks
    sources = importlib.import_module("l4p_tpu_torch.data.sources")
    vis = importlib.import_module("l4p_tpu_torch.utils.vis")
    with pytest.raises(ImportError, match="DavisDataset needs PIL"):
        sources.DavisDataset(str(tmp_path / "davis"), **GEOMETRY)[0]
    with pytest.raises(ImportError, match="DycheckDataset needs PIL"):
        sources.DycheckDataset(str(tmp_path / "dycheck"), **GEOMETRY)[0]
    with pytest.raises(ImportError, match="VideoDataset needs cv2"):
        sources.VideoDataset([str(tmp_path / "clip.mp4")], **GEOMETRY)[0]
    rng = np.random.default_rng(11)
    batch = {"rgb_b3thw": rng.standard_normal((1, 3, 2, 8, 8)).astype(np.float32)}
    out = {"depth_est_b1thw": rng.uniform(0.1, 5, (1, 1, 2, 8, 8)).astype(np.float32),
           "track_2d_traj_est_bn2t": rng.uniform(0, 8, (1, 3, 2, 2)).astype(np.float32)}
    assert vis.panel_frames(batch, out, ("depth",)).shape == (2, 8, 16, 3)
    with pytest.raises(ImportError, match="draw_tracks needs cv2"):
        vis.panel_frames(batch, out, ("depth", "track_2d"))
    with pytest.raises(ImportError, match="generate_video_visualizations needs cv2"):
        vis.generate_video_visualizations(batch, out, ("depth",), str(tmp_path / "panels.mp4"))
