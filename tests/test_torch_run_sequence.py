"""The port's artefact-writing entry points against the JAX package's (fp32,
CPU): run_sequence offline and streamed against l4p_tpu.inference.
run_sequence on test_torch_slice.fused_models' config (whose 8 x 8 camray
rays give the camera solve a unique answer; the tiny config's 2 x 2 rays tie
every homography hypothesis) with the JAX session's random draws, the
artefacts both write, and the demo and the CLI's predict run end to end
(`python3 -m ...` on the CPU)."""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from l4p_tpu_torch import ALL_TASKS
from l4p_tpu_torch.inference import run_sequence
from tests.test_torch_camray import JaxDraws
from tests.test_torch_ops import check
from tests.test_torch_slice import all_task_request, fused_models
from tests.test_torch_streaming import JaxStreamDraws

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_YAML = os.path.join(REPO, "configs", "model_tiny.yaml")
# |port - JAX| / (1 + |JAX|): measured <= 2.0e-7 on the dense and track
# outputs offline and streamed; poses 1.5e-5 / 8.8e-6 and K 4.5e-6 / 1.6e-6
# (offline / streamed: the camera solve and the Sim(3) chain amplify the
# packages' 1e-7 feature differences); the tolerances are about twice that
TOL = {"traj3d_est_b16t": 3e-5, "traj3d_intrinsics_est_b16t": 9e-6}
DENSE_AND_TRACK_TOL = 1e-5


def collated_batch():
    """bench.py-style request of the fused config (12 frames, 5 queries) as a
    collated batch: uint8 frames, the normalised video and its statistics."""
    data = all_task_request()
    mean = np.array([0.485, 0.456, 0.406], np.float32)[None, :, None, None, None]
    std = np.array([0.229, 0.224, 0.225], np.float32)[None, :, None, None, None]
    data["rgb_b3thw"] = ((data["rgb_u8_bthw3"].transpose(0, 4, 1, 2, 3) / 255.0 - mean) / std).astype(np.float32)
    data["rgb_mean_b3111"], data["rgb_std_b3111"] = mean, std
    return data


def jax_run(stream, out_dir):
    from l4p_tpu.inference import run_sequence as jax_run_sequence

    jcfg, jparams, _, _ = fused_models()
    return jax_run_sequence(jparams, jcfg, ALL_TASKS, collated_batch(), out_dir, "clip", dtype=jnp.float32,
                            stream=stream)


def artefacts(out_dir):
    """{path under out_dir: kind} of every file run_sequence wrote."""
    found = {}
    for root, _, files in os.walk(out_dir):
        for f in files:
            found[os.path.relpath(os.path.join(root, f), out_dir)] = f.split("_")[0].split(".")[-1]
    return found


@pytest.mark.parametrize("stream", [False, True], ids=["offline", "streamed"])
def test_run_sequence_matches_jax(tmp_path_factory, stream):
    """Outputs within the tolerances above and the same artefacts (the panel
    video, every 4th frame's point cloud, the cameras and each frame's 3D
    tracks), with JAX's draws: its session's offline, its streaming keys
    streamed."""
    jax_dir = str(tmp_path_factory.mktemp("jax"))
    ref = jax_run(stream, jax_dir)
    _, _, pcfg, model = fused_models()
    port_dir = str(tmp_path_factory.mktemp("port"))
    draws = (JaxStreamDraws if stream else JaxDraws).for_session()
    out = run_sequence(model, pcfg, ALL_TASKS, collated_batch(), port_dir, "clip", device="cpu", dtype=torch.float32,
                       stream=stream, draws=draws)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == np.float32
        check(out[k], ref[k], TOL.get(k, DENSE_AND_TRACK_TOL), k)
    written = artefacts(port_dir)
    assert written == artefacts(jax_dir)
    assert sorted(written.values()).count("pointcloud") == 3 and sorted(written.values()).count("tracks") == 12
    assert {"clip_panels.mp4", os.path.join("clip", "cameras.ply")} <= set(written)


def test_run_sequence_refuses_to_stream_float_frames():
    _, _, pcfg, model = fused_models()
    batch = {k: v for k, v in collated_batch().items() if k != "rgb_u8_bthw3"}
    with pytest.raises(ValueError, match="uint8"):
        run_sequence(model, pcfg, ALL_TASKS, batch, "", "clip", device="cpu", stream=True)


def run_module(args, cwd):
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def test_demo_runs_synthetic_end_to_end(tmp_path):
    """demo.py's seeded 24-frame, 32-query sequence at the tiny config's
    28 x 28: every task, the panel video and 6 + 1 + 24 PLYs."""
    stdout = run_module(["l4p_tpu_torch.demo", "--synthetic", "--config", TINY_YAML, "--device", "cpu", "--out-dir",
                         str(tmp_path)], tmp_path)
    assert "[synthetic] 24 frames in" in stdout and "wrote 31 point clouds" in stdout
    written = artefacts(tmp_path)
    assert "synthetic_panels.mp4" in written and len([k for k in written if k.endswith(".ply")]) == 31


def write_mp4(path, t=9, hw=(40, 56)):
    rng = np.random.default_rng(10)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (hw[1], hw[0]))
    for _ in range(t):
        vw.write(rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    vw.release()
    return str(path)


def test_cli_predict_runs_a_video_end_to_end(tmp_path):
    """`main predict --video` on a 9-frame mp4 (mirror-padded to 10 frames,
    the uniform query grid: 2500 queries) with the tiny config, streamed."""
    video = write_mp4(tmp_path / "clip.mp4")
    stdout = run_module(["l4p_tpu_torch.main", "predict", "--config", TINY_YAML, "--video", video, "--device", "cpu",
                         "--out-dir", str(tmp_path / "out"), "--stream", "--fp32"], tmp_path)
    assert "[clip.mp4] 10 frames streamed" in stdout
    assert "sample 0 (clip.mp4): depth_est_b1thw[1, 1, 10, 28, 28]" in stdout
    assert "track_2d_traj_est_bn2t[1, 2500, 2, 10]" in stdout
    assert "clip.mp4_panels.mp4" in artefacts(tmp_path / "out")


def test_cli_loads_a_ckpt_strictly_and_refuses_what_it_does_not_serve(tmp_path):
    from l4p_tpu_torch import main as cli
    from l4p_tpu_torch.checkpoint import prepare_model

    model, _, _ = prepare_model(TINY_YAML, device="cpu", dtype=torch.float32)
    state = {f"l4p_model.{k}": v for k, v in model.state_dict().items()}
    torch.save({"state_dict": state}, tmp_path / "good.ckpt")
    torch.save({"state_dict": {**state, "l4p_model.extra": torch.zeros(1)}}, tmp_path / "extra.ckpt")
    video = write_mp4(tmp_path / "clip.mp4", t=4)
    common = ["--config", TINY_YAML, "--video", video, "--device", "cpu", "--out-dir", str(tmp_path / "out"), "--fp32"]
    assert cli.main(["predict", "--ckpt", str(tmp_path / "good.ckpt"), *common]) == 0
    with pytest.raises(RuntimeError, match="Unexpected key"):
        cli.main(["predict", "--ckpt", str(tmp_path / "extra.ckpt"), *common])
    with pytest.raises(NotImplementedError, match="orbax"):
        cli.main(["predict", "--ckpt", str(tmp_path), *common])
    with pytest.raises(NotImplementedError, match="training side"):
        cli.main(["fit", *common])
