"""The port's evaluation against the JAX package: Trainer.validate on each of
the five eval configs (fp32, CPU; the tiny config, and for all_task the
8 x 8-ray config on which the camera solve is well conditioned, with the JAX
forward's draws), the scalars it returns and the scalars.jsonl records it
writes; `python3 -m l4p_tpu_torch.eval_protocol` against
scripts/eval_protocol.py on one checkpoint; and the CLI's validate / test
on a DAVIS tree the test writes."""

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from l4p_tpu_torch import Trainer, TrainerConfig
from l4p_tpu_torch.eval_protocol import CONFIGS, config_frames, synthetic_batch
from tests.test_torch_camray import JaxDraws
from tests.test_torch_encoder import tiny_models
from tests.test_torch_ops import check

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_YAML = os.path.join(REPO, "configs", "model_tiny.yaml")
EVAL = {name: (tasks, extra) for name, tasks, extra in CONFIGS}


@functools.lru_cache(maxsize=1)
def camray_models():
    """test_torch_slice.fused_models' 8 x 8-ray config on the default encoder."""
    from tests.test_torch_encoder_options import option_models
    from tests.test_torch_slice import fused_models

    base = fused_models()[0]
    return option_models(base, fused_encoder=False, flash_interpret=False)


def eval_batches(cfg, name: str, seeds=(0, 1), n_queries: int = 5):
    """The protocol's synthetic batches of config `name` at cfg's geometry."""
    tasks, extra = EVAL[name]
    _, h, w = cfg.window_size
    return [synthetic_batch(config_frames(cfg, extra), h, w, n_queries, seed, tasks) for seed in seeds]


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# per metric, |port - JAX| <= tol * (1 + |JAX|) on identical fp32 weights and batches. The
# outputs agree to <= 1e-6 (test_torch_slice), so the counts behind delta1, the pixel
# thresholds, the IoU and the track accuracies come out the same (measured 0, or 4e-8 where
# two batches' means round apart); measured <= 4.5e-7 on the continuous metrics (flow/epe),
# 4.1e-6 on the poses' rot_deg (arccos of the trace, as in test_torch_metrics) and 1.8e-6 on
# trans_rmse
DEFAULT_TOL = 1e-6
VALIDATE_TOL = {"pose/rot_deg": 1e-5, "pose/trans_rmse": 4e-6}


@pytest.mark.parametrize("name", list(EVAL))
def test_validate_matches_jax_trainer(name, tmp_path):
    from l4p_tpu.trainer import Trainer as JaxTrainer
    from l4p_tpu.trainer import TrainerConfig as JaxTrainerConfig

    jcfg, jparams, pcfg, model = camray_models() if name == "all_task" else tiny_models()
    if name == "depth_single_window":  # as the protocol runs it
        jcfg, pcfg = (dataclasses.replace(c, joint_alignment=False) for c in (jcfg, pcfg))
    tasks = EVAL[name][0]
    batches = eval_batches(pcfg, name, seeds=(0,) if name == "all_task" else (0, 1))
    ref = JaxTrainer(jcfg, tasks, JaxTrainerConfig(out_dir=str(tmp_path / "jax"))).validate(jparams, iter(batches),
                                                                                          step=7)
    trainer = Trainer(pcfg, tasks, TrainerConfig(out_dir=str(tmp_path / "port")), device="cpu",
                      draws=JaxDraws.for_session())
    out = trainer.validate(model, iter(batches), step=7)
    assert set(out) == set(ref) and out["num_batches"] == ref["num_batches"] == len(batches)
    assert len(out) == {"depth_single_window": 4, "dense_windowed": 8, "track2d": 4, "track3d_depth": 7,
                        "all_task": 13}[name]
    for k in ref:
        check(torch.tensor(out[k]), ref[k], VALIDATE_TOL.get(k, DEFAULT_TOL), k)
    (port_rec,), (jax_rec,) = records(tmp_path / "port/scalars.jsonl"), records(tmp_path / "jax/scalars.jsonl")
    assert set(port_rec) == set(jax_rec) == {"step", *(f"scalars/val/{k}" for k in ref)}
    assert port_rec["step"] == jax_rec["step"] == 7
    for k, v in jax_rec.items():
        check(torch.tensor(port_rec[k]), v, VALIDATE_TOL.get(k.split("/", 2)[-1], DEFAULT_TOL), k)
    cfg_json = json.load(open(tmp_path / "port/config.json"))
    assert cfg_json["tasks"] == list(tasks) and cfg_json["trainer"] == dataclasses.asdict(TrainerConfig(
        out_dir=str(tmp_path / "port")))


def test_trainer_predict_and_the_refusals(tmp_path):
    from l4p_tpu_torch.trainer import do_data_sanity_checks

    _, _, pcfg, model = tiny_models()
    trainer = Trainer(pcfg, ("depth",), TrainerConfig(out_dir=str(tmp_path)), device="cpu")
    (batch,) = eval_batches(pcfg, "dense_windowed", seeds=(3,))
    (out,) = list(trainer.predict(model, [{**batch, "seq_name": "clip"}]))
    assert set(out) == {"depth_est_b1thw"} and out["depth_est_b1thw"].dtype == np.float32
    with pytest.raises(NotImplementedError, match="training"):
        trainer.fit(model, iter([batch]))
    assert do_data_sanity_checks({"track_2d_valid_bn1t": np.zeros((1, 3, 1, 4))})
    assert not do_data_sanity_checks({"track_2d_valid_bn1t": np.ones((1, 3, 1, 4))}) and not do_data_sanity_checks({})


def run(args, cwd, env=None):
    proc = subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2", **(env or {})})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def tiny_yaml_ckpt(path):
    """configs/model_tiny.yaml's model with JAX weights from PRNGKey(3), as a
    Lightning .ckpt both packages load strictly."""
    from l4p_tpu.config import init_l4p_params, load_model_config
    from tests.test_torch_factory import jax_state, write_ckpt
    from tests.test_torch_ops import port_config

    jcfg, _ = load_model_config(TINY_YAML)
    return write_ckpt(path, jax_state(init_l4p_params(jcfg, jax.random.PRNGKey(3)), port_config(jcfg)))


# both protocols run bf16 weights (the JAX script's fixed dtype): XLA's and torch's CPU bf16
# products round differently, and a few pixels cross the delta / pixel thresholds. Measured
# 9.8e-4 (depth/absrel), 9.0e-4 (depth/delta1), 3.5e-4 (depth/rmse), <= 7.7e-5 on the others; the
# poses come from RANSACs on the tiny config's 2 x 2 rays, where every homography hypothesis
# ties, under each package's own draws: they are held finite only
PROTOCOL_TOL = 2e-3


def test_eval_protocol_matches_the_jax_script(tmp_path):
    ckpt = tiny_yaml_ckpt(tmp_path / "tiny.ckpt")
    common = ["--model-config", TINY_YAML, "--ckpt", ckpt, "--queries", "8"]
    run([os.path.join(REPO, "scripts", "eval_protocol.py"), "--cpu", *common, "--out-dir", str(tmp_path / "jax")],
        tmp_path, {"JAX_PLATFORMS": "cpu"})
    stdout = run(["-m", "l4p_tpu_torch.eval_protocol", "--device", "cpu", *common, "--out-dir",
                  str(tmp_path / "port")], tmp_path)
    assert len(stdout.strip().splitlines()) == len(CONFIGS)
    for name, tasks, _ in CONFIGS:
        (port,), (ref,) = records(tmp_path / "port" / f"{name}.jsonl"), records(tmp_path / "jax" / f"{name}.jsonl")
        assert set(port) == set(ref)
        for key in ("config", "tasks", "frames", "queries", "data", "weights"):
            assert port[key] == ref[key], (name, key)
        assert port["weights"] == "ckpt" and port["frames"] == (4 if name == "depth_single_window" else 12)
        assert port["seconds"] > 0 and port["fps"] > 0
        assert set(port["metrics"]) == set(ref["metrics"])
        for k, v in ref["metrics"].items():
            if k.startswith("pose/"):
                assert math.isfinite(port["metrics"][k]), (name, k)
            else:
                check(torch.tensor(port["metrics"][k]), v, PROTOCOL_TOL, f"{name} {k}")


def test_cli_validate_and_test_match_the_jax_trainer(tmp_path):
    """`main validate` and `main test` on a DAVIS tree (its segmentation
    gives the queries and the static ground-truth tracks) against JAX's
    Trainer.validate on the same collated samples and the same .ckpt."""
    from l4p_tpu.config import convert_l4p, load_model_config
    from l4p_tpu.trainer import Trainer as JaxTrainer
    from l4p_tpu.trainer import TrainerConfig as JaxTrainerConfig
    from l4p_tpu_torch import main as cli
    from l4p_tpu_torch.data.dataset import collate
    from l4p_tpu_torch.data.sources import DavisDataset
    from l4p_tpu_torch.demo import dataset_kwargs
    from tests.test_torch_data import write_davis

    ckpt = tiny_yaml_ckpt(tmp_path / "tiny.ckpt")
    write_davis(tmp_path / "davis", "walk", 5, (40, 56))
    common = ["--config", TINY_YAML, "--ckpt", ckpt, "--davis-root", str(tmp_path / "davis"), "--device", "cpu",
              "--fp32", "--max-queries", "512"]
    for command, phase in (("validate", "val"), ("test", "test")):
        assert cli.main([command, *common, "--out-dir", str(tmp_path / command)]) == 0
    jcfg, tasks = load_model_config(TINY_YAML)
    jcfg = dataclasses.replace(jcfg, track=dataclasses.replace(jcfg.track, max_queries=512))
    jparams = convert_l4p(torch.load(ckpt, weights_only=True)["state_dict"], jcfg)
    from l4p_tpu_torch.config import load_model_config as port_load

    ds = DavisDataset(str(tmp_path / "davis"), **dataset_kwargs(port_load(TINY_YAML)[0]))
    ref = JaxTrainer(jcfg, tasks, JaxTrainerConfig(out_dir=str(tmp_path / "jax"))).validate(
        jparams, (collate(ds[i]) for i in range(len(ds))))
    assert set(ref) == {"track/delta_avg", "track/aj", "track/occ_acc", "num_batches"}
    for command, phase in (("validate", "val"), ("test", "test")):
        (rec,) = records(tmp_path / command / "scalars.jsonl")
        assert set(rec) == {"step", *(f"scalars/{phase}/{k}" for k in ref)}
        for k, v in ref.items():
            # the tracks agree to <= 4e-7 px (test_torch_slice): the same points pass each threshold
            check(torch.tensor(rec[f"scalars/{phase}/{k}"]), v, 1e-7, k)
    with pytest.raises(NotImplementedError, match="training"):
        cli.main(["fit", *common])
