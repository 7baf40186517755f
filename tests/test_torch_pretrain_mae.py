"""The port's VideoMAE pretraining (l4p_tpu_torch/pretrain_mae.py, the
optimizers in train.py) against the JAX package's scripts/pretrain_mae.py
and optax, fp32 on the CPU: the warmup-cosine schedule; Adafactor against
optax.adafactor; three `tiny` steps against the JAX script's clip + AdamW
chain on its batches and JAX's masks; the CLI as a command, its
scalars.jsonl and ckpt.pt; that checkpoint overlaying the port's encoder
and JAX's (through its torch branch) identically, a deeper encoder keeping
its init on the blocks the file lacks; `video_batches` on a written clip.

JAX's tree holds the encoder's `pos_embed` and `decoder_pos_embed` as
leaves that AdamW decays (and, for the decoder's, trains); the port keeps
both as fixed buffers (ROADMAP.md section 3), so JAX's chain here runs with
those two leaves' gradients zeroed and their updates masked."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l4p_tpu_torch.checkpoint import _encoder_state, load_video_encoder_ckpt, mae_params_from_jax
from l4p_tpu_torch.models.encoder import VideoEncoder
from l4p_tpu_torch.pretrain_mae import main, mae_config, pretrain_step, synthetic_batches, video_batches
from l4p_tpu_torch.models.mae import MAE
from l4p_tpu_torch.train import Adafactor, make_mae_optimizer, warmup_cosine_decay_schedule
from tests.test_torch_mae import jax_config, numpy_tree, port_config
from tests.test_torch_ops import check, rand

torch.set_num_threads(1)
jax.config.update("jax_default_matmul_precision", "highest")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))


# (init, peak, warmup, decay steps, end): the pretraining CLI's AdamW schedule at its defaults (lr
# 1.5e-4, 100 steps, warmup 10), at 3 steps and warmup 1, the Adafactor schedule, and others
SCHEDULES = [(0.0, 1.5e-4, 10, 100, 1.5e-6), (0.0, 1e-3, 1, 3, 1e-5), (0.0, 1.5e-4, 10, 100, 0.0),
             (0.3, 2.0, 7, 50, 0.1), (1.0, 1.0, 4, 9, 0.0)]


@pytest.mark.parametrize("args", SCHEDULES)
def test_warmup_cosine_schedule_matches_optax(args):
    import optax

    ref, mine = optax.warmup_cosine_decay_schedule(*args), warmup_cosine_decay_schedule(*args)
    peak = max(abs(args[0]), abs(args[1]))
    for i in range(args[3] + 4):
        # measured <= 9.7e-8 of the peak (float32 cos in XLA and in numpy)
        assert abs(float(mine(i)) - float(ref(i))) <= 2e-7 * peak, (i, float(mine(i)), float(ref(i)))
    with pytest.raises(ValueError, match="decay_steps"):
        warmup_cosine_decay_schedule(0.0, 1.0, 5, 5)


# factored (two dims >= 128, either orientation, a 3-D one), unfactored (second dim < 128, vectors),
# and a zero vector, whose RMS is below the parameter scale's floor of 1e-3
ADAFACTOR_SHAPES = {"w": (256, 128), "wt": (130, 300), "w3": (3, 140, 129), "u": (64, 200), "v": (50,),
                    "s": (2, 3, 4, 5), "z": (40,)}


@pytest.mark.parametrize("scale", [100.0, 0.01])
def test_adafactor_matches_optax(scale):
    """Four updates of a toy tree through optax.chain(clip_by_global_norm(1),
    adafactor(warmup-cosine)) and the port's Adafactor, with gradients far
    above (100) and below (0.01) the clip's norm of 1."""
    import optax

    params = {k: rand(s, i) * (0 if k == "z" else 1) for i, (k, s) in enumerate(ADAFACTOR_SHAPES.items())}
    grads = [{k: rand(s, 10 * j + i) * scale for i, (k, s) in enumerate(ADAFACTOR_SHAPES.items())}
             for j in range(4)]
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adafactor(learning_rate=optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 4)))
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    port = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    adafactor = Adafactor(port, warmup_cosine_decay_schedule(0.0, 1e-2, 1, 4))
    assert {k for k, d in adafactor.factored.items() if d is not None} == {"w", "wt", "w3"}
    for g in grads:
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        adafactor.step([torch.from_numpy(g[k]) for k in port])
    for k in port:
        assert not np.array_equal(np.asarray(jp[k]), params[k]), k
        check(port[k], jp[k], 2.5e-7, k)  # measured <= 1.2e-7 (the 3-D one)
    assert adafactor.count == 4


def jax_step_fn(jcfg, lr, steps, warmup):
    """The JAX script's optimizer (make_mae_optimizer) and its jitted step
    (mae_pretrain_loss on a mask key), with the two sinusoid tables'
    gradients zeroed and their updates masked."""
    import optax
    from pretrain_mae import make_mae_optimizer as jax_optimizer

    from l4p_tpu.models.mae import mae_pretrain_loss

    opt = jax_optimizer(lr, steps, warmup)

    def fixed(tree):
        return {**tree, "decoder_pos_embed": jnp.zeros_like(tree["decoder_pos_embed"]),
                "encoder": {**tree["encoder"], "pos_embed": jnp.zeros_like(tree["encoder"]["pos_embed"])}}

    @jax.jit
    def step(params, state, x, key):
        loss, grads = jax.value_and_grad(lambda p: mae_pretrain_loss(p, jcfg, x, key, 0.9))(params)
        updates, state = opt.update(fixed(grads), state, params)
        return optax.apply_updates(params, fixed(updates)), state, loss

    return opt, step


def test_three_tiny_pretraining_steps_match_jax():
    """Three steps of the CLI's `tiny` config from the same weights on
    synthetic_batches (the JAX script's stream, checked equal) and the masks
    the JAX script draws (PRNGKey(1) split each step, given to the port as
    indices): the losses and every parameter after them, against the JAX
    script's optimizer."""
    from pretrain_mae import synthetic_batches as jax_batches

    from l4p_tpu.models.mae import init_mae_params, tube_mask_indices

    jcfg = jax_config("tiny")
    pcfg = port_config(jcfg)
    assert pcfg == mae_config("tiny")
    jparams = init_mae_params(jcfg, jax.random.PRNGKey(0))
    model = MAE(pcfg)
    model.load_state_dict(mae_params_from_jax(numpy_tree(jparams), pcfg), strict=True)
    lr, steps, warmup = 1e-3, 3, 1
    opt, jax_step = jax_step_fn(jcfg, lr, steps, warmup)
    state = opt.init(jparams)
    optimizer = make_mae_optimizer(dict(model.named_parameters()), lr, steps, warmup)
    ours, theirs = synthetic_batches(pcfg.encoder, 2), jax_batches(jcfg.encoder, 2)
    key = jax.random.PRNGKey(1)
    for i in range(steps):
        x = next(ours)
        np.testing.assert_array_equal(x, next(theirs))
        key, sub = jax.random.split(key)
        vis, mask = (np.asarray(a) for a in tube_mask_indices(sub, jcfg.encoder, 2, 0.9))
        jparams, state, ref = jax_step(jparams, state, jnp.asarray(x), sub)
        loss = pretrain_step(model, optimizer, torch.from_numpy(x), torch.from_numpy(vis), torch.from_numpy(mask))
        check(loss, float(ref), 2.5e-7, f"loss {i}")  # measured <= 1.2e-7
    want = mae_params_from_jax(numpy_tree(jparams), pcfg)
    init = mae_params_from_jax(numpy_tree(init_mae_params(jcfg, jax.random.PRNGKey(0))), pcfg)
    for name, p in model.state_dict().items():
        assert not torch.equal(p, init[name]) or not p.any(), name
        check(p, want[name], 5e-7, name)  # measured <= 2.1e-7 (patch_embed)


def run_cli(args, cwd):
    proc = subprocess.run([sys.executable, "-m", "l4p_tpu_torch.pretrain_mae", *args], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_cli_writes_scalars_and_an_encoder_checkpoint(tmp_path, optimizer):
    """`python3 -m l4p_tpu_torch.pretrain_mae --size tiny --device cpu --fp32`
    in its own process: one scalars.jsonl record a step (`step`, `loss` to 5
    places, `s_per_step`), and ckpt.pt holding the tiny encoder's whole state
    dict under `encoder.` in fp32, moved from the seeded init."""
    out = tmp_path / "mae"
    extra = ["--adafactor"] if optimizer == "adafactor" else []
    stdout = run_cli(["--size", "tiny", "--steps", "3", "--batch", "1", "--warmup", "1", "--device", "cpu", "--fp32",
                      "--log-every", "1", "--out-dir", str(out), *extra], tmp_path)
    recs = [json.loads(line) for line in (out / "scalars.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2] and all(set(r) == {"step", "loss", "s_per_step"} for r in recs)
    assert all(np.isfinite(r["loss"]) and r["loss"] == round(r["loss"], 5) and r["s_per_step"] > 0 for r in recs)
    assert f"saved encoder checkpoint -> {out / 'ckpt.pt'}" in stdout
    ckpt = torch.load(out / "ckpt.pt", weights_only=True)
    cfg = mae_config("tiny")
    init = VideoEncoder(cfg.encoder)
    init.init_weights(torch.Generator().manual_seed(0))
    assert set(ckpt) == {f"encoder.{k}" for k in init.state_dict()}
    assert all(v.dtype == torch.float32 for v in ckpt.values())
    assert not torch.equal(ckpt["encoder.blocks.0.attn.qkv.weight"], init.blocks[0].attn.qkv.weight)


def test_cli_refuses_fp32_on_cuda_before_any_step(tmp_path, capsys):
    with pytest.raises(SystemExit) as exit_info:
        main(["--size", "tiny", "--fp32", "--device", "cuda", "--out-dir", str(tmp_path / "never")])
    assert exit_info.value.code == 2
    err = capsys.readouterr().err
    assert "attention kernel" in err and "bf16 only" in err
    assert not (tmp_path / "never").exists()


@pytest.mark.parametrize("depth", [2, 4])
def test_checkpoint_overlays_port_and_jax_encoders_identically(tmp_path, depth):
    """The CLI's ckpt.pt over an encoder of the tiny config's width
    initialised from one JAX tree, through the port's load_video_encoder_ckpt
    and JAX's torch branch: equal results. At the CLI's depth 2 every
    tensor comes from the file; at depth 4 the blocks keep their init (the
    file has no blocks 2-3) and the rest comes from the file."""
    from l4p_tpu.config import load_video_encoder_ckpt as jax_overlay
    from l4p_tpu.models.encoder import init_encoder_params

    assert main(["--size", "tiny", "--steps", "2", "--batch", "1", "--warmup", "1", "--device", "cpu", "--fp32",
                 "--out-dir", str(tmp_path)]) == 0
    path = str(tmp_path / "ckpt.pt")
    ckpt = torch.load(path, weights_only=True)
    jcfg = dataclasses.replace(jax_config("tiny").encoder, depth=depth)
    init = numpy_tree(init_encoder_params(jcfg, jax.random.PRNGKey(42)))
    pcfg = dataclasses.replace(mae_config("tiny").encoder, depth=depth)
    enc = VideoEncoder(pcfg)
    enc.load_state_dict(_encoder_state(init, pcfg), strict=True)
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    load_video_encoder_ckpt(enc, path)
    ref = _encoder_state(numpy_tree(jax_overlay(init, path, jcfg, jnp.float32)), pcfg)
    for k, v in enc.state_dict().items():
        assert torch.equal(v, ref[k]), k
        from_file = depth == 2 or not k.startswith("blocks.")
        assert torch.equal(v, ckpt[f"encoder.{k}"] if from_file else before[k]), k


def test_video_batches_crop_the_dataset_samples(tmp_path):
    """video_batches on a 9-frame mp4 the test writes, at the tiny config's
    28 x 28 and 4 frames: each clip is the JAX package's VideoDataset sample
    (normalised, resized) at the start frame default_rng(0) draws."""
    from tests.test_torch_data import write_video

    from l4p_tpu.data.sources import VideoDataset as JaxVideoDataset

    write_video(tmp_path / "clip.mp4", 9, (40, 56))
    (tmp_path / "notes.txt").write_text("not a clip")
    enc = mae_config("tiny").encoder
    batches = video_batches(str(tmp_path), enc, 3)
    got = [next(batches) for _ in range(2)]
    ref = JaxVideoDataset([str(tmp_path / "clip.mp4")], crop_size=None, resize_size=(28, 28), sample_size=(4, 28, 28),
                          length_multiply_of=1)[0]["rgb_b3thw"]
    assert ref.shape[1] >= 4
    rng = np.random.default_rng(0)
    for batch in got:
        assert batch.shape == (3, 3, 4, 28, 28) and batch.dtype == np.float32
        for clip in batch:
            assert int(rng.integers(1)) == 0
            t0 = int(rng.integers(ref.shape[1] - 4 + 1))
            np.testing.assert_array_equal(clip, ref[:, t0:t0 + 4])
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no .mp4"):
        next(video_batches(str(tmp_path / "empty"), enc, 1))
