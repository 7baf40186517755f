"""The port's model factory and camera_rays head against the JAX package
(fp32, CPU): prepare_model on a synthetic Lightning .ckpt written from JAX
parameters, the encoder-only overlay load_video_encoder_ckpt, and a session
with a camera_rays (VideoMAECameraDPTHead) head against JAX l4p_forward.
The released .ckpt is not in the repository; the files here are written by
the tests."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from l4p_tpu_torch import L4P, SLICE_TASKS, InferenceSession, load_video_encoder_ckpt, params_from_jax, prepare_model
from tests.test_torch_ops import check, port_config

torch.set_num_threads(1)

TINY_YAML = "configs/model_tiny.yaml"


def jax_state(jparams, pcfg):
    """The JAX tree as the port's state dict (torch tensors)."""
    return params_from_jax(jax.tree.map(np.asarray, jparams), pcfg)


def write_ckpt(path, state, prefix="l4p_model."):
    torch.save({"state_dict": {prefix + k: v for k, v in state.items()}, "epoch": 3}, path)
    return str(path)


@functools.lru_cache(maxsize=1)
def tiny_yaml_models():
    """(JAX config, JAX params from PRNGKey(3), port config) of
    configs/model_tiny.yaml, max_queries 4 (11 queries make 3 chunks)."""
    from l4p_tpu.config import init_l4p_params, load_model_config

    jcfg, _ = load_model_config(TINY_YAML)
    jcfg = dataclasses.replace(jcfg, track=dataclasses.replace(jcfg.track, max_queries=4))
    return jcfg, init_l4p_params(jcfg, jax.random.PRNGKey(3)), port_config(jcfg)


def request(t=8, n=11, seed=8):
    rng = np.random.default_rng(seed)
    q = np.stack([rng.uniform(0, t, n), rng.uniform(0, 28, n), rng.uniform(0, 28, n)], -1).astype(np.float32)
    return {"rgb_u8_bthw3": rng.integers(0, 256, (1, t, 28, 28, 3), dtype=np.uint8),
            "track_2d_pointquerries_bn3": q[None], "track_2d_pointlabels_bn": np.ones((1, n), np.float32)}


def test_prepare_model_matches_jax_prepare_model(tmp_path):
    """The same .ckpt through both factories: the port's model holds the
    JAX parameters exactly, and both sessions serve the same outputs."""
    from l4p_tpu.config import prepare_model as jax_prepare_model
    from l4p_tpu.inference import InferenceSession as JaxSession

    jcfg0, jparams0, pcfg0 = tiny_yaml_models()
    path = write_ckpt(tmp_path / "l4p.ckpt", jax_state(jparams0, pcfg0))
    jparams, jcfg, jtasks = jax_prepare_model(TINY_YAML, path, max_queries=4, dtype=jnp.float32)
    model, pcfg, tasks = prepare_model(TINY_YAML, path, max_queries=4, dtype=torch.float32, device="cpu")
    assert tasks == jtasks and pcfg == port_config(jcfg) and pcfg.track.max_queries == 4
    got, want = model.state_dict(), jax_state(jparams, pcfg)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    data = request()
    ref = JaxSession(jcfg, SLICE_TASKS)(jparams, {k: jnp.asarray(v) for k, v in data.items()})
    out = InferenceSession(pcfg, SLICE_TASKS, "cpu")(model, data)
    assert set(out) == set(ref)
    for k in ref:
        check(out[k], ref[k], 1.5e-6, k)  # measured <= 6.9e-7 (depth), 2.6e-7 (traj)


@pytest.mark.parametrize("head", ["depth", "camray", "track_2d"])
def test_prepare_model_names_a_configured_head_missing_from_the_checkpoint(tmp_path, head):
    """KeyError naming the head, as convert_l4p raises for the dense heads
    (the JAX reader skips a missing track head; the strict load here would
    refuse it anyway)."""
    from l4p_tpu.config import prepare_model as jax_prepare_model

    jcfg, jparams, pcfg = tiny_yaml_models()
    pre = "task_heads.track_2d." if head == "track_2d" else f"task_heads.{head}.task_head."
    state = {k: v for k, v in jax_state(jparams, pcfg).items() if not k.startswith(pre)}
    path = write_ckpt(tmp_path / "l4p.ckpt", state)
    with pytest.raises(KeyError, match=f"'{head}'"):
        prepare_model(TINY_YAML, path, dtype=torch.float32, device="cpu")
    if head != "track_2d":
        with pytest.raises(KeyError, match=f"'{head}'"):
            jax_prepare_model(TINY_YAML, path, dtype=jnp.float32)


def test_prepare_model_refuses_an_extra_key(tmp_path):
    """A key no module takes fails the strict load, as convert_l4p's
    unconsumed-key check refuses it."""
    from l4p_tpu.config import prepare_model as jax_prepare_model

    jcfg, jparams, pcfg = tiny_yaml_models()
    state = jax_state(jparams, pcfg)
    state["video_encoder.blocks.0.gamma_1"] = torch.ones(64)
    path = write_ckpt(tmp_path / "l4p.ckpt", state)
    with pytest.raises(RuntimeError, match="gamma_1"):
        prepare_model(TINY_YAML, path, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="gamma_1"):
        jax_prepare_model(TINY_YAML, path, dtype=jnp.float32)


def test_prepare_model_without_a_checkpoint_is_seeded():
    """Random weights from a generator seeded with 0, in bf16 by default:
    two calls give the same model."""
    a, cfg, tasks = prepare_model(TINY_YAML, max_queries=4, device="cpu")
    b, _, _ = prepare_model(TINY_YAML, max_queries=4, device="cpu")
    assert cfg.track.max_queries == 4 and "camray" in tasks
    assert all(v.dtype == torch.bfloat16 for v in a.state_dict().values())
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k


def encoder_ckpt(tmp_path, wrapper="raw", prefix="", drop=(), mismatch=(), name="encoder.pth"):
    """The encoder of JAX params from PRNGKey(1) as a torch checkpoint with
    `drop` keys left out, `mismatch` keys given another shape, an MAE
    decoder key the overlay ignores, under `wrapper` and key `prefix`.
    Returns (path, the keys in the file, stripped of the prefix)."""
    from l4p_tpu.config import init_l4p_params

    jcfg, _, pcfg = tiny_yaml_models()
    enc = {k[len("video_encoder."):]: v for k, v in jax_state(init_l4p_params(jcfg, jax.random.PRNGKey(1)),
                                                              pcfg).items() if k.startswith("video_encoder.")}
    enc = {k: v + 1.0 for k, v in enc.items() if k not in drop}  # every tensor away from the init
    enc.update({k: torch.zeros(3, 5) for k in mismatch})
    enc["decoder.head.weight"] = torch.ones(2, 2)
    sd = {prefix + k: v for k, v in enc.items()}
    path = tmp_path / name
    torch.save(sd if wrapper == "raw" else {wrapper: sd, "epoch": 7}, path)
    return str(path), enc


@pytest.mark.parametrize("wrapper,prefix", [("raw", ""), ("state_dict", ""), ("model", ""), ("module", ""),
                                            ("raw", "encoder.")])
def test_load_video_encoder_ckpt_matches_jax(tmp_path, wrapper, prefix):
    """Present tensors overlay the init; norm.bias (absent) keeps it, and so
    does every block's fc1 weight, since block 2's is absent (a per-block
    tensor loads only for every block at once); the MAE decoder's key is
    ignored."""
    from l4p_tpu.config import load_video_encoder_ckpt as jax_overlay

    jcfg, jparams, pcfg = tiny_yaml_models()
    path, _ = encoder_ckpt(tmp_path, wrapper, prefix, drop=("norm.bias", "blocks.2.mlp.fc1.weight"))
    model = L4P(pcfg)
    model.load_state_dict(jax_state(jparams, pcfg), strict=True)
    load_video_encoder_ckpt(model.video_encoder, path)
    ref = jax_overlay(jparams["video_encoder"], path, jcfg.encoder, jnp.float32)
    want = jax_state({"video_encoder": ref, "task_heads": jparams["task_heads"]}, pcfg)
    init = jax_state(jparams, pcfg)
    for k, v in model.video_encoder.state_dict().items():
        assert torch.equal(v, want[f"video_encoder.{k}"]), k
    moved = {k for k, v in model.video_encoder.state_dict().items() if not torch.equal(v, init[f"video_encoder.{k}"])}
    assert {"norm.weight", "patch_embed.proj.weight", "blocks.3.attn.qkv.weight"} <= moved
    assert not {"norm.bias", "blocks.0.mlp.fc1.weight", "blocks.2.mlp.fc1.weight"} & moved


def test_load_video_encoder_ckpt_keeps_the_init_on_a_mismatched_shape(tmp_path):
    """A tensor of another shape counts as absent: the port against the JAX
    overlay of the same file without it (the JAX reader checks shapes on its
    orbax branch only)."""
    from l4p_tpu.config import load_video_encoder_ckpt as jax_overlay

    jcfg, jparams, pcfg = tiny_yaml_models()
    path, _ = encoder_ckpt(tmp_path, mismatch=("norm.weight", "blocks.1.attn.proj.weight"))
    ref_path, _ = encoder_ckpt(tmp_path, drop=("norm.weight", "blocks.1.attn.proj.weight"), name="without.pth")
    model = L4P(pcfg)
    model.load_state_dict(jax_state(jparams, pcfg), strict=True)
    load_video_encoder_ckpt(model.video_encoder, path)
    ref = jax_overlay(jparams["video_encoder"], ref_path, jcfg.encoder, jnp.float32)
    want = jax_state({"video_encoder": ref, "task_heads": jparams["task_heads"]}, pcfg)
    for k, v in model.video_encoder.state_dict().items():
        assert torch.equal(v, want[f"video_encoder.{k}"]), k


def test_load_video_encoder_ckpt_refuses_an_orbax_directory(tmp_path):
    _, _, pcfg = tiny_yaml_models()
    with pytest.raises(NotImplementedError, match="MAE"):
        load_video_encoder_ckpt(L4P(pcfg).video_encoder, tmp_path)


def test_prepare_model_overlays_the_yaml_encoder_checkpoint(tmp_path):
    """video_encoder_ckpt_path in the YAML: the seeded model with its
    encoder overlaid by the file, the heads untouched."""
    path, enc = encoder_ckpt(tmp_path)
    with open(TINY_YAML) as f:
        tree = yaml.safe_load(f)
    tree["init_args"]["l4p_model"]["init_args"]["video_encoder_ckpt_path"] = path
    yml = tmp_path / "model.yaml"
    yml.write_text(yaml.safe_dump(tree, sort_keys=False))  # the heads' order sets their random weights
    model, cfg, _ = prepare_model(str(yml), dtype=torch.float32, device="cpu")
    base, _, _ = prepare_model(TINY_YAML, dtype=torch.float32, device="cpu")
    assert cfg.video_encoder_ckpt_path == path
    for k, v in model.state_dict().items():
        if k.startswith("video_encoder."):
            assert torch.equal(v, enc[k[len("video_encoder."):]]), k
        else:
            assert torch.equal(v, base.state_dict()[k]), k


@functools.lru_cache(maxsize=1)
def camera_rays_models():
    """The tiny config plus a camera_rays head 'rays' (VideoMAECameraDPTHead:
    6 raw ray channels at camray's DPT output size, 2 x 2 here); (JAX
    config, JAX params, port config, port model) on the same weights."""
    from l4p_tpu.config import init_l4p_params
    from tests.test_l4p_forward import tiny_cfg

    jcfg = tiny_cfg()
    rays = dataclasses.replace(jcfg.head_dict["camray"], task_name="rays", kind="camera_rays")
    jcfg = dataclasses.replace(jcfg, heads=jcfg.heads + (("rays", rays),))
    jparams = init_l4p_params(jcfg, jax.random.PRNGKey(4))
    pcfg = port_config(jcfg)
    model = L4P(pcfg)
    model.load_state_dict(jax_state(jparams, pcfg), strict=True)
    return jcfg, jparams, pcfg, model.eval()


def test_camera_rays_session_matches_jax_forward():
    """The rays head served by name beside the slice's tasks: its raw rays
    overwrite-stitched, no aligner (l4p.py:774-780 of the JAX package), a
    16 x 16 map at the released size, 2 x 2 at the tiny one."""
    from l4p_tpu.models.l4p import l4p_forward

    jcfg, jparams, pcfg, model = camera_rays_models()
    tasks = ("flow_2d_backward", "rays", "track_2d", "depth", "dyn_mask")
    data = request(seed=9)
    ref = jax.jit(lambda p, d: l4p_forward(p, jcfg, d, tasks))(jparams, {k: jnp.asarray(v) for k, v in data.items()})
    out = InferenceSession(pcfg, tasks, "cpu")(model, data)
    assert set(out) == set(ref) and "rays_est_b6thw" in out
    assert out["rays_est_b6thw"].shape == (1, 6, 8, 2, 2)
    for k in ref:
        check(out[k], ref[k], 1.5e-6, k)  # measured <= 2.6e-7


def test_camera_rays_session_refuses_an_unconfigured_name():
    _, _, pcfg, _ = camera_rays_models()
    with pytest.raises(ValueError, match="unknown tasks"):
        InferenceSession(pcfg, ("depth", "more_rays"), "cpu")
