"""Port encoder vs the JAX encoder at the tiny config (fp32, CPU): hook
features and final output, the uint8 ingest, window encoding, and the
parameter conversion into the released state-dict layout."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l4p_tpu_torch import ALL_TASKS, L4P, params_from_jax
from l4p_tpu_torch.models.ingest import ingest_video_tokens
from l4p_tpu_torch.models.l4p import encode_windows
from tests.test_torch_ops import check, rand, tiny_port_cfg

torch.set_num_threads(1)


@functools.lru_cache(maxsize=1)
def tiny_models(seed: int = 0):
    """(JAX config, JAX params, port config, port model) on the same weights;
    shared by the tests, which do not modify it."""
    from l4p_tpu.config import init_l4p_params
    from tests.test_l4p_forward import tiny_cfg

    jcfg, pcfg = tiny_cfg(), tiny_port_cfg()
    jparams = init_l4p_params(jcfg, jax.random.PRNGKey(seed), tasks=ALL_TASKS)
    model = L4P(pcfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), pcfg), strict=True)
    return jcfg, jparams, pcfg, model.eval()


def video_u8(t: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (1, t, 28, 28, 3), dtype=np.uint8)


@pytest.mark.parametrize("hooks", [(1, 2, 3, 4), (0, 2, 4)])
def test_encoder_hooks_and_final_match_jax(hooks):
    from l4p_tpu.models.encoder import encoder_apply

    jcfg, jparams, _, model = tiny_models()
    x = rand((2, 3, 4, 28, 28), 1)
    ref = encoder_apply(jparams["video_encoder"], jnp.asarray(x), jcfg.encoder, hooks=hooks)
    enc = model.video_encoder
    with torch.no_grad():
        out = enc(enc.embed(torch.from_numpy(x)), hooks)
    for h, p, r in zip(hooks, out["hooks"], ref["hooks"]):
        check(p, r, 5e-6, f"hook {h}")  # measured <= 2.4e-6
    check(out["final"], ref["final"], 5e-6, "final")


def test_uint8_ingest_matches_jax():
    from l4p_tpu.models.ingest import ingest_video_tokens as jax_ingest

    jcfg, jparams, _, model = tiny_models()
    u8 = video_u8(4)  # one window: the position table spans one
    ref = jax_ingest(jparams["video_encoder"], jnp.asarray(u8), jcfg.encoder, compute_dtype=jnp.float32)
    with torch.no_grad():
        out = ingest_video_tokens(model.video_encoder, torch.from_numpy(u8))
    check(out, ref, 1e-5)  # measured 4.9e-6


@pytest.mark.parametrize("source", ["uint8", "float"])
def test_encode_windows_matches_jax(source):
    """T=8 at window 4 / stride 2: three windows, encoded in chunks of 2 + 1."""
    from l4p_tpu.models.l4p import encode_windows as jax_encode_windows

    jcfg, jparams, pcfg, model = tiny_models()
    if source == "uint8":
        u8 = video_u8(8)
        ref = jax_encode_windows(jparams["video_encoder"], jcfg, None, rgb_u8_bthw3=jnp.asarray(u8))
        args = dict(rgb_u8_bthw3=torch.from_numpy(u8))
    else:
        x = rand((1, 3, 8, 28, 28), 2)
        ref = jax_encode_windows(jparams["video_encoder"], jcfg, jnp.asarray(x))
        args = dict(rgb_b3thw=torch.from_numpy(x))
    with torch.no_grad():
        out = encode_windows(model.video_encoder, pcfg, **args)
    assert sorted(out["hooks"]) == sorted(ref["hooks"])
    for h in ref["hooks"]:
        check(out["hooks"][h], ref["hooks"][h], 1.1e-5, f"hook {h}")  # measured <= 5.6e-6
    check(out["final"], ref["final"], 1.1e-5, "final")


def test_encode_windows_rejects_untiled_video():
    _, _, pcfg, model = tiny_models()
    with pytest.raises(ValueError, match="not tiled"):
        encode_windows(model.video_encoder, pcfg, rgb_u8_bthw3=torch.from_numpy(video_u8(7)))


def test_params_from_jax_loads_strictly_with_the_alias_keys():
    from l4p_tpu.config import init_l4p_params
    from tests.test_l4p_forward import tiny_cfg

    pcfg = tiny_port_cfg()
    tree = jax.tree.map(np.asarray, init_l4p_params(tiny_cfg(), jax.random.PRNGKey(1), tasks=ALL_TASKS))
    sd = params_from_jax(tree, pcfg)
    model = L4P(pcfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    for name, _ in pcfg.heads:
        pre = f"task_heads.{name}.task_head.dpt.scratch."
        for i in range(4):
            assert torch.equal(sd[f"{pre}layer_rn.{i}.weight"], sd[f"{pre}layer{i + 1}_rn.weight"])
    qkv = tree["video_encoder"]["blocks"]["qkv_w"][2]  # (3, E, E)
    assert torch.equal(model.video_encoder.blocks[2].attn.qkv.weight, torch.from_numpy(np.array(qkv).reshape(-1, qkv.shape[-1])))
