"""The port's SAM decoder (models/sam.py) against the JAX package's (fp32, CPU):
dense positional encoding, prompt encoder, the two-way transformer on each
schedule and the mask decoder, with the weights carried across by the
port's checkpoint conversion. The two-way fixture is tests/test_fused_keys.py's
(C = 128, P = 4 x 8 x 8 = 256, 8 heads, 6 tokens)."""

import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from l4p_tpu_torch.checkpoint import _track_state
from l4p_tpu_torch.models import sam as PS
from l4p_tpu_torch.models.track import TrackHead
from tests.test_torch_ops import check, port_track_config, rand

torch.set_num_threads(1)

N = 3


@functools.lru_cache(maxsize=None)
def models(seed: int = 3):
    """(JAX track config, JAX params, port config, port head) on the same weights."""
    from l4p_tpu.models.sam import SamConfig
    from l4p_tpu.models.track import TrackConfig, init_track_params

    sam = SamConfig(embed_dim=128, image_embedding_size=(4, 8, 8), input_image_size=(8, 112, 112), num_heads=8,
                    mlp_dim=64, attention_downsample_rate=2)
    jcfg = TrackConfig(image_size=(8, 112, 112), patch_size=(2, 14, 14), sam=sam)
    params = init_track_params(jcfg, jax.random.PRNGKey(seed))
    pcfg = port_track_config(jcfg)
    head = TrackHead(pcfg)
    head.load_state_dict(_track_state(jax.tree.map(np.asarray, params), pcfg), strict=True)
    return jcfg, params, pcfg, head.eval()


@functools.lru_cache(maxsize=None)
def twoway_inputs(seed: int = 3):
    """image (N, P, C), image PE (1, P, C), tokens (N, 6, C), as numpy."""
    jcfg, params, _, _ = models()
    from l4p_tpu.models.sam import dense_pe

    sam = jcfg.sam
    p, c = sam.num_video_tokens, sam.embed_dim
    pe = np.array(dense_pe(params["prompt_encoder"], sam))
    return rand((N, p, c), seed + 1) * 0.5, pe.reshape(1, c, -1).transpose(0, 2, 1), rand((N, 6, c), seed + 3) * 0.5


def test_dense_pe_matches_jax():
    from l4p_tpu.models.sam import dense_pe

    jcfg, params, pcfg, head = models()
    with torch.no_grad():
        out = PS.dense_pe(head.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix, pcfg.sam)
    assert out.shape == (1, 128, 4, 8, 8)
    check(out, dense_pe(params["prompt_encoder"], jcfg.sam), 1e-7)  # measured 4.0e-8


@pytest.mark.parametrize("with_features", [True, False])
def test_prompt_encoder_matches_jax(with_features):
    """Every label (-1 padding, 0 invalid, 1 input, 2 predicted) on the
    points, and feature prompts with labels 0 and 1 or the zero default."""
    from l4p_tpu.models.sam import prompt_encoder_apply

    jcfg, params, pcfg, head = models()
    points = np.stack([rand((8,), 0, 0, 8), rand((8,), 1, 0, 112), rand((8,), 2, 0, 112)], -1)[:, None]
    labels = np.array([-1, 0, 1, 2, 1, 0, 2, -1], np.float32)[:, None]
    feats = rand((8, 1, 128), 3) if with_features else None
    feat_labels = np.array([0, 1, 1, 0, 0, 1, 1, 0], np.float32)[:, None] if with_features else None
    ref = prompt_encoder_apply(params["prompt_encoder"], jcfg.sam, jnp.asarray(points), jnp.asarray(labels),
                               None if feats is None else jnp.asarray(feats),
                               None if feat_labels is None else jnp.asarray(feat_labels))
    with torch.no_grad():
        out = PS.prompt_encoder_apply(head.prompt_encoder, pcfg.sam, torch.from_numpy(points),
                                      torch.from_numpy(labels), None if feats is None else torch.from_numpy(feats),
                                      None if feat_labels is None else torch.from_numpy(feat_labels))
    assert out.shape == (8, 3, 128)  # point, padding point, feature
    check(out, ref, 1.2e-7)  # measured <= 5.7e-8


@pytest.mark.parametrize("port_impl,jax_impl", [
    ("naive", "naive"),
    ("factored", "factored"),
    ("streamed", "streamed_interpret"),  # the port's wrappers (plain on the CPU) vs the Pallas kernels
    ("streamed", "naive"),  # the reassociated schedule against the direct transcription
])
def test_twoway_transformer_matches_jax(port_impl, jax_impl):
    from l4p_tpu.models.sam import twoway_transformer_apply

    jcfg, params, pcfg, head = models()
    img, pos, tokens = twoway_inputs()
    qj, kj = twoway_transformer_apply(params["mask_decoder"]["transformer"], jcfg.sam, jnp.asarray(img),
                                      jnp.asarray(pos), jnp.asarray(tokens), impl=jax_impl)
    with torch.no_grad():
        qp, kp = PS.twoway_transformer_apply(head.mask_decoder.transformer, pcfg.sam, torch.from_numpy(img),
                                             torch.from_numpy(pos), torch.from_numpy(tokens), impl=port_impl)
    # measured <= 6.6e-7 (queries) and 7.6e-7 (keys) on every pair
    check(qp, qj, 1.5e-6, "queries")
    check(kp, kj, 1.5e-6, "keys")


def test_streamed_takes_the_kernels_given():
    """`impl='streamed'` runs the kernel functions it is given and
    'factored' the plain versions, which give the same result on the CPU."""
    _, _, pcfg, head = models()
    img, pos, tokens = (torch.from_numpy(a) for a in twoway_inputs())
    calls = []

    def counted(fn):
        def wrapped(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    kernels = PS.TrackKernels(counted(PS.t2i_flash_plain), counted(PS.i2t_ln_t2i_plain), PS.fused_upscale_hypernet)
    tf = head.mask_decoder.transformer
    with torch.no_grad():
        got = PS.twoway_transformer_apply(tf, pcfg.sam, img, pos, tokens, "streamed", kernels)
        want = PS.twoway_transformer_apply(tf, pcfg.sam, img, pos, tokens, "factored")
    assert calls == ["t2i_flash_plain", "i2t_ln_t2i_plain", "i2t_ln_t2i_plain"]  # one t2i, one i2t per layer
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="unknown"):
        PS.twoway_transformer_apply(tf, pcfg.sam, img, pos, tokens, "fused")


@pytest.mark.parametrize("shared", [False, True])
def test_mask_decoder_matches_jax(shared):
    """Per-query image embeddings (N, P, C), and one (1, P, C) shared by the
    queries; logits (N, 3, 8, 32, 32) and the processed tokens."""
    from l4p_tpu.models.sam import dense_pe, mask_decoder_apply

    jcfg, params, pcfg, head = models()
    img, _, tokens = twoway_inputs()
    img = img[:1] if shared else img
    pe = dense_pe(params["prompt_encoder"], jcfg.sam)
    ref, ref_proc = mask_decoder_apply(params["mask_decoder"], jcfg.sam, jnp.asarray(img), pe,
                                       jnp.asarray(tokens[:, :3]))
    with torch.no_grad():
        out, proc = PS.mask_decoder_apply(head.mask_decoder, pcfg.sam, torch.from_numpy(img),
                                          torch.from_numpy(np.array(pe)), torch.from_numpy(tokens[:, :3]))
    assert out.shape == (N, 3, 8, 32, 32) and out.dtype == torch.float32
    # measured <= 1.1e-7 (logits), 5.8e-7 (io_features), 5.7e-7 (enc_features)
    check(out, ref, 2.5e-7, "logits")
    check(proc["io_features"], ref_proc["io_features"], 1.2e-6, "io_features")
    check(proc["enc_features"], ref_proc["enc_features"], 1.2e-6, "enc_features")
