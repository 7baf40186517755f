"""The port's whole-encoder blocks (ops/fused_encoder.py) vs the JAX
package's `fused_encoder_blocks` (the Pallas kernel in interpret mode) and
its XLA block path, at the JAX test's shapes (tests/test_fused_encoder.py);
the encoder forward and window encoding with `fused_encoder=True`; and the
kernel path's gate (fp32, CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l4p_tpu_torch.checkpoint import _encoder_state
from l4p_tpu_torch.config import EncoderConfig
from l4p_tpu_torch.models.encoder import VideoEncoder
from l4p_tpu_torch.models.l4p import encode_windows
from l4p_tpu_torch.ops import fused_encoder as FE
from tests.test_torch_ops import _same, check, rand

torch.set_num_threads(1)


def jax_cfg(**kw):
    """tests/test_fused_encoder.py's _cfg: D = 64 heads, interpret mode."""
    from l4p_tpu.models.encoder import EncoderConfig as JaxEncoderConfig

    base = dict(img_size=32, patch_size=8, embed_dim=256, depth=3, num_heads=4, mlp_ratio=12.0, all_frames=4,
                use_flash_attention=False, flash_interpret=True)
    base.update(kw)
    return JaxEncoderConfig(**base)


def port_encoder(jcfg, params, **kw) -> VideoEncoder:
    """The port's encoder on the JAX parameters."""
    cfg = _same(EncoderConfig, jcfg, **kw)
    enc = VideoEncoder(cfg)
    enc.load_state_dict(_encoder_state(jax.tree.map(np.asarray, params), cfg), strict=True)
    return enc.eval()


@pytest.mark.parametrize("kw,n,bsz,hooks", [
    (dict(), 512, 1, (2, 3)),  # hidden 3072: two MLP chunks of the TPU kernel
    (dict(mlp_ratio=2.0, depth=2), 256, 2, (1, 2)),
])
def test_fused_encoder_blocks_match_jax_kernel_and_xla(kw, n, bsz, hooks):
    from l4p_tpu.models.encoder import init_encoder_params
    from l4p_tpu.ops.fused_encoder import _run_blocks_xla, fused_encoder_blocks

    jcfg = jax_cfg(**kw)
    params = init_encoder_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    x = rand((bsz, n, jcfg.embed_dim), 1)
    kernel = fused_encoder_blocks(params, jnp.asarray(x), jcfg, hooks)
    xla = _run_blocks_xla(params, jnp.asarray(x), jcfg, hooks)
    enc = port_encoder(jcfg, params)
    with torch.no_grad():
        out = FE.fused_encoder_blocks(enc.blocks, torch.from_numpy(x), enc.cfg, hooks)
        plain = FE.fused_encoder_blocks_plain(enc.blocks, torch.from_numpy(x), enc.cfg, hooks)
    assert out.shape == (bsz, len(hooks), n, jcfg.embed_dim)
    assert torch.equal(out, plain)  # on the CPU the wrapper is the plain version
    # measured <= 2.4e-6 against either
    check(out, kernel, 5e-6, "interpret-mode kernel")
    check(out, xla, 5e-6, "XLA blocks")


def test_encoder_with_fused_encoder_matches_jax_encoder_apply():
    """The encoder forward with `fused_encoder=True` against JAX
    `encoder_apply` with the fused gate on (tests/test_fused_encoder.py:96-114):
    hooks 0-3, the final LayerNorm and the position table included."""
    from l4p_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
    from l4p_tpu.models.encoder import encoder_apply, fused_encoder_engaged, init_encoder_params

    jcfg = JaxEncoderConfig(img_size=112, patch_size=14, embed_dim=256, depth=3, num_heads=4, mlp_ratio=2.0,
                            all_frames=8, tubelet_size=2, use_flash_attention=False, fused_encoder=True,
                            flash_interpret=True)
    params = init_encoder_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    assert fused_encoder_engaged(jcfg, params, jcfg.num_tokens, jnp.float32)
    x = 0.5 * rand((2, 3, 8, 112, 112), 2)
    ref = encoder_apply(params, jnp.asarray(x), jcfg, hooks=(0, 1, 2, 3), want_final=True)
    enc = port_encoder(jcfg, params)
    calls = []

    def spy(blocks, tokens, cfg, ends):
        calls.append(tuple(ends))
        return FE.fused_encoder_blocks(blocks, tokens, cfg, ends)

    with torch.no_grad():
        out = enc(enc.embed(torch.from_numpy(x)), (0, 1, 2, 3), encoder_blocks=spy)
    assert calls == [(1, 2, 3)]
    for i, (p, r) in enumerate(zip(out["hooks"] + [out["final"]], ref["hooks"] + [ref["final"]])):
        check(p, r, 6e-6, f"output {i}")  # measured <= 3.0e-6


def test_encode_windows_with_fused_encoder_encodes_every_window_at_once():
    """T = 8 at window 4 / stride 2: three windows in one `encoder_blocks`
    call of batch 3 (not chunks of 2 + 1), with the outputs of the default
    path."""
    from tests.test_torch_encoder import tiny_models, video_u8

    _, _, pcfg, model = tiny_models()
    fused = dataclasses.replace(pcfg, encoder=dataclasses.replace(pcfg.encoder, fused_encoder=True))
    batches = []

    def spy(blocks, tokens, cfg, ends):
        batches.append(tokens.shape[0])
        return FE.fused_encoder_blocks_plain(blocks, tokens, cfg, ends)

    u8 = torch.from_numpy(video_u8(8))
    with torch.no_grad():
        ref = encode_windows(model.video_encoder, pcfg, rgb_u8_bthw3=u8, encoder_blocks=spy)
        assert batches == []  # the default encoder never calls it
        out = encode_windows(model.video_encoder, fused, rgb_u8_bthw3=u8, encoder_blocks=spy)
    assert batches == [3]
    # one batch of 3 instead of 2 + 1 only changes how the CPU matmuls block
    # their sums: measured <= 8.5e-7
    for h in ref["hooks"]:
        check(out["hooks"][h], ref["hooks"][h], 1.7e-6, f"hook {h}")
    check(out["final"], ref["final"], 1.7e-6, "final")


@pytest.mark.parametrize("kw,dtype,device,match", [
    (dict(), torch.float32, "cuda", "bf16"),
    (dict(embed_dim=200, num_heads=2), torch.bfloat16, "cuda", "head_dim"),  # D = 100
    (dict(embed_dim=96, num_heads=8), torch.float32, "cpu", "head_dim"),  # D = 12
    (dict(embed_dim=128, num_heads=1), torch.bfloat16, "cuda", "head_dim"),  # D = 128
    (dict(mlp_ratio=4.1), torch.bfloat16, "cuda", "multiples of 8"),  # MLP width 262
    (dict(embed_dim=66, num_heads=4), torch.float32, "cpu", "num_heads"),  # E is not heads x D
])
def test_gate_names_the_condition(kw, dtype, device, match):
    cfg = dataclasses.replace(EncoderConfig(embed_dim=64, num_heads=4, depth=1, mlp_ratio=4.0), **kw)
    reason = FE.fused_encoder_unsupported(cfg, dtype, torch.device(device))
    assert reason is not None and match in reason
    if device == "cpu":  # the wrapper refuses it on the CPU as on the card
        enc = VideoEncoder(cfg)
        with pytest.raises(ValueError, match=match):
            FE.fused_encoder_blocks(enc.blocks, torch.zeros((1, 4, cfg.embed_dim)), cfg, (1,))


def test_gate_passes_the_released_encoder_and_checks_hook_ends():
    from l4p_tpu_torch.config import GIANT

    assert FE.fused_encoder_unsupported(GIANT, torch.bfloat16, torch.device("cuda")) is None
    assert FE.fused_encoder_unsupported(GIANT, torch.float32, torch.device("cpu")) is None
    cfg = EncoderConfig(embed_dim=64, num_heads=4, depth=2, mlp_ratio=4.0)
    enc = VideoEncoder(cfg)
    x = torch.zeros((1, 4, 64))
    for ends in ((), (2, 1), (0, 2), (1, 3)):
        with pytest.raises(ValueError, match="hook_ends"):
            FE.fused_encoder_blocks(enc.blocks, x, cfg, ends)


def test_linear_gelu_plain_on_the_cpu():
    a, w, b = (torch.from_numpy(rand(s, i)) for i, s in enumerate(((5, 24), (16, 24), (16,))))
    ref = torch.nn.functional.gelu(a @ w.T + b)  # fp32: the exact erf lane
    got = FE.gemm_nt(a, w, b, FE.GELU, torch.empty((5, 16)))  # the fc1 step, its plain version on the CPU
    assert torch.equal(got, FE.linear_gelu_plain(a, w, b))
    check(got, ref.numpy(), 1e-6)


@pytest.mark.parametrize("n,want", [(4224, 176), (1408, 176), (6144, 256), (1400, 176), (8, 176), (512, 256),
                                    (576, 176), (264, 176)])
def test_gemm_tile_width_takes_the_widest_divisor_else_the_least_padding(n, want):
    """The giant widths (qkv 4224, proj/fc2 1408, fc1 6144) and ragged ones."""
    assert FE.gemm_tile_width(n) == want and want in FE.GEMM_TILE_WIDTHS


@pytest.mark.parametrize("epilogue", ["QKV", "GELU", "RESIDUAL"])
def test_gemm_nt_on_the_cpu_is_its_plain_version(epilogue):
    """What each epilogue writes, against float64 numpy: QKV the head-major
    (3, B, H, tokens, pitch) rows with the pad left alone, GELU the fp32
    (exact erf) lane, RESIDUAL in place on the stream and into copy_out."""
    from scipy.special import erf

    from l4p_tpu_torch.ops.flash_attention import kernel_row_pitch

    m, k, tokens, heads, hd = 12, 24, 6, 2, 8
    n = 3 * heads * hd if epilogue == "QKV" else 16
    a, w, bias, x = (rand(s, i) for i, s in enumerate(((m, k), (n, k), (n,), (m, n))))
    y = a.astype(np.float64) @ w.T.astype(np.float64) + bias
    ta, tw, tb = (torch.from_numpy(t) for t in (a, w, bias))
    if epilogue == "QKV":
        out = torch.full((3, m // tokens, heads, tokens, kernel_row_pitch(hd)), float("nan"))
        assert FE.gemm_nt(ta, tw, tb, FE.QKV, out, tokens=tokens, heads=heads, head_dim=hd) is out
        want = y.reshape(m // tokens, tokens, 3, heads, hd).transpose(2, 0, 3, 1, 4)
        check(out[..., :hd], want, 1e-6, "q/k/v rows")
        assert torch.isnan(out[..., hd:]).all()
        plain = FE.gemm_nt_plain(ta, tw, tb, FE.QKV, torch.full_like(out, float("nan")), None, tokens, heads, hd)
    elif epilogue == "GELU":
        out = FE.gemm_nt(ta, tw, tb, FE.GELU, torch.empty((m, n)))
        check(out, 0.5 * y * (1 + erf(y / np.sqrt(2))), 1e-6, "GELU")
        plain = FE.gemm_nt_plain(ta, tw, tb, FE.GELU, torch.empty((m, n)))
    else:
        out, copy_out = torch.from_numpy(x.copy()), torch.empty((m, n))
        FE.gemm_nt(ta, tw, tb, FE.RESIDUAL, out, copy_out)
        check(out, x + y, 1e-6, "residual stream")
        assert torch.equal(copy_out, out)
        plain = FE.gemm_nt_plain(ta, tw, tb, FE.RESIDUAL, torch.from_numpy(x.copy()))
    assert torch.equal(out.nan_to_num(7.0), plain.nan_to_num(7.0))  # QKV's pad stays NaN in both


def test_gemm_nt_refuses_what_the_kernel_does_not_take():
    a, w, bias = torch.zeros((4, 16)), torch.zeros((48, 16)), torch.zeros((48,))
    with pytest.raises(ValueError, match="do not fit"):
        FE.gemm_nt(a, w, bias, FE.GELU, torch.zeros((4, 40)))  # out of another width
    with pytest.raises(ValueError, match="do not fit"):
        FE.gemm_nt(a, w, bias, FE.GELU, torch.zeros((4, 48)), copy_out=torch.zeros((4, 48)))  # copy_out: RESIDUAL only
    with pytest.raises(ValueError, match="3 x heads"):
        FE.gemm_nt(a, w, bias, FE.QKV, torch.zeros((3, 1, 2, 4, 16)), tokens=4, heads=2, head_dim=4)  # 48 != 24
    with pytest.raises(ValueError, match="multiple of 8"):
        FE.gemm_nt(a, w[:36], bias[:36], FE.QKV, torch.zeros((3, 1, 6, 4, 16)), tokens=4, heads=6, head_dim=2)
    with pytest.raises(ValueError, match="unknown epilogue"):
        FE.gemm_nt(a, w, bias, 7, torch.zeros((4, 48)))
    with pytest.raises(ValueError, match="incompatible"):
        FE.gemm_nt(a, w[:, :8], bias, FE.GELU, torch.zeros((4, 48)))
