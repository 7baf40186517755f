"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and CUDA (tests/conftest.py imports jax, hence
--noconftest there):

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q
"""

import pytest
import torch

from l4p_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from l4p_tpu_torch.ops import fused_keys as FK
from l4p_tpu_torch.ops import fused_upscale as FU


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,nk", [((2, 16, 2048, 88), 2048), ((1, 8, 512, 64), 512), ((1, 2, 1000, 88), 1000),
                                      ((1, 4, 300, 128), 300),
                                      # one tile each: a fault of the TMA boxes or the wgmma descriptors
                                      # shows here first, at D_pad 96 (three swizzle atoms) and 128 (four)
                                      ((1, 1, 64, 88), 64), ((1, 1, 64, 128), 64),
                                      ((5, 16, 2048, 88), 2048)])  # bench.py's fused shape: 80 heads
def test_kernel_matches_plain_on_card(cuda, shape, nk):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, h, nq, d = shape
    q = torch.randn(shape, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((b, h, nk, d), generator=g, device=cuda).bfloat16() for _ in range(2))
    before = flash_attention.launches
    out = flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    plain = flash_attention_plain(q, k, v, d ** -0.5)
    # bf16 band: both round the output and the probabilities to bf16, the
    # kernel before normalising, the plain version after; measured <= 3.9e-3
    # on an H100 for N(0, 1) inputs (the wgmma kernel: 3.9e-3 on one tile and
    # at N=300, 2.0e-3 at N=2048)
    assert (out.float() - plain.float()).abs().max().item() <= 8e-3


@pytest.mark.gpu
def test_encoder_attention_head_major_matches_plain_on_card(cuda):
    """The fused encoder's entry point: q/k/v head-major in one (3, B, H, N, D)
    buffer, each head's rows its own tensor-map rows (N = 300 is ragged: a
    box past a head's last row must read zeros, not the next head), the
    output written token-major (B, N, H * D)."""
    from l4p_tpu_torch.ops import fused_encoder as FE

    from l4p_tpu_torch.ops.flash_attention import kernel_row_pitch

    b, h, n, d = 2, 3, 300, 88
    g = torch.Generator(device=cuda).manual_seed(3)
    # the QKV epilogue's layout: rows kernel_row_pitch(d) = 96 apart, the pad never read
    qkv = torch.full((3, b, h, n, kernel_row_pitch(d)), float("nan"), device=cuda, dtype=torch.bfloat16)
    qkv[..., :d] = torch.randn((3, b, h, n, d), generator=g, device=cuda).bfloat16()
    qkv = qkv[..., :d]
    out = torch.empty((b, n, h * d), device=cuda, dtype=torch.bfloat16)
    err = FE._kernels()[2](qkv.data_ptr(), out.data_ptr(), b, h, n, d, d ** -0.5,
                           torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    plain = flash_attention_plain(qkv[0], qkv[1], qkv[2], d ** -0.5).transpose(1, 2).reshape(b, n, h * d)
    assert (out.float() - plain.float()).abs().max().item() <= 8e-3  # the band above


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 16, 2048, 88), (1, 2, 300, 88), (1, 1, 64, 120)])
def test_kernel_on_padded_rows_matches_plain_on_card(cuda, shape):
    """q/k/v as the default encoder hands them over (kernel_layout: rows
    padded to a multiple of 16 elements, the pad NaN so that a read of it
    would show)."""
    from l4p_tpu_torch.ops.flash_attention import kernel_layout, kernel_row_pitch

    g = torch.Generator(device=cuda).manual_seed(4)
    d = shape[3]

    def padded():
        x = kernel_layout(torch.randn(shape, generator=g, device=cuda).bfloat16())
        x.as_strided((*shape[:3], kernel_row_pitch(d)), x.stride())[..., d:] = float("nan")
        return x

    q, k, v = padded(), padded(), padded()
    assert q.stride(2) == kernel_row_pitch(d)
    out = flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert (out.float() - flash_attention_plain(q, k, v, d ** -0.5).float()).abs().max().item() <= 8e-3


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,h,d", [(2, 2048, 16, 88), (1, 300, 3, 88), (1, 64, 2, 128)])
def test_kernel_on_strided_views_matches_plain_on_card(cuda, b, n, h, d):
    """q/k/v as the default encoder's block hands them over: strided views of
    one (B, N, 3, H, D) projection, which the wrapper copies into padded rows."""
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn((b, n, 3, h, d), generator=g, device=cuda).bfloat16().permute(2, 0, 3, 1, 4)
    before = flash_attention.launches
    out = flash_attention(qkv[0], qkv[1], qkv[2], d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and out.is_contiguous()
    plain = flash_attention_plain(qkv[0], qkv[1], qkv[2], d ** -0.5)
    assert (out.float() - plain.float()).abs().max().item() <= 8e-3  # the band of test_kernel_matches_plain_on_card


@pytest.mark.gpu
def test_kernel_raises_instead_of_falling_back(cuda):
    q = torch.zeros(1, 2, 64, 88, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q, q, q, 0.1)  # fp32
    qb = torch.zeros(1, 2, 64, 12, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(qb, qb, qb, 0.1)  # D not a multiple of 8: no TMA row of whole 16-byte units
    qb = torch.zeros(1, 2, 64, 88, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(qb, qb.cpu(), qb, 0.1)  # two devices


# bf16 bands of the track-head kernels against their plain versions on the same
# bf16 inputs: max |kernel - plain| <= BAND * max |plain| (see each kernel's
# rounding points in its source header)
KEYS_BAND = 2e-2
UPSCALE_BAND = 2e-2


def keys_operands(n, p, c, k, k2, cuda, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def r(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=cuda) * scale).to(dtype)

    return dict(keys=r(n, p, c), st=r(n, c, k2, scale=c ** -0.5), spe=r(n, p, k2, dtype=torch.float32),
                r=r(n, c, k, scale=c ** -0.5), per=r(n, p, k, dtype=torch.float32), v2=r(n, k, c, scale=0.2),
                ob=r(c, scale=0.1), lnw=1.0 + r(c, scale=0.1), lnb=r(c, scale=0.1))


def band_err(out, plain):
    return (out.float() - plain.float()).abs().max().item() / plain.float().abs().max().item()


# (N, P, C, K, K2, heads): the giant width; a ragged P at C = 128; one query;
# P off the 128-row tile (127, 129, 1000); K = 16 and 64; K2 != K; 4 heads;
# C = 2816, where a cluster takes 16 blocks
KEYS_SHAPES = [(4, 2048, 1408, 48, 48, 8), (3, 1000, 128, 48, 32, 8), (1, 2048, 1408, 48, 48, 8),
               (2, 127, 1408, 48, 48, 8), (2, 129, 256, 64, 16, 4), (1, 1000, 1408, 16, 64, 4),
               (2, 300, 2816, 48, 32, 8)]
# the kernels and their plain versions against the plain version on fp32
# copies of the same bf16 operands: the kernel's mean |error| within this
# factor of the plain version's (chip_smoke.py's KEYS_WITNESS_SLACK)
KEYS_WITNESS_SLACK = 1.1


@pytest.mark.gpu
@pytest.mark.parametrize("n,p,c,k,k2,heads", KEYS_SHAPES)
def test_t2i_flash_matches_plain_on_card(cuda, n, p, c, k, k2, heads):
    o = keys_operands(n, p, c, k, k2, cuda)
    before = FK.t2i_flash.launches
    out = FK.t2i_flash(o["keys"], o["st"], o["spe"])
    torch.cuda.synchronize()
    assert FK.t2i_flash.launches == before + 1
    assert out.shape == (n, k2, c) and bool(torch.isfinite(out).all())
    err = band_err(out, FK.t2i_flash_plain(o["keys"], o["st"], o["spe"]))
    print(f"t2i_flash {(n, p, c, k2)}: max|kernel - plain| / max|plain| = {err:.3g}")
    assert err <= KEYS_BAND


@pytest.mark.gpu
def test_t2i_flash_at_its_widest_matches_plain_on_card(cuda):
    """C = 4096: 16 blocks of 256 columns, wider than i2t_ln_t2i's blocks."""
    o = keys_operands(2, 300, 4096, 48, 48, cuda)
    err = band_err(FK.t2i_flash(o["keys"], o["st"], o["spe"]), FK.t2i_flash_plain(o["keys"], o["st"], o["spe"]))
    print(f"t2i_flash (2, 300, 4096, 48): max|kernel - plain| / max|plain| = {err:.3g}")
    assert err <= KEYS_BAND


@pytest.mark.gpu
@pytest.mark.parametrize("n,p,c,k,k2,heads", KEYS_SHAPES)
def test_i2t_ln_t2i_matches_plain_on_card(cuda, n, p, c, k, k2, heads):
    o = keys_operands(n, p, c, k, k2, cuda, seed=1)
    args = [o[x] for x in ("keys", "r", "per", "v2", "ob", "lnw", "lnb", "st", "spe")]
    before = FK.i2t_ln_t2i.launches
    keys_new, wsum = FK.i2t_ln_t2i(*args, heads)
    torch.cuda.synchronize()
    assert FK.i2t_ln_t2i.launches == before + 1
    assert bool(torch.isfinite(keys_new).all()) and bool(torch.isfinite(wsum).all())
    ref_keys, ref_wsum = FK.i2t_ln_t2i_plain(*args, heads)
    errs = band_err(keys_new, ref_keys), band_err(wsum, ref_wsum)
    print(f"i2t_ln_t2i {(n, p, c, k, k2, heads)}: keys {errs[0]:.3g}, wsum {errs[1]:.3g}")
    assert max(errs) <= KEYS_BAND


@pytest.mark.gpu
@pytest.mark.parametrize("n,p,c", [(4, 2048, 1408), (3, 1000, 128)])
def test_keys_kernels_no_farther_from_fp32_than_plain(cuda, n, p, c):
    o = keys_operands(n, p, c, 48, 48, cuda, seed=2)
    args = [o[x] for x in ("keys", "r", "per", "v2", "ob", "lnw", "lnb", "st", "spe")]
    f32 = [a.float() for a in args]
    pairs = {"t2i_flash": (FK.t2i_flash(o["keys"], o["st"], o["spe"]), FK.t2i_flash_plain(o["keys"], o["st"], o["spe"]),
                           FK.t2i_flash_plain(*f32[:1], *f32[7:]))}
    kernel, plain, exact = FK.i2t_ln_t2i(*args, 8), FK.i2t_ln_t2i_plain(*args, 8), FK.i2t_ln_t2i_plain(*f32, 8)
    pairs.update({"i2t_ln_t2i keys": (kernel[0], plain[0], exact[0]), "i2t_ln_t2i wsum": (kernel[1], plain[1], exact[1])})
    for name, (out, ref, ex) in pairs.items():
        off_k, off_p = ((x.float() - ex).abs().mean().item() for x in (out, ref))
        print(f"{name} {(n, p, c)} against fp32: mean |error| kernel {off_k:.3g}, plain {off_p:.3g}")
        assert off_k <= KEYS_WITNESS_SLACK * off_p


def upscale_operands(n, p, c, d1, d2, m, cuda, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=cuda) * scale).bfloat16()

    return (r(n, p, c), r(c, d1, 2, 2, 2, scale=c ** -0.5), r(d1, scale=0.1), 1.0 + r(d1, scale=0.1),
            r(d1, scale=0.1), r(d1, d2, 1, 2, 2, scale=d1 ** -0.5), r(d2, scale=0.1), r(n, m, d2, scale=0.1))


@pytest.mark.gpu
@pytest.mark.parametrize("n,p,c,d1,d2", [(2, 2048, 1408, 352, 176), (3, 200, 64, 24, 12)])
def test_fused_upscale_matches_plain_on_card(cuda, n, p, c, d1, d2):
    args = upscale_operands(n, p, c, d1, d2, 3, cuda)
    before = FU.fused_upscale_hypernet.launches
    out = FU.fused_upscale_hypernet(*args)
    torch.cuda.synchronize()
    assert FU.fused_upscale_hypernet.launches == before + 1
    err = band_err(out, FU.fused_upscale_hypernet_plain(*args))
    print(f"fused_upscale_hypernet {(n, p, c, d1, d2)}: max|kernel - plain| / max|plain| = {err:.3g}")
    assert err <= UPSCALE_BAND


@pytest.mark.gpu
@pytest.mark.parametrize("n,p,c,d1,d2,m", [
    (128, 2048, 1408, 352, 176, 3),  # the track head's chunk of 128 queries
    (1, 2048, 1408, 352, 176, 3),  # one query
    (2, 1000, 1408, 352, 176, 3), (2, 129, 256, 352, 176, 3), (3, 127, 64, 24, 12, 3),  # P off the 128-row tile
    (2, 300, 128, 352, 176, 1), (2, 300, 128, 352, 176, 4), (3, 200, 64, 24, 12, 4),  # M = 1 and 4
    (2, 96, 64, 20, 10, 1), (1, 64, 32, 20, 10, 3),  # d1, d2 off the kernel's padding
])
def test_fused_upscale_matches_plain_on_card_at_edges(cuda, n, p, c, d1, d2, m):
    args = upscale_operands(n, p, c, d1, d2, m, cuda, seed=n + p + m)
    before = FU.fused_upscale_hypernet.launches
    out = FU.fused_upscale_hypernet(*args)
    torch.cuda.synchronize()
    assert FU.fused_upscale_hypernet.launches == before + 1
    assert out.shape == (n, m, p, 8, 4) and bool(torch.isfinite(out).all())
    err = band_err(out, FU.fused_upscale_hypernet_plain(*args))
    print(f"fused_upscale_hypernet {(n, p, c, d1, d2, m)}: max|kernel - plain| / max|plain| = {err:.3g}")
    assert err <= UPSCALE_BAND


@pytest.mark.gpu
def test_track_kernels_raise_instead_of_falling_back(cuda):
    o = keys_operands(2, 64, 128, 48, 48, cuda)
    with pytest.raises(TypeError):
        FK.t2i_flash(o["keys"].float(), o["st"], o["spe"])  # fp32 keys
    with pytest.raises(ValueError):
        FK.t2i_flash(o["keys"].transpose(1, 2).contiguous().transpose(1, 2), o["st"], o["spe"])  # not contiguous
    args = [o[x] for x in ("keys", "r", "per", "v2", "ob", "lnw", "lnb", "st", "spe")]
    with pytest.raises(TypeError):
        FK.i2t_ln_t2i(args[0].float(), *args[1:], 8)
    with pytest.raises(ValueError):
        FK.i2t_ln_t2i(args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:], 8)
    # shapes the cluster launcher refuses (a block's columns beyond its
    # registers: C > 2816 for i2t_ln_t2i, C > 6144 for t2i_flash) raise, as
    # the row kernels before them refused C > 2352 and C > 6104
    wide = keys_operands(1, 128, 2832, 48, 48, cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        FK.i2t_ln_t2i(*(wide[x] for x in ("keys", "r", "per", "v2", "ob", "lnw", "lnb", "st", "spe")), 8)
    wider = keys_operands(1, 128, 6160, 16, 16, cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        FK.t2i_flash(wider["keys"], wider["st"], wider["spe"])
    up = upscale_operands(2, 64, 64, 24, 12, 3, cuda)
    with pytest.raises(TypeError):
        FU.fused_upscale_hypernet(up[0].float(), *up[1:])
    with pytest.raises(ValueError):
        FU.fused_upscale_hypernet(up[0].transpose(1, 2).contiguous().transpose(1, 2), *up[1:])
    wide = upscale_operands(2, 64, 64, 360, 12, 3, cuda)  # d1 above the kernel's 352
    with pytest.raises(ValueError, match="unsupported"):
        FU.fused_upscale_hypernet(*wide)


# per hook end: max |kernel - plain| <= band * max |plain hook|. Both paths
# round q/k/v, probabilities, GELU outputs and every residual add to bf16 but
# sum in other orders, so a value can land one bf16 step apart and the
# difference grows through the blocks. An H100 measured 1.65e-2 (hook 14) to
# 2.52e-2 (hook 36) at the giant shape and 6.1e-3 at the ragged one; the
# bands are about twice that (chip_smoke.py holds the same ones)
FUSED_ENCODER_BANDS = {14: 3.5e-2, 21: 4e-2, 28: 4.5e-2, 36: 5e-2, 40: 5e-2}
RAGGED_ENCODER_BAND = 1.2e-2


def random_blocks(cfg, cuda, seed=0):
    """The encoder's blocks in bf16 with Xavier weights and random biases and
    LayerNorm affines, so every bias and affine path of the kernels runs."""
    from l4p_tpu_torch.models.encoder import VideoEncoder

    g = torch.Generator(device=cuda).manual_seed(seed)
    enc = VideoEncoder(cfg, device=cuda, dtype=torch.bfloat16).eval()
    enc.init_weights(g)
    with torch.no_grad():
        for name, p in enc.blocks.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.02 * torch.randn(p.shape, generator=g, device=cuda))
            elif "norm" in name:
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g, device=cuda))
    return enc.blocks


@pytest.mark.gpu
@pytest.mark.parametrize("giant", [True, False])
def test_fused_encoder_blocks_match_plain_on_card(cuda, giant):
    """The giant width (2 windows of 2048 tokens, 40 blocks, the released
    hook ends) and a ragged small shape (N = 300 tokens, E = 256, D = 64)."""
    from l4p_tpu_torch.config import GIANT, EncoderConfig
    from l4p_tpu_torch.ops import fused_encoder as FE

    if giant:
        cfg, (b, n), ends = GIANT, (2, 2048), (14, 21, 28, 36, 40)
    else:
        cfg = EncoderConfig(embed_dim=256, num_heads=4, depth=2, mlp_ratio=4.0)
        (b, n), ends = (2, 300), (1, 2)
    blocks = random_blocks(cfg, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((b, n, cfg.embed_dim), generator=g, device=cuda).bfloat16()
    before, inner = FE.fused_encoder_blocks.launches, FE.fused_encoder_blocks.kernel_launches
    with torch.no_grad():
        out = FE.fused_encoder_blocks(blocks, x, cfg, ends)
        torch.cuda.synchronize()
        assert FE.fused_encoder_blocks.launches == before + 1
        assert FE.fused_encoder_blocks.kernel_launches == inner + FE.LAUNCHES_PER_BLOCK * ends[-1]
        ref = FE.fused_encoder_blocks_plain(blocks, x, cfg, ends)
    assert out.shape == ref.shape == (b, len(ends), n, cfg.embed_dim)
    for i, e in enumerate(ends):
        assert torch.isfinite(out[:, i]).all()
        err = band_err(out[:, i], ref[:, i])
        print(f"fused_encoder_blocks giant={giant} hook {e}: max|kernel - plain| / max|plain| = {err:.3g}")
        assert err <= (FUSED_ENCODER_BANDS[e] if giant else RAGGED_ENCODER_BAND), e


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(10240, 6144, 1408), (300, 264, 72)])
def test_linear_gelu_matches_plain_on_card(cuda, m, n, k):
    from l4p_tpu_torch.ops import fused_encoder as FE

    g = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn((m, k), generator=g, device=cuda).bfloat16()
    w = (torch.randn((n, k), generator=g, device=cuda) * k ** -0.5).bfloat16()
    bias = (0.1 * torch.randn((n,), generator=g, device=cuda)).bfloat16()
    before = FE.gemm_nt.launches
    out = FE.gemm_nt(a, w, bias, FE.GELU, torch.empty((m, n), device=cuda, dtype=torch.bfloat16))
    torch.cuda.synchronize()
    assert FE.gemm_nt.launches == before + 1
    # both round acc + bias and the GELU output to bf16 once; the sums differ in order
    err = band_err(out, FE.linear_gelu_plain(a, w, bias))
    print(f"gemm_nt GELU {(m, n, k)}: max|kernel - plain| / max|plain| = {err:.3g}")
    assert err <= 2e-2


# the blocks' GEMM (gemm_nt) against its plain version on the same bf16
# operands: max |kernel - plain| <= GEMM_BAND * max |plain|. Both round
# acc + bias (and the GELU output, and the residual add) to bf16 once and
# sum K in other orders, so a value can land one bf16 step apart
GEMM_BAND = 2e-2
GEMM_M, GEMM_N, GEMM_K = (1, 127, 129, 300), (8, 264, 1400), (8, 88, 1400, 6144)


def gemm_operands(m, n, k, cuda, seed=6):
    g = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randn((m, k), generator=g, device=cuda).bfloat16()
    w = (torch.randn((n, k), generator=g, device=cuda) * k ** -0.5).bfloat16()
    bias = (0.1 * torch.randn((n,), generator=g, device=cuda)).bfloat16()
    x = torch.randn((m, n), generator=g, device=cuda).bfloat16()  # a residual stream
    return a, w, bias, x


def run_gemm(epilogue, m, n, k, cuda, copy=False, tokens=1, heads=1, head_dim=2):
    """(kernel out, plain out[, kernel copy_out]) of one gemm_nt launch; a
    QKV output buffer starts as NaN, so a pad column that is written shows."""
    from l4p_tpu_torch.ops import fused_encoder as FE
    from l4p_tpu_torch.ops.flash_attention import kernel_row_pitch

    a, w, bias, x = gemm_operands(m, n, k, cuda)
    if epilogue == FE.QKV:
        shape = (3, m // tokens, heads, tokens, kernel_row_pitch(head_dim))
        out = torch.full(shape, float("nan"), device=cuda, dtype=torch.bfloat16)
    elif epilogue == FE.GELU:
        out = torch.empty((m, n), device=cuda, dtype=torch.bfloat16)
    else:
        out = x.clone()
    plain = out.clone()
    copy_out = torch.empty_like(out) if copy else None
    before = FE.gemm_nt.launches
    FE.gemm_nt(a, w, bias, epilogue, out, copy_out, tokens, heads, head_dim)
    torch.cuda.synchronize()
    assert FE.gemm_nt.launches == before + 1
    FE.gemm_nt_plain(a, w, bias, epilogue, plain, None, tokens, heads, head_dim)
    return out, plain, copy_out


@pytest.mark.gpu
@pytest.mark.parametrize("k", GEMM_K)
@pytest.mark.parametrize("n", GEMM_N)
@pytest.mark.parametrize("m", GEMM_M)
@pytest.mark.parametrize("epilogue", ["GELU", "RESIDUAL"])
def test_gemm_nt_matches_plain_on_card_at_ragged_shapes(cuda, epilogue, m, n, k):
    """M off the 128-row tile and below it, N off every tile width, K off the
    64-deep ring stage and below it: the tensor maps' zero fill and the
    store masks."""
    from l4p_tpu_torch.ops import fused_encoder as FE

    out, plain, _ = run_gemm(getattr(FE, epilogue), m, n, k, cuda)
    assert torch.isfinite(out).all()
    err = band_err(out, plain)
    print(f"gemm_nt {epilogue} {(m, n, k)}: max|kernel - plain| / max|plain| = {err:.3g}")
    assert err <= GEMM_BAND


@pytest.mark.gpu
@pytest.mark.parametrize("k", GEMM_K)
@pytest.mark.parametrize("heads,head_dim", [(1, 88), (2, 88), (1, 8)])
@pytest.mark.parametrize("m,tokens", [(1, 1), (127, 127), (129, 129), (300, 150)])
def test_gemm_nt_qkv_matches_plain_on_card_and_leaves_the_pad(cuda, m, tokens, heads, head_dim, k):
    """The QKV epilogue's head-major rows at D = 88 (pitch 96) and D = 8
    (pitch 16): the data columns match the plain version and the pad
    columns keep the NaN they started with (never written)."""
    from l4p_tpu_torch.ops import fused_encoder as FE

    out, plain, _ = run_gemm(FE.QKV, m, 3 * heads * head_dim, k, cuda, tokens=tokens, heads=heads,
                             head_dim=head_dim)
    assert torch.isnan(out[..., head_dim:]).all()
    assert torch.isfinite(out[..., :head_dim]).all()
    err = band_err(out[..., :head_dim], plain[..., :head_dim])
    print(f"gemm_nt QKV {(m, tokens, heads, head_dim, k)}: max|kernel - plain| / max|plain| = {err:.3g}")
    assert err <= GEMM_BAND


@pytest.mark.gpu
@pytest.mark.parametrize("epilogue,m,n,k", [
    # one output tile of each width, one or two ring stages: a fault of the
    # 128-byte swizzle, the wgmma descriptors or the TMA boxes shows here first
    ("GELU", 64, 176, 64), ("GELU", 128, 176, 64), ("GELU", 128, 256, 64), ("GELU", 64, 256, 128),
    ("RESIDUAL", 128, 176, 64), ("QKV", 128, 168, 64)])  # QKV: 3 x 1 head x D = 56, in one 176-wide tile
def test_gemm_nt_on_one_tile_matches_plain_on_card(cuda, epilogue, m, n, k):
    from l4p_tpu_torch.ops import fused_encoder as FE

    assert FE.gemm_tile_width(n) >= n
    qkv = dict(tokens=m, heads=1, head_dim=n // 3) if epilogue == "QKV" else {}
    out, plain, _ = run_gemm(getattr(FE, epilogue), m, n, k, cuda, **qkv)
    err = band_err(out[..., : n // 3] if qkv else out, plain[..., : n // 3] if qkv else plain)
    print(f"gemm_nt {epilogue} one tile {(m, n, k)}: max|kernel - plain| / max|plain| = {err:.3g}")
    assert err <= GEMM_BAND


@pytest.mark.gpu
@pytest.mark.parametrize("name,epilogue,n,k", [("qkv", "QKV", 4224, 1408), ("proj", "RESIDUAL", 1408, 1408),
                                               ("fc1", "GELU", 6144, 1408), ("fc2", "RESIDUAL", 1408, 6144)])
def test_gemm_nt_giant_block_products_match_plain_on_card(cuda, name, epilogue, n, k):
    """The four products of a giant block at M = 4096 (2 windows of 2048
    tokens), fc2 also writing its hook copy."""
    from l4p_tpu_torch.ops import fused_encoder as FE

    qkv = dict(tokens=2048, heads=16, head_dim=88) if epilogue == "QKV" else {}
    out, plain, copy_out = run_gemm(getattr(FE, epilogue), 4096, n, k, cuda, copy=name == "fc2", **qkv)
    if qkv:
        out, plain = out[..., :88], plain[..., :88]
    err = band_err(out, plain)
    print(f"gemm_nt {name} (4096, {n}, {k}): max|kernel - plain| / max|plain| = {err:.3g}")
    assert err <= GEMM_BAND
    if copy_out is not None:
        assert torch.equal(copy_out, out)


@pytest.mark.gpu
@pytest.mark.parametrize("copy", [False, True])
def test_gemm_nt_residual_updates_in_place(cuda, copy):
    """RESIDUAL adds onto the stream it is given, in place, and writes the
    same values into copy_out when asked; nothing else is written."""
    from l4p_tpu_torch.ops import fused_encoder as FE

    m, n, k = 300, 1400, 1400
    a, w, bias, x = gemm_operands(m, n, k, cuda)
    stream = x.clone()
    ptr = stream.data_ptr()
    copy_out = torch.full((m, n), float("nan"), device=cuda, dtype=torch.bfloat16) if copy else None
    assert FE.gemm_nt(a, w, bias, FE.RESIDUAL, stream, copy_out) is stream
    torch.cuda.synchronize()
    assert stream.data_ptr() == ptr
    plain = FE.gemm_nt_plain(a, w, bias, FE.RESIDUAL, x.clone())
    assert band_err(stream, plain) <= GEMM_BAND
    assert band_err(stream - x, plain - x) <= 2 * GEMM_BAND  # the added part itself, not only x
    if copy:
        assert torch.equal(copy_out, stream)


# the GEMM and its plain version against an fp32 product of the same bf16
# operands: the kernel's mean |error| within this factor of the plain
# version's (the other kernels' witnesses take the same slack)
GEMM_WITNESS_SLACK = 1.1


@pytest.mark.gpu
@pytest.mark.parametrize("epilogue,n,k", [("GELU", 6144, 1408), ("RESIDUAL", 1408, 6144)])
def test_gemm_nt_no_farther_from_fp32_than_plain(cuda, epilogue, n, k):
    from l4p_tpu_torch.ops import fused_encoder as FE

    m = 4096
    a, w, bias, x = gemm_operands(m, n, k, cuda)
    out, plain, _ = run_gemm(getattr(FE, epilogue), m, n, k, cuda)
    y = a.float() @ w.float().t() + bias.float()
    exact = torch.nn.functional.gelu(y, approximate="tanh") if epilogue == "GELU" else x.float() + y
    off = {name: (t.float() - exact).abs().mean().item() for name, t in (("kernel", out), ("plain", plain))}
    print(f"gemm_nt {epilogue} {(m, n, k)} against fp32: mean |error| {off} (ratio {off['kernel'] / off['plain']:.3g})")
    assert off["kernel"] <= GEMM_WITNESS_SLACK * off["plain"]


@pytest.mark.gpu
def test_gemm_nt_raises_instead_of_falling_back(cuda):
    from l4p_tpu_torch.ops import fused_encoder as FE

    a, w, bias, x = gemm_operands(64, 176, 64, cuda)
    out = torch.empty((64, 176), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        FE.gemm_nt(a[:, :60].contiguous(), w[:, :60].contiguous(), bias, FE.GELU, out)  # K = 60
    with pytest.raises(ValueError, match="bf16"):
        FE.gemm_nt(a.float(), w, bias, FE.GELU, out)
    with pytest.raises(ValueError, match="one CUDA device"):
        FE.gemm_nt(a.cpu(), w, bias, FE.GELU, out)
    qkv = torch.empty((3, 1, 4, 64, 16), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):  # D = 6: a 16-byte chunk would straddle heads
        FE.gemm_nt(a, w[:72].contiguous(), bias[:72].contiguous(), FE.QKV, qkv, tokens=64, heads=4, head_dim=6)
    shifted = torch.empty(64 * 64 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(64, 64).copy_(a)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    with pytest.raises(RuntimeError, match="launch failed"):
        FE.gemm_nt(shifted, w, bias, FE.GELU, out)  # no TMA map of a misaligned base
    # copy_out takes 16-byte stores and bias 4-byte loads: a contiguous but misaligned one is refused
    x_copy = torch.empty(64 * 176 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(64, 176)
    assert x_copy.is_contiguous() and x_copy.data_ptr() % 16 != 0
    with pytest.raises(RuntimeError, match="launch failed"):
        FE.gemm_nt(a, w, bias, FE.RESIDUAL, x.clone(), x_copy)
    odd_bias = torch.empty(177, device=cuda, dtype=torch.bfloat16)[1:].copy_(bias)
    assert odd_bias.is_contiguous() and odd_bias.data_ptr() % 4 != 0
    with pytest.raises(RuntimeError, match="launch failed"):
        FE.gemm_nt(a, w, odd_bias, FE.GELU, out)
    torch.cuda.synchronize()  # the refusals left no launch behind to fault
    # the entry point itself: a K off 8 and a tile width it was not built for
    gemm = FE._kernels()[1]
    stream = torch.cuda.current_stream().cuda_stream
    null = None
    assert gemm(a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), null, 64, 176, 60, FE.GELU, 1, 1, 2,
                176, stream) != 0
    assert gemm(a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), null, 64, 176, 64, FE.GELU, 1, 1, 2,
                128, stream) != 0
    assert gemm(a.data_ptr(), w.data_ptr(), bias.data_ptr(), qkv.data_ptr(), null, 64, 72, 64, FE.QKV, 64, 4, 6,
                176, stream) != 0  # the entry point refuses D = 6 too


@pytest.mark.gpu
def test_fused_encoder_raises_instead_of_falling_back(cuda):
    from l4p_tpu_torch.config import EncoderConfig
    from l4p_tpu_torch.ops import fused_encoder as FE

    cfg = EncoderConfig(embed_dim=128, num_heads=2, depth=1, mlp_ratio=4.0)
    blocks = random_blocks(cfg, cuda)
    x = torch.zeros((1, 64, 128), device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        FE.fused_encoder_blocks(blocks.float(), x, cfg, (1,))  # fp32
    with pytest.raises(ValueError, match="one CUDA device"):
        FE.fused_encoder_blocks(blocks, x.bfloat16().cpu(), cfg, (1,))  # x on the CPU, weights on the card
    wide = EncoderConfig(embed_dim=256, num_heads=2, depth=1, mlp_ratio=4.0)  # head_dim 128
    with pytest.raises(ValueError, match="head_dim"):
        FE.fused_encoder_blocks(random_blocks(wide, cuda), torch.zeros((1, 64, 256), device=cuda).bfloat16(), wide,
                                (1,))


def tiny_cfg():
    """The tests' tiny dims (tests/test_l4p_forward.py tiny_cfg), built in code:
    no YAML parser is promised where the card is."""
    import dataclasses

    from l4p_tpu_torch.config import EncoderConfig, L4PConfig, SamConfig, TrackConfig, default_dense_heads

    dpt = dict(hooks=(1, 2, 3, 4), layer_dims=(8, 8, 16, 16), feature_dim=8, last_dim=8, dim_tokens=64)
    heads = tuple((n, dataclasses.replace(h, dpt=dataclasses.replace(h.dpt, **dpt)))
                  for n, h in default_dense_heads().items())
    enc = EncoderConfig(img_size=28, patch_size=14, embed_dim=64, depth=4, num_heads=4, all_frames=4)
    track = TrackConfig(image_size=(4, 28, 28), max_queries=8,
                        sam=SamConfig(embed_dim=64, image_embedding_size=(2, 2, 2), input_image_size=(4, 28, 28)))
    return L4PConfig(encoder=enc, window_size=(4, 28, 28), window_stride_t=2, heads=heads, track=track)


@pytest.mark.gpu
def test_session_on_card_matches_plain_path(cuda):
    """The tiny model in bf16 on the card: 8 tokens per window (a ragged
    64-row tile), 3 windows in chunks of 2 + 1, 4 blocks each; 11 queries in
    chunks of 8, so the padding runs, through 3 windows each."""
    from l4p_tpu_torch import L4P, PLAIN, SLICE_TASKS, InferenceSession

    cfg = tiny_cfg()
    g = torch.Generator(device=cuda).manual_seed(0)
    model = L4P(cfg, device=cuda, dtype=torch.bfloat16).eval()
    model.init_weights(g)
    n = 11
    queries = torch.stack([torch.rand(n, generator=g, device=cuda) * 8,
                           torch.rand(n, generator=g, device=cuda) * 28,
                           torch.rand(n, generator=g, device=cuda) * 28], -1)[None]
    data = {"rgb_u8_bthw3": torch.randint(0, 256, (1, 8, 28, 28, 3), generator=g, device=cuda, dtype=torch.uint8),
            "track_2d_pointquerries_bn3": queries, "track_2d_pointlabels_bn": torch.ones((1, n), device=cuda)}
    counters = (flash_attention, FK.t2i_flash, FK.i2t_ln_t2i, FU.fused_upscale_hypernet)
    before = [f.launches for f in counters]
    out = InferenceSession(cfg, SLICE_TASKS, cuda)(model, data)
    chunks, nw = 2, 3
    assert [f.launches - b for f, b in zip(counters, before)] == [4 * 2, nw * chunks, 2 * nw * chunks, nw * chunks]
    ref = InferenceSession(cfg, SLICE_TASKS, cuda, attention=flash_attention_plain, track_kernels=PLAIN)(model, data)
    assert set(out) == set(ref)
    for k, r in ref.items():
        assert out[k].shape == r.shape and torch.isfinite(out[k]).all()
        # the band chip_smoke.py holds the giant model to, relative to the output's largest value
        assert (out[k].float() - r.float()).abs().max().item() <= 3e-2 * r.float().abs().max().item(), k


@pytest.mark.gpu
def test_all_task_session_with_fused_encoder_on_card_matches_plain_path(cuda):
    """The five tasks on the tiny model with encoder.fused_encoder (MLP width
    256, camray rays at the window's 4 frames): the 3 windows go through one
    fused_encoder_blocks call, and the session's outputs hold against its
    plain path; the RANSAC-chosen poses, K and Sim(3)-stitched depth are
    finite."""
    import dataclasses

    from l4p_tpu_torch import ALL_TASKS, L4P, PLAIN, InferenceSession
    from l4p_tpu_torch.ops import fused_encoder as FE

    cfg = tiny_cfg()
    heads = tuple((n, dataclasses.replace(h, dpt=dataclasses.replace(h.dpt, output_size=(4, 8, 8))))
                  if n == "camray" else (n, h) for n, h in cfg.heads)
    cfg = dataclasses.replace(cfg, heads=heads, encoder=dataclasses.replace(cfg.encoder, mlp_ratio=4.0,
                                                                             fused_encoder=True))
    g = torch.Generator(device=cuda).manual_seed(0)
    model = L4P(cfg, device=cuda, dtype=torch.bfloat16).eval()
    model.init_weights(g)
    n, t = 11, 8
    k = torch.diag(torch.tensor([28.0, 28.0, 1.0, 1.0], device=cuda))
    k[0, 2] = k[1, 2] = 14.0
    queries = torch.stack([torch.rand(n, generator=g, device=cuda) * t,
                           torch.rand(n, generator=g, device=cuda) * 28,
                           torch.rand(n, generator=g, device=cuda) * 28], -1)[None]
    data = {"rgb_u8_bthw3": torch.randint(0, 256, (1, t, 28, 28, 3), generator=g, device=cuda, dtype=torch.uint8),
            "intrinsics_b44t": k[None, :, :, None].expand(1, 4, 4, t).contiguous(),
            "track_2d_pointquerries_bn3": queries, "track_2d_pointlabels_bn": torch.ones((1, n), device=cuda)}
    counters = (FE.fused_encoder_blocks, flash_attention, FK.t2i_flash, FK.i2t_ln_t2i, FU.fused_upscale_hypernet)
    before = [f.launches for f in counters]
    inner = FE.fused_encoder_blocks.kernel_launches
    out = InferenceSession(cfg, ALL_TASKS, cuda)(model, data)
    chunks, nw = 2, 3
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 0, nw * chunks, 2 * nw * chunks, nw * chunks]
    assert FE.fused_encoder_blocks.kernel_launches - inner == FE.LAUNCHES_PER_BLOCK * cfg.encoder.depth
    ref = InferenceSession(cfg, ALL_TASKS, cuda, attention=flash_attention_plain, track_kernels=PLAIN,
                           encoder_blocks=FE.fused_encoder_blocks_plain)(model, data)
    assert set(out) == set(ref)
    for key, r in ref.items():
        assert out[key].shape == r.shape and torch.isfinite(out[key]).all() and torch.isfinite(r).all(), key
        if key != "depth_est_b1thw" and not key.startswith("traj3d"):
            assert (out[key].float() - r.float()).abs().max().item() <= 3e-2 * r.float().abs().max().item(), key


def dlt_normal_matrix(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """A^T A (..., 9, 9) of the Hartley-normalised DLT of 4-point samples
    src, dst (..., 4, 2), in float64."""
    def norm(p):
        p = p.double()
        m = p.mean(-2, keepdim=True)
        return (p - m) * (2 ** 0.5 / (p - m).norm(dim=-1).mean(-1))[..., None, None]

    s, t = norm(src), norm(dst)
    x, y, u, v = s[..., 0], s[..., 1], t[..., 0], t[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    a = torch.cat([torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1),
                   torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)], -2)
    return a.transpose(-1, -2) @ a


@pytest.mark.gpu
def test_homography_dlt_agrees_between_card_and_cpu(cuda):
    """The camera solve's DLT on the card and on the CPU: seeded 4-point
    samples, ill-conditioned ones among them, give the same H to 1e-6 of it,
    so that a RANSAC on each device puts every point on the same side of its
    threshold (chip_smoke phase 13 holds the two solves to 1e-3). Printed
    beside it, per conditioning quartile: how far the two devices' null
    vectors of A^T A lie apart when its eigh runs in fp32 (the JAX package's
    formulation) and in float64 (the port's)."""
    from l4p_tpu_torch.geometry import cameras as PCAM

    g = torch.Generator().manual_seed(8)
    src = torch.rand((1024, 4, 2), generator=g) * 16
    dst = src + 0.5 * torch.randn(src.shape, generator=g)
    h_cpu = PCAM.homography_dlt(src, dst)
    h_card = PCAM.homography_dlt(src.to(cuda), dst.to(cuda)).cpu()
    assert h_card.dtype == h_cpu.dtype == torch.float32
    diff = (h_card - h_cpu).abs().amax((-1, -2)) / h_cpu.abs().amax((-1, -2))
    ata = dlt_normal_matrix(src, dst)
    eig = torch.linalg.eigvalsh(ata)
    ratio = eig[:, -1] / eig[:, 1]  # largest over the smallest nonzero
    order = ratio.argsort()
    apart = {}
    for dtype in (torch.float32, torch.float64):
        v_cpu, v_card = (torch.linalg.eigh(ata.to(dtype).to(d))[1][..., :, 0].double().cpu() for d in ("cpu", cuda))
        apart[dtype] = torch.minimum((v_card - v_cpu).abs().amax(-1), (v_card + v_cpu).abs().amax(-1))
    for lo in range(0, 1024, 256):
        q = order[lo: lo + 256]
        print(f"eigenvalue ratio {ratio[q[0]].item():.3g}-{ratio[q[-1]].item():.3g}: null vectors card vs CPU "
              f"apart at most {apart[torch.float32][q].max().item():.3g} in fp32, "
              f"{apart[torch.float64][q].max().item():.3g} in float64; H card vs CPU at most "
              f"{diff[q].max().item():.3g} of it")
    assert diff.max().item() <= 1e-6


def tiny_request(cuda, g, t=8, n=11):
    """uint8 frames and n queries spread over the video, on the card."""
    queries = torch.stack([torch.rand(n, generator=g, device=cuda) * t,
                           torch.rand(n, generator=g, device=cuda) * 28,
                           torch.rand(n, generator=g, device=cuda) * 28], -1)[None]
    return {"rgb_u8_bthw3": torch.randint(0, 256, (1, t, 28, 28, 3), generator=g, device=cuda, dtype=torch.uint8),
            "track_2d_pointquerries_bn3": queries, "track_2d_pointlabels_bn": torch.ones((1, n), device=cuda)}


def hold_to_cpu(out, ref, what):
    """The card's outputs against the CPU's (plain versions) on the same bf16
    weights, within the band chip_smoke.py holds the kernel path to."""
    assert set(out) == set(ref), what
    for k, r in ref.items():
        o = out[k].cpu()
        assert o.shape == r.shape and torch.isfinite(o).all(), f"{what} {k}"
        assert (o.float() - r.float()).abs().max().item() <= 3e-2 * r.float().abs().max().item(), f"{what} {k}"


@pytest.mark.gpu
@pytest.mark.parametrize("dirs", [(1, -1), (-1,)])
def test_bidirectional_session_on_card_matches_cpu(cuda, dirs):
    """Backward and bidirectional tracks of the tiny model in bf16: the card
    (kernels) against the CPU (plain versions); the backward pass doubles
    the encoder's attention launches and the track kernels' with (1, -1)."""
    import dataclasses

    from l4p_tpu_torch import L4P, SLICE_TASKS, InferenceSession

    base = tiny_cfg()
    cfg = dataclasses.replace(base, track=dataclasses.replace(base.track, estimation_directions=dirs))
    g = torch.Generator(device=cuda).manual_seed(1)
    model = L4P(cfg, device=cuda, dtype=torch.bfloat16).eval()
    model.init_weights(g)
    data = tiny_request(cuda, g)
    counters = (flash_attention, FK.t2i_flash, FK.i2t_ln_t2i, FU.fused_upscale_hypernet)
    before = [f.launches for f in counters]
    out = InferenceSession(cfg, SLICE_TASKS, cuda)(model, data)
    passes, chunks, nw = len(dirs), 2, 3
    assert [f.launches - b for f, b in zip(counters, before)] == [
        4 * 2 * 2, passes * nw * chunks, 2 * passes * nw * chunks, passes * nw * chunks]
    ref = InferenceSession(cfg, SLICE_TASKS, "cpu")(model.cpu(), {k: v.cpu() for k, v in data.items()})
    hold_to_cpu(out, ref, f"directions {dirs}")


@pytest.mark.gpu
def test_camera_rays_session_on_card_matches_cpu(cuda):
    """A camera_rays head (camray's DPT variant, raw rays, overwrite
    stitch) beside depth, on the card against the CPU."""
    import dataclasses

    from l4p_tpu_torch import L4P, InferenceSession

    base = tiny_cfg()
    rays = dataclasses.replace(base.head_dict["camray"], task_name="rays", kind="camera_rays",
                               dpt=dataclasses.replace(base.head_dict["camray"].dpt, output_size=(4, 8, 8)))
    cfg = dataclasses.replace(base, heads=base.heads + (("rays", rays),))
    g = torch.Generator(device=cuda).manual_seed(2)
    model = L4P(cfg, device=cuda, dtype=torch.bfloat16).eval()
    model.init_weights(g)
    data = {"rgb_u8_bthw3": tiny_request(cuda, g)["rgb_u8_bthw3"]}
    out = InferenceSession(cfg, ("rays", "depth"), cuda)(model, data)
    assert out["rays_est_b6thw"].shape == (1, 6, 8, 8, 8)
    ref = InferenceSession(cfg, ("rays", "depth"), "cpu")(model.cpu(), {k: v.cpu() for k, v in data.items()})
    hold_to_cpu(out, ref, "camera_rays")


@pytest.mark.gpu
def test_streaming_on_card_matches_the_offline_session(cuda):
    """The slice's four tasks of the tiny model in bf16, pushed in chunks of
    3, 2 and 5 frames, against the offline session on the card."""
    from l4p_tpu_torch import L4P, SLICE_TASKS, InferenceSession, StreamingL4P, assemble_emissions

    cfg = tiny_cfg()
    g = torch.Generator(device=cuda).manual_seed(3)
    model = L4P(cfg, device=cuda, dtype=torch.bfloat16).eval()
    model.init_weights(g)
    data = tiny_request(cuda, g, t=10)
    ref = InferenceSession(cfg, SLICE_TASKS, cuda)(model, data)
    s = StreamingL4P(model, cfg, SLICE_TASKS, cuda, data["track_2d_pointquerries_bn3"])
    frames, emits, t0 = data["rgb_u8_bthw3"].cpu().numpy(), [], 0
    for c in (3, 2, 5):
        emits += s.push(frames[:, t0: t0 + c])
        t0 += c
    emits.append(s.flush())
    out = assemble_emissions(emits)
    assert set(out) == set(ref)
    for k, r in ref.items():
        assert out[k].shape == r.shape and torch.isfinite(out[k]).all(), k
        assert (out[k].float() - r.float()).abs().max().item() <= 3e-2 * r.float().abs().max().item(), k


@pytest.mark.gpu
def test_device_peak_flops_knows_the_h100(cuda):
    """989e12 bf16 FLOP/s on the H100 SXM part (NVIDIA's data sheet), no
    figure for a card the table does not know."""
    from l4p_tpu_torch.utils.flops import device_peak_flops

    name = torch.cuda.get_device_name(cuda)
    assert device_peak_flops(cuda) == (989e12 if name == "NVIDIA H100 80GB HBM3" else None), name
    assert device_peak_flops("cpu") is None


@pytest.mark.gpu
def test_point_maps_on_card_match_cpu(cuda):
    """generate_point_map and generate_3d_track_point_map (fp32; PyTorch
    keeps TF32 off in matmuls by default) on the card against the CPU,
    within 1e-5 of the largest CPU value."""
    from l4p_tpu_torch.geometry.core import generate_3d_track_point_map, generate_point_map

    g = torch.Generator().manual_seed(4)
    t, h, w, n = 6, 24, 40, 9
    k = torch.diag(torch.tensor([40.0, 40.0, 1.0, 1.0]))
    k[0, 2], k[1, 2] = 20.0, 12.0
    k = (k[None, :, :, None] + 0.5 * torch.rand((1, 4, 4, t), generator=g) * torch.tensor([1, 1, 0, 0.0])[:, None, None]
         ).contiguous()
    q = torch.linalg.qr(torch.randn((t, 3, 3), generator=g))[0]
    pose = torch.eye(4).repeat(t, 1, 1)
    pose[:, :3, :3], pose[:, :3, 3] = q, torch.randn((t, 3), generator=g)
    pose = pose.permute(1, 2, 0)[None].contiguous()
    cases = [(generate_point_map, (0.5 + 4 * torch.rand((1, 1, t, h, w), generator=g), k, pose)),
             (generate_3d_track_point_map, (40 * torch.rand((1, n, 2, t), generator=g),
                                            0.5 + torch.rand((1, n, 1, t), generator=g), k, pose))]
    for fn, args in cases:
        cpu = fn(*args)
        card = fn(*(a.to(cuda) for a in args)).cpu()
        assert card.shape == cpu.shape
        assert (card - cpu).abs().max().item() <= 1e-5 * cpu.abs().max().item(), fn.__name__


def head_dim_64_cfg():
    """tiny_cfg with an encoder of 2 heads of 64 (E = 128), the track head
    at its width and the camray rays at the window's 4 frames."""
    import dataclasses

    from l4p_tpu_torch.config import SamConfig

    cfg = tiny_cfg()
    heads = tuple((n, dataclasses.replace(h, dpt=dataclasses.replace(
        h.dpt, dim_tokens=128, **({"output_size": (4, 8, 8)} if n == "camray" else {})))) for n, h in cfg.heads)
    track = dataclasses.replace(cfg.track, sam=SamConfig(embed_dim=128, image_embedding_size=(2, 2, 2),
                                                         input_image_size=(4, 28, 28)))
    return dataclasses.replace(cfg, heads=heads, track=track,
                               encoder=dataclasses.replace(cfg.encoder, embed_dim=128, num_heads=2))


@pytest.mark.gpu
@pytest.mark.parametrize("stream", [False, True])
def test_run_sequence_on_card_reaches_the_kernels(cuda, stream):
    """run_sequence's five tasks on a bf16 model with D = 64 heads, numpy in
    and out: the attention and the three track kernels launch, and the
    outputs hold against run_sequence on the CPU (plain versions) within
    chip_smoke.py's band; the RANSAC-chosen poses, K and depth are finite."""
    import copy

    import numpy as np

    from l4p_tpu_torch import ALL_TASKS, L4P
    from l4p_tpu_torch.inference import run_sequence

    cfg = head_dim_64_cfg()
    g = torch.Generator(device=cuda).manual_seed(5)
    model = L4P(cfg, device=cuda, dtype=torch.bfloat16).eval()
    model.init_weights(g)
    t, n = 8, 11
    rng = np.random.default_rng(5)
    k = np.tile(np.diag([28.0, 28.0, 1, 1]).astype(np.float32)[None, :, :, None], (1, 1, 1, t))
    k[:, 0, 2] = k[:, 1, 2] = 14.0
    batch = {"rgb_u8_bthw3": rng.integers(0, 256, (1, t, 28, 28, 3), dtype=np.uint8), "intrinsics_b44t": k,
             "track_2d_pointquerries_bn3": np.stack([np.full(n, 0.5), rng.uniform(2, 26, n), rng.uniform(2, 26, n)],
                                                    -1)[None].astype(np.float32),
             "track_2d_pointlabels_bn": np.ones((1, n), np.float32)}
    counters = (flash_attention, FK.t2i_flash, FK.i2t_ln_t2i, FU.fused_upscale_hypernet)
    before = [f.launches for f in counters]
    out = run_sequence(model, cfg, ALL_TASKS, batch, "", "card", device=cuda, write_artifacts=False, stream=stream)
    assert all(f.launches > b for f, b in zip(counters, before)), [f.launches - b for f, b in zip(counters, before)]
    ref = run_sequence(copy.deepcopy(model).cpu(), cfg, ALL_TASKS, batch, "", "cpu", device="cpu",
                       write_artifacts=False, stream=stream)
    assert set(out) == set(ref)
    for key, r in ref.items():
        assert out[key].shape == r.shape and np.isfinite(out[key]).all() and np.isfinite(r).all(), key
        if key != "depth_est_b1thw" and not key.startswith("traj3d"):
            assert np.abs(out[key] - r).max() <= 3e-2 * np.abs(r).max(), key


@pytest.mark.gpu
def test_native_library_builds_on_the_card_machine(cuda):
    """The host preprocessing library builds with this machine's g++ and
    agrees with its numpy versions."""
    import numpy as np

    from l4p_tpu_torch.native import lib as NL

    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (4, 48, 80, 3), dtype=np.uint8)
    mean, std = np.array([0.485, 0.456, 0.406], np.float32), np.array([0.229, 0.224, 0.225], np.float32)
    np.testing.assert_allclose(NL.normalize_video(frames, mean, std), NL.normalize_video_plain(frames, mean, std),
                               rtol=1e-5, atol=1e-5)
    planes = rng.standard_normal((6, 48, 80)).astype(np.float32)
    np.testing.assert_allclose(NL.resize_planes(planes, (28, 28)), NL.resize_planes_plain(planes, (28, 28)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(NL.resize_planes(planes, (28, 28), "nearest"),
                                  NL.resize_planes_plain(planes, (28, 28), "nearest"))
    video = rng.standard_normal((3, 5, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(NL.mirror_pad_time(video), NL.mirror_pad_time_plain(video))


@pytest.mark.gpu
def test_metrics_on_card_match_cpu(cuda):
    """l4p_metrics on the card against the CPU on the same outputs and ground
    truth: a 16-frame 224 x 224 depth map (802,816 values, an even count,
    and a sparse mask with an odd one) for the medians' order statistics,
    flow, the mask at the 0.85 threshold, 128 tracks and 16 poses."""
    import math

    from l4p_tpu_torch.metrics import l4p_metrics

    g = torch.Generator().manual_seed(11)
    t, hw, n = 16, (224, 224), 128

    def pose(count):
        q, _ = torch.linalg.qr(torch.randn((count, 3, 3), generator=g))
        m = torch.eye(4).repeat(count, 1, 1)
        m[:, :3, :3] = q * torch.sign(torch.linalg.det(q))[:, None, None]
        m[:, :3, 3] = torch.randn((count, 3), generator=g)
        return m.permute(1, 2, 0)[None]  # (1, 4, 4, T)

    valid = (torch.rand((1, 1, t, *hw), generator=g) < 0.3).float()
    if int(valid.sum()) % 2 == 0:
        valid.view(-1)[int((valid.view(-1) == 0).nonzero()[0])] = 1.0
    batch = {"depth_b1thw": torch.rand((1, 1, t, *hw), generator=g) * 8 + 0.5, "depth_valid_b1thw": valid,
             "flow_2d_backward_b2thw": torch.randn((1, 2, t, *hw), generator=g),
             "dyn_mask_b1thw": (torch.rand((1, 1, t, *hw), generator=g) > 0.5).float(),
             "track_2d_traj_bn2t": torch.rand((1, n, 2, t), generator=g) * 224,
             "track_2d_vis_bn1t": (torch.rand((1, n, 1, t), generator=g) > 0.3).float(),
             "track_2d_valid_bn1t": (torch.rand((1, n, 1, t), generator=g) > 0.1).float(), "extrinsics_b44t": pose(t)}
    out = {"depth_est_b1thw": torch.rand((1, 1, t, *hw), generator=g) * 5 + 0.2,
           "flow_2d_backward_est_b2thw": torch.randn((1, 2, t, *hw), generator=g),
           "dyn_mask_est_b1thw": torch.randn((1, 1, t, *hw), generator=g) + math.log(0.85 / 0.15),
           "track_2d_traj_est_bn2t": batch["track_2d_traj_bn2t"] + torch.randn((1, n, 2, t), generator=g) * 6,
           "track_2d_vis_est_bn1t": torch.randn((1, n, 1, t), generator=g),
           "traj3d_est_b16t": pose(t).reshape(1, 16, t)}
    ref, _ = l4p_metrics(batch, out)
    got, _ = l4p_metrics({k: v.to(cuda) for k, v in batch.items()}, {k: v.to(cuda) for k, v in out.items()})
    assert set(got) == set(ref) and len(ref) == 12
    for k, r in ref.items():
        assert got[k].device.type == "cuda" and torch.isfinite(got[k]), k
        # fp32 sums in another order; the medians and the counts are the same. Random rotations put
        # some relative angles near 180 degrees, where arccos turns an ulp of the trace into ~1e-3
        # degrees: rot_deg measured 1.6e-5 relative on an H100
        tol = 4e-5 if k == "pose/rot_deg" else 1e-5
        assert abs(got[k].item() - r.item()) <= tol * (1 + abs(r.item())), (k, got[k].item(), r.item())
    for mask in (None, valid.bool()):
        from l4p_tpu_torch.metrics import median

        x = out["depth_est_b1thw"]
        assert median(x.to(cuda), None if mask is None else mask.to(cuda)).item() == median(x, mask).item()


def option_cfg(**enc):
    """tiny_cfg with encoder options; MLP width 256."""
    import dataclasses

    cfg = tiny_cfg()
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, mlp_ratio=4.0, **enc))


def camera_request(cuda, g, t=8):
    """Pixel intrinsics and the extrinsics of a rotating, translating camera."""
    k = torch.diag(torch.tensor([28.0, 28.0, 1.0, 1.0], device=cuda))
    k[0, 2] = k[1, 2] = 14.0
    ext = torch.eye(4, device=cuda).repeat(t, 1, 1)
    a = torch.arange(t, device=cuda) * 0.05
    ext[:, 0, 0], ext[:, 0, 2], ext[:, 2, 0], ext[:, 2, 2] = a.cos(), a.sin(), -a.sin(), a.cos()
    ext[:, :3, 3] = torch.rand((t, 3), generator=g, device=cuda)
    return {"intrinsics_b44t": k[None, :, :, None].expand(1, 4, 4, t).contiguous(),
            "extrinsics_b44t": ext.permute(1, 2, 0)[None].contiguous()}


@pytest.mark.gpu
@pytest.mark.parametrize("enc", [dict(cos_attn=True), dict(init_values=0.1), dict(use_learnable_pos_emb=True),
                                 dict(cam_emb_placed_at="input", cam_emb_type="add"),
                                 dict(cam_emb_placed_at="output", cam_emb_type="concat"),
                                 dict(cos_attn=True, init_values=0.1, use_learnable_pos_emb=True,
                                      cam_emb_placed_at="input")],
                         ids=["cos_attn", "layer_scale", "learnable_pos", "cam_input_add", "cam_output_concat", "all"])
def test_option_branches_on_card_match_plain_path(cuda, enc):
    """Each option of the tiny bf16 model on the kernel path (the attention
    kernel, with scale 1 under cos_attn) against the plain attention: the
    dense tasks over 3 windows, within chip_smoke.py's band."""
    from l4p_tpu_torch import DENSE_TASKS, L4P, InferenceSession

    cfg = option_cfg(**enc)
    g = torch.Generator(device=cuda).manual_seed(6)
    model = L4P(cfg, device=cuda, dtype=torch.bfloat16).eval()
    model.init_weights(g)
    data = {"rgb_u8_bthw3": torch.randint(0, 256, (1, 8, 28, 28, 3), generator=g, device=cuda, dtype=torch.uint8),
            **camera_request(cuda, g)}
    before = flash_attention.launches
    out = InferenceSession(cfg, DENSE_TASKS, cuda)(model, data)
    assert flash_attention.launches - before == 4 * 2  # 4 blocks, chunks of 2 + 1 windows
    ref = InferenceSession(cfg, DENSE_TASKS, cuda, attention=flash_attention_plain)(model, data)
    assert set(out) == set(ref)
    for k, r in ref.items():
        assert out[k].shape == r.shape and torch.isfinite(out[k]).all(), k
        assert (out[k].float() - r.float()).abs().max().item() <= 3e-2 * r.float().abs().max().item(), k


@pytest.mark.gpu
@pytest.mark.parametrize("enc,reason", [(dict(cos_attn=True), "cos_attn"), (dict(init_values=0.1), "init_values")])
def test_fused_encoder_refuses_cos_attn_and_layer_scale_on_card(cuda, enc, reason):
    """fused_encoder with an option the kernels lack raises on the card, at
    fused_encoder_blocks and through the session; the embedding and learnable
    positions, outside the blocks, take the kernels."""
    from l4p_tpu_torch import L4P, InferenceSession
    from l4p_tpu_torch.ops import fused_encoder as FE

    cfg = option_cfg(fused_encoder=True, **enc)
    g = torch.Generator(device=cuda).manual_seed(7)
    model = L4P(cfg, device=cuda, dtype=torch.bfloat16).eval()
    model.init_weights(g)
    x = torch.zeros((1, 8, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=reason):
        FE.fused_encoder_blocks(model.video_encoder.blocks, x, cfg.encoder, (4,))
    data = {"rgb_u8_bthw3": torch.zeros((1, 4, 28, 28, 3), device=cuda, dtype=torch.uint8)}
    with pytest.raises(ValueError, match=reason):
        InferenceSession(cfg, ("depth",), cuda)(model, data)
    ok = option_cfg(fused_encoder=True, use_learnable_pos_emb=True, cam_emb_placed_at="input")
    model = L4P(ok, device=cuda, dtype=torch.bfloat16).eval()
    model.init_weights(g)
    before = FE.fused_encoder_blocks.launches
    InferenceSession(ok, ("depth",), cuda)(model, {**data, **camera_request(cuda, g, t=4)})
    assert FE.fused_encoder_blocks.launches == before + 1
