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
    err = FE.ATTENTION(qkv.data_ptr(), out.data_ptr(), b, h, n, d, d ** -0.5, torch.cuda.current_stream().cuda_stream)
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


# (N, P, C, K, K2, heads): the giant width at the query counts the paths take
# (one query and 16, where P is split over clusters; 32 and 64, the
# data-parallel ranks'; 128, a chunk; 192) and with a ragged P (2000) at 128;
# a ragged P at C = 128; P off the 128-row tile (127, 129, 1000); K = 16 and
# 64; K2 != K (K2 = 64 takes the 64-token build); 4 heads; C = 2816, where a
# cluster takes 16 blocks
KEYS_SHAPES = [(1, 2048, 1408, 48, 48, 8), (16, 2048, 1408, 48, 48, 8), (32, 2048, 1408, 48, 48, 8),
               (64, 2048, 1408, 48, 48, 8), (128, 2048, 1408, 48, 48, 8), (192, 2048, 1408, 48, 48, 8),
               (128, 2000, 1408, 48, 48, 8), (4, 2048, 1408, 48, 48, 8), (3, 1000, 128, 48, 32, 8),
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
    before, variants = FK.t2i_flash.launches, dict(FK.t2i_flash.variant_launches)
    out = FK.t2i_flash(o["keys"], o["st"], o["spe"])
    torch.cuda.synchronize()
    assert FK.t2i_flash.launches == before + 1
    variant = FK.kernel_variant(c, k2, i2t=False)
    assert {v: FK.t2i_flash.variant_launches[v] - variants[v] for v in variants} == {
        v: int(v == variant) for v in variants}
    assert out.shape == (n, k2, c) and bool(torch.isfinite(out).all())
    err = band_err(out, FK.t2i_flash_plain(o["keys"], o["st"], o["spe"]))
    print(f"t2i_flash {(n, p, c, k2)}: max|kernel - plain| / max|plain| = {err:.3g}")
    assert err <= KEYS_BAND


@pytest.mark.gpu
def test_t2i_flash_at_its_widest_matches_plain_on_card(cuda):
    """C = 4096: 16 blocks of 256 columns, wider than i2t_ln_t2i's blocks."""
    o = keys_operands(2, 300, 4096, 48, 48, cuda)
    wide = FK.t2i_flash.variant_launches["wide"]
    err = band_err(FK.t2i_flash(o["keys"], o["st"], o["spe"]), FK.t2i_flash_plain(o["keys"], o["st"], o["spe"]))
    assert FK.t2i_flash.variant_launches["wide"] == wide + 1
    print(f"t2i_flash (2, 300, 4096, 48): max|kernel - plain| / max|plain| = {err:.3g}")
    assert err <= KEYS_BAND


@pytest.mark.gpu
@pytest.mark.parametrize("n,p,c,k,k2,heads", KEYS_SHAPES)
def test_i2t_ln_t2i_matches_plain_on_card(cuda, n, p, c, k, k2, heads):
    o = keys_operands(n, p, c, k, k2, cuda, seed=1)
    args = [o[x] for x in ("keys", "r", "per", "v2", "ob", "lnw", "lnb", "st", "spe")]
    before, variants = FK.i2t_ln_t2i.launches, dict(FK.i2t_ln_t2i.variant_launches)
    keys_new, wsum = FK.i2t_ln_t2i(*args, heads)
    torch.cuda.synchronize()
    assert FK.i2t_ln_t2i.launches == before + 1
    variant = FK.kernel_variant(c, k2, i2t=True)
    assert {v: FK.i2t_ln_t2i.variant_launches[v] - variants[v] for v in variants} == {
        v: int(v == variant) for v in variants}
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


def track_head_products(n, cuda, heads=8, q=6, d=88, c=1408, p=2048):
    """The track head's products through ops/conv.py:einsum_fp32 at the giant
    width (models/sam.py): {name: (spec, x, w)}, bf16, in the layouts the call
    sites hand over (pos_src is a transposed view)."""
    g = torch.Generator(device=cuda).manual_seed(n)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=cuda) * scale).bfloat16()

    qh, wk = r(n, q, heads, d).transpose(1, 2), r(heads, d, c, scale=c ** -0.5)
    pe = r(c, p).t()
    return {"spe": ("nkc,pc->npk", r(n, heads * q, c), pe), "per": ("pc,nck->npk", pe, r(n, c, heads * q)),
            "s": ("nhqd,hdc->nhqc", qh, wk), "outh": ("nhqc,hdc->nhqd", r(n, heads, q, c), wk),
            "r4": ("hdc,nhqd->nhcq", wk, qh),
            "v2": ("nhqd,hdc->nhqc", qh, r(c, heads * d, scale=d ** -0.5).view(c, heads, d).permute(1, 2, 0))}


# max |route - fp64 einsum| / max |fp64 einsum| of the same bf16 operands:
# fp32 sums in another order read about 1e-6, a reduction in bf16 about 4e-3
TRACK_PRODUCT_BAND = 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["spe", "per", "s", "outh", "r4", "v2"])
@pytest.mark.parametrize("n", [128, 192])
def test_track_head_products_on_tensor_cores(cuda, n, name):
    """Each product of the track head on the tensor cores: within
    TRACK_PRODUCT_BAND of the fp64 einsum, fp32, one count a product; the PE
    products (spe, per) a contiguous (N, P, K) result, and the shared (P, C)
    encoding never expanded (peak memory rises by the result, not by N
    copies of the encoding)."""
    from l4p_tpu_torch.ops.conv import einsum_fp32

    spec, x, w = track_head_products(n, cuda)[name]
    einsum_fp32(spec, x, w)  # cuBLAS's handle and workspace
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base, before = torch.cuda.memory_allocated(), einsum_fp32.launches
    out = einsum_fp32(spec, x, w)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    assert einsum_fp32.launches == before + 1 and out.dtype == torch.float32
    ref = torch.einsum(spec, x.double(), w.double())
    err = (out.double() - ref).abs().max().item() / ref.abs().max().item()
    print(f"{name} {spec} N={n}: max|route - fp64| / max|fp64| = {err:.3g}, peak rise {rise / 2**20:.1f} MiB")
    assert out.shape == ref.shape and err <= TRACK_PRODUCT_BAND
    if name in ("spe", "per"):
        pe = w if name == "spe" else x
        assert out.is_contiguous()
        # the expanded encoding alone would be n * 5.8 MB
        assert rise <= out.numel() * 4 + 2 * pe.numel() * pe.element_size()


def bf16_misses(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The share of the bf16 entries of `got` that are not the float64
    `ref` rounded to bf16."""
    return (got != ref.to(got.dtype)).float().mean().item()


def bf16_split_reduction(spec: str, x: torch.Tensor, y: torch.Tensor, splits: int = 8) -> torch.Tensor:
    """einsum(spec, x, y) as a reduction in bf16 computes it: the leading
    summed letter cut into `splits` parts, each part's sum exact and then
    rounded to bf16, the parts summed and the sum rounded again."""
    (xs, ys), out = spec.split("->")[0].split(","), spec.split("->")[1]
    c = next(c for c in xs if c in ys and c not in out)
    parts = zip(x.double().chunk(splits, xs.index(c)), y.double().chunk(splits, ys.index(c)))
    return sum(torch.einsum(spec, a, b).bfloat16().double() for a, b in parts).bfloat16()


# einsum_fp32's gradients (bf16, from fp32 sums) against the float64 ones of
# the same bf16 operands and bf16-rounded cotangent: the share of entries that
# are not the float64 value rounded to bf16. Sums in fp32 miss only where
# the value lies within their error of a rounding boundary (an H100 read
# 3.4e-5 to 5.2e-3, the most on the encoding's 9,216-term sums at N = 192);
# the same sums reduced in eight bf16 parts miss on 0.41 of entries
GRAD_MISS_BAND = 0.02


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["spe", "per", "s", "r4"])
@pytest.mark.parametrize("n", [16, 192])
def test_track_head_product_gradients_on_tensor_cores(cuda, n, name):
    """einsum_fp32's backward (the cotangent rounded to bf16, fp32 sums of
    its bf16 products, then rounded to bf16) against the fp64 einsum's
    gradients of the same bf16 operands and rounded cotangent: each
    gradient within GRAD_MISS_BAND of its rounded fp64 value entry for
    entry, and the shared (P, C) encoding's gradient, which sums
    N * K products, outside the band when the same sums are reduced in
    bf16."""
    from l4p_tpu_torch.ops.conv import einsum_fp32

    spec, x, w = track_head_products(n, cuda)[name]
    x, w = (t.detach().requires_grad_() for t in (x, w))
    cot = torch.randn(torch.einsum(spec, x.float(), w.float()).shape, device=cuda).bfloat16()
    einsum_fp32(spec, x, w).backward(cot.float())
    x64, w64 = (t.detach().double().requires_grad_() for t in (x, w))
    torch.einsum(spec, x64, w64).backward(cot.double())
    ins, out = spec.split("->")
    for got, want, letters, other in ((x.grad, x64.grad, ins.split(",")[0], w), (w.grad, w64.grad, ins.split(",")[1], x)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        miss = bf16_misses(got, want)
        err = (got.double() - want).abs().max().item() / want.abs().max().item()
        line = f"{name} N={n} gradient {letters}: {miss:.3g} of entries not the fp64 value rounded, max err {err:.3g}"
        if name in ("spe", "per") and len(letters) == 2:
            # the encoding's gradient: cotangent (npk) against the other operand, summed over n and k
            other_letters = next(s for s in ins.split(",") if s != letters)
            split = bf16_split_reduction(f"{out},{other_letters}->{letters}", cot, other.detach())
            split_miss = bf16_misses(split, want)
            line += f"; reduced in bf16: {split_miss:.3g}"
            assert split_miss > GRAD_MISS_BAND
        print(line)
        assert miss <= GRAD_MISS_BAND and err <= 2 ** -7  # a rounding to bf16 moves an entry by at most 2^-8 of it


@pytest.mark.gpu
def test_linear_fp32_on_the_card(cuda):
    """linear_fp32 (models/encoder.py's row-parallel product) at the giant
    encoder's fc2 half width, (2048, 2816) x (1408, 2816): the forward bit
    for bit cuBLAS's mm with an fp32 result of the same bf16 operands, the
    gradients those of the bf16-rounded cotangent summed in fp32 and
    rounded once."""
    from l4p_tpu_torch.ops.conv import linear_fp32

    g = torch.Generator(device=cuda).manual_seed(7)
    x = (torch.randn((1, 2048, 2816), generator=g, device=cuda) * 0.1).bfloat16().requires_grad_()
    w = (torch.randn((1408, 2816), generator=g, device=cuda) * 2816 ** -0.5).bfloat16().requires_grad_()
    y = linear_fp32(x, w)
    x2 = x.detach().reshape(-1, 2816)
    assert torch.equal(y, torch.mm(x2, w.detach().t(), out_dtype=torch.float32).view(1, 2048, 1408))
    cot = torch.randn(y.shape, generator=g, device=cuda)
    y.backward(cot)
    c = cot.bfloat16().reshape(-1, 1408)
    assert torch.equal(x.grad, torch.mm(c, w.detach(), out_dtype=torch.float32).bfloat16().view_as(x))
    assert torch.equal(w.grad, torch.mm(x2.t(), c, out_dtype=torch.float32).t().bfloat16())
    # the products in bf16 out (linear_fp32's backward before its products kept fp32 sums)
    print("gradients equal to bf16-output products:", torch.equal(x.grad, (c @ w.detach()).view_as(x)),
          torch.equal(w.grad, c.t() @ x2))


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


# the DPT heads' five resizes at the heads' widths, per window: the four
# fusion upsamples (256 channels) and the final resize to the window (128)
DPT_RESIZES = [((256, 4, 8, 8), (8, 16, 16)), ((256, 8, 16, 16), (16, 32, 32)), ((256, 16, 32, 32), (16, 64, 64)),
               ((256, 16, 64, 64), (16, 128, 128)), ((128, 16, 128, 128), (16, 224, 224))]


def resize_equal(x, size, align_corners):
    """The kernel against F.interpolate, bit for bit and in the same memory
    format, and one launch a call."""
    import torch.nn.functional as F

    from l4p_tpu_torch.ops.resize import interpolate_trilinear

    before = interpolate_trilinear.launches
    out = interpolate_trilinear(x, size, align_corners)
    torch.cuda.synchronize()
    assert interpolate_trilinear.launches == before + 1
    ref = F.interpolate(x, size=size, mode="trilinear", align_corners=align_corners)
    assert torch.equal(out, ref)
    assert [out.is_contiguous(memory_format=f) for f in (torch.contiguous_format, torch.channels_last_3d)] == [
        ref.is_contiguous(memory_format=f) for f in (torch.contiguous_format, torch.channels_last_3d)]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [torch.channels_last_3d, torch.contiguous_format])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("shape,size", DPT_RESIZES)
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_resize_equals_interpolate_on_card_at_dpt_shapes(cuda, dtype, align_corners, shape, size, batch, layout):
    """channels_last_3d is the layout the DPT trunk's convs hand over."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((batch, *shape), generator=g, device=cuda).to(dtype).contiguous(memory_format=layout)
    resize_equal(x, size, align_corners)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,size", [
    ((1, 3, 5, 7, 9), (11, 13, 29)),     # W_out not a multiple of 8
    ((1, 2, 1, 1, 1), (3, 4, 5)),        # input axes of size 1
    ((2, 3, 6, 6, 6), (1, 1, 1)),        # output axes of size 1
    ((2, 8, 50, 40, 100), (13, 17, 37)),  # a downscale
    ((2, 4, 6, 10, 16), (6, 20, 32)),    # an identity axis
    ((1, 2, 3, 4, 100), (5, 6, 300)),    # long rows
    ((2, 12, 4, 5, 6), (7, 9, 11)),      # channels_last with channels not a multiple of the 16-byte vector
])
@pytest.mark.parametrize("layout", [torch.channels_last_3d, torch.contiguous_format])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_resize_equals_interpolate_on_card_at_edges(cuda, dtype, align_corners, shape, size, layout):
    g = torch.Generator(device=cuda).manual_seed(6)
    resize_equal(torch.randn(shape, generator=g, device=cuda).to(dtype).contiguous(memory_format=layout), size,
                 align_corners)


@pytest.mark.gpu
def test_resize_raises_instead_of_falling_back(cuda):
    from l4p_tpu_torch.ops.resize import interpolate_trilinear

    x = torch.randn((1, 2, 4, 8, 8), device=cuda)
    before = interpolate_trilinear.launches
    with pytest.raises(ValueError, match="contiguous"):
        interpolate_trilinear(x.transpose(3, 4), (8, 16, 16), True)
    with pytest.raises(ValueError, match="contiguous"):
        interpolate_trilinear(x[..., ::2], (8, 16, 16), True)
    with pytest.raises(TypeError):
        interpolate_trilinear(x.half(), (8, 16, 16), True)
    with pytest.raises(ValueError, match="B, C, T, H, W"):
        interpolate_trilinear(x[0], (8, 16, 16), True)
    assert interpolate_trilinear.launches == before


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
    gemm = FE.GEMM
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


def grad_of_fit(outs, leaves):
    """Gradients of sum_i 0.5 |outs_i A_i - t_i|^2, A_i and t_i from fixed seeds (chip_smoke.py's grad_of_fit)."""
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = 0
    for i, o in enumerate(outs):
        gen = torch.Generator(device=o.device).manual_seed(i)
        mix = torch.randn((o.shape[-1], o.shape[-1]), generator=gen, device=o.device) / o.shape[-1] ** 0.5
        loss = loss + 0.5 * (o.float() @ mix - torch.randn(o.shape, generator=gen, device=o.device)).square().sum()
    return torch.autograd.grad(loss, leaves, allow_unused=True)


def l2_gap(grads, ref):
    """|grads - ref| / |ref| over all entries together (None = 0)."""
    num = sum(((r.float() if g is None else g.float() - r.float()) ** 2).sum().item()
              for g, r in zip(grads, ref) if r is not None)
    return (num / sum((r.float() ** 2).sum().item() for r in ref if r is not None)) ** 0.5


def function_case(name, cuda, g):
    """(Function class, run(path) -> (outputs, leaves)) at small shapes on the
    card; path 'kernel' or 'plain'."""
    from l4p_tpu_torch.config import EncoderConfig, SamConfig, TrackConfig
    from l4p_tpu_torch.models import sam as PS
    from l4p_tpu_torch.models.encoder import VideoEncoder
    from l4p_tpu_torch.models.track import TrackHead
    from l4p_tpu_torch.ops import flash_attention as FA
    from l4p_tpu_torch.ops import fused_encoder as FE

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=cuda) * scale).bfloat16()

    def leaves(ts):
        return [t.detach().clone().requires_grad_() for t in ts]

    if name == "flash_attention":
        qkv = [rnd(2, 4, 300, 88) for _ in range(3)]

        def attention(path):
            xs = leaves(qkv)
            return (FA.flash_attention if path == "kernel" else FA.flash_attention_plain)(*xs, 88 ** -0.5), xs
        return FA.FlashAttentionFunction, attention
    if name == "fused_upscale_hypernet":
        ops = [rnd(4, 512, 256), rnd(256, 64, 2, 2, 2, scale=1 / 16), rnd(64, scale=0.1), 1 + rnd(64, scale=0.1),
               rnd(64, scale=0.1), rnd(64, 32, 1, 2, 2, scale=1 / 8), rnd(32, scale=0.1), rnd(4, 3, 32, scale=0.1)]

        def upscale(path):
            xs = leaves(ops)
            return (FU.fused_upscale_hypernet if path == "kernel" else FU.fused_upscale_hypernet_plain)(*xs), xs
        return FU.FusedUpscaleFunction, upscale
    if name == "twoway_streamed":
        sam = SamConfig(embed_dim=128, image_embedding_size=(4, 8, 8), input_image_size=(8, 112, 112), mlp_dim=64)
        head = TrackHead(TrackConfig(image_size=(8, 112, 112), sam=sam), device=cuda, dtype=torch.bfloat16)
        head.init_weights(g)
        tf = head.mask_decoder.transformer
        ops = [rnd(3, 6, 128), rnd(3, 256, 128), rnd(256, 128)]

        def run(path):
            q, k, pe = leaves(ops)
            out = PS.twoway_streamed(tf, sam, q, k, q, pe, PS.KERNELS if path == "kernel" else PS.PLAIN)
            return out, [q, k, pe, *tf.parameters()]
        return PS.TwoWayStreamedFunction, run
    cfg = EncoderConfig(embed_dim=256, num_heads=4, depth=2, mlp_ratio=4.0)
    enc = VideoEncoder(cfg, device=cuda, dtype=torch.bfloat16)
    enc.init_weights(g)
    x = rnd(2, 300, 256)

    def run(path):
        (x_,) = leaves([x])
        fn = FE.fused_encoder_blocks if path == "kernel" else FE.fused_encoder_blocks_plain
        return fn(enc.blocks, x_, cfg, (1, 2)), [x_, *enc.blocks.parameters()]
    return FE.FusedEncoderFunction, run


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flash_attention", "fused_upscale_hypernet", "twoway_streamed",
                                  "fused_encoder_blocks"])
def test_kernel_function_gradients_on_card_match_plain_path(cuda, name):
    """Each kernel's autograd Function on the card: its outputs hang off the
    Function's node and the gradients of 0.5 |out A - target|^2 for every input and
    parameter are the plain path's, but for the cotangent (the forward's
    output, a bf16 step apart): within chip_smoke.py's FUNCTION_GRAD_BAND
    (an H100 measured 2.6e-3, 2.1e-4, 4.3e-3 and 3.0e-3)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    function, run = function_case(name, cuda, g)
    outs, leaves = run("kernel")
    for o in outs if isinstance(outs, tuple) else (outs,):
        assert isinstance(o.grad_fn, function._backward_cls), o.grad_fn
    kernel = grad_of_fit(outs, leaves)
    plain = grad_of_fit(*run("plain"))
    assert [k is None for k in kernel] == [p is None for p in plain]
    gap = l2_gap(kernel, plain)
    print(f"{name}: gradients kernel path against plain path, relative L2 {gap:.3g}")
    assert gap <= 1e-2


def train_cfg(**enc):
    """tiny_cfg with an MLP width the fused encoder takes (a multiple of 8)."""
    import dataclasses

    cfg = tiny_cfg()
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, mlp_ratio=4.0, **enc))


def tiny_train_batch(cuda, seed, t=4, n=5):
    import numpy as np

    rng = np.random.default_rng(seed)
    k = np.tile(np.diag([30.0, 30.0, 1, 1]).astype(np.float32)[None, :, :, None], (1, 1, 1, t))
    k[:, 0, 2] = k[:, 1, 2] = 14.0
    batch = {
        "rgb_b3thw": rng.standard_normal((1, 3, t, 28, 28)), "intrinsics_b44t": k,
        "extrinsics_b44t": np.tile(np.eye(4)[None, :, :, None], (1, 1, 1, t)),
        "depth_b1thw": rng.uniform(1, 5, (1, 1, t, 28, 28)),
        "flow_2d_backward_b2thw": rng.standard_normal((1, 2, t, 28, 28)),
        "dyn_mask_b1thw": rng.uniform(size=(1, 1, t, 28, 28)) > 0.5,
        "track_2d_pointquerries_bn3": np.stack([rng.uniform(0, t, (1, n)), rng.uniform(2, 26, (1, n)),
                                                rng.uniform(2, 26, (1, n))], -1),
        "track_2d_pointlabels_bn": np.ones((1, n)), "track_2d_traj_bn2t": rng.uniform(0, 28, (1, n, 2, t)),
        "track_2d_vis_bn1t": np.ones((1, n, 1, t)), "track_2d_depth_bn1t": rng.uniform(1, 5, (1, n, 1, t)),
        "track_2d_valid_bn1t": np.ones((1, n, 1, t))}
    return {key: torch.as_tensor(v, device=cuda).float() for key, v in batch.items()}


@pytest.mark.gpu
def test_two_train_steps_on_card_match_the_plain_kernels(cuda):
    """Two train steps of the tiny bf16 model on the kernel path against the
    same steps on the plain path (plain attention and track kernels) from
    the same weights: the launches of each step, the first step's gradients
    (relative L2 within chip_smoke.py's STEP_GRAD_L2), the losses close and
    finite, every weight finite after them."""
    import copy

    from l4p_tpu_torch import ALL_TASKS, L4P, PLAIN
    from l4p_tpu_torch import train as T

    cfg = train_cfg()
    g = torch.Generator(device=cuda).manual_seed(2)
    model = L4P(cfg, device=cuda, dtype=torch.bfloat16)
    model.init_weights(g)
    plain_model = copy.deepcopy(model)
    batches = [tiny_train_batch(cuda, s) for s in (0, 1)]
    plain_kw = dict(attention=flash_attention_plain, track_kernels=PLAIN)
    grads = {}
    for path, m, kw in (("kernel", model, {}), ("plain", plain_model, plain_kw)):
        loss, _ = T.l4p_loss(m, cfg, batches[0], ALL_TASKS, **kw)
        grads[path] = torch.autograd.grad(loss, list(m.parameters()), allow_unused=True)
    gap = l2_gap(grads["kernel"], grads["plain"])
    print(f"first step's gradients, kernel path against plain path: relative L2 {gap:.3g}")
    assert gap <= 1.5e-2  # measured 5.7e-3 and 5.8e-3 on an H100
    counters = (flash_attention, FK.t2i_flash, FK.i2t_ln_t2i, FU.fused_upscale_hypernet)
    losses = {}
    for path, m, kw in (("kernel", model, {}), ("plain", plain_model, plain_kw)):
        opt = T.make_optimizer(m, lr=1e-3, total_steps=2, mask=T.trainable_mask(m, cfg))
        losses[path] = []
        for b in batches:
            before = [c.launches for c in counters]
            loss, _ = T.train_step(m, opt, b, cfg, ALL_TASKS, **kw)
            torch.cuda.synchronize()
            want = [4, 1, 2, 1] if path == "kernel" else [0, 0, 0, 0]
            assert [c.launches - x for c, x in zip(counters, before)] == want
            losses[path].append(loss.item())
        assert all(torch.isfinite(p).all() for p in m.parameters())
    print(f"losses kernel path {losses['kernel']}, plain path {losses['plain']}")
    # the first step's losses are the same weights' (measured 1.2e-5 apart, relative); the second's
    # come after one update, whose Adam steps (about lr whatever a gradient's size) differ wherever a
    # gradient is near 0, and the backward's atomics are not deterministic: the plain path's own
    # second loss moved 1.6e-4 between runs, the two paths' 1.6e-6 to 1.7e-4 apart over eight
    for (a, b), tol in zip(zip(losses["kernel"], losses["plain"]), (3e-5, 4e-4)):
        assert abs(a - b) <= tol * abs(b)


@pytest.mark.gpu
def test_fused_encoder_and_frozen_encoder_steps_on_card(cuda):
    """A train step with encoder.fused_encoder (one fused_encoder_blocks
    launch, gradients within STEP_GRAD_L2 of the plain blocks'), and one
    with freeze_video_encoder: the encoder's weights bit for bit unchanged,
    the heads' changed."""
    import copy
    import dataclasses

    from l4p_tpu_torch import ALL_TASKS, L4P
    from l4p_tpu_torch import train as T
    from l4p_tpu_torch.ops import fused_encoder as FE

    cfg = train_cfg(fused_encoder=True)
    g = torch.Generator(device=cuda).manual_seed(3)
    model = L4P(cfg, device=cuda, dtype=torch.bfloat16)
    model.init_weights(g)
    batch = tiny_train_batch(cuda, 0)
    before = FE.fused_encoder_blocks.launches
    loss, _ = T.l4p_loss(model, cfg, batch, ALL_TASKS)
    kernel = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    assert FE.fused_encoder_blocks.launches == before + 1
    loss, _ = T.l4p_loss(model, cfg, batch, ALL_TASKS, encoder_blocks=FE.fused_encoder_blocks_plain)
    plain = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    gap = l2_gap(kernel, plain)
    print(f"fused encoder step's gradients against the plain blocks': relative L2 {gap:.3g}")
    assert gap <= 8e-3  # measured 3.5e-3 on an H100
    frozen = dataclasses.replace(cfg, freeze_video_encoder=True)
    state = copy.deepcopy(model.state_dict())
    # lr 1e-2: the first one-cycle rate, lr / 25, must clear half a bf16 step of the heads' weights
    opt = T.make_optimizer(model, lr=1e-2, total_steps=2, mask=T.trainable_mask(model, frozen))
    T.train_step(model, opt, batch, frozen, ALL_TASKS)
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in state.items() if k.startswith("video_encoder."))
    assert all(not torch.equal(after[k], state[k]) for k in ("task_heads.depth.task_head.dpt.head2.0.bias",
                                                              "task_heads.track_2d.mask_decoder.mask_tokens.weight"))


@pytest.mark.gpu
def test_fit_save_restore_on_card(cuda, tmp_path):
    """Trainer.fit on the card for two steps, its checkpoint restored into a
    second model: weights, moments and step bit for bit."""
    from l4p_tpu_torch import ALL_TASKS, L4P, Trainer, TrainerConfig

    cfg = train_cfg()
    model = L4P(cfg, device=cuda, dtype=torch.bfloat16)
    model.init_weights(torch.Generator(device=cuda).manual_seed(4))
    trainer = Trainer(cfg, ALL_TASKS, TrainerConfig(max_steps=2, log_every=1, out_dir=str(tmp_path)), device=cuda)
    _, opt, step = trainer.fit(model, iter([tiny_train_batch(cuda, s) for s in (0, 1, 2)]))
    assert step == 2
    back, opt2, step2 = trainer.restore(str(tmp_path / "ckpt_0000002.pt"), L4P(cfg, device=cuda, dtype=torch.bfloat16))
    assert step2 == 2 and opt2.count == opt.count == 2
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in back.state_dict().items())
    assert all(torch.equal(opt.mu[k], opt2.mu[k]) and torch.equal(opt.nu[k], opt2.nu[k]) for k in opt.mu)


# --- VideoMAE pretraining ------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 16, 208, 88), (2, 8, 2048, 64)])
def test_attention_at_mae_shapes_on_card_matches_plain(cuda, shape):
    """The giant MAE's two attention shapes at batch 2: the encoder's 208
    visible tokens (D = 88) and the decoder's 2048 (D = 64), q, k and v the
    strided views of one qkv product as a block hands them over: one launch,
    the forward within the band above, the gradients of 0.5 |out A -
    target|^2 within chip_smoke.py's FUNCTION_GRAD_BAND of the plain path's."""
    g = torch.Generator(device=cuda).manual_seed(13)
    b, h, n, d = shape
    qkv = torch.randn((b, n, 3, h, d), generator=g, device=cuda).bfloat16()
    got = {}
    for path, fn in (("kernel", flash_attention), ("plain", flash_attention_plain)):
        leaf = qkv.clone().requires_grad_()
        before = flash_attention.launches
        out = fn(*leaf.permute(2, 0, 3, 1, 4), d ** -0.5)
        assert flash_attention.launches == before + (path == "kernel")
        got[path] = out, grad_of_fit(out, [leaf])
    err = (got["kernel"][0].float() - got["plain"][0].float()).abs().max().item()
    gap = l2_gap(got["kernel"][1], got["plain"][1])
    print(f"attention {shape}: max|kernel - plain| {err:.3g}, gradients relative L2 {gap:.3g}")
    assert err <= 8e-3  # measured 3.9e-3 and 9.8e-4 on an H100
    assert gap <= 1e-2  # measured 2.8e-3 and 2.0e-3


@pytest.mark.gpu
def test_giant_mae_step_on_card_matches_plain_path(cuda):
    """The giant MAE (batch 2, mask ratio 0.9, bf16) from one seeded model,
    batch and set of masks: the loss and its gradients on the kernel path (48
    attention launches) against the plain path (none), within chip_smoke.py's
    MAE_LOSS_TOL and MAE_STEP_GRAD_L2; then two pretraining steps (the first
    at the warm-up's rate 0) leave every weight finite and move the head."""
    from l4p_tpu_torch.models.mae import MAE, mae_pretrain_loss, mae_registry, tube_mask_indices
    from l4p_tpu_torch.pretrain_mae import pretrain_step, synthetic_batches
    from l4p_tpu_torch.train import make_mae_optimizer

    cfg = mae_registry("giant")
    model = MAE(cfg, device=cuda, dtype=torch.bfloat16)
    model.init_weights(torch.Generator(device=cuda).manual_seed(5))
    x = torch.as_tensor(next(synthetic_batches(cfg.encoder, 2)), device=cuda).bfloat16()
    vis, mask = (i.to(cuda) for i in tube_mask_indices(torch.Generator().manual_seed(1), cfg.encoder, 2, 0.9))
    assert vis.shape == (2, 208) and mask.shape == (2, 1840)
    params = list(model.parameters())
    got = {}
    for path, attention in (("kernel", flash_attention), ("plain", flash_attention_plain)):
        before = flash_attention.launches
        loss = mae_pretrain_loss(model, x, vis, mask, attention=attention)
        got[path] = loss.item(), torch.autograd.grad(loss, params)
        assert flash_attention.launches - before == (48 if path == "kernel" else 0)
    loss_gap = abs(got["kernel"][0] - got["plain"][0]) / got["plain"][0]
    gap = l2_gap(got["kernel"][1], got["plain"][1])
    print(f"giant MAE: losses {got['kernel'][0]:.6g} / {got['plain'][0]:.6g}, gradients relative L2 {gap:.3g}")
    assert loss_gap <= 1.5e-5  # measured 6e-6 on an H100
    assert gap <= 5e-3  # measured 1.9e-3
    del got
    head = model.decoder.head.bias.clone()
    optimizer = make_mae_optimizer(dict(model.named_parameters()), 1e-3, 3, 1)
    for _ in range(2):
        before = flash_attention.launches
        loss = pretrain_step(model, optimizer, x, vis, mask)
        assert flash_attention.launches - before == 48 and torch.isfinite(loss)
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert not torch.equal(model.decoder.head.bias, head)


@pytest.mark.gpu
def test_tiny_pretraining_cli_on_card_writes_an_overlayable_checkpoint(cuda, tmp_path):
    """`pretrain_mae.main` at its defaults (cuda, bf16) on the tiny config:
    the attention kernel at D = 16 (2 + 1 launches a step), and ckpt.pt
    overlaying every tensor of an encoder of that config."""
    from l4p_tpu_torch.checkpoint import load_video_encoder_ckpt
    from l4p_tpu_torch.models.encoder import VideoEncoder
    from l4p_tpu_torch.pretrain_mae import main, mae_config

    before = flash_attention.launches
    assert main(["--size", "tiny", "--steps", "2", "--batch", "2", "--warmup", "1", "--out-dir", str(tmp_path)]) == 0
    assert flash_attention.launches - before == 2 * 3
    ckpt = torch.load(tmp_path / "ckpt.pt", weights_only=True)
    enc = VideoEncoder(mae_config("tiny").encoder, device=cuda, dtype=torch.bfloat16)
    load_video_encoder_ckpt(enc, tmp_path / "ckpt.pt")
    assert all(v.device == torch.device("cpu") and v.dtype == torch.float32 for v in ckpt.values())
    assert all(torch.equal(v.cpu(), ckpt[f"encoder.{k}"].bfloat16()) for k, v in enc.state_dict().items())


@pytest.mark.gpu
def test_pretrain_cli_refuses_fp32_on_card(cuda, tmp_path, capsys):
    from l4p_tpu_torch.pretrain_mae import main

    with pytest.raises(SystemExit) as exit_info:
        main(["--size", "tiny", "--fp32", "--out-dir", str(tmp_path / "never")])
    assert exit_info.value.code == 2 and "takes bf16 only" in capsys.readouterr().err
    assert not (tmp_path / "never").exists()


# --- multi-GPU: the kernels at a rank's shapes, a one-rank NCCL session, the dry run ---

# (kernel, size): the default encoder's chunk of 2 windows and its last chunk
# of 1 at 8 of the 16 heads (a model axis of 2); the track chunk of 128
# queries over a data axis of 2 and of 4
SHARD_CASES = [("attention", (2, 8, 2048, 88)), ("attention", (1, 8, 2048, 88)),
               ("t2i_flash", 64), ("t2i_flash", 32), ("i2t_ln_t2i", 64), ("i2t_ln_t2i", 32),
               ("fused_upscale_hypernet", 64), ("fused_upscale_hypernet", 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,size", SHARD_CASES)
def test_kernels_at_shard_local_shapes_match_plain_on_card(cuda, kernel, size):
    if kernel == "attention":
        g = torch.Generator(device=cuda).manual_seed(0)
        q, k, v = (torch.randn(size, generator=g, device=cuda).bfloat16() for _ in range(3))
        err = (flash_attention(q, k, v, size[3] ** -0.5).float()
               - flash_attention_plain(q, k, v, size[3] ** -0.5).float()).abs().max().item()
        assert err <= 8e-3  # test_kernel_matches_plain_on_card's band
    elif kernel == "fused_upscale_hypernet":
        args = upscale_operands(size, 2048, 1408, 352, 176, 3, cuda)
        assert band_err(FU.fused_upscale_hypernet(*args), FU.fused_upscale_hypernet_plain(*args)) <= UPSCALE_BAND
    else:
        o = keys_operands(size, 2048, 1408, 48, 48, cuda)
        if kernel == "t2i_flash":
            err = band_err(FK.t2i_flash(o["keys"], o["st"], o["spe"]), FK.t2i_flash_plain(o["keys"], o["st"], o["spe"]))
        else:
            args = [o[x] for x in ("keys", "r", "per", "v2", "ob", "lnw", "lnb", "st", "spe")]
            err = max(band_err(a, b) for a, b in zip(FK.i2t_ln_t2i(*args, 8), FK.i2t_ln_t2i_plain(*args, 8)))
        assert err <= KEYS_BAND


@pytest.mark.gpu
def test_one_rank_nccl_session_on_card_matches_the_session_without_a_mesh(cuda, tmp_path):
    """The tiny model's five tasks through InferenceSession(mesh=) on an NCCL
    group of one rank (a (1, 1) mesh): the same kernel launches and the same
    outputs, bit for bit, as the session without a mesh."""
    import dataclasses

    import torch.distributed as dist

    from l4p_tpu_torch import ALL_TASKS, L4P, InferenceSession
    from l4p_tpu_torch.parallel.mesh import make_mesh

    cfg = tiny_cfg()
    heads = tuple((n, dataclasses.replace(h, dpt=dataclasses.replace(h.dpt, output_size=(4, 8, 8))))
                  if n == "camray" else (n, h) for n, h in cfg.heads)
    cfg = dataclasses.replace(cfg, heads=heads)
    g = torch.Generator(device=cuda).manual_seed(0)
    model = L4P(cfg, device=cuda, dtype=torch.bfloat16).eval()
    model.init_weights(g)
    n, t = 11, 8
    k = torch.diag(torch.tensor([28.0, 28.0, 1.0, 1.0], device=cuda))
    k[0, 2] = k[1, 2] = 14.0
    data = {"rgb_u8_bthw3": torch.randint(0, 256, (1, t, 28, 28, 3), generator=g, device=cuda, dtype=torch.uint8),
            "intrinsics_b44t": k[None, :, :, None].expand(1, 4, 4, t).contiguous(),
            "track_2d_pointquerries_bn3": torch.stack([torch.rand(n, generator=g, device=cuda) * t,
                                                       torch.rand(n, generator=g, device=cuda) * 28,
                                                       torch.rand(n, generator=g, device=cuda) * 28], -1)[None],
            "track_2d_pointlabels_bn": torch.ones((1, n), device=cuda)}
    counters = (flash_attention, FK.t2i_flash, FK.i2t_ln_t2i, FU.fused_upscale_hypernet)
    ref = InferenceSession(cfg, ALL_TASKS, cuda)(model, data)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous", rank=0, world_size=1)
    try:
        before = [f.launches for f in counters]
        out = InferenceSession(cfg, ALL_TASKS, cuda, mesh=make_mesh(1, 1, device=cuda))(model, data)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    nw, chunks = 3, 2
    assert [f.launches - b for f, b in zip(counters, before)] == [4 * 2, nw * chunks, 2 * nw * chunks, nw * chunks]
    assert set(out) == set(ref)
    for key, r in ref.items():
        assert torch.equal(out[key], r), key


@pytest.mark.gpu
@pytest.mark.parametrize("procs,backend", [(1, "nccl"), (2, "gloo")])
def test_dryrun_on_card(cuda, procs, backend):
    """`torchrun -m l4p_tpu_torch.parallel.dryrun --device cuda` on the card:
    one NCCL rank (a (1, 1) mesh), and two gloo ranks sharing the card (a
    (1, 2) mesh: the encoder split over `model`, its training step too)."""
    import math
    import os
    import re
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(procs), "-m",
           "l4p_tpu_torch.parallel.dryrun", "--device", "cuda", "--backend", backend]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr[-3000:]
    mesh = "{'data': 1, 'model': %d}" % procs
    m = re.search(r"dryrun OK: mesh=(\{.*?\}) loss=(\S+) ", res.stdout)
    assert m is not None and m.group(1) == mesh and math.isfinite(float(m.group(2))), res.stdout


# VGGT (models/vggt.py): the DPT heads' bilinear resizes at 294 x 518, a chunk of 8 frames
VGGT_RESIZES = [((11, 19), (21, 37), 256), ((21, 37), (42, 74), 256), ((42, 74), (84, 148), 256),
                ((84, 148), (168, 296), 256), ((168, 296), (294, 518), 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [torch.channels_last, torch.contiguous_format])
@pytest.mark.parametrize("shape,size,channels", VGGT_RESIZES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bilinear_resize_equals_interpolate_on_card(cuda, dtype, shape, size, channels, layout):
    """The resize kernel as a depth-1 trilinear resize against
    F.interpolate(mode='bilinear', align_corners=True), in the memory format
    F.interpolate keeps, one launch a call: bit for bit in bf16 (VGGT's
    dtype) and in fp32 NCHW; fp32 channels_last within one ulp of the
    largest input, where PyTorch's NHWC kernel rounds its partial sums
    otherwise (measured on an H100: up to 18% of the values off, by 4.8e-7
    at most for inputs up to 5.3)."""
    import torch.nn.functional as F

    from l4p_tpu_torch.ops.resize import interpolate_bilinear, interpolate_trilinear

    g = torch.Generator(device=cuda).manual_seed(19)
    x = torch.randn((8, channels, *shape), generator=g, device=cuda).to(dtype).contiguous(memory_format=layout)
    before = interpolate_trilinear.launches
    out = interpolate_bilinear(x, size, True)
    torch.cuda.synchronize()
    assert interpolate_trilinear.launches == before + 1
    ref = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
    if dtype == torch.float32 and layout == torch.channels_last:
        assert (out - ref).abs().max().item() <= torch.finfo(dtype).eps * x.abs().max().item()
    else:
        assert torch.equal(out, ref)
    assert out.is_contiguous(memory_format=layout) and ref.is_contiguous(memory_format=layout)


@pytest.mark.gpu
def test_attention_kernel_at_vggt_global_shape(cuda):
    """VGGT's global attention, (1, 16, 50048, 64), against the plain
    version computed 1024 queries at a time (a row's softmax is its own).
    Over 50,048 keys the softmax of N(0, 1) scores is near uniform and the
    output small (max |plain| about 0.05), so the error is taken relative
    to max |plain|: a kernel that drops part of the keys reads O(1)."""
    g = torch.Generator(device=cuda).manual_seed(20)
    q, k, v = (torch.randn((1, 16, 50048, 64), generator=g, device=cuda).bfloat16() for _ in range(3))
    out = flash_attention(q, k, v, 0.125).float()
    err = top = 0.0
    for i in range(0, q.shape[2], 1024):
        want = flash_attention_plain(q[:, :, i:i + 1024], k, v, 0.125).float()
        err = max(err, (out[:, :, i:i + 1024] - want).abs().max().item())
        top = max(top, want.abs().max().item())
    assert err <= VGGT_GLOBAL_ATTENTION_TOL * top, (err, top)


# max |kernel - plain| / max |plain| at (1, 16, 50048, 64), about 4x what an H100 read (in brackets:
# chip_smoke.py phase 2, the same shape and draw distribution; 4.2e-3 at (64, 16, 782, 64))
VGGT_GLOBAL_ATTENTION_TOL = 0.02  # [4.9e-3]


@pytest.mark.gpu
def test_vggt_kernel_path_matches_plain_on_card(cuda):
    """VGGT at 8 frames of 294 x 518 with 4 aggregator blocks (every other
    width published): the session on the attention and resize kernels
    against the session on the plain attention, each output within the
    bands below of the plain path's (the intrinsics follow the pose
    encoding through tan(fov / 2)), and the kernel launches counted."""
    from l4p_tpu_torch.config import VGGTConfig
    from l4p_tpu_torch.inference import InferenceSession
    from l4p_tpu_torch.models.vggt import VGGT
    from l4p_tpu_torch.ops import qk_norm_rope as qnr
    from l4p_tpu_torch.ops.resize import interpolate_trilinear
    from portbench.drivers.vggt import seeded_weights

    cfg = VGGTConfig(depth=4, dpt_layers=(0, 1, 2, 3))
    tasks = ("camera", "depth", "world_points")
    model = VGGT(cfg, device=cuda, dtype=torch.bfloat16).eval()
    model.load_state_dict(seeded_weights(model, 19, cuda, torch.bfloat16))
    g = torch.Generator(device=cuda).manual_seed(21)
    data = {"rgb_u8_bthw3": torch.randint(0, 256, (1, 8, 294, 518, 3), generator=g, device=cuda, dtype=torch.uint8)}
    before = flash_attention.launches, interpolate_trilinear.launches, qnr.qk_norm_rope.launches
    out = InferenceSession(cfg, tasks, cuda)(model, data)
    torch.cuda.synchronize()
    # 24 embedder blocks, 4 frame and 4 global blocks, 4 passes of the 4-block camera trunk; 5 resizes a
    # DPT head call, one chunk of 8 frames a head; the q/k prologue in the 4 + 4 aggregator blocks alone
    assert (flash_attention.launches - before[0], interpolate_trilinear.launches - before[1],
            qnr.qk_norm_rope.launches - before[2]) == (48, 10, 8)
    plain = InferenceSession(cfg, tasks, cuda, attention=flash_attention_plain)(model, data)
    for key, band in VGGT_PATH_BANDS.items():
        a, b = out[key].double(), plain[key].double()
        rel = ((a - b).norm() / b.norm()).item()
        assert rel <= band, (key, rel)


# relative L2 of the kernel path against the plain path, about 4x what an H100 read (in brackets)
VGGT_PATH_BANDS = {"pose_enc": 2.5e-2,  # [5.6e-3]
                   "extrinsic": 3e-2,  # [6.7e-3]
                   "depth": 2e-4,  # [5.0e-5]
                   "depth_conf": 1e-4,  # [2.4e-5]
                   "world_points": 2.5e-2,  # [5.3e-3]
                   "world_points_conf": 1.5e-4}  # [3.5e-5]


# VGGT's attention prologue (ops/qk_norm_rope.py): a frame call's (B, N) and a global call's, 16 heads of 64
QK_SHAPES = [(64, 782), (1, 50048)]
QK_CASES = [(True, True), (True, False), (False, True)]  # (q/k norm, rope)


def qk_operands(b, n, cuda, seed):
    from l4p_tpu_torch.models.vggt import frame_positions
    from l4p_tpu_torch.ops.qk_norm_rope import Rope2D

    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = (2 * torch.randn((b, n, 3 * 16 * 64), generator=g, device=cuda) + 0.5).bfloat16()
    norms = tuple(((1 + 0.3 * torch.randn(64, generator=g, device=cuda)) if i % 2 == 0 else
                   0.2 * torch.randn(64, generator=g, device=cuda)).bfloat16() for i in range(4))
    return qkv, norms, Rope2D(frame_positions(21, 37, 5, cuda), 64, 100.0)  # 294 x 518: P = 5 + 21 * 37 = 782


@pytest.mark.gpu
@pytest.mark.parametrize("norm,rope", QK_CASES)
@pytest.mark.parametrize("b,n", QK_SHAPES)
def test_qk_norm_rope_kernel_matches_plain_on_card(cuda, b, n, norm, rope):
    """The kernel against its plain version run on the card, one launch a
    call: v moved bit for bit, q and k within QK_NORM_ROPE_TOL (the fp32
    LayerNorm sums in another order, so a few values round to the other
    bf16 neighbour), every output in the attention kernel's layout."""
    from l4p_tpu_torch.ops import qk_norm_rope as qnr
    from l4p_tpu_torch.ops.flash_attention import in_kernel_layout

    qkv, norms, table = qk_operands(b, n, cuda, 22)
    norms = norms if norm else None
    table = table if rope else None
    before = qnr.qk_norm_rope.launches
    got = qnr.qk_norm_rope(qkv, 16, 1e-6, norms, table)
    torch.cuda.synchronize()
    assert qnr.qk_norm_rope.launches == before + 1
    want = qnr.qk_norm_rope_plain(16, 1e-6, qkv, *(norms or (None,) * 4),
                                   *((table.cos, table.sin) if rope else (None, None)))
    assert all(in_kernel_layout(t) and t.shape == (b, 16, n, 64) for t in got)
    assert torch.equal(got[2], want[2])
    for g_, w in zip(got[:2], want[:2]):
        assert (g_.float() - w.float()).abs().max().item() <= QK_NORM_ROPE_TOL


# max |kernel - plain| of q and k, about 2x what an H100 read (in brackets): one bf16 step of values up to ~8
QK_NORM_ROPE_TOL = 0.0625  # [0.03125]


@pytest.mark.gpu
def test_qk_norm_rope_refuses_what_the_kernel_does_not_take(cuda):
    from l4p_tpu_torch.ops import qk_norm_rope as qnr

    qkv, norms, table = qk_operands(2, 782, cuda, 23)
    with pytest.raises(TypeError, match="bf16"):
        qnr.qk_norm_rope(qkv.float(), 16, 1e-6, norms, table)
    with pytest.raises(ValueError, match="multiple of 4"):
        qnr.qk_norm_rope(qkv[..., :3 * 6 * 64].contiguous(), 6, 1e-6, None, table)
    with pytest.raises(ValueError, match="rope table"):
        qnr.qk_norm_rope(qkv[:, :700].contiguous(), 16, 1e-6, norms, table)
    with pytest.raises(ValueError, match="contiguous"):
        qnr.qk_norm_rope(torch.cat([qkv, qkv], -1)[..., ::2], 16, 1e-6, norms, table)


@pytest.mark.gpu
def test_qk_norm_rope_off_the_vggt_blocks_and_no_attention_copy(cuda, monkeypatch):
    """The VGGT aggregator block hands the attention kernel q, k and v that
    its wrapper takes as they are (no `kernel_layout` copy); a VideoMAE
    block (no q/k norm, no rope) and VGGT's embedder block never launch the
    prologue."""
    from l4p_tpu_torch.config import GIANT, VGGTConfig
    from l4p_tpu_torch.models.encoder import Block
    from l4p_tpu_torch.models.vggt import frame_positions
    from l4p_tpu_torch.ops import flash_attention as fa
    from l4p_tpu_torch.ops import qk_norm_rope as qnr
    from l4p_tpu_torch.ops.qk_norm_rope import Rope2D

    copies = []
    layout = fa.kernel_layout
    monkeypatch.setattr(fa, "kernel_layout", lambda t: copies.append(t.shape) or layout(t))
    cfg = VGGTConfig()
    g = torch.Generator(device=cuda).manual_seed(24)
    cases = [(cfg.aggregator_block, Rope2D(frame_positions(21, 37, 5, cuda), 64, 100.0), 1, 0),
             (cfg.embed_block, None, 0, None), (GIANT.block, None, 0, None)]
    for block_cfg, rope, launches, n_copies in cases:
        blk = Block(block_cfg, device=cuda, dtype=torch.bfloat16).eval()
        x = torch.randn((2, 782, block_cfg.embed_dim), generator=g, device=cuda).bfloat16()
        before, copies[:] = qnr.qk_norm_rope.launches, []
        with torch.no_grad():
            out = blk(x, fa.flash_attention, rope=rope)
        torch.cuda.synchronize()
        assert bool(out.isfinite().all()) and qnr.qk_norm_rope.launches - before == launches, block_cfg
        if n_copies is not None:
            assert len(copies) == n_copies, copies


# Video Depth Anything's temporal attention: B*H past the grid's 65,535 rows of y (split over z) at T = 32
BEYOND_GRID_Y = [(9768, 8, 32, 32),  # the last motion module: 9,768 positions x 8 heads = 78,144 sequences
                 (2442, 8, 32, 128),  # the first: 19,536 sequences of 128-wide heads
                 (2, 16, 2048, 88)]  # a long shape of the encoder's, on one z slice as before


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BEYOND_GRID_Y)
def test_attention_kernel_beyond_the_grid_y_matches_plain(cuda, shape):
    """One launch a call at any B*H, within the band of the plain version
    relative to max |plain| (over 32 keys the outputs reach ~2, where a bf16
    step is 0.0156, so the absolute band of the long shapes does not fit);
    each (batch, head) computed alone, so the launch on the whole batch
    equals, bit for bit, launches on two parts of it that each fit the
    grid's y."""
    g = torch.Generator(device=cuda).manual_seed(31)
    b, h, n, d = shape
    q, k, v = (torch.randn(shape, generator=g, device=cuda).bfloat16() for _ in range(3))
    before = flash_attention.launches
    out = flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    plain = flash_attention_plain(q, k, v, d ** -0.5).float()
    err, top = (out.float() - plain).abs().max().item(), plain.abs().max().item()
    assert err <= BEYOND_GRID_Y_TOL * top, (err, top)
    half = b // 2
    parts = torch.cat([flash_attention(q[:half], k[:half], v[:half], d ** -0.5),
                       flash_attention(q[half:], k[half:], v[half:], d ** -0.5)])
    assert torch.equal(parts, out)


# max |kernel - plain| / max |plain|, about 4x what an H100 read over seeds 31-33 (in brackets)
BEYOND_GRID_Y_TOL = 0.03  # [7.2e-3 at (2, 16, 2048, 88); 5.5e-3 at the two T = 32 shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 16, 782, 64), (1, 16, 50048, 64)])
def test_attention_kernel_launches_and_results_unchanged_on_one_z_slice(cuda, shape):
    """VGGT's frame and global shapes keep one launch and the same results:
    B*H on the grid's y alone (one z slice), each (batch, head) bit for bit
    what a launch of that batch entry alone gives, and the whole within the
    band of the plain version (relative to max |plain| at 50,048 keys, as
    test_attention_kernel_at_vggt_global_shape reads it)."""
    g = torch.Generator(device=cuda).manual_seed(32)
    b, h, n, d = shape
    q, k, v = (torch.randn(shape, generator=g, device=cuda).bfloat16() for _ in range(3))
    before = flash_attention.launches
    out = flash_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    for i in sorted({0, b - 1}):
        assert torch.equal(flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], 0.125), out[i:i + 1])
    err = top = 0.0
    for i in range(0, n, 1024):
        want = flash_attention_plain(q[:, :, i:i + 1024], k, v, 0.125).float()
        err = max(err, (out[:, :, i:i + 1024].float() - want).abs().max().item())
        top = max(top, want.abs().max().item())
    assert err <= VGGT_GLOBAL_ATTENTION_TOL * top, (err, top)


@pytest.mark.gpu
def test_vda_stitch_never_syncs_on_card(cuda):
    """The long-video stitch (fits, blend, anchors) queues its work and never
    waits for the card: sync debug mode "error" raises on any blocking call."""
    from l4p_tpu_torch.models.vda import stitch_windows, take, window_frames

    g = torch.Generator(device=cuda).manual_seed(33)
    clip = torch.randint(0, 256, (1, 60, 4, 6, 3), generator=g, device=cuda, dtype=torch.uint8)
    windows = [torch.rand((1, 32, 64, 96), generator=g, device=cuda) for _ in window_frames(60)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        inputs = [take(clip, w) for w in window_frames(60)]
        depth, fits = stitch_windows(windows, 60)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert depth.shape == (1, 60, 64, 96) and fits.shape == (1, 2, 2) and len(inputs) == 3
    assert bool(depth.isfinite().all())


@pytest.mark.gpu
def test_vda_kernel_path_matches_plain_on_card(cuda):
    """Video Depth Anything at 44 frames of 294 x 518 (two windows) with 4
    encoder blocks (every other width published): the session on the
    attention and resize kernels against the session on the plain
    attention, the clip within the band below of the plain path's, and the
    kernel launches counted."""
    import dataclasses

    from l4p_tpu_torch.config import VDAConfig
    from l4p_tpu_torch.inference import InferenceSession
    from l4p_tpu_torch.models.vda import VideoDepthAnything, load_upstream_state_dict, upstream_name
    from l4p_tpu_torch.ops.resize import interpolate_trilinear
    from portbench.drivers.vda import POSITIVE
    from portbench.drivers.vggt import seeded_weights

    base = VDAConfig()
    cfg = dataclasses.replace(base, encoder=dataclasses.replace(base.encoder, depth=4), intermediate_layers=(0, 1, 2, 3))
    model = VideoDepthAnything(cfg, device=cuda, dtype=torch.bfloat16).eval()
    w = seeded_weights(model, 23, cuda, torch.bfloat16, upstream_name)
    w.update({k: w[k].abs() for k in POSITIVE})
    w.update({k: v for k, v in model.state_dict().items() if k.endswith(".pe")})
    load_upstream_state_dict(model, w)
    g = torch.Generator(device=cuda).manual_seed(25)
    data = {"rgb_u8_bthw3": torch.randint(0, 256, (1, 44, 294, 518, 3), generator=g, device=cuda, dtype=torch.uint8)}
    before = flash_attention.launches, interpolate_trilinear.launches
    out = InferenceSession(cfg, ("depth",), cuda)(model, data)["depth"]
    torch.cuda.synchronize()
    # a window: 4 encoder blocks and 4 motion modules of 2 temporal attentions; refinenet4 and refinenet3 resize
    # once, then each chunk of 4 frames refinenet2, refinenet1 and the output resize
    assert (flash_attention.launches - before[0], interpolate_trilinear.launches - before[1]) == (2 * 12, 2 * 26)
    plain = InferenceSession(cfg, ("depth",), cuda, attention=flash_attention_plain)(model, data)["depth"]
    assert out.shape == (1, 44, 294, 518) and out.dtype == torch.float32 and bool(out.isfinite().all())
    rel = ((out.double() - plain.double()).norm() / plain.double().norm()).item()
    assert 0 < plain.double().norm() and rel <= VDA_PATH_BAND, rel


# relative L2 of the kernel path's clip against the plain path's, about 4x what an H100 read over seeds 23, 24, 26
VDA_PATH_BAND = 8e-3  # [1.83e-3]


# SAM 2's memory attention: one head of 256 over the bank (4,096 + 64 keys when one memory and 16 pointers
# are read, 28,736 at steady state, 20,496 while the bank fills: off the 64-key tile), 8 objects
MEMORY_ATTENTION = [((8, 1, 4096, 256), 28736), ((8, 1, 4096, 256), 4096 + 64), ((8, 1, 4096, 256), 20496),
                    ((1, 1, 64, 256), 64), ((1, 2, 300, 256), 77), ((2, 1, 130, 136), 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,nk", MEMORY_ATTENTION)
def test_attention_kernel_at_head_dim_256_matches_plain(cuda, shape, nk):
    """The D_pad 256 instantiation (64-key tiles, 2 stages) in one launch,
    within the band of the plain version relative to max |plain|, as the
    long shapes read it (the absolute band does not fit outputs near 1 over
    28,736 keys); a one-tile shape, ragged Nq and Nk and D = 136 (padded to
    256) among them."""
    g = torch.Generator(device=cuda).manual_seed(34)
    b, h, nq, d = shape
    q = torch.randn(shape, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((b, h, nk, d), generator=g, device=cuda).bfloat16() for _ in range(2))
    before = flash_attention.launches
    out = flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and bool(out.isfinite().all())
    err = top = 0.0
    for i in range(0, nq, 1024):
        want = flash_attention_plain(q[:, :, i:i + 1024], k, v, d ** -0.5).float()
        err = max(err, (out[:, :, i:i + 1024].float() - want).abs().max().item())
        top = max(top, want.abs().max().item())
    assert err <= HEAD_DIM_256_TOL * top, (err, top)


# max |kernel - plain| / max |plain| at head dim 256, about 4x what an H100 read (in brackets)
HEAD_DIM_256_TOL = 0.03  # [5.8e-3 at (8, 1, 4096, 4160, 256), 3.6e-3 to 5.1e-3 at the others]

# sha256 (first 16 hex digits) of the bf16 output of the D <= 128 instantiations at the other cells' shapes,
# from seed 7's inputs, as the kernel before the D_pad 256 instantiation computed them on an H100
PARENT_DIGESTS = {((2, 16, 2048, 88), 2048): "8dec81e2dbd434c3",  # L4P's encoder
                  ((1, 16, 50048, 64), 50048): "204dafcd96595c19",  # VGGT's global attention
                  ((9768, 8, 32, 32), 32): "28cb0438aa9ebfb3",  # Video Depth Anything's temporal attention
                  ((64, 16, 782, 64), 782): "3debc191c0884c88"}  # VGGT's frame attention


@pytest.mark.gpu
@pytest.mark.parametrize("shape,nk", list(PARENT_DIGESTS))
def test_attention_kernel_up_to_head_dim_128_unchanged_bit_for_bit(cuda, shape, nk):
    import hashlib

    g = torch.Generator(device=cuda).manual_seed(7)
    b, h, nq, d = shape
    q = torch.randn(shape, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((b, h, nk, d), generator=g, device=cuda).bfloat16() for _ in range(2))
    out = flash_attention(q, k, v, d ** -0.5)
    digest = hashlib.sha256(out.cpu().view(torch.int16).numpy().tobytes()).hexdigest()[:16]
    assert digest == PARENT_DIGESTS[(shape, nk)]


@pytest.mark.gpu
def test_sam2_propagates_on_the_kernels_without_a_host_sync(cuda):
    """SAM 2 at a tiny width (tests/test_torch_sam2.py's) in bf16 on the card,
    on the benchmark driver's seeded weights: a 10-frame, 2-object
    propagation never blocks the host (sync debug mode "error" raises on
    any blocking call), every Hiera call (a chunk of frames each) and every
    memory-attention call launches the attention kernel, and the masks lie
    within the band below of the plain attention's."""
    from l4p_tpu_torch.config import Sam2Config
    from l4p_tpu_torch.inference import InferenceSession
    from l4p_tpu_torch.models import sam2
    from portbench.drivers.sam2 import PRESENT
    from portbench.drivers.vggt import seeded_weights

    cfg = Sam2Config(image_size=128, embed_dim=8, num_heads=1, stages=(1, 1, 2, 1), global_att_blocks=(3,),
                     window_pos_embed_bkg_spatial_size=(3, 3), window_spec=(4, 2, 4, 2), d_model=32, memory_ffn=64,
                     mem_dim=8, num_maskmem=3, max_obj_ptrs=4)
    t, n = 10, 2
    model = sam2.Sam2(cfg, device=cuda, dtype=torch.bfloat16).eval()
    w = seeded_weights(model, 25, cuda, torch.bfloat16, sam2.upstream_name)
    w[PRESENT] = 1.0 + w[PRESENT].abs()
    sam2.load_upstream_state_dict(model, w)
    g = torch.Generator(device=cuda).manual_seed(26)
    data = {"rgb_u8_bthw3": torch.randint(0, 256, (1, t, 128, 128, 3), generator=g, device=cuda, dtype=torch.uint8),
            "point_coords_bnk2": 8 + 112 * torch.rand((1, n, 1, 2), generator=g, device=cuda),
            "point_labels_bnk": torch.ones((1, n, 1), device=cuda, dtype=torch.int64)}
    sess = InferenceSession(cfg, ("masks",), cuda)
    sess(model, data)  # the kernels built and loaded
    torch.cuda.synchronize()
    before = flash_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sess(model, data)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    chunks = -(-t // sam2.ENCODE_CHUNK)  # the image encoder's calls, each of up to ENCODE_CHUNK frames
    assert flash_attention.launches - before == chunks * sum(cfg.stages) + (t - 1) * 2 * cfg.memory_layers
    plain = InferenceSession(cfg, ("masks",), cuda, attention=flash_attention_plain)(model, data)
    got, want = out["mask_logits_btnhw"].double(), plain["mask_logits_btnhw"].double()
    assert got.shape == (1, t, n, 128, 128) and bool(got.isfinite().all())
    assert ((got - want).norm() / want.norm()).item() <= SAM2_PATH_BAND


# relative L2 of the kernel path's masks against the plain path's at the tiny width with the published decoder
# (bf16 both), 6-9x what an H100 read on the driver's weights of seeds 25, 27 and 28 (in brackets)
SAM2_PATH_BAND = 0.05  # [0.0084, 0.0058, 0.0089]


# LayerNorm's rows and widths in the cells: L4P's encoder (1408) and track head (256), VGGT's and VDA's DINOv2
# (1024, VDA's rows a window of 32 frames of 2443 tokens), SAM 2's Hiera stages (144-1152), memory attention (256)
# and its mask downsampler's channels (4, 16)
LAYER_NORMS = [(4096, 1408, 1e-6), (2443, 1024, 1e-6), (50048, 1024, 1e-5), (4096, 256, 1e-5), (65536, 144, 1e-6),
               (16384, 288, 1e-6), (4096, 576, 1e-6), (1024, 1152, 1e-6), (65536, 4, 1e-6), (16384, 16, 1e-6)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rows,width,eps", LAYER_NORMS)
def test_layer_norm_in_one_kernel_is_the_upcast_expression(cuda, rows, width, eps, dtype):
    """ops/conv.py's layer_norm with parameters of x's dtype (one F.layer_norm
    call on x) equals the upcast expression it stands for bit for bit, on a
    whole tensor and on a strided view that starts one token in."""
    from l4p_tpu_torch.ops.conv import layer_norm

    g = torch.Generator(device=cuda).manual_seed(rows + width)
    x = (3 * torch.randn((2, rows + 1, width), generator=g, device=cuda) + 1).to(dtype)
    w = (1 + 0.3 * torch.randn((width,), generator=g, device=cuda)).to(dtype)
    b = (0.2 * torch.randn((width,), generator=g, device=cuda)).to(dtype)
    for t in (x, x[:, 1:]):
        want = torch.nn.functional.layer_norm(t.float(), (width,), w.float(), b.float(), eps).to(dtype)
        assert torch.equal(layer_norm(t, w, b, eps), want)
