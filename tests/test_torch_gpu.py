"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and CUDA (tests/conftest.py imports jax, hence
--noconftest there):

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q
"""

import pytest
import torch

from l4p_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,nk", [((2, 16, 2048, 88), 2048), ((1, 8, 512, 64), 512), ((1, 2, 1000, 88), 1000),
                                      ((1, 4, 300, 128), 300)])
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
    # on an H100 for N(0, 1) inputs
    assert (out.float() - plain.float()).abs().max().item() <= 8e-3


@pytest.mark.gpu
def test_kernel_raises_instead_of_falling_back(cuda):
    q = torch.zeros(1, 2, 64, 88, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q, q, q, 0.1)  # fp32
    qb = torch.zeros(1, 64, 2, 88, device=cuda, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError):
        flash_attention(qb, qb, qb, 0.1)  # not contiguous
    with pytest.raises(ValueError):
        flash_attention(qb.contiguous(), qb.contiguous().cpu(), qb.contiguous(), 0.1)  # two devices


def tiny_cfg():
    """The tests' tiny dims (tests/test_l4p_forward.py tiny_cfg), built in code:
    no YAML parser is promised where the card is."""
    import dataclasses

    from l4p_tpu_torch.config import EncoderConfig, L4PConfig, default_dense_heads

    dpt = dict(hooks=(1, 2, 3, 4), layer_dims=(8, 8, 16, 16), feature_dim=8, last_dim=8, dim_tokens=64)
    heads = tuple((n, dataclasses.replace(h, dpt=dataclasses.replace(h.dpt, **dpt)))
                  for n, h in default_dense_heads().items())
    enc = EncoderConfig(img_size=28, patch_size=14, embed_dim=64, depth=4, num_heads=4, all_frames=4)
    return L4PConfig(encoder=enc, window_size=(4, 28, 28), window_stride_t=2, heads=heads)


@pytest.mark.gpu
def test_session_on_card_matches_plain_attention(cuda):
    """The tiny slice in bf16 on the card: 8 tokens per window (a ragged
    64-row tile), 3 windows in chunks of 2 + 1, 4 blocks each."""
    from l4p_tpu_torch import L4P, SLICE_TASKS, InferenceSession

    cfg = tiny_cfg()
    g = torch.Generator(device=cuda).manual_seed(0)
    model = L4P(cfg, device=cuda, dtype=torch.bfloat16).eval()
    model.init_weights(g)
    data = {"rgb_u8_bthw3": torch.randint(0, 256, (1, 8, 28, 28, 3), generator=g, device=cuda, dtype=torch.uint8)}
    before = flash_attention.launches
    out = InferenceSession(cfg, SLICE_TASKS, cuda)(model, data)
    assert flash_attention.launches - before == 4 * 2
    ref = InferenceSession(cfg, SLICE_TASKS, cuda, attention=flash_attention_plain)(model, data)
    for k, r in ref.items():
        assert out[k].shape == r.shape and torch.isfinite(out[k]).all()
        # the band chip_smoke.py holds the giant model to, relative to the output's largest value
        assert (out[k].float() - r.float()).abs().max().item() <= 3e-2 * r.float().abs().max().item(), k
