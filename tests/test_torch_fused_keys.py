"""The plain versions of the port's two-way transformer kernels (ops/fused_keys)
against the JAX package's Pallas kernels run in interpret mode, at the
tests/test_fused_keys.py scale (C = 128, P = 256, 8 heads of 6 tokens), fp32
on the CPU. On the CPU the wrappers run the plain versions; the kernels
themselves are held against them on the card (tests/test_torch_gpu.py)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from l4p_tpu_torch.ops import fused_keys as FK
from tests.test_torch_ops import check, rand

torch.set_num_threads(1)

N, P, C, HEADS, Q = 3, 256, 128, 8, 6
K = HEADS * Q


@functools.lru_cache(maxsize=None)
def operands(seed: int = 0, p: int = P):
    """keys, st, spe, r, per, v2, ob, lnw, lnb, st2, spe2 as float32 numpy,
    with the magnitudes the factored prep produces."""
    return (
        rand((N, p, C), seed) * 0.5,
        rand((N, C, K), seed + 1) * 0.1,
        rand((N, p, K), seed + 2),
        rand((N, C, K), seed + 3) * 0.1,
        rand((N, p, K), seed + 4),
        rand((N, K, C), seed + 5) * 0.3,
        rand((C,), seed + 6) * 0.1,
        1.0 + rand((C,), seed + 7) * 0.1,
        rand((C,), seed + 8) * 0.1,
        rand((N, C, K), seed + 9) * 0.1,
        rand((N, p, K), seed + 10),
    )


@pytest.mark.parametrize("seed", [0, 5])
def test_t2i_flash_plain_matches_pallas_interpret(seed):
    from l4p_tpu.ops.fused_keys import t2i_flash

    keys, st, spe = operands(seed)[:3]
    ref = t2i_flash(jnp.asarray(keys), jnp.asarray(st), jnp.asarray(spe), interpret=True)
    out = FK.t2i_flash(*(torch.from_numpy(a) for a in (keys, st, spe)))
    assert out.dtype == torch.float32 and out.shape == (N, K, C)
    # the kernel's online softmax against one softmax over P: measured <= 3.0e-7
    check(out, ref, 6e-7)


@pytest.mark.parametrize("seed", [0, 5])
def test_i2t_ln_t2i_plain_matches_pallas_interpret(seed):
    from l4p_tpu.ops.fused_keys import group_sum_matrix, i2t_ln_t2i

    keys, _, _, r, per, v2, ob, lnw, lnb, st2, spe2 = operands(seed)
    ref_keys, ref_wsum = i2t_ln_t2i(
        jnp.asarray(keys), jnp.asarray(r), jnp.asarray(per), jnp.asarray(v2), group_sum_matrix(HEADS, Q),
        jnp.asarray(ob), jnp.asarray(lnw), jnp.asarray(lnb), jnp.asarray(st2), jnp.asarray(spe2),
        eps=1e-5, interpret=True,
    )
    t = [torch.from_numpy(a) for a in (keys, r, per, v2, ob, lnw, lnb, st2, spe2)]
    out_keys, out_wsum = FK.i2t_ln_t2i(*t, HEADS, 1e-5)
    assert out_keys.shape == (N, P, C) and out_wsum.shape == (N, K, C)
    check(out_keys, ref_keys, 1.5e-6, "keys")  # measured <= 7.0e-7
    check(out_wsum, ref_wsum, 1.5e-6, "wsum")  # measured <= 7.6e-7


def test_ragged_p_plain_matches_float64():
    """P = 200, which no Pallas kernel takes (it needs P % 128 == 0) and the
    card's kernels mask: the plain version against float64 numpy."""
    keys, st, spe = operands(2, 200)[:3]
    lg = np.einsum("npc,nck->npk", keys.astype(np.float64), st) + spe
    e = np.exp(lg - lg.max(axis=1, keepdims=True))
    ref = np.einsum("npk,npc->nkc", e / e.sum(axis=1, keepdims=True), keys.astype(np.float64))
    check(FK.t2i_flash(*(torch.from_numpy(a) for a in (keys, st, spe))), ref, 3e-7)  # measured 1.4e-7


def test_wrappers_check_shapes():
    keys, st, spe = (torch.from_numpy(a) for a in operands(0)[:3])
    with pytest.raises(ValueError, match="incompatible"):
        FK.t2i_flash(keys, st[:, :, :40], spe)
    args = [torch.from_numpy(a) for a in operands(0)]
    with pytest.raises(ValueError, match="incompatible"):
        FK.i2t_ln_t2i(args[0], *args[3:], 7)  # 48 tokens do not split into 7 heads


def test_i2t_ln_t2i_ragged_p_plain_matches_float64():
    """P = 200 with K2 = 32 != K = 48 (the case the card's kernels mask and
    reduce over separate token widths): the plain version against float64
    numpy, i2t softmax per head, residual LayerNorm and the next t2i."""
    keys, _, _, r, per, v2, ob, lnw, lnb = operands(3, 200)[:9]
    k2 = 32
    st2, spe2 = rand((N, C, k2), 20) * 0.1, rand((N, 200, k2), 21)
    f = [a.astype(np.float64) for a in (keys, r, per, v2, ob, lnw, lnb, st2, spe2)]
    lg = (np.einsum("npc,nck->npk", f[0], f[1]) + f[2]).reshape(N, 200, HEADS, Q)
    e = np.exp(lg - lg.max(axis=-1, keepdims=True))
    attn = (e / e.sum(axis=-1, keepdims=True)).reshape(N, 200, K)
    y = f[0] + np.einsum("npk,nkc->npc", attn, f[3]) + f[4]
    mu = y.mean(axis=-1, keepdims=True)
    ref_keys = (y - mu) / np.sqrt(((y - mu) ** 2).mean(axis=-1, keepdims=True) + 1e-5) * f[5] + f[6]
    lg2 = np.einsum("npc,nck->npk", ref_keys, f[7]) + f[8]
    e2 = np.exp(lg2 - lg2.max(axis=1, keepdims=True))
    ref_wsum = np.einsum("npk,npc->nkc", e2 / e2.sum(axis=1, keepdims=True), ref_keys)
    out_keys, out_wsum = FK.i2t_ln_t2i(*(torch.from_numpy(a) for a in (keys, r, per, v2, ob, lnw, lnb, st2, spe2)),
                                       HEADS, 1e-5)
    assert out_keys.shape == (N, 200, C) and out_wsum.shape == (N, k2, C)
    check(out_keys, ref_keys, 2e-6, "keys")  # measured 6.4e-7
    check(out_wsum, ref_wsum, 2e-6, "wsum")  # measured 5.8e-7


# keys rows a cluster takes at P = 2048: P split until MIN_CLUSTERS clusters run
SPLIT_ROWS = {1: 128, 16: 1024, 32: 2048, 64: 2048, 128: 2048, 192: 2048}


@pytest.mark.parametrize("n", sorted(SPLIT_ROWS))
def test_kernel_plan_at_the_track_head_shapes(n):
    """The wrappers' plan at the giant track head's shape (P = 2048, C = 1408,
    K = K2 = 48) for the query counts the paths take (one query, the
    data-parallel ranks' 16 / 32 / 64, a chunk of 128, 192): rows per
    cluster, the P-split workspace, and the kernel build; a ragged P = 2000
    plans as 2048 does."""
    split = FK.split_rows(n, 2048)
    assert split == SPLIT_ROWS[n] and FK.split_rows(n, 2000) == split
    splits = 2048 // split
    acc, m, l = FK._workspace(torch.empty((n, 2048, 1408), device="meta"), 48, split)
    if splits == 1:
        assert (acc.shape, m.shape, l.shape) == ((0, 1, 48, 0), (0, 1, 48), (0, 1, 48))
    else:
        assert (acc.shape, m.shape, l.shape) == ((n, splits, 48, 1408), (n, splits, 48), (n, splits, 48))
    assert FK.kernel_variant(1408, 48, i2t=True) == FK.kernel_variant(1408, 48, i2t=False) == "nt48"


def test_kernel_variants_by_width():
    """Which build serves a launch: the token width of the weighted sum, and
    t2i_flash's widest blocks past C = 2816 (16 blocks of 11 boxes)."""
    assert FK.kernel_variant(1408, 64, i2t=True) == "nt64"
    assert FK.kernel_variant(2816, 32, i2t=False) == "nt48"
    assert FK.kernel_variant(2832, 32, i2t=False) == "wide"
    assert FK.kernel_variant(4096, 48, i2t=False) == FK.kernel_variant(6144, 64, i2t=False) == "wide"
    assert set(FK.t2i_flash.variant_launches) == {"nt48", "nt64", "wide"}
    assert set(FK.i2t_ln_t2i.variant_launches) == {"nt48", "nt64"}
