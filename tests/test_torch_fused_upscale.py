"""The plain version of the port's upscale + hypernetwork kernel
(ops/fused_upscale) against the JAX package's Pallas kernel in interpret
mode and its XLA chain, at the tests/test_fused_upscale.py shapes, fp32 on
the CPU; and the wrapper's packed weight layout, emulated in plain PyTorch."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from l4p_tpu_torch.ops import fused_upscale as FU
from tests.test_torch_ops import check

torch.set_num_threads(1)


def inputs(seed, n=3, p=16, c=64, d1=24, d2=12, m=3):
    rng = np.random.default_rng(seed)

    def mk(shape, scale, shift=0.0):
        return (shift + rng.standard_normal(shape) * scale).astype(np.float32)

    return (mk((n, p, c), 0.3), mk((c, d1, 2, 2, 2), 0.05), mk((d1,), 0.1), mk((d1,), 0.1, 1.0), mk((d1,), 0.1),
            mk((d1, d2, 1, 2, 2), 0.1), mk((d2,), 0.1), mk((n, m, d2), 0.3))


SHAPES = {
    "aligned": dict(),
    "nonaligned": dict(p=8, c=32, d1=20, d2=10),  # d1, d2 not multiples of the kernel's padding
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_matches_pallas_interpret_and_xla(shape):
    from l4p_tpu.ops.fused_upscale import _upscale_xla, fused_upscale_hypernet

    args = inputs(0, **SHAPES[shape])
    out = FU.fused_upscale_hypernet(*(torch.from_numpy(a) for a in args))
    n, p = args[0].shape[:2]
    assert out.shape == (n, 3, p, 8, 4) and out.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in args]
    check(out, _upscale_xla(*jargs), 4e-7, "xla")  # measured <= 2.0e-7
    check(out, fused_upscale_hypernet(*jargs, True), 4e-7, "pallas")  # measured <= 2.1e-7


def packed_emulation(src, w1, b1, lnw, lnb, w2, b2, hyper):
    """The kernel's arithmetic in plain PyTorch on the wrapper's packed
    operands (ops/fused_upscale.pack_weights), fp32."""
    w1t, b1p, lnwp, lnbp, w2t, b2p = FU.pack_weights(w1, b1, lnw, lnb, w2, b2)
    d1 = w1.shape[1]
    d2p = w2t.shape[1]
    hyp = torch.zeros((*hyper.shape[:2], d2p))
    hyp[..., : hyper.shape[-1]] = hyper
    x1 = torch.einsum("npc,kdc->npkd", src, w1t.float()) + b1p  # (N, P, k1, D1P)
    xv = x1[..., :d1]
    mean = xv.mean(-1, keepdim=True)
    var = ((xv - mean) ** 2).mean(-1, keepdim=True)
    y = F.gelu((x1 - mean) * torch.rsqrt(var + FU.LN_EPS) * lnwp + lnbp)
    y[..., d1:] = 0.0
    x2 = F.gelu(torch.einsum("npkd,led->npkle", y, w2t.float()) + b2p)  # (N, P, k1, k2, D2P)
    return torch.einsum("npkle,nme->nmpkl", x2, hyp)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_packed_layout_computes_the_plain_function(shape):
    """The weights' transposes and zero padding that the card's kernel reads
    give the plain version's result (bf16 rounding of the packed weights is
    the only difference, so the inputs are bf16-exact)."""
    args = [torch.from_numpy(a).bfloat16().float() for a in inputs(1, **SHAPES[shape])]
    check(packed_emulation(*args), FU.fused_upscale_hypernet_plain(*args), 6e-7)  # measured <= 2.7e-7


def test_wrapper_checks_shapes():
    args = [torch.from_numpy(a) for a in inputs(3)]
    with pytest.raises(ValueError, match="incompatible"):
        FU.fused_upscale_hypernet(*args[:7], args[7][:, :, :5])
