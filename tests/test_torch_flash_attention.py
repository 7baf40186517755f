"""Encoder attention of the port on the CPU: the plain version against the
JAX Pallas kernel (interpret mode) and the wrapper's CPU contract (the CPU
path itself is a case of tests/test_torch_build.py). The CUDA kernel itself
is tested on a card by test_torch_gpu.py.
"""

import pytest
import torch

import jax.numpy as jnp

from l4p_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_plain, in_kernel_layout,
                                               kernel_layout, kernel_row_pitch, kernel_unsupported)
from tests.test_flash_attention import _flash_interpret
from tests.test_torch_ops import check, rand

torch.set_num_threads(1)


@pytest.mark.parametrize("n,d", [(512, 88), (256, 128)])
def test_plain_matches_pallas_kernel(n, d):
    q, k, v = (rand((1, 4, n, d), s) for s in range(3))
    ref = _flash_interpret(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d ** -0.5)
    # measured <= 7.0e-7 (fp32, the same softmax in another summation order)
    check(flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), d ** -0.5), ref, 1.4e-6)


@pytest.mark.parametrize("k_shape", [(2, 3, 40, 8), (2, 4, 40, 16), (3, 40, 16)])
def test_wrapper_rejects_mismatched_shapes(k_shape):
    q = torch.zeros(2, 3, 40, 16)
    kv = torch.zeros(k_shape)
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv, 0.25)


@pytest.mark.parametrize("bh,nq,nk,d,why", [(32, 2048, 2048, 88, None), (1, 1, 1, 128, None),
                                             (32, 2048, 2048, 12, "multiple of 8"), (4, 64, 64, 264, "at most 256"),
                                             (4, 64, 64, 136, None), (8, 4096, 28736, 256, None),
                                             (70000, 64, 64, 64, None), (78144, 32, 32, 32, None),
                                             (2 ** 31 - 65535, 32, 32, 32, None),
                                             (2 ** 31 - 65534, 32, 32, 32, "B*H"), (2 ** 31, 32, 32, 32, "B*H"),
                                             (0, 64, 64, 64, "B*H"),
                                             (4, 0, 64, 64, "positive")])
def test_kernel_checks_what_tma_cannot_take(bh, nq, nk, d, why):
    """The checks the wrapper makes on CUDA tensors before the launch: TMA rows
    of whole 16-byte units, D at most 256 (SAM 2's memory attention: one
    head of 256 over 28,736 keys), B*H from 1 to MAX_BH (the grid
    spreads it over y and z, so Video Depth Anything's 78,144 temporal
    sequences a call fit; past MAX_BH the launcher's grid arithmetic would
    leave an int)."""
    reason = kernel_unsupported(bh, nq, nk, d)
    assert (reason is None) if why is None else (why in reason)


@pytest.mark.parametrize("shape", [(2, 3, 40, 88), (1, 1, 1, 16), (2, 1, 5, 72), (1, 4, 1, 24)])
def test_kernel_layout_pads_rows_and_keeps_values(shape):
    """The layout the wrapper hands the kernel: the same values, rows a
    multiple of 16 elements apart; other layouts it copies into it."""
    x = torch.from_numpy(rand(shape, 5)).transpose(1, 2).contiguous().transpose(1, 2)  # (B, N, H, D) memory
    y = kernel_layout(x)
    assert torch.equal(y, x) and y.shape == x.shape
    assert in_kernel_layout(y) and y.stride(2) == kernel_row_pitch(shape[3]) and kernel_row_pitch(shape[3]) % 16 == 0
    # contiguous rows are the kernel's layout only where D is a multiple of 16
    assert in_kernel_layout(x.contiguous()) == (shape[3] % 16 == 0)
    assert shape[3] % 16 == 0 or not in_kernel_layout(x)


def test_wrapper_runs_plain_version_on_padded_rows_on_cpu():
    q, k, v = (kernel_layout(torch.from_numpy(rand((2, 3, 40, 24), s))) for s in range(3))
    before = flash_attention.launches
    out = flash_attention(q, k, v, 0.25)
    assert torch.equal(out, flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), 0.25))
    assert flash_attention.launches == before

