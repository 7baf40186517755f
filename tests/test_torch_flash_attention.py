"""Encoder attention of the port on the CPU: the plain version against the
JAX Pallas kernel (interpret mode), the wrapper's CPU contract and the kernel
build helper. The CUDA kernel itself is tested on a card by test_torch_gpu.py.
"""

import os

import pytest
import torch

import jax.numpy as jnp

from l4p_tpu_torch import _build
from l4p_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from tests.test_flash_attention import _flash_interpret
from tests.test_torch_ops import check, rand

torch.set_num_threads(1)


@pytest.mark.parametrize("n,d", [(512, 88), (256, 128)])
def test_plain_matches_pallas_kernel(n, d):
    q, k, v = (rand((1, 4, n, d), s) for s in range(3))
    ref = _flash_interpret(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d ** -0.5)
    # measured <= 7.0e-7 (fp32, the same softmax in another summation order)
    check(flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), d ** -0.5), ref, 1.4e-6)


def test_wrapper_runs_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(rand((2, 3, 40, 16), s)) for s in range(3))
    before = flash_attention.launches
    out = flash_attention(q, k, v, 0.25)
    assert torch.equal(out, flash_attention_plain(q, k, v, 0.25))
    assert flash_attention.launches == before  # no kernel ran


@pytest.mark.parametrize("k_shape", [(2, 3, 40, 8), (2, 4, 40, 16), (3, 40, 16)])
def test_wrapper_rejects_mismatched_shapes(k_shape):
    q = torch.zeros(2, 3, 40, 16)
    kv = torch.zeros(k_shape)
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv, 0.25)


def test_library_name_follows_source_content(tmp_path):
    """An edited source gets a new library name, so it is rebuilt."""
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    first = _build.library_path("k", [str(src)])
    src.write_text("// v2\n")
    assert _build.library_path("k", [str(src)]) != first
    assert os.path.dirname(first) == _build.BUILD_DIR
    cmd = _build.nvcc_command("nvcc", [str(src)], "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
