"""Port DPT heads vs the JAX heads at the tiny config (fp32, CPU), and the
port's state dict against the JAX package's strict checkpoint converter."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l4p_tpu_torch import L4P, params_from_jax
from l4p_tpu_torch.models.dpt import rescale_kind
from tests.test_torch_encoder import tiny_models
from tests.test_torch_ops import check, rand

torch.set_num_threads(1)


@pytest.mark.parametrize("task", ["flow_2d_backward", "depth", "dyn_mask", "camray"])
def test_dense_head_matches_jax(task):
    """DPT trunk + activation on the same hook features; the tiny encoder's
    2x2x2 token grid runs every branch of the giant head (deconv up, identity,
    strided-conv down, fusion upsampling, the path4 crop, the final resize),
    and camray its variant (time-only deconvs, unit fusion scales, the fixed
    output size)."""
    from l4p_tpu.models.l4p import dense_head_raw

    jcfg, jparams, _, model = tiny_models()
    hcfg = jcfg.head_dict[task]
    feats = [rand((2, 8, 64), s) for s in range(4)]
    ref = dense_head_raw(jparams["task_heads"][task], hcfg, [jnp.asarray(f) for f in feats], (4, 28, 28))
    with torch.no_grad():
        out = model.task_heads[task]([torch.from_numpy(f) for f in feats], (4, 28, 28))
    check(out, ref, 1.1e-7)  # measured <= 5.1e-8


def test_rescale_kind_dispatch():
    assert [rescale_kind(sf) for sf in ((1, 2, 2), (0, 0, 0), (-1, -1, -1))] == ["up", "id", "down"]
    with pytest.raises(ValueError):
        rescale_kind((1, -1, 0))


def test_port_state_dict_is_the_released_layout():
    """The port's state dict, under the Lightning `l4p_model.` prefix, goes
    through the JAX package's strict converter (which reads the released
    checkpoint's names, alias keys included) without a missing or unused
    key, and comes back unchanged through params_from_jax."""
    import dataclasses

    from l4p_tpu.config import convert_l4p

    jcfg, _, pcfg, _ = tiny_models()
    jcfg_dense = dataclasses.replace(jcfg, heads=tuple((n, h) for n, h in jcfg.heads if n in pcfg.head_dict))
    model = L4P(pcfg)
    g = torch.Generator().manual_seed(0)
    model.init_weights(g)
    sd = model.state_dict()
    params = convert_l4p({f"l4p_model.{k}": v.numpy() for k, v in sd.items()}, jcfg_dense, strict=True)
    back = params_from_jax(jax.tree.map(np.asarray, params), pcfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
