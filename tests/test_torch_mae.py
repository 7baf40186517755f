"""The port's VideoMAE model (l4p_tpu_torch/models/mae.py) against the JAX
package's (l4p_tpu/models/mae.py), fp32 on the CPU: the registry; the
masked encoder, the forward and the pretraining loss on JAX's tube masks;
every parameter's gradient against jax.grad; one upstream-layout state dict
loaded strictly into the port and through `convert_mae` into JAX; the round
trip through `mae_params_from_jax`; the port's tube sampler; init_weights'
distributions against init_mae_params'.

Two configs: the JAX script's `tiny` one (2 x 2 patches, 4 frames, ratio
0.9: 2 visible tokens) and a wider one (4 x 4 patches, 6 frames, ratio
0.75: 12 visible, 36 masked tokens, neither a multiple of 8; the giant
MLP ratio 48/11, so odd MLP widths 418 and 209; a decoder head dim 16).

JAX's tree holds the two fixed sinusoid tables as leaves: the encoder's
`pos_embed` (zero gradient through stop_gradient) and `decoder_pos_embed`
(a gradient of its own). The port keeps both as buffers, as upstream does
(ROADMAP.md section 3), so they have no port gradient to compare."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l4p_tpu_torch.checkpoint import mae_params_from_jax
from l4p_tpu_torch.config import EncoderConfig
from l4p_tpu_torch.models import mae as PM
from l4p_tpu_torch.pretrain_mae import mae_config
from tests.test_torch_ops import _same, check, rand

torch.set_num_threads(1)
jax.config.update("jax_default_matmul_precision", "highest")

T = torch.from_numpy
# (encoder, decoder (embed, depth, heads), mask ratio); both 2 x 14 x 14 x 3 pixels a tubelet
CONFIGS = {
    "tiny": (dict(img_size=28, patch_size=14, embed_dim=64, depth=2, num_heads=4, mlp_ratio=4.0, all_frames=4),
             (32, 1, 2), 0.9),
    "wide": (dict(img_size=56, patch_size=14, embed_dim=96, depth=3, num_heads=4, mlp_ratio=48 / 11, all_frames=6),
             (48, 2, 3), 0.75),
}


def jax_config(name):
    from l4p_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
    from l4p_tpu.models.mae import MAEConfig as JaxMAEConfig

    enc, (de, dd, dh), _ = CONFIGS[name]
    return JaxMAEConfig(encoder=JaxEncoderConfig(**enc), decoder_embed_dim=de, decoder_depth=dd, decoder_num_heads=dh,
                        decoder_num_classes=3 * 2 * 14 * 14)


def port_config(jcfg) -> PM.MAEConfig:
    return _same(PM.MAEConfig, jcfg, encoder=_same(EncoderConfig, jcfg.encoder))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def models(name):
    """(JAX config, JAX params, port config, port model) on the same weights;
    shared by the tests, which do not modify them."""
    from l4p_tpu.models.mae import init_mae_params

    jcfg = jax_config(name)
    jparams = init_mae_params(jcfg, jax.random.PRNGKey(0))
    pcfg = port_config(jcfg)
    model = PM.MAE(pcfg)
    model.load_state_dict(mae_params_from_jax(numpy_tree(jparams), pcfg), strict=True)
    return jcfg, jparams, pcfg, model.eval()


def video(jcfg, seed=1, batch=2):
    e = jcfg.encoder
    return rand((batch, 3, e.all_frames, e.img_size, e.img_size), seed)


MASK_KEY = jax.random.PRNGKey(5)


def jax_masks(name, batch=2):
    """JAX's tube_mask_indices(MASK_KEY): the indices mae_pretrain_loss(MASK_KEY) draws."""
    from l4p_tpu.models.mae import tube_mask_indices

    vis, mask = tube_mask_indices(MASK_KEY, jax_config(name).encoder, batch, CONFIGS[name][2])
    return np.asarray(vis), np.asarray(mask)


def test_registry_matches_jax_for_every_size_and_the_cli_tiny_config():
    """Every field of each MAEConfig and of its encoder and decoder configs
    (the port's EncoderConfig fields, read from JAX's), and the CLI's
    `tiny` config against the JAX script's."""
    from l4p_tpu.models.mae import mae_registry as jax_registry

    pairs = [(PM.mae_registry(s), jax_registry(s)) for s in ("small", "base", "large", "huge", "giant")]
    pairs.append((mae_config("tiny"), jax_config("tiny")))
    for port, ref in pairs:
        for f in ("decoder_embed_dim", "decoder_depth", "decoder_num_heads", "decoder_num_classes"):
            assert getattr(port, f) == getattr(ref, f), f
        for pe, je in ((port.encoder, ref.encoder), (port.decoder_cfg, ref.decoder_cfg)):
            for f in EncoderConfig.__dataclass_fields__:
                assert getattr(pe, f) == getattr(je, f), f
            assert (pe.num_tokens, pe.mlp_hidden, pe.head_dim) == (je.num_tokens, je.mlp_hidden, je.head_dim)
    giant = PM.mae_registry("giant")
    assert (giant.decoder_cfg.mlp_hidden, giant.decoder_num_classes, giant.decoder_cfg.head_dim) == (2234, 1176, 64)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_visible_matches_jax(name):
    from l4p_tpu.models.mae import mae_encode_visible

    jcfg, jparams, _, model = models(name)
    x = video(jcfg)
    vis, _ = jax_masks(name)
    ref = mae_encode_visible(jparams["encoder"], jnp.asarray(x), jnp.asarray(vis), jcfg.encoder)
    with torch.no_grad():
        out = model.encode_visible(T(x), T(vis))
    assert out.shape == (2, vis.shape[1], jcfg.encoder.embed_dim)
    check(out, ref, 4e-6, "encode_visible")  # measured <= 1.9e-6 (wide), 1.4e-6 (tiny)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name):
    from l4p_tpu.models.mae import mae_forward

    jcfg, jparams, _, model = models(name)
    x = video(jcfg)
    vis, mask = jax_masks(name)
    ref = mae_forward(jparams, jcfg, jnp.asarray(x), jnp.asarray(vis), jnp.asarray(mask))
    with torch.no_grad():
        out = model(T(x), T(vis), T(mask))
    assert out.shape == (2, mask.shape[1], jcfg.decoder_num_classes)
    check(out, ref, 1e-6, "mae_forward")  # measured <= 3.9e-7


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pretrain_loss_matches_jax(name, normalize):
    """JAX's loss draws its masks from MASK_KEY; the port's is given them."""
    from l4p_tpu.models.mae import mae_pretrain_loss

    jcfg, jparams, _, model = models(name)
    x = video(jcfg)
    ratio = CONFIGS[name][2]
    ref = mae_pretrain_loss(jparams, jcfg, jnp.asarray(x), MASK_KEY, ratio, normalize_target=normalize)
    with torch.no_grad():
        loss = PM.mae_pretrain_loss(model, T(x), *map(T, jax_masks(name)), normalize_target=normalize)
    check(loss, ref, 2e-7, "loss")  # measured <= 5.8e-8


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_gradient_matches_jax(name):
    """Every port parameter's gradient of the loss against jax.grad's leaf
    mapped onto its name (mae_params_from_jax); JAX's encoder pos_embed
    gradient is 0 and its decoder_pos_embed's is not (buffers in the port)."""
    from l4p_tpu.models.mae import mae_pretrain_loss

    jcfg, jparams, _, model = models(name)
    x = video(jcfg)
    ratio = CONFIGS[name][2]
    grads = numpy_tree(jax.grad(lambda p: mae_pretrain_loss(p, jcfg, jnp.asarray(x), MASK_KEY, ratio))(jparams))
    assert not grads["encoder"]["pos_embed"].any() and np.abs(grads["decoder_pos_embed"]).max() > 0
    want = mae_params_from_jax(grads, model.cfg)
    loss = PM.mae_pretrain_loss(model, T(x), *map(T, jax_masks(name)))
    names, params = zip(*model.named_parameters())
    got = dict(zip(names, torch.autograd.grad(loss, params)))
    assert set(got) == set(want)
    for n, g in got.items():
        r = want[n]
        err = (g - r).abs().max().item()
        # measured <= 1.9e-6 of the largest entry (tiny's blocks.1.norm1.weight, wide's blocks.1.attn.q_bias)
        assert err <= 4e-6 * r.abs().max().item(), f"{n}: |port - JAX| {err:.3g}, max {r.abs().max():.3g}"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_upstream_state_dict_loads_strictly_and_through_convert_mae(name):
    """The port's seeded init as an upstream-layout numpy state dict: loaded
    strictly into a second port model and through convert_mae into JAX, the
    two forwards agree."""
    from l4p_tpu.checkpoint import convert_mae
    from l4p_tpu.models.mae import mae_forward

    jcfg, _, pcfg, _ = models(name)
    source = PM.MAE(pcfg)
    source.init_weights(torch.Generator().manual_seed(7))
    sd = {k: v.numpy().copy() for k, v in source.state_dict().items()}
    assert not any("pos_embed" in k for k in sd)
    model = PM.MAE(pcfg)
    model.load_state_dict({k: T(v) for k, v in sd.items()}, strict=True)
    jparams = convert_mae(sd, jcfg)
    x = video(jcfg, seed=3)
    vis, mask = jax_masks(name)
    ref = mae_forward(jparams, jcfg, jnp.asarray(x), jnp.asarray(vis), jnp.asarray(mask))
    with torch.no_grad():
        out = model(T(x), T(vis), T(mask))
    check(out, ref, 1e-6, "forward of the shared state dict")  # measured <= 5.0e-7


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mae_params_from_jax_round_trips_through_convert_mae(name):
    """init_mae_params -> mae_params_from_jax -> convert_mae gives every leaf
    back bit for bit (the sinusoid tables rebuilt by convert_mae)."""
    from l4p_tpu.checkpoint import convert_mae

    jcfg, jparams, pcfg, _ = models(name)
    sd = {k: v.numpy() for k, v in mae_params_from_jax(numpy_tree(jparams), pcfg).items()}
    back = numpy_tree(convert_mae(sd, jcfg))
    flat, ref = jax.tree_util.tree_flatten_with_path(back)[0], jax.tree_util.tree_flatten_with_path(
        numpy_tree(jparams))[0]
    assert [p for p, _ in flat] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(flat, ref):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name,batch", [("tiny", 3), ("wide", 2), ("giant", 2)])
def test_tube_sampler_properties(name, batch):
    """The port's sampler: int(h * w * ratio) masked spatial tokens, the same
    spatial mask at every tubelet step, both lists sorted, disjoint and
    covering every token; reproducible from the generator's seed. The giant
    config at 0.9 keeps 208 of 2048 tokens."""
    if name == "giant":
        cfg, ratio = PM.mae_registry("giant").encoder, 0.9
    else:
        cfg, ratio = port_config(jax_config(name)).encoder, CONFIGS[name][2]
    t, h, w = cfg.tokens_thw
    n_mask = int(h * w * ratio)
    vis, mask = PM.tube_mask_indices(torch.Generator().manual_seed(0), cfg, batch, ratio)
    assert vis.shape == (batch, t * (h * w - n_mask)) and mask.shape == (batch, t * n_mask)
    if name == "giant":
        assert vis.shape[1] == 208 and mask.shape[1] == 1840
    for v, m in zip(vis, mask):
        assert torch.equal(torch.sort(torch.cat([v, m])).values, torch.arange(cfg.num_tokens))
        for idx in (v, m):
            assert torch.equal(idx, idx.sort().values)
            steps = idx.view(t, -1)
            assert torch.equal(steps - steps[:1], (torch.arange(t) * h * w)[:, None].expand_as(steps))
    again = PM.tube_mask_indices(torch.Generator().manual_seed(0), cfg, batch, ratio)
    assert torch.equal(again[0], vis) and torch.equal(again[1], mask)


def test_init_weights_has_init_mae_params_distributions():
    """The port's init_weights against init_mae_params on the wide config,
    per parameter: constant tensors equal, random ones with the same bounds
    (max |w| within 2% of JAX's) and spread (std within 5%; each has at
    least 4608 entries), mask_token within +-0.04."""
    from l4p_tpu.models.mae import init_mae_params

    jcfg, _, pcfg, _ = models("wide")
    want = mae_params_from_jax(numpy_tree(init_mae_params(jcfg, jax.random.PRNGKey(1))), pcfg)
    model = PM.MAE(pcfg)
    model.init_weights(torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert set(got) == set(want)
    for n, v in got.items():
        r = want[n]
        if r.min() == r.max():
            assert torch.equal(v, r), n
        elif n == "mask_token":  # 48 draws of 0.02 x a normal truncated at +-2
            assert 0 < v.abs().max() <= 0.04 and r.abs().max() <= 0.04
        else:
            assert abs(v.abs().max() / r.abs().max() - 1) <= 0.02, n
            assert abs(v.std() / r.std() - 1) <= 0.05, n
    np.testing.assert_array_equal(model.decoder_pos_embed.numpy(), init_mae_params(jcfg, jax.random.PRNGKey(1))[
        "decoder_pos_embed"])
