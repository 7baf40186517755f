"""The port's point-track head (models/track.py and models/l4p.run_track_chunked)
against the JAX package's (fp32, CPU): the soft-argmax, one window, the causal
windowed scan, the max_queries chunking, the track head's parameter
conversion and the YAML track branch. Weights are carried across by the
port's checkpoint conversion; inputs are made with numpy from a seed.

Two head configurations: the released switches (vis, depth, prompt
features, token memory, label rewriting) and a bare one with all of those
off, at C = 128, a (4, 8, 8) token grid and (8, 112, 112) windows."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import l4p_tpu_torch.config as PC
from l4p_tpu_torch import L4P, params_from_jax
from l4p_tpu_torch.checkpoint import _track_state
from l4p_tpu_torch.models import l4p as PL
from l4p_tpu_torch.models import track as PT
from tests.test_torch_ops import check, port_config, port_track_config, rand

torch.set_num_threads(1)

SAM = dict(embed_dim=128, image_embedding_size=(4, 8, 8), input_image_size=(8, 112, 112), num_heads=8, mlp_dim=64)
BARE = dict(estimate_depth=False, prompt_using_features=False, attend_to_past=False,
            modify_pointlabels_for_windowing=False)
VARIANTS = ("released", "bare")


@functools.lru_cache(maxsize=None)
def models(variant: str, seed: int = 7):
    """(JAX track config, JAX params, port config, port head) on the same weights."""
    from l4p_tpu.models.sam import SamConfig
    from l4p_tpu.models.track import TrackConfig, init_track_params

    kw = BARE if variant == "bare" else {}
    jcfg = TrackConfig(image_size=(8, 112, 112), patch_size=(2, 14, 14), **kw)
    # the SAM switches follow the head's, as the YAML branch sets them
    jcfg = dataclasses.replace(jcfg, sam=SamConfig(**SAM, prompt_using_features=jcfg.prompt_using_features,
                                                   num_mask_tokens=jcfg.num_mask_tokens))
    params = init_track_params(jcfg, jax.random.PRNGKey(seed))
    pcfg = port_track_config(jcfg)
    head = PT.TrackHead(pcfg)
    head.load_state_dict(_track_state(jax.tree.map(np.asarray, params), pcfg), strict=True)
    return jcfg, params, pcfg, head.eval()


def queries(n: int, t_max: float, hw, seed: int, at_start: int = 0) -> np.ndarray:
    """(1, n, 3) (t, x, y) queries; the first `at_start` at t = 0.5."""
    t = rand((n,), seed, 0, t_max)
    t[:at_start] = 0.5
    return np.stack([t, rand((n,), seed + 1, 0, hw[1]), rand((n,), seed + 2, 0, hw[0])], -1)[None]


def to_j(x):
    return None if x is None else jnp.asarray(x)


def to_t(x):
    return None if x is None else torch.from_numpy(x)


def test_softargmax_matches_jax():
    from l4p_tpu.models.track import softargmax_xy

    lg = rand((3, 4, 10, 12), 0) * 3
    out = PT.softargmax_xy(torch.from_numpy(lg))
    assert out.shape == (3, 4, 2)
    check(out, softargmax_xy(jnp.asarray(lg), (10, 12)), 5e-7)  # measured 2.6e-7


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("per_query", [True, False])
def test_track_forward_one_window_matches_jax(variant, per_query):
    """B = 2 items of N = 4 queries with labels 0/1/2 and feature prompts
    with labels 0/1, on per-query (B, N, P, C) or shared (B, P, C) tokens."""
    from l4p_tpu.models.track import track_forward

    jcfg, params, pcfg, head = models(variant)
    b, n, p, c = 2, 4, 256, 128
    enc = rand((b, n, p, c) if per_query else (b, p, c), 1) * 0.5
    q = np.concatenate([queries(n, 8, (112, 112), 2 + 3 * i) for i in range(b)])
    lab = np.array([[1, 2, 0, 1], [2, 1, 1, 0]], np.float32)
    pf = rand((b, n, c), 9) if pcfg.prompt_using_features else None
    pfl = np.array([[0, 1, 1, 0], [1, 0, 0, 1]], np.float32) if pcfg.prompt_using_features else None
    ref = track_forward(params, jcfg, jnp.asarray(enc), jnp.asarray(q), jnp.asarray(lab), to_j(pf), to_j(pfl))
    with torch.no_grad():
        out = PT.track_forward(head, pcfg, torch.from_numpy(enc), torch.from_numpy(q), torch.from_numpy(lab),
                               to_t(pf), to_t(pfl))
    assert set(out) == set(ref)
    assert out["track_2d_traj_est_bn2t"].shape == (b, n, 2, 8)
    for k in ref:
        # measured <= 3.4e-7 (traj), 6.6e-7 (the token memory), 5.4e-7 (prompt features)
        check(out[k], ref[k], 1.5e-6, k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_track_forward_windowed_matches_jax(variant):
    """Three windows of 8 frames at stride 4 (T = 16), 6 queries: half at
    t = 0.5, half later, so validity, the label passes, the prompt-feature
    and token-memory carries and the argmax re-query all run."""
    from l4p_tpu.models.track import track_forward_windowed

    jcfg, params, pcfg, head = models(variant)
    enc = rand((3, 1, 256, 128), 11) * 0.5
    q = queries(6, 16, (112, 112), 12, at_start=3)
    lab = np.ones((1, 6), np.float32)
    ref = track_forward_windowed(params, jcfg, jnp.asarray(enc), jnp.asarray(q), jnp.asarray(lab), 4)
    with torch.no_grad():
        out = PT.track_forward_windowed(head, pcfg, torch.from_numpy(enc), torch.from_numpy(q),
                                        torch.from_numpy(lab), 4)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape and out[k].shape[-1] == 16
        # measured <= 4.0e-7 (traj); the label-order fault of ROADMAP.md gave 5e-3
        check(out[k], ref[k], 1e-6, k)


def test_windowed_scan_keeps_frames_before_the_query():
    """Frames before a query's time keep the buffers' initial values
    (traj 0, vis -10, depth 0); from its time on they are written."""
    _, _, pcfg, head = models("released")
    enc = torch.from_numpy(rand((3, 1, 256, 128), 13) * 0.5)
    q = torch.from_numpy(queries(2, 16, (112, 112), 14))
    q[0, :, 0] = torch.tensor([0.5, 9.5])
    with torch.no_grad():
        out = PT.track_forward_windowed(head, pcfg, enc, q, torch.ones(1, 2), 4)
    vis, traj = out["track_2d_vis_est_bn1t"][0, :, 0], out["track_2d_traj_est_bn2t"][0]
    assert (vis[1, :9] == -10).all() and (traj[1, :, :9] == 0).all()
    assert (vis[1, 9:] != -10).all() and (vis[0] != -10).all()


def test_the_scans_constants_are_made_once_and_serve_a_backward_pass():
    """The head's interpolation weights and prompt scale are made once a
    shape (a copy from host memory waits for the device), as each window
    made them before, and are no inference tensors: a scan under
    inference_mode, then one that takes gradients, give the same outputs."""
    from l4p_tpu_torch.models import sam as PS
    from l4p_tpu_torch.ops.resize import interp_matrix

    _, _, pcfg, head = models("released")
    enc = torch.from_numpy(rand((3, 1, 256, 128), 13) * 0.5)
    q = torch.from_numpy(queries(2, 16, (112, 112), 14))
    PT.interp_weights.cache_clear()
    PS.point_scale.cache_clear()
    with torch.inference_mode():
        first = PT.track_forward_windowed(head, pcfg, enc, q, torch.ones(1, 2), 4)
    weights, scale = PT.interp_weights.cache_info(), PS.point_scale.cache_info()
    # three windows, three reads of weights a window in two shapes (h and w are equal here), one scale
    assert (weights.misses, weights.hits, scale.misses, scale.hits) == (2, 3 * 3 - 2, 1, 2)
    cpu = torch.device("cpu")
    with torch.inference_mode():
        made = PT.interp_weights(8, 112, True, torch.bfloat16, cpu)
    assert not made.is_inference() and PT.interp_weights(8, 112, True, torch.bfloat16, cpu) is made
    assert torch.equal(made, torch.as_tensor(interp_matrix(8, 112, False).mean(axis=0)).to(torch.bfloat16).float())
    enc.requires_grad_(True)
    again = PT.track_forward_windowed(head, pcfg, enc, q, torch.ones(1, 2), 4)
    sum(v.float().sum() for v in again.values()).backward()
    assert enc.grad is not None and torch.isfinite(enc.grad).all()
    for k in first:
        assert torch.equal(first[k], again[k].detach()), k


def tiny_track():
    """The JAX tiny model's track config and parameters (tests/test_l4p_forward.py)
    with the port's head on the same weights."""
    from l4p_tpu.models.track import init_track_params
    from tests.test_l4p_forward import tiny_cfg

    jt = tiny_cfg().track
    params = init_track_params(jt, jax.random.PRNGKey(5))
    pt = port_track_config(jt)
    head = PT.TrackHead(pt)
    head.load_state_dict(_track_state(jax.tree.map(np.asarray, params), pt), strict=True)
    return jt, params, pt, head.eval()


def test_run_track_chunked_pads_and_matches_jax():
    """N = 11 queries at max_queries = 8: two chunks, the second padded by
    5 label-0 queries whose outputs are sliced off."""
    from l4p_tpu.models.l4p import run_track_chunked

    jt, params, pt, head = tiny_track()
    assert pt.max_queries == 8
    enc = rand((3, 1, 8, 64), 15)  # 3 windows of 2 x 2 x 2 tokens, T = 8 at stride 2
    q = queries(11, 8, (28, 28), 16, at_start=4)
    lab = np.ones((1, 11), np.float32)
    ref = run_track_chunked(params, jt, jnp.asarray(enc), jnp.asarray(q), jnp.asarray(lab), 2)
    with torch.no_grad():
        out = PL.run_track_chunked(head, torch.from_numpy(enc), torch.from_numpy(q), torch.from_numpy(lab), 2)
        one_chunk = PT.track_forward_windowed(head, pt, torch.from_numpy(enc), torch.from_numpy(q),
                                              torch.from_numpy(lab), 2)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == (1, 11, 2 if "traj" in k else 1, 8)
        check(out[k], ref[k], 1e-6, k)  # measured <= 3.8e-7
        # queries are independent: chunking changes nothing beyond the summation order
        check(out[k], one_chunk[k], 1e-6, k)  # measured 0


def test_merge_query_chunks_drops_the_padding():
    v = torch.arange(2 * 1 * 4 * 3).reshape(2, 1, 4, 3)  # (chunks, B, chunk, ...)
    out = PL.merge_query_chunks(v, 6)
    assert out.shape == (1, 6, 3)
    assert torch.equal(out[0, 4], v[1, 0, 0]) and torch.equal(out[0, :4], v[0, 0])


@pytest.mark.parametrize("variant", VARIANTS)
def test_track_params_from_jax_load_strictly(variant):
    """The track head's state dict: every released name, the stacked point
    embeddings split into (1, C) rows, the never-read iou_token and
    no_mask_embed zero, and `load_state_dict(strict=True)` of the whole
    model with the track head."""
    _, params, pcfg, head = models(variant)
    sd = _track_state(jax.tree.map(np.asarray, params), pcfg)
    assert set(sd) == set(head.state_dict())
    pts = np.array(params["prompt_encoder"]["point_embeddings"])
    for i in range(2):
        assert torch.equal(sd[f"prompt_encoder.point_embeddings.{i}.weight"], torch.from_numpy(pts[i:i + 1]))
    assert not sd["mask_decoder.iou_token.weight"].any() and not sd["prompt_encoder.no_mask_embed.weight"].any()
    assert sd["mask_decoder.output_upscaling.0.weight"].shape == (128, 32, 2, 2, 2)
    assert ("processed_video_mask_token.weight" in sd) == pcfg.attend_to_past
    assert ("prompt_feature_linear_layer.weight" in sd) == pcfg.prompt_using_features


def test_whole_model_with_track_head_loads_strictly():
    from l4p_tpu.config import init_l4p_params
    from tests.test_l4p_forward import tiny_cfg

    jcfg = tiny_cfg()
    pcfg = port_config(jcfg)
    tree = jax.tree.map(np.asarray, init_l4p_params(jcfg, jax.random.PRNGKey(2),
                                                    tasks=("flow_2d_backward", "track_2d", "depth", "dyn_mask",
                                                           "camray")))
    sd = params_from_jax(tree, pcfg)
    model = L4P(pcfg)
    assert any(k.startswith("task_heads.track_2d.mask_decoder.") for k in sd)
    model.load_state_dict(sd, strict=True)
    gauss = tree["task_heads"]["track_2d"]["prompt_encoder"]["pe_gaussian"]
    assert torch.equal(model.task_heads["track_2d"].prompt_encoder.pe_layer.positional_encoding_gaussian_matrix,
                       torch.from_numpy(gauss))


TRACK_NODE = "l4p.models.task_heads.sparse_heads.VideoMAETrack2DSamHead"


@pytest.mark.parametrize("init_args", [
    {},  # every key absent: the schema's defaults, not the dataclasses'
    {"prompt_embed_dim": 64, "image_size": [4, 28, 28], "estimate_vis": True, "max_queries": 16},
    {"prompt_using_features": True, "attend_to_past": True, "estimation_directions": [1], "depth_fn": "exp"},
])
def test_yaml_track_branch_matches_jax(tmp_path, init_args):
    import yaml

    from l4p_tpu.config import load_model_config

    with open("configs/model_tiny.yaml") as f:
        tree = yaml.safe_load(f)
    modules = tree["init_args"]["l4p_model"]["init_args"]["task_heads"]["init_args"]["modules"]
    modules["track_2d"] = {"class_path": TRACK_NODE, "init_args": init_args}
    path = tmp_path / "model.yaml"
    path.write_text(yaml.safe_dump(tree))
    jcfg, _ = load_model_config(str(path))
    pcfg, _ = PC.load_model_config(str(path))
    assert pcfg.track == port_track_config(jcfg.track)
    if not init_args:
        t = pcfg.track
        assert (t.max_queries, t.estimation_directions, t.prompt_using_features) == (192, (1, -1), False)


def test_yaml_without_a_track_head_has_none(tmp_path):
    """A file with no track_2d head builds no track head, and the session
    refuses track_2d for it."""
    import yaml

    from l4p_tpu_torch import InferenceSession

    with open("configs/model_tiny.yaml") as f:
        tree = yaml.safe_load(f)
    del tree["init_args"]["l4p_model"]["init_args"]["task_heads"]["init_args"]["modules"]["track_2d"]
    path = tmp_path / "model.yaml"
    path.write_text(yaml.safe_dump(tree))
    cfg, _ = PC.load_model_config(str(path))
    assert cfg.track is None and "track_2d" not in L4P(cfg).task_heads
    with pytest.raises(ValueError, match="no configured head"):
        InferenceSession(cfg, ("depth", "track_2d"), "cpu")
