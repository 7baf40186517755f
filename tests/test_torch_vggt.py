"""VGGT on the port (l4p_tpu_torch/models/vggt.py) against the plain fp32
reference (tests/vggt_reference.py) on the CPU at a tiny size, on seeded
random weights whose biases, LayerScale gains and LayerNorm affines are
drawn away from their init values; the structure the model must have
(RoPE's relative positions, frame 0's own token slot, upstream's names),
the configuration reader, the session, the FLOP count and the benchmark's
driver at the tiny size."""

import json
import math
import time

import pytest
import torch
import torch.nn.functional as F

from tests import vggt_reference as ref

from l4p_tpu_torch.config import VGGTConfig, load_model_config, vggt_config_from_tree
from l4p_tpu_torch.inference import InferenceSession
from l4p_tpu_torch.models.vggt import VGGT, Rope2D, frame_positions, load_upstream_state_dict, upstream_name
from l4p_tpu_torch.ops.resize import interpolate_bilinear

TINY = VGGTConfig(img_size=42, embed_dim=64, depth=2, num_heads=2, embed_depth=2, embed_num_heads=2,
                  camera_trunk_depth=2, camera_num_heads=2, dpt_features=16, dpt_out_channels=(8, 16, 32, 32),
                  dpt_layers=(0, 1, 1, 0), frames_chunk_size=2)
TASKS = ("camera", "depth", "world_points")
S, H, W = 3, 28, 42
CONFIG = "portbench/configs/vggt_1b.json"


def plain_attention(q, k, v, scale):
    return ref.attention(q, k, v)


def tiny_weights(model, seed=0):
    """Every tensor drawn: matrices at unit gain over their fan-in, LayerNorm
    scales 1 +- 0.3, every other vector (biases, LayerScale gains) +-0.2,
    tokens and position tables +-1."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, v in model.state_dict().items():
        u = torch.rand(v.shape, generator=g) * 2 - 1
        if v.dim() <= 1:
            norm_scale = name.endswith("weight") and ("norm" in name.rsplit(".", 2)[-2])
            out[name] = 1 + 0.3 * u if norm_scale else 0.2 * u
        elif name.endswith(("token", "tokens", "pos_embed")):
            out[name] = u
        else:
            fan_in = math.prod(v.shape[1:]) if "resize_layers.0" not in name and "resize_layers.1" not in name \
                else v.shape[0]
            out[name] = u * math.sqrt(3.0 / fan_in)
    return out


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    port, plain = VGGT(TINY).eval(), ref.VGGT(TINY).eval()
    w = {upstream_name(k): v for k, v in tiny_weights(port).items()}
    load_upstream_state_dict(port, w)
    plain.load_state_dict(w, strict=True)
    frames = torch.randint(0, 256, (1, S, H, W, 3), generator=torch.Generator().manual_seed(1), dtype=torch.uint8)
    with torch.no_grad():
        got, want = port(frames, TASKS), plain(frames, TASKS)
    return port, plain, frames, got, want


# each tolerance about 4x the largest error measured on the CPU (fp32), which is in brackets
TOLERANCE = {
    "pose_enc": 4e-6,  # [1.07e-6 of values up to 4.3]
    "extrinsic": 4e-6,  # [1.07e-6]
    "intrinsic": 5e-6,  # relative [1.19e-6; 3 infinite focal lengths, where the FoV is 0, on both sides]
    "depth": 5e-6,  # [1.25e-6 of values up to 2.0]
    "depth_conf": 1e-5,  # [2.15e-6 of values up to 3.7]
    "world_points": 6e-5,  # [1.53e-5 of values up to 11.3]
    "world_points_conf": 1.2e-5,  # [2.86e-6 of values up to 3.5]
}


@pytest.mark.parametrize("key", sorted(TOLERANCE))
def test_outputs_match_the_reference(pair, key):
    _, _, _, got, want = pair
    assert got[key].shape == want[key].shape and got[key].dtype == torch.float32
    if key == "intrinsic":
        torch.testing.assert_close(got[key], want[key], rtol=TOLERANCE[key], atol=0)
    else:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=TOLERANCE[key])


@pytest.mark.parametrize("slot", range(4))
def test_read_aggregator_outputs_match_the_reference(pair, slot):
    port, plain, frames, _, _ = pair
    layer = TINY.dpt_layers[slot]
    with torch.no_grad():
        got = port.aggregator(frames, plain_attention, {layer})[layer]
        want = plain.aggregator(frames.permute(0, 1, 4, 2, 3).float() / 255.0, {layer})[layer]
    assert got.shape == (1, S, TINY.patch_start + (H // 14) * (W // 14), 2 * TINY.embed_dim)
    torch.testing.assert_close(got, want, rtol=0, atol=1.5e-5)  # [3.37e-6 of values up to 3.9]


def test_rope_scores_depend_only_on_position_differences():
    g = torch.Generator().manual_seed(3)
    q, k = torch.randn(1, 2, 5, 16, generator=g), torch.randn(1, 2, 5, 16, generator=g)
    pos = torch.randint(0, 9, (5, 2), generator=g)
    scores = []
    for shift in ((0, 0), (3, 1), (7, 11)):
        rope = Rope2D(pos + torch.tensor(shift), 16, 100.0)
        scores.append(rope(q) @ rope(k).transpose(-2, -1))
    torch.testing.assert_close(scores[1], scores[0], rtol=0, atol=2e-5)
    torch.testing.assert_close(scores[2], scores[0], rtol=0, atol=2e-5)
    moved = Rope2D(pos + torch.tensor([[1, 0]] + [[0, 0]] * 4), 16, 100.0)
    assert (moved(q) @ moved(k).transpose(-2, -1) - scores[0]).abs().max() > 1e-3


def test_rope_is_upstreams():
    g = torch.Generator().manual_seed(4)
    t = torch.randn(2, 3, 20, 32, generator=g)
    pos = frame_positions(4, 4, 4, "cpu").expand(2, -1, -1)
    want = ref.RotaryPositionEmbedding2D(100.0)(t, pos)
    torch.testing.assert_close(Rope2D(pos[0], 32, 100.0)(t), want, rtol=0, atol=1e-6)


def test_permuting_later_frames_permutes_their_outputs(pair):
    port, _, frames, got, _ = pair
    order = [0, 2, 1]
    with torch.no_grad():
        out = port(frames[:, order], TASKS)
    for key in ("pose_enc", "depth", "world_points", "depth_conf"):
        torch.testing.assert_close(out[key], got[key][:, order], rtol=0, atol=TOLERANCE[key])  # summation order
    # frame 0 takes its own token slot: the same frames with another first frame answer otherwise
    with torch.no_grad():
        other = port(frames[:, [1, 0, 2]], ("camera",))
    assert (other["pose_enc"][:, 1] - got["pose_enc"][:, 0]).abs().max() > 1e-4


def test_state_dict_is_upstreams_and_loads_strictly(pair):
    port, plain, _, _, _ = pair
    names = {upstream_name(k) for k in port.state_dict()}
    assert names == set(plain.state_dict())
    assert upstream_name("aggregator.frame_blocks.0.gamma_1") == "aggregator.frame_blocks.0.ls1.gamma"
    for name in ("aggregator.camera_token", "aggregator.register_token", "aggregator.patch_embed.pos_embed",
                 "aggregator.patch_embed.register_tokens", "aggregator.patch_embed.blocks.0.ls1.gamma",
                 "aggregator.frame_blocks.1.attn.q_norm.weight", "aggregator.global_blocks.0.attn.qkv.bias",
                 "camera_head.poseLN_modulation.1.weight", "camera_head.trunk.1.ls2.gamma",
                 "depth_head.scratch.refinenet4.resConfUnit2.conv1.weight", "point_head.scratch.output_conv2.2.bias",
                 "depth_head.resize_layers.3.weight"):
        assert name in names, name
    assert "depth_head.scratch.refinenet4.resConfUnit1.conv1.weight" not in names
    state = dict(plain.state_dict())
    fresh = VGGT(TINY)
    load_upstream_state_dict(fresh, {**state, "track_head.fnet.weight": torch.zeros(1)})
    assert all(torch.equal(v, state[upstream_name(k)]) for k, v in fresh.state_dict().items())
    with pytest.raises(RuntimeError):
        load_upstream_state_dict(fresh, {k: v for k, v in state.items() if k != "aggregator.camera_token"})


def test_published_widths_and_parameter_count():
    cfg, tasks = load_model_config(CONFIG)
    assert cfg == VGGTConfig() and tasks == TASKS
    model = VGGT(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 1_190_596_120
    assert cfg.aggregator_block.head_dim == 64 and cfg.camera_block.head_dim == 128


@pytest.mark.parametrize("change,message", [
    ({"init_args": {"enable_track": True}}, "enable_track"),
    ({"init_args": {"enable_point": False}}, "enable_point"),
    ({"aggregator": {"aa_order": ["global", "frame"]}}, "aa_order"),
    ({"camera_head": {"pose_encoding_type": "relT_quaR_FoV"}}, "pose_encoding_type"),
    ({"point_head": {"features": 128}}, "features"),
])
def test_the_reader_refuses_what_the_port_does_not_build(change, message):
    tree = json.load(open(CONFIG))
    for group, kv in change.items():
        tree[group].update(kv)
    with pytest.raises(ValueError, match=message):
        vggt_config_from_tree(tree)


def test_the_session_serves_a_state_dict_and_refuses_other_tasks(pair):
    port, _, frames, got, _ = pair
    sess = InferenceSession(TINY, ("depth", "camera"), "cpu", attention=plain_attention)
    out = sess(port.state_dict(), {"rgb_u8_bthw3": frames})
    assert set(out) == {"depth", "depth_conf", "pose_enc", "extrinsic", "intrinsic"}
    torch.testing.assert_close(out["depth"], got["depth"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="VGGT serves"):
        InferenceSession(TINY, ("track_2d",), "cpu")


@pytest.mark.parametrize("tasks", [TASKS, ("depth",), ("camera",)])
def test_flops_count_the_references_products(tasks):
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.work.vggt_flops import vggt_request_flops

    plain = ref.VGGT(TINY).eval().requires_grad_(False)
    frames = torch.randint(0, 256, (1, S, H, W, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as counter:
        plain(frames, tasks)
    assert vggt_request_flops(TINY, tasks, S, H, W)["total"] == counter.get_total_flops()


@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last])
@pytest.mark.parametrize("align_corners", [True, False])
def test_bilinear_resize_is_f_interpolate(layout, align_corners):
    x = torch.randn(2, 5, 7, 9).to(memory_format=layout)
    got = interpolate_bilinear(x, (13, 20), align_corners)
    want = F.interpolate(x, size=(13, 20), mode="bilinear", align_corners=align_corners)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert got.is_contiguous(memory_format=layout)


def tiny_bench(tmp_path):
    """The benchmark with one tiny VGGT cell, written under tmp_path."""
    import shutil

    from portbench import manifest as mf

    pkg = tmp_path / "portbench"
    shutil.copytree(mf.PACKAGE_DIR, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    c = json.load(open(CONFIG))
    c["dtype"] = "float32"
    c["init_args"].update(img_size=TINY.img_size, embed_dim=TINY.embed_dim)
    c["aggregator"].update(depth=2, num_heads=2, embed_depth=2, embed_num_heads=2)
    c["camera_head"].update(dim_in=128, trunk_depth=2, num_heads=2)
    for h in ("depth_head", "point_head"):
        c[h].update(dim_in=128, features=16, out_channels=[8, 16, 32, 32], intermediate_layer_idx=[0, 1, 1, 0],
                    frames_chunk_size=2)
    (pkg / "configs" / "vggt_tiny.json").write_text(json.dumps(c))
    (pkg / "traffic" / "tiny-vggt.json").write_text(json.dumps(
        {"driver": "vggt", "frames": S, "height": H, "width": W, "tasks": list(TASKS), "sample": 2, "sample_from": 3,
         "slice_requests": 1}))
    b = json.load(open("BENCHMARK.json"))
    b["configs"] = [{"name": "vggt_tiny", "source": "x", "file": "portbench/configs/vggt_tiny.json", "reduced": [],
                     "why": "t"}]
    b["workloads"] = [{"name": "tiny-vggt", "config": "vggt_tiny", "traffic": "tiny-vggt", "chips": 1, "why": "t"}]
    b["end_to_end"] = [m for m in b["end_to_end"] if m["name"] in ("video_fps", "setup_s")]
    b["end_to_end"][0]["workloads"] = ["tiny-vggt"]
    b["per_layer"] = []
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return mf.Manifest.load(tmp_path / "BENCHMARK.json", pkg)


def test_the_driver_serves_and_compares(tmp_path):
    from portbench import run
    from portbench.calibrate import readings

    bench = tiny_bench(tmp_path)
    cell = bench.cell("tiny-vggt")
    ctx = run.Context(cell, bench.traffic(cell["traffic"]), bench.config_path(cell["config"]), {}, 2 ** 31 + 11, 0.3,
                      False, torch.device("cpu"), None, time.perf_counter())
    served = __import__("portbench.drivers.vggt", fromlist=["Cell"]).Cell(ctx)
    win = served.window(0.3)
    assert win.attempted >= 2 and win.failed == 0 and win.end_to_end["video_fps"] > 0 and win.flops > 0
    assert set(served.check()) == {"tokens", "depth", "world_points", "pose_enc", "camera.pose", "frame0.attn",
                                   "global0.attn", "frame1.attn", "global1.attn"}
    # the plain path in fp32 against the reference: rounding apart; the fp8 control far from it
    got = readings(bench, "tiny-vggt", 3, True, "cpu", torch.float32)
    assert all(v < 1e-5 for v in got["program"].values()), got["program"]
    assert all(v > 1e-4 for v in got["control"].values()), got["control"]


def test_the_drivers_weights_do_not_depend_on_module_order():
    from portbench.drivers.vggt import seeded_weights

    a = seeded_weights(VGGT(TINY), 5, "cpu", torch.bfloat16, upstream_name)
    b = seeded_weights(ref.VGGT(TINY), 5, "cpu", torch.bfloat16)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def per_frame_global_attention(monkeypatch, p: int):
    """A planted fault: every global block attends within each frame of `p`
    tokens, with the frame's positions."""
    import copy

    from l4p_tpu_torch.models import encoder

    forward = encoder.Block.forward

    def faulty(self, x, attention, drop=None, mesh=None, rope=None):
        b, n, e = x.shape
        if rope is None or n == p:
            return forward(self, x, attention, drop, mesh, rope)
        frame_rope = copy.copy(rope)
        frame_rope.cos, frame_rope.sin = rope.cos[:p], rope.sin[:p]
        return forward(self, x.reshape(b * n // p, p, e), attention, drop, mesh, frame_rope).reshape(b, n, e)

    monkeypatch.setattr(encoder.Block, "forward", faulty)


def test_the_stage_readings_see_global_attention_run_per_frame(tmp_path, monkeypatch):
    """The global blocks' stage readings from the program's own tokens: at
    rounding with the program as it is, far off with global attention run
    per frame, while the frame blocks' stay at rounding."""
    from portbench.calibrate import readings

    bench = tiny_bench(tmp_path)
    right = readings(bench, "tiny-vggt", 4, False, "cpu", torch.float32)["program"]
    per_frame_global_attention(monkeypatch, TINY.patch_start + (H // 14) * (W // 14))
    wrong = readings(bench, "tiny-vggt", 4, False, "cpu", torch.float32)["program"]
    for name in ("frame0.attn", "frame1.attn", "global0.attn", "global1.attn"):
        assert right[name] < 1e-5, (name, right[name])
    assert wrong["frame0.attn"] < 1e-5 and min(wrong["global0.attn"], wrong["global1.attn"]) > 1e-2, wrong
