"""Video Depth Anything on the port (l4p_tpu_torch/models/vda.py) against the
plain fp32 reference (tests/vda_reference.py) on the CPU at a tiny size, on
seeded random weights whose biases, LayerScale gains and norm affines are
drawn away from their init values: one motion module, the temporal head, a
window, the stitched clip over one to three windows, the encoder's four
outputs; the scale-factor position resize, VGGT's embedder and DPT trunk
unchanged bit for bit, upstream's names and strict loading, the published
widths and parameter count, the configuration reader, the session, the
FLOP count and the benchmark's driver at the tiny size with a planted
fault its stage readings must see.

Each tolerance is about 4x the largest error measured on the CPU (fp32,
the port's and the reference's summation orders), which is in brackets."""

import json
import math
import time
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from tests import vda_reference as ref

from l4p_tpu_torch.config import (DINOv2Config, VDAConfig, VGGTConfig, load_model_config, vda_config_from_tree)
from l4p_tpu_torch.inference import InferenceSession
from l4p_tpu_torch.models import dpt, vda
from l4p_tpu_torch.models.dinov2 import DINOv2
from l4p_tpu_torch.models.vggt import VGGT
from l4p_tpu_torch.ops.conv import layer_norm, linear

torch.set_num_threads(1)

CONFIG = "portbench/configs/vda_l.json"
ENC = DINOv2Config(img_size=42, patch_size=14, embed_dim=64, depth=4, num_heads=2, interpolate_offset=0.1)
TINY = VDAConfig(encoder=ENC, intermediate_layers=(0, 1, 2, 3), features=32, out_channels=(16, 32, 64, 64),
                 motion_heads=4, motion_groups=8)
H, W = 28, 42
T = TINY.num_frames


def ref_config(cfg: VDAConfig = TINY):
    """The reference's namespace of `cfg`'s numbers (as read_config reads a file)."""
    e = cfg.encoder
    return SimpleNamespace(
        img_size=e.img_size, patch_size=e.patch_size, embed_dim=e.embed_dim, depth=e.depth, num_heads=e.num_heads,
        mlp_ratio=e.mlp_ratio, init_values=e.init_values, ln_eps=e.ln_eps, interpolate_offset=e.interpolate_offset,
        interpolate_antialias=e.interpolate_antialias, intermediate_layers=cfg.intermediate_layers,
        features=cfg.features, out_channels=cfg.out_channels, num_frames=cfg.num_frames,
        motion_heads=cfg.motion_heads, motion_groups=cfg.motion_groups, motion_gn_eps=cfg.motion_gn_eps,
        motion_ln_eps=cfg.motion_ln_eps, motion_attention_blocks=cfg.motion_attention_blocks, ff_mult=cfg.ff_mult,
        micro_batch=vda.MICRO_BATCH)


def tiny_weights(model, seed=0):
    """Every tensor drawn (the frame-position tables kept): matrices at unit
    gain over their fan-in, norm scales 1 +- 0.3, every other vector
    (biases, LayerScale gains) +-0.2, tokens and position tables +-1."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, v in model.state_dict().items():
        if name.endswith(".pe"):
            out[name] = v
            continue
        u = torch.rand(v.shape, generator=g) * 2 - 1
        if v.dim() <= 1:
            norm_scale = name.endswith("weight") and "norm" in name.rsplit(".", 2)[-2]
            out[name] = 1 + 0.3 * u if norm_scale else 0.2 * u
        elif name.endswith(("token", "pos_embed")):
            out[name] = u
        else:
            fan_in = math.prod(v.shape[1:]) if "resize_layers.0" not in name and "resize_layers.1" not in name \
                else v.shape[0]
            out[name] = u * math.sqrt(3.0 / fan_in)
    return out


def plain_attention(q, k, v, scale):
    return ref.attention(q, k, v)


def frames(length, seed=1):
    return torch.randint(0, 256, (1, length, H, W, 3), generator=torch.Generator().manual_seed(seed),
                         dtype=torch.uint8)


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    plain = ref.VideoDepthAnything(ref_config()).eval()
    port = vda.VideoDepthAnything(TINY).eval()
    w = tiny_weights(plain)
    plain.load_state_dict(w, strict=True)
    vda.load_upstream_state_dict(port, w)
    return port, plain, w


@pytest.fixture(scope="module")
def clips(pair):
    port, plain, _ = pair
    out = {}
    with torch.no_grad():
        for length in (22, 44, 60):
            x = frames(length, length)
            out[length] = (port(x, ("depth",), plain_attention)["depth"], *plain.infer_video_depth(x))
    return out


@pytest.mark.parametrize("length,windows", [(22, 1), (44, 2), (60, 3)])
def test_stitched_clip_matches_the_reference(clips, length, windows):
    got, want, raw, fits = clips[length]
    assert got.shape == want.shape == (1, length, H, W) and got.dtype == torch.float32
    assert raw.shape[0] == windows and fits.shape == (windows - 1, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=4e-5)  # [9.5e-6 of values up to 3.8]


@pytest.mark.parametrize("length", [44, 60])
def test_stitch_fits_match_the_references_on_the_same_windows(clips, length):
    """The port's stitch on the reference's own raw windows: the same clip
    and fits up to the fits' summation (fp64 against fp32)."""
    _, want, raw, fits = clips[length]
    got, got_fits = vda.stitch_windows([w[None] for w in raw], length)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=4e-6)  # [9.5e-7]
    torch.testing.assert_close(got_fits[0], fits, rtol=4e-6, atol=4e-7)  # [scale 9.5e-7 relative, shift 5e-8]


def test_window0_matches_the_reference(pair):
    port, plain, _ = pair
    x = frames(T, 7)
    with torch.no_grad():
        got = port.window(x, plain_attention)
        want = plain.forward(((x.permute(0, 1, 4, 2, 3).float() / 255.0) - plain._mean) / plain._std)
    assert got.shape == (1, T, H, W)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)  # [4.8e-6 of values up to 3.1]


@pytest.mark.parametrize("slot", range(4))
def test_intermediate_layers_match_the_reference(pair, slot):
    port, plain, _ = pair
    x = frames(3, 8)[0]
    with torch.no_grad():
        got = port.pretrained.intermediate_layers(x, plain_attention, TINY.intermediate_layers)[slot]
        norm = ((x.permute(0, 3, 1, 2).float() / 255.0) - plain._mean[0]) / plain._std[0]
        want = plain.pretrained.get_intermediate_layers(norm, list(TINY.intermediate_layers),
                                                        return_class_token=True)[slot][0]
    assert got.shape == (3, (H // 14) * (W // 14), ENC.embed_dim)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)  # [2.4e-6 of values up to 4.1]


@pytest.mark.parametrize("module,grid", [(0, (2, 3)), (2, (2, 3)), (3, (4, 6)), (1, (1, 2))])
def test_one_motion_module_matches_the_reference(pair, module, grid):
    port, plain, _ = pair
    c = port.head.motion_modules[module].temporal_transformer.proj_in.weight.shape[0]
    frames_ = 6
    x = torch.randn(frames_, c, *grid, generator=torch.Generator().manual_seed(module))
    with torch.no_grad():
        got = port.head.motion_modules[module](x, frames_, plain_attention)
        want = plain.head.motion_modules[module](x.unflatten(0, (1, frames_)).transpose(1, 2))
    torch.testing.assert_close(got, want.transpose(1, 2).flatten(0, 1), rtol=0, atol=2e-5)  # [3.8e-6 of up to 5.2]


def test_temporal_head_matches_the_reference(pair):
    port, plain, _ = pair
    g = torch.Generator().manual_seed(5)
    n = (H // 14) * (W // 14)
    feats = [torch.randn(T, n, ENC.embed_dim, generator=g) for _ in range(4)]
    with torch.no_grad():
        got = port.head(feats, H // 14, W // 14, T, plain_attention)
        want = plain.head([(f, None) for f in feats], H // 14, W // 14, T, vda.MICRO_BATCH)
    assert got.shape == want.shape == (T, 1, H, W)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)  # [4.3e-6 of values up to 3.6]


@pytest.mark.parametrize("grid,table", [((2, 3), 3), ((37, 66), 37), ((3, 3), 3), ((5, 4), 3)])
def test_scale_factor_position_resize_is_upstreams(grid, table):
    """The table resized by scale factor ((g + 0.1) / side, no antialias) as
    Depth Anything V2's interpolate_pos_encoding does, and kept as it is on
    the table's own square grid."""
    cfg = DINOv2Config(img_size=14 * table, embed_dim=8, depth=1, num_heads=2, interpolate_offset=0.1)
    port = DINOv2(cfg)
    torch.nn.init.normal_(port.pos_embed, generator=torch.Generator().manual_seed(table))
    gh, gw = grid
    got = port.positions(gh, gw)
    plain = ref.DinoVisionTransformer(ref_config(VDAConfig(encoder=cfg)))
    plain.pos_embed.data.copy_(port.pos_embed.data)
    want = plain.interpolate_pos_encoding(torch.zeros(1, 1 + gh * gw, 8), gh * 14, gw * 14)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if grid != (table, table):  # the formula itself
        patch = port.pos_embed[:, 1:].reshape(1, table, table, 8).permute(0, 3, 1, 2)
        formula = F.interpolate(patch, scale_factor=((gh + 0.1) / table, (gw + 0.1) / table), mode="bicubic",
                                antialias=False)
        torch.testing.assert_close(got[:, 1:], formula.permute(0, 2, 3, 1).reshape(1, gh * gw, 8), rtol=0, atol=0)
        by_size = F.interpolate(patch, size=(gh, gw), mode="bicubic", antialias=False)
        assert not torch.equal(formula, by_size)  # the rule matters: the two sample other points


def old_vggt_embedder(m, rgb_u8, attention):
    """VGGT's DINOv2 forward as models/vggt.py had it before the embedder
    was shared: size-resized antialiased positions, registers after cls,
    the last block's normed patch tokens."""
    cfg = m.cfg
    p = cfg.patch_size
    n, h, w, _ = rgb_u8.shape
    gh, gw = h // p, w // p
    pos = m.pos_embed.float()
    e, side = pos.shape[-1], math.isqrt(pos.shape[1] - 1)
    grid = F.interpolate(pos[:, 1:].reshape(1, side, side, e).permute(0, 3, 1, 2), size=(gh, gw), mode="bicubic",
                         antialias=True)
    pos = torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, e)], 1)
    from l4p_tpu_torch.models.ingest import folded_patch_weights
    w_fold, b_fold = folded_patch_weights(m.patch_embed.proj)
    x = rgb_u8.float().reshape(n, gh, p, gw, p, 3).permute(0, 1, 3, 5, 2, 4).reshape(n, gh * gw, 3 * p * p)
    x = linear(x, w_fold, b_fold)
    x = torch.cat([m.cls_token.expand(n, -1, -1), x], 1) + pos
    x = torch.cat([x[:, :1], m.register_tokens.expand(n, -1, -1), x[:, 1:]], 1)
    for blk in m.blocks:
        x = blk(x, attention)
    return layer_norm(x[:, 1 + cfg.num_register_tokens:], m.norm.weight, m.norm.bias, cfg.ln_eps)


def old_fuse(scratch, layers, sizes, crop=False):
    """models/dpt.py's fuse before the motion modules' hooks and the chunked tail."""
    rn = [dpt.conv(x, getattr(scratch, f"layer{i + 1}_rn").weight, None, padding=1) for i, x in enumerate(layers)]
    out = scratch.refinenet4(rn[3], None, sizes[3])
    if crop:
        out = out[:, :, : rn[2].shape[2], : rn[2].shape[3]]
    for i in (2, 1, 0):
        out = getattr(scratch, f"refinenet{i + 1}")(out, rn[i], sizes[i])
    return out


def test_vggt_embedder_and_trunk_unchanged_bit_for_bit():
    vcfg = VGGTConfig(img_size=42, embed_dim=64, depth=2, num_heads=2, embed_depth=2, embed_num_heads=2,
                      camera_trunk_depth=2, camera_num_heads=2, dpt_features=16, dpt_out_channels=(8, 16, 32, 32),
                      dpt_layers=(0, 1, 1, 0), frames_chunk_size=2)
    torch.manual_seed(3)
    model = VGGT(vcfg).eval()
    for p_ in model.parameters():
        torch.nn.init.uniform_(p_, -0.3, 0.3)
    x = frames(3, 9)[0]
    with torch.no_grad():
        emb = model.aggregator.patch_embed
        assert torch.equal(emb(x, plain_attention), old_vggt_embedder(emb, x, plain_attention))
        g = torch.Generator().manual_seed(4)
        grids = ((8, 12), (4, 6), (2, 3), (1, 2))
        layers = [torch.randn(2, c, *s, generator=g) for c, s in zip((8, 16, 32, 32), grids)]
        sizes = [(16, 24), (8, 12), (4, 6), (2, 3)]
        scratch = model.depth_head.scratch
        assert torch.equal(dpt.fuse(scratch, layers, sizes), old_fuse(scratch, layers, sizes))


def test_fuse_chunks_give_the_unchunked_values(pair):
    port, _, _ = pair
    g = torch.Generator().manual_seed(6)
    s = port.head.scratch
    grids = ((8, 12), (4, 6), (2, 3), (1, 2))
    layers = [torch.randn(6, c, *sz, generator=g) for c, sz in zip(TINY.out_channels, grids)]
    sizes = [(16, 24), (8, 12), (4, 6), (2, 3)]
    with torch.no_grad():
        whole = dpt.fuse(s, layers, sizes)
        # the same convolutions at chunk 4 [0]; at chunk 1 they pick another algorithm [2.1e-6 of values up to 6]
        torch.testing.assert_close(dpt.fuse(s, layers, sizes, chunk=4), whole, rtol=0, atol=0)
        torch.testing.assert_close(dpt.fuse(s, layers, sizes, chunk=1, tail=lambda x: 2 * x), 2 * whole, rtol=0,
                                   atol=2e-5)


def test_state_dict_is_upstreams_and_loads_strictly(pair):
    port, plain, w = pair
    names = {vda.upstream_name(k) for k in port.state_dict()}
    assert names == set(plain.state_dict())
    for name in ("pretrained.blocks.0.ls1.gamma", "pretrained.pos_embed", "pretrained.mask_token",
                 "head.projects.3.weight", "head.resize_layers.3.bias", "head.scratch.layer4_rn.weight",
                 "head.scratch.refinenet4.resConfUnit1.conv1.weight", "head.scratch.output_conv2.2.bias",
                 "head.motion_modules.3.temporal_transformer.norm.weight",
                 "head.motion_modules.0.temporal_transformer.transformer_blocks.0.attention_blocks.1.to_out.0.bias",
                 "head.motion_modules.1.temporal_transformer.transformer_blocks.0.attention_blocks.0.pos_encoder.pe",
                 "head.motion_modules.2.temporal_transformer.transformer_blocks.0.ff.net.0.proj.weight",
                 "head.motion_modules.2.temporal_transformer.transformer_blocks.0.ff.net.2.weight",
                 "head.motion_modules.3.temporal_transformer.transformer_blocks.0.norms.1.weight",
                 "head.motion_modules.3.temporal_transformer.proj_out.weight"):
        assert name in names, name
    assert not any("register_tokens" in n or "layer_rn" in n for n in names)
    assert port.head.motion_modules[0].temporal_transformer.transformer_blocks[0].attention_blocks[0] \
        .pos_encoder.pe.dtype == torch.float32
    fresh = vda.VideoDepthAnything(TINY)
    vda.load_upstream_state_dict(fresh, w)
    assert all(torch.equal(v, w[vda.upstream_name(k)]) for k, v in fresh.state_dict().items())
    with pytest.raises(RuntimeError):
        vda.load_upstream_state_dict(fresh, {k: v for k, v in w.items() if k != "pretrained.cls_token"})


def test_frame_tables_are_upstreams(pair):
    port, plain, _ = pair
    got = port.head.motion_modules[2].temporal_transformer.transformer_blocks[0].attention_blocks[0].pos_encoder.pe
    want = plain.head.motion_modules[2].temporal_transformer.transformer_blocks[0].attention_blocks[0].pos_encoder.pe
    assert got.shape == (1, 32, TINY.features) and torch.equal(got, want)


def test_published_widths_and_parameter_count():
    cfg, tasks = load_model_config(CONFIG)
    assert cfg == VDAConfig() and tasks == ("depth",)
    model = vda.VideoDepthAnything(cfg, device="meta")
    motion = sum(p.numel() for p in model.head.motion_modules.parameters())
    total = sum(p.numel() for p in model.parameters())
    assert motion == 49_074_688  # 22 C^2 + 21 C per module: 2 at C = 1024, 2 at C = 256
    assert round((total - motion) / 1e5) == 3353  # Depth Anything V2-Large's published 335.3M
    assert total == 384_390_337
    e = cfg.encoder
    assert (e.embed_dim, e.depth, e.num_heads, e.block.mlp_hidden, e.num_register_tokens) == (1024, 24, 16, 4096, 0)
    assert [mm.temporal_transformer.proj_in.weight.shape[0] for mm in model.head.motion_modules] == [1024, 1024, 256,
                                                                                                    256]


@pytest.mark.parametrize("change,message", [
    ({"init_args": {"encoder": "vits"}}, "encoder"),
    ({"init_args": {"pe": "rope"}}, "pe"),
    ({"motion_module": {"num_transformer_block": 2}}, "num_transformer_block"),
    ({"motion_module": {"temporal_max_len": 16}}, "temporal_max_len"),
    ({"pretrained": {"ffn_layer": "swiglufused"}}, "ffn_layer"),
    ({"init_args": {"num_frames": 16}, "motion_module": {"temporal_max_len": 16}}, "num_frames"),
    ({"infer_video_depth": {"INFER_LEN": 16}}, "INFER_LEN"),
    ({"infer_video_depth": {"OVERLAP": 8}}, "OVERLAP"),
    ({"infer_video_depth": {"KEYFRAMES": [0, 12, 24, 26, 27, 28, 29, 30, 31, 25]}}, "KEYFRAMES"),
    ({"infer_video_depth": {"INTERP_LEN": 4}}, "INTERP_LEN"),
    ({"head": {"micro_batch_size": 2}}, "micro_batch_size"),
])
def test_the_reader_refuses_what_the_port_does_not_build(change, message):
    tree = json.load(open(CONFIG))
    for group, kv in change.items():
        tree[group].update(kv)
    with pytest.raises(ValueError, match=message):
        vda_config_from_tree(tree)


def test_the_session_serves_a_state_dict_and_refuses_other_tasks(pair, clips):
    port, _, _ = pair
    sess = InferenceSession(TINY, ("depth",), "cpu", attention=plain_attention)
    out = sess(port.state_dict(), {"rgb_u8_bthw3": frames(44, 44)})
    assert set(out) == {"depth"}
    torch.testing.assert_close(out["depth"], clips[44][0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="Video Depth Anything serves"):
        InferenceSession(TINY, ("camera",), "cpu")
    with pytest.raises(ValueError, match="takes no mesh"):
        InferenceSession(TINY, ("depth",), "cpu", mesh=object())


@pytest.mark.parametrize("length", [22, 60, 110])
def test_window_frames_are_upstreams(length):
    """The inputs of each window as upstream's loop builds them: the clip
    padded with its last frame, the previous window's inputs at KEYFRAMES
    first; every window's first input is the clip's first frame."""
    clip = list(range(length))
    step = ref.INFER_LEN - ref.OVERLAP
    padded = clip + [clip[-1]] * ((step - length % step) % step + ref.INFER_LEN - step)
    want, pre = [], None
    for start in range(0, length, step):
        cur = padded[start: start + ref.INFER_LEN]
        if pre is not None:
            cur[:ref.OVERLAP] = [pre[k] for k in ref.KEYFRAMES]
        want.append(cur)
        pre = cur
    got = vda.window_frames(length)
    assert got == want and all(w[0] == 0 for w in got)
    x = torch.arange(length).view(1, length)
    assert all(vda.take(x, w).tolist() == [w] for w in got)


def test_take_slices_without_an_index_tensor(monkeypatch):
    """Window inputs are gathered from slices: no index tensor, which would
    reach a card by a blocking copy."""
    x = torch.arange(40).view(1, 40)

    def refuse(*a, **k):
        raise AssertionError("an index tensor was built")

    monkeypatch.setattr(torch, "tensor", refuse)
    assert vda.take(x, [0, 12, 24, 25, 26, 39, 39]).tolist() == [[0, 12, 24, 25, 26, 39, 39]]


def test_scale_and_shift_is_the_least_squares_fit():
    g = torch.Generator().manual_seed(2)
    pred = torch.rand(2, 2, 5, 7, generator=g)
    target = 1.7 * pred + 0.3
    target[1] = -0.5 * pred[1] + 2.0
    s, t = vda.scale_and_shift(pred, target)
    torch.testing.assert_close(s, torch.tensor([1.7, -0.5]), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(t, torch.tensor([0.3, 2.0]), rtol=1e-6, atol=1e-6)
    for b in range(2):  # the reference's upstream solve on the same inputs
        want = ref.compute_scale_and_shift(pred[b], target[b], torch.ones_like(pred[b]) == 1)
        torch.testing.assert_close(torch.stack([s[b], t[b]]), torch.stack(want), rtol=2e-6, atol=2e-6)
    s, t = vda.scale_and_shift(torch.ones(1, 2, 3, 3), torch.rand(1, 2, 3, 3, generator=g))  # singular: (1, 0)
    assert s.item() == 1.0 and t.item() == 0.0


@pytest.mark.parametrize("length", [22, 44])
def test_flops_count_the_references_products(length):
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.work.vda_flops import vda_request_flops

    plain = ref.VideoDepthAnything(ref_config()).eval().requires_grad_(False)
    with FlopCounterMode(display=False) as counter:
        plain.infer_video_depth(frames(length))
    assert vda_request_flops(TINY, length, H, W)["total"] == counter.get_total_flops()


def tiny_bench(tmp_path, frames_=44):
    """The benchmark with one tiny Video Depth Anything cell, written under tmp_path."""
    import shutil

    from portbench import manifest as mf

    pkg = tmp_path / "portbench"
    shutil.copytree(mf.PACKAGE_DIR, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    c = json.load(open(CONFIG))
    c["dtype"] = "float32"
    c["pretrained"].update(img_size=ENC.img_size, embed_dim=ENC.embed_dim, depth=ENC.depth, num_heads=ENC.num_heads)
    c["intermediate_layer_idx"] = list(TINY.intermediate_layers)
    c["init_args"].update(features=TINY.features, out_channels=list(TINY.out_channels))
    c["motion_module"].update(num_attention_heads=TINY.motion_heads, norm_num_groups=TINY.motion_groups)
    (pkg / "configs" / "vda_tiny.json").write_text(json.dumps(c))
    (pkg / "traffic" / "tiny-vda.json").write_text(json.dumps(
        {"driver": "vda", "frames": frames_, "height": H, "width": W, "tasks": ["depth"], "sample": 2,
         "sample_from": 3, "slice_requests": 1}))
    b = json.load(open("BENCHMARK.json"))
    b["configs"] = [{"name": "vda_tiny", "source": "x", "file": "portbench/configs/vda_tiny.json", "reduced": [],
                     "why": "t"}]
    b["workloads"] = [{"name": "tiny-vda", "config": "vda_tiny", "traffic": "tiny-vda", "chips": 1, "why": "t"}]
    b["end_to_end"] = [m for m in b["end_to_end"] if m["name"] in ("video_fps", "setup_s")]
    b["end_to_end"][0]["workloads"] = ["tiny-vda"]
    b["per_layer"] = []
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return mf.Manifest.load(tmp_path / "BENCHMARK.json", pkg)


STAGES = ("motion0.attn", "motion1.attn", "motion2.attn", "motion3.attn")


def test_the_driver_serves_and_compares(tmp_path):
    from portbench import run
    from portbench.calibrate import readings

    bench = tiny_bench(tmp_path)
    cell = bench.cell("tiny-vda")
    ctx = run.Context(cell, bench.traffic(cell["traffic"]), bench.config_path(cell["config"]), {}, 2 ** 31 + 13, 0.3,
                      False, torch.device("cpu"), None, time.perf_counter())
    served = __import__("portbench.drivers.vda", fromlist=["Cell"]).Cell(ctx)
    assert served.model.head.motion_modules[0].temporal_transformer.transformer_blocks[0].attention_blocks[0] \
        .pos_encoder.pe.abs().max() == 1.0  # upstream's table, not a draw
    win = served.window(0.3)
    assert win.attempted >= 2 and win.failed == 0 and win.end_to_end["video_fps"] > 0 and win.flops > 0
    assert set(served.check()) == {"depth", "window0.depth", "stitch.scale", "stitch.shift", *STAGES}
    # the plain path in fp32 against the reference: rounding apart; the fp8 control far from it
    got = readings(bench, "tiny-vda", 3, True, "cpu", torch.float32)
    assert all(v < 1e-5 for v in got["program"].values()), got["program"]
    assert all(v > 1e-4 for v in got["control"].values()), got["control"]


def attention_over_positions(monkeypatch):
    """A planted fault: each temporal attention attends over the window's
    positions within each frame instead of over the frames at each position."""
    forward = vda.TemporalAttention.forward

    def faulty(self, h, attention):
        return forward(self, h.transpose(0, 1).contiguous(), attention).transpose(0, 1)

    monkeypatch.setattr(vda.TemporalAttention, "forward", faulty)


def test_the_stage_readings_see_temporal_attention_run_over_positions(tmp_path, monkeypatch):
    """The motion modules' stage readings from the program's own inputs: at
    rounding with the program as it is, far off with the temporal attention
    run over positions, which moves the end-to-end depth too."""
    from portbench.calibrate import readings

    bench = tiny_bench(tmp_path, frames_=22)
    right = readings(bench, "tiny-vda", 4, False, "cpu", torch.float32)["program"]
    attention_over_positions(monkeypatch)
    wrong = readings(bench, "tiny-vda", 4, False, "cpu", torch.float32)["program"]
    for name in STAGES:
        assert right[name] < 1e-5, (name, right[name])
    assert min(wrong[name] for name in STAGES) > 1e-2, wrong
    assert wrong["window0.depth"] > 10 * right["window0.depth"], (right, wrong)
