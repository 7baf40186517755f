"""SAM 2.1 on the port (l4p_tpu_torch/models/sam2.py, models/sam.py's 2D
decoder) against the plain fp32 reference (tests/sam2_reference.py) on the
CPU at a tiny width: four Hiera stages of 1, 1, 2 and 1 blocks (a global
block in stage 3, q-pooling at each stage change), d_model 32 with the
published decoder (8 heads, MLP 2048: models/sam2.py's constants), 2 objects
and 10 frames with a memory ring of 2 and 4 pointers, so that both rings
wrap. Window partition with q-pooling across a stage change, axial RoPE
with the keys' repeat and the pointer tokens left out, the bank's order
after wrap-around, a whole propagation, the attention's plain route at head
dim 256, the shared two-way transformer, the published widths and names,
the reader, the session, the FLOP counts and the benchmark's driver with a
planted fault its stage readings must see.

Each tolerance is about 4x the largest error measured on the CPU (fp32,
the port's and the reference's summation orders), which is in brackets."""

import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from tests import sam2_reference as ref

from l4p_tpu_torch.config import SamConfig, Sam2Config, load_model_config, sam2_config_from_tree
from l4p_tpu_torch.inference import InferenceSession
from l4p_tpu_torch.models import sam as PS
from l4p_tpu_torch.models import sam2
from l4p_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain, kernel_unsupported

torch.set_num_threads(1)

CONFIG = "portbench/configs/sam2_1_hiera_l.json"
TINY = Sam2Config(image_size=128, embed_dim=8, num_heads=1, stages=(1, 1, 2, 1), global_att_blocks=(3,),
                  window_pos_embed_bkg_spatial_size=(3, 3), window_spec=(4, 2, 4, 2), d_model=32, memory_ffn=64,
                  mem_dim=8, num_maskmem=3, max_obj_ptrs=4)
T, N = 10, 2
PRESENT = "sam_mask_decoder.pred_obj_score_head.layers.2.bias"
TOL = 2e-6  # relative L2 of a stage or a whole propagation [<= 6.1e-7]


def ref_config(cfg: Sam2Config = TINY) -> SimpleNamespace:
    """The reference's namespace of `cfg`'s numbers and the port's constants
    (as read_config reads a file)."""
    out = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    return SimpleNamespace(**out, feat_size=cfg.feat_size, scalp=1, q_pool=3, decoder_depth=sam2.DECODER_DEPTH,
                           decoder_heads=sam2.DECODER_HEADS, decoder_mlp=sam2.DECODER_MLP)


def tiny_weights(model, seed=0):
    """Every tensor drawn: matrices at unit gain over their fan-in, norm
    scales 1 +- 0.3, other vectors +-0.2, embeddings and tables +-1; the
    object-score head's last bias 1 + |draw| (every object present)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, v in model.state_dict().items():
        u = torch.rand(v.shape, generator=g) * 2 - 1
        if v.dim() <= 1:
            leaf = name.rsplit(".", 2)
            out[name] = 1 + 0.3 * u if name.endswith("weight") and "norm" in leaf[-2] else 0.2 * u
        elif "embed" in name.rsplit(".", 1)[-1] or "gaussian" in name or name.endswith(("_token.weight", "tpos_enc")):
            out[name] = u
        else:
            out[name] = u * math.sqrt(3.0 / (math.prod(v.shape) // v.shape[0]))
    out[PRESENT] = 1 + out[PRESENT].abs()
    return out


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    plain = ref.SAM2Base(ref_config()).eval()
    port = sam2.Sam2(TINY).eval()
    w = tiny_weights(plain)
    plain.load_state_dict(w, strict=True)
    sam2.load_upstream_state_dict(port, w)
    return port, plain, w


def clip(seed=1, frames=T):
    g = torch.Generator().manual_seed(seed)
    rgb = torch.randint(0, 256, (1, frames, 128, 128, 3), generator=g, dtype=torch.uint8)
    coords = 8 + 112 * torch.rand((1, N, 1, 2), generator=g)
    return rgb, coords, torch.ones((1, N, 1), dtype=torch.int64)


@pytest.fixture(scope="module")
def propagated(pair):
    port, plain, _ = pair
    rgb, coords, labels = clip()
    with torch.no_grad():
        out = port(rgb, ("masks",), flash_attention, coords, labels)
        masks, scores = plain.propagate(rgb, coords[0], labels[0])
    return out, masks, scores


def test_whole_propagation_matches_the_reference(propagated):
    out, masks, scores = propagated
    got = out["mask_logits_btnhw"][0]
    assert got.shape == (T, N, 128, 128) and got.dtype == torch.float32
    assert bool((scores > 0).all())  # every object present: the masks carry the whole computation
    assert rel(got, masks) <= TOL, rel(got, masks)  # [5.2e-7]
    assert rel(out["object_score_logits_btn"][0], scores) <= TOL


def test_absent_objects_answer_the_constant_and_match(pair):
    """The object-score head's bias flipped: every object absent, its masks
    NO_OBJ_SCORE, the memories and pointers of absence carried on."""
    port, plain, w = pair
    w2 = dict(w, **{PRESENT: -w[PRESENT]})
    p2, r2 = sam2.Sam2(TINY).eval(), ref.SAM2Base(ref_config()).eval()
    sam2.load_upstream_state_dict(p2, w2)
    r2.load_state_dict(w2, strict=True)
    rgb, coords, labels = clip(2, 4)
    with torch.no_grad():
        out = p2(rgb, ("masks",), flash_attention, coords, labels)
        masks, scores = r2.propagate(rgb, coords[0], labels[0])
    assert bool((scores <= 0).all()) and bool((out["mask_logits_btnhw"] == ref.NO_OBJ_SCORE).all())
    assert rel(out["object_score_logits_btn"][0], scores) <= TOL


@pytest.mark.parametrize("block", [1, 2, 3, 4])  # q-pool at 1, 2 and 4 (stage changes), 3 global
def test_window_partition_and_q_pool_across_a_stage_change(pair, block):
    """One Hiera block from the same input: windows of the previous stage's
    size, q max-pooled 2x2 and the shortcut projected and pooled at a stage
    change; no windows in a global block."""
    port, plain, _ = pair
    pb, rb = port.image_encoder.trunk.blocks[block], plain.image_encoder.trunk.blocks[block]
    side = {1: 32, 2: 16, 3: 8, 4: 8}[block]
    assert pb.q_pool == (block in (1, 2, 4)) and pb.window == rb.window_size
    x = torch.randn((1, side, side, pb.dim), generator=torch.Generator().manual_seed(block))
    with torch.no_grad():
        got, want = pb(x, flash_attention), rb(x)
    assert got.shape == want.shape == (1, side // (2 if pb.q_pool else 1), side // (2 if pb.q_pool else 1),
                                       pb.dim_out)
    assert rel(got, want) <= TOL  # [2.4e-7]


def test_encoder_levels_match_the_reference(pair):
    port, plain, _ = pair
    rgb, _, _ = clip(3, 1)
    with torch.no_grad():
        pos = port.image_encoder.trunk.pos_table(32, 32)
        top, (s0, s1) = port.encode(rgb[:, 0], flash_attention, pos)
        feats, _, sizes = plain.features(plain.forward_image(rgb[:, 0]))
    assert rel(top.flatten(1, 2)[0], feats[-1][:, 0]) <= TOL
    for got, want, size in ((s0, feats[0], sizes[0]), (s1, feats[1], sizes[1])):
        assert rel(got, want.permute(1, 2, 0).view(1, -1, *size)) <= TOL


@pytest.mark.parametrize("repeat,pointers", [(1, 0), (3, 0), (3, 16), (5, 8)])
def test_axial_rope_with_k_repeat_and_excluded_pointers(repeat, pointers):
    """RoPE on the keys of `repeat` memories, the pointer tokens after them
    left as they are, against upstream's complex rotation."""
    d, side = 32, 8
    g = torch.Generator().manual_seed(repeat + pointers)
    q = torch.randn((2, side * side, d), generator=g)
    k = torch.randn((2, repeat * side * side + pointers, d), generator=g)
    table = sam2.rope_table(d, side, 10000.0)
    n_rope = k.shape[1] - pointers
    got_k = torch.cat([sam2.apply_rope(k[:, :n_rope], table), k[:, n_rope:]], 1)
    want_q, want_k = ref.apply_rotary_enc(q[:, None], k[:, None, :n_rope], ref.compute_axial_cis(d, side, side),
                                          repeat_freqs_k=True)
    assert torch.allclose(sam2.apply_rope(q, table), want_q[:, 0], atol=1e-6)
    assert torch.allclose(got_k[:, :n_rope], want_k[:, 0], atol=1e-6)
    assert torch.equal(got_k[:, n_rope:], k[:, n_rope:])


def test_memory_attention_matches_the_reference(pair):
    """Four layers over 2 memories and 3 pointers (12 tokens), one image for
    both objects (its first self-attention run once)."""
    port, plain, _ = pair
    g = torch.Generator().manual_seed(5)
    p, c, m = 64, 32, 8
    curr = torch.randn((1, p, c), generator=g)
    memory = torch.randn((N, 2 * p + 12, m), generator=g)
    memory_pos = torch.randn((1, 2 * p + 12, m), generator=g)
    with torch.no_grad():
        got = port.memory_attention(curr, port.curr_pos, memory, memory_pos, 12, flash_attention)
        want = plain.memory_attention(curr=curr.transpose(0, 1).expand(-1, N, -1),
                                      curr_pos=port.curr_pos[:, None].expand(-1, N, -1),
                                      memory=memory.transpose(0, 1),
                                      memory_pos=memory_pos.transpose(0, 1).expand(-1, N, -1), num_obj_ptr_tokens=12)
    assert rel(got, want.transpose(0, 1)) <= TOL  # [2.3e-7]


@pytest.mark.parametrize("num_maskmem,max_ptrs,frames", [(3, 4, 10), (7, 16, 64), (7, 16, 9)])
def test_memory_ring_and_pointer_order_after_wrap(num_maskmem, max_ptrs, frames):
    """The port's choice of slots and encodings against upstream's selection
    on every frame, the rings wrapped many times over."""
    pointers = min(frames, max_ptrs) - 1
    for f in range(1, frames):
        mems, ptrs = sam2.bank_order(f, num_maskmem - 1, pointers)
        want_m, want_p = ref.memory_selection(f, frames, num_maskmem, max_ptrs)
        assert [(j, num_maskmem - t_pos - 1) for t_pos, j in want_m] == mems
        assert [(t, d) for d, t in want_p] == ptrs
        # the ring slots of the frames read are distinct: none was overwritten
        assert len({(j - 1) % (num_maskmem - 1) for j, _ in mems[1:]}) == len(mems) - 1
        assert len({(j - 1) % max(pointers, 1) for j, _ in ptrs[1:]}) == len(ptrs) - 1


def test_memory_inputs_match_the_references_bank(pair):
    """The memory and positions the port assembles from its rings at frame 9
    (both rings wrapped) against those upstream assembles from every
    frame's outputs."""
    port, plain, _ = pair
    g = torch.Generator().manual_seed(6)
    p, c, m = 64, 32, 8
    pointers = min(T, TINY.max_obj_ptrs) - 1
    bank = sam2.Bank(N, p, m, c, TINY.num_maskmem - 1, pointers, "cpu", torch.float32)
    outs = {}
    for f in range(9):
        mem, ptr = torch.randn((N, p, m), generator=g), torch.randn((N, c), generator=g)
        bank.put(f, mem, ptr)
        outs[f] = {"maskmem_features": mem.transpose(1, 2).reshape(N, m, 8, 8), "obj_ptr": ptr,
                   "maskmem_pos_enc": [port.memory_pos.T.reshape(1, m, 8, 8).expand(N, -1, -1, -1)]}
    with torch.no_grad():
        dist = torch.arange(T, dtype=torch.float32) / pointers
        table = sam2.linear(sam2.sine_pe_1d(dist, c), port.obj_ptr_tpos_proj.weight, port.obj_ptr_tpos_proj.bias)
        memory, pos, n_ptr = port.memory_inputs(bank, 9, pointers, table)
        want, want_pos, want_n = plain.memory_bank(9, outs, T, N)
    assert n_ptr == want_n == 4 * (TINY.d_model // TINY.mem_dim)
    assert torch.allclose(memory, want.transpose(0, 1), atol=1e-6)
    assert torch.allclose(pos.expand(N, -1, -1), want_pos.transpose(0, 1), atol=1e-5)


def test_decoder_matches_the_reference_with_two_clicks(pair):
    """Two clicks: one mask, token 0 unless unstable (the best of 1..3 then),
    the pointer from token 0; every candidate, the IoU and object scores."""
    port, plain, _ = pair
    g = torch.Generator().manual_seed(7)
    pix = torch.randn((N, 32, 8, 8), generator=g)
    s0, s1 = torch.randn((1, 4, 32, 32), generator=g), torch.randn((1, 8, 16, 16), generator=g)
    coords, labels = 128 * torch.rand((N, 2, 2), generator=g), torch.tensor([[1, 0], [1, 1]])
    with torch.no_grad():
        masks, iou, score, low, ptr = port.decode(pix, (s0, s1), coords, labels)
        heads = plain._forward_sam_heads(pix, {"point_coords": coords, "point_labels": labels},
                                         [s0.expand(N, -1, -1, -1), s1.expand(N, -1, -1, -1)], False)
        multi = plain._forward_sam_heads(pix, {"point_coords": coords, "point_labels": labels},
                                         [s0.expand(N, -1, -1, -1), s1.expand(N, -1, -1, -1)], True)
    assert rel(masks[:, 1:], multi["candidates"]) <= TOL and rel(iou[:, 1:], multi["ious"]) <= TOL
    assert rel(low, heads["low_res_masks"]) <= TOL and rel(ptr, heads["obj_ptr"]) <= TOL
    assert rel(score, heads["object_score_logits"]) <= TOL


def test_d256_plain_route_and_kernel_limits():
    """Memory attention's shape takes the plain version on the CPU, which is
    upstream's attention, and the kernel's checks take head dim 256."""
    g = torch.Generator().manual_seed(8)
    q, k, v = torch.randn((2, 1, 64, 256), generator=g), *torch.randn((2, 2, 1, 200, 256), generator=g)
    before = flash_attention.launches
    out = flash_attention(q, k, v, 256 ** -0.5)
    assert flash_attention.launches == before and torch.equal(out, flash_attention_plain(q, k, v, 256 ** -0.5))
    assert rel(out, ref.attention(q, k, v)) <= TOL
    assert kernel_unsupported(8, 4096, 28736, 256) is None and kernel_unsupported(8, 4096, 4160, 256) is None
    assert "at most 256" in kernel_unsupported(8, 4096, 4096, 264)


def test_the_2d_and_3d_decoders_share_the_two_way_transformer(monkeypatch):
    """SAM 2's decoder runs models/sam.py's two-way transformer through the
    same `twoway_block` as the track head's naive schedule, and at a tiny
    SamConfig its transformer outputs are those of L4P's call bit for bit."""
    cfg = SamConfig(embed_dim=32, num_heads=2, mlp_dim=64, sam_head_depth=2, num_mask_tokens=4)
    md, pe = PS.Sam2MaskDecoder(cfg).eval(), PS.Sam2PromptEncoder(32).eval()
    for p in list(md.parameters()) + list(pe.parameters()):
        p.data.uniform_(-0.3, 0.3)
    calls, seen = [], {}
    block, apply = PS.twoway_block, PS.twoway_transformer_apply

    def counted(*a, **k):
        calls.append(1)
        return block(*a, **k)

    def kept(tf, c, image, image_pe, tokens, impl="streamed", kernels=PS.KERNELS):
        seen["inputs"], seen["impl"] = (image, image_pe, tokens), impl
        seen["out"] = apply(tf, c, image, image_pe, tokens, impl, kernels)
        return seen["out"]

    monkeypatch.setattr(PS, "twoway_block", counted)
    monkeypatch.setattr(PS, "twoway_transformer_apply", kept)
    g = torch.Generator().manual_seed(9)
    image, skips = torch.randn((2, 32, 4, 4), generator=g), (torch.randn((1, 4, 16, 16)), torch.randn((1, 8, 8, 8)))
    sparse = torch.randn((2, 2, 32), generator=g)
    with torch.no_grad():
        PS.sam2_decode(md, cfg, pe, image, skips, sparse, PS.dense_pe_2d(
            pe.pe_layer.positional_encoding_gaussian_matrix, 4, 4))
        monkeypatch.undo()
        l4p = PS.twoway_transformer_apply(md.transformer, cfg, *seen["inputs"], impl="naive")
    assert len(calls) == cfg.sam_head_depth and seen["impl"] == "naive"
    assert all(torch.equal(a, b) for a, b in zip(seen["out"], l4p))


def test_published_widths_names_and_parameter_count():
    with torch.device("meta"):
        model = sam2.Sam2(load_model_config(CONFIG)[0])
    names = {sam2.upstream_name(k) for k in model.state_dict()}
    for k in ("image_encoder.trunk.blocks.47.mlp.layers.1.weight", "image_encoder.trunk.blocks.44.proj.weight",
              "image_encoder.trunk.pos_embed_window", "image_encoder.neck.convs.3.conv.weight",
              "memory_attention.layers.3.cross_attn_image.k_proj.weight", "memory_encoder.fuser.layers.1.gamma",
              "memory_encoder.mask_downsampler.encoder.12.weight", "sam_mask_decoder.transformer.layers.1.mlp.layers.0"
              ".weight", "sam_mask_decoder.pred_obj_score_head.layers.2.bias", "sam_prompt_encoder.mask_downscaling.6"
              ".weight", "maskmem_tpos_enc", "no_obj_embed_spatial", "obj_ptr_tpos_proj.weight", "mask_downsample.weight"):
        assert k in names, k
    sd = model.state_dict()
    assert tuple(sd["memory_attention.layers.0.cross_attn_image.k_proj.weight"].shape) == (256, 64)
    assert tuple(sd["image_encoder.trunk.blocks.47.attn.qkv.weight"].shape) == (3 * 1152, 1152)
    assert [b.window for b in model.image_encoder.trunk.blocks].count(0) == 3
    n = sum(p.numel() for p in model.parameters())
    assert 222e6 < n < 226e6, n  # upstream's Hiera-L: about 224M


@pytest.mark.parametrize("group,key,value,message", [
    ("model", "fill_hole_area", 8, "builds 0"), ("memory_attention", "cross_num_heads", 2, "builds 1"),
    ("neck", "fpn_interp_model", "bilinear", "nearest"), ("trunk", "stages", [2, 6, 36], "four Hiera stages"),
    ("memory_attention", "kv_in_dim", 128, "ties it"), ("model", "multimask_min_pt_num", 1, "builds 0"),
    ("trunk", "q_pool", 2, "q-pooling at the last three")])
def test_the_reader_refuses_what_the_port_does_not_build(group, key, value, message):
    tree = json.load(open(CONFIG))
    assert sam2_config_from_tree(tree) == Sam2Config()
    tree[group][key] = value
    with pytest.raises(ValueError, match=message):
        sam2_config_from_tree(tree)


def test_the_session_serves_a_state_dict_and_refuses_other_tasks(pair, propagated):
    port, _, w = pair
    rgb, coords, labels = clip()
    data = {"rgb_u8_bthw3": rgb, "point_coords_bnk2": coords, "point_labels_bnk": labels, "prompt_frame": 0}
    out = InferenceSession(TINY, ("masks",), "cpu")(w, data)
    assert set(out) == {"mask_logits_btnhw", "object_score_logits_btn"}
    assert torch.equal(out["mask_logits_btnhw"], propagated[0]["mask_logits_btnhw"])
    with pytest.raises(ValueError, match="SAM 2 serves"):
        InferenceSession(TINY, ("depth",), "cpu")
    with pytest.raises(ValueError, match="frame 0"):
        InferenceSession(TINY, ("masks",), "cpu")(port, dict(data, prompt_frame=3))


@pytest.mark.parametrize("part", ["encode", "memory_attention"])
def test_flops_count_the_programs_products(pair, part):
    """The analytic count of work/sam2_flops.py against torch's count of the
    port's products at the tiny size (one frame; memory attention over 2
    memories and 3 pointers, its first self-attention once for both
    objects)."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.work.sam2_flops import encoder_flops, memory_attention_flops

    port, _, _ = pair
    rgb, _, _ = clip(4, 1)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        if part == "encode":
            port.encode(rgb[:, 0], flash_attention, port.image_encoder.trunk.pos_table(32, 32))
            want = encoder_flops(TINY)
        else:
            port.memory_attention(torch.randn(1, 64, 32), port.curr_pos, torch.randn(N, 140, 8),
                                  torch.randn(1, 140, 8), 12, flash_attention)
            want = memory_attention_flops(TINY, 140, N)
    assert fc.get_total_flops() == want


def tiny_bench(tmp_path, frames_=T):
    """The benchmark with one tiny SAM 2 cell, written under tmp_path."""
    import shutil

    from portbench import manifest as mf

    pkg = tmp_path / "portbench"
    shutil.copytree(mf.PACKAGE_DIR, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    c = json.load(open(CONFIG))
    c["dtype"] = "float32"
    c["model"].update(image_size=128, num_maskmem=3, max_obj_ptrs_in_encoder=4)
    c["trunk"].update(embed_dim=8, num_heads=1, stages=[1, 1, 2, 1], global_att_blocks=[3],
                      window_pos_embed_bkg_spatial_size=[3, 3], window_spec=[4, 2, 4, 2])
    c["neck"].update(d_model=32, backbone_channel_list=[64, 32, 16, 8], position_encoding_num_pos_feats=32)
    c["memory_attention"].update(d_model=32, dim_feedforward=64, feat_sizes=[8, 8], kv_in_dim=8)
    c["memory_encoder"].update(out_dim=8, position_encoding_num_pos_feats=8, fuser_dim=32)
    (pkg / "configs" / "sam2_tiny.json").write_text(json.dumps(c))
    (pkg / "traffic" / "tiny-sam2.json").write_text(json.dumps(
        {"driver": "sam2", "frames": frames_, "size": 128, "objects": N, "click_lo": 8, "click_hi": 120,
         "tasks": ["masks"], "sample": 2, "sample_from": 3, "slice_requests": 1}))
    b = json.load(open("BENCHMARK.json"))
    b["configs"] = [{"name": "sam2_tiny", "source": "x", "file": "portbench/configs/sam2_tiny.json",
                     "reduced": [], "why": "t"}]
    b["workloads"] = [{"name": "tiny-sam2", "config": "sam2_tiny", "traffic": "tiny-sam2", "chips": 1, "why": "t"}]
    b["end_to_end"] = [m for m in b["end_to_end"] if m["name"] in ("video_fps", "setup_s")]
    b["end_to_end"][0]["workloads"] = ["tiny-sam2"]
    b["per_layer"] = []
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return mf.Manifest.load(tmp_path / "BENCHMARK.json", pkg)


STAGES = ("early.attn", "steady.attn", "early.cross", "steady.cross", "early.masks", "steady.masks", "early.memory",
          "steady.memory", "frame0.memory")


def test_the_driver_serves_and_compares(tmp_path):
    from portbench import run
    from portbench.calibrate import readings

    bench = tiny_bench(tmp_path)
    cell = bench.cell("tiny-sam2")
    ctx = run.Context(cell, bench.traffic(cell["traffic"]), bench.config_path(cell["config"]), {}, 2 ** 31 + 13, 0.3,
                      False, torch.device("cpu"), None, time.perf_counter())
    served = __import__("portbench.drivers.sam2", fromlist=["Cell"]).Cell(ctx)
    assert 1 <= served.stage_frames["early"] <= 2 and served.stage_frames["steady"] >= 3
    win = served.window(0.3)
    assert win.attempted >= 2 and win.failed == 0 and win.end_to_end["video_fps"] > 0 and win.flops > 0
    assert set(served.check()) == {"encode.top", "frame0.masks", "frame0.iou", "frame0.score", "frame0.mask_logits",
                                   "frame0.memory", *(f"{f}.{k}" for f in ("early", "steady") for k in
                                                      ("attn", "cross", "bank", "bank_pos", "masks", "iou", "score",
                                                       "memory"))}
    # the plain path in fp32 against the reference: rounding apart; the fp8 control far from it
    got = readings(bench, "tiny-sam2", 3, True, "cpu", torch.float32)
    assert all(v < 1e-5 for v in got["program"].values()), got["program"]
    assert all(v > 1e-4 for k, v in got["control"].items() if not k.endswith(".bank")), got["control"]
    assert got["control"]["steady.bank"] == 0.0  # no product: the same memories under fp8


def test_the_stage_readings_see_a_bank_read_a_frame_stale(tmp_path, monkeypatch):
    """The stage readings from the program's own memories: at rounding with
    the program as it is, far off where the port reads each ring slot one
    frame stale (frame j's memory from frame j - 1's slot)."""
    from portbench.calibrate import readings

    bench = tiny_bench(tmp_path)
    right = readings(bench, "tiny-sam2", 4, False, "cpu", torch.float32)["program"]
    order = sam2.bank_order

    def stale(frame, memories, pointers):
        mems, ptrs = order(frame, memories, pointers)
        return mems[:1] + [(max(j - 1, 1), i) for j, i in mems[1:]], ptrs

    monkeypatch.setattr(sam2, "bank_order", stale)
    wrong = readings(bench, "tiny-sam2", 4, False, "cpu", torch.float32)["program"]
    for name in STAGES:
        assert right[name] < 1e-5, (name, right[name])
    assert right["steady.bank"] == right["early.bank"] == 0.0  # the program's own memories, in upstream's order
    assert wrong["steady.bank"] > 0.1 and wrong["steady.attn"] > 100 * right["steady.attn"], wrong


def test_the_cross_reading_sees_a_kernel_that_drops_keys(tmp_path):
    """Layer 0's cross-attention call held against the reference from the
    program's own q, k and v: at rounding with the attention as it is, far
    off where the attention leaves out the bank's last pointer (its last 4
    keys) in every call over the bank, more than memory attention's output
    after four residual layers moves (here 0.085 and 0.026 against 0.020
    and 0.0058, from 2e-7 and 3e-7 right; at the cell's width the output
    hardly moves with the keys: PERF.md)."""
    from portbench import run

    bench = tiny_bench(tmp_path)
    cell = bench.cell("tiny-sam2")

    def served_readings(attention=None):
        ctx = run.Context(cell, bench.traffic(cell["traffic"]), bench.config_path(cell["config"]), {}, 2 ** 31 + 14,
                          0.0, False, torch.device("cpu"), torch.float32, time.perf_counter())
        served = __import__("portbench.drivers.sam2", fromlist=["Cell"]).Cell(ctx)
        if attention is not None:
            served.session.attention = attention
        served.serve_sample()
        return served.readings()[0]

    def dropping(q, k, v, scale):
        if k.shape[2] != q.shape[2]:  # a call over the bank, not a self-attention
            k, v = k[:, :, :-4], v[:, :, :-4]
        return flash_attention(q, k, v, scale)

    right, wrong = served_readings(), served_readings(dropping)
    assert right["early.cross"] < 1e-5 and right["steady.cross"] < 1e-5, right
    for f in ("early", "steady"):
        assert wrong[f"{f}.cross"] > 1e-3 and wrong[f"{f}.cross"] > 2 * wrong[f"{f}.attn"], wrong
