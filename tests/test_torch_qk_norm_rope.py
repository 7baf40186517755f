"""The attention prologue of VGGT's blocks (l4p_tpu_torch/ops/qk_norm_rope.py)
on the CPU: its plain route against the branch `Block` ran before it
(inlined here), the one-frame rope table against the S-times repeated one,
the output layout, the autograd backward, the kernel wrapper's refusals,
which blocks reach it, and the benchmark's reader of its roofline share."""

import pytest
import torch
import torch.nn.functional as F

from l4p_tpu_torch.config import BlockConfig, VGGTConfig
from l4p_tpu_torch.models.encoder import Block
from l4p_tpu_torch.models.vggt import frame_positions
from l4p_tpu_torch.ops import qk_norm_rope as qnr
from l4p_tpu_torch.ops.flash_attention import in_kernel_layout
from l4p_tpu_torch.ops.qk_norm_rope import Rope2D, qk_norm_rope, qk_norm_rope_plain

HEADS, HD, EPS = 2, 32, 1e-6
GH, GW, SPECIAL = 3, 4, 5  # a frame of 3 x 4 patches after 5 special tokens: P = 17
FRAMES = 3
# (B, N): a frame block's B frames of P tokens; a global block's one sequence of FRAMES frames
SHAPES = {"frame": (FRAMES, SPECIAL + GH * GW), "global": (1, FRAMES * (SPECIAL + GH * GW))}
CASES = [(True, True), (True, False), (False, True)]  # (qk_norm, rope)


def before(qkv, heads, eps, norms, cos, sin, dtype):
    """Block's q/k branch as it was written before the op (models/encoder.py),
    with models/vggt.py's Rope2D of the positions it was given."""
    b, n, _ = qkv.shape
    qkv = qkv.view(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    hd = qkv.shape[-1]
    q, k = qkv[0].float(), qkv[1].float()
    if norms is not None:
        q = F.layer_norm(q, (hd,), norms[0].float(), norms[1].float(), eps)
        k = F.layer_norm(k, (hd,), norms[2].float(), norms[3].float(), eps)
    if cos is not None:
        def rope(t):
            parts = t.unflatten(-1, (2, 2, hd // 4))
            rot = torch.stack((-parts[..., 1, :], parts[..., 0, :]), -2).flatten(-3)
            return t * cos + rot * sin
        q, k = rope(q), rope(k)
    return q.to(dtype), k.to(dtype), qkv[2]


def operands(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    b, n = shape
    qkv = (2 * torch.randn((b, n, 3 * HEADS * HD), generator=g) + 0.5).to(dtype)
    norms = tuple((1 + 0.3 * torch.randn(HD, generator=g) if i % 2 == 0 else 0.2 * torch.randn(HD, generator=g))
                  .to(dtype) for i in range(4))
    return qkv, norms


def frame_rope():
    return Rope2D(frame_positions(GH, GW, SPECIAL, "cpu"), HD, 100.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("norm,rope", CASES)
def test_plain_route_equals_the_branch_it_replaced(norm, rope, kind, dtype):
    """Bit for bit: the op on the CPU against the pre-op branch, which took a
    global block's table from the S-times repeated positions."""
    qkv, norms = operands(SHAPES[kind], dtype)
    n = qkv.shape[1]
    table = Rope2D(frame_positions(GH, GW, SPECIAL, "cpu").repeat(n // (SPECIAL + GH * GW), 1), HD, 100.0)
    want = before(qkv, HEADS, EPS, norms if norm else None, table.cos if rope else None,
                  table.sin if rope else None, dtype)
    got = qk_norm_rope(qkv, HEADS, EPS, norms if norm else None, frame_rope() if rope else None)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_one_frame_table_rotates_as_the_repeated_one(kind):
    """Token n takes row n mod P of one frame's table: the same bits as the
    table of the repeated positions, for every token of the sequence."""
    t = torch.randn((2, HEADS, SHAPES[kind][1], HD), generator=torch.Generator().manual_seed(1))
    pos = frame_positions(GH, GW, SPECIAL, "cpu")
    repeated = Rope2D(pos.repeat(t.shape[2] // pos.shape[0], 1), HD, 100.0)
    assert frame_rope().cos.shape == (pos.shape[0], HD)
    assert torch.equal(frame_rope()(t), repeated(t))


def test_rope_refuses_a_partial_frame():
    with pytest.raises(ValueError, match="whole number"):
        frame_rope()(torch.zeros(1, 1, SHAPES["frame"][1] + 1, HD))


@pytest.mark.parametrize("norm,rope", CASES)
def test_outputs_lie_in_the_attention_kernels_layout(norm, rope):
    qkv, norms = operands(SHAPES["global"], torch.bfloat16)
    for t in qk_norm_rope(qkv, HEADS, EPS, norms if norm else None, frame_rope() if rope else None):
        assert t.shape == (1, HEADS, SHAPES["global"][1], HD) and in_kernel_layout(t)


@pytest.mark.parametrize("norm,rope", CASES)
def test_backward_matches_autograd_through_the_plain_version(norm, rope):
    qkv, norms = operands(SHAPES["frame"], torch.float32, seed=2)
    rope_t = frame_rope() if rope else None
    grads = [torch.randn((FRAMES, HEADS, SHAPES["frame"][1], HD), generator=torch.Generator().manual_seed(i))
             for i in range(3)]

    def run(fn):
        xs = [qkv.clone().requires_grad_(True), *(t.clone().requires_grad_(True) for t in norms)]
        outs = fn(xs[0], tuple(xs[1:]) if norm else None)
        torch.autograd.backward(outs, grads)
        return [x.grad for x in (xs if norm else xs[:1])]

    got = run(lambda x, ns: qk_norm_rope(x, HEADS, EPS, ns, rope_t))
    want = run(lambda x, ns: qk_norm_rope_plain(HEADS, EPS, x, *(ns or (None,) * 4),
                                                *((rope_t.cos, rope_t.sin) if rope else (None, None))))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,heads,rows,match", [
    ((2, 782, 3 * 16 * 64), 16, 782, None),  # VGGT's frame call
    ((1, 50048, 3 * 16 * 64), 16, 782, None),  # and its global call
    ((1, 50048, 3 * 16 * 64), 16, None, None),  # the norm alone
    ((2, 782, 3 * 16 * 88), 16, 782, "head_dim 64"),
    ((2, 782, 3 * 6 * 64), 6, 782, "multiple of 4"),
    ((1, 1000, 3 * 16 * 64), 16, 782, "multiple of the rope table"),
    ((0, 782, 3 * 16 * 64), 16, 782, "positive"),
])
def test_kernel_unsupported(shape, heads, rows, match):
    reason = qnr.kernel_unsupported(shape, heads, rows)
    assert (reason is None) if match is None else (match in reason)


def test_op_refuses_neither_a_norm_nor_a_rotation():
    qkv, _ = operands(SHAPES["frame"], torch.float32)
    with pytest.raises(ValueError, match="neither"):
        qk_norm_rope(qkv, HEADS, EPS)


def test_op_refuses_operands_on_two_devices():
    qkv, norms = operands(SHAPES["frame"], torch.float32)
    with pytest.raises(ValueError, match="qk_norm_rope"):
        qk_norm_rope(qkv.to("meta"), HEADS, EPS, norms)


@pytest.mark.parametrize("block,rope,calls", [
    ("vggt_aggregator", True, 1), ("vggt_aggregator", False, 1),  # q/k norm, with and without the rotation
    ("vggt_embedder", False, 0), ("vggt_camera", False, 0),  # DINOv2's and the camera trunk's: neither
    ("videomae", False, 0)])
def test_blocks_reach_the_op_through_its_module_attribute(monkeypatch, block, rope, calls):
    """Which blocks run the op is what the block is: q/k norm or a rope. A
    wrapper set on the module's attribute (as the benchmark's harness sets
    one) sees each call."""
    tiny = VGGTConfig(img_size=42, embed_dim=64, num_heads=2, embed_num_heads=2, camera_num_heads=2)
    cfg = {"vggt_aggregator": tiny.aggregator_block, "vggt_embedder": tiny.embed_block,
           "vggt_camera": tiny.camera_block, "videomae": BlockConfig(64, 2, 4.0, 1e-6)}[block]
    seen = []
    original = qnr.qk_norm_rope
    monkeypatch.setattr(qnr, "qk_norm_rope", lambda *a, **k: seen.append(1) or original(*a, **k))
    blk = Block(cfg).eval()
    x = torch.randn(FRAMES, SPECIAL + GH * GW, cfg.embed_dim, generator=torch.Generator().manual_seed(3))
    rope_t = Rope2D(frame_positions(GH, GW, SPECIAL, "cpu"), cfg.head_dim, 100.0) if rope else None
    with torch.no_grad():
        out = blk(x, lambda q, k, v, s: F.scaled_dot_product_attention(q, k, v, scale=s), rope=rope_t)
    assert out.shape == x.shape and len(seen) == calls


def test_block_output_is_unchanged_by_the_op():
    """A VGGT block's output on the CPU against the block written with the
    branch it replaced."""
    cfg = VGGTConfig(img_size=42, embed_dim=64, num_heads=2).aggregator_block
    blk = Block(cfg).eval()
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g) + (1.0 if p.dim() == 1 else 0.0))
    x = torch.randn(1, FRAMES * (SPECIAL + GH * GW), cfg.embed_dim, generator=g)
    pos = frame_positions(GH, GW, SPECIAL, "cpu")
    table = Rope2D(pos.repeat(FRAMES, 1), cfg.head_dim, 100.0)
    a = blk.attn
    kept = []

    def attention(q, k, v, scale):
        kept.append((q, k, v))
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    with torch.no_grad():
        blk(x, attention, rope=Rope2D(pos, cfg.head_dim, 100.0))
        h = F.layer_norm(x, (cfg.embed_dim,), blk.norm1.weight, blk.norm1.bias, cfg.ln_eps)
        flat = F.linear(h, a.qkv.weight, a.qkv_bias())
        norms = (a.q_norm.weight, a.q_norm.bias, a.k_norm.weight, a.k_norm.bias)
        want = before(flat, cfg.num_heads, cfg.ln_eps, norms, table.cos, table.sin, x.dtype)
    for g_, w in zip(kept[0], want):
        assert torch.equal(g_, w)


# the benchmark's reader of the kernel's roofline share (portbench/layers/qk_norm_rope_roofline.py)

def test_reader_counts_a_frame_and_a_global_call():
    from portbench.work.qk_norm_rope import moved

    frame = {"tokens": 64 * 782, "heads": 16, "head_dim": 64, "itemsize": 2, "table_rows": 782, "norm": True}
    qkv = 64 * 782 * 3 * 16 * 64 * 2
    table = 2 * 782 * 64 * 4
    assert moved(frame) == 2 * qkv + 4 * 64 * 2 + table  # q/k/v read and written once, the norms, cos and sin
    glob = dict(frame, tokens=50048)
    assert moved(glob) == moved(frame)  # one sequence of 64 frames moves what 64 frames do
    assert moved(dict(frame, norm=False)) == 2 * qkv + table
    assert moved(dict(frame, table_rows=0)) == 2 * qkv + 4 * 64 * 2


def test_reader_reads_the_programs_spans(monkeypatch):
    from portbench.layers import host_syncs, qk_norm_rope_roofline as reader
    from portbench.work.qk_norm_rope import moved

    attrs = {"tokens": 50048, "heads": 16, "head_dim": 64, "itemsize": 2, "table_rows": 782, "norm": True}
    spans = [{"name": "qk_norm_rope", "attrs": attrs, "device_ms": [1.0, 1.5]},
             {"name": "vggt/global_block", "attrs": {}, "device_ms": [0.5, 30.0]}]
    requests = [{"spans": spans, "host_syncs": 0}] * 2

    class Run:
        card, slice_units = "NVIDIA H100 80GB HBM3", 2

    monkeypatch.setattr(reader, "recorded", lambda run: requests)
    got = reader.read("qk_norm_rope_roofline.vggt", Run())
    assert got == pytest.approx(100 * moved(attrs) / 3.35e12 / 0.5e-3)
    monkeypatch.setattr(reader, "recorded", lambda run: [{"spans": spans[1:], "host_syncs": 0}] * 2)
    assert reader.read("qk_norm_rope_roofline.vggt", Run()) is None  # a program without the op's span
    Run.card = "cpu"
    monkeypatch.setattr(reader, "recorded", host_syncs.recorded)
    assert reader.read("qk_norm_rope_roofline.vggt", Run()) is None
