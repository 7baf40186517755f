"""PyTorch port vs the JAX package: ops, aligners and config (fp32, CPU).

Inputs are made with numpy from a seed and fed to both packages. `check`
holds the port to the reference with |port - ref| <= tol * (1 + |ref|);
each tolerance is about twice the error measured on this comparison.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import l4p_tpu_torch.config as PC
from l4p_tpu_torch.geometry import alignment as PA
from l4p_tpu_torch.ops import attention as PATT
from l4p_tpu_torch.ops import conv as PCONV
from l4p_tpu_torch.ops import misc as PMISC
from l4p_tpu_torch.ops import resize as PRES

torch.set_num_threads(1)

DENSE_KINDS = ("flow", "depth", "dyn_mask", "camray", "camera_rays")


def check(port, ref, tol: float, what: str = "") -> None:
    a = np.asarray(port.float() if isinstance(port, torch.Tensor) else port, np.float64)
    b = np.asarray(ref, np.float64)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    err = float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))) if a.size else 0.0
    assert err <= tol, f"{what}: error {err:.3g} above tolerance {tol:g}"


def _same(cls, obj, **kw):
    """`cls` with the fields of `obj` of the same names, `kw` overriding."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls) if f.name not in kw}, **kw)


def port_track_config(jtrack) -> PC.TrackConfig:
    return _same(PC.TrackConfig, jtrack, sam=_same(PC.SamConfig, jtrack.sam))


def port_config(jcfg) -> PC.L4PConfig:
    """The port's config with the JAX config's encoder, dense heads and track
    head, copied field by field (the port's dataclasses mirror the JAX names)."""
    heads = tuple(
        (name, _same(PC.DenseHeadConfig, h, dpt=_same(PC.DPTConfig, h.dpt)))
        for name, h in jcfg.heads if h.kind in DENSE_KINDS
    )
    track = None if jcfg.track is None else port_track_config(jcfg.track)
    return _same(PC.L4PConfig, jcfg, encoder=_same(PC.EncoderConfig, jcfg.encoder), heads=heads, track=track)


def tiny_port_cfg() -> PC.L4PConfig:
    from tests.test_l4p_forward import tiny_cfg

    return port_config(tiny_cfg())


def rand(shape, seed=0, lo=None, hi=None) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


T = torch.from_numpy
J = jnp.asarray


# --- config ---------------------------------------------------------------

def test_defaults_match_released_yaml_field_by_field():
    """The port's dataclass defaults are the released model: they equal what
    the JAX package reads from configs/model.yaml, the camray head, the
    joint alignment and the track head included."""
    from l4p_tpu.config import load_model_config

    jcfg, tasks = load_model_config("configs/model.yaml")
    ref = port_config(jcfg)
    port = PC.L4PConfig()
    for f in dataclasses.fields(PC.L4PConfig):
        if f.name != "heads":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.encoder == PC.GIANT
    assert sorted(n for n, _ in port.heads) == sorted(n for n, _ in ref.heads) == \
        ["camray", "depth", "dyn_mask", "flow_2d_backward"]
    assert port.joint_alignment and (port.sim3_num_trials, port.sim3_min_samples) == (128, 10)
    port_heads, ref_heads = port.head_dict, ref.head_dict
    for name in port_heads:
        ph, rh = port_heads[name], ref_heads[name]
        for f in dataclasses.fields(PC.DenseHeadConfig):
            assert getattr(ph, f.name) == getattr(rh, f.name), f"{name}.{f.name}"


@pytest.mark.parametrize("path", ["configs/model.yaml", "configs/model_tiny.yaml"])
def test_load_model_config_matches_jax(path):
    from l4p_tpu.config import load_model_config

    jcfg, jtasks = load_model_config(path)
    pcfg, ptasks = PC.load_model_config(path)
    assert ptasks == jtasks
    assert pcfg == port_config(jcfg)


def yaml_with_head_class(tmp_path, cls: str) -> str:
    """configs/model_tiny.yaml with its depth head's class replaced by `cls`."""
    import yaml

    with open("configs/model_tiny.yaml") as f:
        tree = yaml.safe_load(f)
    heads = tree["init_args"]["l4p_model"]["init_args"]["task_heads"]["init_args"]["modules"]
    heads["depth"]["class_path"] = f"l4p.models.task_heads.dense_heads.{cls}"
    path = tmp_path / "model.yaml"
    path.write_text(yaml.safe_dump(tree))
    return str(path)


def test_unknown_head_class_raises_in_both_readers(tmp_path):
    from l4p_tpu.config import load_model_config

    path = yaml_with_head_class(tmp_path, "VideoMAEMysteryDPTHead")
    with pytest.raises(ValueError, match="unknown head class VideoMAEMysteryDPTHead"):
        load_model_config(path)
    with pytest.raises(ValueError, match="unknown head class VideoMAEMysteryDPTHead"):
        PC.load_model_config(path)


def test_camera_dpt_head_reads_as_camera_rays_in_both_readers(tmp_path):
    """VideoMAECameraDPTHead is a `camera_rays` head: 6 channels and
    camray's DPT variant with its output size, read field by field as the
    JAX reader reads it."""
    from l4p_tpu.config import load_model_config

    path = yaml_with_head_class(tmp_path, "VideoMAECameraDPTHead")
    jcfg, jtasks = load_model_config(path)
    pcfg, ptasks = PC.load_model_config(path)
    assert ptasks == jtasks
    assert pcfg == port_config(jcfg)
    head = pcfg.head_dict["depth"]
    assert (head.kind, head.out_nchan, head.dpt.num_channels, head.dpt.output_size) == ("camera_rays", 6, 6,
                                                                                        (16, 16, 16))
    assert head.dpt.fusion_scale_factors == pcfg.head_dict["camray"].dpt.fusion_scale_factors


def tiny_yaml_with_encoder(tmp_path, **keys) -> str:
    """configs/model_tiny.yaml with `keys` set in its encoder mapping."""
    import yaml

    with open("configs/model_tiny.yaml") as f:
        tree = yaml.safe_load(f)
    tree["init_args"]["l4p_model"]["init_args"]["encoder"].update(keys)
    path = tmp_path / "model.yaml"
    path.write_text(yaml.safe_dump(tree))
    return str(path)


def test_camera_embedding_is_refused_by_the_reader(tmp_path):
    """The reader reads the Plucker camera embedding as the JAX reader does
    (null, 'input' or 'output', 'add' or 'concat') and refuses a placement
    or type the encoder does not have, naming it, where the JAX encoder
    would run without the embedding."""
    from l4p_tpu.config import load_model_config

    for place in (None, "input", "output"):
        for kind in ("add", "concat"):
            path = tiny_yaml_with_encoder(tmp_path, cam_emb_placed_at=place, cam_emb_type=kind)
            enc = PC.load_model_config(path)[0].encoder
            assert (enc.cam_emb_placed_at, enc.cam_emb_type) == (place, kind)
            assert enc == _same(PC.EncoderConfig, load_model_config(path)[0].encoder)
    for keys, bad in (({"cam_emb_placed_at": "middle"}, "middle"), ({"cam_emb_type": "mul"}, "mul")):
        with pytest.raises(ValueError, match=bad):
            PC.load_model_config(tiny_yaml_with_encoder(tmp_path, **keys))


def _other_value(name: str, value):
    """A value of a JAX EncoderConfig field other than `value`, valid in both readers."""
    if name == "cam_emb_placed_at":
        return "output"
    if name == "cam_emb_type":
        return "concat"
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return 2 * value
    return value + 0.25


def test_every_jax_encoder_key_reads_as_the_jax_reader_reads_it(tmp_path):
    """For each field of JAX's EncoderConfig, a YAML setting it read by both
    readers: the port's config equals JAX's on every shared field, the
    XLA-only keys are dropped, and an unknown key raises ValueError naming it."""
    from l4p_tpu.config import load_model_config
    from l4p_tpu.models.encoder import EncoderConfig as JaxEncoderConfig

    port_fields = {f.name for f in dataclasses.fields(PC.EncoderConfig)}
    jax_fields = [f.name for f in dataclasses.fields(JaxEncoderConfig)]
    assert set(jax_fields) == port_fields | PC.XLA_ONLY_ENCODER_KEYS
    tiny = load_model_config("configs/model_tiny.yaml")[0].encoder
    for name in jax_fields:
        path = tiny_yaml_with_encoder(tmp_path, **{name: _other_value(name, getattr(tiny, name))})
        ref = load_model_config(path)[0].encoder
        out = PC.load_model_config(path)[0].encoder
        assert getattr(ref, name) != getattr(tiny, name)
        for f in port_fields:
            assert getattr(out, f) == getattr(ref, f), (name, f)
    with pytest.raises(ValueError, match="use_flash_atention"):
        PC.load_model_config(tiny_yaml_with_encoder(tmp_path, use_flash_atention=False))


# --- conv / norm / activation ----------------------------------------------

def test_layer_norm_matches_jax():
    from l4p_tpu.ops.conv import layer_norm

    x, w, b = rand((3, 5, 64), 0) * 3 + 1, rand((64,), 1), rand((64,), 2)
    check(PCONV.layer_norm(T(x), T(w), T(b), 1e-6), layer_norm(J(x), J(w), J(b), 1e-6), 7e-7)  # measured 3.1e-7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_dtype_policy_matches_jax(dtype):
    """Exact erf in fp32, tanh approximation in bf16. Measured 8.0e-7 in
    fp32; 5.2e-3 (one bf16 step) in bf16, where JAX evaluates the tanh form
    in bf16 steps and torch in fp32 with one final rounding."""
    from l4p_tpu.ops.conv import gelu

    x = rand((4096,), 0) * 4
    port = PCONV.gelu(T(x).to(getattr(torch, dtype)))
    ref = gelu(J(x).astype(dtype)).astype(jnp.float32)
    check(port, ref, 1.6e-6 if dtype == "float32" else 1.1e-2)


def test_linear_matches_jax():
    from l4p_tpu.ops.conv import linear

    x, w, b = rand((2, 7, 48), 0), rand((32, 48), 1), rand((32,), 2)
    check(PCONV.linear(T(x), T(w), T(b)), linear(J(x), J(w), J(b)), 3e-6)  # measured 1.3e-6


def track_products(dtype, n=3, heads=4, q=6, d=8, c=32, p=20):
    """The track head's einsum_fp32 products (models/sam.py) as {name: (spec,
    x, w, the call site's expression before einsum_fp32)}, operands in the
    layouts the call sites hand over (views included), the weights fp32."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dt=dtype):
        return torch.randn(*shape, generator=g).to(dt)

    qh = r(n, q, heads, d).transpose(1, 2)
    w_f32 = r(heads * d, c, dt=torch.float32).view(heads, d, c)
    s_flat, wsum, rr = r(n, heads * q, c), r(n, heads, q, c), r(n, c, heads * q)
    pe = r(c, p).t()  # pos_src is a transposed view
    wo_h = r(c, heads * d, dt=torch.float32).view(c, heads, d).permute(1, 2, 0)

    def mm(spec, x, w):  # models/sam.py's _mm
        return lambda: torch.einsum(spec, x.float(), w.to(x.dtype).float())

    return {
        "s": ("nhqd,hdc->nhqc", qh, w_f32, mm("nhqd,hdc->nhqc", qh, w_f32)),
        "spe": ("nkc,pc->npk", s_flat, pe, mm("nkc,pc->npk", s_flat, pe)),
        "outh": ("nhqc,hdc->nhqd", wsum, w_f32, mm("nhqc,hdc->nhqd", wsum, w_f32)),
        "r4": ("hdc,nhqd->nhcq", w_f32.to(dtype), qh,
               lambda: torch.einsum("hdc,nhqd->nhcq", w_f32.to(dtype).float(), qh.float())),
        "per": ("pc,nck->npk", pe.to(dtype), rr, lambda: torch.einsum("pc,nck->npk", pe.to(dtype).float(), rr.float())),
        "v2": ("nhqd,hdc->nhqc", qh, wo_h, mm("nhqd,hdc->nhqc", qh, wo_h)),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["s", "spe", "outh", "r4", "per", "v2"])
def test_einsum_fp32_off_the_card_is_the_call_sites_expression(name, dtype):
    spec, x, w, before = track_products(dtype)[name]
    launches = PCONV.einsum_fp32.launches
    got = PCONV.einsum_fp32(spec, x, w)
    assert got.dtype == torch.float32 and torch.equal(got, before())
    assert PCONV.einsum_fp32.launches == launches


@pytest.mark.parametrize("name", ["s", "spe", "outh", "r4", "per", "v2"])
def test_bmm_plan_is_the_einsum(name):
    """The tensor-core route's arrangement, with a float64 matmul as its
    product: the einsum's values; the PE products (spe, per) written in
    their (N, P, K) layout, the shared (P, C) encoding read in place."""
    spec, x, w, _ = track_products(torch.float32)[name]
    a, b, finish = PCONV._bmm_plan(spec, x, w)
    got = finish(torch.matmul(a.double(), b.double()))
    torch.testing.assert_close(got, torch.einsum(spec, x.double(), w.double()), rtol=1e-12, atol=1e-12)
    if name in ("spe", "per"):
        pe = w if name == "spe" else x
        shared = a if a.dim() == 2 else b
        assert got.is_contiguous() and shared.data_ptr() == pe.data_ptr() and shared.shape == pe.shape


def test_pe_products_on_meta_at_the_track_heads_shapes():
    """The route's product at N = 192, P = 2048, C = 1408, K = 48 on the meta
    device: the fp32 (N, P, K) result contiguous, (P, C) shared."""
    n, p, c, k = 192, 2048, 1408, 48
    pe = torch.empty((c, p), device="meta", dtype=torch.bfloat16).t()
    for spec, x, w in (("nkc,pc->npk", torch.empty((n, k, c), device="meta", dtype=torch.bfloat16), pe),
                       ("pc,nck->npk", pe, torch.empty((n, c, k), device="meta", dtype=torch.bfloat16))):
        a, b, finish = PCONV._bmm_plan(spec, x, w)
        out = finish(PCONV._BmmFp32.apply(a, b))
        assert out.shape == (n, p, k) and out.dtype == torch.float32 and out.is_contiguous()
        assert (a if a.dim() == 2 else b).shape == (p, c)


@pytest.mark.parametrize("shared", [None, 0, 1])
def test_bmm_fp32_backward_is_the_products_gradient(shared):
    """_BmmFp32's gradients (on the CPU in fp32, where its products are
    plain fp32 matmuls) against autograd through torch.matmul; `shared`
    names the 2-D operand read across the batch."""
    g = torch.Generator().manual_seed(1)
    a = torch.randn((2, 5, 7) if shared != 0 else (5, 7), generator=g, requires_grad=True)
    b = torch.randn((2, 7, 3) if shared != 1 else (7, 3), generator=g, requires_grad=True)
    grad = torch.randn(2, 5, 3, generator=g)
    torch.matmul(a, b).backward(grad)
    a2, b2 = (t.detach().clone().requires_grad_() for t in (a, b))
    PCONV._BmmFp32.apply(a2, b2).backward(grad)
    torch.testing.assert_close(a2.grad, a.grad)
    torch.testing.assert_close(b2.grad, b.grad)


def test_linear_fp32_off_the_card_is_its_old_product():
    """linear_fp32 (models/encoder.py's row-parallel product) off the card:
    bf16 operands give torch.mm of their fp32 copies bit for bit, with the
    gradients of that product's cotangent rounded to bf16; fp32 operands
    F.linear."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 5, 64, generator=g).bfloat16().requires_grad_()
    w = torch.randn(32, 64, generator=g).bfloat16().requires_grad_()
    y = PCONV.linear_fp32(x, w)
    assert y.dtype == torch.float32 and torch.equal(y, torch.mm(x.reshape(-1, 64).float(), w.float().t()).view(3, 5, 32))
    cot = torch.randn(y.shape, generator=g)
    y.backward(cot)
    c = cot.bfloat16().reshape(-1, 32).float()
    assert torch.equal(x.grad, (c @ w.float()).bfloat16().view_as(x))
    assert torch.equal(w.grad, (x.reshape(-1, 64).float().t() @ c).t().bfloat16())
    xf, wf = x.detach().float(), w.detach().float()
    assert torch.equal(PCONV.linear_fp32(xf, wf), torch.nn.functional.linear(xf, wf))


@pytest.mark.parametrize("stride,padding,k", [(1, 1, 3), (2, 1, 3), (1, 0, 1)])
def test_conv3d_matches_jax(stride, padding, k):
    from l4p_tpu.ops.conv import conv3d

    x, w, b = rand((2, 4, 5, 6, 7), 0), rand((3, 4, k, k, k), 1), rand((3,), 2)
    port = PCONV.conv3d(T(x), T(w), T(b), stride=stride, padding=padding)
    check(port, conv3d(J(x), J(w), J(b), stride=stride, padding=padding), 2.6e-7)  # measured <= 1.3e-7


@pytest.mark.parametrize("stride", [(2, 4, 4), (2, 2, 2)])
def test_conv_transpose3d_matches_jax(stride):
    from l4p_tpu.ops.conv import conv_transpose3d

    x, w, b = rand((2, 4, 3, 3, 3), 0), rand((4, 5, *stride), 1), rand((5,), 2)
    port = PCONV.conv_transpose3d(T(x), T(w), T(b), stride=stride)
    check(port, conv_transpose3d(J(x), J(w), J(b), stride=stride), 1e-7)  # measured 0


# --- resize ------------------------------------------------------------------

@pytest.mark.parametrize("sf", [(1, 2, 2), (2, 2, 2), (2, 1, 1)])
def test_interpolate_scale_matches_jax(sf):
    from l4p_tpu.ops.resize import interpolate_scale

    x = rand((2, 3, 4, 5, 6), 0)
    check(PRES.interpolate_scale(T(x), sf), interpolate_scale(J(x), sf, align_corners=True), 8e-7)  # measured <= 3.9e-7


# the DPT heads' five resizes (four fusion upsamples, the final resize to the
# window) at a small channel count
DPT_RESIZES = [((1, 2, 4, 8, 8), (8, 16, 16)), ((1, 2, 8, 16, 16), (16, 32, 32)), ((1, 2, 16, 32, 32), (16, 64, 64)),
               ((1, 2, 16, 64, 64), (16, 128, 128)), ((1, 1, 16, 128, 128), (16, 224, 224))]


# tolerances about twice the error measured at each shape (at most 3.5e-6,
# 2.6e-6, 3.8e-6, 9.7e-6, 4.4e-5): the JAX package builds fp32 interpolation
# matrices from float64 positions, torch computes each position in fp32 as
# scale * index, whose error grows with the output index
@pytest.mark.parametrize("shape,size,tol", [((1, 2, 4, 16, 16), (4, 28, 28), 7e-6)]
                         + [(*r, tol) for r, tol in zip(DPT_RESIZES, (7e-6, 7e-6, 7e-6, 2e-5, 9e-5))])
@pytest.mark.parametrize("align_corners", [True, False])
def test_interpolate_trilinear_matches_jax(align_corners, shape, size, tol):
    from l4p_tpu.ops.resize import interpolate_trilinear

    x = rand(shape, 0)
    port = PRES.interpolate_trilinear(T(x), size, align_corners)
    check(port, interpolate_trilinear(J(x), size, align_corners=align_corners), tol)


@pytest.mark.parametrize("shape,size", [((2, 3, 4, 5, 6), (7, 9, 11)), ((1, 2, 6, 8, 8), (3, 5, 8))])
@pytest.mark.parametrize("align_corners", [True, False])
def test_interpolate_trilinear_gradient_matches_plain(align_corners, shape, size):
    """The autograd.Function's backward (the plain version recomputed)
    gives F.interpolate's gradient, up- and downsampling."""
    x = T(rand(shape, 2)).requires_grad_(True)
    g = T(rand((shape[0], shape[1], *size), 3))
    (got,) = torch.autograd.grad(PRES.interpolate_trilinear(x, size, align_corners), x, g)
    ref_x = x.detach().clone().requires_grad_(True)
    ref = torch.nn.functional.interpolate(ref_x, size=size, mode="trilinear", align_corners=align_corners)
    (want,) = torch.autograd.grad(ref, ref_x, g)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_in,n_out", [(8, 16), (16, 224), (5, 3), (7, 7), (1, 4)])
@pytest.mark.parametrize("align_corners", [True, False])
def test_interp_matrix_matches_jax(n_in, n_out, align_corners):
    """The copied interpolation matrix (the track head's column means come
    from it), upsampling, downsampling and identity sizes."""
    from l4p_tpu.ops.resize import _interp_matrix

    port = PRES.interp_matrix(n_in, n_out, align_corners)
    assert port.shape == (n_out, n_in) and port.dtype == np.float32
    np.testing.assert_array_equal(port, np.asarray(_interp_matrix(n_in, n_out, align_corners)))


# --- misc --------------------------------------------------------------------

@pytest.mark.parametrize("fn_type", ["linear", "exp", "sigmoid", "log", "inverse"])
def test_apply_fn_matches_jax(fn_type):
    from l4p_tpu.ops.misc import apply_fn

    x = rand((257,), 0, 0.05, 3.0) if fn_type == "log" else rand((257,), 0)
    if fn_type == "inverse":
        x[:5] = 0.0
    check(PMISC.apply_fn(T(x), fn_type), apply_fn(J(x), fn_type), 2e-7)  # measured <= 7.9e-8


def test_safe_inverse_matches_jax():
    from l4p_tpu.ops.misc import safe_inverse

    x = rand((300,), 0)
    x[:7] = 0.0
    check(PMISC.safe_inverse(T(x), 0.1), safe_inverse(J(x), 0.1), 1e-7)  # measured 0


def test_mha_matches_jax():
    from l4p_tpu.ops.attention import mha

    q, k, v = rand((2, 3, 40, 16), 0), rand((2, 3, 24, 16), 1), rand((2, 3, 24, 16), 2)
    check(PATT.mha(T(q), T(k), T(v), 0.3), mha(J(q), J(k), J(v), 0.3), 7e-7)  # measured 3.1e-7


# --- aligners ------------------------------------------------------------------

@pytest.mark.parametrize("pre_inverse", [True, False])
def test_lstsq_affine_matches_jax(pre_inverse):
    from l4p_tpu.geometry import alignment as A

    pred, target = rand((2, 1, 4, 8, 8), 0, 0.5, 4.0), rand((2, 1, 4, 8, 8), 1, 0.5, 4.0)
    sol_p = PA.lstsq_affine_solve(T(pred), T(target), pre_inverse)
    sol_j = A.lstsq_affine_solve(J(pred), J(target), pre_inverse)
    # measured <= 9.3e-8
    check(sol_p, sol_j, 2e-7, "solve")
    check(PA.lstsq_affine_apply(sol_p, T(pred), pre_inverse), A.lstsq_affine_apply(sol_j, J(pred), pre_inverse),
          2e-7, "apply")


@pytest.mark.parametrize("method,pre_inverse", [("mean", False), ("median", False), ("median", True)])
def test_linear_scale_matches_jax(method, pre_inverse):
    from l4p_tpu.geometry import alignment as A

    pred, target = rand((3, 1, 2, 4, 4), 0, 0.5, 4.0), rand((3, 1, 2, 4, 4), 1, 0.5, 4.0)
    sol_p = PA.linear_scale_solve(T(pred), T(target), pre_inverse, method)
    sol_j = A.linear_scale_solve(J(pred), J(target), pre_inverse, method)
    # measured <= 1.2e-7
    check(sol_p, sol_j, 2.5e-7, "solve")
    check(PA.linear_scale_apply(sol_p, T(pred), pre_inverse), A.linear_scale_apply(sol_j, J(pred), pre_inverse),
          2.5e-7, "apply")
