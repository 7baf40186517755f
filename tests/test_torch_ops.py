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


@pytest.mark.parametrize("align_corners", [True, False])
def test_interpolate_trilinear_matches_jax(align_corners):
    from l4p_tpu.ops.resize import interpolate_trilinear

    x, size = rand((1, 2, 4, 16, 16), 0), (4, 28, 28)
    port = PRES.interpolate_trilinear(T(x), size, align_corners)
    # measured <= 3.5e-6: the JAX package builds fp32 interpolation matrices
    # from float64 positions, torch computes the weights in fp32
    check(port, interpolate_trilinear(J(x), size, align_corners=align_corners), 7e-6)


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
