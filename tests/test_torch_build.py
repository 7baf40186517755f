"""The port's one boundary to native code (l4p_tpu_torch/_build.py) on the
CPU: each of the seven kernel entry points runs its plain version for
operands on the CPU, bit for bit and without counting a launch, and refuses
operands split across devices; the library naming and the launch error
text. The kernels themselves are held against their plain versions on the
card (tests/test_torch_gpu.py)."""

import functools
import os

import pytest
import torch
import torch.nn.functional as F

from l4p_tpu_torch import _build
from l4p_tpu_torch.config import EncoderConfig
from l4p_tpu_torch.models.encoder import VideoEncoder
from l4p_tpu_torch.ops import flash_attention as FA
from l4p_tpu_torch.ops import fused_encoder as FE
from l4p_tpu_torch.ops import fused_keys as FK
from l4p_tpu_torch.ops import fused_upscale as FU
from l4p_tpu_torch.ops import resize as RS
from tests.test_torch_fused_keys import HEADS, operands
from tests.test_torch_fused_upscale import inputs
from tests.test_torch_ops import DPT_RESIZES, rand

torch.set_num_threads(1)

WRAPPERS = (FA.flash_attention, FK.t2i_flash, FK.i2t_ln_t2i, FU.fused_upscale_hypernet, RS.interpolate_trilinear,
            FE.fused_encoder_blocks, FE.gemm_nt)


def counts():
    """Every launch counter of the seven entry points."""
    return [(f.launches, getattr(f, "kernel_launches", None), dict(getattr(f, "variant_launches", {})))
            for f in WRAPPERS]


def attention_case():
    q, k, v = (torch.from_numpy(rand((2, 3, 40, 16), s)) for s in range(3))
    return [q, k, v], lambda *o: FA.flash_attention(*o, 0.25), lambda *o: FA.flash_attention_plain(*o, 0.25)


def t2i_case():
    return [torch.from_numpy(a) for a in operands(0)[:3]], FK.t2i_flash, FK.t2i_flash_plain


def i2t_case():
    args = [torch.from_numpy(a) for a in operands(0)]
    return ([args[0], *args[3:]], lambda *o: FK.i2t_ln_t2i(*o, HEADS),
            lambda *o: FK.i2t_ln_t2i_plain(*o, HEADS))


def upscale_case():
    return [torch.from_numpy(a) for a in inputs(2)], FU.fused_upscale_hypernet, FU.fused_upscale_hypernet_plain


def resize_case(shape, size, align_corners):
    def plain(x):
        return F.interpolate(x, size=size, mode="trilinear", align_corners=align_corners)

    return ([torch.from_numpy(rand(shape, 1))], lambda x: RS.interpolate_trilinear(x, size, align_corners), plain)


def encoder_case():
    cfg = EncoderConfig(embed_dim=64, depth=2, num_heads=2, mlp_ratio=4.0)
    enc = VideoEncoder(cfg).eval()
    enc.init_weights(torch.Generator().manual_seed(0))
    x = torch.from_numpy(rand((2, 24, 64), 3))
    return ([x], lambda t: FE.fused_encoder_blocks(enc.blocks, t, cfg, (1, 2)),
            lambda t: FE.fused_encoder_blocks_plain(enc.blocks, t, cfg, (1, 2)))


def gemm_case():
    a, w, bias = (torch.from_numpy(rand(s, i)) for i, s in enumerate(((12, 24), (16, 24), (16,))))
    out = torch.from_numpy(rand((12, 16), 4))
    return ([a, w, bias, out], lambda *o: FE.gemm_nt(*o[:3], FE.GELU, o[3].clone()),
            lambda *o: FE.gemm_nt_plain(*o[:3], FE.GELU, o[3].clone()))


CASES = {"flash_attention": attention_case, "t2i_flash": t2i_case, "i2t_ln_t2i": i2t_case,
         "fused_upscale_hypernet": upscale_case, "fused_encoder_blocks": encoder_case, "gemm_nt": gemm_case}
CASES.update({f"interpolate_trilinear {shape}->{size} align_corners={ac}":
              functools.partial(resize_case, shape, size, ac) for shape, size in DPT_RESIZES[:3] for ac in (True, False)})


@pytest.mark.parametrize("name", sorted(CASES))
def test_entry_points_run_the_plain_version_on_cpu_and_refuse_split_devices(name):
    """CPU operands take the plain version bit for bit and count no launch;
    one operand on another device (meta) raises a ValueError naming the
    entry point, before anything launches."""
    ops, run, plain = CASES[name]()
    before = counts()
    got, want = run(*ops), plain(*ops)
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert counts() == before  # no kernel ran
    entry = name.split()[0]
    with pytest.raises(ValueError, match=f"{entry}: .*one CUDA device"):
        run(*ops[:-1], ops[-1].to("meta"))
    assert counts() == before


def test_launch_error_names_tensor_map_failures():
    assert _build.launch_error(1) == "CUDA error 1"
    assert "tensor map" in _build.launch_error(-1) and "CUresult 1" in _build.launch_error(-1)


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
