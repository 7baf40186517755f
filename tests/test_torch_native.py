"""The port's host preprocessing library (l4p_tpu_torch.native.lib, built
with g++) against its numpy versions and against the JAX package's library
(l4p_tpu.native.lib, the same C++ source); a failed build raises with the
compiler's output instead of falling back."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from l4p_tpu.native import lib as jax_native
from l4p_tpu_torch import _build
from l4p_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD
from l4p_tpu_torch.native import lib as NL

RNG = np.random.default_rng(0)


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's library, built from its source into a directory of
    this test's own (so no build races tests/test_native.py's), its module
    state restored afterwards. The JAX package falls back to numpy quietly
    where its build fails; the comparison needs the build."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_SO", str(tmp_path_factory.mktemp("jax_native") / "libpreprocess.so"))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_build_failed", False)
        if jax_native.get_lib() is None:
            pytest.fail("the JAX package's native library did not build")
        yield jax_native


def test_normalize_matches_numpy_and_jax(jax_lib):
    frames = RNG.integers(0, 256, (6, 32, 48, 3), np.uint8)
    out = NL.normalize_video(frames, IMAGENET_MEAN, IMAGENET_STD)
    # x * (1 / (255 std)) - mean / std in C++ against (x / 255 - mean) / std: measured <= 4.8e-7
    np.testing.assert_allclose(out, NL.normalize_video_plain(frames, IMAGENET_MEAN, IMAGENET_STD), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out, jax_lib.normalize_video(frames, IMAGENET_MEAN, IMAGENET_STD))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("src,dst", [((40, 56), (28, 28)), ((48, 85), (22, 22)), ((20, 30), (27, 41))])
def test_resize_matches_numpy_and_jax(jax_lib, mode, src, dst):
    """Down and up, off-integer ratios, leading dimensions kept."""
    x = RNG.standard_normal((2, 3, *src)).astype(np.float32)
    out = NL.resize_planes(x, dst, mode)
    assert out.shape == (2, 3, *dst)
    plain = NL.resize_planes_plain(x, dst, mode)
    if mode == "nearest":
        np.testing.assert_array_equal(out, plain)
    else:  # the same float32 positions; g++ may fuse the products (measured <= 2.4e-7)
        np.testing.assert_allclose(out, plain, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out, jax_lib.resize_planes(x, dst, mode))


def test_nearest_resize_follows_torch_where_the_dataset_does_not():
    """At DAVIS's 480 x 854 -> 224 the library's float32 index equals
    F.interpolate's nearest; the dataset's resize (the JAX package's, float64
    index) reads another source row for output row 119, which the port keeps
    so that its samples equal the JAX package's."""
    from l4p_tpu_torch.data.dataset import _resize_chw

    x = RNG.standard_normal((1, 480, 854)).astype(np.float32)
    torch_out = F.interpolate(torch.from_numpy(x)[None], size=(224, 224), mode="nearest")[0].numpy()
    np.testing.assert_array_equal(NL.resize_planes(x, (224, 224), "nearest"), torch_out)
    rows = np.nonzero((_resize_chw(x, (224, 224), "nearest") != torch_out).any(-1)[0])[0]
    assert 119 in rows.tolist()


def test_mirror_pad_matches_numpy_and_jax(jax_lib):
    x = RNG.standard_normal((3, 5, 8, 8)).astype(np.float32)
    out = NL.mirror_pad_time(x)
    np.testing.assert_array_equal(out, NL.mirror_pad_time_plain(x))
    np.testing.assert_array_equal(out, jax_lib.mirror_pad_time(x))


def test_entry_points_refuse_bad_inputs():
    with pytest.raises(ValueError, match="uint8"):
        NL.normalize_video(np.zeros((2, 4, 4, 3), np.float32), IMAGENET_MEAN, IMAGENET_STD)
    with pytest.raises(ValueError, match="3 channel"):
        NL.normalize_video(np.zeros((2, 4, 4, 3), np.uint8), IMAGENET_MEAN[:2], IMAGENET_STD)
    with pytest.raises(ValueError, match="mode"):
        NL.resize_planes(np.zeros((4, 4), np.float32), (2, 2), "bicubic")
    with pytest.raises(ValueError, match="C, T, H, W"):
        NL.mirror_pad_time(np.zeros((4, 4, 4), np.float32))


@pytest.mark.parametrize("through", ["build", "first call"])
def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch, through):
    """A broken source raises g++'s output from the build (l4p_tpu_torch/_build.py
    compiles it), and again from an entry point's first call, which builds
    the library it binds."""
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" void f() { this is not C++; }\n')
    monkeypatch.setattr(NL, "SOURCE", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_loaded", {})  # nothing of this process's build is loaded
    monkeypatch.setattr(NL.MIRROR_PAD, "_fn", None)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed building .*broken.cpp:\n.*error: "):
        NL.build() if through == "build" else NL.mirror_pad_time(np.zeros((1, 2, 2, 2), np.float32))
    assert not list((tmp_path / "build").iterdir())  # no half-written library left behind
