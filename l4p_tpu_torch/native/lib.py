"""The host preprocessing library (native/preprocess.cpp), built with g++ at
first use and bound through l4p_tpu_torch/_build.py (counterpart of
l4p_tpu/native/lib.py).

`normalize_video`, `resize_planes` and `mirror_pad_time` run the C++ code,
multithreaded over frames; their `*_plain` versions are the numpy
definitions they are held against. There is no quiet fallback: a failed
build raises with the compiler's output. The library goes to
``l4p_tpu_torch/build/``, named by a hash of the source, the flags and the
host's CPU flags (``-march=native`` code from another machine could die of
an illegal instruction), so a change of any of them rebuilds.
"""

from __future__ import annotations

import os
import platform
from typing import Sequence

import numpy as np

from l4p_tpu_torch import _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "preprocess.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-lpthread")


def _host_tag() -> str:
    flags = ""
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
    return f"{platform.machine()} {flags}"


def build() -> str:
    """Compiles preprocess.cpp unless an up-to-date library exists; returns
    its path. Raises RuntimeError with g++'s output when the build fails."""
    out = _build.hashed_path("preprocess", " ".join(GXX_FLAGS) + _host_tag(), [SOURCE])
    return _build.compile_library(out, lambda tmp: ["g++", *GXX_FLAGS[:-1], "-o", tmp, SOURCE, GXX_FLAGS[-1]], SOURCE)


NORMALIZE = _build.Entry("preprocess", build, "normalize_thwc_u8_to_cthw_f32", "UFiiiFF", result=None)
RESIZE = {mode: _build.Entry("preprocess", build, f"resize_{mode}_f32", "FFiiiii", result=None)
          for mode in ("bilinear", "nearest")}
MIRROR_PAD = _build.Entry("preprocess", build, "mirror_pad_time_f32", "FFiiii", result=None)


def _stats(v) -> np.ndarray:
    a = np.ascontiguousarray(v, np.float32).reshape(-1)
    if a.shape != (3,):
        raise ValueError(f"expected 3 channel values, got shape {np.shape(v)}")
    return a


def normalize_video(frames_thwc_u8: np.ndarray, mean3, std3) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (3, T, H, W) float32, (x / 255 - mean) / std."""
    frames = np.ascontiguousarray(frames_thwc_u8)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (T, H, W, 3) uint8 frames, got {frames.dtype} {frames.shape}")
    t, h, w, _ = frames.shape
    out = np.empty((3, t, h, w), np.float32)
    NORMALIZE(frames, out, t, h, w, _stats(mean3), _stats(std3))
    return out


def normalize_video_plain(frames_thwc_u8: np.ndarray, mean3, std3) -> np.ndarray:
    x = (frames_thwc_u8.astype(np.float32) / 255.0 - np.asarray(mean3, np.float32)) / np.asarray(std3, np.float32)
    return np.ascontiguousarray(x.transpose(3, 0, 1, 2))


def resize_planes(x: np.ndarray, size: Sequence[int], mode: str = "bilinear") -> np.ndarray:
    """(..., H, W) float32 -> (..., H2, W2), bilinear (half-pixel, not
    antialiased) or nearest (floor(i * in / out)), in float32 arithmetic."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"mode {mode!r}: bilinear or nearest")
    h, w = x.shape[-2:]
    h2, w2 = size
    lead = x.shape[:-2]
    n = int(np.prod(lead)) if lead else 1
    src = np.ascontiguousarray(x.reshape(n, h, w), np.float32)
    dst = np.empty((n, h2, w2), np.float32)
    RESIZE[mode](src, dst, n, h, w, h2, w2)
    return dst.reshape(*lead, h2, w2)


def resize_planes_plain(x: np.ndarray, size: Sequence[int], mode: str = "bilinear") -> np.ndarray:
    """`resize_planes` in numpy, with the C++ code's float32 positions: the
    source position (i + 0.5) * in / out - 0.5 for bilinear, the index
    i * (in / out) for nearest (which F.interpolate's nearest equals). The
    dataset's `_resize_chw` (the JAX package's) computes them in float64,
    which at 480 -> 224 picks another nearest row (119) and moves bilinear
    weights by up to ~1e-4."""
    h, w = x.shape[-2:]
    h2, w2 = size
    f32 = np.float32

    def positions(n_in: int, n_out: int):
        i = np.arange(n_out, dtype=f32)
        if mode == "nearest":
            return np.minimum((i * (f32(n_in) / f32(n_out))).astype(np.int64), n_in - 1), None, None
        src = np.maximum(f32(0), (i + f32(0.5)) * f32(n_in) / f32(n_out) - f32(0.5))
        i0 = np.minimum(src.astype(np.int64), n_in - 1)
        return i0, np.minimum(i0 + 1, n_in - 1), src - i0.astype(f32)

    y0, y1, wy = positions(h, h2)
    x0, x1, wx = positions(w, w2)
    x = x.astype(f32)
    if mode == "nearest":
        return x[..., y0[:, None], x0[None, :]]
    if mode != "bilinear":
        raise ValueError(f"mode {mode!r}: bilinear or nearest")
    wy, wx = wy[:, None], wx[None, :]
    top = x[..., y0[:, None], x0[None, :]] * (1 - wx) + x[..., y0[:, None], x1[None, :]] * wx
    bottom = x[..., y1[:, None], x0[None, :]] * (1 - wx) + x[..., y1[:, None], x1[None, :]] * wx
    return top * (1 - wy) + bottom * wy


def mirror_pad_time(x_cthw: np.ndarray) -> np.ndarray:
    """(C, T, H, W) float32 -> (C, 2T - 1, H, W): the frames, then frames
    T-2 .. 0."""
    if x_cthw.ndim != 4:
        raise ValueError(f"expected (C, T, H, W), got shape {x_cthw.shape}")
    c, t, h, w = x_cthw.shape
    out = np.empty((c, 2 * t - 1, h, w), np.float32)
    MIRROR_PAD(np.ascontiguousarray(x_cthw, np.float32), out, c, t, h, w)
    return out


def mirror_pad_time_plain(x_cthw: np.ndarray) -> np.ndarray:
    return np.concatenate([x_cthw, np.flip(x_cthw, 1)[:, 1:]], 1)
