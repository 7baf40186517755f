"""The host-side data pipeline in numpy: the L4PData schema and its
preprocessing (counterpart of l4p_tpu/data/dataset.py; reference
l4p/data/l4p_dataset_mini.py:16-587).

Temporal mirror-pad to a multiple of 8, spatial resize with per-key modes
and the half-pixel rescale of the intrinsics, spatio-temporal crop with the
tracks, queries and K moved along, query grids (uniform, or over the eroded
instance mask) pinned to frame 0, the causal valid-mask fix and ImageNet
normalisation. The random draws are the JAX package's, in its order, so one
seed gives the same sample in both packages. Device work starts at the
model's boundary.
"""

from __future__ import annotations

import dataclasses
from math import ceil
from typing import Dict, List, Literal, Optional, Tuple

import numpy as np

from l4p_tpu_torch.models.ingest import IMAGENET_MEAN, IMAGENET_STD
from l4p_tpu_torch.ops.resize import interp_matrix


@dataclasses.dataclass
class L4PData:
    """Canonical sample schema; names encode shapes (without the batch dim)
    (reference l4p_dataset_mini.py:16-44)."""

    rgb_b3thw: np.ndarray
    intrinsics_b44t: Optional[np.ndarray] = None
    extrinsics_b44t: Optional[np.ndarray] = None
    rel_pose_b6t: Optional[np.ndarray] = None
    flow_2d_backward_b2thw: Optional[np.ndarray] = None
    flow_2d_backward_valid_b2thw: Optional[np.ndarray] = None
    flow_2d_forward_b2thw: Optional[np.ndarray] = None
    flow_2d_forward_valid_b2thw: Optional[np.ndarray] = None
    depth_b1thw: Optional[np.ndarray] = None
    depth_valid_b1thw: Optional[np.ndarray] = None
    instanceseg_b1thw: Optional[np.ndarray] = None
    dyn_mask_b1thw: Optional[np.ndarray] = None
    dyn_mask_valid_b1thw: Optional[np.ndarray] = None
    track_2d_traj_bn2t: Optional[np.ndarray] = None
    track_2d_depth_bn1t: Optional[np.ndarray] = None
    track_2d_vis_bn1t: Optional[np.ndarray] = None
    track_2d_valid_bn1t: Optional[np.ndarray] = None
    track_2d_pointquerries_bn3: Optional[np.ndarray] = None
    track_2d_pointlabels_bn: Optional[np.ndarray] = None
    dataset_name: Optional[str] = None
    seq_name: Optional[str] = None


_VIDEO_KEYS = (
    "rgb_b3thw",
    "depth_b1thw",
    "depth_valid_b1thw",
    "instanceseg_b1thw",
    "dyn_mask_b1thw",
    "dyn_mask_valid_b1thw",
)
_TIME_LAST_KEYS = (
    "track_2d_traj_bn2t",
    "track_2d_depth_bn1t",
    "track_2d_vis_bn1t",
    "track_2d_valid_bn1t",
    "intrinsics_b44t",
    "extrinsics_b44t",
    "rel_pose_b6t",
)


def _resize_chw(x: np.ndarray, size: Tuple[int, int], mode: str) -> np.ndarray:
    """Resize trailing (H, W) of (..., H, W). 'trilinear'/'bilinear' use the
    half-pixel convention; 'nearest' uses torch's floor(dst*in/out) index."""
    h, w = x.shape[-2], x.shape[-1]
    hh, ww = size
    if (h, w) == (hh, ww):
        return x
    if mode == "nearest":
        ri = np.minimum((np.arange(hh) * (h / hh)).astype(np.int64), h - 1)
        ci = np.minimum((np.arange(ww) * (w / ww)).astype(np.int64), w - 1)
        return x[..., ri[:, None], ci[None, :]]
    mh = interp_matrix(h, hh, align_corners=False)
    mw = interp_matrix(w, ww, align_corners=False)
    out = np.einsum("oi,...iw->...ow", mh, x.astype(np.float32))
    out = np.einsum("oi,...hi->...ho", mw, out)
    return out.astype(x.dtype) if np.issubdtype(x.dtype, np.floating) else out


def _erode3x3(mask_hw: np.ndarray) -> np.ndarray:
    """Binary 3x3 erosion (reference uses kornia erosion,
    l4p_dataset_mini.py:453-455)."""
    m = mask_hw > 0
    p = np.pad(m, 1, mode="edge")
    out = np.ones_like(m)
    for di in (0, 1, 2):
        for dj in (0, 1, 2):
            out &= p[di : di + m.shape[0], dj : dj + m.shape[1]]
    return out.astype(mask_hw.dtype)


class L4PDataset:
    """Base dataset; subclasses implement getitem_helper(index) -> L4PData."""

    default_sample_size = (16, 224, 224)

    def __init__(
        self,
        crop_size: Optional[Tuple[int, int, int]] = default_sample_size,
        track_2d_traj_per_sample: int = 128,
        center_crop: bool = False,
        start_crop_time: bool = False,
        resize_size: Optional[Tuple[int, int]] = None,
        resize_mode: Optional[Dict[str, str]] = None,
        estimation_directions: List[int] = [1, -1],
        length_multiply_of: int = 8,
        track_2d_querry_sampling_version: Optional[Literal["uniform", "uniform_over_seg"]] = None,
        track_2d_querry_sampling_spacing: float = 0.02,
        remove_queries_outside_bounds: bool = True,
        rng: Optional[np.random.Generator] = None,
        sample_size: Optional[Tuple[int, int, int]] = None,
        emit_uint8: bool = True,
    ) -> None:
        self.emit_uint8 = emit_uint8
        if sample_size is not None:  # override the (16, 224, 224) default
            self.default_sample_size = tuple(sample_size)
        self.crop_size = crop_size
        self.track_2d_traj_per_sample = track_2d_traj_per_sample
        self.center_crop = center_crop
        self.start_crop_time = start_crop_time
        if resize_size is not None and not isinstance(resize_size, tuple):
            resize_size = (resize_size, resize_size)
        self.resize_size = resize_size
        self.resize_mode = self._setup_resize_mode(resize_mode or {})
        self.estimation_directions = estimation_directions
        self.length_multiply_of = length_multiply_of
        self.track_2d_querry_sampling_version = track_2d_querry_sampling_version
        self.track_2d_querry_sampling_spacing = track_2d_querry_sampling_spacing
        self.remove_queries_outside_bounds = remove_queries_outside_bounds
        self.rng = rng or np.random.default_rng(0)

    @staticmethod
    def _setup_resize_mode(override: Dict[str, str]) -> Dict[str, str]:
        out = {
            "rgb_b3thw": "trilinear",
            "depth_b1thw": "nearest",
            "instanceseg_b1thw": "nearest",
            "flow_2d_backward_b2thw": "nearest",
            "flow_2d_forward_b2thw": "nearest",
            "flow_2d_backward_valid_b2thw": "nearest",
            "flow_2d_forward_valid_b2thw": "nearest",
            "depth_valid_b1thw": "nearest",
            "dyn_mask_b1thw": "nearest",
            "dyn_mask_valid_b1thw": "nearest",
        }
        out.update(override)
        return out

    def getitem_helper(self, index: int) -> L4PData:
        raise NotImplementedError

    # -- pipeline stages (l4p_dataset_mini.py:126-524) ----------------------

    def mirror_and_pad(self, s: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Temporal mirror with flow fwd/bwd swapped on the reflected copy
        (l4p_dataset_mini.py:126-190)."""
        out = {}
        for key, v in s.items():
            if not isinstance(v, np.ndarray):
                continue
            if key == "flow_2d_backward_b2thw":
                out[key] = np.concatenate([v, np.flip(s["flow_2d_forward_b2thw"], 1)[:, 1:]], 1)
                out["flow_2d_backward_valid_b2thw"] = np.concatenate(
                    [s["flow_2d_backward_valid_b2thw"], np.flip(s["flow_2d_forward_valid_b2thw"], 1)[:, 1:]], 1
                )
            elif key == "flow_2d_forward_b2thw":
                out[key] = np.concatenate([v, np.flip(s["flow_2d_backward_b2thw"], 1)[:, 1:]], 1)
                out["flow_2d_forward_valid_b2thw"] = np.concatenate(
                    [s["flow_2d_forward_valid_b2thw"], np.flip(s["flow_2d_backward_valid_b2thw"], 1)[:, 1:]], 1
                )
            elif key in ("flow_2d_forward_valid_b2thw", "flow_2d_backward_valid_b2thw"):
                continue
            elif key in _VIDEO_KEYS:
                out[key] = np.concatenate([v, np.flip(v, 1)[:, 1:]], 1)
            elif key in _TIME_LAST_KEYS:
                out[key] = np.concatenate([v, np.flip(v, -1)[..., 1:]], -1)
            elif key in ("track_2d_pointquerries_bn3", "track_2d_pointlabels_bn"):
                out[key] = v
            else:
                raise NotImplementedError(key)
        return out

    def repeat_single_frame(self, s: Dict[str, np.ndarray], length: int) -> Dict[str, np.ndarray]:
        """(l4p_dataset_mini.py:192-235)"""
        out = {}
        for key, v in s.items():
            if not isinstance(v, np.ndarray):
                continue
            if key in _VIDEO_KEYS:
                out[key] = np.tile(v, (1, length, 1, 1))
            elif key in ("track_2d_traj_bn2t", "track_2d_depth_bn1t", "track_2d_vis_bn1t",
                         "track_2d_valid_bn1t", "intrinsics_b44t"):
                out[key] = np.tile(v, (1, 1, length))
            elif key in ("track_2d_pointquerries_bn3", "track_2d_pointlabels_bn"):
                out[key] = v
            elif key == "extrinsics_b44t":
                out[key] = np.tile(np.eye(4, dtype=np.float32)[..., None], (1, 1, length))
            elif key == "rel_pose_b6t":
                out[key] = np.zeros((6, length), np.float32)
            else:
                raise NotImplementedError(key)
        return out

    def resize(self, s: Dict[str, np.ndarray], resize_size: Tuple[int, int]) -> Dict[str, np.ndarray]:
        """(l4p_dataset_mini.py:237-290)"""
        _, t, h, w = s["rgb_b3thw"].shape
        rf = (resize_size[0] / h, resize_size[1] / w)
        if rf == (1.0, 1.0):
            return s
        for key in list(s.keys()):
            v = s[key]
            if key in self.resize_mode:
                s[key] = _resize_chw(v, resize_size, self.resize_mode[key])
                if key in ("flow_2d_backward_b2thw", "flow_2d_forward_b2thw"):
                    s[key][0] = s[key][0] * rf[1]
                    s[key][1] = s[key][1] * rf[0]
            elif key == "track_2d_traj_bn2t":
                v[:, 0, :] *= rf[1]
                v[:, 1, :] *= rf[0]
            elif key == "track_2d_pointquerries_bn3":
                # keep query (x, y) in sync with the resized video (the
                # reference raises NotImplementedError here; queries are
                # normally sampled post-resize, but GT queries may pre-exist)
                v[:, 1] *= rf[1]
                v[:, 2] *= rf[0]
            elif key == "intrinsics_b44t":
                v[0, 0, :] *= rf[1]
                v[1, 1, :] *= rf[0]
                v[0, 2, :] = (v[0, 2, :] + 0.5) * rf[1] - 0.5
                v[1, 2, :] = (v[1, 2, :] + 0.5) * rf[0] - 0.5
            # time-only keys unchanged
        return s

    def crop(self, s: Dict[str, np.ndarray], crop_size: Tuple[int, int, int]) -> Dict[str, np.ndarray]:
        """Spatio-temporal crop with track/query/K adjustment
        (l4p_dataset_mini.py:292-395)."""
        _, t, h, w = s["rgb_b3thw"].shape
        tn, hn, wn = crop_size
        diff = (t - tn, h - hn, w - wn)
        if min(diff) < 0:
            raise ValueError(f"crop {tuple(crop_size)} is larger than the sample {(t, h, w)}")
        if diff == (0, 0, 0):
            return s

        t0 = 0 if (diff[0] <= 0 or self.start_crop_time) else int(self.rng.integers(0, diff[0]))
        if self.center_crop:
            i0 = 0 if diff[1] <= 0 else int(diff[1] * 0.5)
            j0 = 0 if diff[2] <= 0 else int(diff[2] * 0.5)
        else:
            i0 = 0 if diff[1] <= 0 else int(self.rng.integers(0, diff[1]))
            j0 = 0 if diff[2] <= 0 else int(self.rng.integers(0, diff[2]))

        for key in list(s.keys()):
            v = s[key]
            if not isinstance(v, np.ndarray):
                continue
            if key in _VIDEO_KEYS or key.startswith("flow_2d"):
                s[key] = v[:, t0 : t0 + tn, i0 : i0 + hn, j0 : j0 + wn]
            elif key in _TIME_LAST_KEYS:
                s[key] = v[..., t0 : t0 + tn]

        if "track_2d_pointquerries_bn3" in s and self.remove_queries_outside_bounds:
            q = s["track_2d_pointquerries_bn3"]
            valid = (q[:, 0] > t0) & (q[:, 0] < t0 + tn)
            valid &= (q[:, 1] > j0) & (q[:, 1] < j0 + wn)
            valid &= (q[:, 2] > i0) & (q[:, 2] < i0 + hn)
            s["track_2d_pointquerries_bn3"] = q[valid]
            for key in ("track_2d_traj_bn2t", "track_2d_vis_bn1t", "track_2d_depth_bn1t",
                        "track_2d_valid_bn1t", "track_2d_pointlabels_bn"):
                if key in s:
                    s[key] = s[key][valid]

        if "track_2d_traj_bn2t" in s:
            tr = s["track_2d_traj_bn2t"]
            tr[:, 0, :] -= j0
            tr[:, 1, :] -= i0
            vis = s["track_2d_vis_bn1t"]
            oob = (tr[:, 0] >= wn) | (tr[:, 0] < 0) | (tr[:, 1] >= hn) | (tr[:, 1] < 0)
            vis[:, 0][oob] = False
        if "intrinsics_b44t" in s:
            s["intrinsics_b44t"][0, 2, :] -= j0
            s["intrinsics_b44t"][1, 2, :] -= i0
        if "track_2d_pointquerries_bn3" in s:
            s["track_2d_pointquerries_bn3"][:, 0] -= t0
            s["track_2d_pointquerries_bn3"][:, 1] -= j0
            s["track_2d_pointquerries_bn3"][:, 2] -= i0
        return s

    def generate_point_querries(self, traj_n2t: np.ndarray, vis_n1t: np.ndarray) -> np.ndarray:
        """Sample one query per GT track at a random visible frame
        (reference generate_point_qurries, l4p_dataset_mini.py:397-416) —
        used by training datasets with GT tracks."""
        n, _, t = vis_n1t.shape
        vis_cumsum = np.cumsum(vis_n1t.astype(np.int32), axis=-1)
        traj_pts = np.concatenate(
            [np.tile(np.arange(t, dtype=np.float32)[None, None, :], (n, 1, 1)) + 0.5, traj_n2t], axis=1
        )
        out = []
        for i in range(n):
            r = self.rng.random()
            target = np.round(r * (vis_cumsum[i, 0, -1] - 1) + 1)
            idx = np.nonzero(vis_cumsum[i, 0, :] == target)[0][0]
            if not vis_n1t[i, 0, idx]:
                raise ValueError(f"track {i} is visible in no frame: no query to sample")
            out.append(traj_pts[i, :, idx])
        return np.stack(out).astype(np.float32)

    def sample_tracks(self, s: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Query sampling: uniform grid (optionally restricted to eroded
        instance seg), pinned to frame 0, pixel centers
        (l4p_dataset_mini.py:418-497)."""
        if "track_2d_pointquerries_bn3" in s:
            return s
        _, t, h, w = s["rgb_b3thw"].shape
        txy = (t, w, h)

        n = self.track_2d_traj_per_sample
        if self.track_2d_querry_sampling_version is not None:
            sp = self.track_2d_querry_sampling_spacing
            gx, gy = np.meshgrid(np.arange(0, 1, sp), np.arange(0, 1, sp), indexing="xy")
            pts = np.stack([np.zeros_like(gx), gx, gy], -1).reshape(-1, 3)
            if self.track_2d_querry_sampling_version == "uniform_over_seg":
                seg = _erode3x3(s["instanceseg_b1thw"][0, 0])
                # index by the seg's actual size (the reference hardcodes 224,
                # l4p_dataset_mini.py:458-459, which only works at 224x224)
                xi = (pts[:, 1] * seg.shape[1]).astype(np.int64)
                yi = (pts[:, 2] * seg.shape[0]).astype(np.int64)
                keep = seg[np.clip(yi, 0, seg.shape[0] - 1), np.clip(xi, 0, seg.shape[1] - 1)] > 0
                if keep.sum() > 0:
                    pts = pts[keep]
            q = pts.astype(np.float32)
            n = q.shape[0]
        else:
            q = self.rng.random((n, 3)).astype(np.float32)

        s["track_2d_traj_bn2t"] = np.zeros((n, 2, t), np.float32)
        s["track_2d_vis_bn1t"] = np.zeros((n, 1, t), bool)
        s["track_2d_depth_bn1t"] = np.ones((n, 1, t), np.float32)
        s["track_2d_valid_bn1t"] = np.zeros((n, 1, t), bool)

        q[..., 0] = 0  # sample queries in the first frame
        for i in range(3):
            q[..., i] = np.round(q[..., i] * (txy[i] - 1)) + 0.5
        s["track_2d_pointquerries_bn3"] = q
        s["track_2d_pointlabels_bn"] = np.ones((n,), np.float32)
        return s

    def fix_track_valid_for_causal_estimation(self, s: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """(l4p_dataset_mini.py:499-519)"""
        if "track_2d_valid_bn1t" not in s or len(self.estimation_directions) == 2:
            return s
        t = s["track_2d_valid_bn1t"].shape[-1]
        time_nt = 0.5 + np.arange(t)[None, :]
        qt = s["track_2d_pointquerries_bn3"][:, 0][:, None]
        ok = time_nt >= qt if self.estimation_directions[0] == 1 else time_nt <= qt
        s["track_2d_valid_bn1t"] = np.logical_and(s["track_2d_valid_bn1t"], ok[:, None, :])
        return s

    # -- assembly (l4p_dataset_mini.py:526-587) ----------------------------

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        raw = dataclasses.asdict(self.getitem_helper(index))
        sample = {k: v for k, v in raw.items() if isinstance(v, np.ndarray)}
        strs = {k: v for k, v in raw.items() if isinstance(v, str)}
        if "intrinsics_b44t" not in sample:
            sample["intrinsics_b44t"] = np.tile(
                np.eye(4, dtype=np.float32)[:, :, None], (1, 1, sample["rgb_b3thw"].shape[-3])
            )

        ori_len = sample["rgb_b3thw"].shape[-3]
        t_curr = ori_len
        crop_size = self.crop_size
        if crop_size is None:
            m = self.length_multiply_of
            t_new = ceil(max(t_curr, self.default_sample_size[0]) / m) * m
            crop_size = (t_new,) + self.default_sample_size[1:]

        if t_curr == 1:
            sample = self.repeat_single_frame(sample, crop_size[0])
        else:
            while t_curr < crop_size[0]:
                sample = self.mirror_and_pad(sample)
                t_curr = sample["rgb_b3thw"].shape[-3]

        if self.resize_size is not None:
            sample = self.resize(sample, self.resize_size)
        sample = self.crop(sample, crop_size)
        sample = self.sample_tracks(sample)
        sample = self.fix_track_valid_for_causal_estimation(sample)

        mean = IMAGENET_MEAN[:, None, None, None]
        std = IMAGENET_STD[:, None, None, None]
        sample["rgb_mean_b3111"] = mean
        sample["rgb_std_b3111"] = std
        if self.emit_uint8:
            # production transfer path: ship raw uint8 (T, H, W, 3); the
            # device normalizes inside the fused ingest matmul
            # (models/ingest.py). rgb_b3thw stays for visualization;
            # run_sequence keeps it on the host.
            sample["rgb_u8_bthw3"] = np.clip(
                np.round(sample["rgb_b3thw"].transpose(1, 2, 3, 0) * 255.0), 0, 255
            ).astype(np.uint8)
        sample["rgb_b3thw"] = (sample["rgb_b3thw"] - mean) / std
        sample.update(strs)
        sample["ori_video_len"] = ori_len
        return sample

    def __len__(self):
        raise NotImplementedError


def collate(sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Add the batch dim (the torch DataLoader's role at batch_size=1)."""
    out = {}
    for k, v in sample.items():
        if isinstance(v, np.ndarray):
            out[k] = np.ascontiguousarray(v[None]).astype(
                np.float32 if v.dtype == np.float64 or v.dtype == bool else v.dtype
            )
        else:
            out[k] = v
    return out
