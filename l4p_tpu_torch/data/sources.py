"""Datasets on disk: DAVIS frame directories, videos, Dycheck sequences
(counterpart of l4p_tpu/data/sources.py; reference
l4p/data/{davis,video_dataset,dycheck_dataset}.py).

Stills are read with PIL, including the reference's antialias trick (a
downsize then an upsize at the original resolution, davis.py:86-90), and
videos with cv2.VideoCapture. Both are imported by the loaders, so this
module imports where neither is installed; a loader that needs a missing one
raises ImportError naming it.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from l4p_tpu_torch.data.dataset import L4PData, L4PDataset


def _pil(what: str):
    try:
        from PIL import Image, ImageOps
    except ImportError as e:
        raise ImportError(f"{what} needs PIL (pillow), which is not installed here") from e
    return Image, ImageOps


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs cv2 (opencv-python), which is not installed here") from e
    return cv2


def _pil_antialias(image_mod, img, resize_size: Tuple[int, int]):
    """Downsize, then upsize to the original resolution, both bilinear."""
    full = img.size
    img = img.resize(resize_size, resample=image_mod.Resampling.BILINEAR)
    return img.resize(full, resample=image_mod.Resampling.BILINEAR)


def _to_chw(img) -> np.ndarray:
    a = np.asarray(img, np.float32) / 255.0
    if a.ndim == 2:
        a = a[:, :, None]
    return a.transpose(2, 0, 1)


def _dummy_intrinsics(h: int, w: int, t: int) -> np.ndarray:
    """Focal min(h, w), principal point at the centre, for every frame."""
    f = float(min(h, w))
    k = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    return np.tile(k[:, :, None], (1, 1, t))


class DavisDataset(L4PDataset):
    """DAVIS-format frame directories, `JPEGImages/480p/<seq>/%05d.jpg` with
    optional `Annotations` masks (reference davis.py:24-141). Needs PIL."""

    def __init__(self, data_root: str, stride: int = 1, crop_size: Optional[Tuple[int, int, int]] = None,
                 resize_size: Tuple[int, int] = (224, 224), center_crop: bool = True, start_crop_time: bool = True,
                 estimation_directions: List[int] = [1], track_2d_querry_sampling_spacing: float = 0.02, **kw):
        super().__init__(crop_size=crop_size, center_crop=center_crop, start_crop_time=start_crop_time,
                         resize_size=resize_size, estimation_directions=estimation_directions,
                         track_2d_querry_sampling_version="uniform_over_seg",
                         track_2d_querry_sampling_spacing=track_2d_querry_sampling_spacing, **kw)
        self.data_root = data_root
        self.stride = stride
        self.scene_list = sorted(glob.glob(os.path.join(data_root, "JPEGImages/480p/*")))

    def __len__(self):
        return len(self.scene_list)

    def getitem_helper(self, index: int) -> L4PData:
        image, _ = _pil("DavisDataset")
        scene = self.scene_list[index]
        n = len(glob.glob(os.path.join(scene, "*.jpg")))
        rgbs, instances = [], []
        for i in range(0, n, self.stride):
            p = os.path.join(scene, "%05d.jpg" % i)
            rgbs.append(_to_chw(_pil_antialias(image, image.open(p), self.resize_size))[:3, None])
            ip = p.replace("JPEGImages", "Annotations").replace("jpg", "png")
            if os.path.isfile(ip):
                instances.append(_to_chw(_pil_antialias(image, image.open(ip), self.resize_size))[:1, None])
            else:
                instances.append(np.zeros_like(rgbs[-1][:1]))
        rgb = np.concatenate(rgbs, 1)
        inst = (np.concatenate(instances, 1).mean(0, keepdims=True) > 0).astype(np.float32)
        _, t, h, w = rgb.shape
        return L4PData(rgb_b3thw=rgb, intrinsics_b44t=_dummy_intrinsics(h, w, t), instanceseg_b1thw=inst,
                       seq_name=os.path.basename(scene))


class VideoDataset(L4PDataset):
    """Video files decoded by cv2 (reference video_dataset.py:17-137).
    Needs cv2 and PIL."""

    def __init__(self, video_paths: List[str], max_frames: int = 192, stride: int = 1,
                 crop_size: Optional[Tuple[int, int, int]] = None, resize_size: Tuple[int, int] = (224, 224),
                 center_crop: bool = True, start_crop_time: bool = True, estimation_directions: List[int] = [1],
                 track_2d_querry_sampling_spacing: float = 0.02, **kw):
        super().__init__(crop_size=crop_size, center_crop=center_crop, start_crop_time=start_crop_time,
                         resize_size=resize_size, estimation_directions=estimation_directions,
                         track_2d_querry_sampling_version="uniform",
                         track_2d_querry_sampling_spacing=track_2d_querry_sampling_spacing, **kw)
        self.video_paths = video_paths
        self.max_frames = max_frames
        self.stride = stride

    def __len__(self):
        return len(self.video_paths)

    def getitem_helper(self, index: int) -> L4PData:
        cv2 = _cv2("VideoDataset")
        image, _ = _pil("VideoDataset")
        path = self.video_paths[index]
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise FileNotFoundError(f"VideoDataset: cannot open video {path!r}")
        rgbs = []
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                img = _pil_antialias(image, image.fromarray(frame[:, :, ::-1]), self.resize_size)  # BGR -> RGB
                rgbs.append(_to_chw(img)[:3, None])
                if len(rgbs) == self.max_frames - 1:  # the reference's count (video_dataset.py:99)
                    break
        finally:
            cap.release()
        if not rgbs:
            raise ValueError(f"VideoDataset: no decodable frames in {path!r} (unsupported codec?)")
        rgb = np.concatenate(rgbs, 1)[:, :: self.stride]
        _, t, h, w = rgb.shape
        return L4PData(rgb_b3thw=rgb, intrinsics_b44t=_dummy_intrinsics(h, w, t),
                       instanceseg_b1thw=np.zeros((1, t, h, w), np.float32), seq_name=os.path.basename(path))


class DycheckDataset(L4PDataset):
    """Dycheck sequences, `<seq>/dense/images/*.png` with fx fy cx cy on the
    first line of `<seq>/calibration.txt` (reference dycheck_dataset.py:
    17-109). Needs PIL."""

    def __init__(self, data_root: str, stride: int = 1, crop_size: Optional[Tuple[int, int, int]] = None,
                 resize_size: Tuple[int, int] = (224, 224), center_crop: bool = True, start_crop_time: bool = True,
                 estimation_directions: List[int] = [1], resize_mode: Optional[Dict[str, str]] = None,
                 track_2d_querry_sampling_spacing: float = 0.02, **kw):
        super().__init__(crop_size=crop_size, center_crop=center_crop, start_crop_time=start_crop_time,
                         resize_size=resize_size, resize_mode=resize_mode or {"depth_b1thw": "trilinear"},
                         estimation_directions=estimation_directions, track_2d_querry_sampling_version="uniform",
                         track_2d_querry_sampling_spacing=track_2d_querry_sampling_spacing, **kw)
        self.data_root = data_root
        self.stride = stride
        self.seq_list = sorted(glob.glob(os.path.join(data_root, "*")))

    def __len__(self):
        return len(self.seq_list)

    def getitem_helper(self, index: int) -> L4PData:
        image, image_ops = _pil("DycheckDataset")
        dir_path = self.seq_list[index]
        imgs = sorted(glob.glob(os.path.join(dir_path, "dense", "images", "*.png")))[:: self.stride]
        rgb = np.concatenate([_to_chw(image_ops.exif_transpose(image.open(p)).convert("RGB"))[:3, None]
                              for p in imgs], 1)
        t = rgb.shape[1]
        with open(os.path.join(dir_path, "calibration.txt")) as f:
            fx, fy, cx, cy = (float(x) for x in f.readlines()[0].split(" ")[:4])
        k = np.eye(4, dtype=np.float32)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = fx, fy, cx, cy
        return L4PData(rgb_b3thw=rgb, intrinsics_b44t=np.tile(k[:, :, None], (1, 1, t)),
                       extrinsics_b44t=np.tile(np.eye(4, dtype=np.float32)[:, :, None], (1, 1, t)),
                       seq_name=f"Dycheck_{os.path.basename(dir_path)}")
