"""Visualisation: per-task video panels and the 4D reconstruction export
(counterpart of l4p_tpu/utils/vis.py; reference l4p/utils/vis.py).

The panels are numpy: turbo-mapped depth, the Middlebury flow wheel, the
dynamic-mask overlay and rainbow track trails, concatenated side by side
(`panel_frames`). The colormaps are tables in this module, so only the track
trails (anti-aliased `cv2.line` / `cv2.circle`) and the mp4 encoding need
cv2, which they import where they run and name when it is missing. The
point clouds, camera frusta and 3D tracks are binary PLY files written
directly; their point maps run on a torch device.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from l4p_tpu_torch.geometry.core import generate_3d_track_point_map, generate_point_map

# ---------------------------------------------------------------------------
# colormaps
# ---------------------------------------------------------------------------

# matplotlib's ListedColormaps "turbo" and "viridis" (256 colours each) as the
# bytes of (colours * 255).astype(uint8), row-major (256, 3): what
# (cmap(x)[..., :3] * 255).astype(np.uint8) reads for any x
_TURBO_HEX = (
    "30123b31154232184a341b51351e5836215f37236538266c3929723a2c793b2f7f3c32853c358b3d37913e3a963f3d9c"
    "4040a14043a64145ab4148b0424bb5434eba4350be4353c24456c74458cb455bce455ed24560d64563d94666dd4668e0"
    "466be3466de64670e84673eb4675ed4678f0467af2467df4467ff64682f84584f94587fb4589fc448cfd438efd4291fe"
    "4193fe4096fe3f98fe3e9bfe3c9dfd3ba0fc39a2fc38a5fb36a8f934aaf833acf631aff52fb1f32db4f12bb6ef2ab9ed"
    "28bbeb26bde925c0e623c2e421c4e120c6df1ec9dc1dcbda1ccdd71bcfd41ad1d219d3cf18d5cc18d7ca17d9c717dac4"
    "17dcc217debf18e0bd18e1ba19e3b81ae4b61be5b41de7b11ee8af20e9ac22eba924eca627eda329eea02cef9d2ff09a"
    "32f19735f39438f4913bf48d3ff58a42f68746f7834af8804df97c51f97955fa7659fb725dfb6f61fc6c65fc6869fd65"
    "6dfd6271fd5f74fe5c78fe597cfe5680fe5384fe5087fe4d8bfe4b8efe4892fe4695fe4498fe429bfd409efd3ea1fc3d"
    "a4fc3ba6fb3aa9fb39acfa37aef937b1f836b3f835b6f735b9f534bbf434bef334c0f233c3f133c5ef33c8ee33caed33"
    "cdeb34cfea34d1e834d4e735d6e535d8e335dae236dde036dfde36e1dc37e3da37e5d838e7d738e8d538ead339ecd139"
    "edcf39efcd39f0cb3af2c83af3c63af4c43af6c23af7c039f8be39f9bc39f9ba38fab737fbb537fbb336fcb035fcae34"
    "fdab33fda932fda631fda330fea12ffe9e2efe9b2dfe982cfd952bfd9229fd8f28fd8c27fc8926fc8624fb8323fb8022"
    "fa7d20fa7a1ff9771ef8741cf7711bf76e1af66b18f56817f46516f36315f26014f15d13ef5a11ee5810ed550fec520e"
    "ea500de94d0de84b0ce6490be5460ae3440ae24209e04008de3e08dd3c07db3a07d93806d73606d63405d43205d23005"
    "d02f04ce2d04cb2b03c92903c72803c52602c32402c02302be2102bb1f01b91e01b61c01b41b01b11901ae1801ac1601"
    "a91501a61401a31201a011019d10019a0e01970d01940c01910b018e0a018b09018708018407018106027d05027a0402"
)
_VIRIDIS_HEX = (
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163471265471466471567471669"
    "47186a48196b481a6c481c6e481d6f481e70482071482172482273482374472575472676472777472878472a79472b7a"
    "472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
    "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d"
    "32628d32638d31648d31658d31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e"
    "26818e25828e25838d24848d24858d24868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
    "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
    "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
    "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517cd24f7ed24e81d34c"
    "83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
    "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"
)
# matplotlib's LinearSegmentedColormap "hsv" (matplotlib/_cm.py): per channel (x, y0, y1) anchors
_HSV_SEGMENTS = (
    ((0.0, 1.0, 1.0), (0.15873, 1.0, 1.0), (0.174603, 0.96875, 0.96875), (0.333333, 0.03125, 0.03125),
     (0.349206, 0.0, 0.0), (0.666667, 0.0, 0.0), (0.68254, 0.03125, 0.03125), (0.84127, 0.96875, 0.96875),
     (0.857143, 1.0, 1.0), (1.0, 1.0, 1.0)),
    ((0.0, 0.0, 0.0), (0.15873, 0.9375, 0.9375), (0.174603, 1.0, 1.0), (0.507937, 1.0, 1.0),
     (0.666667, 0.0625, 0.0625), (0.68254, 0.0, 0.0), (1.0, 0.0, 0.0)),
    ((0.0, 0.0, 0.0), (0.333333, 0.0, 0.0), (0.349206, 0.0625, 0.0625), (0.507937, 1.0, 1.0),
     (0.84127, 1.0, 1.0), (0.857143, 0.9375, 0.9375), (1.0, 0.09375, 0.09375)),
)
LUT_SIZE = 256


def _segment_lut(anchors, n: int = LUT_SIZE) -> np.ndarray:
    """One channel of a LinearSegmentedColormap: its n-entry table, by
    matplotlib.colors._create_lookup_table's arithmetic (gamma 1)."""
    a = np.array(anchors)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


@functools.lru_cache(maxsize=None)
def colormap_table(name: str) -> np.ndarray:
    """(256, 3) uint8: the colours of matplotlib's colormap `name` ("turbo",
    "viridis" or "hsv") as (colour * 255).astype(uint8)."""
    if name == "hsv":
        lut = np.stack([_segment_lut(s) for s in _HSV_SEGMENTS], -1)
        return (lut * 255).astype(np.uint8)
    hexes = {"turbo": _TURBO_HEX, "viridis": _VIRIDIS_HEX}
    if name not in hexes:
        raise ValueError(f"colormap {name!r}: the port has turbo, viridis and hsv")
    return np.frombuffer(bytes.fromhex(hexes[name]), np.uint8).reshape(LUT_SIZE, 3)


def apply_colormap(x, name: str) -> np.ndarray:
    """Values in [0, 1] -> (..., 3) uint8, as (matplotlib.colormaps[name](x)
    [..., :3] * 255).astype(np.uint8) computes it: index min(int(x * 256),
    255) in x's own float type, below 0 the first colour, NaN black."""
    xa = np.array(x, copy=True, dtype=np.result_type(np.asarray(x).dtype, np.float32))
    xa *= LUT_SIZE
    bad = np.isnan(xa)
    idx = np.clip(np.where(bad, 0, xa), 0, LUT_SIZE - 1).astype(np.int64)
    rgb = np.take(colormap_table(name), idx, axis=0)
    rgb[bad] = 0
    return rgb


def colormap_image(img_hw: np.ndarray, vmin: float = 0.05, vmax: float = 20.0, cmap: str = "turbo") -> np.ndarray:
    """Scalar map -> RGB uint8 (the reference clamps depth to [0.05, 20],
    vis.py:64-66)."""
    x = np.clip(img_hw, vmin, vmax)
    x = (x - vmin) / max(vmax - vmin, 1e-12)
    return apply_colormap(x, cmap)


def make_colorwheel() -> np.ndarray:
    """Middlebury flow colour wheel (55 colours, the standard construction)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col: col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col: col + yg, 1] = 255
    col += yg
    wheel[col: col + gc, 1] = 255
    wheel[col: col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col: col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col: col + cb, 2] = 255
    col += cb
    wheel[col: col + bm, 2] = 255
    wheel[col: col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col: col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col: col + mr, 0] = 255
    return wheel


_WHEEL = make_colorwheel()


def flow_to_color(flow_2hw: np.ndarray, max_rad: Optional[float] = None) -> np.ndarray:
    """Flow (2, H, W) -> RGB uint8, the Middlebury convention."""
    u, v = flow_2hw[0], flow_2hw[1]
    rad = np.sqrt(u ** 2 + v ** 2)
    if max_rad is None:
        max_rad = max(rad.max(), 1e-5)
    u, v = u / max_rad, v / max_rad
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    ncols = _WHEEL.shape[0]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(u.shape + (3,), np.uint8)
    for c in range(3):
        col = (1 - f) * (_WHEEL[k0, c] / 255.0) + f * (_WHEEL[k1, c] / 255.0)
        col = np.where(rad <= 1, 1 - rad * (1 - col), col * 0.75)
        img[..., c] = np.floor(255 * col)
    return img


def _track_colors(n: int) -> np.ndarray:
    """n rainbow colours (hsv at n evenly spaced hues, at least 2)."""
    return apply_colormap(np.linspace(0, 1, max(n, 2), endpoint=False), "hsv")


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs cv2 (opencv-python), which is not installed here") from e
    return cv2


def draw_tracks(rgb_thw3: np.ndarray, traj_n2t: np.ndarray, vis_n1t: Optional[np.ndarray] = None, trail: int = 8,
                vis_threshold: float = 0.0) -> np.ndarray:
    """Rainbow track trails on the frames (reference plot_2d_tracks,
    vis.py:430-523); vis is a logit, > threshold shows the point. Needs cv2."""
    cv2 = _cv2("draw_tracks")
    n = traj_n2t.shape[0]
    colors = _track_colors(n)
    out = rgb_thw3.copy()
    for t in range(rgb_thw3.shape[0]):
        frame = np.ascontiguousarray(out[t])
        for i in range(n):
            if vis_n1t is not None and not vis_n1t[i, 0, t] > vis_threshold:
                continue
            color = tuple(int(c) for c in colors[i])
            for dt in range(1, trail):
                tp = t - dt
                if tp < 0 or (vis_n1t is not None and not vis_n1t[i, 0, tp] > vis_threshold):
                    break
                x0, y0 = traj_n2t[i, :, tp + 1]
                x1, y1 = traj_n2t[i, :, tp]
                cv2.line(frame, (int(x0), int(y0)), (int(x1), int(y1)), color, 1, cv2.LINE_AA)
            x, y = traj_n2t[i, :, t]
            cv2.circle(frame, (int(x), int(y)), 2, color, -1, cv2.LINE_AA)
        out[t] = frame
    return out


# ---------------------------------------------------------------------------
# panel video
# ---------------------------------------------------------------------------

def _video_rgb(batch: Dict[str, np.ndarray]) -> np.ndarray:
    """The batch's first video de-normalised to [0, 1], (3, T, H, W)."""
    rgb = np.asarray(batch["rgb_b3thw"][0], np.float32)
    mean = np.asarray(batch["rgb_mean_b3111"][0]) if "rgb_mean_b3111" in batch else 0.0
    std = np.asarray(batch["rgb_std_b3111"][0]) if "rgb_std_b3111" in batch else 1.0
    return np.clip(rgb * std + mean, 0, 1)


def panel_frames(batch: Dict[str, np.ndarray], out: Dict[str, np.ndarray], tasks: Sequence[str],
                 dyn_mask_threshold: float = 0.85) -> np.ndarray:
    """The video and one panel per task side by side, (T, H, W * k, 3) uint8
    (reference generate_video_visualizations, vis.py:34-104): depth in turbo,
    flow on the colour wheel, the dynamic mask where its probability passes
    the threshold, the tracks' trails (cv2) with track_2d."""
    video = (_video_rgb(batch).transpose(1, 2, 3, 0) * 255).astype(np.uint8)  # (T, H, W, 3)
    t_total = video.shape[0]
    panels: List[np.ndarray] = [video]
    if "depth" in tasks and "depth_est_b1thw" in out:
        d = np.asarray(out["depth_est_b1thw"][0, 0], np.float32)
        panels.append(np.stack([colormap_image(d[t]) for t in range(t_total)]))
    if "flow_2d_backward" in tasks and "flow_2d_backward_est_b2thw" in out:
        fl = np.asarray(out["flow_2d_backward_est_b2thw"][0], np.float32)
        mx = max(float(np.sqrt((fl ** 2).sum(0)).max()), 1e-5)
        panels.append(np.stack([flow_to_color(fl[:, t], mx) for t in range(t_total)]))
    if "dyn_mask" in tasks and "dyn_mask_est_b1thw" in out:
        m = np.asarray(out["dyn_mask_est_b1thw"][0, 0], np.float32)
        mask = (1.0 / (1.0 + np.exp(-m)) > dyn_mask_threshold).astype(np.uint8) * 255  # vis.py:82-84
        panels.append(np.repeat(mask[..., None], 3, -1))
    if "track_2d" in tasks and "track_2d_traj_est_bn2t" in out:
        vis = out.get("track_2d_vis_est_bn1t")  # none: every point drawn
        panels.append(draw_tracks(video, np.asarray(out["track_2d_traj_est_bn2t"][0], np.float32),
                                  None if vis is None else np.asarray(vis[0])))
    return np.concatenate(panels, axis=2)


def write_mp4(frames_thw3: np.ndarray, out_path: str, fps: int = 15) -> str:
    """RGB uint8 frames -> an mp4v video. Needs cv2."""
    cv2 = _cv2("write_mp4")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    h, w = frames_thw3.shape[1:3]
    vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for frame in frames_thw3:
            vw.write(np.ascontiguousarray(frame[:, :, ::-1]))
    finally:
        vw.release()
    return out_path


def generate_video_visualizations(batch: Dict[str, np.ndarray], out: Dict[str, np.ndarray], tasks: Sequence[str],
                                  out_path: str, fps: int = 15, dyn_mask_threshold: float = 0.85) -> str:
    """`panel_frames` written as an mp4 (reference
    generate_video_visualizations, vis.py:34-104). Needs cv2."""
    _cv2("generate_video_visualizations")
    return write_mp4(panel_frames(batch, out, tasks, dyn_mask_threshold), out_path, fps)


# ---------------------------------------------------------------------------
# 4D export (.ply, no open3d)
# ---------------------------------------------------------------------------

def write_ply(path: str, xyz_n3: np.ndarray, rgb_n3: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY point cloud."""
    n = xyz_n3.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    fields = [("xyz", np.float32, 3)]
    if rgb_n3 is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        fields.append(("rgb", np.uint8, 3))
    header.append("end_header")
    arr = np.empty(n, np.dtype(fields))
    arr["xyz"] = xyz_n3.astype(np.float32)
    if rgb_n3 is not None:
        arr["rgb"] = rgb_n3.astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(arr.tobytes())


def camera_frustum_points(pose_44: np.ndarray, k_44: np.ndarray, hw: Tuple[int, int] = (224, 224),
                          scale: float = 0.2, points_per_edge: int = 12) -> np.ndarray:
    """A camera frustum as points in world space: centre-to-corner edges and
    the rim at depth `scale` (reference create_camera_frustum, vis.py:529-620)."""
    h, w = hw
    corners_px = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], np.float32)
    rays = (np.linalg.inv(k_44[:3, :3]) @ corners_px.T).T * scale  # (4, 3)
    ctr = np.zeros((1, 3), np.float32)
    t = np.linspace(0, 1, points_per_edge)[:, None]
    pts = [ctr]
    for i in range(4):
        pts.append(ctr + t * rays[i][None])  # centre -> corner
        pts.append(rays[i][None] * (1 - t) + rays[(i + 1) % 4][None] * t)  # rim
    return np.concatenate(pts, 0) @ pose_44[:3, :3].T + pose_44[:3, 3]


def generate_camera_trajectory_ply(out: Dict[str, np.ndarray], path: str, hw: Tuple[int, int] = (224, 224)) -> str:
    """Every frame's frustum in one PLY, coloured by time in viridis
    (reference generate_video_camera_trajectory, vis.py:623-680)."""
    pose = np.asarray(out["traj3d_est_b16t"], np.float32)
    t_total = pose.shape[-1]
    pose = pose.reshape(4, 4, t_total)
    k = np.asarray(out["traj3d_intrinsics_est_b16t"], np.float32).reshape(4, 4, t_total)
    pts, cols = [], []
    for t in range(t_total):
        p = camera_frustum_points(pose[:, :, t], k[:, :, t], hw)
        pts.append(p)
        cols.append(np.tile(apply_colormap(t / max(t_total - 1, 1), "viridis"), (p.shape[0], 1)))
    write_ply(path, np.concatenate(pts), np.concatenate(cols))
    return path


def _intrinsics(batch: Dict[str, np.ndarray], out: Dict[str, np.ndarray], t_total: int) -> np.ndarray:
    """(1, 4, 4, T): the estimated K, or the input's where the camray head
    uses it."""
    if "traj3d_intrinsics_est_b16t" in out:
        k = out["traj3d_intrinsics_est_b16t"]
    else:
        k = np.asarray(batch["intrinsics_b44t"])[:1]
    return np.asarray(k, np.float32).reshape(1, 4, 4, t_total)


def generate_3d_track_ply(batch: Dict[str, np.ndarray], out: Dict[str, np.ndarray], out_dir: str,
                          vis_threshold: float = 0.0, rescale_to_dense_depth: bool = True,
                          device: Union[str, torch.device] = "cuda") -> List[str]:
    """3D track points per frame: the 2D tracks and their depth unprojected to
    world on `device` (reference generate_3d_track_point_clouds,
    vis.py:683-766), the track depth rescaled to the dense depth by the
    median ratio at visible samples (vis.py:149-169)."""
    traj = np.asarray(out["track_2d_traj_est_bn2t"], np.float32)
    tdep = np.asarray(out["track_2d_depth_est_bn1t"], np.float32)
    vis = np.asarray(out["track_2d_vis_est_bn1t"], np.float32)
    t_total = traj.shape[-1]
    pose = np.asarray(out["traj3d_est_b16t"], np.float32).reshape(1, 4, 4, t_total)
    k = _intrinsics(batch, out, t_total)
    if rescale_to_dense_depth and "depth_est_b1thw" in out:
        dense = np.asarray(out["depth_est_b1thw"], np.float32)
        xs = np.clip(traj[0, :, 0].round().astype(int), 0, dense.shape[-1] - 1)
        ys = np.clip(traj[0, :, 1].round().astype(int), 0, dense.shape[-2] - 1)
        dense_at = dense[0, 0, np.broadcast_to(np.arange(t_total), xs.shape), ys, xs]
        m = vis[0, :, 0] > vis_threshold
        if m.sum() > 0:
            tdep = tdep * np.median(dense_at[m] / np.maximum(tdep[0, :, 0][m], 1e-6))
    dev = torch.device(device)
    xyz = generate_3d_track_point_map(*(torch.from_numpy(a).to(dev) for a in (traj, tdep, k, pose))).cpu().numpy()
    colors = _track_colors(traj.shape[1])
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for t in range(t_total):
        keep = vis[0, :, 0, t] > vis_threshold
        p = os.path.join(out_dir, f"tracks_{t:04d}.ply")
        write_ply(p, xyz[0, keep, :, t], colors[keep])
        paths.append(p)
    return paths


VIEWER_HTML = """<!doctype html><html><body style="margin:0">
<div style="position:fixed;z-index:1;color:#fff;font-family:monospace;padding:8px">
 frame <input id=s type=range min=0 max=0 value=0 style="width:300px"> <span id=l></span></div>
<script type="module">
import * as THREE from 'https://unpkg.com/three@0.160.0/build/three.module.js';
import {PLYLoader} from 'https://unpkg.com/three@0.160.0/examples/jsm/loaders/PLYLoader.js';
import {OrbitControls} from 'https://unpkg.com/three@0.160.0/examples/jsm/controls/OrbitControls.js';
const files = await (await fetch('files.json')).json();
const scene = new THREE.Scene();
const cam = new THREE.PerspectiveCamera(60, innerWidth/innerHeight, 0.01, 100);
cam.position.z = 2;
const r = new THREE.WebGLRenderer(); r.setSize(innerWidth, innerHeight);
document.body.appendChild(r.domElement);
new OrbitControls(cam, r.domElement);
const loader = new PLYLoader(); let pc = null;
const slider = document.getElementById('s'); slider.max = files.length - 1;
async function show(i){
  const g = await loader.loadAsync(files[i]);
  if (pc) scene.remove(pc);
  pc = new THREE.Points(g, new THREE.PointsMaterial({size:0.01, vertexColors:true}));
  scene.add(pc); document.getElementById('l').textContent = files[i];
}
slider.oninput = () => show(+slider.value);
show(0);
(function anim(){ requestAnimationFrame(anim); r.render(scene, cam); })();
</script></body></html>"""


def serve_point_clouds(ply_dir: str, port: int = 8001):
    """A minimal web point-cloud browser (in place of the reference's viser
    server, viser.py:14-89): writes the viewer's assets beside the PLYs
    (index.html, a Three.js page with a frame slider that the browser loads
    from unpkg.com, and files.json, the sorted PLY names) and returns an
    HTTP server over `ply_dir`; the caller runs its serve_forever()."""
    import http.server

    plys = sorted(f for f in os.listdir(ply_dir) if f.endswith(".ply"))
    with open(os.path.join(ply_dir, "index.html"), "w") as f:
        f.write(VIEWER_HTML)
    with open(os.path.join(ply_dir, "files.json"), "w") as f:
        json.dump(plys, f)
    handler = functools.partial(http.server.SimpleHTTPRequestHandler, directory=ply_dir)
    httpd = http.server.ThreadingHTTPServer(("", port), handler)
    print(f"point-cloud viewer: http://localhost:{httpd.server_address[1]}/ ({len(plys)} frames)")
    return httpd


def generate_4d_visualization(batch: Dict[str, np.ndarray], out: Dict[str, np.ndarray], out_dir: str,
                              depth_clip: Tuple[float, float] = (0.05, 20.0), stride: int = 1,
                              device: Union[str, torch.device] = "cuda") -> List[str]:
    """World point clouds of every `stride`-th frame from the depth and the
    estimated poses and K (reference generate_4D_visualization,
    vis.py:107-221): the point map runs on `device` and comes to the host
    once."""
    depth = np.asarray(out["depth_est_b1thw"], np.float32)
    t_total = depth.shape[2]
    pose = np.asarray(out["traj3d_est_b16t"], np.float32).reshape(1, 4, 4, t_total)
    k = _intrinsics(batch, out, t_total)
    frames = slice(0, t_total, stride)
    dev = torch.device(device)
    pm = generate_point_map(torch.from_numpy(np.ascontiguousarray(depth[:, :, frames])).to(dev),
                            torch.from_numpy(np.ascontiguousarray(k[..., frames])).to(dev),
                            torch.from_numpy(np.ascontiguousarray(pose[..., frames])).to(dev)).cpu().numpy()
    rgb = _video_rgb(batch)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, t in enumerate(range(t_total)[frames]):
        d = depth[0, 0, t].reshape(-1)
        keep = (d > depth_clip[0]) & (d < depth_clip[1])
        p = os.path.join(out_dir, f"pointcloud_{t:04d}.ply")
        write_ply(p, pm[0, :, i].reshape(3, -1).T[keep], (rgb[:, t].reshape(3, -1).T * 255).astype(np.uint8)[keep])
        paths.append(p)
    return paths
