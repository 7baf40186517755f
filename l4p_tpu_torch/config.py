"""Configs of the port: the released giant model as dataclass defaults.

Counterparts of `EncoderConfig`/`GIANT` (l4p_tpu/models/encoder.py),
`DPTConfig` (models/dpt.py), `DenseHeadConfig`/`default_dense_heads`/
`L4PConfig` (models/l4p.py), `SamConfig` (models/sam.py), `TrackConfig`
(models/track.py) and `load_model_config` (config.py), holding the fields the
port runs. The dataclass defaults equal what the JAX package reads from
configs/model.yaml, so no YAML parser is needed to build the released model;
`yaml` is imported only by `load_model_config`, which applies the YAML
schema's own defaults to keys a file leaves out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

DENSE_KINDS = {
    "VideoMAEFlowDPTHead": "flow",
    "VideoMAEDepthDPTHead": "depth",
    "VideoMAEDynMaskDPTHead": "dyn_mask",
    "VideoMAETraj3DDPTHead": "camray",
    "VideoMAECameraDPTHead": "camera_rays",  # raw 6-channel rays (reference dense_heads.py:220-254)
}

# the DPT variant of the camray and camera_rays heads (reference
# dense_heads.py:269-270; l4p_tpu/config.py:38-42)
_CAMRAY_DPT_DEFAULTS = dict(
    actpost_scale_factors=((1, 0, 0), (1, 0, 0), (0, 0, 0), (-1, -1, -1)),
    fusion_scale_factors=((1, 1, 1), (1, 1, 1), (2, 1, 1), (2, 2, 2)),
    output_size=(16, 16, 16),
)


CAM_EMB_PLACES = (None, "input", "output")  # the Plucker camera embedding: none, after the positions, on the outputs
CAM_EMB_TYPES = ("add", "concat")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """ViT-giant video encoder (reference l4p_videomae.py:163-186)."""

    img_size: int = 224
    patch_size: int = 14
    in_chans: int = 3
    embed_dim: int = 1408
    depth: int = 40
    num_heads: int = 16
    mlp_ratio: float = 48 / 11
    tubelet_size: int = 2
    all_frames: int = 16
    ln_eps: float = 1e-6
    # the option branches (l4p_tpu/models/encoder.py:48-59, :79-81), with
    # the JAX defaults: cosine attention with a learnable clamped logit
    # scale; learnable positions (a persistent `pos_embed`); LayerScale
    # gammas when init_values > 0; stochastic depth, which acts only in
    # training; the Plucker camera embedding at the 'input' or on the
    # 'output' features, added ('add') or projected with them ('concat')
    cos_attn: bool = False
    use_learnable_pos_emb: bool = False
    init_values: float = 0.0
    drop_path_rate: float = 0.0
    cam_emb_placed_at: Optional[str] = None
    cam_emb_type: str = "add"
    # all blocks on ops/fused_encoder.py's kernels, with every window of a
    # request in one batch (l4p_tpu/models/encoder.py:91)
    fused_encoder: bool = False

    def __post_init__(self):
        if self.cam_emb_placed_at not in CAM_EMB_PLACES:
            raise ValueError(f"cam_emb_placed_at {self.cam_emb_placed_at!r}: expected one of {CAM_EMB_PLACES}")
        if self.cam_emb_type not in CAM_EMB_TYPES:
            raise ValueError(f"cam_emb_type {self.cam_emb_type!r}: expected one of {CAM_EMB_TYPES}")

    @property
    def tokens_thw(self) -> Tuple[int, int, int]:
        return (
            self.all_frames // self.tubelet_size,
            self.img_size // self.patch_size,
            self.img_size // self.patch_size,
        )

    @property
    def num_tokens(self) -> int:
        t, h, w = self.tokens_thw
        return t * h * w

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


GIANT = EncoderConfig()

# JAX encoder keys that steer only XLA's compilation (the flash-kernel
# switch, scan unrolling, matmul output dtype, rematerialisation, Pallas
# interpret mode): the YAML reader accepts and drops them
XLA_ONLY_ENCODER_KEYS = frozenset(
    {"use_flash_attention", "unroll_blocks", "matmul_out_compute_dtype", "remat_blocks", "flash_interpret"})


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    num_channels: int
    hooks: Tuple[int, ...] = (14, 21, 28, 36)
    layer_dims: Tuple[int, ...] = (256, 512, 1024, 1024)
    feature_dim: int = 256
    last_dim: int = 128
    dim_tokens: int = 1408
    patch_size: Tuple[int, int, int] = (2, 14, 14)
    actpost_scale_factors: Tuple[Tuple[int, int, int], ...] = ((1, 2, 2), (1, 1, 1), (0, 0, 0), (-1, -1, -1))
    fusion_scale_factors: Tuple[Tuple[int, int, int], ...] = ((1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2))
    output_size: Optional[Tuple[int, int, int]] = None  # None -> the window's (T, H, W)


@dataclasses.dataclass(frozen=True)
class DenseHeadConfig:
    """Defaults are the reference's (dense_heads.py:155), as the YAML loader
    applies them; `default_dense_heads` sets what configs/model.yaml sets."""

    task_name: str
    kind: str  # 'flow' | 'depth' | 'dyn_mask' | 'camray' | 'camera_rays'
    out_nchan: int
    dpt: DPTConfig
    depth_fn: str = "linear"
    mask_fn: str = "linear"
    align_pre_inverse: bool = False  # depth aligned in disparity
    align_type: str = "affine"  # 'affine' | 'linear'
    # camray: poses from the input intrinsics, else K estimated once from
    # window 0 (fixed) or per frame (variable); l4p_tpu/config.py:106-107
    use_intrinsics: bool = True
    fixed_intrinsics: bool = False


def default_dense_heads(hooks: Tuple[int, ...] = (14, 21, 28, 36)) -> Dict[str, DenseHeadConfig]:
    """The released configs/model.yaml flow, depth, dyn_mask and camray heads."""
    return {
        "flow_2d_backward": DenseHeadConfig(
            task_name="flow_2d_backward", kind="flow", out_nchan=2,
            dpt=DPTConfig(num_channels=2, hooks=hooks),
        ),
        "depth": DenseHeadConfig(
            task_name="depth", kind="depth", out_nchan=1,
            dpt=DPTConfig(num_channels=1, hooks=hooks),
            depth_fn="exp", align_pre_inverse=True,
        ),
        "dyn_mask": DenseHeadConfig(
            task_name="dyn_mask", kind="dyn_mask", out_nchan=1,
            dpt=DPTConfig(num_channels=1, hooks=hooks),
        ),
        "camray": DenseHeadConfig(
            task_name="traj3d", kind="camray", out_nchan=6,
            dpt=DPTConfig(num_channels=6, hooks=hooks, **_CAMRAY_DPT_DEFAULTS),
            use_intrinsics=False, fixed_intrinsics=True,
        ),
    }


@dataclasses.dataclass(frozen=True)
class SamConfig:
    """Prompt encoder + two-way transformer + mask decoder of the track head
    (l4p_tpu/models/sam.py:24-47)."""

    embed_dim: int = 1408
    image_embedding_size: Tuple[int, int, int] = (8, 16, 16)
    input_image_size: Tuple[int, int, int] = (16, 224, 224)
    num_point_embeddings: int = 2
    num_prompt_feature_embeddings: int = 2
    prompt_using_features: bool = True
    num_mask_tokens: int = 3
    sam_head_depth: int = 2
    num_heads: int = 8
    mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    decoding_out_dim_factor: int = 8

    @property
    def num_video_tokens(self) -> int:
        t, h, w = self.image_embedding_size
        return t * h * w

    @property
    def decode_dims(self) -> Tuple[int, int]:
        """(d1, d2) of the two upscaling deconvs: (352, 176) at C = 1408."""
        d, f = self.embed_dim, self.decoding_out_dim_factor
        return (min(2 * d // f, d), d // f)


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """The SAM-style point-track head (l4p_tpu/models/track.py:46-82), with
    the released configs/model.yaml values as defaults."""

    task_name: str = "track_2d"
    image_size: Tuple[int, int, int] = (16, 224, 224)
    patch_size: Tuple[int, int, int] = (2, 14, 14)
    estimate_vis: bool = True
    estimate_depth: bool = True
    modify_pointlabels_for_windowing: bool = True
    prompt_using_features: bool = True
    attend_to_past: bool = True
    depth_fn: str = "exp"
    vis_fn: str = "linear"
    max_queries: int = 192  # the YAML schema's default; the released file sets none
    num_prompt_points: int = 2
    estimation_directions: Tuple[int, ...] = (1,)
    sam: SamConfig = SamConfig()

    @property
    def token_ids(self) -> Dict[str, int]:
        """Decoder output token of each estimate (mask tokens first, then
        the prompts: points, padding point, prompt feature)."""
        ids = {"xy": 0}
        n = 1
        if self.estimate_vis:
            ids["vis"] = n
            n += 1
        if self.estimate_depth:
            ids["depth"] = n
            n += 1
        if self.prompt_using_features:
            ids["prompt_feat"] = n + self.num_prompt_points
        return ids

    @property
    def num_mask_tokens(self) -> int:
        return 1 + int(self.estimate_vis) + int(self.estimate_depth)


@dataclasses.dataclass(frozen=True)
class L4PConfig:
    encoder: EncoderConfig = GIANT
    window_size: Tuple[int, int, int] = (16, 224, 224)
    window_stride_t: int = 8
    joint_alignment: bool = True  # depth and camray stitched by one Sim(3) chain
    heads: Tuple[Tuple[str, DenseHeadConfig], ...] = tuple(default_dense_heads().items())
    track: Optional[TrackConfig] = TrackConfig()  # None: no track head
    enc_window_chunk: int = 2  # windows per encoder call (all of them with encoder.fused_encoder)
    dense_window_chunk: int = 2  # windows per DPT head call
    sim3_num_trials: int = 128  # RANSAC hypotheses of the joint alignment
    sim3_min_samples: int = 10
    # an encoder-only checkpoint that prepare_model overlays on random
    # weights (reference l4p_videomae.py:187-191; l4p_tpu/models/l4p.py:115)
    video_encoder_ckpt_path: Optional[str] = None

    @property
    def head_dict(self) -> Dict[str, DenseHeadConfig]:
        return dict(self.heads)

    @property
    def all_hooks(self) -> Tuple[int, ...]:
        hooks: List[int] = []
        for _, h in self.heads:
            for idx in h.dpt.hooks:
                if idx not in hooks:
                    hooks.append(idx)
        return tuple(sorted(hooks))


def _dense_head_from_yaml(name: str, cls: str, args: Mapping[str, Any]) -> DenseHeadConfig:
    """A dense head's init_args with the YAML schema's defaults
    (l4p_tpu/config.py:76-108): camray and camera_rays have 6 channels and
    camray's DPT variant; use_intrinsics on, fixed_intrinsics off unless the
    file says otherwise."""
    kind = DENSE_KINDS[cls]
    d = args.get("depth", 40)
    hooks = tuple(args.get("hooks_idx") or (d * 2 // 5, d * 3 // 5, d * 4 // 5, d))
    out_nchan = 6 if kind in ("camray", "camera_rays") else args.get("out_nchan", 2 if kind == "flow" else 1)
    dpt_kw: Dict[str, Any] = dict(num_channels=out_nchan, hooks=hooks)
    if "embed_dim" in args:
        dpt_kw["dim_tokens"] = args["embed_dim"]
    for ext in ("layer_dims", "feature_dim", "last_dim"):
        if ext in args:
            dpt_kw[ext] = tuple(args[ext]) if ext == "layer_dims" else args[ext]
    if kind in ("camray", "camera_rays"):
        dpt_kw.update(_CAMRAY_DPT_DEFAULTS)
        for k in ("actpost_scale_factors", "fusion_scale_factors"):
            if k in args:
                dpt_kw[k] = tuple(map(tuple, args[k]))
        if "output_size" in args:
            dpt_kw["output_size"] = tuple(args["output_size"])
    return DenseHeadConfig(
        task_name=args.get("task_name", name),
        kind=kind,
        out_nchan=out_nchan,
        dpt=DPTConfig(**dpt_kw),
        depth_fn=args.get("depth_fn", "linear"),
        mask_fn=args.get("apply_fn", "linear"),
        align_pre_inverse=args.get("align_window_overlap_fn") == "inverse",
        align_type=args.get("align_type", "affine"),
        use_intrinsics=args.get("use_intrinsics", True),
        fixed_intrinsics=args.get("fixed_intrinsics", False),
    )


def _track_from_yaml(args: Mapping[str, Any]) -> TrackConfig:
    """VideoMAETrack2DSamHead init_args -> TrackConfig, with the schema's
    defaults for absent keys (l4p_tpu/config.py:48-75), which are not the
    dataclass defaults: max_queries 192, estimation_directions [1, -1], and
    every estimate/prompt/memory switch off."""
    image_size = tuple(args.get("image_size", (16, 224, 224)))
    patch_size = tuple(args.get("patch_size", (2, 14, 14)))
    sam = SamConfig(
        embed_dim=args.get("prompt_embed_dim", 1408),
        image_embedding_size=tuple(image_size[i] // patch_size[i] for i in range(3)),
        input_image_size=image_size,
        num_point_embeddings=args.get("num_point_embeddings", 2),
        prompt_using_features=args.get("prompt_using_features", False),
        num_mask_tokens=1 + int(args.get("estimate_vis", False)) + int(args.get("estimate_depth", False)),
        sam_head_depth=args.get("sam_head_depth", 2),
    )
    return TrackConfig(
        task_name=args.get("task_name", "track_2d"),
        image_size=image_size,
        patch_size=patch_size,
        estimate_vis=args.get("estimate_vis", False),
        estimate_depth=args.get("estimate_depth", False),
        modify_pointlabels_for_windowing=args.get("modify_pointlabels_for_windowing", False),
        prompt_using_features=args.get("prompt_using_features", False),
        attend_to_past=args.get("attend_to_past", False),
        depth_fn=args.get("depth_fn", "linear"),
        vis_fn=args.get("vis_fn", "linear"),
        max_queries=args.get("max_queries", 192),
        estimation_directions=tuple(args.get("estimation_directions", [1, -1])),
        sam=sam,
    )


def _encoder_from_yaml(args: Mapping[str, Any]) -> EncoderConfig:
    """The `encoder:` mapping -> EncoderConfig, as the JAX reader's
    `EncoderConfig(**m["encoder"])` (l4p_tpu/config.py:133-135) minus the
    XLA-only keys; any other key the port does not know raises ValueError
    naming it."""
    known = {f.name for f in dataclasses.fields(EncoderConfig)}
    unknown = sorted(set(args) - known - XLA_ONLY_ENCODER_KEYS)
    if unknown:
        raise ValueError(f"unknown encoder key(s) {unknown}; the encoder takes {sorted(known)}")
    return EncoderConfig(**{k: v for k, v in args.items() if k in known})


def load_model_config(path: str) -> Tuple[L4PConfig, Tuple[str, ...]]:
    """Parse a reference-schema model YAML into (L4PConfig, tasks).

    The flow, depth, dyn_mask, camray, camera_rays and track_2d heads are
    read, and `tasks` is returned as written (InferenceSession refuses the
    tasks it cannot run). A file with no track_2d head gives `track=None`.
    An unknown head class raises ValueError, as the JAX reader does."""
    import yaml

    with open(path) as f:
        tree = yaml.safe_load(f)
    init = tree["init_args"]
    m = init["l4p_model"]["init_args"]
    heads = []
    track = None
    for name, node in m["task_heads"]["init_args"]["modules"].items():
        cls = node["class_path"].rsplit(".", 1)[-1]
        args = dict(node.get("init_args", {}))
        if cls in DENSE_KINDS:
            heads.append((name, _dense_head_from_yaml(name, cls, args)))
        elif cls == "VideoMAETrack2DSamHead":
            track = _track_from_yaml(args)
        else:
            raise ValueError(f"unknown head class {cls}")
    enc = _encoder_from_yaml(m["encoder"] or {}) if "encoder" in m else GIANT
    cfg = L4PConfig(
        encoder=enc,
        window_size=tuple(m.get("window_size", (16, 224, 224))),
        window_stride_t=m.get("window_stride_T", 8),
        joint_alignment=m.get("joint_alignment", False),
        heads=tuple(heads),
        track=track,
        video_encoder_ckpt_path=m.get("video_encoder_ckpt_path"),
    )
    return cfg, tuple(init["tasks"])
