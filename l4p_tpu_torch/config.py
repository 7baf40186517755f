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

    @property
    def block(self) -> "BlockConfig":
        return BlockConfig(self.embed_dim, self.num_heads, self.mlp_ratio, self.ln_eps, self.init_values,
                           self.cos_attn)


GIANT = EncoderConfig()


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One pre-LN transformer block (models/encoder.py `Block`): the video
    encoder's (`EncoderConfig.block`) or VGGT's (`VGGTConfig`), which has a
    bias on each of q, k and v (`qkv_bias`, where VideoMAE has q and v
    biases only), exact GELU in every dtype (`exact_gelu`) and LayerNorm on
    q and k over the head dim (`qk_norm`)."""

    embed_dim: int
    num_heads: int
    mlp_ratio: float
    ln_eps: float
    init_values: float = 0.0  # LayerScale gains when > 0
    cos_attn: bool = False
    qkv_bias: bool = False
    exact_gelu: bool = False
    qk_norm: bool = False

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

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
    # what training leaves frozen (reference l4p_videomae.py:199-218;
    # train.trainable_mask): the whole encoder, except the listed blocks and
    # the final norm when unfreeze_blocks is not None (an empty tuple
    # unfreezes the norm alone); and the named task heads
    freeze_video_encoder: bool = False
    unfreeze_blocks: Optional[Tuple[int, ...]] = None
    freeze_heads: Tuple[str, ...] = ()

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


VGGT_CLASS = "vggt.models.vggt.VGGT"
VGGT_TASKS = ("camera", "depth", "world_points")


@dataclasses.dataclass(frozen=True)
class DINOv2Config:
    """A DINOv2 ViT run whole once per frame (models/dinov2.py), as VGGT's
    patch embedder and Video Depth Anything's encoder build it. Its position
    table covers an img_size / patch_size square grid; a frame's grid gets
    it resized bicubically: to the grid's size where `interpolate_offset` is
    0 (DINOv2 with registers), else by the scale factor (grid +
    interpolate_offset) / side (Depth Anything V2's dinov2.py), with
    `interpolate_antialias` in either case."""

    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 0
    ln_eps: float = 1e-6
    init_values: float = 1.0  # LayerScale's init
    interpolate_offset: float = 0.0
    interpolate_antialias: bool = False

    @property
    def block(self) -> BlockConfig:
        """DINOv2's block: q, k and v biases, exact GELU, LayerScale."""
        return BlockConfig(self.embed_dim, self.num_heads, self.mlp_ratio, self.ln_eps, self.init_values,
                           qkv_bias=True, exact_gelu=True)


@dataclasses.dataclass(frozen=True)
class VGGTConfig:
    """VGGT (facebookresearch/vggt, vggt/models/vggt.py): the defaults are
    VGGT-1B's published settings, which upstream's constructors hard-code;
    the LayerNorm epsilons are nn.LayerNorm's default where upstream passes
    none (the aggregator's blocks, their q/k norms, the camera head's and
    the DPT heads' token norms) and DINOv2's 1e-6 in the patch embedder. The
    track head is not built (models/vggt.py)."""

    img_size: int = 518  # the DINOv2 position table's side: img_size / patch_size positions a side
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24  # frame blocks, and as many global blocks
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    qk_norm: bool = True
    rope_freq: float = 100.0
    init_values: float = 0.01
    ln_eps: float = 1e-5
    # the patch embedder, DINOv2 ViT-L/14 with registers
    embed_depth: int = 24
    embed_num_heads: int = 16
    embed_ln_eps: float = 1e-6
    embed_init_values: float = 1.0
    # the camera head on 2 * embed_dim
    camera_trunk_depth: int = 4
    camera_num_heads: int = 16
    camera_iterations: int = 4
    # the depth and point DPT heads on 2 * embed_dim
    dpt_features: int = 256
    dpt_out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    dpt_layers: Tuple[int, ...] = (4, 11, 17, 23)  # the aggregator outputs the heads read
    frames_chunk_size: int = 8

    def block(self, dim: int, heads: int, eps: float, init_values: float, qk_norm: bool = False) -> BlockConfig:
        """A VGGT block of width `dim` (DINOv2's: q, k and v biases, exact GELU)."""
        return BlockConfig(dim, heads, self.mlp_ratio, eps, init_values, qkv_bias=True, exact_gelu=True,
                           qk_norm=qk_norm)

    @property
    def embed_block(self) -> BlockConfig:
        return self.dinov2.block

    @property
    def dinov2(self) -> DINOv2Config:
        """The patch embedder: dinov2_vitl14_reg, its positions resized to the grid's size, antialiased."""
        return DINOv2Config(self.img_size, self.patch_size, self.embed_dim, self.embed_depth, self.embed_num_heads,
                            self.mlp_ratio, self.num_register_tokens, self.embed_ln_eps, self.embed_init_values,
                            interpolate_offset=0.0, interpolate_antialias=True)

    @property
    def aggregator_block(self) -> BlockConfig:
        return self.block(self.embed_dim, self.num_heads, self.ln_eps, self.init_values, self.qk_norm)

    @property
    def camera_block(self) -> BlockConfig:
        return self.block(2 * self.embed_dim, self.camera_num_heads, self.ln_eps, self.init_values)

    @property
    def patch_start(self) -> int:
        return 1 + self.num_register_tokens  # the camera token and the registers come first in every frame


# what the port builds of VGGT: each key of a file's group that must hold this value
_VGGT_FIXED = {
    "init_args": {"enable_camera": True, "enable_depth": True, "enable_point": True, "enable_track": False},
    "aggregator": {"qkv_bias": True, "proj_bias": True, "ffn_bias": True, "patch_embed": "dinov2_vitl14_reg",
                   "aa_order": ["frame", "global"], "aa_block_size": 1},
    "camera_head": {"pose_encoding_type": "absT_quaR_FoV", "trans_act": "linear", "quat_act": "linear",
                    "fl_act": "relu"},
    "depth_head": {"output_dim": 2, "activation": "exp", "conf_activation": "expp1", "pos_embed": True},
    "point_head": {"output_dim": 4, "activation": "inv_log", "conf_activation": "expp1", "pos_embed": True},
}


def vggt_config_from_tree(tree: Mapping[str, Any]) -> VGGTConfig:
    """A VGGT configuration file (VGGT's constructor arguments under
    `init_args`, the aggregator's and each head's under their module names)
    -> VGGTConfig. A setting the port does not build raises ValueError."""
    init, agg, cam = tree.get("init_args", {}), tree.get("aggregator", {}), tree.get("camera_head", {})
    dpt = tree.get("depth_head", {})
    for group, fixed in _VGGT_FIXED.items():
        for k, v in fixed.items():
            if k in tree.get(group, {}) and tree[group][k] != v:
                raise ValueError(f"{group}.{k} = {tree[group][k]!r}: the port builds {v!r} only")
    if "enable_track" not in init:
        raise ValueError("init_args.enable_track: upstream builds the track head by default, the port does not")
    for k in ("features", "out_channels", "intermediate_layer_idx", "frames_chunk_size"):
        if dpt.get(k) != tree.get("point_head", {}).get(k):
            raise ValueError(f"depth_head.{k} differs from point_head's: the port builds the two trunks alike")
    e = init.get("embed_dim", 1024)
    for group in ("camera_head", "depth_head", "point_head"):
        if tree.get(group, {}).get("dim_in", 2 * e) != 2 * e:
            raise ValueError(f"{group}.dim_in must be 2 * embed_dim = {2 * e}")
    eps = tree.get("layer_norm_eps", {})
    return VGGTConfig(
        img_size=init.get("img_size", 518), patch_size=init.get("patch_size", 14), embed_dim=e,
        depth=agg.get("depth", 24), num_heads=agg.get("num_heads", 16), mlp_ratio=float(agg.get("mlp_ratio", 4.0)),
        num_register_tokens=agg.get("num_register_tokens", 4), qk_norm=agg.get("qk_norm", True),
        rope_freq=float(agg.get("rope_freq", 100)), init_values=float(agg.get("init_values", 0.01)),
        ln_eps=float(eps.get("default", 1e-5)), embed_depth=agg.get("embed_depth", 24),
        embed_num_heads=agg.get("embed_num_heads", 16), embed_ln_eps=float(eps.get("patch_embed", 1e-6)),
        embed_init_values=float(agg.get("embed_init_values", 1.0)),
        camera_trunk_depth=cam.get("trunk_depth", 4), camera_num_heads=cam.get("num_heads", 16),
        camera_iterations=cam.get("num_iterations", 4), dpt_features=dpt.get("features", 256),
        dpt_out_channels=tuple(dpt.get("out_channels", (256, 512, 1024, 1024))),
        dpt_layers=tuple(dpt.get("intermediate_layer_idx", (4, 11, 17, 23))),
        frames_chunk_size=dpt.get("frames_chunk_size", 8))


VDA_CLASS = "video_depth_anything.video_depth.VideoDepthAnything"
VDA_TASKS = ("depth",)


@dataclasses.dataclass(frozen=True)
class VDAConfig:
    """Video Depth Anything (DepthAnything/Video-Depth-Anything,
    video_depth_anything/video_depth.py): the defaults are the Large
    model's published settings, which upstream's constructors hard-code.
    The encoder is Depth Anything V2's vit_large, without registers, its
    positions resized by scale factor with the 0.1 offset and no antialias;
    the head is DPTHeadTemporal with four motion modules (TemporalModule:
    one transformer block of two temporal attentions and a GEGLU
    feed-forward). infer_video_depth's windowing and stitch constants and
    the head's tail chunk are upstream's hard-coded values, module constants
    of models/vda.py."""

    encoder: DINOv2Config = DINOv2Config(interpolate_offset=0.1)
    intermediate_layers: Tuple[int, ...] = (4, 11, 17, 23)
    features: int = 256
    out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    num_frames: int = 32  # the motion modules' temporal_max_len, and infer_video_depth's INFER_LEN
    motion_heads: int = 8
    motion_groups: int = 32  # GroupNorm's groups
    motion_gn_eps: float = 1e-6
    motion_ln_eps: float = 1e-5  # nn.LayerNorm's default, where upstream passes none
    motion_attention_blocks: int = 2
    ff_mult: int = 4  # GEGLU: Linear(C, 2 * ff_mult * C), Linear(ff_mult * C, C)


# what the port builds of Video Depth Anything: each key of a file's group that must hold this value
_VDA_FIXED = {
    "init_args": {"encoder": "vitl", "use_bn": False, "use_clstoken": False, "pe": "ape"},
    "pretrained": {"ffn_layer": "mlp", "block_chunks": 0, "qkv_bias": True, "proj_bias": True, "ffn_bias": True},
    "motion_module": {"num_transformer_block": 1, "activation_fn": "geglu", "pos_embedding_type": "ape",
                      "cross_attention": False},
}


def vda_config_from_tree(tree: Mapping[str, Any]) -> VDAConfig:
    """A Video Depth Anything configuration file (the constructor's
    arguments under `init_args`, the encoder's under `pretrained`, the
    motion modules' under `motion_module`, infer_video_depth's constants
    under `infer_video_depth`, the head's tail chunk under `head`) ->
    VDAConfig. A setting the port does not build raises ValueError, and so
    does any infer_video_depth constant or tail chunk but upstream's, which
    models/vda.py hard-codes as upstream does."""
    from l4p_tpu_torch.models import vda

    upstream = {"infer_video_depth": {"INFER_LEN": vda.INFER_LEN, "OVERLAP": vda.OVERLAP,
                                      "KEYFRAMES": list(vda.KEYFRAMES), "INTERP_LEN": vda.INTERP_LEN},
                "head": {"micro_batch_size": vda.MICRO_BATCH}}
    for group, fixed in {**_VDA_FIXED, **upstream}.items():
        for k, v in fixed.items():
            if k in tree.get(group, {}) and tree[group][k] != v:
                raise ValueError(f"{group}.{k} = {tree[group][k]!r}: the port builds {v!r} only")
    init, enc, mm = tree.get("init_args", {}), tree.get("pretrained", {}), tree.get("motion_module", {})
    t = init.get("num_frames", vda.INFER_LEN)
    if t != vda.INFER_LEN or mm.get("temporal_max_len", t) != t:
        raise ValueError(f"init_args.num_frames and motion_module.temporal_max_len must be INFER_LEN = {vda.INFER_LEN}")
    e = enc.get("embed_dim", 1024)
    heads = mm.get("num_attention_heads", 8)
    if e % heads or init.get("features", 256) % heads:
        raise ValueError(f"the motion modules' {heads} heads must divide their widths")
    encoder = DINOv2Config(
        img_size=enc.get("img_size", 518), patch_size=enc.get("patch_size", 14), embed_dim=e,
        depth=enc.get("depth", 24), num_heads=enc.get("num_heads", 16), mlp_ratio=float(enc.get("mlp_ratio", 4.0)),
        num_register_tokens=enc.get("num_register_tokens", 0), ln_eps=float(enc.get("layer_norm_eps", 1e-6)),
        init_values=float(enc.get("init_values", 1.0)), interpolate_offset=float(enc.get("interpolate_offset", 0.1)),
        interpolate_antialias=bool(enc.get("interpolate_antialias", False)))
    return VDAConfig(
        encoder=encoder, intermediate_layers=tuple(tree.get("intermediate_layer_idx", (4, 11, 17, 23))),
        features=init.get("features", 256), out_channels=tuple(init.get("out_channels", (256, 512, 1024, 1024))),
        num_frames=t, motion_heads=heads, motion_groups=mm.get("norm_num_groups", 32),
        motion_gn_eps=float(mm.get("group_norm_eps", 1e-6)), motion_ln_eps=float(mm.get("layer_norm_eps", 1e-5)),
        motion_attention_blocks=mm.get("num_attention_blocks", 2), ff_mult=mm.get("ff_mult", 4))


SAM2_CLASS = "sam2.modeling.sam2_base.SAM2Base"
SAM2_TASKS = ("masks",)


@dataclasses.dataclass(frozen=True)
class Sam2Config:
    """SAM 2.1 (facebookresearch/sam2, sam2/configs/sam2.1/sam2.1_hiera_l.yaml
    with the video predictor's overrides): the defaults are Hiera-L's
    published settings. The image encoder is Hiera (`embed_dim` and
    `num_heads` doubling at each of `stages`, 2x2 q-pooling at the first
    block of stages 2-4, windows of `window_spec`, global attention in
    `global_att_blocks`) with an FPN neck at `d_model`; memory attention is
    `memory_layers` layers of RoPE self- and cross-attention with one head
    of `d_model` over a bank of `num_maskmem` memories of width `mem_dim`
    and up to `max_obj_ptrs` object pointers; the decoder is SAM's two-way
    transformer with high-resolution skips and object scores. What upstream
    hard-codes (the decoder's depth, heads and MLP, the prompt encoder's
    mask channels) and the q-pooling at every stage change are
    models/sam2.py constants."""

    image_size: int = 1024
    embed_dim: int = 144
    num_heads: int = 2
    stages: Tuple[int, ...] = (2, 6, 36, 4)
    global_att_blocks: Tuple[int, ...] = (23, 33, 43)
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (7, 7)
    window_spec: Tuple[int, ...] = (8, 4, 16, 8)
    d_model: int = 256  # the neck's width, memory attention's and the decoder's
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    memory_layers: int = 4
    memory_ffn: int = 2048
    rope_theta: float = 10000.0
    mem_dim: int = 64
    num_maskmem: int = 7
    max_obj_ptrs: int = 16
    num_multimask_outputs: int = 3
    fuser_layers: int = 2
    fuser_kernel: int = 7
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    stability_delta: float = 0.05
    stability_thresh: float = 0.98
    multimask_max_pt_num: int = 1

    @property
    def channel_list(self) -> Tuple[int, ...]:
        """Hiera's stage widths, the last stage's first (the neck's backbone_channel_list)."""
        return tuple(self.embed_dim * 2 ** i for i in reversed(range(len(self.stages))))

    @property
    def feat_size(self) -> int:
        """The side of the top feature map that memory attention and the decoder read."""
        return self.image_size // 16


# what the port builds of SAM 2: each key of a file's group that must hold this value
_SAM2_FIXED = {
    "model": {"use_high_res_features_in_sam": True, "multimask_output_in_sam": True, "iou_prediction_use_sigmoid": True,
              "use_obj_ptrs_in_encoder": True, "add_tpos_enc_to_obj_ptrs": True, "proj_tpos_enc_in_obj_ptrs": True,
              "use_signed_tpos_enc_to_obj_ptrs": True, "only_obj_ptrs_in_the_past_for_eval": True,
              "pred_obj_scores": True, "pred_obj_scores_mlp": True, "fixed_no_obj_ptr": True,
              "multimask_output_for_tracking": True, "use_multimask_token_for_obj_ptr": True,
              "multimask_min_pt_num": 0, "use_mlp_for_obj_ptr_proj": True, "directly_add_no_mem_embed": True,
              "no_obj_embed_spatial": True, "use_mask_input_as_output_without_sam": True,
              "binarize_mask_from_pts_for_mem_enc": True, "fill_hole_area": 0, "non_overlap_masks_for_mem_enc": False,
              "memory_temporal_stride_for_eval": 1, "max_cond_frames_in_attn": -1, "soft_no_obj_ptr": False},
    "sam_mask_decoder_extra_args": {"dynamic_multimask_via_stability": True},
    "trunk": {"q_stride": [2, 2], "dim_mul": 2.0, "head_mul": 2.0},
    "neck": {"fpn_interp_model": "nearest", "fuse_type": "sum", "kernel_size": 1},
    "memory_attention": {"pos_enc_at_input": True, "activation": "relu", "pos_enc_at_attn": False,
                         "pos_enc_at_cross_attn_keys": True, "pos_enc_at_cross_attn_queries": False,
                         "self_num_heads": 1, "cross_num_heads": 1, "rope_k_repeat": True, "downsample_rate": 1},
    "memory_encoder": {"kernel_size": 3, "stride": 2, "padding": 1, "use_dwconv": True},
}


def sam2_config_from_tree(tree: Mapping[str, Any]) -> Sam2Config:
    """A SAM 2 configuration file (upstream's YAML flattened into groups:
    `model` for SAM2Base's arguments, `trunk`, `neck`, `memory_attention`,
    `memory_encoder`, `sam_mask_decoder_extra_args`) -> Sam2Config. A
    setting the port does not build raises ValueError."""
    for group, fixed in _SAM2_FIXED.items():
        for k, v in fixed.items():
            if k in tree.get(group, {}) and tree[group][k] != v:
                raise ValueError(f"{group}.{k} = {tree[group][k]!r}: the port builds {v!r} only")
    m, tr, nk = tree.get("model", {}), tree.get("trunk", {}), tree.get("neck", {})
    ma, me = tree.get("memory_attention", {}), tree.get("memory_encoder", {})
    dx = tree.get("sam_mask_decoder_extra_args", {})
    d = Sam2Config()
    cfg = Sam2Config(
        image_size=m.get("image_size", d.image_size), embed_dim=tr.get("embed_dim", d.embed_dim),
        num_heads=tr.get("num_heads", d.num_heads), stages=tuple(tr.get("stages", d.stages)),
        global_att_blocks=tuple(tr.get("global_att_blocks", d.global_att_blocks)),
        window_pos_embed_bkg_spatial_size=tuple(tr.get("window_pos_embed_bkg_spatial_size",
                                                       d.window_pos_embed_bkg_spatial_size)),
        window_spec=tuple(tr.get("window_spec", d.window_spec)),
        d_model=nk.get("d_model", d.d_model), fpn_top_down_levels=tuple(nk.get("fpn_top_down_levels",
                                                                             d.fpn_top_down_levels)),
        memory_layers=ma.get("num_layers", d.memory_layers),
        memory_ffn=ma.get("dim_feedforward", d.memory_ffn), rope_theta=float(ma.get("rope_theta", d.rope_theta)),
        mem_dim=me.get("out_dim", d.mem_dim), num_maskmem=m.get("num_maskmem", d.num_maskmem),
        max_obj_ptrs=m.get("max_obj_ptrs_in_encoder", d.max_obj_ptrs),
        num_multimask_outputs=m.get("num_multimask_outputs", d.num_multimask_outputs),
        fuser_layers=me.get("fuser_num_layers", d.fuser_layers), fuser_kernel=me.get("fuser_kernel_size",
                                                                                     d.fuser_kernel),
        sigmoid_scale_for_mem_enc=float(m.get("sigmoid_scale_for_mem_enc", d.sigmoid_scale_for_mem_enc)),
        sigmoid_bias_for_mem_enc=float(m.get("sigmoid_bias_for_mem_enc", d.sigmoid_bias_for_mem_enc)),
        stability_delta=float(dx.get("dynamic_multimask_stability_delta", d.stability_delta)),
        stability_thresh=float(dx.get("dynamic_multimask_stability_thresh", d.stability_thresh)),
        multimask_max_pt_num=m.get("multimask_max_pt_num", d.multimask_max_pt_num))
    if len(cfg.stages) != 4 or m.get("scalp", 1) != 1 or tr.get("q_pool", 3) != 3:
        raise ValueError("the port builds four Hiera stages, q-pooling at the last three and scalp 1 only")
    if tuple(nk.get("backbone_channel_list", cfg.channel_list)) != cfg.channel_list:
        raise ValueError(f"neck.backbone_channel_list must be Hiera's stage widths {cfg.channel_list}")
    if cfg.d_model % cfg.mem_dim or cfg.image_size % 16:
        raise ValueError(f"mem_dim {cfg.mem_dim} must divide d_model {cfg.d_model}, and 16 the image size")
    tied = {("memory_attention", "d_model"): cfg.d_model, ("memory_attention", "kv_in_dim"): cfg.mem_dim,
            ("memory_attention", "feat_sizes"): [cfg.feat_size] * 2, ("memory_encoder", "fuser_dim"): cfg.d_model,
            ("neck", "position_encoding_num_pos_feats"): cfg.d_model,
            ("memory_encoder", "position_encoding_num_pos_feats"): cfg.mem_dim}
    for (group, k), v in tied.items():
        if k in tree.get(group, {}) and tree[group][k] != v:
            raise ValueError(f"{group}.{k} = {tree[group][k]!r}: the port ties it to {v!r}")
    return cfg


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


def load_model_config(path: str) -> Tuple[Any, Tuple[str, ...]]:
    """Parse a reference-schema model YAML into (L4PConfig, tasks), a VGGT
    configuration (`class_path` vggt.models.vggt.VGGT) into (VGGTConfig,
    tasks), a Video Depth Anything one (`VDA_CLASS`) into (VDAConfig,
    tasks), or a SAM 2 one (`SAM2_CLASS`) into (Sam2Config, tasks).

    The flow, depth, dyn_mask, camray, camera_rays and track_2d heads are
    read, and `tasks` is returned as written (InferenceSession refuses the
    tasks it cannot run). A file with no track_2d head gives `track=None`.
    An unknown head class raises ValueError, as the JAX reader does."""
    import yaml

    with open(path) as f:
        tree = yaml.safe_load(f)
    if tree.get("class_path") == VGGT_CLASS:
        return vggt_config_from_tree(tree), tuple(tree.get("tasks", VGGT_TASKS))
    if tree.get("class_path") == VDA_CLASS:
        return vda_config_from_tree(tree), tuple(tree.get("tasks", VDA_TASKS))
    if tree.get("class_path") == SAM2_CLASS:
        return sam2_config_from_tree(tree), tuple(tree.get("tasks", SAM2_TASKS))
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
    # None (every block frozen with the encoder) is not () (the final norm trains), as the JAX reader keeps them
    unfreeze, freeze_heads = m.get("unfreeze_blocks"), m.get("freeze_heads")
    cfg = L4PConfig(
        encoder=enc,
        window_size=tuple(m.get("window_size", (16, 224, 224))),
        window_stride_t=m.get("window_stride_T", 8),
        joint_alignment=m.get("joint_alignment", False),
        heads=tuple(heads),
        track=track,
        video_encoder_ckpt_path=m.get("video_encoder_ckpt_path"),
        freeze_video_encoder=m.get("freeze_video_encoder", False),
        unfreeze_blocks=tuple(unfreeze) if unfreeze is not None else None,
        freeze_heads=tuple(freeze_heads) if freeze_heads else (),
    )
    return cfg, tuple(init["tasks"])
