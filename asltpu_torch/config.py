"""Typed configuration dataclasses, one per capability config.

A field-for-field copy of ``asltpu/config.py`` (the five configs,
``PreprocessConfig``, ``TrainConfig`` and ``get_config``), so a config built
here compares equal, field by field, with the JAX package's, and three
families of the port's own, ``timesformer`` (:class:`TimeSformerConfig`),
``video_swin`` (:class:`VideoSwinConfig`) and ``mvit_v2``
(:class:`MViTv2Config`), which the JAX package does not have. Two things
differ:

- ``out_jnp_dtype``/``compute_jnp_dtype`` become
  ``out_torch_dtype``/``compute_torch_dtype``;
- ``PreprocessConfig.use_pallas`` keeps its name and selects the
  hand-written CUDA preprocess kernel (:mod:`asltpu_torch.ops.preprocess_kernels`)
  instead of a Pallas one.

This module imports no torch at import time: the decode workers import it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# ImageNet statistics, the standard normalization for all RGB backbones.
IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)

# MediaPipe Holistic layout: 33 pose + 468 face + 2×21 hands = 543 landmarks.
NUM_LANDMARKS = 543
LANDMARK_DIM = 3  # (x, y, z) normalized coordinates


def _torch_dtype(name: str):
    import torch

    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """The decode→tensor pipeline: uniform temporal sampling, bilinear
    resize, center-crop, mean-std normalize → NHWC."""

    num_frames: int = 16
    # Frames arrive from the host decoder at this staging resolution
    # (uint8 HWC). The device resizes so the short side is `resize_short`,
    # then center-crops to `crop`².
    staging_size: Tuple[int, int] = (256, 256)  # (H, W) of host-staged frames
    resize_short: int = 256
    crop: int = 224
    # Transfer-thin mode: the host decoder performs the short-side resize
    # (to `host_resize_short`) AND the center crop to `staging_size` before
    # transfer, so only crop²·T uint8 bytes cross host→device (the device
    # then only normalizes). 0 = off.
    host_resize_short: int = 0
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD
    out_dtype: str = "bfloat16"  # compute dtype the backbone consumes
    # On a CUDA tensor: the hand-written preprocess kernel (True) or the
    # plain PyTorch path (False). CPU tensors always take the plain path.
    use_pallas: bool = True
    # Wire format of staged frames. "yuv420" stages packed I420 planes
    # (1.5 bytes per pixel instead of 3) and the device performs the BT.601
    # YUV→RGB conversion. Requires height % 4 == 0 and even width.
    staging_format: str = "rgb"  # "rgb" | "yuv420"

    def __post_init__(self):
        if self.num_frames < 1:
            raise ValueError(
                f"num_frames must be >= 1; got {self.num_frames}"
            )

    @property
    def out_torch_dtype(self):
        return _torch_dtype(self.out_dtype)

    @property
    def staged_frame_shape(self) -> Tuple[int, ...]:
        """Per-frame staged shape on the wire: (Hs, Ws, 3) for RGB or the
        packed I420 plane layout (Hs·3/2, Ws) for yuv420."""
        hs, ws = self.staging_size
        if self.staging_format == "yuv420":
            # The packed 2D view stores each half-resolution chroma plane as
            # hs//4 full-width rows (two half-width chroma rows per packed
            # row), so the height must divide by 4.
            if hs % 4 or ws % 2:
                raise ValueError(
                    "yuv420 staging requires height % 4 == 0 and even width; "
                    f"got staging_size={self.staging_size}"
                )
            return (hs * 3 // 2, ws)
        return (hs, ws, 3)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "base"
    num_classes: int = 100
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def compute_torch_dtype(self):
        return _torch_dtype(self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class PoseBiLSTMConfig(ModelConfig):
    """Config #1: pose keypoints + 2-layer BiLSTM."""

    name: str = "pose_bilstm"
    num_classes: int = 100  # WLASL-100
    num_frames: int = 32
    num_landmarks: int = NUM_LANDMARKS
    landmark_dim: int = LANDMARK_DIM
    hidden_size: int = 256
    num_layers: int = 2
    dropout: float = 0.3
    # Recurrent heads run fp32: the loop over T amplifies bf16 error.
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MobileNetV2GRUConfig(ModelConfig):
    """Config #2: the north-star config, MobileNetV2 per frame + GRU head."""

    name: str = "mobilenet_gru"
    num_classes: int = 100  # WLASL-100
    num_frames: int = 16
    width_mult: float = 1.0
    feature_dim: int = 1280
    gru_hidden: int = 512
    gru_layers: int = 1
    dropout: float = 0.2
    preprocess: PreprocessConfig = PreprocessConfig(num_frames=16)


@dataclasses.dataclass(frozen=True)
class ResNet18TransformerConfig(ModelConfig):
    """Config #3: ResNet-18 + 4-layer transformer."""

    name: str = "resnet_transformer"
    num_classes: int = 300  # WLASL-300
    num_frames: int = 32
    feature_dim: int = 512
    d_model: int = 512
    num_heads: int = 8
    num_tx_layers: int = 4
    mlp_ratio: int = 4
    dropout: float = 0.1
    preprocess: PreprocessConfig = PreprocessConfig(num_frames=32)


@dataclasses.dataclass(frozen=True)
class I3DConfig(ModelConfig):
    """Config #4: I3D fine-tune on WLASL-2000."""

    name: str = "i3d"
    num_classes: int = 2000  # WLASL-2000
    num_frames: int = 64
    dropout: float = 0.5
    # Gradient checkpointing over Inception blocks for 64-frame memory.
    remat: bool = True
    preprocess: PreprocessConfig = PreprocessConfig(num_frames=64)


@dataclasses.dataclass(frozen=True)
class TwoStreamFusionConfig(ModelConfig):
    """Config #5: RGB+keypoint cross-attention fusion."""

    name: str = "two_stream"
    num_classes: int = 100
    num_frames: int = 16
    num_landmarks: int = NUM_LANDMARKS
    landmark_dim: int = LANDMARK_DIM
    d_model: int = 256
    num_heads: int = 8
    num_fusion_layers: int = 2
    dropout: float = 0.1
    # Width multiplier of the RGB-stream MobileNetV2 backbone.
    width_mult: float = 1.0
    preprocess: PreprocessConfig = PreprocessConfig(num_frames=16)


@dataclasses.dataclass(frozen=True)
class TimeSformerConfig(ModelConfig):
    """TimeSformer-HR (Bertasius et al., ICML 2021): ViT-B/16 with divided
    space-time attention over 16 frames of 448², fine-tuned on WLASL-2000.
    The port's own family: the JAX package has no counterpart."""

    name: str = "timesformer"
    num_classes: int = 2000  # WLASL-2000
    num_frames: int = 16
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    # Stochastic depth, linearly spaced over the blocks from 0 at block 0.
    drop_path_rate: float = 0.1
    preprocess: PreprocessConfig = PreprocessConfig(
        num_frames=16, staging_size=(512, 512), resize_short=512, crop=448)


@dataclasses.dataclass(frozen=True)
class VideoSwinConfig(ModelConfig):
    """Video Swin-B (Liu et al., CVPR 2022): 3D shifted-window attention
    with a learned relative-position bias over 32 frames of 224²,
    fine-tuned on WLASL-2000. The port's own family: the JAX package has
    no counterpart."""

    name: str = "video_swin"
    num_classes: int = 2000  # WLASL-2000
    num_frames: int = 32
    patch_size: Tuple[int, int, int] = (2, 4, 4)  # (T, H, W)
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: Tuple[int, int, int] = (8, 7, 7)
    mlp_ratio: int = 4
    # Stochastic depth, linearly spaced over all blocks from 0 at block 0.
    drop_path_rate: float = 0.3
    # Dropout before the classifier (the published I3DHead's).
    dropout: float = 0.5
    preprocess: PreprocessConfig = PreprocessConfig(num_frames=32)


# The q stride of each of MViTv2-B's 24 blocks, as SlowFast's
# ``POOL_Q_STRIDE`` lists them: [block, t, h, w].
_MVIT_B_POOL_Q_STRIDE = tuple((i, 1, 2, 2) if i in (2, 5, 21) else (i, 1, 1, 1)
                              for i in range(24))


@dataclasses.dataclass(frozen=True)
class MViTv2Config(ModelConfig):
    """MViTv2-B, 32×3 (Li et al., CVPR 2022; SlowFast's
    ``MVITv2_B_32x3.yaml``): pooling attention with a query-dependent
    decomposed relative-position bias and residual pooling over 32 frames
    of 224², fine-tuned on WLASL-2000. The port's own family: the JAX
    package has no counterpart. The lists keep SlowFast's layout:
    ``dim_mul`` / ``head_mul`` [block, multiplier] (width and heads change
    inside that block's attention), ``pool_q_stride`` [block, t, h, w] for
    every block."""

    name: str = "mvit_v2"
    num_classes: int = 2000  # WLASL-2000
    num_frames: int = 32
    patch_kernel: Tuple[int, int, int] = (3, 7, 7)  # (T, H, W)
    patch_stride: Tuple[int, int, int] = (2, 4, 4)
    patch_padding: Tuple[int, int, int] = (1, 3, 3)
    embed_dim: int = 96
    depth: int = 24
    num_heads: int = 1
    dim_mul: Tuple[Tuple[int, float], ...] = ((2, 2.0), (5, 2.0), (21, 2.0))
    head_mul: Tuple[Tuple[int, float], ...] = ((2, 2.0), (5, 2.0), (21, 2.0))
    pool_q_stride: Tuple[Tuple[int, int, int, int], ...] = _MVIT_B_POOL_Q_STRIDE
    pool_kvq_kernel: Tuple[int, int, int] = (3, 3, 3)
    # The k/v stride of block 0, divided by each q stride as the blocks pass.
    pool_kv_stride_adaptive: Tuple[int, int, int] = (1, 8, 8)
    mlp_ratio: int = 4
    # Stochastic depth, linearly spaced over the blocks from 0 at block 0.
    drop_path_rate: float = 0.3
    # Dropout before the classifier (the published TransformerBasicHead's).
    dropout: float = 0.5
    preprocess: PreprocessConfig = PreprocessConfig(num_frames=32)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters for the I3D fine-tune path."""

    batch_size: int = 8
    num_steps: int = 10_000
    learning_rate: float = 1e-3
    warmup_steps: int = 500
    weight_decay: float = 1e-4
    label_smoothing: float = 0.1
    grad_clip_norm: float = 1.0
    seed: int = 0
    log_every: int = 50
    eval_every: int = 1000
    ckpt_every: int = 1000
    ckpt_dir: str = "/tmp/asltpu_ckpt"
    ckpt_keep: int = 3
    # Besides the rolling last-``ckpt_keep`` step dirs, keep
    # ``ckpt_dir/best/`` = the checkpoint with the highest eval_top1.
    keep_best: bool = True
    # Fault injection for resume testing: raise at this step.
    fault_inject_step: int = -1


CONFIG_REGISTRY = {
    "pose_bilstm": PoseBiLSTMConfig,
    "mobilenet_gru": MobileNetV2GRUConfig,
    "resnet_transformer": ResNet18TransformerConfig,
    "i3d": I3DConfig,
    "two_stream": TwoStreamFusionConfig,
    "timesformer": TimeSformerConfig,
    "video_swin": VideoSwinConfig,
    "mvit_v2": MViTv2Config,
}


def get_config(name: str, **overrides) -> ModelConfig:
    """Build a config by registry name with field overrides.

    Nested ``preprocess`` overrides may be passed as a dict.
    """
    cls = CONFIG_REGISTRY[name]
    if "preprocess" in overrides and isinstance(overrides["preprocess"], dict):
        base_pp = cls().preprocess  # type: ignore[attr-defined]
        overrides["preprocess"] = dataclasses.replace(
            base_pp, **overrides["preprocess"]
        )
    if cls is TwoStreamFusionConfig:
        # The fusion model aligns landmarks to the clip's frame count
        # (preprocess.num_frames); the top-level num_frames mirrors it. A
        # one-sided override syncs the other side; a contradiction is
        # rejected here rather than as a shape error at serve time.
        if "num_frames" in overrides and "preprocess" not in overrides:
            overrides["preprocess"] = dataclasses.replace(
                cls().preprocess, num_frames=overrides["num_frames"]
            )
        pp_t = (
            overrides["preprocess"].num_frames
            if "preprocess" in overrides
            else cls().preprocess.num_frames
        )
        if "num_frames" in overrides and overrides["num_frames"] != pp_t:
            raise ValueError(
                f"two_stream num_frames={overrides['num_frames']} contradicts "
                f"preprocess.num_frames={pp_t}; the fusion clip and landmark "
                "frame counts are one value — set preprocess={'num_frames': N}"
            )
        overrides["num_frames"] = pp_t
    return cls(**overrides)
