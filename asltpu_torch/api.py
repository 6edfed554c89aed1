"""Public API: ``load_model``, ``load_clip``, ``predict`` and
``stream_predict``. Counterpart of ``asltpu/api.py`` for the five configs:
``pose_bilstm``, ``mobilenet_gru``, ``resnet_transformer``, ``i3d`` and
``two_stream``; and the port's own sixth to eighth, ``timesformer``
(TimeSformer-HR), ``video_swin`` (Video Swin-B) and ``mvit_v2`` (MViTv2-B).

For the RGB models everything after host decode runs on the device:
preprocess (a hand-written CUDA kernel on the card), then the per-frame
backbone over the B·T frames (MobileNetV2 or ResNet-18) and the temporal
head (GRU or transformer), or I3D's 3D network, TimeSformer's divided
space–time attention, Video Swin's 3D shifted windows or MViTv2's pooling
attention over the whole clip.
``pose_bilstm`` takes landmarks [T, 543, 3] instead of frames; it
normalises them and runs its BiLSTM on the device. ``two_stream`` takes
both: frames through MobileNetV2, landmarks of the same T, and
cross-attention between the two.
The entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise rather than quietly running on the CPU.

Training: :func:`build_trainable` builds a model to train (fp32 master
parameters, computing in the config's dtype) for
:mod:`asltpu_torch.train.loop`, and ``load_model(name, checkpoint=<dir>)``
reads back the port's training checkpoints (:mod:`asltpu_torch.ckpt`).

The JAX package's ``split_predict_fn``, ``raw_apply_fn`` and
``prefer_split`` work around a TPU host link and compose with ``jax.jit``;
eager PyTorch has no use for them, so they are not ported.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from asltpu_torch import native
from asltpu_torch.config import (
    I3DConfig,
    MobileNetV2GRUConfig,
    ModelConfig,
    MViTv2Config,
    PoseBiLSTMConfig,
    PreprocessConfig,
    ResNet18TransformerConfig,
    TimeSformerConfig,
    TwoStreamFusionConfig,
    VideoSwinConfig,
    get_config,
)
from asltpu_torch.data.decode import decode_clip, make_decode_pool
from asltpu_torch.data.pad import pad_to_batch
from asltpu_torch.data.prefetch import Prefetcher, resolve_device
from asltpu_torch.data.wlasl import gloss_label  # noqa: F401  (part of the API)
from asltpu_torch.models.bilstm import PoseBiLSTM
from asltpu_torch.models.common import cast_for_compute, init_weights
from asltpu_torch.models.fusion import TwoStreamFusion
from asltpu_torch.models.i3d import I3D
from asltpu_torch.models.mvit import MViT
from asltpu_torch.models.timesformer import TimeSformer
from asltpu_torch.models.video import MobileNetV2GRU, ResNet18Transformer
from asltpu_torch.models.video_swin import VideoSwin
from asltpu_torch.ops.preprocess import preprocess_clip
from asltpu_torch.utils import profiling

_log = logging.getLogger("asltpu_torch.stream")


def build_module(cfg: ModelConfig) -> nn.Module:
    """Config dataclass → ``nn.Module`` (fp32 parameters, on the CPU)."""
    if isinstance(cfg, MobileNetV2GRUConfig):
        return MobileNetV2GRU(
            num_classes=cfg.num_classes,
            width_mult=cfg.width_mult,
            gru_hidden=cfg.gru_hidden,
            gru_layers=cfg.gru_layers,
            dropout=cfg.dropout,
            dtype=cfg.compute_torch_dtype,
        )
    if isinstance(cfg, ResNet18TransformerConfig):
        return ResNet18Transformer(
            num_classes=cfg.num_classes,
            num_frames=cfg.preprocess.num_frames,
            d_model=cfg.d_model,
            num_heads=cfg.num_heads,
            num_tx_layers=cfg.num_tx_layers,
            mlp_ratio=cfg.mlp_ratio,
            dropout=cfg.dropout,
            dtype=cfg.compute_torch_dtype,
        )
    if isinstance(cfg, PoseBiLSTMConfig):
        return PoseBiLSTM(
            num_classes=cfg.num_classes,
            hidden=cfg.hidden_size,
            num_layers=cfg.num_layers,
            dropout=cfg.dropout,
            num_landmarks=cfg.num_landmarks,
            landmark_dim=cfg.landmark_dim,
        )
    if isinstance(cfg, I3DConfig):
        return I3D(num_classes=cfg.num_classes, dropout=cfg.dropout, remat=cfg.remat,
                   dtype=cfg.compute_torch_dtype)
    if isinstance(cfg, TwoStreamFusionConfig):
        return TwoStreamFusion(
            num_classes=cfg.num_classes,
            num_frames=cfg.num_frames,
            d_model=cfg.d_model,
            num_heads=cfg.num_heads,
            num_fusion_layers=cfg.num_fusion_layers,
            dropout=cfg.dropout,
            width_mult=cfg.width_mult,
            num_landmarks=cfg.num_landmarks,
            landmark_dim=cfg.landmark_dim,
            dtype=cfg.compute_torch_dtype,
        )
    if isinstance(cfg, TimeSformerConfig):
        return TimeSformer(
            num_classes=cfg.num_classes,
            num_frames=cfg.num_frames,
            img_size=cfg.preprocess.crop,
            patch_size=cfg.patch_size,
            embed_dim=cfg.embed_dim,
            depth=cfg.depth,
            num_heads=cfg.num_heads,
            mlp_ratio=cfg.mlp_ratio,
            drop_path_rate=cfg.drop_path_rate,
            dtype=cfg.compute_torch_dtype,
        )
    if isinstance(cfg, VideoSwinConfig):
        return VideoSwin(
            num_classes=cfg.num_classes,
            patch_size=cfg.patch_size,
            embed_dim=cfg.embed_dim,
            depths=cfg.depths,
            num_heads=cfg.num_heads,
            window_size=cfg.window_size,
            mlp_ratio=cfg.mlp_ratio,
            drop_path_rate=cfg.drop_path_rate,
            dropout=cfg.dropout,
            dtype=cfg.compute_torch_dtype,
        )
    if isinstance(cfg, MViTv2Config):
        return MViT(
            num_classes=cfg.num_classes,
            num_frames=cfg.num_frames,
            img_size=cfg.preprocess.crop,
            patch_kernel=cfg.patch_kernel,
            patch_stride=cfg.patch_stride,
            patch_padding=cfg.patch_padding,
            embed_dim=cfg.embed_dim,
            depth=cfg.depth,
            num_heads=cfg.num_heads,
            dim_mul=cfg.dim_mul,
            head_mul=cfg.head_mul,
            pool_q_stride=cfg.pool_q_stride,
            pool_kvq_kernel=cfg.pool_kvq_kernel,
            pool_kv_stride_adaptive=cfg.pool_kv_stride_adaptive,
            mlp_ratio=cfg.mlp_ratio,
            drop_path_rate=cfg.drop_path_rate,
            dropout=cfg.dropout,
            dtype=cfg.compute_torch_dtype,
        )
    raise ValueError(f"no model for config {type(cfg).__name__}")


def fp32_modules(module: nn.Module) -> Tuple[nn.Module, ...]:
    """The parts of a built model that run fp32 under any compute dtype,
    besides its norms: the GRU head of ``mobilenet_gru`` (the recurrence
    amplifies low-precision error); the classifiers that read a pooled
    output in fp32 (the transformer head's and the fusion model's ``fc``,
    I3D's ``logits``, TimeSformer's, Video Swin's and MViT's ``head``); all of
    ``pose_bilstm``, as the JAX package computes it. The transformers'
    LayerNorms stay fp32 as every norm does."""
    if isinstance(module, PoseBiLSTM):
        return (module,)
    if isinstance(module, MobileNetV2GRU):
        return (module.gru, module.fc)
    if isinstance(module, I3D):
        return (module.logits,)
    if isinstance(module, TwoStreamFusion):
        return (module.fc,)
    if isinstance(module, (TimeSformer, VideoSwin, MViT)):
        return (module.head,)
    return (module.head.fc,)


def to_channels_last(module: nn.Module) -> nn.Module:
    """Lay every 4D parameter out ``channels_last`` and every 5D one
    ``channels_last_3d``, in place (``Module.to(memory_format=...)`` takes
    one format and raises on a rank it does not fit)."""
    formats = {4: torch.channels_last, 5: torch.channels_last_3d}
    for p in module.parameters():
        if p.dim() in formats:
            p.data = p.data.contiguous(memory_format=formats[p.dim()])
    return module


@dataclasses.dataclass
class Model:
    """A built model: config + module (weights on ``device``)."""

    cfg: ModelConfig
    module: nn.Module
    device: torch.device

    @property
    def takes_rgb(self) -> bool:
        return not isinstance(self.cfg, PoseBiLSTMConfig)

    @property
    def takes_landmarks(self) -> bool:
        return isinstance(self.cfg, (PoseBiLSTMConfig, TwoStreamFusionConfig))

    def predict_fn(self) -> Callable[..., torch.Tensor]:
        """Inputs on ``device`` → logits [B, num_classes] fp32. The input is
        staged uint8 frames ([B, T, Hs, Ws, 3] or packed I420
        [B, T, Hs·3/2, Ws]); for ``pose_bilstm`` landmarks [B, T, 543, 3];
        for ``two_stream`` frames and landmarks, ``fn(frames_u8,
        landmarks)``."""
        module = self.module
        if not self.takes_rgb:
            def pose_fn(landmarks: torch.Tensor) -> torch.Tensor:
                with torch.inference_mode():
                    return module(landmarks)

            return pose_fn
        pp: PreprocessConfig = self.cfg.preprocess  # type: ignore[attr-defined]

        def fn(frames_u8: torch.Tensor, *landmarks: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return module(preprocess_clip(frames_u8, pp), *landmarks)

        return fn


def load_model(
    name: str,
    checkpoint: Optional[str] = None,
    seed: int = 0,
    device: Union[None, str, torch.device] = None,
    **overrides,
) -> Model:
    """Build (and optionally restore) a model by config name.

    Weights are random from ``torch.Generator().manual_seed(seed)``, or read
    from a torchvision-layout ``.pt``/``.pth`` ``checkpoint``, or from a
    port training checkpoint directory (a step dir, a ``ckpt_dir`` for its
    newest step, or its ``best/``; the JAX package's orbax directories are
    not read). Convs,
    linears and attention are cast to ``compute_dtype``
    (:func:`asltpu_torch.models.common.cast_for_compute`); every BatchNorm
    and LayerNorm keeps fp32 parameters and statistics, and so do the parts
    :func:`fp32_modules` names (all of ``pose_bilstm``). The module is laid
    out channels_last (3D convs channels_last_3d). ``device`` defaults to
    the card.
    """
    dev = resolve_device(device)
    cfg = get_config(name, **overrides)
    module = build_module(cfg)
    init_weights(module, torch.Generator().manual_seed(seed))
    if checkpoint:
        from asltpu_torch import ckpt

        if checkpoint.endswith((".pt", ".pth")):
            ckpt.load_torch_checkpoint(module, checkpoint)
        else:
            module.load_state_dict(ckpt.load_trained_state_dict(checkpoint))
    cast_for_compute(module, cfg.compute_torch_dtype, fp32_modules(module))
    to_channels_last(module.to(device=dev)).eval()
    return Model(cfg=cfg, module=module, device=dev)


# The families whose modules train: all eight.
TRAINABLE = (PoseBiLSTMConfig, MobileNetV2GRUConfig, ResNet18TransformerConfig, I3DConfig,
             TwoStreamFusionConfig, TimeSformerConfig, VideoSwinConfig, MViTv2Config)


def build_trainable(name: str, seed: int = 0,
                    device: Union[None, str, torch.device] = None, **overrides) -> Model:
    """A model to train: its module built from the config as
    :func:`load_model` builds it and initialised from ``seed``, with fp32
    parameters (the masters; the module computes in ``compute_dtype``),
    laid out channels_last, in train mode, on ``device`` (the card by
    default). Counterpart of the JAX package's ``build_module`` +
    ``create_train_state`` pair; pass ``model.module`` to
    :func:`asltpu_torch.train.loop.create_train_state` or ``train``."""
    dev = resolve_device(device)
    cfg = get_config(name, **overrides)
    module = build_module(cfg)
    init_weights(module, torch.Generator().manual_seed(seed))
    to_channels_last(module.to(device=dev)).train()
    return Model(cfg=cfg, module=module, device=dev)


def load_clip(path: str, cfg: Optional[PreprocessConfig] = None) -> np.ndarray:
    """Decode + stage a video clip: path → uint8 [T, Hs, Ws, 3] (or packed
    I420 [T, Hs·3/2, Ws])."""
    return decode_clip(path, cfg or PreprocessConfig())


def predict(
    model: Model,
    clip: np.ndarray,
    landmarks: Optional[np.ndarray] = None,
    gloss_names: Optional[Sequence[str]] = None,
) -> Tuple[Any, np.ndarray]:
    """Staged frames [T, ...] or [B, T, ...] → (gloss ids/names, logits).
    For ``pose_bilstm`` ``clip`` is landmarks [T, 543, 3] or
    [B, T, 543, 3]. ``two_stream`` also needs ``landmarks`` of the clip's
    T ([T, 543, 3] or [B, T, 543, 3], batched as ``clip`` is)."""
    fusion = isinstance(model.cfg, TwoStreamFusionConfig)
    if fusion and landmarks is None:
        raise ValueError("two_stream model requires landmarks")
    if model.takes_rgb:
        pp: PreprocessConfig = model.cfg.preprocess  # type: ignore[attr-defined]
        # Per-clip staged rank: T + frame dims (3 for RGB HWC, 2 for packed
        # I420 planes); a batch carries one more leading axis.
        add_batch = clip.ndim != 2 + len(pp.staged_frame_shape)
    else:
        add_batch = clip.ndim != 4
        clip = clip.astype(np.float32, copy=False)
    inputs = [clip] + ([np.asarray(landmarks, np.float32)] if fusion else [])
    xs = [torch.from_numpy(np.ascontiguousarray(a[None] if add_batch else a)).to(model.device)
          for a in inputs]
    logits = model.predict_fn()(*xs).cpu().numpy()
    ids = logits.argmax(axis=-1)
    glosses: Any = ids
    if gloss_names is not None:
        glosses = [gloss_label(i, gloss_names) for i in ids]
    if add_batch:
        return (glosses[0], logits[0])
    return glosses, logits


def stream_predict(
    model: Model,
    paths: Sequence[Any],
    batch_size: int = 8,
    num_decode_workers: int = 4,
    decode_backend: str = "auto",
    decode_fast: bool = False,
    landmarks_for: Optional[Callable[[Any], np.ndarray]] = None,
    gloss_names: Optional[Sequence[str]] = None,
    prefetch_depth: int = 2,
    skip_errors: bool = False,
    yield_items: bool = False,
    decode_pool: Optional[Any] = None,
) -> Iterator[Tuple[Any, Any, np.ndarray]]:
    """Batched streaming inference: decode → double-buffered prefetch to the
    device → predict; yields (path, gloss, logits) as batches complete.

    Items are video paths or clip records
    (:class:`~asltpu_torch.data.wlasl.ClipRecord`: segment and signer box
    honoured); results carry the item's path, or the item itself with
    ``yield_items=True`` (two records of one video stay apart).

    ``landmarks_for``: callable path → landmarks [T, 543, 3], required by
    the landmark models (``pose_bilstm``, ``two_stream``); one marked
    ``takes_record = True`` receives the item instead of its path. The pose
    model decodes no video: its batches are the landmarks alone. The fusion
    model loads the landmarks of each decoded clip; under ``skip_errors`` a
    clip whose landmarks do not load is dropped from its batch. ``decode_fast=True`` (with
    ``decode_backend="av"``) turns on the av decoder's codec-level fast
    modes (``asltpu_torch.native.FAST_ALL``): pixels differ slightly from
    the exact decode. ``skip_errors=True`` drops clips that do not decode or
    whose landmarks do not load. ``decode_pool``: a pool from
    :func:`~asltpu_torch.data.decode.make_decode_pool` to decode with, in
    place of one made from ``num_decode_workers``, ``decode_backend`` and
    ``decode_fast``; it stays open (a caller streaming many corpora starts
    its workers once).
    """
    items = list(paths)
    paths = [it.path if hasattr(it, "path") else it for it in items]
    out_of = items if yield_items else paths
    if model.takes_landmarks and landmarks_for is None:
        raise ValueError(
            f"model '{type(model.cfg).__name__}' consumes landmarks: pass "
            "landmarks_for=<callable path -> [T,543,3]>"
        )
    fn = model.predict_fn()
    load_lm = _landmark_loader(items, paths, landmarks_for, skip_errors)

    def results(batches):
        with Prefetcher(batches, depth=prefetch_depth, device=model.device) as pf:
            for b, (*xs, kept) in enumerate(pf):
                with profiling.span("stream.predict", batch=b):
                    logits = fn(*xs).cpu().numpy()[: len(kept)]
                ids = logits.argmax(axis=-1)
                for j, k in enumerate(kept):
                    yield out_of[k], gloss_label(ids[j], gloss_names), logits[j]

    if not model.takes_rgb:
        yield from results(_landmark_batches(len(items), batch_size, load_lm))
        return

    pp: PreprocessConfig = model.cfg.preprocess  # type: ignore[attr-defined]
    if decode_fast and decode_backend != "av":
        raise ValueError(
            "decode_fast requires decode_backend='av' (codec-level fast modes "
            "live in the libavcodec backend)"
        )
    pool = decode_pool or make_decode_pool(
        pp, num_workers=num_decode_workers, backend=decode_backend,
        fast_flags=native.FAST_ALL if decode_fast else 0)
    batches = pool.map_batches(items, batch_size, "skip" if skip_errors else "raise")
    if model.takes_landmarks:
        batches = _with_landmarks(batches, load_lm)
    try:
        yield from results(batches)
    finally:
        if decode_pool is None:
            pool.shutdown()


def _landmark_loader(items, paths, landmarks_for, skip_errors):
    """index → landmarks [T, 543, 3] float32 from ``landmarks_for`` (the
    item or its path), or None where they do not load under
    ``skip_errors``."""
    takes_record = bool(getattr(landmarks_for, "takes_record", False))

    def load(k):
        try:
            lm = landmarks_for(items[k] if takes_record else paths[k])
        except Exception:
            if not skip_errors:
                raise
            _log.warning("skipping clip with unloadable landmarks: %s",
                         paths[k], exc_info=True)
            return None
        return np.asarray(lm, np.float32)

    return load


def _landmark_batches(n_items, batch_size, load_lm):
    """(landmarks [B, T, 543, 3] float32, kept indices) per batch of items;
    an item whose landmarks do not load is dropped and a batch with none
    left is skipped."""
    for i in range(0, n_items, batch_size):
        loaded = [(k, load_lm(k)) for k in range(i, min(i + batch_size, n_items))]
        loaded = [(k, lm) for k, lm in loaded if lm is not None]
        if loaded:
            yield (pad_to_batch(np.stack([lm for _, lm in loaded]), batch_size),
                   [k for k, _ in loaded])


def _with_landmarks(batches, load_lm):
    """(frames, kept) decoded batches → (frames, landmarks, kept): the
    landmarks of each kept clip; a clip whose landmarks do not load is
    dropped, and frames and landmarks are padded back to the batch."""
    for frames, kept in batches:
        loaded = [(row, k, load_lm(k)) for row, k in enumerate(kept)]
        loaded = [(row, k, lm) for row, k, lm in loaded if lm is not None]
        if not loaded:
            continue
        rows = [row for row, _, _ in loaded]
        batch = frames.shape[0]
        yield (pad_to_batch(frames[rows], batch),
               pad_to_batch(np.stack([lm for _, _, lm in loaded]), batch),
               [k for _, k, _ in loaded])
