"""Public API: ``load_model``, ``load_clip``, ``predict`` and
``stream_predict``. Counterpart of ``asltpu/api.py`` for the configs ported
so far: ``mobilenet_gru`` and ``resnet_transformer``.

Everything after host decode runs on the device: preprocess (a hand-written
CUDA kernel on the card), the per-frame backbone over the B·T frames
(MobileNetV2 or ResNet-18), the temporal head (GRU or transformer).
The entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise rather than quietly running on the CPU.

The JAX package's ``split_predict_fn``, ``raw_apply_fn`` and
``prefer_split`` work around a TPU host link and compose with ``jax.jit``;
eager PyTorch has no use for them, so they are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from asltpu_torch.config import (
    MobileNetV2GRUConfig,
    ModelConfig,
    PreprocessConfig,
    ResNet18TransformerConfig,
    get_config,
)
from asltpu_torch.data.decode import decode_clip, make_decode_pool
from asltpu_torch.data.prefetch import Prefetcher, resolve_device
from asltpu_torch.models.common import cast_for_compute, init_weights
from asltpu_torch.models.video import MobileNetV2GRU, ResNet18Transformer
from asltpu_torch.ops.preprocess import preprocess_clip


def gloss_label(idx, gloss_names=None):
    """Gloss id → display label, falling back to the integer id when the
    supplied name list is shorter than the model's class count."""
    i = int(idx)
    if gloss_names is not None and 0 <= i < len(gloss_names):
        return gloss_names[i]
    return i


def build_module(cfg: ModelConfig) -> nn.Module:
    """Config dataclass → ``nn.Module`` (fp32 parameters, on the CPU)."""
    if isinstance(cfg, MobileNetV2GRUConfig):
        return MobileNetV2GRU(
            num_classes=cfg.num_classes,
            width_mult=cfg.width_mult,
            gru_hidden=cfg.gru_hidden,
            gru_layers=cfg.gru_layers,
            dropout=cfg.dropout,
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
        )
    raise NotImplementedError(
        f"{cfg.name} is not ported yet (ROADMAP queue 1, items 7, 9, 10)"
    )


def fp32_modules(module: nn.Module) -> Tuple[nn.Module, ...]:
    """The parts of a built model that run fp32 under any compute dtype,
    besides its norms: the GRU head of ``mobilenet_gru`` (the recurrence
    amplifies low-precision error) and the transformer head's classifier,
    which reads the CLS output in fp32."""
    if isinstance(module, MobileNetV2GRU):
        return (module.gru, module.fc)
    return (module.head.fc,)


@dataclasses.dataclass
class Model:
    """A built model: config + module (weights on ``device``)."""

    cfg: ModelConfig
    module: nn.Module
    device: torch.device

    def predict_fn(self):
        """Staged uint8 frames on ``device`` ([B, T, Hs, Ws, 3] or packed
        I420 [B, T, Hs·3/2, Ws]) → logits [B, num_classes] fp32."""
        pp: PreprocessConfig = self.cfg.preprocess  # type: ignore[attr-defined]
        module = self.module

        def fn(frames_u8: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return module(preprocess_clip(frames_u8, pp))

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
    from a torchvision-layout ``.pt``/``.pth`` ``checkpoint``. Convs,
    linears and attention are cast to ``compute_dtype``
    (:func:`asltpu_torch.models.common.cast_for_compute`); every BatchNorm
    and LayerNorm keeps fp32 parameters and statistics, and so do the parts
    :func:`fp32_modules` names. The module is laid out channels_last.
    ``device`` defaults to the card.
    """
    dev = resolve_device(device)
    cfg = get_config(name, **overrides)
    module = build_module(cfg)
    init_weights(module, torch.Generator().manual_seed(seed))
    if checkpoint:
        if not checkpoint.endswith((".pt", ".pth")):
            raise NotImplementedError(
                "orbax checkpoints are not read by the port yet "
                "(ROADMAP queue 1, item 11); pass a .pt/.pth file"
            )
        from asltpu_torch import ckpt

        ckpt.load_torch_checkpoint(module, checkpoint)
    cast_for_compute(module, cfg.compute_torch_dtype, fp32_modules(module))
    module.to(device=dev, memory_format=torch.channels_last).eval()
    return Model(cfg=cfg, module=module, device=dev)


def load_clip(path: str, cfg: Optional[PreprocessConfig] = None) -> np.ndarray:
    """Decode + stage a video clip: path → uint8 [T, Hs, Ws, 3] (or packed
    I420 [T, Hs·3/2, Ws])."""
    return decode_clip(path, cfg or PreprocessConfig())


def predict(
    model: Model,
    clip: np.ndarray,
    gloss_names: Optional[Sequence[str]] = None,
) -> Tuple[Any, np.ndarray]:
    """Staged frames [T, ...] or [B, T, ...] → (gloss ids/names, logits)."""
    pp: PreprocessConfig = model.cfg.preprocess  # type: ignore[attr-defined]
    # Per-clip staged rank: T + frame dims (3 for RGB HWC, 2 for packed I420
    # planes); a batch carries one more leading axis.
    add_batch = clip.ndim != 2 + len(pp.staged_frame_shape)
    if add_batch:
        clip = clip[None]
    frames = torch.from_numpy(np.ascontiguousarray(clip)).to(model.device)
    logits = model.predict_fn()(frames).cpu().numpy()
    ids = logits.argmax(axis=-1)
    glosses: Any = ids
    if gloss_names is not None:
        glosses = [gloss_label(i, gloss_names) for i in ids]
    if add_batch:
        return (glosses[0], logits[0])
    return glosses, logits


def stream_predict(
    model: Model,
    paths: Sequence[str],
    batch_size: int = 8,
    num_decode_workers: int = 4,
    decode_backend: str = "auto",
    gloss_names: Optional[Sequence[str]] = None,
    prefetch_depth: int = 2,
    skip_errors: bool = False,
) -> Iterator[Tuple[str, Any, np.ndarray]]:
    """Batched streaming inference: decode workers → double-buffered
    prefetch to the device → predict; yields (path, gloss, logits) as
    batches complete. ``skip_errors=True`` drops undecodable clips."""
    pp: PreprocessConfig = model.cfg.preprocess  # type: ignore[attr-defined]
    fn = model.predict_fn()
    paths = list(paths)
    on_error = "skip" if skip_errors else "raise"
    pool = make_decode_pool(pp, num_workers=num_decode_workers,
                            backend=decode_backend)
    try:
        with Prefetcher(pool.map_batches(paths, batch_size, on_error),
                        depth=prefetch_depth, device=model.device) as pf:
            for frames, kept in pf:
                logits = fn(frames).cpu().numpy()[: len(kept)]
                ids = logits.argmax(axis=-1)
                for j, k in enumerate(kept):
                    yield paths[k], gloss_label(ids[j], gloss_names), logits[j]
    finally:
        pool.shutdown()
