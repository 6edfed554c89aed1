"""asltpu_torch — the PyTorch/CUDA port of ``asltpu`` for an NVIDIA H100.

It sits beside the JAX package and imports nothing of it (nor JAX). The
layout mirrors ``asltpu/``, so each module's counterpart is at the same
path:

  - :mod:`asltpu_torch.api`     — ``load_model``, ``load_clip``, ``predict``,
    ``stream_predict``.
  - :mod:`asltpu_torch.config`  — the five configs, field for field, and
    the port's own ``timesformer``, ``video_swin`` and ``mvit_v2``.
  - :mod:`asltpu_torch.models`  — MobileNetV2 + GRU head (``mobilenet_gru``),
    ResNet-18 + transformer head (``resnet_transformer``), the landmark
    BiLSTM (``pose_bilstm``), I3D (``i3d``), the RGB + landmark
    cross-attention fusion (``two_stream``), TimeSformer-HR
    (``timesformer``), Video Swin-B (``video_swin``), MViTv2-B
    (``mvit_v2``).
  - :mod:`asltpu_torch.ops`     — preprocess (plain PyTorch and the
    hand-written CUDA kernels of ``csrc/``), the GRU and LSTM layers, I3D's
    stem conv in its plain and space-to-depth forms, fused attention.
  - :mod:`asltpu_torch.data`    — host decode, WLASL clip records,
    landmarks, padding, prefetch to the card, synthetic fixtures.
  - :mod:`asltpu_torch.native`  — the native (C++, g++) batch decoders,
    OpenCV and libav, bound with ctypes.
  - :mod:`asltpu_torch.ckpt`    — weights from the JAX package or ``.pt``.
  - :mod:`asltpu_torch.train`   — the training loop.
  - :mod:`asltpu_torch.dist`    — data and tensor parallelism over
    ``torch.distributed`` process groups, and multi-process bring-up.
  - :mod:`asltpu_torch.utils`   — logging, per-step metrics, profiling.
  - :mod:`asltpu_torch.serve`, :mod:`asltpu_torch.serve_http` — the
    dynamic-batching server and its HTTP front end.
  - :mod:`asltpu_torch.windows` — continuous-video recognition by sliding
    windows.
  - :mod:`asltpu_torch.export`  — the inference program exported with
    ``torch.export`` (the CUDA preprocess kernel inside), loaded with no
    model code.
  - :mod:`asltpu_torch.cli`     — ``python -m asltpu_torch.cli predict |
    serve | train | eval | export | landmarks | bench``.
  - :mod:`asltpu_torch.benchmark` — the port's bench
    (``python -m asltpu_torch.benchmark``).

Importing the package loads no CUDA code and needs no nvcc or g++: the
kernels and the native decoders are built on first use.
"""

__version__ = "0.1.0"

from asltpu_torch.config import (  # noqa: F401
    PreprocessConfig,
    PoseBiLSTMConfig,
    MobileNetV2GRUConfig,
    ResNet18TransformerConfig,
    I3DConfig,
    TwoStreamFusionConfig,
    TimeSformerConfig,
    VideoSwinConfig,
    MViTv2Config,
    get_config,
    CONFIG_REGISTRY,
)
