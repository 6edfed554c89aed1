"""asltpu_torch.utils — logging and per-step metrics. Counterpart of
``asltpu/utils/`` without its profiling helpers."""

from asltpu_torch.utils.logging import MetricsWriter, get_logger  # noqa: F401
