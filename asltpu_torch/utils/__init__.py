"""asltpu_torch.utils — logging, per-step metrics and profiling.
Counterpart of ``asltpu/utils/``."""

from asltpu_torch.utils.logging import MetricsWriter, get_logger  # noqa: F401
from asltpu_torch.utils.profiling import named_scope, trace  # noqa: F401
