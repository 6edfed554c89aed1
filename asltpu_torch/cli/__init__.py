"""asltpu_torch.cli — command-line entry points (``python -m asltpu_torch.cli ...``)."""

from asltpu_torch.cli.main import main  # noqa: F401
