"""The port's profiling helpers (``asltpu_torch.utils.profiling``), as
``tests/unit/test_utils.py::test_profiling_helpers`` holds the JAX
package's: ``trace()`` writes a profiler trace, ``named_scope`` names a
range inside it, and ``enable_nan_debugging`` turns autograd's anomaly
detection on and off."""

import json
import os

import pytest
import torch

from asltpu_torch.utils import named_scope, trace
from asltpu_torch.utils.profiling import enable_nan_debugging


def test_profiling_helpers(tmp_path):
    def f(x):
        with named_scope("double"):
            return x * 2

    with trace(str(tmp_path)):
        f(torch.ones(4))
    found = [os.path.join(dp, fn) for dp, _, fns in os.walk(tmp_path) for fn in fns]
    assert found, "trace() wrote no profiler artifacts"
    with open(found[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "double" in names

    enable_nan_debugging(True)
    try:
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1).sum().backward()
    finally:
        enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
