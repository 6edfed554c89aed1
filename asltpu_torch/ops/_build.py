"""Builds the CUDA sources of ``asltpu_torch/csrc`` with nvcc and loads them
with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

through the build cache of :mod:`asltpu_torch._buildcache`: ``<hash>``
covers the source and the flags, so a library is built at first use and
again only when its source changes. The compiler's output (with ptxas's
register and spill counts) is kept beside it as ``.log``. Nothing here runs
at import time: the CPU tests import the kernel wrappers on hosts that have
no nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path
from typing import Dict, List

from asltpu_torch import _buildcache

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = _buildcache.BUILD_DIR
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels of asltpu_torch are built on first use"
    )


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built."""
    return _buildcache.output_path(name, [CSRC / f"{name}.cu"], NVCC_FLAGS)


def build(names: List[str]) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, one nvcc process
    each, all started together; raise if any fails."""
    out = {n: library_path(n) for n in names}
    if not all(p.exists() for p in out.values()):
        compiler = nvcc()
        _buildcache.build(
            [(out[n], lambda tmp, n=n: [compiler, *NVCC_FLAGS, "-o", str(tmp),
                                        str(CSRC / f"{n}.cu")]) for n in names],
            "nvcc")
    return out


def all_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        if name not in _libs:
            path = build([name])[name]
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]
