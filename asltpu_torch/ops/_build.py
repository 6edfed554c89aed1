"""Builds the CUDA sources of ``asltpu_torch/csrc`` with nvcc and loads them
with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

``<hash>`` covers the source and the flags, so a library is built at first
use and again only when its source changes. The compiler's output (with
ptxas's register and spill counts) is kept beside it as ``.log``. Nothing
here runs at import time: the CPU tests import the kernel wrappers on hosts
that have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
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
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: List[str]) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, one nvcc process
    each, all started together; raise if any fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    compiler = nvcc() if todo else ""
    procs = []
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        log = open(out[n].with_suffix(".log"), "w")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for n, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out[n])
        else:
            failed.append(f"{n} (rc {rc}, see {out[n].with_suffix('.log')})")
    if failed:
        raise RuntimeError("nvcc failed: " + ", ".join(failed))
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
