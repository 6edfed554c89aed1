"""The build cache of the port's compiled libraries: the CUDA kernels of
``csrc/`` (nvcc, :mod:`asltpu_torch.ops._build`) and the host decode
libraries of ``native/`` (g++, :mod:`asltpu_torch.native`).

Each library is built at first use into ``asltpu_torch/_build/<stem>-<hash>.so``,
``<hash>`` covering its sources and its compile flags, so it is built again
only when one of them changes. The compiler writes a temporary file that is
then renamed into place, so concurrent processes (xdist workers, decode
workers) never open a half-written library. Its output is kept beside the
library as ``.log``.

The standard library only: spawned decode workers import this.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parent / "_build"

# A library to build: where it goes, and its compile command given the
# path the compiler writes.
Job = Tuple[Path, Callable[[Path], List[str]]]


def output_path(stem: str, sources: Sequence[Path], flags: Sequence[str]) -> Path:
    """Where the library built from ``sources`` with ``flags`` goes."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update(Path(src).read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def build(jobs: Sequence[Job], compiler: str, timeout: Optional[float] = None) -> None:
    """Run the compile command of each library in ``jobs`` that is not built
    yet, all started together; raise ``RuntimeError`` naming each failure
    and its log."""
    todo = [(out, command) for out, command in jobs if not out.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(exist_ok=True)
    procs = []
    for out, command in todo:
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        procs.append((out, tmp, log, subprocess.Popen(
            command(tmp), stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for out, tmp, log, proc in procs:
        try:
            rc = proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = f"timed out after {timeout} s"
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{out.name} (rc {rc}, see {out.with_suffix('.log')})")
    if failed:
        raise RuntimeError(f"{compiler} failed: " + ", ".join(failed))
