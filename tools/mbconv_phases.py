#!/usr/bin/env python3
"""Where the TF32 fused MBConv kernel spends its cycles, phase by phase.

    python3 tools/mbconv_phases.py

Needs an NVIDIA GPU and nvcc. Builds ``asltpu_torch/csrc/mbconv.cu`` with
``-DASL_PHASE_CLOCKS`` into ``asltpu_torch/_build/`` (the kernel then times
its phases with ``clock64()`` in thread 0 of every block: the x-tile
prologue, and per chunk of 16 expanded channels the weight staging, the
expand, the depthwise and the project, each ending at a barrier; then the
epilogue), runs it once at each of the seven main-path shapes of
``chip_smoke.py`` (512 frames, the same seeded inputs) through the
``fused_mbconv_s1`` wrapper, and prints the card's ``nvidia-smi`` line, then
one JSON line per shape: cycles per block, and per phase its cycles (per
chunk for the four chunk phases) and its share of the block's cycles. The
clocks add registers and serialise thread 0 at each barrier, so the
instrumented kernel runs a little slower than the real one; the shares are
what it is for.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from asltpu_torch.ops import _build  # noqa: E402
from asltpu_torch.ops import mbconv_kernels as mb  # noqa: E402

PHASES = ["prologue", "stage", "expand", "depthwise", "project", "epilogue"]
PER_CHUNK = {"stage", "expand", "depthwise", "project"}


def build() -> tuple[ctypes.CDLL, list[str]]:
    _build.BUILD_DIR.mkdir(exist_ok=True)
    out = _build.BUILD_DIR / "mbconv-phases.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-DASL_PHASE_CLOCKS", "-o", str(out),
           str(_build.CSRC / "mbconv.cu")]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed:\n{run.stdout}{run.stderr}")
    log = (run.stdout + run.stderr).splitlines()
    ptxas = [ln.strip() for ln in log if "spill" in ln or "registers" in ln]
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.asl_fused_mbconv_s1_tf32.argtypes = [p] * 8 + [i] * 9 + [p]
    lib.asl_fused_mbconv_s1_tf32.restype = i
    lib.asl_phase_cycles_take.argtypes = [p]
    lib.asl_phase_cycles_take.restype = i
    return lib, ptxas


def main() -> int:
    if not torch.cuda.is_available():
        print("mbconv_phases: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi(), flush=True)
    lib, ptxas = build()
    print(json.dumps({"instrumented_build_ptxas": ptxas}), flush=True)
    mb._lib = lambda: lib  # the wrapper launches the instrumented build
    dev = torch.device("cuda", 0)
    n = chip_smoke.BATCH * 16
    cycles = (ctypes.c_ulonglong * 8)()
    for i, (h, cin, ce, cout, _) in enumerate(chip_smoke.MBCONV_SHAPES):
        x, *wts = chip_smoke._mbconv_args(n, h, cin, ce, cout, chip_smoke.SEED + 10 + i, dev)
        for _ in range(2):  # the first run warms up; the second is read
            mb.fused_mbconv_s1(x, *wts)
            if lib.asl_phase_cycles_take(ctypes.addressof(cycles)):
                raise RuntimeError("reading the phase clocks failed")
        blocks, chunks = cycles[6], -(-ce // mb._CHUNK)
        per_block = [cycles[k] / blocks for k in range(len(PHASES))]
        total = sum(per_block)
        print(json.dumps({
            "shape": [n, h, h, cin], "ce": ce, "cout": cout, "blocks": blocks,
            "plan": dataclasses.asdict(mb.tf32_tile_plan(h, h, cin, cout)),
            "cycles_per_block": total,
            "phases": {name: {"cycles": c / chunks if name in PER_CHUNK else c,
                              "per": "chunk" if name in PER_CHUNK else "block",
                              "share": c / total}
                       for name, c in zip(PHASES, per_block)},
        }), flush=True)
        del x, wts
    return 0


if __name__ == "__main__":
    sys.exit(main())
