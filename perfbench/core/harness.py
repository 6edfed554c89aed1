"""One run of one cell: find the cell's files by name, check the card, run
its traffic driver, read its per-layer metrics, decide ``correct`` and
print the result.

Everything a cell is made of lives in files of its own, found by the
names in ``BENCHMARK.json``: ``workloads/<cell>.json`` (configuration,
traffic mix, limits), ``configs/<config>.json`` (sizes as run),
``traffic/<mix>.json`` (the driver that generates the mix and its
parameters), ``drivers/<driver>.py`` (set-up, window, comparison with
the reference), ``metrics/<metric>.py`` (a reader) and
``reference/<family>.py``. A new cell, configuration, mix or metric is a
new file; no file here changes."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PACKAGE_DIR)
# Top-level modules no run may hold: JAX, its libraries, and the JAX package
# the program was ported from (compared whole: the program's own name
# begins with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "asltpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_files(name: str, package_dir: str = PACKAGE_DIR) -> Tuple[dict, dict]:
    """(workload file with its traffic mix's file under ``"mix"``,
    configuration file) of the cell ``name``."""
    cell = load_json(os.path.join(package_dir, "workloads", f"{name}.json"))
    cell["mix"] = load_json(os.path.join(package_dir, "traffic", f"{cell['traffic']}.json"))
    config = load_json(os.path.join(package_dir, "configs", f"{cell['config']}.json"))
    return cell, config


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class SetupClock:
    """Where set-up goes: named parts from the process's start to the
    window's."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.parts: Dict[str, float] = {}
        self.window_start: Optional[float] = None

    @contextlib.contextmanager
    def part(self, name: str) -> Iterator[None]:
        t = time.perf_counter()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t

    def start_window(self) -> float:
        self.window_start = time.perf_counter()
        return self.window_start

    @property
    def seconds(self) -> float:
        return self.window_start - self.t0


@dataclasses.dataclass
class Context:
    name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    setup: SetupClock
    tmp: str

    @property
    def params(self) -> dict:
        return self.cell["mix"]["params"]

    def limit(self, check: str) -> float:
        return float(self.cell["limits"][check])


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end values (``setup_s`` aside),
    counts, the compared numbers with their limits, the counters the
    per-layer readers take, the parsed trace of a traced run, and lines of
    information for standard error."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]
    counters: Dict[str, float]
    memory_peak_bytes: int
    trace: Any = None
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads."""

    ctx: Context
    outcome: Outcome

    @property
    def counters(self) -> Dict[str, float]:
        return self.outcome.counters

    @property
    def trace(self):
        return self.outcome.trace


def per_layer_metrics(name: str, man: dict) -> List[dict]:
    """The per-layer metrics a traced run of ``name`` reports: those that
    list it, and those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in man["end_to_end"] if name in m.get("workloads", [name])}
    return [m for m in man["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def read_per_layer(run: Run, metrics: List[dict],
                   package_dir: str = PACKAGE_DIR) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        reader = load_file(os.path.join(package_dir, "metrics", f"{m['name']}.py"),
                           f"perfbench_metric_{len(out)}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def driver(name: str, package_dir: str = PACKAGE_DIR):
    return load_file(os.path.join(package_dir, "drivers", f"{name}.py"),
                     f"perfbench_driver_{name}")


def run_cell(name: str, seed: int, seconds: float, trace: bool, t0: float,
             device: Any = None, cell: Optional[dict] = None,
             config: Optional[dict] = None) -> Tuple[dict, Outcome, Context]:
    """Run the cell ``name`` once on ``device`` (the card by default) and
    return its result line as a dict, with the outcome and the context.
    ``cell`` and ``config`` stand in for the files (a test's small sizes)."""
    import torch

    man = manifest()
    files = cell_files(name)
    cell, config = cell or files[0], config or files[1]
    dev = torch.device(device or "cuda")
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        ctx = Context(name=name, cell=cell, config=config, seed=seed, seconds=seconds,
                      trace=trace, device=dev, setup=SetupClock(t0), tmp=tmp)
        if trace:
            from perfbench.core import trace as tracing

            with ctx.setup.part("profiler"):
                tracing.prime(dev)
        outcome = driver(cell["mix"]["driver"]).run(ctx)
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    correct = outcome.failed == 0 and all(v <= lim for v, lim in outcome.checks.values())
    if trace:
        metrics = read_per_layer(Run(ctx, outcome), per_layer_metrics(name, man))
    else:
        # The cell's own end-to-end metrics: a driver may measure more.
        units = {m["name"]: m["unit"] for m in man["end_to_end"]
                 if name in m.get("workloads", [name])}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in outcome.e2e.items()
                   if k in units}
        metrics["setup_s"] = {"value": ctx.setup.seconds, "unit": units["setup_s"]}
    result = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": device_record(dev, outcome)}
    if trace and outcome.trace is not None:
        result["breakdown"] = {"device_ops": outcome.trace.top_device_ops(),
                               "idle_gaps": outcome.trace.idle_gaps()}
    result["checks"] = checks
    return result, outcome, ctx


def device_record(dev, outcome: Outcome) -> dict:
    import torch

    if dev.type == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": 1, "memory_peak_bytes": outcome.memory_peak_bytes}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": outcome.memory_peak_bytes}
    if outcome.trace is not None:
        rec.update(busy_s=outcome.trace.busy_s, window_s=outcome.trace.window_s)
    return rec


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def stop_children() -> List[Tuple[int, str]]:
    """Stop multiprocessing's resource tracker (the spawned pools start it,
    and it would outlive this process for a moment) and reap it; kill and
    return any other child still alive."""
    import gc
    import signal
    from multiprocessing import resource_tracker

    gc.collect()
    resource_tracker._resource_tracker._stop()
    left = live_children()
    for pid, _ in left:
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
    return left


def live_children() -> List[Tuple[int, str]]:
    me, out = os.getpid(), []
    for entry in os.scandir("/proc"):
        if not entry.name.isdigit():
            continue
        try:
            with open(f"/proc/{entry.name}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            if int(ppid) != me:
                continue
            if state == "Z":
                os.waitpid(int(entry.name), os.WNOHANG)
                continue
            with open(f"/proc/{entry.name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except (OSError, ValueError):
            continue
        out.append((int(entry.name), cmd))
    return out


def say(*parts: Any) -> None:
    print(*parts, file=sys.stderr, flush=True)


def main(args, t0: float) -> int:
    import torch

    cell, _ = cell_files(args.workload)
    need = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        say(f"perfbench: the cell needs {need} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        result, outcome, ctx = run_cell(args.workload, args.seed, args.seconds,
                                        bool(args.trace), t0)
    finally:
        left = stop_children()
    if left:
        say(f"perfbench: processes left running, now killed: {left}")
        return 3
    bad = forbidden_modules()
    if bad:
        say(f"perfbench: the run loaded {bad}: the port may not import JAX or its JAX package")
        return 4
    say("setup_parts", json.dumps({k: round(v, 4) for k, v in ctx.setup.parts.items()}))
    say("info", json.dumps(outcome.info, default=str))
    for k, c in result["checks"].items():
        say(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
