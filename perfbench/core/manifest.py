"""The shape ``BENCHMARK.json`` has to keep, and that every name in it
finds its file under ``perfbench/``: :func:`problems` lists what breaks
either."""

from __future__ import annotations

import json
import os
import re
from typing import List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and not re.search(r"[\n\r\t]", text)


def problems(root: str) -> List[str]:
    """What in ``root``'s ``BENCHMARK.json`` and ``perfbench/`` breaks the
    benchmark's shape; empty where nothing does."""
    out: List[str] = []
    man = json.load(open(os.path.join(root, "BENCHMARK.json")))
    pkg = os.path.join(root, "perfbench")
    if set(man) != KEYS["top"]:
        out.append(f"top-level keys {sorted(man)}")
    if not (isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51):
        out.append("run_seconds")
    if not all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in man["paths"]):
        out.append("paths")
    if not (1 <= len(man["command"]) <= 32 and all(_line(w) for w in man["command"])):
        out.append("command")
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[section]]
        if len(names) != len(set(names)):
            out.append(f"{section}: a name given twice")
        for e in man[section]:
            extra = set(e) - KEYS[section] - ({"workloads"} if section in ("end_to_end",
                                                                             "per_layer") else set())
            if KEYS[section] - set(e) or extra:
                out.append(f"{section} {e.get('name')}: keys {sorted(e)}")
            if not NAME.match(e["name"]):
                out.append(f"{section} {e['name']}: name")
            for key in ("why", "layer", "source"):
                if key in e and not _line(e[key]):
                    out.append(f"{section} {e['name']}: {key}")
            if "unit" in e and not UNIT.match(e["unit"]):
                out.append(f"{section} {e['name']}: unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                out.append(f"{section} {e['name']}: better")
    metric_names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    if len(metric_names) != len(set(metric_names)):
        out.append("a metric name given twice")
    for c in man["configs"]:
        if not (os.path.isfile(os.path.join(root, c["file"])) and c["file"].startswith("perfbench/")):
            out.append(f"config {c['name']}: file {c['file']}")
        if len(c["reduced"]) > 16 or not all(NAME.match(k) for k in c["reduced"]):
            out.append(f"config {c['name']}: reduced")
        if not any(w["config"] == c["name"] for w in man["workloads"]):
            out.append(f"config {c['name']}: used by no cell")
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    if len(pairs) != len(set(pairs)):
        out.append("a pair of config and traffic given twice")
    e2e = {m["name"]: m for m in man["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in man["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: source")
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']}")
    cells = {w["name"] for w in man["workloads"]}
    reports = {c: {m["name"] for m in man["end_to_end"] if c in m.get("workloads", cells)}
               for c in cells}
    layered = {c: [m["name"] for m in man["per_layer"] if c in m.get("workloads", cells)
                   and m["moves"] in reports[c]] for c in cells}
    for m in man["per_layer"]:
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: source")
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves {m['moves']}")
        for c in m.get("workloads", []):
            if c not in cells or m["moves"] not in reports[c]:
                out.append(f"{m['name']}: cell {c} does not report {m['moves']}")
        if not os.path.isfile(os.path.join(pkg, "metrics", f"{m['name']}.py")):
            out.append(f"{m['name']}: no metrics/{m['name']}.py")
    for w in man["workloads"]:
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips")
        if "setup_s" not in reports[w["name"]] or len(reports[w["name"]]) < 2 \
                or not layered[w["name"]]:
            out.append(f"{w['name']}: reports too few metrics")
        try:
            cell = json.load(open(os.path.join(pkg, "workloads", f"{w['name']}.json")))
            mix = json.load(open(os.path.join(pkg, "traffic", f"{w['traffic']}.json")))
        except OSError as e:
            out.append(f"{w['name']}: {e}")
            continue
        if any(cell.get(k) != w[k] for k in ("config", "traffic", "chips", "why")):
            out.append(f"{w['name']}: its workload file disagrees")
        if not os.path.isfile(os.path.join(pkg, "drivers", f"{mix['driver']}.py")):
            out.append(f"{w['name']}: no driver {mix['driver']}")
    return out
