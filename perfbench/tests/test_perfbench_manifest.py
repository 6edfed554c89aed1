"""``BENCHMARK.json`` keeps its shape, and a new cell, configuration, traffic
mix and per-layer metric are each a new file the harness finds by name,
with no file of the benchmark edited."""

import hashlib
import json
import os
import shutil

import pytest

from perfbench.core import harness, manifest

ROOT = harness.ROOT


def test_the_manifest_has_no_problems():
    assert manifest.problems(ROOT) == []


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer():
    man = harness.manifest()
    for w in man["workloads"]:
        per_layer = harness.per_layer_metrics(w["name"], man)
        moves = {m["moves"] for m in per_layer}
        assert per_layer and moves <= {m["name"] for m in man["end_to_end"]}


def test_each_cell_names_its_limits():
    for w in harness.manifest()["workloads"]:
        cell, _ = harness.cell_files(w["name"])
        assert cell["limits"] and all(v > 0 for v in cell["limits"].values())


@pytest.mark.parametrize("bad,why", [
    ({"unit": "clips per s"}, "unit"), ({"name": "a b"}, "name"), ({"better": "more"}, "better"),
])
def test_a_bad_entry_is_found(tmp_path, bad, why):
    root = _copy(tmp_path)
    man = json.load(open(root / "BENCHMARK.json"))
    man["end_to_end"][0].update(bad)
    json.dump(man, open(root / "BENCHMARK.json", "w"))
    assert any(why in p for p in manifest.problems(str(root)))


def test_a_layer_metric_on_a_cell_that_does_not_report_what_it_moves_is_found(tmp_path):
    root = _copy(tmp_path)
    man = json.load(open(root / "BENCHMARK.json"))
    man["per_layer"][0]["workloads"] = ["i3d.finetune_b48"]
    json.dump(man, open(root / "BENCHMARK.json", "w"))
    assert any("does not report" in p for p in manifest.problems(str(root)))


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root


def _digests(pkg):
    out = {}
    for d, _, files in os.walk(pkg):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, pkg)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_files_are_found_by_name_with_no_file_edited(tmp_path):
    root = _copy(tmp_path)
    pkg = root / "perfbench"
    before = _digests(pkg)
    config = json.load(open(pkg / "configs" / "mobilenet_gru.json"))
    config["name"] = "mobilenet_gru_b"
    json.dump(config, open(pkg / "configs" / "mobilenet_gru_b.json", "w"))
    mix = json.load(open(pkg / "traffic" / "serve_poisson.json"))
    mix["params"]["rate_per_s"] = 100
    json.dump(mix, open(pkg / "traffic" / "serve_slow.json", "w"))
    why = "a new configuration under a new mix"
    json.dump({"config": "mobilenet_gru_b", "traffic": "serve_slow", "chips": 1, "why": why,
               "limits": {"logit_gap": 0.1}}, open(pkg / "workloads" / "mobilenet_gru_b.slow.json", "w"))
    (pkg / "metrics" / "queue_depth.slow.py").write_text(
        '"""queue_depth.slow: a test\'s counter."""\n\n'
        "def read(run):\n    return run.counters.get('queue')\n")
    man = json.load(open(root / "BENCHMARK.json"))
    man["configs"].append({"name": "mobilenet_gru_b", "source": "https://arxiv.org/abs/1801.04381",
                           "file": "perfbench/configs/mobilenet_gru_b.json", "reduced": [],
                           "why": why})
    man["workloads"].append({"name": "mobilenet_gru_b.slow", "config": "mobilenet_gru_b",
                             "traffic": "serve_slow", "chips": 1, "why": why})
    man["end_to_end"][[m["name"] for m in man["end_to_end"]].index("serve_p95_ms")][
        "workloads"].append("mobilenet_gru_b.slow")
    man["per_layer"].append({"name": "queue_depth.slow", "unit": "requests", "better": "lower",
                             "source": "program_counter", "layer": "batcher",
                             "moves": "serve_p95_ms", "workloads": ["mobilenet_gru_b.slow"]})
    json.dump(man, open(root / "BENCHMARK.json", "w"))

    assert manifest.problems(str(root)) == []
    after = _digests(pkg)
    assert {k: after[k] for k in before} == before  # nothing that was there changed
    cell, cfg = harness.cell_files("mobilenet_gru_b.slow", package_dir=str(pkg))
    assert cfg["name"] == "mobilenet_gru_b" and cell["mix"]["params"]["rate_per_s"] == 100
    assert harness.driver(cell["mix"]["driver"], package_dir=str(pkg)).run
    metrics = harness.per_layer_metrics("mobilenet_gru_b.slow", harness.manifest(str(root)))
    names = [m["name"] for m in metrics]
    assert "queue_depth.slow" in names and "avg_batch.serve" not in names

    class Stub:
        counters = {"queue": 3.0}

    got = harness.read_per_layer(Stub(), [m for m in metrics if m["name"] == "queue_depth.slow"],
                                 package_dir=str(pkg))
    assert got == {"queue_depth.slow": {"value": 3.0, "unit": "requests"}}
