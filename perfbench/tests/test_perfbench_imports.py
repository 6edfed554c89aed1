"""Nothing a run imports is JAX or the JAX package (compared by whole
top-level name: the program's own name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from perfbench.core import harness

PKG = harness.PACKAGE_DIR


def _imported_top_levels(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        assert not set(_imported_top_levels(path)) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(PKG, "reference", "*.py")):
        assert "asltpu_torch" not in set(_imported_top_levels(path)), path


def _in_a_fresh_process(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=harness.ROOT,
                         env={**os.environ, "PYTHONPATH": harness.ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_module():
    code = """
import time
from perfbench.core import harness
from perfbench.tests.sizes import tiny
for name in ("mobilenet_gru.serve_poisson", "i3d.finetune_b48"):
    cell, config = tiny(name)
    harness.run_cell(name, 3, 0.5, False, time.perf_counter(), device="cpu", cell=cell,
                     config=config)
harness.stop_children()
import sys
assert "asltpu_torch" in sys.modules
print(harness.forbidden_modules())
"""
    assert _in_a_fresh_process(code) == "[]"


def test_the_reference_loads_nothing_of_the_program():
    code = """
import importlib, pkgutil, sys
import perfbench.reference as r
for m in pkgutil.iter_modules(r.__path__):
    importlib.import_module("perfbench.reference." + m.name)
print(sorted(n for n in sys.modules if n.split(".")[0] in ("asltpu_torch", "asltpu", "jax")))
"""
    assert _in_a_fresh_process(code) == "[]"
