"""Nothing the benchmark runs loads JAX or the JAX package: top-level
module names are compared whole (the port's `repro_torch` begins with the
JAX package's name `repro`)."""

import ast
import json
import subprocess
import sys

from portbench import spec
from portbench.harness import FORBIDDEN

PORTBENCH = spec.HERE


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    files = [p for p in PORTBENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        names = set(_top_level_imports(p))
        assert not names & set(FORBIDDEN), (p, names & set(FORBIDDEN))
        assert "benchmarks" not in names and "tools" not in names and "chip_smoke" not in names


def test_forbidden_names_are_compared_whole():
    from portbench.harness import forbidden_modules

    assert forbidden_modules(["repro_torch", "repro_torch.core.api", "portbench"]) == []
    assert forbidden_modules(["repro.core.api", "jax._src.api", "flax", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "repro"]


SCRIPT = """
import json, sys, time
sys.path[0:0] = [{root!r}, {src!r}]
import runpy
run = runpy.run_path({run!r}, run_name="portbench_run")
import torch
from portbench import spec
from portbench.spec import load_cell, metric_reader
from portbench.harness import run_cell, forbidden_modules
import portbench.readings
for cell in ("atm-e4", "hurricane-e4", "atm-psnr60"):
    c = load_cell(cell)
    for m in c.per_layer:
        metric_reader(m["name"])
c = load_cell("atm-psnr60")
run_cell(c, 1, 0.0, False, device=torch.device("cpu"), t0=time.perf_counter(),
         shape=(32, 64), log=lambda m: None)
c = load_cell("hurricane-e4")
run_cell(c, 1, 0.0, False, device=torch.device("cpu"), t0=time.perf_counter(),
         shape=(8, 16, 16), log=lambda m: None)
for kind in ("loads", "checks", "metrics"):
    for p in (spec.HERE / kind).glob("*.py"):
        spec.module(kind, p.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax_or_jax_package():
    root = spec.ROOT
    code = SCRIPT.format(root=str(root), src=str(root / "src"), run=str(PORTBENCH / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
