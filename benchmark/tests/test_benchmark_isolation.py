"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the port.

Each traffic's CPU rehearsal (benchmark/run.py --rehearse) runs in a child
process in which importing jax, jaxlib, flax or scp_tpu raises, and which
reports the top-level names of every module it loaded; names are compared
whole (scp_tpu_torch is the port, not scp_tpu)."""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "scp_tpu"}

CHILD = r"""
import importlib.abc, json, runpy, sys
FORBIDDEN = {"jax", "jaxlib", "flax", "scp_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in FORBIDDEN:
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, ".")
sys.argv = ["benchmark/run.py"] + sys.argv[1:]
try:
    runpy.run_path("benchmark/run.py", run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
print("MODULES " + json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def _child(args, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", CHILD, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("cell", ["sknn-sweeps", "dgcnn-sweeps", "sknn-train"])
def test_rehearsal_loads_no_jax(cell):
    out = _child(["--workload", cell, "--seed", "2147483647", "--seconds", "1", "--trace", "0",
                  "--rehearse"])
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    mods = set(json.loads(lines[-1].split(" ", 1)[1]))
    assert not mods & FORBIDDEN
    assert "scp_tpu_torch" in mods  # the port did run
    result = json.loads(lines[-2])
    assert result["correct"] is True, out.stderr[-3000:]


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.reference.ehem, benchmark.reference.octree, "
            "benchmark.reference.train, benchmark.checks.sweeps, benchmark.checks.train;"
            "print(sorted({m.split('.', 1)[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    mods = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not mods & (FORBIDDEN | {"scp_tpu_torch"})


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_reference_no_port():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            names = set(_imports(path))
            assert not names & FORBIDDEN, path
            if os.sep + "reference" + os.sep in path:
                assert "scp_tpu_torch" not in names, path
