"""The controls on the card, at each cell's own size: the reference in the
next precision below the configuration's (float8 e4m3 products for bf16)
in the program's place has to read `correct: false`, on three seeds.

    python -m pytest -m cuda benchmark/tests/test_benchmark_control.py

Each case is one benchmark run with a short window (`--control`); the
readings it prints beside each limit are the upper readings the limits in
benchmark/limits/ were set below.  Skips without enough cards."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = {"sknn-sweeps": 1, "dgcnn-sweeps": 1, "sknn-train": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2147483001, 2147483002, 2147483003])
@pytest.mark.parametrize("cell", list(CELLS))
def test_control_reads_incorrect(cell, seed):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < CELLS[cell]:
        pytest.skip(f"{cell} needs {CELLS[cell]} CUDA card(s)")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(seed), "--seconds", "4", "--trace", "0", "--control"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    print(cell, seed, json.dumps(result["checks"]))
    assert result["correct"] is False, result["checks"]
