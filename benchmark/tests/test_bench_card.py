"""Each cell on the card, briefly: ``python3 benchmark/run.py`` for a few
seconds comes out correct and prints the cell's metrics. Needs a CUDA
card; skips without one."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import run as bench_run


def cells():
    with open(os.path.join(bench_run.ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", cells())
def test_cell_runs_correct_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "2147483901", "--seconds", "5", "--trace", "0"],
        cwd=bench_run.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert "setup_s" in line["metrics"]
