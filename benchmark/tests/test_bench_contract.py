"""BENCHMARK.json against the files of the harness, and a run in a
directory that holds only the benchmark."""

import json
import os
import re
import shutil
import subprocess
import sys

from benchmark import run as bench_run

ROOT = bench_run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_name_has_its_files():
    b = bench()
    for c in b["configs"]:
        assert NAME.match(c["name"])
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(
            bench_run.HERE, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(
            bench_run.HERE, "limits", w["name"] + ".json"))
        _, _, cell_e2e, layer = bench_run.cell_spec(b, w["name"])
        assert "setup_s" in {m["name"] for m in cell_e2e}
        assert len(cell_e2e) >= 2 and layer
    for m in b["per_layer"]:
        assert NAME.match(m["name"]) and m["moves"] in e2e
        assert os.path.exists(os.path.join(bench_run.HERE, "metrics",
                                           m["name"] + ".py"))
    assert all(w["chips"] in (1, 4) for w in b["workloads"])


def test_run_without_the_program_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(bench_run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         bench()["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
