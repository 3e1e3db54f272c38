"""A run with the timed path broken underneath comes out not correct; a
sound one comes out correct. Each run skips the look for a card and
drives the rest of ``run.py`` on the CPU at small widths, with the cell's
own limits."""

import argparse
import json
import os

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests import tiny

torch.set_num_threads(2)

SHARES = {"16": 0.171, "32": 0.602, "48": 0.228}
SMALL = {
    "train-ljspeech-b64": dict(batch=8, utterances=96, frames_per_char=2.0,
                               shares=SHARES),
    "serve-ljspeech-poisson": dict(rate=20.0, max_batch=4, max_steps=40,
                                   checked_requests=3, shares=SHARES),
}


def result(workload, capsys, faults=(), seconds=1.0):
    bench = bench_run.load_json(os.path.join(bench_run.ROOT,
                                             "BENCHMARK.json"))
    cell, _, e2e, layer = bench_run.cell_spec(bench, workload)
    mix = bench_run.load_json(os.path.join(
        bench_run.HERE, "traffic", cell["traffic"] + ".json"))
    mix.update(SMALL[workload])
    limits = bench_run.load_json(os.path.join(
        bench_run.HERE, "limits", workload + ".json"))["limits"]
    args = argparse.Namespace(workload=workload, seed=2_147_483_700,
                              seconds=seconds, trace=0)
    capsys.readouterr()
    line = bench_run.execute(args, cell, e2e, layer, tiny.config(), mix,
                             limits, torch.device("cpu"), "cpu", faults)
    assert bench_run.emit(line) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("workload, fault", [
    ("train-ljspeech-b64", None),
    ("train-ljspeech-b64", "stale_state"),
    ("train-ljspeech-b64", "half_batch"),
    ("train-ljspeech-b64", "stale_state@window"),
    ("train-ljspeech-b64", "half_batch@window"),
    ("serve-ljspeech-poisson", None),
    ("serve-ljspeech-poisson", "alter_frame"),
])
def test_faults_turn_correct_false(workload, fault, capsys):
    line = result(workload, capsys, (fault,) if fault else ())
    assert line["correct"] is (fault is None), line["checks"]
    if fault and fault.endswith("@window"):
        # planted as the window starts: the start's steps stay sound, the
        # window's steps fail
        failed = {k for k, c in line["checks"].items()
                  if c["value"] > c["limit"]}
        assert failed and all(k.startswith("window_") for k in failed), \
            line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
