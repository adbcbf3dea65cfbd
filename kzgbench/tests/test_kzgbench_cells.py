"""Each cell's path end to end on the CPU at a tiny size (the port's plain
versions), its answers against the reference; the planted faults and the
control each come out not correct; the line's keys against BENCHMARK.json.
The card's test runs the command itself."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from kzgbench import control, harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
TINY = {"config": {"n": 8}, "traffic": {"batch": 2, "pool_batches": 2,
                                        "warmup_batches": 1}}


def _run(cell, plant=None, seconds=0.5):
    return harness.run(cell, 2 ** 31 + 11, seconds, False,
                       torch.device("cpu"), time.perf_counter(), plant=plant,
                       resize=TINY)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_cpu(cell):
    res = _run(cell, seconds=2.0)
    line = res["line"]
    assert line["correct"] and line["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device"}
    want = {m["name"]: m["unit"] for m in harness.cell_metrics(cell, False)}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    rate = [m for m in harness.cell_metrics(cell, False)
            if m["name"].startswith("polys_per_s")]
    assert len(rate) == 1 and line["metrics"][rate[0]["name"]]["value"] > 0


@pytest.mark.parametrize("plant", sorted(control.PLANTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_reads_not_correct(cell, plant):
    res = _run(cell, control.PLANTS[plant])
    assert not res["line"]["correct"]
    assert sum(c["value"] for c in res["checks"].values()) > 0


@pytest.mark.cuda
def test_cell_on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    root = harness.ROOT
    out = subprocess.run(
        [sys.executable, "-m", "kzgbench.run", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=1200,
        env={**os.environ})
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
