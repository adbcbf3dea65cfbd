"""The port's entry point (``python -m kzg_snark_tpu_torch``) and its phase
timing, in process on the CPU.

``main([...])`` with ``--device cpu`` runs the KZG demo on both backends
and all three demos on the host backend over the synthetic circuits at
2^3, each printing PASS, and returns 0; without the fixture pickles and
without ``--synthetic`` the Marlin and PLONK demos fail by the file's name
(or, with no ``--fixtures``, by the missing argument) and the exit code is
1.  ``PhaseTimer`` counts and totals phases and
waits for the work it is given; ``device_trace`` writes a Chrome trace on
the CPU.
"""

import json
import os
import time

import pytest
import torch

from kzg_snark_tpu_torch.__main__ import main
from kzg_snark_tpu_torch.utils.profiling import PhaseTimer, device_trace

torch.set_num_threads(1)


@pytest.fixture
def env(monkeypatch):
    for var in ("KZG_TPU_CHECKED", "KZG_TPU_NTT_MODE",
                "KZG_TPU_COMPLETE_ADD"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_kzg_demo_on_both_backends(capsys, env, backend):
    assert main(["--demo", "kzg", "--backend", backend, "--device", "cpu",
                 "--seed", "7"]) == 0
    assert "KZG verification: PASS" in capsys.readouterr().out


def test_all_demos_on_synthetic_circuits(capsys, env):
    assert main(["--backend", "host", "--device", "cpu", "--synthetic", "3",
                 "--seed", "7", "--timing"]) == 0
    out = capsys.readouterr().out
    for name in ("KZG", "Marlin", "PLONK"):
        assert f"{name} verification: PASS" in out
    report = json.loads(out.split("Timing report:\n", 1)[1].rsplit(
        "Demo complete!", 1)[0])
    assert sorted(report) == ["kzg", "marlin", "plonk"]
    assert all(r["count"] == 1 for r in report.values())


@pytest.mark.parametrize("given", [True, False],
                         ids=["empty-dir", "no-fixtures-arg"])
def test_missing_fixtures_fail_by_name(capsys, env, tmp_path, given):
    args = ["--backend", "host", "--seed", "7"]
    if given:
        args += ["--fixtures", str(tmp_path)]
    assert main(args) == 1
    out = capsys.readouterr().out
    assert "KZG verification: PASS" in out
    for name, pickle in (("marlin", "R1CS_INSTANCE.pkl"),
                         ("plonk", "PLONK_ARITHMETIZATION_INSTANCE.pkl")):
        assert f"{name} demo failed: FileNotFoundError" in out
        if given:
            assert os.path.join(str(tmp_path), pickle) in out
        else:
            assert (f"{pickle}: pass --fixtures DIR or --synthetic LOG2N"
                    in out)


def test_phase_timer_counts_and_totals():
    timer = PhaseTimer()
    x = torch.ones(4)
    for _ in range(3):
        with timer.phase("a", block_on=x):
            time.sleep(0.01)
    with timer.phase("b"):
        pass

    class Ready:
        waited = False

        def block_until_ready(self):
            Ready.waited = True
    with timer.phase("b", block_on=Ready()):
        pass
    assert Ready.waited
    report = timer.report()
    assert (report["a"]["count"], report["b"]["count"]) == (3, 2)
    assert report["a"]["total_s"] >= 0.03
    assert report["a"]["mean_s"] == pytest.approx(report["a"]["total_s"] / 3,
                                                  abs=1e-3)
    assert json.loads(timer.dump()) == report


def test_device_trace_writes_a_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with device_trace(logdir):
        torch.ones(64).cumsum(0)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)
