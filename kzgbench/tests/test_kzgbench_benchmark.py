"""BENCHMARK.json against its contract and the files it names: every cell's
configuration, traffic and protocol, every metric's reader; the frozen
yardstick's counts."""

import importlib
import json
import os
import re

import pytest

from kzgbench import harness, roofline

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["kzgbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "kzgbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), "rb") as fh:
        assert len(fh.read()) <= 64 * 1024


def test_names_units_and_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("kzgbench/") and NAME.match(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["name"] not in names
            names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} == \
        {"polys_per_s", "batch_ms.p95", "polys_per_s.blob",
         "batch_ms.p95.blob", "setup_s"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_its_metrics_move(cell):
    """Every cell reports setup_s and another end-to-end metric, and each
    per-layer metric it reports moves one of its end-to-end metrics."""
    e2e = {m["name"] for m in harness.cell_metrics(cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = harness.cell_metrics(cell, True)
    assert layers
    assert all(m["moves"] in e2e for m in layers)


def test_split_metric_is_read_by_its_quantity_reader():
    assert harness.reader("open_ms.blob") is harness.reader("open_ms")
    assert harness.reader("batch_ms.p95.blob") is \
        harness.reader("batch_ms.p95")
    with pytest.raises(ModuleNotFoundError):
        harness.reader("no_such_metric.blob")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    entry, config, traffic = harness.load_cell(cell)
    conf = {c["name"]: c for c in BENCH["configs"]}[entry["config"]]
    assert config["name"] == conf["name"] and config["reduced"] == \
        conf["reduced"]
    assert config["source"] == conf["source"]
    for key in ("curve", "n", "protocol", "guarantees", "assumed"):
        assert key in config
    for key in ("batch", "pool_batches", "warmup_batches", "trace_batches"):
        assert traffic[key] >= 1
    assert traffic["pool_batches"] >= 2        # a stale answer reads wrong
    proto = importlib.import_module(f"kzgbench.plain.{config['protocol']}")
    assert callable(proto.expected)
    for traced in (False, True):
        metrics = harness.cell_metrics(cell, traced)
        assert metrics
        for m in metrics:
            assert callable(harness.reader(m["name"]).read)


def test_frozen_counts():
    assert roofline.mont_products(8) == 136
    assert roofline.mont_products(12) == 300
    assert roofline.sqr_products(8) == 108
    assert roofline.sqr_products(12) == 234
    assert roofline.msm_shape(4096, 255) == (10, 26, 512)
    assert roofline.msm_shape(1 << 20, 254) == (14, 19, 8192)
    rates = {"bytes_per_s": roofline.HBM_BYTES_PER_S,
             "products_per_s": 132 * 64 * 1980e6}
    b, p = roofline.accumulate_work(4096, 64, 12, 255)
    t, by = roofline.bound_s(rates, b, p)
    assert by == "products" and 0.5e-3 < t < 2e-3
    t, by = roofline.bound_s(rates, *roofline.reduce_work(1 << 20, 8, 8, 254))
    assert by == "products" and t > 0
