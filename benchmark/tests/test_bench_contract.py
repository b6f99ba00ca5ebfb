"""BENCHMARK.json against the benchmark's contract, and the result line's
schema."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import spec

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits in its 12 hours
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_have_the_contracts_keys_and_names():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for e in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(e["name"]) and e["name"] not in names
        names.add(e["name"])
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
        assert m["source"] in SOURCES


def test_every_name_finds_its_files():
    configs = {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/") and data["name"] == c["name"]
        assert all(k in data and k in data["source_values"] for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        spec.traffic(ROOT, w["traffic"])
        assert len(spec.metrics(BENCH, w["name"], False)) >= 2
        assert "setup_s" in {m["name"] for m in spec.metrics(BENCH, w["name"], False)}
        assert spec.metrics(BENCH, w["name"], True)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(ROOT, m["name"]))
        assert set(m.get("workloads", [])) <= cells
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_roofline_and_share_names():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_result_line_schema(run_tiny):
    for workload in ("tiny.train", "tiny.enc"):
        for trace in (False, True):
            r = run_tiny(workload, trace=trace, seconds=0.2)
            keys = list(r)
            assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
            assert keys[-1] == "compared"
            assert ("breakdown" in r) == trace
            assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
            assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
            if trace:
                assert set(r["device"]) >= {"busy_s", "window_s"}
                assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
            for m in r["metrics"].values():
                assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
            for c in r["compared"].values():
                assert set(c) == {"value", "limit"}
            json.dumps(r)


def test_cpu_runs_report_no_device_metric(run_tiny):
    r = run_tiny("tiny.train", trace=True, seconds=0.2)
    assert {"upload_ms", "rounds_ms_per_merge"} <= set(r["metrics"])
    assert not {"launches_per_merge", "merge_kernel_ms_per_merge",
                "idle_share.train"} & set(r["metrics"])
    r = run_tiny("tiny.enc", seconds=0.3)
    calls = r["notes"]["calls"]
    assert calls == r["attempted"] and r["notes"]["call_median_ms"] > 0
