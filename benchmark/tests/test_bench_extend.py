"""A later change adds a configuration, a traffic mix and a metric by
adding files and entries alone, and the harness runs them."""

from __future__ import annotations

import json
import shutil

import torch

from benchmark import run

from conftest import ROOT, add_cell


def test_new_files_and_entries_make_a_new_cell(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(tmp_path): p.read_bytes() for p in tmp_path.rglob("*")
              if p.is_file() and p.name != "BENCHMARK.json"}
    add_cell(tmp_path, {"name": "bpe_260.train_tiny", "config": "bpe_260", "traffic": "jobs_8k"},
             {"name": "bpe_260", "vocab_size": 260},
             {"name": "jobs_8k", "kind": "train_jobs", "corpus_bytes": 8192, "warmup_bytes": 512,
              "trace": {"phase": "merge_rounds", "every": 1, "first": 0}})
    (tmp_path / "benchmark" / "metrics" / "merges_per_job.py").write_text(
        "def read(run):\n    return sum(j.merges for j in run.jobs) / len(run.jobs)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["end_to_end"][0]["workloads"].append("bpe_260.train_tiny")
    bench["per_layer"].append({"name": "merges_per_job", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "trainer loop",
                               "moves": "train_MBps", "workloads": ["bpe_260.train_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    # no file that was there changed
    assert all((tmp_path / p).read_bytes() == b for p, b in before.items())

    e2e = run.run_cell(tmp_path, "bpe_260.train_tiny", 11, 0.1, False, torch.device("cpu"))
    assert e2e["correct"] is True
    assert set(e2e["metrics"]) == {"train_MBps", "setup_s"}
    per_layer = run.run_cell(tmp_path, "bpe_260.train_tiny", 11, 0.1, True, torch.device("cpu"))
    assert per_layer["metrics"]["merges_per_job"]["value"] == 4.0
