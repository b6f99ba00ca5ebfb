"""Fixtures of the benchmark's own tests.

Run them from the root of the repository: ``python -m pytest benchmark/tests``.
Tests marked ``card`` need a CUDA card and skip without one; they decide in
the ``card`` fixture, never while a module is imported.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    import torch

    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
    torch.set_num_threads(1)  # small tensors; workers share the cores


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def add_cell(root: Path, cell: dict, config: dict | None = None, traffic: dict | None = None,
             e2e: tuple = (), per_layer: tuple = ()) -> None:
    """Add a cell to the benchmark under ``root`` the way a later change
    would: new files, and new entries in ``BENCHMARK.json``. ``e2e`` and
    ``per_layer`` name existing metrics that list cells and should list
    this one too."""
    path = root / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    if config is not None:
        (root / "benchmark" / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
        bench["configs"].append({"name": config["name"], "source": "test",
                                 "file": f"benchmark/configs/{config['name']}.json",
                                 "reduced": [], "why": "test"})
    if traffic is not None:
        name = traffic.pop("name")
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    bench["workloads"].append({**cell, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in e2e + per_layer:
            m["workloads"].append(cell["name"])
    path.write_text(json.dumps(bench))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of the benchmark with three tiny cells added, small enough for
    the program's plain PyTorch path on the CPU: ``tiny.train`` (32 KiB to
    vocab 300), ``tiny.enc`` (calls of 8 documents under 64 merges) and
    ``bpe_1k.enc_tiny`` (calls of 8 documents of 4 KiB under the whole 1K
    table)."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    table = (ROOT / "benchmark" / "data" / "bpe_1k.merges.txt").read_text().splitlines(True)
    (root / "benchmark" / "data" / "tiny.merges.txt").write_text("".join(table[:64]))
    config = {"name": "tiny", "vocab_size": 300, "table": "benchmark/data/tiny.merges.txt"}
    train = ("upload_ms", "rounds_ms_per_merge", "launches_per_merge",
             "merge_kernel_ms_per_merge", "idle_share.train")
    add_cell(root, {"name": "tiny.train", "config": "tiny", "traffic": "train_tiny"}, config,
             {"name": "train_tiny", "kind": "train_jobs", "corpus_bytes": 32768,
              "warmup_bytes": 2048, "trace": {"phase": "merge_rounds", "every": 1, "first": 0}},
             e2e=("train_MBps",), per_layer=train)
    add_cell(root, {"name": "tiny.enc", "config": "tiny", "traffic": "enc_tiny"}, None,
             {"name": "enc_tiny", "kind": "encode_calls", "docs_per_call": 8, "pool_calls": 3, "source": "random_offsets",
              "lengths": {"dist": "lognormal", "median": 300, "sigma": 1.0, "min": 16,
                          "max": 2048, "seed": 0},
              "corpus_bytes": 65536, "check_calls": 2, "trace_calls": 3},
             e2e=("encode_MBps",), per_layer=("encode_kernel_roofline", "idle_share.encode"))
    add_cell(root, {"name": "bpe_1k.enc_tiny", "config": "bpe_1k", "traffic": "enc_4k"}, None,
             {"name": "enc_4k", "kind": "encode_calls", "docs_per_call": 8, "pool_calls": 2,
              "source": "consecutive", "lengths": {"dist": "fixed", "bytes": 4096},
              "check_calls": 2, "trace_calls": 2},
             e2e=("encode_MBps",))
    return root


@pytest.fixture
def run_tiny(tiny_root):
    """``run_tiny(workload, trace=False, seconds=0.5, seed=..., program=None)``:
    one run of a tiny cell on the CPU, as the result dict."""
    import torch

    from benchmark import run

    def go(workload, trace=False, seconds=0.5, seed=2**33 + 5, program=None):
        return run.run_cell(tiny_root, workload, seed, seconds, trace, torch.device("cpu"),
                            program)
    return go
