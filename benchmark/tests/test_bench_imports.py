"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

from benchmark import run

from conftest import ROOT

BENCH_DIR = ROOT / "benchmark"
JAX_NAMES = {"jax", "jaxlib", "flax", "zigbpe_tpu"}


def imported_top_names(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_top_level_names_are_compared_whole():
    mods = {"zigbpe_tpu_torch": 1, "zigbpe_tpu_torch.ops": 1, "jaxtyping": 1, "numpy": 1}
    assert run.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "zigbpe_tpu.ops": 1, "flax": 1})
    assert run.forbidden_modules(mods) == ["flax", "jax.numpy", "zigbpe_tpu.ops"]
    assert run.forbidden_modules(mods, ("zigbpe_tpu_torch",)) == [
        "zigbpe_tpu_torch", "zigbpe_tpu_torch.ops"]


def test_the_harness_imports_neither_jax_nor_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        if "tests" not in path.parts:
            assert not imported_top_names(path) & JAX_NAMES, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        assert imported_top_names(path) <= {"__future__", "torch", "numpy"}, path


def test_a_run_leaves_jax_unloaded(run_tiny):
    loaded = set(sys.modules)
    run_tiny("tiny.train", seconds=0.1)
    new = {m: 1 for m in set(sys.modules) - loaded}
    assert run.forbidden_modules(new) == []


def test_without_the_program_the_command_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = json.loads((ROOT / "BENCHMARK.json").read_text())["command"]
    out = subprocess.run([sys.executable, *cmd[1:], "--workload", "bpe_1k.encode_bulk",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "bpe_1k.encode_bulk", "--seed", str(2**33), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    import torch

    if torch.cuda.is_available():
        return
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
