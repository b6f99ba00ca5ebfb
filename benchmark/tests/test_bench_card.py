"""On the card: every cell runs correct for a short window, and every
cell's control, put in the program's place for a whole run at the cell's
own size, reads ``correct: false`` on three seeds.

    python -m pytest benchmark/tests/test_bench_card.py -m card
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import controls

from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct(card, workload):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", str(2**33 + 17), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size(card, workload):
    for seed in (2**33 + 1, 2**33 + 2, 2**33 + 3):
        r = controls.control_run(ROOT, workload, seed, card)
        assert r["correct"] is False and r["failed"] >= 1
