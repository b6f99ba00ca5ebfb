"""The port's measurement entry points (``zigbpe_tpu_torch.bench``,
``scripts.run_config2``, ``scripts.run_config3`` and the probes
``breakdown``, ``encode`` and ``select_batch``) against the JAX repo's
scripts: the same corpus, every key of the JAX script's JSON line plus
``device``, and at tiny sizes on the CPU the same merges, fused passes and
tokens out as the JAX package and the native runtime. Every comparison is
exact; the timed fields are null on the CPU."""

import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as j_bench  # imports jax only inside main
from zigbpe_tpu import train as j_train
from zigbpe_tpu.ops.pallas import encode as pe
from zigbpe_tpu_torch import bench, measure
from zigbpe_tpu_torch import train as t_train
from zigbpe_tpu_torch.native import fastio
from zigbpe_tpu_torch.probes import __main__ as probes_main
from zigbpe_tpu_torch.probes import breakdown, encode, select_batch
from zigbpe_tpu_torch.probes.budget import tiled_corpus
from zigbpe_tpu_torch.scripts import run_config2, run_config3

REPO = Path(__file__).resolve().parents[1]
TRAIN_BYTES, MERGES = 64 << 10, 44  # the corpus has 44 merges to vocab 300
ENCODE_BYTES, ROW, ENCODE_MERGES = 16 << 10, 1024, 64
JAX_SCRIPTS = {"bench": REPO / "bench.py", "config2": REPO / "scripts" / "run_config2.py",
               "config3": REPO / "scripts" / "run_config3.py"}
# the fields of each line that time the card: null on the CPU
CARD_FIELDS = {
    "bench": ("value", "vs_baseline", "runs_mbps", "best_mbps", "upload_s", "end_to_end_mbps",
              "warmup_s", "encode_mbps_1kmerge_batched", "encode_runs_mbps"),
    "config2": ("value", "warm_s", "cold_s", "cold_mbps", "upload_s", "vs_native"),
    "config3": ("value", "runs_mbps", "upload_s"),
}
RECORDS = ("CONFIG2_r5.json", "CONFIG3_r5.json")


@pytest.fixture(scope="module")
def records():
    """The TPU runs' records, read before any entry point runs."""
    return {name: (REPO / name).read_bytes() for name in RECORDS}


@pytest.fixture(scope="module")
def lines(records, tmp_path_factory):
    """The three JSON lines at tiny sizes on the CPU (the serving table and
    rows cut to ENCODE_MERGES and ROW), run from an empty directory, and the
    merges each train_device call of bench and config 2 gave."""
    cwd = tmp_path_factory.mktemp("cwd")
    got = []
    real = t_train.train_device

    def recorded(*args, **kwargs):
        got.append(real(*args, **kwargs))
        return got[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        mp.setattr(t_train, "train_device", recorded)
        mp.setattr(measure, "ENCODE_ROW", ROW)
        mp.setattr(measure, "ENCODE_MERGES", ENCODE_MERGES)
        out = {"bench": bench.run("cpu", TRAIN_BYTES, MERGES, 2)}
        out["bench_merges"], got[:] = list(got), []
        out["config2"] = run_config2.run("cpu", TRAIN_BYTES, MERGES)
        out["config2_merges"] = list(got)
        out["config3"] = run_config3.run("cpu", ENCODE_BYTES)
    out["cwd"] = sorted(p.name for p in cwd.iterdir())
    return out


def _jax_line_keys(script: Path) -> set:
    """The keys of the dict literal that a JAX script prints as its line."""
    tree = ast.parse(script.read_text())
    found = [n for n in ast.walk(tree) if isinstance(n, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == "metric" for k in n.keys)]
    assert len(found) == 1
    return {k.value for k in found[0].keys}


def _jax_metric(script: Path, **names) -> str:
    """The JAX script's metric name with its f-string's names bound."""
    tree = ast.parse(script.read_text())
    (expr,) = [n.values[i] for n in ast.walk(tree) if isinstance(n, ast.Dict)
               for i, k in enumerate(n.keys) if isinstance(k, ast.Constant) and k.value == "metric"]
    return eval(compile(ast.Expression(expr), str(script), "eval"), {}, names)


@pytest.mark.parametrize("nbytes", [1, 1000, 185_768, 185_769, 1 << 20, (3 << 20) + 7])
def test_tiled_corpus_is_bench_load_corpus(nbytes):
    assert tiled_corpus(nbytes) == j_bench.load_corpus(nbytes)


@pytest.mark.parametrize("name", sorted(JAX_SCRIPTS))
def test_lines_hold_every_jax_key_and_device(name, lines):
    keys = set(lines[name])
    assert _jax_line_keys(JAX_SCRIPTS[name]) | {"device"} == keys
    assert lines[name]["device"] == "cpu"
    json.dumps(lines[name])


@pytest.mark.parametrize("name", sorted(JAX_SCRIPTS))
def test_cpu_lines_hold_no_card_time(name, lines):
    assert lines[name]["unit"] == "MB/s/chip"
    assert [lines[name][k] for k in CARD_FIELDS[name]] == [None] * len(CARD_FIELDS[name])


def test_metric_names_are_the_jax_scripts(lines):
    label = measure.size_label(TRAIN_BYTES)
    assert label == "0.0625" and measure.size_label(32 << 20) == "32"
    assert lines["bench"]["metric"] == _jax_metric(JAX_SCRIPTS["bench"], MERGES=MERGES,
                                                   BENCH_MB=label)
    assert lines["config2"]["metric"] == _jax_metric(JAX_SCRIPTS["config2"], n_merges=MERGES,
                                                     mb=label)
    assert lines["config3"]["metric"] == _jax_metric(JAX_SCRIPTS["config3"],
                                                     mb=measure.size_label(ENCODE_BYTES))


def test_bench_and_config2_merges_equal_jax_train_device_and_native(lines):
    data = tiled_corpus(TRAIN_BYTES)
    tokens, length, ub = j_train.upload(data)
    want = j_train.train_device(tokens, length, 256 + MERGES, length_host=len(data),
                                ub_seed_block=ub)
    assert len(want) == MERGES and want == fastio.train(data, 256 + MERGES)
    # bench: the warm-up's train, then BENCH_RUNS = 2 timed runs; config 2:
    # cold, then warm
    assert lines["bench_merges"] == [want, want, want]
    assert lines["config2_merges"] == [want, want]
    assert lines["config2"]["conforms_to_native"] is True
    assert lines["config2"]["serde_roundtrip"] is True


def test_config3_and_encode_probe_equal_native_rows_and_jax(lines, capsys):
    data = tiled_corpus(ENCODE_BYTES)
    table = fastio.train(data, 256 + ENCODE_MERGES)
    assert len(table) == ENCODE_MERGES
    B = ENCODE_BYTES // ROW
    per_row = [len(fastio.encode(data[i * ROW:(i + 1) * ROW], table)) for i in range(B)]
    gt, gl = pe.schedule_merges(np.asarray(table, np.int32).reshape(-1, 3), cap=32)
    rows = np.frombuffer(data, np.uint8).astype(np.int32).reshape(B, ROW)
    _, jlens = pe.encode_rows_grouped(jnp.asarray(rows), jnp.asarray(gt), jnp.asarray(gl),
                                      interpret=True)
    assert np.asarray(jlens).tolist() == per_row
    line = lines["config3"]
    assert (line["rows"], line["row_tokens"], line["fused_passes"]) == (B, ROW, len(gl))
    assert line["tokens_out"] == sum(per_row)
    assert line["compression"] == round(B * ROW / sum(per_row), 4)

    # the probe's table: 1024 merges (as many as 16 KiB holds), group_merges
    table = fastio.train(data, 256 + 1024)
    per_row = [len(fastio.encode(data[i * ROW:(i + 1) * ROW], table)) for i in range(B)]
    probe = encode.run("cpu", ENCODE_BYTES, ROW, runs=1)
    assert probe["tokens_out"] == sum(per_row)
    assert probe["fused_passes"] == len(pe.group_merges(np.asarray(table, np.int32))[1])
    printed = capsys.readouterr().out.splitlines()
    assert f"tokens out: {sum(per_row)}" in printed
    assert any(p.startswith(f"encode 0.015625 MB rows={ROW}: ") for p in printed)


def test_select_batch_arms_give_the_native_merges(capsys):
    out = select_batch.run("cpu", 32 << 10, 300, runs=1)
    assert out["merges"] == fastio.train(tiled_corpus(32 << 10), 300)
    assert sorted(out["rows"]) == list(select_batch.BATCHES)
    printed = capsys.readouterr().out
    assert all(f"batch={b:3d}: " in printed for b in select_batch.BATCHES)


def test_select_batch_raises_when_an_arm_diverges(monkeypatch):
    real = t_train.train_device

    def skewed(*args, select_batch, **kwargs):
        merges = real(*args, select_batch=select_batch, **kwargs)
        return merges[:-1] if select_batch == 16 else merges

    monkeypatch.setattr(t_train, "train_device", skewed)
    with pytest.raises(RuntimeError, match="select_batch=16 diverges"):
        select_batch.run("cpu", 32 << 10, 270, runs=1)


def test_breakdown_full_is_the_native_prefix(capsys):
    out = breakdown.run("cpu", 64 << 10, rounds=8, runs=1)
    assert (out["merge_group"], out["select_batch"]) == (1, 8)
    assert sorted(out["rows"]) == ["1pal_mrg", "full", "replay", "select"]
    assert sorted(out["derived"]) == ["merge", "other", "select"]
    printed = capsys.readouterr().out
    assert "1xla_mrg" not in printed and "\nderived: merge=" in printed


def test_breakdown_raises_when_full_differs_from_native(monkeypatch):
    real = fastio.train
    monkeypatch.setattr(fastio, "train", lambda data, vocab: real(data, vocab)[::-1])
    with pytest.raises(RuntimeError, match="full gave other merges"):
        breakdown.run("cpu", 64 << 10, rounds=4, runs=1)


ENTRIES = {
    "bench": (bench, lambda: bench.main([])),
    "run_config2": (run_config2, lambda: run_config2.main([])),
    "run_config3": (run_config3, lambda: run_config3.main(["1"])),
    "breakdown": (breakdown, lambda: probes_main.main(["breakdown"])),
    "encode": (encode, lambda: probes_main.main(["encode"])),
    "select_batch": (select_batch, lambda: probes_main.main(["select_batch"])),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entry_points_refuse_cuda_without_a_card(name, monkeypatch, capsys):
    """The default device is cuda: without a card each entry stops with
    ``resolve_device``'s message before it reads the corpus."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    module, call = ENTRIES[name]

    def no_corpus(nbytes):
        raise AssertionError("the entry point went on without a card")

    monkeypatch.setattr(module, "tiled_corpus", no_corpus)
    with pytest.raises((SystemExit, RuntimeError)) as err:
        call()
    if err.type is SystemExit:
        assert err.value.code not in (0, None)
        message = capsys.readouterr().err
    else:
        message = str(err.value)
    assert "torch.cuda.is_available() is False" in message


@pytest.mark.parametrize("module", [run_config2, run_config3], ids=["config2", "config3"])
def test_mains_write_their_own_file_and_no_record(module, records, lines, monkeypatch,
                                                  tmp_path, capsys):
    line = {"metric": module.__name__, "value": None}
    monkeypatch.setattr(module, "run", lambda *args, **kwargs: line)
    monkeypatch.setattr(measure, "RESULTS_DIR", tmp_path / "results")
    monkeypatch.chdir(tmp_path)
    assert module.main(["1", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out.splitlines()
    name = module.__name__.rsplit("_", 1)[1]
    written = (tmp_path / "results" / f"{name}.json").read_text()
    assert printed == [json.dumps(line)] and written == json.dumps(line) + "\n"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["results"]
    assert lines["cwd"] == []
    assert {n: (REPO / n).read_bytes() for n in RECORDS} == records


def test_bench_main_reads_its_environment(monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(bench, "run", lambda *args: seen.append(args) or {"metric": "m"})
    monkeypatch.setenv("BENCH_MB", "2")
    monkeypatch.setenv("BENCH_MERGES", "5")
    monkeypatch.setenv("BENCH_RUNS", "1")
    assert bench.main(["--device", "cpu"]) == 0
    assert seen == [("cpu", 2 << 20, 5, 1)]
    assert capsys.readouterr().out == '{"metric": "m"}\n'


def test_stage_rows_is_a_view_of_whole_rows():
    data = tiled_corpus(5 * ROW + 17)
    rows, ms = measure.stage_rows(data, ROW, torch.device("cpu"))
    assert rows.shape == (5, ROW) and rows.dtype == torch.int32 and ms >= 0
    assert rows._base is not None and rows._base.numel() == 5 * ROW
    assert rows.flatten().tolist() == list(data[:5 * ROW])
