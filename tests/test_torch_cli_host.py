"""The port's CLI on its host backends needs no card: ``train``, ``encode``
and ``demo`` build the tokenizer on ``--device`` (default ``cuda``) only
when the chosen backend runs there, as the JAX CLI runs its host backends
on the host. None of these tests passes ``--device``."""

from pathlib import Path

import pytest
import torch

from zigbpe_tpu.models import oracle
from zigbpe_tpu_torch import cli
from zigbpe_tpu_torch.models.basic_tokenizer import _DEVICE_ENCODE_THRESHOLD
from zigbpe_tpu_torch.utils import serde

REPO = Path(__file__).resolve().parents[1]
TEXT = b"hello world hello " * 50


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


def _merges(tmp_path):
    m = tmp_path / "m.txt"
    serde.save(oracle.train(TEXT, 300), m)
    return m


@pytest.mark.parametrize("backend", ["host", "oracle"])
def test_train_on_a_host_backend_needs_no_device(tmp_path, capsys, backend):
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(TEXT)
    m = tmp_path / "m.txt"
    assert cli.main(["train", str(corpus), "--vocab", "300", "--out", str(m),
                     "--backend", backend]) == 0
    assert serde.load(m) == oracle.train(TEXT, 300)
    assert "trained" in capsys.readouterr().err


@pytest.mark.parametrize("backend", ["host", "oracle", "auto"])
def test_encode_of_short_text_needs_no_device(tmp_path, capsys, backend):
    """``auto`` takes the host below the device threshold, as
    BasicTokenizer.encode does."""
    args = ["encode", "--merges", str(_merges(tmp_path)), "--text", "hello world"]
    if backend != "auto":
        args += ["--backend", backend]
    assert cli.main(args) == 0
    ids = [int(i) for i in capsys.readouterr().out.split()]
    assert ids == oracle.encode(b"hello world", oracle.train(TEXT, 300))


def test_encode_of_a_file_on_the_host(tmp_path, capsys):
    f = tmp_path / "in.txt"
    f.write_bytes(TEXT)
    assert cli.main(["encode", "--merges", str(_merges(tmp_path)), "--file", str(f),
                     "--backend", "host"]) == 0
    ids = [int(i) for i in capsys.readouterr().out.split()]
    assert ids == oracle.encode(TEXT, oracle.train(TEXT, 300))


def test_demo_on_the_host_needs_no_device(tmp_path, capsys):
    out = tmp_path / "merges.txt"
    corpus = REPO / "tests" / "data" / "taylorswift.txt"
    assert cli.main(["demo", "--backend", "host", "--corpus", str(corpus),
                     "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == cli.PROBE
    assert out.read_bytes() == (REPO / "tests" / "data" / "merges.txt").read_bytes()


@pytest.mark.parametrize("backend", [[], ["--backend", "auto"], ["--backend", "device"]])
def test_train_on_the_device_backend_still_needs_a_card(tmp_path, backend):
    """The default stays the card: without one, train under auto or device
    raises and names cuda."""
    _no_card()
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(TEXT)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["train", str(corpus), "--vocab", "300", "--out", str(tmp_path / "m.txt"),
                  *backend])


def test_encode_of_long_text_under_auto_still_needs_a_card(tmp_path):
    """From the threshold up, auto encodes on the device, and without a card
    that raises."""
    _no_card()
    f = tmp_path / "in.txt"
    f.write_bytes(b"a" * _DEVICE_ENCODE_THRESHOLD)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["encode", "--merges", str(_merges(tmp_path)), "--file", str(f)])


def test_host_backends_take_an_explicit_device_too(tmp_path, capsys):
    """``--device cpu`` with a host backend, as the tests of earlier
    releases pass it, still runs."""
    args = ["encode", "--merges", str(_merges(tmp_path)), "--text", "hello",
            "--backend", "host", "--device", "cpu"]
    assert cli.main(args) == 0
    assert [int(i) for i in capsys.readouterr().out.split()] == oracle.encode(
        b"hello", oracle.train(TEXT, 300))


@pytest.mark.parametrize("flag", ["--checkpoint-dir", "--time-stats-detailed"])
def test_train_checkpoint_and_detailed_flags_on_the_cpu(tmp_path, capsys, flag):
    """``train --checkpoint-dir`` writes a checkpoint that a second run
    resumes from; ``--time-stats-detailed`` prints the report with the
    sort/replace split, as ``--time-stats`` prints it in the JAX CLI."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(TEXT)
    m = tmp_path / "m.txt"
    args = ["train", str(corpus), "--vocab", "300", "--out", str(m), "--backend", "device",
            "--device", "cpu", "--chunk-rounds", "4", flag]
    if flag == "--checkpoint-dir":
        args.append(str(tmp_path / "ck"))
    assert cli.main(args) == 0
    assert serde.load(m) == oracle.train(TEXT, 300)
    report = capsys.readouterr().out
    assert ("Time statistics:" in report) == (flag == "--time-stats-detailed")
    if flag == "--checkpoint-dir":
        saved = serde.load(tmp_path / "ck" / "merges.txt")  # after every 4th chunk
        assert 0 < len(saved) < len(serde.load(m)) and saved == serde.load(m)[: len(saved)]
        assert cli.main(args) == 0  # resumes from the checkpoint
        assert serde.load(m) == oracle.train(TEXT, 300)
    else:
        assert "sort_pairs" in report and "replace_pairs" in report


@pytest.mark.parametrize("argv,want", [
    ([], (None, "host", "cpu")),
    (["--merges", "m.txt"], ("m.txt", "host", "cpu")),
    (["--merges", "m.txt", "--backend", "oracle"], ("m.txt", "oracle", "cpu")),
    (["--merges", "m.txt", "--backend", "device"], ("m.txt", "device", "cuda")),
    (["--merges", "m.txt", "--backend", "device", "--device", "cpu"],
     ("m.txt", "device", "cpu")),
])
def test_gui_arguments(monkeypatch, argv, want):
    """``gui`` encodes on the host under ``auto``, as the JAX shell does,
    and builds its tokenizer on ``--device`` only for the device backend."""
    from zigbpe_tpu_torch.gui import app

    seen = []
    monkeypatch.setattr(app, "run", lambda path, backend, device: seen.append(
        (path, backend, device)))
    assert cli.main(["gui", *argv]) == 0
    assert seen == [want]
