"""End-to-end BasicTokenizer tests of the port on the CPU (plain PyTorch
path): the reference test vectors of test_tokenizer.py, the whole
conformance corpus against the JAX package, and the CLI demo."""

import subprocess
import sys
from pathlib import Path

import pytest

from zigbpe_tpu import BasicTokenizer as JaxTokenizer
from zigbpe_tpu.models import oracle
from zigbpe_tpu_torch import BasicTokenizer, InvalidTokenError, cli

SEEDED = [(ord("h"), ord("e"), 256), (256, ord("l"), 257), (ord("w"), ord("o"), 258)]
REPO = Path(__file__).resolve().parents[1]


def tok(merges=None):
    return BasicTokenizer(merges, device="cpu")


@pytest.mark.parametrize("backend", ["host", "device", "oracle"])
def test_encode_seeded(backend):
    # basic_tokenizer.zig:362-378
    assert tok(SEEDED).encode("hello world", backend=backend) == [
        257, ord("l"), ord("o"), ord(" "), 258, ord("r"), ord("l"), ord("d"),
    ]


def test_decode_seeded():
    # basic_tokenizer.zig:380-397
    ids = [257, ord("l"), ord("o"), ord(" "), 258, ord("r"), ord("l"), ord("d")]
    assert tok(SEEDED).decode(ids) == b"hello world"


@pytest.mark.parametrize("backend", ["host", "device", "oracle"])
def test_train_hello(backend):
    # basic_tokenizer.zig:399-432
    t = tok().train("hello world hello", 300, backend=backend)
    assert len(t.merges) > 0
    assert t.encode("hello", backend=backend) == [259]
    assert t.decode([259]) == b"hello"


def test_serde_round_trip(tmp_path):
    t = tok(SEEDED)
    t.save_merges(tmp_path / "m.txt")
    assert BasicTokenizer.from_merges_file(tmp_path / "m.txt", device="cpu").merges == t.merges
    assert tok().load_merges(tmp_path / "m.txt").merges == t.merges
    assert t.vocab_size == 259 and len(t) == 3


def test_decode_unknown():
    with pytest.raises(InvalidTokenError):
        tok(SEEDED).decode([300])
    with pytest.raises(InvalidTokenError):
        tok(SEEDED).decode([-1])


def test_decode_cyclic_table():
    with pytest.raises(InvalidTokenError):
        tok([(256, 97, 256)]).decode([256])


def test_deep_merge_chain_decode():
    merges = [(97, 97, 256)] + [(255 + i, 97, 256 + i) for i in range(1, 600)]
    assert tok(merges).decode([256 + 599]) == b"a" * 601


def test_probe_round_trip_device():
    probe = "hello world!!!? (안녕하세요!) lol123 😉"
    t = tok().train("hello world hello", 300, backend="device")
    ids = t.encode(probe, backend="device")
    assert t.decode(ids).decode("utf-8") == probe
    assert ids == oracle.encode(probe, t.merges)
    assert t.encode(probe) == ids  # auto: host below 64 KiB


def test_empty_and_tiny_inputs():
    assert tok().train(b"", 300).merges == []
    t = tok().train(b"a", 300)
    assert t.merges == []
    assert t.encode(b"") == [] and t.encode(b"", backend="device") == []
    assert tok(SEEDED).encode(b"", backend="device") == []
    assert t.decode([]) == b""


def test_unknown_backend():
    with pytest.raises(ValueError):
        tok().train(b"ab", 300, backend="tpu")
    with pytest.raises(ValueError):
        tok(SEEDED).encode(b"ab", backend="tpu")


def test_corpus_device_encode_matches_jax(corpus_bytes, golden_merges):
    """The whole conformance corpus through the device-backend encode:
    128,451 tokens, equal to the JAX package's encode, and decode gives the
    corpus back."""
    ids = tok(golden_merges).encode(corpus_bytes, backend="device")
    assert len(ids) == 128451
    assert ids == JaxTokenizer(golden_merges).encode(corpus_bytes, backend="device")
    assert tok(golden_merges).decode(ids) == corpus_bytes


def test_cli_demo_writes_golden_merges(tmp_path, capsys):
    out = tmp_path / "merges.txt"
    corpus = REPO / "tests" / "data" / "taylorswift.txt"
    assert cli.main(["demo", "--device", "cpu", "--corpus", str(corpus),
                     "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == cli.PROBE
    assert out.read_bytes() == (REPO / "tests" / "data" / "merges.txt").read_bytes()


def test_cli_train_encode_decode(tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"hello world hello " * 50)
    m = tmp_path / "m.txt"
    assert cli.main(["train", str(corpus), str(corpus), "--vocab", "300", "--out", str(m),
                     "--device", "cpu", "--time-stats"]) == 0
    capsys.readouterr()
    assert cli.main(["encode", "--merges", str(m), "--text", "hello world",
                     "--device", "cpu", "--backend", "device"]) == 0
    ids = capsys.readouterr().out.split()
    want = oracle.encode(b"hello world", oracle.train(b"hello world hello " * 100, 300))
    assert [int(i) for i in ids] == want
    assert cli.main(["decode", "--merges", str(m), "--ids", ",".join(ids)]) == 0
    assert capsys.readouterr().out.rstrip("\n") == "hello world"


def test_cli_module_invocation(tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"hello world hello " * 50)
    m = tmp_path / "m.txt"
    r = subprocess.run(
        [sys.executable, "-m", "zigbpe_tpu_torch.cli", "train", str(corpus),
         "--vocab", "270", "--out", str(m), "--backend", "host", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr
    assert [tuple(map(int, line.split(","))) for line in m.read_text().split()] == \
        oracle.train(b"hello world hello " * 50, 270)
