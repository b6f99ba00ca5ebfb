"""The port's native host runtime (``zigbpe_tpu_torch.native.fastio``)
against the JAX package's (``zigbpe_tpu.native.fastio``) and the oracle:
the cases of test_native.py and the golden corpus, the contract without a
compiler, a build by two processes or two threads at once, and the port's
independence from the reference package's files. All comparisons are exact."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from zigbpe_tpu.models import oracle
from zigbpe_tpu.native import fastio as jfastio
from zigbpe_tpu_torch import train as t_train
from zigbpe_tpu_torch.native import fastio
from zigbpe_tpu_torch.utils import fileio

REPO = Path(__file__).resolve().parents[1]

TRAIN_CASES = {  # test_native.py's, and its seeded random corpus
    "hello": (b"hello world hello", 300),
    "aaaaab": (b"aaaaab" * 50, 300),
    "ab": (b"ab" * 3, 300),
    "one_byte": (b"a", 300),
    "empty": (b"", 300),
    "random": (bytes(np.random.default_rng(13).integers(97, 103, 6000, dtype=np.uint8)), 330),
}
HIST_CASES = {
    "aaab": b"aaab hello hello",
    "empty": b"",
    "one_byte": b"x",
    "all_bytes": bytes(range(256)) * 3,
    "random": bytes(np.random.default_rng(14).integers(0, 256, 5000, dtype=np.uint8)),
}


def test_source_is_a_byte_copy_of_the_reference():
    assert (REPO / "zigbpe_tpu_torch" / "native" / "fastio.cpp").read_bytes() == (
        REPO / "zigbpe_tpu" / "native" / "fastio.cpp").read_bytes()


def test_library_builds_here():
    assert fastio.available() and jfastio.available()
    assert fastio.library_path().parent == Path(fastio.BUILD_DIR)


@pytest.mark.parametrize("payload", [bytes(range(256)) * 10, b"", b"\0" * 4097],
                         ids=["bytes", "empty", "zeros"])
def test_read_file_matches_jax(tmp_path, payload):
    p = tmp_path / "x.bin"
    p.write_bytes(payload)
    assert fastio.read_file(str(p)) == payload == jfastio.read_file(str(p))
    assert fastio.read_file(p) == payload  # a path object too
    assert fileio.read_file(p) == payload


def test_read_file_missing_raises(tmp_path):
    with pytest.raises(OSError):
        fastio.read_file(str(tmp_path / "missing"))


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_matches_jax_and_oracle(case):
    data, vocab = TRAIN_CASES[case]
    got = fastio.train(data, vocab)
    assert got == jfastio.train(data, vocab) == oracle.train(data, vocab)


def test_train_takes_any_bytes_like():
    data = b"hello world hello"
    assert fastio.train(bytearray(data), 300) == fastio.train(memoryview(data), 300) == \
        oracle.train(data, 300)


@pytest.mark.parametrize("vocab", [255, 0x10001])
def test_train_rejects_vocab_like_jax(vocab):
    with pytest.raises(ValueError):
        jfastio.train(b"abab", vocab)
    with pytest.raises(ValueError):
        fastio.train(b"abab", vocab)


def test_encode_matches_jax_and_oracle():
    data = b"hello world hello hello"
    merges = oracle.train(data, 300)
    for probe in [b"hello", b"hello world", b"xyz", b"", b"h"]:
        got = fastio.encode(probe, merges)
        assert got == jfastio.encode(probe, merges) == oracle.encode(probe, merges)
    assert fastio.encode(b"hello", []) == list(b"hello")


def test_encode_rejects_malformed_merges():
    with pytest.raises(ValueError):
        fastio.encode(b"hello", [(104, 101)])


def test_golden(corpus_bytes, golden_merges):
    merges = fastio.train(corpus_bytes, 300)
    assert merges == golden_merges == jfastio.train(corpus_bytes, 300)
    ids = fastio.encode(corpus_bytes, golden_merges)
    assert len(ids) == 128451
    assert ids == jfastio.encode(corpus_bytes, golden_merges)


@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_byte_pair_hist_matches_jax_and_oracle(case):
    data = HIST_CASES[case]
    hist = fastio.byte_pair_hist(data)
    assert hist.shape == (256, 256) and hist.dtype == np.int32
    np.testing.assert_array_equal(hist, jfastio.byte_pair_hist(data))
    got = {(a, b): int(c) for (a, b), c in np.ndenumerate(hist) if c}
    assert got == dict(oracle.count_pairs(list(data)))


def test_without_a_compiler_the_contract_holds(monkeypatch, tmp_path):
    """No library: read_file reads in Python, byte_pair_hist gives None,
    train and encode raise; the trainer then seeds on the device."""
    monkeypatch.setattr(fastio, "_compile", lambda force: None)
    monkeypatch.setattr(fastio, "_lib", None)
    monkeypatch.setattr(fastio, "_tried", False)
    assert not fastio.available() and not fastio.build()
    p = tmp_path / "x.bin"
    p.write_bytes(b"payload")
    assert fastio.read_file(p) == b"payload" == fileio.read_file(p)
    assert fastio.byte_pair_hist(b"abc") is None
    with pytest.raises(RuntimeError, match="unavailable"):
        fastio.train(b"abc", 300)
    with pytest.raises(RuntimeError, match="unavailable"):
        fastio.encode(b"abc", [])
    tokens, n, block = t_train.upload(b"hello world", "cpu")
    assert block is None and n == 11
    data = b"hello world hello " * 20
    assert t_train.train(data, 300, device="cpu") == oracle.train(data, 300)


def test_a_library_that_does_not_load_is_built_again(monkeypatch, tmp_path):
    """A file at the library's path that this host cannot load (as one
    built on another host may be) is rebuilt, not fatal."""
    monkeypatch.setattr(fastio, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(fastio, "_lib", None)
    monkeypatch.setattr(fastio, "_tried", False)
    fastio.library_path().write_bytes(b"not a shared library")
    assert fastio.available()
    assert fastio.train(b"hello world hello", 300) == oracle.train(b"hello world hello", 300)
    assert fastio.library_path().read_bytes()[:4] == b"\x7fELF"


_CHILD = """
import sys, time
from pathlib import Path
from zigbpe_tpu_torch.native import fastio
fastio.BUILD_DIR = Path(sys.argv[1])
go = Path(sys.argv[2])
deadline = time.monotonic() + 60
while not go.exists() and time.monotonic() < deadline:
    time.sleep(0.01)
assert fastio.available(), "the library did not build"
print(fastio.train(b"hello world hello", 300))
"""


def test_two_processes_build_at_once(tmp_path):
    """Two processes started together build the same library into an
    empty directory: both load it, one library is left and no temporary
    file."""
    build, go = tmp_path / "build", tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(build), str(go)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    go.touch()
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    want = str(oracle.train(b"hello world hello", 300))
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == want
    assert [f.suffix for f in build.iterdir()] == [".so"]


def test_two_threads_build_at_once(monkeypatch, tmp_path):
    """Two threads of one process that force a build at once each compile
    to a name of their own: both succeed, and one library is left and no
    temporary file."""
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setattr(fastio, "BUILD_DIR", tmp_path)
    with ThreadPoolExecutor(2) as pool:
        assert list(pool.map(lambda _: fastio.build(force=True), range(2))) == [True, True]
    assert [f.name for f in tmp_path.iterdir()] == [fastio.library_path().name]


def _reads_of_the_reference(path: Path):
    """Imports of jax or zigbpe_tpu, and the path component "zigbpe_tpu"
    as a string (a path built into the reference package), in a module."""
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        found += [n for n in names if n.split(".")[0] in ("jax", "zigbpe_tpu")]
        if isinstance(node, ast.Constant) and node.value == "zigbpe_tpu":
            found.append(f"'zigbpe_tpu' at line {node.lineno}")
    return found


def test_port_and_smoke_never_read_the_reference_package():
    files = sorted((REPO / "zigbpe_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert {str(f.relative_to(REPO)): r for f in files if (r := _reads_of_the_reference(f))} == {}
