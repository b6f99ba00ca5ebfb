"""Multi-process data-parallel training of the port, mirroring
tests/test_multihost.py: two processes on localhost in a gloo group, each
reading only its own byte range of the corpus file
(``multihost.train_from_files``), and the CLI's ``train --backend dp`` with
the multi-process flags; merges must equal the oracle's."""

import os
import subprocess
import sys

from tests import torch_dp_ranks as ranks
from zigbpe_tpu.models import oracle
from zigbpe_tpu_torch import cli
from zigbpe_tpu_torch.parallel import multihost
from zigbpe_tpu_torch.utils import serde

DATA = b"the quick brown fox jumps over the lazy dog " * 60


def test_two_process_train_from_files_matches_oracle(tmp_path):
    # the corpus in two files; each rank reads its half of their concatenation
    paths = [tmp_path / "a.bin", tmp_path / "b.bin"]
    paths[0].write_bytes(DATA[:1000])
    paths[1].write_bytes(DATA[1000:])
    case = dict(kind="files", paths=[str(p) for p in paths], vocab=300,
                kwargs=dict(chunk_rounds=8))
    results = [r[0] for r in ranks.run(2, [case], timeout=120)]
    want = oracle.train(DATA, 300)
    half = -(-len(DATA) // 2)
    for rank, (merges, read, total) in enumerate(results):
        assert merges == want
        assert total == len(DATA)
        assert read == min(half, len(DATA) - rank * half)


def test_cli_train_dp_two_processes(tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(DATA)
    out = tmp_path / "merges.txt"
    port = ranks.free_port()
    env = dict(os.environ, PYTHONPATH=str(ranks.REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "zigbpe_tpu_torch.cli", "train", str(corpus), "--vocab", "300",
         "--out", str(out), "--backend", "dp", "--device", "cpu", "--chunk-rounds", "8",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(rank)],
        cwd=ranks.REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    ) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    assert serde.load(out) == oracle.train(DATA, 300)
    assert b"trained 44 merges" in outs[0][1] and b"trained" not in outs[1][1]


def test_cli_train_dp_one_process(tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(DATA)
    out = tmp_path / "merges.txt"
    assert cli.main(["train", str(corpus), "--vocab", "300", "--out", str(out),
                     "--backend", "dp", "--device", "cpu"]) == 0
    assert serde.load(out) == oracle.train(DATA, 300)


def test_initialize_is_a_no_op_at_one_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    multihost.initialize()
    multihost.initialize(num_processes=1, device="cuda")  # no group, no device needed
    assert multihost.process_info() == (0, 1)
    assert multihost.global_data_group().size == 1
