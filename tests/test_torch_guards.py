"""Guards of the port: it imports without jax, without zigbpe_tpu and
without nvcc, and a request for CUDA on a machine without a card raises
instead of running on the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from zigbpe_tpu_torch import BasicTokenizer, train
from zigbpe_tpu_torch.ops import core
from zigbpe_tpu_torch.ops.kernels import encode as kencode
from zigbpe_tpu_torch.ops.kernels import merge as kmerge

REPO = Path(__file__).resolve().parents[1]
MODULES = [
    "zigbpe_tpu_torch", "zigbpe_tpu_torch.cli", "zigbpe_tpu_torch.train",
    "zigbpe_tpu_torch.models.basic_tokenizer", "zigbpe_tpu_torch.models.oracle",
    "zigbpe_tpu_torch.models.numpy_backend", "zigbpe_tpu_torch.ops.core",
    "zigbpe_tpu_torch.ops.encode_batch", "zigbpe_tpu_torch.ops.kernels.encode",
    "zigbpe_tpu_torch.ops.kernels", "zigbpe_tpu_torch.ops.kernels._build",
    "zigbpe_tpu_torch.ops.kernels.merge", "zigbpe_tpu_torch.utils.serde",
    "zigbpe_tpu_torch.utils.profiling", "zigbpe_tpu_torch.utils.fileio",
    "zigbpe_tpu_torch.utils.state",
]


def _run(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=env)


def test_imports_without_jax_or_reference_package():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['zigbpe_tpu'] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'zigbpe_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_kernel_module_imports_without_nvcc(tmp_path):
    env = {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path / "none"),
           "PYTHONPATH": str(REPO)}
    code = (
        "from zigbpe_tpu_torch.ops.kernels import _build, encode, merge\n"
        "assert _build._libs == {}\n"
        "try:\n"
        "    _build.nvcc_path()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc not found' in str(e)\n"
        "else:\n"
        "    raise SystemExit('nvcc_path did not raise')\n"
        "print('ok')\n"
    )
    r = _run(code, env=env)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        BasicTokenizer(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        core.pad_tokens(b"hello", 256, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        train.train(b"hello hello", 300, device="cuda")


def test_merge_pass_on_a_non_cpu_tensor_never_runs_the_twin():
    tokens = torch.full((256,), -1, dtype=torch.int32, device="meta")
    table = torch.tensor([[97, 98, 256]], dtype=torch.int32, device="meta")
    before = kmerge.merge_pass_multi.launches
    with pytest.raises(ValueError, match="CUDA"):
        kmerge.merge_pass_multi(tokens, table)
    assert kmerge.merge_pass_multi.launches == before


@pytest.mark.parametrize("n,table,match", [
    (200, [[97, 98, 256]], "multiple of 128"),
    (256, [[97, 98, 256]] * 5, "slots"),
    (256, [[97, 98]], r"\[K, 3\]"),
])
def test_merge_pass_rejects_bad_shapes(n, table, match):
    tokens = torch.full((n,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        kmerge.merge_pass_multi(tokens, torch.tensor(table, dtype=torch.int32))


def _grouped(rows):
    gt, gl = kencode.schedule_merges(rows, cap=4)
    return torch.from_numpy(gt), torch.from_numpy(gl)


def test_encode_on_a_non_cpu_tensor_never_runs_the_twin():
    gt, gl = _grouped([[97, 98, 256]])
    tokens = torch.full((2, 1024), -1, dtype=torch.int32, device="meta")
    before = kencode.encode_rows_grouped.launches
    with pytest.raises(ValueError, match="CUDA"):
        kencode.encode_rows_grouped(tokens, gt.to("meta"), gl.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        kencode.encode_rows(tokens, [[97, 98, 256]])
    assert kencode.encode_rows_grouped.launches == before


@pytest.mark.parametrize("L,gshape,match", [
    (1000, (1, 4, 3), "128"),
    (896, (1, 4, 3), "8 <= R <= 256"),
    (32896, (1, 4, 3), "8 <= R <= 256"),
    (1024, (1, 4, 2), r"\[P, cap, 3\]"),
    (1024, (4, 3), r"\[P, cap, 3\]"),
    (1024, (1, 2000, 3), "capacity"),
])
def test_encode_rejects_bad_shapes(L, gshape, match):
    tokens = torch.full((2, L), -1, dtype=torch.int32)
    gtable = torch.full(gshape, -1, dtype=torch.int32)
    glens = torch.zeros(gshape[0], dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        kencode.encode_rows_grouped(tokens, gtable, glens)


def test_encode_rejects_mismatched_glens():
    gt, _ = _grouped([[97, 98, 256]])
    tokens = torch.full((2, 1024), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="glens"):
        kencode.encode_rows_grouped(tokens, gt, torch.zeros(3, dtype=torch.int32))


def test_train_and_load_merges_reset_the_grouped_table(tmp_path):
    tok = BasicTokenizer([(104, 101, 256)], device="cpu")
    assert tok.encode_batch([b"hello"]) == [[256, 108, 108, 111]]
    assert tok._grouped_merges is not None
    tok.train(b"lolo lolo", 257, backend="oracle")
    assert tok._grouped_merges is None
    assert tok.encode_batch([b"lolo"]) == [[256, 256]]
    (tmp_path / "m.txt").write_text("104,101,256\n")
    tok.load_merges(tmp_path / "m.txt")
    assert tok._grouped_merges is None
    assert tok.encode_batch([b"hello"]) == [[256, 108, 108, 111]]
