"""Guards of the port: it imports without jax, without zigbpe_tpu and
without nvcc, and a request for CUDA on a machine without a card raises
instead of running on the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from zigbpe_tpu_torch import BasicTokenizer, train
from zigbpe_tpu_torch.ops import core
from zigbpe_tpu_torch.ops.kernels import copy as kcopy
from zigbpe_tpu_torch.ops.kernels import count as kcount
from zigbpe_tpu_torch.ops.kernels import encode as kencode
from zigbpe_tpu_torch.ops.kernels import hist as khist
from zigbpe_tpu_torch.ops.kernels import lowering as klow
from zigbpe_tpu_torch.ops.kernels import merge as kmerge
from zigbpe_tpu_torch.ops.kernels import opmix as kopmix

REPO = Path(__file__).resolve().parents[1]
MODULES = [
    "zigbpe_tpu_torch", "zigbpe_tpu_torch.cli", "zigbpe_tpu_torch.train",
    "zigbpe_tpu_torch.models.basic_tokenizer", "zigbpe_tpu_torch.models.oracle",
    "zigbpe_tpu_torch.models.numpy_backend", "zigbpe_tpu_torch.ops.core",
    "zigbpe_tpu_torch.ops.encode_batch", "zigbpe_tpu_torch.ops.kernels.encode",
    "zigbpe_tpu_torch.ops.kernels", "zigbpe_tpu_torch.ops.kernels._build",
    "zigbpe_tpu_torch.ops.kernels.merge", "zigbpe_tpu_torch.utils.serde",
    "zigbpe_tpu_torch.utils.profiling", "zigbpe_tpu_torch.utils.fileio",
    "zigbpe_tpu_torch.utils.state", "zigbpe_tpu_torch.ops.kernels.copy",
    "zigbpe_tpu_torch.probes", "zigbpe_tpu_torch.probes.__main__",
    "zigbpe_tpu_torch.probes.budget", "zigbpe_tpu_torch.probes.floor",
    "zigbpe_tpu_torch.probes.pipeline", "zigbpe_tpu_torch.ops.kernels.opmix",
    "zigbpe_tpu_torch.ops.kernels.hist", "zigbpe_tpu_torch.ops.kernels.lowering",
    "zigbpe_tpu_torch.probes.alu16", "zigbpe_tpu_torch.probes.hist",
    "zigbpe_tpu_torch.probes.lowering", "zigbpe_tpu_torch.utils.checkpoint",
    "zigbpe_tpu_torch.gui", "zigbpe_tpu_torch.gui.app", "zigbpe_tpu_torch.parallel",
    "zigbpe_tpu_torch.parallel.train_dp", "zigbpe_tpu_torch.parallel.multihost",
    "zigbpe_tpu_torch.native", "zigbpe_tpu_torch.native.fastio", "zigbpe_tpu_torch.probes.seed",
    "zigbpe_tpu_torch.bench", "zigbpe_tpu_torch.measure", "zigbpe_tpu_torch.scripts",
    "zigbpe_tpu_torch.scripts.run_config2",
    "zigbpe_tpu_torch.scripts.run_config3", "zigbpe_tpu_torch.probes.breakdown",
    "zigbpe_tpu_torch.probes.encode", "zigbpe_tpu_torch.probes.select_batch",
    "zigbpe_tpu_torch.ops.kernels.count",
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


def test_cli_train_dp_runs_without_jax_or_reference_package(tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"hello world hello " * 20)
    out = tmp_path / "merges.txt"
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['zigbpe_tpu'] = None\n"
        "from zigbpe_tpu_torch import cli\n"
        f"rc = cli.main(['train', {str(corpus)!r}, '--vocab', '270', '--out', {str(out)!r},\n"
        "               '--backend', 'dp', '--device', 'cpu'])\n"
        "assert rc == 0\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'zigbpe_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    assert len(out.read_text().split()) == 14


def test_kernel_module_imports_without_nvcc(tmp_path):
    env = {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path / "none"),
           "PYTHONPATH": str(REPO)}
    code = (
        "from zigbpe_tpu_torch.ops.kernels import _build, copy, encode, merge\n"
        "from zigbpe_tpu_torch.ops.kernels import count, hist, lowering, opmix\n"
        "import zigbpe_tpu_torch.probes.__main__\n"
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


def test_data_parallel_entry_points_default_to_the_card(tmp_path):
    """train_dp, train_from_files and a multi-process initialize run on
    the card unless asked otherwise: without a card they raise, before any
    process group is made."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from zigbpe_tpu_torch.parallel import multihost, train_dp

    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"hello hello")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_dp.train_dp(b"hello hello", 300)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        multihost.train_from_files([str(corpus)], 300)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        multihost.initialize("127.0.0.1:1", 2, 0)
    assert not torch.distributed.is_initialized()


def test_train_defaults_to_the_card():
    """train.train runs on the card unless asked otherwise, as the JAX
    package's runs on its default accelerator: without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train.train(b"hello hello", 300)


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


def _launches(wrapper):
    return getattr(kcopy, wrapper, getattr(kmerge, wrapper, None)).launches


@pytest.mark.parametrize("wrapper", ["merge_pass_ablated", "copy_blocks", "copy_carry",
                                     "copy_peek"])
def test_probe_kernels_on_a_non_cpu_tensor_never_run_the_twin(wrapper):
    before = _launches(wrapper)
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "merge_pass_ablated":
            kmerge.merge_pass_ablated(
                torch.full((256,), -1, dtype=torch.int32, device="meta"),
                torch.tensor([[97, 98, 256]], dtype=torch.int32, device="meta"), "copy")
        else:
            getattr(kcopy, wrapper)(torch.zeros((16, 128), dtype=torch.int32,
                                                device="meta"), 8)
    assert _launches(wrapper) == before


@pytest.mark.parametrize("variant,n,match", [
    ("nofull", 256, "unknown variant"),
    ("FULL", 256, "unknown variant"),
    ("copy", 200, "multiple of 128"),
])
def test_merge_pass_ablated_rejects_bad_arguments(variant, n, match):
    tokens = torch.full((n,), -1, dtype=torch.int32)
    table = torch.tensor([[97, 98, 256]], dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        kmerge.merge_pass_ablated(tokens, table, variant)


@pytest.mark.parametrize("wrapper", ["copy_blocks", "copy_carry", "copy_peek"])
@pytest.mark.parametrize("shape,dtype,R,match", [
    ((16, 128), torch.int64, 8, "int32 or int16"),
    ((16, 128), torch.uint8, 8, "int32 or int16"),
    ((16, 64), torch.int32, 8, r"\(rows, 128\)"),
    ((2048,), torch.int32, 8, r"\(rows, 128\)"),
    ((16, 128), torch.int32, 3, "multiple of rows_per_block"),
    ((16, 128), torch.int16, 0, "multiple of rows_per_block"),
    ((0, 128), torch.int32, 8, "multiple of rows_per_block"),
])
def test_copy_kernels_reject_bad_arguments(wrapper, shape, dtype, R, match):
    with pytest.raises(ValueError, match=match):
        getattr(kcopy, wrapper)(torch.zeros(shape, dtype=dtype), R)


def test_copy_peek_needs_eight_rows():
    with pytest.raises(ValueError, match="8 rows"):
        kcopy.copy_peek(torch.zeros((4, 128), dtype=torch.int32), 4)


@pytest.mark.parametrize("rows,R", [(24, 12), (12, 4), (20, 20)])
def test_copy_peek_needs_eight_row_blocks(rows, R):
    with pytest.raises(ValueError, match="multiples of 8"):
        kcopy.copy_peek(torch.zeros((rows, 128), dtype=torch.int32), R)


def test_ablation_masks_match_the_kernel_source():
    """ops/kernels/merge.py's ABL_* bits are csrc/merge.cu's, and every
    variant's mask is one the kernel's entry dispatches."""
    src = (REPO / "zigbpe_tpu_torch" / "csrc" / "merge.cu").read_text()
    cu = {m[0]: int(m[1]) for m in re.findall(r"constexpr unsigned (ABL_\w+) = (\d+);", src)}
    assert cu == {k: v for k, v in vars(kmerge).items() if k.startswith("ABL_")}
    cases = re.findall(r"case ([A-Z_| 0-9]+):", src)
    masks = {sum(cu[t.strip()] if t.strip() in cu else int(t) for t in c.split("|"))
             for c in cases}
    assert masks == set(kmerge.VARIANTS.values())


def test_probe_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from zigbpe_tpu_torch.probes import __main__ as probes_main

    with pytest.raises(RuntimeError, match="cuda"):
        probes_main.main(["floor"])


def _meta(shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype, device="meta")


NEW_PROBE_CALLS = {
    "opmix": (kopmix.opmix, lambda: kopmix.opmix(_meta((16, 128)), 8, 4)),
    "onehot_hist": (khist.onehot_hist,
                    lambda: khist.onehot_hist(_meta((16, 128)), 8, 512, 8, 7, True)),
    "rows_to_column": (klow.rows_to_column, lambda: klow.rows_to_column(_meta((32, 128)))),
    "transpose": (klow.transpose, lambda: klow.transpose(_meta((32, 128)))),
    "iota_mod_add": (klow.iota_mod_add, lambda: klow.iota_mod_add(_meta((32, 128)), 4)),
    "dot_tn": (klow.dot_tn, lambda: klow.dot_tn(_meta((256, 128), torch.bfloat16),
                                                _meta((256, 128), torch.bfloat16))),
    "onehot_dot": (klow.onehot_dot, lambda: klow.onehot_dot(_meta((4096, 1)))),
}


@pytest.mark.parametrize("name", sorted(NEW_PROBE_CALLS))
def test_new_probe_kernels_on_a_non_cpu_tensor_never_run_the_twin(name):
    wrapper, call = NEW_PROBE_CALLS[name]
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert wrapper.launches == before


@pytest.mark.parametrize("shape,dtype,R,reps,match", [
    ((16, 128), torch.int64, 8, 4, "int32 or int16"),
    ((16, 64), torch.int32, 8, 4, r"\(rows, 128\)"),
    ((16, 128), torch.int32, 3, 4, "multiple of rows_per_block"),
    ((16, 128), torch.int16, 8, -1, "reps must be >= 0"),
    ((16, 128), torch.int32, 8, -4, "reps must be >= 0"),
])
def test_opmix_rejects_bad_arguments(shape, dtype, R, reps, match):
    with pytest.raises(ValueError, match=match):
        kopmix.opmix(torch.zeros(shape, dtype=dtype), R, reps)


@pytest.mark.parametrize("shape,dtype,R,V,S,dmod,match", [
    ((16, 128), torch.int16, 8, 512, 8, 7, "int32"),
    ((16, 128), torch.int32, 3, 512, 1, 7, "multiple of rows_per_block"),
    ((16, 128), torch.int32, 8, 512, 3, 7, "sub_rows 3 must divide"),
    ((192, 128), torch.int32, 192, 512, 192, 7, "at most 96"),
    ((16, 128), torch.int32, 8, 4609, 8, 7, r"vocab must be in \[1, 4608\]"),
    ((16, 128), torch.int32, 8, 0, 8, 7, "vocab must be in"),
    ((16, 128), torch.int32, 8, 512, 8, -7, "density_mod"),
])
def test_onehot_hist_rejects_bad_arguments(shape, dtype, R, V, S, dmod, match):
    with pytest.raises(ValueError, match=match):
        khist.onehot_hist(torch.zeros(shape, dtype=dtype), R, V, S, dmod, False)


@pytest.mark.parametrize("call,match", [
    (lambda: klow.rows_to_column(torch.zeros((32, 128), dtype=torch.int16)), "int32"),
    (lambda: klow.transpose(torch.zeros((4096,), dtype=torch.int32)), "2-d int32"),
    (lambda: klow.iota_mod_add(torch.zeros((32, 128), dtype=torch.int32), 0), "m must be"),
    (lambda: klow.dot_tn(torch.ones((256, 128)), torch.ones((256, 128))), "bf16"),
    (lambda: klow.dot_tn(torch.ones((24, 16), dtype=torch.bfloat16),
                         torch.ones((24, 16), dtype=torch.bfloat16)), "multiple of 16"),
    (lambda: klow.onehot_dot(torch.zeros((4096,), dtype=torch.int32)), r"\(n, 1\)"),
    (lambda: klow.onehot_dot(torch.zeros((4008, 1), dtype=torch.int32)), "multiple of 16"),
])
def test_lowering_kernels_reject_bad_arguments(call, match):
    with pytest.raises(ValueError, match=match):
        call()


# ------------------------------------------------- the launch path on Entry

import ctypes  # noqa: E402

from zigbpe_tpu_torch.ops.kernels import _build  # noqa: E402

ENTRY_MODULES = {"copy": kcopy, "count": kcount, "encode": kencode, "hist": khist,
                 "merge": kmerge, "opmix": kopmix}
CTYPES = {"long long": ctypes.c_longlong, "int": ctypes.c_int}


def _c_entries(name: str) -> dict:
    """{symbol: ctypes of its parameters} of the int-returning entries of
    csrc/<name>.cu: pointers as c_void_p, ``long long`` and ``int``."""
    src = (REPO / "zigbpe_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    out = {}
    for symbol, params in re.findall(r"\nint (zbpe_\w+)\(([^)]*)\)", src):
        types = [re.sub(r"\s*\w+$", "", p.strip()).replace("const ", "") for p in params.split(",")]
        out[symbol] = tuple(ctypes.c_void_p if t.endswith("*") else CTYPES[t] for t in types)
    return out


def _entries(module) -> list:
    return [v for v in vars(module).values() if isinstance(v, _build.Entry)]


@pytest.mark.parametrize("name", sorted(ENTRY_MODULES))
def test_wrapper_modules_launch_through_entry(name):
    """No wrapper module enters a device context or builds a Stream per
    launch: each launches through _build.Entry, whose argument types are
    its C entry's (the stream last)."""
    src = (REPO / "zigbpe_tpu_torch" / "ops" / "kernels" / f"{name}.py").read_text()
    for piece in ("torch.cuda.device", "current_stream", "cuda_stream", "getattr(lib"):
        assert piece not in src, piece
    entries = _entries(ENTRY_MODULES[name])
    declared = _c_entries(name)
    assert entries and all(e.name == name for e in entries)
    for e in entries:
        assert (*e.argtypes, ctypes.c_void_p) == declared[e.symbol], e.symbol


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def _meta(shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _wrapper_calls(device):
    """(name, wrapper, call) of every wrapper of the six modules, on
    inputs on ``device`` at small shapes."""
    t = lambda shape, dtype=torch.int32: torch.zeros(shape, dtype=dtype, device=device)  # noqa
    table = torch.tensor([[97, 98, 256]], dtype=torch.int32, device=device)
    gt, gl = _grouped([[97, 98, 256]])
    return [
        ("copy_blocks", kcopy.copy_blocks, lambda: kcopy.copy_blocks(t((16, 128)), 8)),
        ("copy_carry", kcopy.copy_carry, lambda: kcopy.copy_carry(t((16, 128), torch.int16), 8)),
        ("copy_peek", kcopy.copy_peek, lambda: kcopy.copy_peek(t((16, 128)), 8)),
        ("onehot_hist", khist.onehot_hist,
         lambda: khist.onehot_hist(t((16, 128)), 8, 512, 8, 7, True)),
        ("opmix", kopmix.opmix, lambda: kopmix.opmix(t((16, 128), torch.int16), 8, 4)),
        ("merge_pass_multi", kmerge.merge_pass_multi,
         lambda: kmerge.merge_pass_multi(t((256,)), table)),
        ("merge_pass_ablated", kmerge.merge_pass_ablated,
         lambda: kmerge.merge_pass_ablated(t((256,)), table, "nokills")),
        ("encode_rows_grouped", kencode.encode_rows_grouped,
         lambda: kencode.encode_rows_grouped(t((2, 1024)), gt.to(device), gl.to(device))),
        ("count_queries", kcount.count_queries,
         lambda: kcount.count_queries(t((4097,)), t((105,), torch.int64))),
    ]


def _stub_entries(monkeypatch) -> _Recorder:
    """Every Entry of the six modules records its calls instead of
    launching; the current device is -1, a CPU tensor's get_device()."""
    rec = _Recorder()
    for module in ENTRY_MODULES.values():
        for e in _entries(module):
            monkeypatch.setattr(e, "fn", lambda *a, e=e: rec((e.symbol, e.argtypes), *a))
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: -1, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 4242, raising=False)
    monkeypatch.setattr(kmerge, "_work_ints", lambda n: 9 * (n // 4096 + 1))
    return rec


@pytest.mark.parametrize("index", range(9))
def test_a_meta_tensor_raises_before_any_launch(monkeypatch, index):
    rec = _stub_entries(monkeypatch)
    name, wrapper, call = _wrapper_calls("meta")[index]
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert wrapper.launches == before and rec.calls == [], name


@pytest.mark.parametrize("index", range(9))
def test_wrappers_pass_the_argument_types_their_c_entry_declares(monkeypatch, index):
    """With the launch stubbed and a CPU tensor taken for a card's, each
    wrapper makes one launch whose arguments ctypes converts to what the C
    entry declares: pointers, 64-bit sizes and 32-bit ints in range, the
    raw stream last; and its counter counts it."""
    rec = _stub_entries(monkeypatch)
    monkeypatch.setattr(_build, "on_card", lambda x, name: True)
    name, wrapper, call = _wrapper_calls("cpu")[index]
    before = wrapper.launches
    call()
    assert wrapper.launches == before + 1, name
    assert len(rec.calls) == 1
    (symbol, argtypes), *args = rec.calls[0]
    declared = _c_entries(symbol.split("_")[1])[symbol]  # zbpe_<source>_...
    assert (*argtypes, ctypes.c_void_p) == declared and len(args) == len(declared)
    assert args[-1] == 4242  # the raw stream of the current device
    for t, v in zip(declared, args):
        assert type(v) is int, (name, t, v)
        lo, hi = {ctypes.c_int: (-2**31, 2**31), ctypes.c_longlong: (-2**63, 2**63),
                  ctypes.c_void_p: (1, 2**64)}[t]
        assert lo <= v < hi, (name, t, v)
