"""Build the hand-written CUDA kernels in ``csrc/`` at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``_build/`` (named after
a hash of the source and the flags, so an edited source is rebuilt) and
loaded with ctypes. Nothing is built when a module is imported: the first
launch builds, so the package imports on machines without the CUDA toolkit.
:class:`Entry` launches a C entry with what a launch needs and no more, and
:func:`on_card` picks kernel or twin by the tensor's device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are built "
        "at first launch and need the CUDA toolkit"
    )


def build(name: str, flags: tuple[str, ...] = NVCC_FLAGS) -> Path:
    """Compile ``csrc/<name>.cu`` with ``flags`` unless an up-to-date
    library exists. The compiler's output (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside the library as ``.log``. Returns the
    library path."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def library(name: str, flags: tuple[str, ...] = NVCC_FLAGS) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``flags``, built
    on first call."""
    with _lock:
        if (name, flags) not in _libs:
            _libs[name, flags] = ctypes.CDLL(str(build(name, flags)))
        return _libs[name, flags]


def on_card(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (kernel ``name`` launches), False for a CPU
    tensor (its plain twin runs); ValueError for a tensor on any other
    device, so that nothing falls back to the twin."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on CUDA tensors (or its twin on CPU ones); got a tensor "
                     f"on {x.device}")


class Entry:
    """A launch entry of ``csrc/<name>.cu``, called as ``entry(index,
    *args)``: it launches on the current stream of CUDA device ``index``,
    with ``args`` converted by ``argtypes`` and the stream appended, and
    raises RuntimeError when the entry returns a CUDA error.

    The library is built and the ctypes function resolved (argtypes set) at
    the first call, and kept. Per call it reads the device's raw stream
    handle, building no Stream object, and enters a device context only
    when ``index`` is not the current device."""

    __slots__ = ("name", "symbol", "argtypes", "fn")

    def __init__(self, name: str, symbol: str, argtypes):
        self.name, self.symbol, self.argtypes, self.fn = name, symbol, tuple(argtypes), None

    def resolve(self):
        fn = getattr(library(self.name), self.symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [*self.argtypes, ctypes.c_void_p]
        self.fn = fn
        return fn

    def __call__(self, index: int, *args) -> None:
        fn = self.fn if self.fn is not None else self.resolve()
        if index == torch._C._cuda_getDevice():
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        if rc:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc}")
