"""ctypes binding for the native host runtime (``fastio.cpp``).

Counterpart of ``zigbpe_tpu/native/fastio.py``, with the same public
functions and results. The library is compiled with ``g++`` at first use
into the package's build directory (``ops/kernels/_build.BUILD_DIR``),
named after a digest of the source and the flags, so an edited source
builds anew; a library this host cannot load (built on another, as the
build directory travels with a copy of the checkout) is built again.
Processes and threads that build it at once (test workers, ranks started
together, a pool of builds) each compile to a name of their own and move it
into place with ``os.replace``. Without a compiler,
``available()`` is False: ``read_file`` reads in Python, ``byte_pair_hist``
returns None, and ``train`` and ``encode`` raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.kernels import _build

SRC = Path(__file__).with_name("fastio.cpp")
# No -march=native: the build directory travels with a copy of the checkout,
# and a library tuned to one host's CPU could fault on another's.
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
# Read at call time, so a test may build elsewhere.
BUILD_DIR = _build.BUILD_DIR

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

Merge = Tuple[int, int, int]


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    key = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    return Path(BUILD_DIR) / f"libzigbpe_native_{key.hexdigest()[:16]}.so"


def _compile(force: bool) -> Optional[Path]:
    """The library's path, compiled first unless it exists (or ``force``);
    None when it cannot be built."""
    try:
        out = library_path()
        if out.exists() and not force:
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        return None


def build(force: bool = False) -> bool:
    """Compile fastio.cpp unless its library exists (or ``force``). Returns
    success."""
    return _compile(force) is not None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _compile(False)
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:  # built by another host's toolchain
            path = _compile(True)
            if path is None:
                return None
            lib = ctypes.CDLL(str(path))
        P, I32, I64, BYTES = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_char_p
        lib.zbpe_read_file.restype = P
        lib.zbpe_read_file.argtypes = [BYTES, ctypes.POINTER(I64)]
        lib.zbpe_free.restype = None
        lib.zbpe_free.argtypes = [P]
        lib.zbpe_train.restype = I64
        lib.zbpe_train.argtypes = [BYTES, I64, I32, P]
        lib.zbpe_encode.restype = I64
        lib.zbpe_encode.argtypes = [BYTES, I64, P, I64, P]
        lib.zbpe_byte_pair_hist.restype = None
        lib.zbpe_byte_pair_hist.argtypes = [BYTES, I64, P]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def read_file(path) -> bytes:
    """The whole file (in Python when the library is unavailable)."""
    lib = _load()
    if lib is None:
        return Path(path).read_bytes()
    size = ctypes.c_int64()
    buf = lib.zbpe_read_file(os.fsencode(path), ctypes.byref(size))
    if not buf:
        raise OSError(f"failed to read {path}")
    try:
        return ctypes.string_at(buf, size.value)
    finally:
        lib.zbpe_free(buf)


def train(data: bytes, vocab_size: int) -> List[Merge]:
    """Native single-core training; exact reference semantics."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if vocab_size < 256:
        raise ValueError(f"vocab_size must be >= 256, got {vocab_size}")
    data = bytes(data)  # no copy for bytes; c_char_p passes its buffer
    out = np.zeros(3 * max(vocab_size - 256, 1), np.int32)
    k = lib.zbpe_train(data, len(data), vocab_size, out.ctypes.data)
    if k < 0:
        raise ValueError("invalid arguments to native train")
    return [tuple(row) for row in out[: 3 * k].reshape(-1, 3).tolist()]


def byte_pair_hist(data: bytes) -> Optional[np.ndarray]:
    """(256, 256) int32 histogram of adjacent byte pairs (overlaps
    included): the host-side seed of the trainer's upper-bound table.
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    data = bytes(data)
    out = np.empty((256, 256), np.int32)  # the C side zeroes it
    lib.zbpe_byte_pair_hist(data, len(data), out.ctypes.data)
    return out


def encode(data: bytes, merges: Sequence[Sequence[int]]) -> List[int]:
    """Native encode: replay merges in training order."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if not data:
        return []
    table = np.ascontiguousarray(merges, np.int32)
    if len(merges) and (table.ndim != 2 or table.shape[1] != 3):
        raise ValueError(f"merges must be (first, second, new) triples, got shape {table.shape}")
    data = bytes(data)
    out = np.empty(len(data), np.int32)
    n = lib.zbpe_encode(data, len(data), table.ctypes.data, len(merges), out.ctypes.data)
    return out[:n].tolist()
