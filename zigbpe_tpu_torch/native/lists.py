"""ctypes binding for the serving path's list builder (``lists.cpp``).

``row_lists`` turns a CPU batch of int32 id rows and their lengths into
the ``List[List[int]]`` that ``encode_batch`` returns. The native routine
fills each row's list with references to one shared table of the ints
``0..T-1`` (T the vocabulary's size), so a call allocates one list a row
and no int, and releasing the lists frees no int; an id outside ``[0, T)``
is made anew, so the values are exact whatever the rows hold. The table is a module-level list that
grows to the largest size any caller asks for and is never changed in
place.

The library is compiled with ``g++`` against the interpreter's headers at
first use, into the package's build directory, named after a digest of the
source, the flags and the interpreter's ABI, and moved into place with
``os.replace``, as ``fastio`` is. It is loaded with ``ctypes.PyDLL``, so
the interpreter lock is held while it runs. Without a compiler or the
headers, ``available()`` is False and ``row_lists`` takes ``plain_lists``,
one ``tolist`` a row.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from ..ops.kernels import _build

SRC = Path(__file__).with_name("lists.cpp")
# No -march=native, as for fastio: the build directory travels with a copy
# of the checkout.
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
# Read at call time, so a test may build elsewhere.
BUILD_DIR = _build.BUILD_DIR

_lock = threading.Lock()
_lib: Optional[ctypes.PyDLL] = None
_tried = False
_table: List[int] = []


def library_path() -> Path:
    """Where the library of this source, these flags and this interpreter
    lives."""
    key = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
                         + str(sysconfig.get_config_var("SOABI")).encode())
    return Path(BUILD_DIR) / f"libzigbpe_lists_{key.hexdigest()[:16]}.so"


def _compile(force: bool) -> Optional[Path]:
    """The library's path, compiled first unless it exists (or ``force``);
    None when it cannot be built."""
    try:
        out = library_path()
        if out.exists() and not force:
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        include = sysconfig.get_paths()["include"]
        subprocess.run(["g++", *CXX_FLAGS, f"-I{include}", str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        return None


def build(force: bool = False) -> bool:
    """Compile lists.cpp unless its library exists (or ``force``). Returns
    success."""
    return _compile(force) is not None


def _load() -> Optional[ctypes.PyDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _compile(False)
        if path is None:
            return None
        try:
            lib = ctypes.PyDLL(str(path))
        except OSError:  # built by another host's toolchain
            path = _compile(True)
            if path is None:
                return None
            lib = ctypes.PyDLL(str(path))
        P, I64 = ctypes.c_void_p, ctypes.c_int64
        lib.zbpe_lists.restype = ctypes.py_object
        lib.zbpe_lists.argtypes = [P, I64, I64, I64, P, ctypes.py_object, I64, P]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def table(size: int) -> List[int]:
    """The shared list of the ints ``0..n-1``, ``n >= size``. A larger
    size replaces it with a longer list; a list once handed out is never
    changed."""
    global _table
    t = _table
    if len(t) < size:
        t = _table = list(range(size))
    return t


def plain_lists(rows: torch.Tensor, lengths: torch.Tensor) -> List[List[int]]:
    """One ``tolist`` a row: the twin that ``row_lists`` is held to."""
    return [rows[i, :n].tolist() for i, n in enumerate(lengths.tolist())]


def row_lists(rows: torch.Tensor, lengths: torch.Tensor,
              size: int) -> Tuple[List[List[int]], int, int]:
    """``(lists, shared, made)``: row ``i`` of the CPU int32 [B, L]
    ``rows`` up to ``lengths[i]`` as a list of ints, for every row; the ids
    in ``[0, size)``, handed out from the table, and the others, made as
    new ints (every id where the library is unavailable)."""
    if rows.dim() != 2 or rows.dtype != torch.int32 or rows.device.type != "cpu":
        raise ValueError(f"rows must be a CPU int32 [B, L] tensor, got {rows.dtype} "
                         f"{tuple(rows.shape)} on {rows.device}")
    if lengths.shape != rows.shape[:1]:
        raise ValueError(f"lengths of shape {tuple(lengths.shape)} for {rows.shape[0]} rows")
    lib = _load()
    if lib is None:
        lists = plain_lists(rows, lengths)
        return lists, 0, sum(map(len, lists))
    if rows.stride(1) != 1:
        rows = rows.contiguous()
    lens = lengths.to("cpu", torch.int32).contiguous()
    counts = (ctypes.c_int64 * 2)()
    lists = lib.zbpe_lists(rows.data_ptr(), rows.shape[0], rows.shape[1], rows.stride(0),
                           lens.data_ptr(), table(size), size, counts)
    return lists, counts[0], counts[1]
