"""Corpus file I/O: whole-file reads (the reference's readFile analogue,
utils/read_file.zig:3-13), mmap views of large corpora, multi-file corpora
read as one concatenated byte string, and per-host byte ranges for
multi-host loading (each host reads only its contiguous slice).

Counterpart of ``zigbpe_tpu/utils/fileio.py``. Whole-file reads stay in
Python, where the JAX package takes its optional C++ reader: the port's copy
of that reader (``native/fastio.read_file``) took 2.05-2.26x as long as
``Path.read_bytes`` on an H100 host (``python -m zigbpe_tpu_torch.probes
seed``, PERF.md section 5). The results are the same.
"""

from __future__ import annotations

import mmap
import os
import pathlib
from typing import List, Sequence, Tuple


def read_file(path: str | os.PathLike) -> bytes:
    """Whole-file read."""
    return pathlib.Path(path).read_bytes()


def read_file_mmap(path: str | os.PathLike) -> memoryview:
    """Zero-copy mmap view of a corpus file (large-corpus path)."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return memoryview(mm)


def count_text_size(path: str | os.PathLike) -> int:
    """Size of a corpus file in bytes without reading it (the analogue of
    the reference's ``countTextSize``, utils/count_text_size.zig:6-9), for
    capacity planning before upload."""
    return os.path.getsize(path)


def host_slice(total_size: int, host_id: int, host_count: int) -> Tuple[int, int]:
    """Contiguous byte range [start, end) owned by ``host_id`` of
    ``host_count``: the global sequence is the concatenation of the host
    slices, in host order."""
    per = (total_size + host_count - 1) // host_count
    start = min(host_id * per, total_size)
    return start, min(start + per, total_size)


def read_range(paths: Sequence[str | os.PathLike], start: int, end: int) -> bytes:
    """The byte range [start, end) of the concatenation of ``paths``, read
    from disk and nothing else of it."""
    out: List[bytes] = []
    offset = 0
    for p in paths:
        size = os.path.getsize(p)
        lo, hi = max(start - offset, 0), min(end - offset, size)
        if lo < hi:
            with open(p, "rb") as f:
                f.seek(lo)
                out.append(f.read(hi - lo))
        offset += size
    return b"".join(out)


def read_corpus(paths: Sequence[str | os.PathLike],
                host_id: int = 0, host_count: int = 1) -> bytes:
    """Read (this host's slice of) a corpus made of one or more files,
    concatenated in argument order."""
    total = sum(os.path.getsize(p) for p in paths)
    return read_range(paths, *host_slice(total, host_id, host_count))
