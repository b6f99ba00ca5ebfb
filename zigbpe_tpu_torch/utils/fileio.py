"""Corpus file I/O: whole-file reads (the reference's readFile analogue,
utils/read_file.zig:3-13) and multi-file corpora read as one concatenated
byte string."""

from __future__ import annotations

import os
import pathlib
from typing import Sequence


def read_file(path: str | os.PathLike) -> bytes:
    """Whole-file read."""
    return pathlib.Path(path).read_bytes()


def read_corpus(paths: Sequence[str | os.PathLike]) -> bytes:
    """A corpus made of one or more files, concatenated in argument order."""
    return b"".join(read_file(p) for p in paths)
