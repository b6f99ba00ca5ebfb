"""merges.txt interchange serde.

The reference persists its entire model (the ordered merge list) as ASCII
CSV lines ``first,second,new_token\\n`` in training order
(reference: zig-bpe src/basic_tokenizer.zig:319-348). This module
reproduces that format byte-for-byte; it is the checkpoint/interchange
artifact of the framework.

Unlike the reference's ``deserializeMerges`` (which *appends* to any
pre-existing merge list — a documented quirk we do not replicate, see
SURVEY.md §2.3.9), loading here returns a fresh list.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Sequence, Tuple

Merge = Tuple[int, int, int]


class MergesFormatError(ValueError):
    pass


def dumps(merges: Iterable[Sequence[int]]) -> str:
    """Serialize merges to the exact reference CSV format
    (basic_tokenizer.zig:325-329)."""
    lines = []
    for first, second, new_token in merges:
        lines.append(f"{int(first)},{int(second)},{int(new_token)}\n")
    return "".join(lines)


def loads(text: str) -> List[Merge]:
    """Parse merges CSV (basic_tokenizer.zig:332-348). Each line must be
    three base-10 u16 integers separated by commas."""
    merges: List[Merge] = []
    for lineno, line in enumerate(text.split("\n"), start=1):
        if line == "":
            continue
        parts = line.split(",")
        if len(parts) != 3:
            raise MergesFormatError(f"line {lineno}: expected 3 fields, got {len(parts)}")
        try:
            first, second, new_token = (int(p) for p in parts)
        except ValueError as e:
            raise MergesFormatError(f"line {lineno}: {e}") from e
        for v in (first, second, new_token):
            if not (0 <= v <= 0xFFFF):
                raise MergesFormatError(f"line {lineno}: value {v} out of u16 range")
        merges.append((first, second, new_token))
    return merges


def save(merges: Iterable[Sequence[int]], path: str | os.PathLike) -> None:
    with open(path, "w", newline="") as f:
        f.write(dumps(merges))


def load(path: str | os.PathLike) -> List[Merge]:
    with open(path, "r", newline="") as f:
        return loads(f.read())
