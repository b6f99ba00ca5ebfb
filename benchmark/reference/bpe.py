"""Plain byte-level BPE in PyTorch: the yardstick the benchmark holds the
tokenizer to. It imports torch alone and shares no code with the program.

Training counts every adjacent pair of the stream, overlaps included, by
sorting the packed pair keys. It takes the largest count and, among equal
counts, the largest (first, second), and replaces that pair left to right,
leftmost first, by the next id. It stops at the target vocabulary or when
fewer than two tokens are left.

Encoding replays a merge list in its order over every document. The
documents travel as one stream with a separator between them that no merge
matches.

Each function also has the control the benchmark's comparison must fail:
``count_dtype=torch.bfloat16`` rounds the pair counts before the largest is
taken, and ``leftmost=False`` applies every occurrence of a pair ``(a, a)``
at once instead of leftmost first.
"""

from __future__ import annotations

import torch

VOCAB_START = 256
SEP = -1
_KEY = 1 << 16  # ids stay below 65536, so a * _KEY + b orders pairs as (a, b)


def merge(stream: torch.Tensor, a: int, b: int, new: int, leftmost: bool = True) -> torch.Tensor:
    """``stream`` (1-D int64) with each occurrence of the pair (a, b) taken
    left to right replaced by ``new``."""
    at = ((stream[:-1] == a) & (stream[1:] == b)).nonzero().squeeze(1)
    if at.numel() == 0:
        return stream
    if a == b and leftmost and at.numel() > 1:
        # in a run of consecutive hits only every other one, from its start, merges
        starts = torch.ones_like(at, dtype=torch.bool)
        starts[1:] = at[1:] != at[:-1] + 1
        run_start = at[starts]
        first = run_start[torch.searchsorted(run_start, at, right=True) - 1]
        at = at[(at - first) % 2 == 0]
    out = stream.clone()
    out[at] = new
    keep = torch.ones_like(stream, dtype=torch.bool)
    keep[at + 1] = False
    return out[keep]


def top_pair(stream: torch.Tensor, count_dtype=None) -> tuple[int, int]:
    """(first, second) of the most frequent adjacent pair, the largest pair
    among equal counts."""
    keys, counts = torch.unique(stream[:-1] * _KEY + stream[1:], sorted=True,
                                return_counts=True)
    if count_dtype is not None:
        counts = counts.to(count_dtype)
    key = int(keys[counts == counts.max()].max())
    return key // _KEY, key % _KEY


def train(data: bytes, vocab_size: int, device="cpu", count_dtype=None) -> list[tuple[int, int, int]]:
    """The ordered merge list that trains ``data`` to ``vocab_size``."""
    stream = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device).long()
    merges = []
    for new in range(VOCAB_START, vocab_size):
        if stream.numel() < 2:
            break
        a, b = top_pair(stream, count_dtype)
        merges.append((a, b, new))
        stream = merge(stream, a, b, new)
    return merges


def encode(docs: list[bytes], merges, device="cpu", leftmost: bool = True) -> list[torch.Tensor]:
    """The ids of each document under ``merges`` (rows of (a, b, new)), as
    int64 tensors on the host."""
    if not docs:
        return []
    raw = torch.frombuffer(bytearray(b"".join(docs)), dtype=torch.uint8).to(device).long()
    lens = torch.tensor([len(d) for d in docs], device=device)
    # one separator after each document
    ends = torch.cumsum(lens, 0) + torch.arange(1, len(docs) + 1, device=device)
    stream = torch.full((int(ends[-1]),), SEP, dtype=torch.int64, device=device)
    is_sep = torch.zeros_like(stream, dtype=torch.bool)
    is_sep[ends - 1] = True
    stream[~is_sep] = raw
    for a, b, new in merges:
        stream = merge(stream, int(a), int(b), int(new), leftmost)
    seps = (stream == SEP).nonzero().squeeze(1).cpu()
    host = stream.cpu()
    out, start = [], 0
    for end in seps.tolist():
        out.append(host[start:end])
        start = end + 1
    return out
