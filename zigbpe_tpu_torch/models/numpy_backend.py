"""Vectorized NumPy host backend.

Same observable semantics as the oracle (and the reference), implemented
with C-speed vector ops: bincount pair histogram, argmax with the
deterministic largest-pair tie-break, and a parity-masked greedy merge
pass. Used as the fast host path for small/medium inputs and as the CPU
baseline that ``bench.py`` measures device speedups against.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

VOCAB_START = 256

Merge = Tuple[int, int, int]


def _to_tokens(data: bytes | str) -> np.ndarray:
    if isinstance(data, str):
        data = data.encode("utf-8")
    return np.frombuffer(bytes(data), dtype=np.uint8).astype(np.int32)


def _greedy_mask(toks: np.ndarray, first: int, second: int) -> np.ndarray:
    """Hit mask over pair positions; leftmost-greedy on overlapping runs
    (reference basic_tokenizer.zig:207-232 semantics)."""
    c = (toks[:-1] == first) & (toks[1:] == second)
    if first == second and c.any():
        idx = np.arange(c.size)
        last_zero = np.maximum.accumulate(np.where(c, -1, idx))
        c = c & (((idx - last_zero) % 2) == 1)
    return c


def _apply(toks: np.ndarray, hits: np.ndarray, new_token: int) -> np.ndarray:
    out = toks.copy()
    out[:-1][hits] = new_token
    keep = np.ones(toks.size, dtype=bool)
    keep[1:][hits] = False
    return out[keep]


def merge_pass(toks: np.ndarray, first: int, second: int, new_token: int) -> np.ndarray:
    return _apply(toks, _greedy_mask(toks, first, second), new_token)


def train(data: bytes | str, vocab_size: int, verbose: bool = False) -> List[Merge]:
    """Train a merge table; exact reference semantics, NumPy-vectorized."""
    if vocab_size < VOCAB_START:
        raise ValueError(f"vocab_size must be >= 256, got {vocab_size}")
    toks = _to_tokens(data)
    V = vocab_size
    merges: List[Merge] = []
    for new_id in range(VOCAB_START, vocab_size):
        if toks.size < 2:
            break
        pid = toks[:-1].astype(np.int64) * V + toks[1:]
        if V <= 8192:  # dense bincount (fast path; V^2 fits comfortably)
            counts = np.bincount(pid)
            mx = counts.max()
            top = np.nonzero(counts == mx)[0].max()  # tie-break: larger wins
        else:  # sparse counting: no V^2 allocation, no int32 overflow
            uniq, cnt = np.unique(pid, return_counts=True)
            mx = cnt.max()
            top = uniq[cnt == mx].max()
        ta, tb = int(top) // V, int(top) % V
        if verbose:
            print(
                f"merge {new_id - VOCAB_START + 1}/{vocab_size - VOCAB_START}: "
                f"({ta},{tb}) -> {new_id} had {mx} occurrences"
            )
        merges.append((ta, tb, new_id))
        toks = merge_pass(toks, ta, tb, new_id)
    return merges


def encode(data: bytes | str, merges: Sequence[Merge]) -> List[int]:
    """Replay merges in training order (basic_tokenizer.zig:71-88)."""
    toks = _to_tokens(data)
    for first, second, new_token in merges:
        if toks.size < 2:
            break
        toks = merge_pass(toks, first, second, new_token)
    return toks.tolist()
