"""Batched padded-sequence encode — the serving path's plain formulation.

Counterpart of ``zigbpe_tpu/ops/encode_batch.py``: a [B, L] batch of
PAD-padded rows, one document each; each merge of the table is one
vectorised leftmost-greedy pass over the whole batch (rows are
independent), replayed in table order. Compaction is stable, by ``cumsum``
destinations and a ``scatter`` (``kernels.compact_rows``). Rows
that the encode kernel's shape rule takes go through
``kernels.encode.encode_rows_grouped`` instead (``BasicTokenizer.encode_batch``).
"""

from __future__ import annotations

import numpy as np
import torch

from .core import PAD, resolve_device
from .kernels import compact_rows
from .kernels.encode import parity_hits, shift_left


def pad_batch(docs, length: int | None = None, device="cpu"):
    """List of byte strings -> (int32[B, L] PAD-padded, int32[B] lengths)
    on ``device``. The bytes cross to the device as uint8 and widen to int32
    there."""
    B = len(docs)
    L = max(length or max((len(d) for d in docs), default=1), 1)
    lens = np.asarray([len(d) for d in docs], np.int32)
    for i, n in enumerate(lens):
        if n > L:
            raise ValueError(f"doc {i} length {n} exceeds row length {L}")
    dev = resolve_device(device)
    tokens = torch.full((B, L), PAD, dtype=torch.int32, device=dev)
    lengths = torch.from_numpy(lens).to(dev)
    flat = b"".join(bytes(d) for d in docs)
    if flat:
        raw = torch.frombuffer(bytearray(flat), dtype=torch.uint8).to(dev)
        tokens[torch.arange(L, device=dev) < lengths[:, None]] = raw.to(torch.int32)
    return tokens, lengths


def batch_merge_pass(tokens: torch.Tensor, first: int, second: int,
                     new_token: int) -> torch.Tensor:
    """One leftmost-greedy pass of one merge over every row of a [B, L]
    batch (reference basic_tokenizer.zig:207-232 semantics per row)."""
    nxt = shift_left(tokens)
    cand = (nxt >= 0) & (tokens == first) & (nxt == second)
    hit = parity_hits(cand) if first == second else cand
    written = torch.where(hit, new_token, tokens)
    killed = torch.zeros_like(hit)
    killed[:, 1:] = hit[:, :-1]
    return compact_rows(written, (tokens >= 0) & ~killed)


def encode_batch(tokens: torch.Tensor, merges):
    """Replay the (M, 3) merge table over a [B, L] batch; rows of the table
    with a negative new token are no-ops. Returns (tokens, lengths) with
    rows prefix-compacted; ``tokens`` is not modified."""
    rows = merges.tolist() if isinstance(merges, torch.Tensor) else merges
    for first, second, new_token in rows:
        if new_token >= 0:
            tokens = batch_merge_pass(tokens, int(first), int(second), int(new_token))
    return tokens, (tokens >= 0).sum(1, dtype=torch.int32)
