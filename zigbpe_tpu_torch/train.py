"""Training driver: the host loop around the device chunk loop.

Counterpart of ``zigbpe_tpu/train.py`` (lazy-selection path). The device
does the hot work (selection, merge, compaction) in chunks of rounds; the
host orchestrates chunk calls, the optional verbose printing (reference
format, basic_tokenizer.zig:308-317) and the *shrink schedule*: as the
corpus compacts, the padded capacity halves between chunks so later rounds
touch proportionally less device memory.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .ops import core
from .utils.profiling import TimeStats

Merge = Tuple[int, int, int]

# Shrink floor, kept equal to the JAX trainer's so capacities, shrink steps
# and recompaction points match it; every capacity stays a multiple of the
# 128-token row the merge kernel takes.
MIN_CAPACITY = 32768

# Above this vocab size the dense V^2 upper-bound table gets expensive; the
# JAX trainer switches to sort-based selection there (not yet ported).
LAZY_VOCAB_MAX = 8192

_NOT_PORTED = "not ported to zigbpe_tpu_torch yet; see ROADMAP.md (Queue 1)"


def _round_capacity(n: int) -> int:
    cap = MIN_CAPACITY
    while cap < n:
        cap *= 2
    return cap


def upload(data: bytes, device, stats: Optional[TimeStats] = None):
    """Host->device staging only: returns (tokens, length) of the byte
    corpus on ``device`` at the trainer's capacity."""
    with (stats or TimeStats.null()).phase("initial_tokens", device):
        return core.pad_tokens(data, _round_capacity(len(data)), device)


def train(
    data: bytes,
    vocab_size: int,
    verbose: bool = False,
    chunk_rounds: int = 64,
    shrink: bool = True,
    stats: Optional[TimeStats] = None,
    checkpoint_dir: Optional[str] = None,
    detailed_stats: bool = False,
    merge_group: Optional[int] = None,
    device="cuda",
) -> List[Merge]:
    """Train a BPE merge table on ``device`` (the card unless the caller
    asks for the CPU); exact reference semantics
    (basic_tokenizer.zig:140-205). Returns the ordered merge list."""
    if vocab_size < core.VOCAB_START:
        raise ValueError(f"vocab_size must be >= 256, got {vocab_size}")
    if vocab_size > 0x10000:
        raise ValueError(f"vocab_size must fit u16, got {vocab_size}")
    if vocab_size > LAZY_VOCAB_MAX:
        raise NotImplementedError(
            f"vocab_size > {LAZY_VOCAB_MAX} (sort-based selection) is {_NOT_PORTED}"
        )
    if checkpoint_dir:
        raise NotImplementedError(f"checkpoint_dir is {_NOT_PORTED}")
    if detailed_stats:
        raise NotImplementedError(f"detailed_stats is {_NOT_PORTED}")
    dev = core.resolve_device(device)
    if vocab_size == core.VOCAB_START or len(data) < 2:
        return []
    tokens, length = upload(data, dev, stats)
    return train_device(
        tokens, length, vocab_size, verbose=verbose, chunk_rounds=chunk_rounds,
        shrink=shrink, stats=stats, merge_group=merge_group,
    )


def train_device(
    tokens: torch.Tensor,
    length: int,
    vocab_size: int,
    *,
    verbose: bool = False,
    chunk_rounds: int = 64,
    shrink: bool = True,
    stats: Optional[TimeStats] = None,
    select_batch: Optional[int] = None,
    merge_group: Optional[int] = None,
) -> List[Merge]:
    """Run the training chunk loop on a device-resident byte corpus (see
    :func:`upload`); the compute path of :func:`train`. ``tokens`` is
    consumed (rewritten in place by the merge passes)."""
    stats = stats or TimeStats.null()
    dev = tokens.device
    M = vocab_size - core.VOCAB_START
    if merge_group is None:
        merge_group = 4  # tuned on another machine; awaits a measurement on the card
    capacity = tokens.shape[0]
    merges = torch.full((M, 3), core.PAD, dtype=torch.int32, device=dev)
    occupancy = torch.zeros((M,), dtype=torch.int32, device=dev)
    with stats.phase("count_pairs", dev):
        ub = core.pair_histogram(tokens, vocab_size)

    k = 0
    while k < M and length >= 2:
        rounds = min(chunk_rounds, M - k)
        with stats.phase("merge_rounds", dev):
            if select_batch is None:
                # deep tables churn many near-top stale bounds per round, so
                # verify more entries per pass, wider still on small streams
                # (tuned on another machine; awaits a measurement on the card)
                sb_chunk = 8 if vocab_size <= 1024 else (32 if capacity <= 2**24 else 16)
            else:
                sb_chunk = select_batch
            prev_k = k
            tokens, length, ub, merges, occupancy, k, needs_compact = core.train_chunk_lazy(
                tokens, length, ub, merges, occupancy, k, vocab_size=vocab_size,
                max_rounds=rounds, select_batch=sb_chunk, merge_group=merge_group,
            )

        if verbose:
            mg = merges[prev_k:k].tolist()
            oc = occupancy[prev_k:k].tolist()
            for j in range(k - prev_k):
                # exact reference format (basic_tokenizer.zig:308-317)
                print(
                    f"merge {prev_k + j + 1}/{M}: ({mg[j][0]},{mg[j][1]}) -> "
                    f"{mg[j][2]} had {oc[j]} occurrences"
                )

        # Shrink: halve the padded capacity while the valid tokens fit. The
        # row-local layout is globally recompacted first (also when a row
        # drained, needs_compact).
        want_shrink = shrink and capacity > MIN_CAPACITY and length <= capacity // 2
        if needs_compact or want_shrink:
            tokens, _ = core.compact_stream(tokens)
        if want_shrink:
            while capacity > MIN_CAPACITY and length <= capacity // 2:
                capacity //= 2
            tokens = tokens[:capacity].clone()

    if k < M and length < 2:
        # reference early-stop notice (basic_tokenizer.zig:188-191)
        print("No more pairs to merge. Stopping early.")
    return [tuple(row) for row in merges[:k].tolist()]
