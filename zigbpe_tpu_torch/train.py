"""Training driver: the host loop around the device chunk loop.

Counterpart of ``zigbpe_tpu/train.py``. The device does the hot work
(selection, merge, compaction) in chunks of rounds; the host orchestrates
chunk calls, the optional verbose printing (reference format,
basic_tokenizer.zig:308-317), checkpoints, and the *shrink schedule*: as the
corpus compacts, the padded capacity halves between chunks so later rounds
touch proportionally less device memory.

Up to ``LAZY_VOCAB_MAX`` a chunk runs lazy upper-bound selection
(``core.train_chunk_lazy``); above it, sort-based selection
(``core.train_chunk``). The upper-bound table of a fresh byte corpus is
seeded from the corpus's byte-pair histogram, counted on the host by the
native runtime (``native/fastio``) while the bytes are still in host memory
and placed in the table's low 256 x 256 block; a resumed stream, or a
machine without the native library, seeds it on the device
(``core.pair_histogram``). ``detailed_stats`` trades the chunk loop for a
per-round loop on the same algorithms that times each phase.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .native import fastio
from .ops import core
from .ops.kernels import LAYOUT
from .ops.kernels import merge as kmerge
from .utils.profiling import TimeStats

Merge = Tuple[int, int, int]

# Shrink floor, kept equal to the JAX trainer's so capacities, shrink steps
# and recompaction points match it; every capacity stays a multiple of the
# 128-token row the merge kernel takes.
MIN_CAPACITY = 32768

# Above this vocab size the dense V^2 upper-bound table gets expensive
# (memory and per-pop argmax), so training selects by sorting instead.
LAZY_VOCAB_MAX = 8192


def _round_capacity(n: int) -> int:
    cap = MIN_CAPACITY
    while cap < n:
        cap *= 2
    return cap


def _print_merge(i: int, M: int, a: int, b: int, new: int, count: int) -> None:
    # exact reference format (basic_tokenizer.zig:308-317)
    print(f"merge {i}/{M}: ({a},{b}) -> {new} had {count} occurrences")


def _stage(data: bytes, device, stats: TimeStats):
    with stats.phase("initial_tokens", device):
        return core.pad_tokens(data, _round_capacity(len(data)), device)


def _host_seed(data: bytes, device, stats: TimeStats) -> Optional[torch.Tensor]:
    """The (256, 256) byte-pair histogram of ``data``, counted on the host
    by the native runtime, as int32 on ``device``; None without the native
    library. Timed as ``count_pairs``."""
    with stats.phase("count_pairs", device):
        hist = fastio.byte_pair_hist(data)
        return None if hist is None else torch.from_numpy(hist).to(device)


def upload(data: bytes, device, stats: Optional[TimeStats] = None):
    """Host->device staging only: returns (tokens, length, ub_seed_block)
    of the byte corpus on ``device`` at the trainer's capacity, so callers
    can account staging apart from :func:`train_device`. ``ub_seed_block``
    is the host-counted (256, 256) byte-pair histogram on ``device`` (None
    without the native library), which seeds lazy selection without a
    pass over the stream on the device."""
    stats = stats or TimeStats.null()
    tokens, length = _stage(data, device, stats)
    return tokens, length, _host_seed(data, device, stats)


def _place_byte_hist(block: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """The flat V*V upper-bound table seeded from a (256, 256) byte-pair
    histogram: a raw byte stream only populates the low block."""
    V = vocab_size
    ub = torch.zeros((V, V), dtype=torch.int32, device=block.device)
    ub[:256, :256] = block
    return ub.view(V * V)


def train(
    data: bytes,
    vocab_size: int,
    verbose: bool = False,
    chunk_rounds: int = 64,
    shrink: bool = True,
    stats: Optional[TimeStats] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every_chunks: int = 4,
    resume: bool = True,
    detailed_stats: bool = False,
    merge_group: Optional[int] = None,
    device="cuda",
) -> List[Merge]:
    """Train a BPE merge table on ``device`` (the card unless the caller
    asks for the CPU); exact reference semantics
    (basic_tokenizer.zig:140-205). Returns the ordered merge list.

    With ``checkpoint_dir`` set, a resumable checkpoint (merges.txt plus
    the residual token stream, the JAX package's format) is written every
    ``checkpoint_every_chunks`` chunks, and with ``resume`` training
    resumes from one found there. ``detailed_stats`` runs the instrumented
    per-round loop (see :func:`train_device`).
    """
    if vocab_size < core.VOCAB_START:
        raise ValueError(f"vocab_size must be >= 256, got {vocab_size}")
    if vocab_size > 0x10000:
        raise ValueError(f"vocab_size must fit u16, got {vocab_size}")
    dev = core.resolve_device(device)
    M = vocab_size - core.VOCAB_START
    if M == 0 or len(data) < 2:
        return []

    stats = stats or TimeStats.null()
    state = {}
    if checkpoint_dir and resume:
        from .utils import checkpoint as ckpt

        if ckpt.exists(checkpoint_dir):
            start_merges, start_tokens, ck_vocab, start_occ = ckpt.load(checkpoint_dir)
            if ck_vocab != vocab_size:
                raise ValueError(
                    f"checkpoint vocab_size {ck_vocab} != requested {vocab_size}"
                )
            if len(start_merges) > M:
                raise ValueError("checkpoint has more merges than target vocab")
            k = len(start_merges)
            with stats.phase("initial_tokens", dev):
                tokens, length = core.pad_token_ids(
                    start_tokens, _round_capacity(start_tokens.size), dev)
                merges = torch.full((M, 3), core.PAD, dtype=torch.int32, device=dev)
                occupancy = torch.zeros((M,), dtype=torch.int32, device=dev)
                if k:
                    merges[:k] = torch.tensor(start_merges, dtype=torch.int32)
                occ = torch.from_numpy(np.asarray(start_occ, np.int32))
                occupancy[: occ.numel()] = occ
            state = {"merges": merges, "occupancy": occupancy, "k": k}
    if not state:
        tokens, length = _stage(data, dev, stats)
        if vocab_size <= LAZY_VOCAB_MAX:
            # With detailed_stats the detailed loop ignores this seed: it is
            # counted there only so the phases match the JAX trainer's.
            state["ub_seed_block"] = _host_seed(data, dev, stats)
    return train_device(
        tokens, length, vocab_size, **state, verbose=verbose, chunk_rounds=chunk_rounds,
        shrink=shrink, stats=stats, checkpoint_dir=checkpoint_dir,
        checkpoint_every_chunks=checkpoint_every_chunks,
        detailed_stats=detailed_stats, merge_group=merge_group,
    )


def train_device(
    tokens: torch.Tensor,
    length: int,
    vocab_size: int,
    *,
    merges: Optional[torch.Tensor] = None,
    occupancy: Optional[torch.Tensor] = None,
    k: int = 0,
    ub_seed_block: Optional[torch.Tensor] = None,
    verbose: bool = False,
    chunk_rounds: int = 64,
    shrink: bool = True,
    stats: Optional[TimeStats] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every_chunks: int = 4,
    detailed_stats: bool = False,
    select_batch: Optional[int] = None,
    merge_group: Optional[int] = None,
) -> List[Merge]:
    """Run the training chunk loop on a device-resident corpus (see
    :func:`upload`), globally compacted; the compute path of :func:`train`.
    ``tokens`` is consumed (rewritten in place by the merge passes). A
    resumed run passes the state so far: ``merges`` (int32[M, 3], PAD
    rows past ``k``), ``occupancy`` (int32[M]) and ``k``. A fresh byte
    corpus may pass ``ub_seed_block``, its (256, 256) byte-pair histogram
    from :func:`upload`, to seed the lazy path's table; without one the
    table is counted from ``tokens`` on the device.

    ``detailed_stats`` switches to an instrumented per-round loop that
    times selection and merge separately (the reference's per-phase
    taxonomy, utils/time_statistics.zig:36-60) at the price of a host sync
    per phase and round; like the JAX trainer's, it writes no checkpoint
    and seeds its table on the device, leaving ``ub_seed_block`` unused.
    """
    dev = tokens.device
    M = vocab_size - core.VOCAB_START
    if merges is None:
        merges = torch.full((M, 3), core.PAD, dtype=torch.int32, device=dev)
    if occupancy is None:
        occupancy = torch.zeros((M,), dtype=torch.int32, device=dev)
    if detailed_stats:
        start = [tuple(row) for row in merges[:k].tolist()]
        return _train_device_instrumented(
            tokens, length, vocab_size, start, stats or TimeStats(), verbose, shrink)

    stats = stats or TimeStats.null()
    if merge_group is None:
        merge_group = 4  # tuned on another machine; awaits a measurement on the card
    capacity = tokens.shape[0]
    lazy = vocab_size <= LAZY_VOCAB_MAX
    if lazy:
        with stats.phase("count_pairs", dev):
            if ub_seed_block is not None:
                ub = _place_byte_hist(ub_seed_block, vocab_size)
            else:
                ub = core.pair_histogram(tokens, vocab_size)

    chunks_done = 0
    while k < M and length >= 2:
        rounds = min(chunk_rounds, M - k)
        prev_k = k
        with stats.phase("merge_rounds", dev):
            if not lazy:
                tokens, length, merges, occupancy, k, needs_compact = core.train_chunk(
                    tokens, length, merges, occupancy, k, vocab_size=vocab_size,
                    max_rounds=rounds, stats=stats,
                )
            else:
                if select_batch is None:
                    # deep tables churn many near-top stale bounds per round, so
                    # verify more entries per pass, wider still on small streams
                    # (tuned on another machine; awaits a measurement on the card)
                    sb_chunk = 8 if vocab_size <= 1024 else (32 if capacity <= 2**24 else 16)
                else:
                    sb_chunk = select_batch
                tokens, length, ub, merges, occupancy, k, needs_compact = core.train_chunk_lazy(
                    tokens, length, ub, merges, occupancy, k, vocab_size=vocab_size,
                    max_rounds=rounds, select_batch=sb_chunk, merge_group=merge_group,
                    stats=stats,
                )

        if verbose:
            for j, ((a, b, new), c) in enumerate(zip(merges[prev_k:k].tolist(),
                                                     occupancy[prev_k:k].tolist())):
                _print_merge(prev_k + j + 1, M, a, b, new, c)

        # Shrink: halve the padded capacity while the valid tokens fit. The
        # row-local layout is globally recompacted first (also when a row
        # drained, needs_compact, and before a checkpoint, which stores the
        # logical stream).
        chunks_done += 1
        ckpt_due = bool(checkpoint_dir) and chunks_done % checkpoint_every_chunks == 0
        want_shrink = shrink and capacity > MIN_CAPACITY and length <= capacity // 2
        if needs_compact or want_shrink or ckpt_due:
            tokens, _ = core.compact_stream(tokens)
        if want_shrink:
            while capacity > MIN_CAPACITY and length <= capacity // 2:
                capacity //= 2
            tokens = tokens[:capacity].clone()
        if ckpt_due:
            from .utils import checkpoint as ckpt

            ckpt.save(
                checkpoint_dir, [tuple(row) for row in merges[:k].tolist()],
                tokens[:length].cpu().numpy(), vocab_size, occupancy[:k].cpu().numpy(),
            )

    if k < M and length < 2:
        # reference early-stop notice (basic_tokenizer.zig:188-191)
        print("No more pairs to merge. Stopping early.")
    return [tuple(row) for row in merges[:k].tolist()]


def _train_device_instrumented(
    tokens: torch.Tensor, length: int, vocab_size: int, start_merges: List[Merge],
    stats: TimeStats, verbose: bool, shrink: bool,
) -> List[Merge]:
    """Per-round loop with per-phase device timing in the reference's
    taxonomy (utils/time_statistics.zig:36-60), on the production
    algorithms: the ub seed under ``count_pairs`` (lazy path only),
    selection (lazy pop/verify plus bound upkeep, or the sort) under
    ``sort_pairs``, the merge pass under ``replace_pairs``. Each phase
    ends with a device sync, so the split is device time."""
    dev = tokens.device
    V = vocab_size
    M = V - core.VOCAB_START
    merges = list(start_merges)
    capacity = tokens.shape[0]
    lazy = V <= LAZY_VOCAB_MAX
    if lazy:
        with stats.phase("count_pairs", dev):
            ub = core.pair_histogram(tokens, V)
            rowmax = core.rowmax_of(ub, V)
    while len(merges) < M and length >= 2:
        new_id = core.VOCAB_START + len(merges)
        with stats.phase("sort_pairs", dev):
            if lazy:
                ta, tb, cnt, ub, rowmax = core.select_top_pair_lazy(
                    ub, tokens, V, layout_block=LAYOUT, rowmax=rowmax, hot=new_id - 1)
            else:
                ta, tb, cnt = torch.stack(
                    core.select_top_pair_sorted(tokens, V, layout_block=LAYOUT)).tolist()
        if cnt == 0:
            break
        with stats.phase("replace_pairs", dev):
            tokens, st = kmerge.merge_pass(tokens, ta, tb, new_id)
            nhits, length, min_kept = st.tolist()
        if lazy:
            with stats.phase("sort_pairs", dev):
                core.update_ub_after_merge(ub, rowmax, ta, tb, new_id, nhits, V)
        merges.append((ta, tb, new_id))
        if verbose:
            _print_merge(len(merges), M, ta, tb, new_id, cnt)
        want_shrink = shrink and capacity > MIN_CAPACITY and length <= capacity // 2
        if min_kept <= 1 or want_shrink:
            tokens, _ = core.compact_stream(tokens)
        if want_shrink:
            while capacity > MIN_CAPACITY and length <= capacity // 2:
                capacity //= 2
            tokens = tokens[:capacity].clone()

    if len(merges) < M and length < 2:
        print("No more pairs to merge. Stopping early.")
    return merges
