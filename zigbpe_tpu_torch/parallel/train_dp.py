"""Data-parallel BPE training on ``torch.distributed``.

Counterpart of ``zigbpe_tpu/parallel/train_dp.py``. The JAX trainer puts one
shard of the corpus on each device of a ``('data',)`` mesh and runs its body
under ``shard_map``; here a shard is a rank of a process group, and the body
runs as ordinary eager code on that rank's device (``cuda:<index>``, or the
CPU when the caller asks for it). ``psum`` is ``all_reduce(SUM)``, and
``pmax`` and ``all_gather`` become all-gathers. With no
process group initialised the trainer runs at world size 1 and its
collectives are the identity (the counterpart of ``data_mesh()`` on a host
with one device). Merges are the single-chip trainer's for any world size:

* Every rank keeps its slice of the stream in the merge kernel's row-local
  layout (``ops/kernels/merge.py``); the global stream is the concatenation
  of the ranks' logical streams.
* **Boundary pairs**: rank d owns the pair (its last valid token, the first
  valid token of the next non-empty rank). Every round ends with one
  all-gather of each rank's ``(hits, length, first, last, layout_bad)``,
  which gives the global hit count and length, the longest shard, the
  recompaction flag, and the next round's halo (the JAX code spends two
  tiny all-gathers on the halo and a ``psum`` on each total).
* **Selection is lazy**, with two layouts of the upper-bound table:
  - vocab <= ``LAZY_VOCAB_MAX``: the table is REPLICATED; every rank pops
    the identical sequence (``core.select_top_pair_lazy``) and candidate
    bins are verified with one ``all_reduce`` of the ranks' exact counts.
  - above it, the table is SHARDED BY ROWS: pops become local top-k plus
    an all-gather of candidate pairs, verified with one ``all_reduce``;
    the global argmax of the refreshed row caches is the lexicographic
    maximum of the ranks' (count, row, column) triples, gathered together
    with the next iteration's candidates. Upkeep after a merge needs one
    row and one column of the table, which ride the round's last
    all-gather.
* **The merge of a shard** is one K = 1 pass of the merge kernel
  (``kmerge.merge_pass``; ``csrc/merge.cu`` on the card, its twin on the
  CPU) when a != b. The boundary pair is decided on the pre-pass stream and
  patched after the pass. An a == b round recompacts the shard to a prefix
  and resolves leftmost-greedy parity on global ranks, with a carry from
  earlier ranks (plain PyTorch, as the JAX package runs it in XLA).
* Every branch and loop exit reads a value that every rank holds alike (a
  gathered or reduced value, or the replicated table), so every rank issues
  the same collectives in the same order.
* Shrink, checkpoints (written by rank 0, in the single-chip trainer's
  files) and resume as in the JAX trainer; the checkpoint's stream is
  gathered to rank 0 only.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import core
from ..ops.core import PAD, VOCAB_START
from ..ops.kernels import LAYOUT
from ..ops.kernels import merge as kmerge
from ..utils.profiling import TimeStats

Merge = Tuple[int, int, int]

# Above this vocab size the replicated dense V^2 table gets expensive (256 MB
# at V = 8192 on every rank); the table is then sharded by rows. Read at
# call time, so a test may lower it.
LAZY_VOCAB_MAX = 8192

# Per-shard capacity floor for the shrink schedule: a multiple of the merge
# kernel's 128-token row.
MIN_SHARD_CAPACITY = 256

# Candidates a rank lists each verify iteration on the row-sharded table,
# and the columns read from each of its first rows to find them.
SHARDED_BATCH = 128
SHARDED_COLS = 8


class DataGroup:
    """The data axis: a ``torch.distributed`` process group with this
    process's rank and the group's size, or world size 1 when no group is
    given and none is initialised (then every collective is the identity).
    ``collectives`` counts the collectives issued."""

    def __init__(self, group=None):
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        if group is None:
            self.rank, self.size = 0, 1
        else:
            self.rank, self.size = dist.get_rank(group), dist.get_world_size(group)
        self.collectives = 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, in place."""
        if self.group is not None:
            self.collectives += 1
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t``, stacked in rank order: [size, *t.shape]. The
        list form of ``dist.all_gather`` exists in every torch this package
        runs on (``all_gather_into_tensor`` is deprecated in newer ones)."""
        if self.group is None:
            return t[None]
        self.collectives += 1
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.stack(parts)

    def gather_to_root(self, t: torch.Tensor):
        """Every rank's ``t`` (equal shapes) as a list on rank 0; None on
        the other ranks."""
        if self.group is None:
            return [t]
        self.collectives += 1
        parts = [torch.empty_like(t) for _ in range(self.size)] if self.rank == 0 else None
        dist.gather(t.contiguous(), parts, dst=dist.get_global_rank(self.group, 0),
                    group=self.group)
        return parts


def data_group(group=None) -> DataGroup:
    """The :class:`DataGroup` of ``group`` (a process group, a DataGroup,
    or None for the default group, or world size 1 without one)."""
    return group if isinstance(group, DataGroup) else DataGroup(group)


def _device(device) -> torch.device:
    """``device`` resolved (a CUDA request without a card raises); a bare
    ``cuda`` means the current CUDA device."""
    dev = core.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# --------------------------------------------------------------------------
# Shard layout
# --------------------------------------------------------------------------


def _shard_capacity(per: int, per_shard_capacity: Optional[int]) -> int:
    if per_shard_capacity is None:
        return max(MIN_SHARD_CAPACITY, 1 << (max(per, 1) - 1).bit_length())
    if per > per_shard_capacity:
        raise ValueError(f"shard slice {per} exceeds capacity {per_shard_capacity}")
    if per_shard_capacity % LAYOUT:
        raise ValueError(f"shard capacity {per_shard_capacity} must be a multiple of {LAYOUT}")
    return per_shard_capacity


def shard_range(n: int, rank: int, size: int,
                per_shard_capacity: Optional[int] = None) -> Tuple[int, int, int]:
    """(start, end, capacity) of rank ``rank`` of ``size`` over a stream of
    ``n`` values: contiguous slices of ceil(n / size), each placed at the
    head of a PAD-tailed buffer of one common capacity."""
    per = -(-n // size)
    cap = _shard_capacity(per, per_shard_capacity)
    start = min(rank * per, n)
    return start, min(start + per, n), cap


def shard_corpus(data: bytes, group=None, device="cuda",
                 per_shard_capacity: Optional[int] = None) -> torch.Tensor:
    """This rank's PAD-tailed piece of a byte corpus on ``device``
    (byte-level init, basic_tokenizer.zig:155-170)."""
    g = data_group(group)
    start, end, cap = shard_range(len(data), g.rank, g.size, per_shard_capacity)
    return core.pad_tokens(memoryview(data)[start:end], cap, _device(device))[0]


def shard_token_ids(ids, group=None, device="cuda",
                    per_shard_capacity: Optional[int] = None) -> torch.Tensor:
    """This rank's piece of a resumed token-id stream. Shard boundaries may
    differ from the checkpointing run's; training does not depend on them."""
    ids = np.asarray(ids, dtype=np.int32)
    g = data_group(group)
    start, end, cap = shard_range(ids.size, g.rank, g.size, per_shard_capacity)
    return core.pad_token_ids(ids[start:end], cap, _device(device))[0]


def shard_corpus_from_files(paths: Sequence, group=None, device="cuda",
                            per_shard_capacity: Optional[int] = None):
    """This rank's piece of a corpus spread over ``paths``, read straight
    from disk: the rank reads its own byte range and nothing else.
    Returns (tokens, total bytes of the corpus)."""
    from ..utils import fileio

    g = data_group(group)
    total = sum(os.path.getsize(p) for p in paths)
    start, end, cap = shard_range(total, g.rank, g.size, per_shard_capacity)
    piece = fileio.read_range(paths, start, end)
    return core.pad_tokens(piece, cap, _device(device))[0], total


# --------------------------------------------------------------------------
# The halo: each rank's (length, first, last)
# --------------------------------------------------------------------------


def _edge(tokens: torch.Tensor) -> torch.Tensor:
    """int64 [length, first valid token, last valid token] of a shard in any
    layout (PAD for the tokens of an empty shard)."""
    valid = (tokens >= 0).to(torch.uint8)
    n = tokens.shape[0]
    first = tokens[valid.argmax()]
    last = tokens[n - 1 - valid.flip(0).argmax()]
    return torch.stack([valid.sum(dtype=torch.int64), first.long(), last.long()])


def _gather_edges(tokens: torch.Tensor, g: DataGroup) -> List[Tuple[int, int, int]]:
    return [tuple(e) for e in g.all_gather(_edge(tokens)).tolist()]


def _neighbours(edges, rank: int):
    """(first token of the next non-empty rank or PAD, last token of the
    previous non-empty rank or None, global offset of this rank's first
    token) from every rank's (length, first, last)."""
    nxt = next((e[1] for e in edges[rank + 1:] if e[0] > 0), PAD)
    prev = next((e[2] for e in reversed(edges[:rank]) if e[0] > 0), None)
    return nxt, prev, sum(e[0] for e in edges[:rank])


def _shard_pair_streams(tokens: torch.Tensor, next_tok: int):
    """(a, b) of a row-local shard with the boundary pair included: the
    shard's tail (its one valid token with no successor in the shard, unique
    while no interior row is empty) pairs with ``next_tok``."""
    a, b = core.pair_streams(tokens, LAYOUT)
    if next_tok >= 0:
        b = torch.where((a >= 0) & (b < 0), next_tok, b)
    return a, b


# --------------------------------------------------------------------------
# Upper-bound table seeds
# --------------------------------------------------------------------------


def init_ub_dp(tokens: torch.Tensor, vocab_size: int, group=None, edges=None) -> torch.Tensor:
    """Replicated upper-bound table: the all-reduced sum of the ranks'
    histograms (flat int32 V*V), boundary pairs counted once."""
    g = data_group(group)
    edges = edges or _gather_edges(tokens, g)
    V = vocab_size
    a, b = _shard_pair_streams(tokens, _neighbours(edges, g.rank)[0])
    pid = torch.where(b >= 0, a.long() * V + b.long(), V * V)
    return g.all_reduce(torch.bincount(pid, minlength=V * V + 1)[: V * V].to(torch.int32))


def init_ub_sharded_dp(tokens: torch.Tensor, vocab_size: int, group=None,
                       max_row: Optional[int] = None, edges=None) -> torch.Tensor:
    """This rank's (Vp / D, V) int32 row block of the row-sharded table (Vp
    rounds V up to a multiple of D; padded rows stay zero). For each row
    block q, every rank counts its pairs whose first token lies in the block
    and the all-reduce lands on rank q. Only rows below ``max_row`` are
    counted (256 for a fresh byte corpus): counts go into an int32 block by
    ``index_put_`` on 64-bit indices, never into a bincount of Rl * V bins,
    which would take 8 GiB at D = 1 and V = 32768."""
    g = data_group(group)
    edges = edges or _gather_edges(tokens, g)
    V, D = vocab_size, g.size
    Rl = -(-V // D)
    max_row = min(max_row or V, V)
    a, b = _shard_pair_streams(tokens, _neighbours(edges, g.rank)[0])
    valid = b >= 0
    out = torch.zeros((Rl, V), dtype=torch.int32, device=tokens.device)
    for q in range(D):
        r0 = q * Rl
        if r0 >= max_row:
            break
        rows = min(Rl, max_row - r0)
        block = (out[:rows] if q == g.rank else out.new_zeros((rows, V))).view(-1)
        sel = valid & (a >= r0) & (a < r0 + rows)
        idx = (a[sel].long() - r0) * V + b[sel].long()
        block.index_put_((idx,), torch.ones_like(idx, dtype=torch.int32), accumulate=True)
        g.all_reduce(block)
    return out


def _host_pair_entries(ids: np.ndarray):
    """Sparse exact pair counts of a host-resident token stream:
    (rows, cols, counts) int64/int64/int32 (overlaps included, reference
    semantics basic_tokenizer.zig:234-278)."""
    ids = np.asarray(ids, dtype=np.int64)
    if ids.size < 2:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int32))
    pid = ids[:-1] * 65536 + ids[1:]
    uniq, counts = np.unique(pid, return_counts=True)
    return uniq >> 16, uniq & 0xFFFF, counts.astype(np.int32)


def _byte_pair_entries(data: bytes):
    """Sparse byte-pair counts of a corpus (the native C++ histogram when
    built, NumPy otherwise): only rows and columns below 256 occur."""
    from ..native import fastio

    block = fastio.byte_pair_hist(data)
    if block is None:
        return _host_pair_entries(np.frombuffer(bytes(data), dtype=np.uint8))
    rows, cols = np.nonzero(block)
    return rows.astype(np.int64), cols.astype(np.int64), block[rows, cols].astype(np.int32)


def _place_entries(rows, cols, counts, *, row0: int, nrows: int, vocab_size: int,
                   device) -> torch.Tensor:
    """The (nrows, V) int32 block of table rows [row0, row0 + nrows) holding
    the host-counted entries that fall in it: they cross to ``device`` and
    are written into a block zeroed there (never a dense table on the host;
    the JAX trainer fills one, 4 GiB at V = 32768)."""
    V = vocab_size
    rows = np.asarray(rows, np.int64)
    mine = (rows >= row0) & (rows < row0 + nrows)
    idx = torch.from_numpy((rows[mine] - row0) * V + np.asarray(cols, np.int64)[mine])
    block = torch.zeros((nrows, V), dtype=torch.int32, device=device)
    block.view(-1).index_put_(
        (idx.to(device),), torch.from_numpy(np.asarray(counts, np.int32)[mine]).to(device))
    return block


def _replicated_ub_from_entries(rows, cols, counts, *, vocab_size: int, device) -> torch.Tensor:
    """The flat V*V int32 replicated table holding host-counted entries."""
    return _place_entries(rows, cols, counts, row0=0, nrows=vocab_size, vocab_size=vocab_size,
                          device=device).view(-1)


def _sharded_ub_from_entries(rows, cols, counts, *, vocab_size: int, group=None,
                             device) -> torch.Tensor:
    """This rank's (Vp / D, V) int32 row block of the row-sharded table
    holding host-counted entries (Vp rounds V up to a multiple of D; padded
    rows stay zero)."""
    g = data_group(group)
    Rl = -(-vocab_size // g.size)
    return _place_entries(rows, cols, counts, row0=g.rank * Rl, nrows=Rl,
                          vocab_size=vocab_size, device=device)


# --------------------------------------------------------------------------
# Selection
# --------------------------------------------------------------------------


def _dp_select_lazy(ub, rm, a, b, vocab_size: int, g: DataGroup, hot: int, batch: int):
    """Lazy batch-verified selection on the replicated table: every rank
    pops the identical sequence; each verify pass counts the candidates on
    the rank's pair streams and all-reduces the int32 counts (integer sums,
    so the argmax and its tie-break do not depend on the world size).
    Returns Python ints (first, second, count); ``ub`` and ``rm`` are
    updated in place."""
    local = core.stream_count_fn(a, b, vocab_size)
    ta, tb, cnt, _, _ = core.select_top_pair_lazy(
        ub, None, vocab_size, batch=batch, rowmax=rm,
        count_fn=lambda pa, pb: g.all_reduce(local(pa, pb)), hot=hot,
    )
    return ta, tb, cnt


def _dp_select_lazy_sharded(u, rm, a, b, vocab_size: int, g: DataGroup, hot: int):
    """Lazy batch-verified selection on the table SHARDED BY ROWS: ``u`` is
    this rank's (Rl, V) row block and ``rm`` its exact per-row maximum.

    Each verify iteration, every rank lists its local candidates: about the
    ``SHARDED_BATCH`` first entries of its block in the order of the
    tie-break, (bound, row, column) descending, taken from the
    ``SHARDED_COLS`` first columns of its ``SHARDED_BATCH`` first rows by
    (row maximum, row). One all-gather shares
    the lists, one all-reduce of local counts verifies them all, and their
    owners write the exact counts and refresh their row caches. The global
    argmax is the lexicographic maximum of the ranks' (count, row, column)
    triples, as the JAX code's three dependent ``pmax`` compute it (one
    all-gather of three scalars). The loop ends when the argmax is a
    verified bin or no pair is left. Pair ids stay two components (V may
    pass 46341).

    The ``hot`` row and column (the token minted last round, whose bounds
    are the stalest) are verified whole in the first iteration: one
    bincount over the rank's pairs that hold the hot token rides the same
    all-reduce, and the owners write them. The JAX function pops the top
    two columns of its 8 top rows by bound alone, plus the hot row's top 2
    and the hot column's best, and runs its loop on the device. Here an
    iteration costs three collectives and host syncs, and deep vocabularies
    hold thousands of bounds tied at the small counts of their last rounds,
    most of them in the hot row and column: on the conformance corpus to
    vocab 1200 at world size 1 the JAX lists need about 50 verify
    iterations a round, these one. The merges do not
    depend on the candidates. Returns Python ints (first, second, count);
    ``u`` and ``rm`` are updated in place."""
    V = vocab_size
    Rl = u.shape[0]
    row0 = g.rank * Rl
    dev = u.device
    local = core.stream_count_fn(a, b, V)
    r_iota = torch.arange(Rl, device=dev)
    c_iota = torch.arange(V, device=dev)
    rows_k, cols_k = min(SHARDED_BATCH, Rl), min(SHARDED_COLS, V)
    batch = min(SHARDED_BATCH, rows_k * cols_k)

    def candidates():
        """[rows, columns] of the local candidates. An entry's key (bound,
        local row, column) is exact in int64: a bound is below 2^31 and
        Rl * V at most 2^32."""
        rows = torch.topk(rm.long() * Rl + r_iota, rows_k).indices
        keys = (u[rows].long() * Rl + rows[:, None]) * V + c_iota
        top = torch.topk(torch.topk(keys, cols_k, dim=1).values.view(-1), batch).values
        return torch.cat([row0 + top // V % Rl, top % V])

    def local_argmax():
        cl = rm.max()
        rl = torch.where(rm == cl, r_iota, -1).max()
        bl = torch.where(u[rl] == cl, c_iota, -1).max()
        return torch.stack([cl.long(), row0 + rl, bl.clamp(min=0)])

    # local counts of the hot row and column, [row, column]
    hr = min(max(hot, 0), V - 1)
    sel = ((b >= 0) & ((a == hr) | (b == hr))).nonzero().flatten()
    sa, sb = a[sel].long(), b[sel].long()
    idx = torch.cat([torch.where(sa == hr, sb, 2 * V), torch.where(sb == hr, sa + V, 2 * V)])
    whole = torch.bincount(idx, minlength=2 * V + 1)[: 2 * V].to(torch.int32)
    while True:
        gathered = g.all_gather(candidates())
        host = gathered.tolist()
        ga, gb = gathered[:, :batch].reshape(-1), gathered[:, batch:].reshape(-1)
        pairs = [(x, y) for h in host for x, y in zip(h[:batch], h[batch:])]
        counts = local(ga, gb)
        if whole is not None:
            counts = g.all_reduce(torch.cat([counts, whole]))
            _write_hot(u, rm, hr, row0, counts[ga.numel():])
            whole = None
        else:
            counts = g.all_reduce(counts)
        own = [i for i, (x, _) in enumerate(pairs) if row0 <= x < row0 + Rl]
        if own:
            idx = torch.tensor(own, device=dev)
            ri = ga[idx] - row0
            u[ri, gb[idx]] = counts[idx]  # duplicates carry equal values
            rm[ri] = u[ri].amax(1)
        mc, ra, cb = max(map(tuple, g.all_gather(local_argmax()).tolist()))
        if mc <= 0 or (ra, cb) in set(pairs) or hr in (ra, cb):
            return ra, cb, max(mc, 0)


def _write_hot(u, rm, hr: int, row0: int, whole: torch.Tensor) -> None:
    """Write the exact row and column ``hr`` (``whole`` = [row, column],
    global counts) into the row block and refresh the row caches. Exact
    counts never exceed their bounds, so a cached maximum can only fall,
    and only in a row whose maximum sat in column hr."""
    Rl, V = u.shape
    row, col = whole[:V], whole[V:]
    n = max(0, min(Rl, V - row0))
    old = u[:, hr].clone()
    u[:n, hr] = col[row0: row0 + n]
    if row0 <= hr < row0 + Rl:
        u[hr - row0] = row
    stale = ((old == rm) & (u[:, hr] < old)).nonzero().flatten()
    if row0 <= hr < row0 + Rl:
        stale = torch.cat([stale, stale.new_tensor([hr - row0])])
    if stale.numel():
        rm[stale] = u[stale].amax(1)


# --------------------------------------------------------------------------
# The merge of one shard
# --------------------------------------------------------------------------


def _kernel_merge_shard(tokens: torch.Tensor, ta: int, tb: int, new_id: int, edges,
                        rank: int):
    """One merge round on a row-local shard, a != b: one K = 1 pass of the
    merge kernel over the shard, IN PLACE. The boundary pair is decided on
    the PRE-pass stream and patched afterwards: for a != b the shard's tail
    token is never consumed by its own pass (its successor there is PAD),
    and the head a left neighbour kills survives this shard's pass (it
    would have to be a left member, a, but it equals b).

    Returns (tokens, int64 [hits, kept, layout_bad]) on the tokens' device;
    layout_bad is set when the pass drained a row to <= 1 token, or the
    head kill left row 0 with too few tokens to keep the layout."""
    L, first, last = edges[rank]
    nxt, prev_last, _ = _neighbours(edges, rank)
    boundary_hit = L > 0 and last == ta and nxt == tb
    killed_first = L > 0 and prev_last == ta and first == tb
    tokens, st = kmerge.merge_pass(tokens, ta, tb, new_id)
    st = st.long()
    bad = st[2] <= 1
    if boundary_hit:  # rewrite this shard's tail token
        _, b_out = core.pair_streams(tokens, LAYOUT)
        tokens.masked_fill_((tokens >= 0) & (b_out < 0), new_id)
    if killed_first:  # drop the head the left neighbour's boundary hit consumed
        row0 = tokens[:LAYOUT]
        bad = bad | ((row0 >= 0).sum() <= 2)
        tokens[:LAYOUT] = torch.cat([row0[1:], row0.new_full((1,), PAD)])
    return tokens, torch.stack([st[0] + int(boundary_hit), st[1] - int(killed_first),
                                bad.long()])


def _prefix_max(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running maximum of a 1-D int64 tensor. ``torch.cummax`` of a
    long 1-D tensor scans on one block of a card (102.8 ms at 2^25 tokens on
    an H100), so the scan runs along rows of 128, then over the row maxima
    (the same split again while they are many), and the two combine."""
    n = x.shape[0]
    if n <= LAYOUT:
        return torch.cummax(x, 0).values
    R = -(-n // LAYOUT)
    if R * LAYOUT != n:
        x = torch.cat([x, x.new_full((R * LAYOUT - n,), torch.iinfo(x.dtype).min)])
    inner = torch.cummax(x.view(R, LAYOUT), 1).values
    carry = _prefix_max(inner[:, -1])
    carry = torch.cat([carry.new_full((1,), torch.iinfo(x.dtype).min), carry[:-1]])
    return torch.maximum(inner, carry[:, None]).view(-1)[:n]


def _parity_merge_shard(tokens: torch.Tensor, ta: int, new_id: int, edges, g: DataGroup):
    """One merge round of a pair (a, a) on a shard: the shard is recompacted
    to a prefix and leftmost-greedy parity runs on GLOBAL indices. A
    candidate hits iff its global index minus that of the last
    non-candidate before it is odd; the last non-candidate of earlier ranks
    comes from one all-gather of each rank's (last non-candidate index,
    running maximum at its last token, whether its last token is a
    candidate), from which every rank also knows every rank's boundary hit.
    Plain PyTorch, as the JAX package runs it in XLA.

    Returns (new prefix-layout tokens, int64 [hits, kept, 0])."""
    L = edges[g.rank][0]
    nxt, _, G = _neighbours(edges, g.rank)
    tc, _ = core.compact_stream(tokens)
    n = tc.shape[0]
    j = torch.arange(n, device=tc.device)
    b = torch.cat([tc[1:], tc.new_full((1,), PAD)])
    if L > 0:
        b[L - 1] = nxt
    c = (tc == ta) & (b == ta)
    gj = G + j
    lz_local = _prefix_max(torch.where(c, -1, gj))
    my_reset = torch.where(~c & (j < L), gj, -1).max()
    tail = torch.stack([lz_local[L - 1], c[L - 1].long()]) if L > 0 else gj.new_tensor([-1, 0])
    info = g.all_gather(torch.cat([my_reset.view(1), tail])).tolist()

    carry, offset, carry_in, bhits = -1, 0, -1, []
    for e, (reset_e, lz_last_e, c_last_e) in enumerate(info):
        L_e = edges[e][0]
        lz_e = max(lz_last_e, carry)
        bhits.append(L_e > 0 and bool(c_last_e) and (offset + L_e - 1 - lz_e) % 2 == 1)
        if e == g.rank:
            carry_in = carry
        carry, offset = max(carry, reset_e), offset + L_e
    prev = next((e for e in range(g.rank - 1, -1, -1) if edges[e][0] > 0), None)
    killed_first = L > 0 and prev is not None and bhits[prev]

    lz = torch.clamp(lz_local, min=carry_in)
    hit = c & ((gj - lz) % 2 == 1)
    written = torch.where(hit, new_id, tc)
    killed = torch.zeros_like(hit)
    killed[1:] = hit[:-1]
    killed[0] = killed_first
    kept = written[(tc >= 0) & ~killed]
    out = torch.full_like(tc, PAD)
    out[: kept.numel()] = kept
    return out, torch.stack([hit.sum(), gj.new_tensor(kept.numel()), gj.new_tensor(0)])


# --------------------------------------------------------------------------
# The chunk loop
# --------------------------------------------------------------------------


class _Shard:
    """One rank's training state: its shard of the stream, its part of the
    table and the replicated rest (every rank holds the same ``edges``,
    ``merges``, ``occ``, ``total`` and, up to LAZY_VOCAB_MAX, ``ub``)."""

    def __init__(self, tokens, ub, g: DataGroup, vocab_size: int, sharded: bool, edges,
                 merges, occ, total: int):
        self.tokens, self.ub, self.g = tokens, ub, g
        self.V, self.sharded = vocab_size, sharded
        self.edges, self.merges, self.occ, self.total = edges, merges, occ, total
        self.rm = None

    def refresh_rowmax(self) -> None:
        """The row cache, recomputed once a chunk and kept exact within it."""
        self.rm = self.ub.amax(1) if self.sharded else core.rowmax_of(self.ub, self.V)

    def round(self) -> None:
        """One merge round (``_dp_round`` of the JAX trainer)."""
        g, V = self.g, self.V
        k = len(self.merges)
        new_id = VOCAB_START + k
        a, b = _shard_pair_streams(self.tokens, _neighbours(self.edges, g.rank)[0])
        if self.sharded:
            ta, tb, cnt = _dp_select_lazy_sharded(self.ub, self.rm, a, b, V, g, hot=new_id - 1)
        else:
            ta, tb, cnt = _dp_select_lazy(self.ub, self.rm, a, b, V, g, hot=new_id - 1,
                                          batch=16 if V > 1024 else 8)
        if ta == tb:
            self.tokens, st = _parity_merge_shard(self.tokens, ta, new_id, self.edges, g)
        else:
            self.tokens, st = _kernel_merge_shard(self.tokens, ta, tb, new_id, self.edges,
                                                  g.rank)
        # one all-gather: hits, length, first, last, layout flag (and, for the
        # sharded table, row tb and column ta of each rank's block)
        e = _edge(self.tokens)
        msg = [st[:1], e, st[2:]]
        if self.sharded:
            Rl = self.ub.shape[0]
            r = min(max(tb - g.rank * Rl, 0), Rl - 1)
            msg += [self.ub[r].long(), self.ub[:, ta].long()]
        gathered = g.all_gather(torch.cat(msg))
        head = gathered[:, :5].tolist()
        nhits = sum(h[0] for h in head)
        self.edges = [tuple(h[1:4]) for h in head]
        self.total = sum(h[1] for h in head)
        if any(h[4] for h in head):  # restore the row-local invariant
            self.tokens, _ = core.compact_stream(self.tokens)
        self.merges.append((ta, tb, new_id))
        self.occ.append(cnt)
        if self.sharded:
            self._upkeep_sharded(gathered, ta, tb, new_id, nhits)
        else:
            core.update_ub_after_merge(self.ub, self.rm, ta, tb, new_id, nhits, V)

    def _upkeep_sharded(self, gathered, ta: int, tb: int, new_id: int, nhits: int) -> None:
        """Bound upkeep on the row-sharded table (``core.update_ub_after_merge``'s
        derivation): row tb comes from its owner's part of the gather, column
        ta from every rank's."""
        u, rm = self.ub, self.rm
        Rl, V = u.shape
        row0 = self.g.rank * Rl
        row_tb = gathered[tb // Rl, 5: 5 + V]
        col_ta = gathered[:, 5 + V:].reshape(-1)
        row_bound = row_tb.clamp(max=nhits).to(u.dtype)
        col_bound = col_ta.clamp(max=nhits).to(u.dtype)
        my_col = col_bound[row0: row0 + Rl]
        owns_ta, owns_new = row0 <= ta < row0 + Rl, row0 <= new_id < row0 + Rl
        if owns_ta:
            u[ta - row0, tb] = 0
        if owns_new:
            u[new_id - row0] = row_bound
        u[:, new_id] = my_col
        if owns_new:
            u[new_id - row0, new_id] = row_bound[ta].clamp(max=nhits)
        torch.maximum(rm, my_col, out=rm)
        if owns_ta:
            rm[ta - row0] = u[ta - row0].max()
        if owns_new:
            rm[new_id - row0] = u[new_id - row0].max()


def _halvable(cap: int, maxlen: int) -> bool:
    """Whether a shard capacity may halve: above the floor, the longest
    shard fits in half, and half is still whole kernel rows."""
    return cap > MIN_SHARD_CAPACITY and maxlen <= cap // 2 and (cap // 2) % LAYOUT == 0


def _gather_valid_stream(tokens: torch.Tensor, g: DataGroup, edges):
    """The global compacted stream on rank 0 (None on the others), for a
    checkpoint: the ranks' lengths are known from the last round's gather,
    so each rank sends its prefix padded to the longest, to rank 0 only.
    ``tokens`` must be prefix-compacted."""
    lengths = [e[0] for e in edges]
    parts = g.gather_to_root(tokens[: max(max(lengths), 1)])
    if parts is None:
        return None
    return np.concatenate([p[:n].cpu().numpy() for p, n in zip(parts, lengths)])


def _validate_vocab(vocab_size: int) -> int:
    if vocab_size < VOCAB_START:
        raise ValueError(f"vocab_size must be >= 256, got {vocab_size}")
    if vocab_size > 0x10000:
        raise ValueError(f"vocab_size must fit u16, got {vocab_size}")
    return vocab_size - VOCAB_START


def _load_resume(checkpoint_dir, vocab_size: int, M: int):
    """(start_merges, start_ids, start_occ) from a checkpoint, if any."""
    from ..utils import checkpoint as ckpt

    if not (checkpoint_dir and ckpt.exists(checkpoint_dir)):
        return [], None, None
    start_merges, start_ids, ck_vocab, start_occ = ckpt.load(checkpoint_dir)
    if ck_vocab != vocab_size:
        raise ValueError(f"checkpoint vocab_size {ck_vocab} != requested {vocab_size}")
    if len(start_merges) > M:
        raise ValueError("checkpoint has more merges than target vocab")
    return start_merges, start_ids, start_occ


def train_dp_tokens(
    tokens: torch.Tensor,
    total_tokens: int,
    vocab_size: int,
    group=None,
    *,
    ub: Optional[torch.Tensor] = None,
    ub_max_row: Optional[int] = None,
    start_merges: Sequence[Merge] = (),
    start_occ=(),
    chunk_rounds: int = 64,
    verbose: bool = False,
    shrink: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every_chunks: int = 4,
    stats: Optional[TimeStats] = None,
) -> List[Merge]:
    """Run the data-parallel chunk loop on this rank's shard ``tokens`` (a
    PAD-tailed piece from :func:`shard_corpus`; consumed: merge passes
    rewrite it in place). Every rank of ``group`` calls it with the same
    arguments but its own shard; ``total_tokens`` counts the whole corpus.

    ``ub`` defaults to a device-computed seed (``ub_max_row`` bounds the
    populated first-token rows of the sharded table, 256 for a fresh byte
    corpus). A chunk is up to ``chunk_rounds`` rounds; between chunks the
    shards are recompacted and their capacity halved while the longest
    fits, verbose lines are printed (rank 0), and a checkpoint is written
    every ``checkpoint_every_chunks`` chunks (rank 0 writes it). The phases
    ``count_pairs`` and ``merge_rounds`` go to ``stats``."""
    stats = stats or TimeStats.null()
    M = _validate_vocab(vocab_size)
    g = data_group(group)
    dev = tokens.device
    sharded = vocab_size > LAZY_VOCAB_MAX
    cap = tokens.shape[0]
    edges = _gather_edges(tokens, g)
    if ub is None:
        with stats.phase("count_pairs", dev):
            if sharded:
                ub = init_ub_sharded_dp(tokens, vocab_size, g, max_row=ub_max_row, edges=edges)
            else:
                ub = init_ub_dp(tokens, vocab_size, g, edges=edges)
    occ = [int(c) for c in np.asarray(start_occ, np.int64)[: len(start_merges)]]
    run = _Shard(tokens, ub, g, vocab_size, sharded, edges,
                 [tuple(int(v) for v in m) for m in start_merges],
                 occ + [0] * (len(start_merges) - len(occ)), total_tokens)

    chunks_done = 0
    while len(run.merges) < M and run.total >= 2:
        prev_k = len(run.merges)
        target = min(prev_k + chunk_rounds, M)
        with stats.phase("merge_rounds", dev):
            run.refresh_rowmax()
            while len(run.merges) < target and run.total >= 2:
                run.round()
        if verbose and g.rank == 0:
            for i in range(prev_k, len(run.merges)):
                a, b, new = run.merges[i]
                print(f"merge {i + 1}/{M}: ({a},{b}) -> {new} had {run.occ[i]} occurrences")

        # the stream is row-local after any merge pass: recompact before a
        # shrink or a checkpoint (which stores the logical stream)
        chunks_done += 1
        maxlen = max(e[0] for e in run.edges)
        ckpt_due = bool(checkpoint_dir) and chunks_done % checkpoint_every_chunks == 0

        want_shrink = shrink and _halvable(cap, maxlen)
        if want_shrink or ckpt_due:
            run.tokens, _ = core.compact_stream(run.tokens)
        if want_shrink:
            while _halvable(cap, maxlen):
                cap //= 2
            run.tokens = run.tokens[:cap].clone()
        if ckpt_due:
            stream = _gather_valid_stream(run.tokens, g, run.edges)
            if stream is not None:
                from ..utils import checkpoint as ckpt

                ckpt.save(checkpoint_dir, run.merges, stream, vocab_size,
                          np.asarray(run.occ, np.int32))

    if len(run.merges) < M and run.total < 2 and g.rank == 0:
        # reference early-stop notice (basic_tokenizer.zig:188-191)
        print("No more pairs to merge. Stopping early.")
    return list(run.merges)


def train_dp(
    data: bytes,
    vocab_size: int,
    group=None,
    device="cuda",
    chunk_rounds: int = 64,
    verbose: bool = False,
    shrink: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every_chunks: int = 4,
    resume: bool = True,
    stats: Optional[TimeStats] = None,
) -> List[Merge]:
    """Data-parallel training over ``group`` (default: the initialised
    default group, else world size 1) on ``device`` (the card unless the
    caller asks for the CPU); merge order identical to the single-chip
    trainer and the oracle for any world size. Every rank calls it with the
    whole corpus and keeps only its slice.

    Up to LAZY_VOCAB_MAX the upper-bound table is replicated, above it
    sharded by rows (up to the u16 cap 65536, basic_tokenizer.zig:140).
    With ``checkpoint_dir`` set, a checkpoint is written every
    ``checkpoint_every_chunks`` chunks and, with ``resume``, training
    resumes from one found there; checkpoints are interchangeable with
    the single-chip trainers of both packages.

    The table's seed is counted on the host when one process sees the whole
    stream, that is at world size 1 (the JAX trainer's one-process case):
    a fresh corpus's byte pairs by the native runtime, a resumed stream's
    pairs by ``np.unique``; the entries are placed on the device. Every
    rank of a larger group sees only its slice and seeds on the device,
    rows below 256 only for a fresh corpus. Both seeds are exact."""
    stats = stats or TimeStats.null()
    M = _validate_vocab(vocab_size)
    dev = _device(device)
    if M == 0 or len(data) < 2:
        return []
    g = data_group(group)
    start_merges, start_ids, start_occ = (
        _load_resume(checkpoint_dir, vocab_size, M) if resume else ([], None, None)
    )
    with stats.phase("initial_tokens", dev):
        if start_ids is not None:
            tokens = shard_token_ids(start_ids, g, dev)
            total = int(start_ids.size)
        else:
            tokens = shard_corpus(data, g, dev)
            total = len(data)
    ub = None
    if g.size == 1:
        with stats.phase("count_pairs", dev):
            if start_ids is not None:
                entries = _host_pair_entries(start_ids)
            else:
                entries = _byte_pair_entries(data)
            if vocab_size > LAZY_VOCAB_MAX:
                ub = _sharded_ub_from_entries(*entries, vocab_size=vocab_size, group=g,
                                              device=dev)
            else:
                ub = _replicated_ub_from_entries(*entries, vocab_size=vocab_size, device=dev)
    return train_dp_tokens(
        tokens, total, vocab_size, g, ub=ub,
        ub_max_row=None if start_ids is not None else 256,  # a fresh byte corpus
        start_merges=start_merges,
        start_occ=start_occ if start_occ is not None else (),
        chunk_rounds=chunk_rounds, verbose=verbose, shrink=shrink,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every_chunks=checkpoint_every_chunks, stats=stats,
    )
