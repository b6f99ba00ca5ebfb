"""Core device ops for BPE training and encoding, in PyTorch.

Counterpart of ``zigbpe_tpu/ops/core.py``. Functions take tensors and work
on the tensors' device; the port's token stream is always in the merge
kernel's row-local layout (``ops/kernels/merge.py``), so ``layout_block``
is ``LAYOUT`` wherever a stream may have been through a merge pass.

* Top-pair selection up to vocab 8192 is lazy: upper bounds on every pair
  count (``ub``) are popped and verified against the stream in batches
  (``select_top_pair_lazy``) until the table's argmax is exact; the dense
  histogram (``pair_histogram``) only seeds ``ub``. Above it the V*V table
  is too large, and each round sorts the stream's pairs instead
  (``select_top_pair_sorted``, ``train_chunk``). Every selection realises
  the same tie-break: the largest (first, second) wins among equal counts,
  which reproduces the reference's one golden tie.
* Leftmost-greedy overlap resolution (``aaa`` + (a,a)->X gives [X, a]) is
  a ``cummax`` parity over candidate runs, inside the merge pass.
* Loops the JAX package runs as ``lax.while_loop``/``lax.cond`` are Python
  control flow here, with one host sync per verify iteration and per merge
  group (two per round on the sorted path).
* The chunk loops record three sibling spans a round into the ``stats``
  they are given (``utils/profiling.TimeStats``): ``train.select``,
  ``train.upkeep`` (lazy path only) and ``train.merge``; and the counters
  ``verify_passes`` (exact-count passes over the stream),
  ``verify_queries`` (the pairs those passes count, summed),
  ``merge_passes``, ``merges`` and ``merge_tokens`` (the stream capacity
  each merge pass reads, summed).

Where the JAX code donates a buffer, the port updates it in place; each
function says so.
"""

from __future__ import annotations

import torch

from ..utils.profiling import TimeStats
from .kernels import LAYOUT
from .kernels import count as kcount
from .kernels import merge as kmerge

PAD = -1
VOCAB_START = 256


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device this process cannot
    use (the port never quietly runs a CUDA request on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def pad_tokens(byte_array, capacity: int, device="cpu"):
    """Place byte tokens in a PAD-tailed int32 stream of ``capacity`` on
    ``device``: the bytes cross to the device as uint8 and widen to int32
    there. Returns (tokens, length) with ``length`` a Python int."""
    data = bytes(byte_array)
    n = len(data)
    if n > capacity:
        raise ValueError(f"corpus length {n} exceeds capacity {capacity}")
    dev = resolve_device(device)
    tokens = torch.full((capacity,), PAD, dtype=torch.int32, device=dev)
    if n:
        raw = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        tokens[:n] = raw.to(dev)
    return tokens, n


def pad_token_ids(ids, capacity: int, device="cpu"):
    """Place an int32 token-id stream in a PAD-tailed stream of
    ``capacity`` on ``device``. Returns (tokens, length)."""
    ids = torch.as_tensor(ids, dtype=torch.int32).flatten()
    if ids.numel() > capacity:
        raise ValueError(f"token stream {ids.numel()} exceeds capacity {capacity}")
    tokens = torch.full((capacity,), PAD, dtype=torch.int32,
                        device=resolve_device(device))
    tokens[: ids.numel()] = ids.to(tokens.device)
    return tokens, int(ids.numel())


def pair_streams(tokens: torch.Tensor, layout_block: int | None = None):
    """(a, b) where b[j] is the next LOGICAL token after position j (PAD if
    none).

    * ``layout_block=None``: one global prefix with a PAD tail; b is a
      shift.
    * ``layout_block=C``: block-local prefixes of C elements; within a
      block b is the shift, and the last valid slot of a block pairs with
      slot 0 of the next block. A globally compacted stream is a special
      case.
    """
    n = tokens.shape[0]
    if layout_block and n % layout_block == 0 and n > layout_block:
        t2 = tokens.view(-1, layout_block)
        pad = torch.full((t2.shape[0], 1), PAD, dtype=tokens.dtype, device=tokens.device)
        nxt = torch.cat([t2[:, 1:], pad], dim=1)
        nextblk = torch.cat([t2[1:, :1], pad[:1]], dim=0)
        is_last = (t2 >= 0) & (nxt < 0)
        b = torch.where(is_last, nextblk, nxt).reshape(-1)
    else:
        b = torch.cat([tokens[1:], tokens.new_full((1,), PAD)])
    return tokens, b


def compact_stream(tokens: torch.Tensor):
    """Re-establish one global valid prefix from any layout (kept tokens
    keep their order; PAD fills the tail). Returns (new tokens, length)."""
    kept = tokens[tokens >= 0]
    out = torch.full_like(tokens, PAD)
    out[: kept.numel()] = kept
    return out, int(kept.numel())


def pair_histogram(tokens: torch.Tensor, vocab_size: int,
                   layout_block: int | None = None) -> torch.Tensor:
    """Dense ``V*V`` int32 histogram of adjacent pairs, overlaps included.
    Pairs involving PAD are dropped."""
    V = vocab_size
    a, b = pair_streams(tokens, layout_block)
    valid = (a >= 0) & (b >= 0)
    pid = torch.where(valid, a.long() * V + b.long(), V * V)
    return torch.bincount(pid, minlength=V * V + 1)[: V * V].to(torch.int32)


def select_top_pair(hist: torch.Tensor, vocab_size: int):
    """Argmax pair with the larger pair id winning ties. Returns 0-d
    tensors (first, second, count); count 0 means no pairs exist."""
    V = vocab_size
    max_count = hist.max()
    ids = torch.arange(hist.shape[0], device=hist.device)
    top = torch.where(hist == max_count, ids, -1).max()
    return top // V, top % V, max_count


def select_top_pair_sorted(tokens: torch.Tensor, vocab_size: int,
                           layout_block: int | None = None):
    """Argmax pair straight from the stream: sort the packed pair keys and
    count each run, then break ties on the largest (first, second). No
    histogram. Returns 0-d tensors (first, second, count); count 0 means no
    pairs exist (first and second are then meaningless).

    A key packs (first, second) in sort order: ``first * V + second`` in
    int32 while V*V fits, else ``first << 18 | second`` in int64 (int32
    would overflow for V > 46341). Invalid pairs take a key above every
    valid one. The JAX function takes run lengths from a cummax over run
    starts; here ``torch.unique`` counts the runs (a keys-only radix sort
    and a run-length encode on a card), because ``torch.cummax`` of a 1-D
    tensor scans on one block of the card: at 2^25 tokens it takes about
    fifty times this whole selection (``chip_smoke.py``'s sorted phase
    times both; PERF.md). It waits on the device once, for the number of
    runs.
    """
    V = vocab_size
    a, b = pair_streams(tokens, layout_block)
    wide = V * V >= 2**31
    if wide:
        key, invalid = (a.long() << 18) | b.long(), 1 << 36
    else:
        key, invalid = a * V + b, 2**31 - 1
    keys, counts = torch.unique(torch.where(b >= 0, key, invalid), sorted=True,
                                return_counts=True)
    counts = torch.where(keys != invalid, counts, 0)
    count = counts.max()
    top = torch.where(counts == count, keys, -1).max()
    if wide:
        return top >> 18, top & ((1 << 18) - 1), count
    return top // V, top % V, count


def count_pair(tokens: torch.Tensor, first, second,
               layout_block: int | None = None) -> torch.Tensor:
    """Exact count of adjacent pair (first, second) in the logical stream."""
    a, b = pair_streams(tokens, layout_block)
    return ((a == first) & (b == second) & (b >= 0)).sum().to(torch.int32)


def rowmax_of(ub: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Exact per-row maximum of the flat V*V upper-bound table."""
    V = vocab_size
    return ub.view(V, V).amax(1)


def count_queries(stream: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """int32 counts of each query value (>= 0) in the int32 ``stream``:
    ``ops/kernels/count.py``, the kernel on a card (one read of the stream)
    and its chunked twin on the CPU."""
    return kcount.count_queries(stream, queries)


def packed_count_fn(tokens: torch.Tensor, vocab_size: int,
                    layout_block: int | None = None):
    """The exact-count pass for ``select_top_pair_lazy``: compares against
    one packed pair-id stream while V*V fits int32, else the two components."""
    return stream_count_fn(*pair_streams(tokens, layout_block), vocab_size)


def stream_count_fn(sa: torch.Tensor, sb: torch.Tensor, vocab_size: int):
    """:func:`packed_count_fn` on given pair streams (``sb`` PAD where a
    slot holds no pair): ``count_fn(pa, pb)`` gives the int32 count of each
    queried pair."""
    V = vocab_size
    if V * V < 2**31:
        pid_stream = torch.where(sb >= 0, sa * V + sb, -1)

        def count_fn(pa, pb):
            return count_queries(pid_stream, pa * V + pb)
    else:
        def count_fn(pa, pb):
            out = torch.zeros(pa.shape[0], dtype=torch.int64, device=sa.device)
            for ca, cb in zip(sa.split(kcount.CHUNK), sb.split(kcount.CHUNK)):
                out += ((ca[None] == pa[:, None]) & (cb[None] == pb[:, None])
                        & (cb[None] >= 0)).sum(1)
            return out.to(torch.int32)
    return count_fn


def _table_argmax(u2: torch.Tensor, rm: torch.Tensor, iota: torch.Tensor):
    """(count, first, second) of the table argmax via the row cache, as
    0-d tensors: max count, then largest row, then largest column (-1 if
    the row cache is inflated and no column of the row reaches it)."""
    c = rm.max()
    a = torch.where(rm == c, iota, -1).max()
    row = u2[a.clamp(min=0)]
    b = torch.where(row == c, iota, -1).max()
    return c.long(), a, b


def select_top_pair_lazy(ub: torch.Tensor, tokens: torch.Tensor, vocab_size: int,
                         batch: int = 8, layout_block: int | None = None,
                         rowmax: torch.Tensor | None = None,
                         count_fn=None, hot=None, hot_batch: int = 4,
                         protect_from: int | None = None,
                         return_verified: bool = False, col_k: int = 2):
    """Lazy-heap argmax: pop the ``batch`` largest rows of the stale upper
    bound table ``ub`` (their top ``col_k`` entries), the top ``hot_batch``
    entries of row and column ``hot`` for each hot token, and the exact
    tie-break candidate; verify them all with one exact pass over the
    stream; repeat until the table's argmax is a verified entry.

    Soundness: every ub entry is >= the live count, so once the argmax of
    ub is exact it is the true argmax; the order (count, first, second)
    realises the tie-break. ``rowmax`` is the per-row max of ub (exact or
    a sound overestimate); computed when not given. ``count_fn(pa, pb)``
    overrides the exact-count pass. ``protect_from``: bins whose row or
    column is >= this id keep their ub value instead of the measured count
    (they reference tokens minted earlier in the same group). The default
    ``hot_batch`` was tuned on another machine and awaits a measurement on
    the card.

    ``ub`` and ``rowmax`` are updated IN PLACE (the JAX trainer donates
    them). Returns Python ints (first, second, count), then ub and rowmax;
    with ``return_verified`` also the final iteration's verified bins as
    two tuples of ints (their ub entries hold exact live counts).
    """
    V = vocab_size
    u2 = ub.view(V, V)
    if rowmax is None:
        rowmax = u2.amax(1)
    rm = rowmax
    dev = ub.device
    iota = torch.arange(V, device=dev)
    hots = [] if hot is None else (list(hot) if isinstance(hot, (list, tuple)) else [hot])
    if count_fn is None:
        count_fn = packed_count_fn(tokens, V, layout_block)

    while True:
        rows_idx = torch.topk(rm, batch).indices
        cols = torch.topk(u2[rows_idx], col_k, dim=1).indices
        pa_parts = [rows_idx.repeat_interleave(col_k)]
        pb_parts = [cols.reshape(-1)]
        for h in hots:
            # the freshest bounds (tokens minted last round) are the stalest
            hr = min(max(int(h), 0), V - 1)
            hcols = torch.topk(u2[hr], hot_batch).indices
            hrows = torch.topk(u2[:, hr], hot_batch).indices
            hr_t = torch.full((hot_batch,), hr, dtype=hcols.dtype, device=dev)
            pa_parts += [hr_t, hrows]
            pb_parts += [hcols, hr_t]
        # ALWAYS verify the exact tie-break candidate: topk orders ties
        # arbitrarily, so with 3+ tied entries it could otherwise never be
        # verified and the loop would spin on already-exact values
        c0m, a0m, b0m = _table_argmax(u2, rm, iota)
        pa_parts.append(a0m.view(1))
        pb_parts.append(b0m.clamp(min=0).view(1))
        pa = torch.cat(pa_parts)
        pb = torch.cat(pb_parts)
        exact = count_fn(pa, pb)
        if protect_from is not None:
            prot = (pa >= protect_from) | (pb >= protect_from)
            exact = torch.where(prot, u2[pa, pb], exact)
        # duplicate (pa, pb) entries carry equal values
        u2[pa, pb] = exact
        rm[pa] = u2[pa].amax(1)
        c2, a2, b2 = _table_argmax(u2, rm, iota)
        verified = ((pa == a2) & (pb == b2)).any() | (c2 == 0)
        head = torch.stack([a2, b2, c2, verified.long()]).tolist()
        if head[3]:
            break
    a, b, c = head[0], head[1], head[2]
    if return_verified:
        return a, b, c, ub, rm, tuple(pa.tolist()), tuple(pb.tolist())
    return a, b, c, ub, rm


def update_ub_after_merge(ub: torch.Tensor, rowmax: torch.Tensor, ta: int, tb: int,
                          new_id: int, nhits: int, vocab_size: int):
    """Upper-bound upkeep after merging (ta, tb) -> new_id, IN PLACE.

    Every new (X, v) pair sits where an old (tb, v) pair was, and every
    (v, X) where an old (v, ta) was, so row tb / column ta of ub bound them;
    nhits caps both. Reads happen before the merged bin is zeroed: for
    ta == tb the old (a, a) count bounds (X, a). (X, X) sits where an old
    (tb, ta) pair was. The row cache stays exact: column new_id rose from
    zero, and rows ta and new_id are refreshed. Returns (ub, rowmax).
    """
    V = vocab_size
    u2 = ub.view(V, V)
    row_bound = u2[tb].clamp(max=nhits)
    col_bound = u2[:, ta].clamp(max=nhits)
    xx_bound = u2[tb, ta].clamp(max=nhits)
    u2[ta, tb] = 0
    u2[new_id] = row_bound
    u2[:, new_id] = col_bound
    u2[new_id, new_id] = xx_bound
    torch.maximum(rowmax, col_bound, out=rowmax)
    rowmax[ta] = u2[ta].max()
    rowmax[new_id] = u2[new_id].max()
    return ub, rowmax


def train_chunk_lazy(tokens: torch.Tensor, length: int, ub: torch.Tensor,
                     merges: torch.Tensor, occupancy: torch.Tensor,
                     num_merges: int, vocab_size: int, max_rounds: int,
                     select_batch: int = 8, merge_group: int = 1,
                     stats: TimeStats | None = None):
    """Run up to ``max_rounds`` merge rounds (or to the target vocab, early
    stop, or a drained row) on a stream in row-local layout, with lazy
    upper-bound selection and one fused merge pass per group of up to
    ``merge_group`` merges.

    Group building: after accepting P_i = (a_i, b_i) -> X_i, a bin (a, b)
    keeps its count iff a != b_i, b != a_i and (a, b) != (a_i, b_i). So the
    next member is the new table argmax, accepted iff it is exact (see the
    two extension modes below), chain-free against every earlier member and
    references no minted token. The accepted prefix applies at once in one
    merge pass, equal to sequential rounds, the tie-break included. A
    rejected member ends the group and is re-selected against fresh counts.

    ``tokens`` (through the merge pass), ``ub``, ``merges`` and
    ``occupancy`` are updated IN PLACE. Returns
    (tokens, length, ub, merges, occupancy, k, needs_compact) with
    Python ints for length, k and needs_compact (1 when a row drained to
    <= 1 token and the caller must recompact the stream).
    """
    stats = stats or TimeStats.null()
    V = vocab_size
    M = merges.shape[0]
    GK = merge_group
    dev = tokens.device
    target = min(num_merges + max_rounds, M)
    lb = LAYOUT
    rowmax = rowmax_of(ub, V)
    iota = torch.arange(V, device=dev)
    # Two ways to extend a group, chosen per chunk like the JAX trainer
    # (tuned on another machine; awaits a measurement on the card):
    # * chained: each extension first tries the latest verified set and
    #   otherwise re-runs the verified selection against the PRE-group
    #   stream (highest acceptance, one extra verify pass per member);
    # * membership: extensions are free, accepted only if the argmax is in
    #   the round's verified set.
    chained_ext = GK > 1 and (V <= 1024 or tokens.shape[0] > 2**24)

    k, L, flag = num_merges, length, 0
    while k < target and L >= 2 and flag == 0:
        X0 = VOCAB_START + k
        vpa = vpb = ()
        with stats.span("train.select"):
            # every verify pass of the round counts the PRE-group stream
            count_fn = _counted(packed_count_fn(tokens, V, lb), stats)
            # hot = the previous round's last new token (its bounds are fresh)
            if GK > 1:
                ta, tb, cnt, ub, rowmax, vpa, vpb = select_top_pair_lazy(
                    ub, tokens, V, batch=select_batch, layout_block=lb,
                    rowmax=rowmax, hot=X0 - 1, count_fn=count_fn,
                    return_verified=True, col_k=3,
                )
            else:
                ta, tb, cnt, ub, rowmax = select_top_pair_lazy(
                    ub, tokens, V, batch=select_batch, layout_block=lb,
                    rowmax=rowmax, hot=X0 - 1, count_fn=count_fn,
                )
        with stats.span("train.upkeep"):
            update_ub_after_merge(ub, rowmax, ta, tb, X0, cnt, V)
        ok = cnt > 0
        rows = [(ta, tb, X0) if ok else (-2, -2, -2)]
        cnts = [cnt]
        members = [(ta, tb)] if ok else []
        for m in range(1, GK):
            if not ok:
                rows.append((-2, -2, -2))
                continue
            Xm = X0 + m
            with stats.span("train.select"):
                c_m, ta_m, tb_m = torch.stack(
                    _table_argmax(ub.view(V, V), rowmax, iota)).tolist()
                in_verified = tb_m >= 0 and any(
                    pa == ta_m and pb == tb_m for pa, pb in zip(vpa, vpb)
                )
                if chained_ext and not in_verified:
                    # re-select against the PRE-group stream; bins that reference
                    # minted tokens keep their bounds (protect_from)
                    ta_m, tb_m, c_m, ub, rowmax, vpa, vpb = select_top_pair_lazy(
                        ub, tokens, V, batch=select_batch, layout_block=lb,
                        rowmax=rowmax, count_fn=count_fn, protect_from=X0,
                        return_verified=True,
                    )
                    in_verified = True
                ok = (
                    in_verified and c_m > 0 and tb_m >= 0 and k + m < target
                    and ta_m != tb_m and ta_m < X0 and tb_m < X0
                    and all((fa, fb) != (ta_m, tb_m) and fb != ta_m and fa != tb_m
                            for fa, fb in members)
                )
            if ok:
                with stats.span("train.upkeep"):
                    update_ub_after_merge(ub, rowmax, ta_m, tb_m, Xm, c_m, V)
                rows.append((ta_m, tb_m, Xm))
                cnts.append(c_m)
                members.append((ta_m, tb_m))
            else:
                rows.append((-2, -2, -2))

        g = len(members)
        if g == 0:
            break  # no pair left in the stream
        with stats.span("train.merge"):
            table = torch.tensor(rows, dtype=torch.int32, device=dev)
            _count_merge_pass(stats, tokens, g)
            tokens, pass_stats = kmerge.merge_pass_multi(tokens, table)
            st = pass_stats.tolist()
            L = st[GK]
            flag = int(st[GK + 1] <= 1)
            merges[k: k + g] = table[:g]
            occupancy[k: k + g] = torch.tensor(cnts[:g], dtype=torch.int32, device=dev)
        k += g
    return tokens, L, ub, merges, occupancy, k, flag


def _counted(count_fn, stats: TimeStats):
    """``count_fn`` that adds each call to the ``verify_passes`` counter and
    its queries to ``verify_queries``."""
    def counted(pa, pb):
        stats.count("verify_passes")
        stats.count("verify_queries", pa.shape[0])
        return count_fn(pa, pb)
    return counted


def _count_merge_pass(stats: TimeStats, tokens: torch.Tensor, merges: int) -> None:
    stats.count("merge_passes")
    stats.count("merges", merges)
    stats.count("merge_tokens", tokens.shape[0])



def train_chunk(tokens: torch.Tensor, length: int, merges: torch.Tensor,
                occupancy: torch.Tensor, num_merges: int, vocab_size: int,
                max_rounds: int, stats: TimeStats | None = None):
    """Run up to ``max_rounds`` merge rounds (or to the target vocab, early
    stop, or a drained row) with sort-based selection, on a stream in
    row-local layout: each round is one ``select_top_pair_sorted`` and one
    K = 1 merge pass, whose one-row table is built on the device from the
    selected pair. Two host syncs a round: the selection's count of runs,
    and one read of the pass's stats. A stream of length >= 2 always holds
    a pair, so every round merges.

    ``tokens`` (through the merge pass), ``merges`` and ``occupancy`` are
    updated IN PLACE. Returns (tokens, length, merges, occupancy, k,
    needs_compact) with Python ints for length, k and needs_compact (1 when
    a row drained to <= 1 token and the caller must recompact the stream).
    """
    stats = stats or TimeStats.null()
    target = min(num_merges + max_rounds, merges.shape[0])
    k, L, flag = num_merges, length, 0
    while k < target and L >= 2 and flag == 0:
        with stats.span("train.select"):
            ta, tb, cnt = select_top_pair_sorted(tokens, vocab_size, layout_block=LAYOUT)
        with stats.span("train.merge"):
            new_id = torch.full_like(ta, VOCAB_START + k)
            table = torch.stack([ta, tb, new_id]).to(torch.int32).view(1, 3)
            _count_merge_pass(stats, tokens, 1)
            tokens, pass_stats = kmerge.merge_pass_multi(tokens, table)
            _, L, min_kept = pass_stats.tolist()
            merges[k] = table[0]
            occupancy[k] = cnt
        flag = int(min_kept <= 1)
        k += 1
    return tokens, L, merges, occupancy, k, flag


def encode_replay(tokens: torch.Tensor, merges: torch.Tensor):
    """Encode by replaying the (M, 3) merge table in training order, one
    fused merge pass per merge; rows whose new token is negative (PAD) are
    no-ops. When a pass drains an interior row to <= 1 token the stream is
    recompacted before the next pass (the layout contract); one final
    compaction gives the global prefix.

    ``tokens`` is consumed (updated in place). Returns (tokens, length).
    """
    if merges.device != tokens.device:
        merges = merges.to(tokens.device)
    merges = merges.to(torch.int32).contiguous()
    live = (merges[:, 2] >= 0).nonzero().flatten().tolist()
    for i in live:
        tokens, stats = kmerge.merge_pass_multi(tokens, merges[i: i + 1])
        if int(stats[2]) <= 1:
            tokens, _ = compact_stream(tokens)
    return compact_stream(tokens)
