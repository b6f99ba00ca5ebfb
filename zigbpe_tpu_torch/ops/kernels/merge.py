"""Fused greedy merge + row-local compaction: the CUDA kernel's wrapper,
its plain PyTorch twin, and a plain Python replay of the kernel's plan.

Counterpart of ``zigbpe_tpu/ops/pallas/merge.py`` (``merge_pass_pallas_multi``
and ``merge_pass_pallas``); the kernel is ``csrc/merge.cu``.

Layout contract — **row-local prefixes**: the token array is a sequence of
128-token rows, each a valid-token prefix with a PAD tail; the LOGICAL
stream is the concatenation of the row prefixes. A row's last valid token
pairs with the next row's head. Compaction after a merge is within-row only,
so a globally compacted stream is itself a valid layout, and the output
array equals the JAX kernel's element for element. Every row that precedes
a row with valid tokens must be non-empty; a pass can empty a row only if it
entered with fewer than 2 tokens, so the pass reports ``min_kept`` (the
smallest post-pass population of any non-empty input row but the stream's
last one) and callers globally recompact when it drops to <= 1.

Both versions rewrite ``tokens`` IN PLACE (where the JAX kernel aliases its
output to its input) and return ``(tokens, stats)`` with
``stats = [nhits_0 .. nhits_{K-1}, new_length, min_kept]`` (int32, on the
tokens' device).

**The kernel's plan** (``csrc/merge.cu`` says why): one launch a pass. A
persistent grid takes 4096-token tiles in order from a tile counter; each
tile publishes a status word tagged with the pass's epoch, the next tile
looks back one tile for its head kill, and with a == b in slot 0 a
decoupled look-back carries the rank parity as the pair (count, last
non-candidate rank), combined by :func:`carry_combine`. The last block to
finish folds the stats and leaves the work array ready for the next pass,
so the wrapper keeps one work array per (device, capacity).
:func:`replay_pass` replays that plan in numpy, tile by tile and block by
block in a random interleaving, for the CPU tests.

**Ablated passes** (:func:`merge_pass_ablated`, the port of the ablated
copies in ``scripts/probe_merge_budget.py``): the same kernel compiled with
one piece switched off, to measure what each piece costs. ``VARIANTS``
maps each name to the kernel's compile-time mask (``csrc/merge.cu``):

- ``full``: nothing off; the production pass.
- ``nofast``: every row is written, not only the rows that change; tokens
  and stats equal ``full``'s.
- ``noparity``: no slot-0 rank parity (and no look-back past one tile for
  a == b): every candidate hits. Equal to ``full`` when no slot has a == b.
- ``nominkept``: no kept-row minimum: tokens, hits and length equal
  ``full``'s, min_kept is BIG.
- ``noedgek``: no head kill across rows and tiles: a hit kills its partner
  only within its 128-token row.
- ``nocompact``: no warp scan and no compaction: each hit's token becomes
  the new token where it stands and its partner stays in the array; stats
  (hits, kept count, min_kept) equal ``full``'s. It stands for the Pallas
  variants ``noscan`` and ``nobitmove``.
- ``nokills``: no partner is killed (so no compaction, no edge kill and no
  min_kept either, as in the Pallas variant): hits written in place,
  length = the input length, min_kept = BIG.
- ``nostore``: no store of tokens: tokens unchanged, stats equal ``full``'s.
- ``copy``: the kernel's own tile loop, load and store of every tile and
  nothing else (the pass's floor); tokens unchanged, stats zero.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import LAYOUT, PAD, _build, compact_rows

BIG = 2**31 - 1
MAX_SLOTS = 4

# Ablation bits, equal to csrc/merge.cu's ABL_* constants.
ABL_NOFAST = 1
ABL_NOPARITY = 2
ABL_NOMINKEPT = 4
ABL_NOEDGEK = 8
ABL_NOCOMPACT = 16
ABL_NOKILLS = 32
ABL_NOSTORE = 64
ABL_COPY = 128

VARIANTS = {
    "full": 0,
    "nofast": ABL_NOFAST,
    "noparity": ABL_NOPARITY,
    "nominkept": ABL_NOMINKEPT,
    "noedgek": ABL_NOEDGEK,
    "nocompact": ABL_NOCOMPACT,
    "nokills": ABL_NOKILLS | ABL_NOCOMPACT | ABL_NOEDGEK | ABL_NOMINKEPT,
    "nostore": ABL_NOSTORE,
    "copy": ABL_COPY,
}


def merge_pass_multi_reference(tokens: torch.Tensor, table: torch.Tensor):
    """Plain PyTorch twin of the merge kernel (same contract, same arrays).

    ``table``: int32[K, 3] of (first, second, new_token) slots, a disabled
    slot being (-2, -2, -2). The enabled slots must form a valid
    simultaneous group: pairwise distinct, chain-free both ways, no slot
    referencing another's minted token, first != second except possibly in
    slot 0 (which keeps leftmost-greedy overlap parity). Under that contract
    simultaneous application equals sequential replay in slot order.
    """
    return _pass_reference(tokens, table, 0)


def merge_pass_ablated_reference(tokens: torch.Tensor, table: torch.Tensor, variant: str):
    """Plain twin of :func:`merge_pass_ablated`: the formulas of
    :func:`merge_pass_multi_reference` with the variant's pieces switched
    off (see ``VARIANTS``)."""
    return _pass_reference(tokens, table, _variant_mask(variant))


def _pass_reference(tokens: torch.Tensor, table: torch.Tensor, ablate: int):
    _check_shapes(tokens, table)
    K = table.shape[0]
    dev = tokens.device
    if ablate & ABL_COPY:
        return tokens, torch.zeros(K + 2, dtype=torch.int32, device=dev)
    t2 = tokens.view(-1, LAYOUT)
    R = t2.shape[0]
    valid = t2 >= 0
    pad_col = torch.full((R, 1), PAD, dtype=t2.dtype, device=dev)
    nxt_in = torch.cat([t2[:, 1:], pad_col], dim=1)
    head_next = torch.cat([t2[1:, 0], pad_col[:1, 0]])  # next row's head
    is_last = valid & (nxt_in < 0)
    nxt = torch.where(is_last, head_next[:, None], nxt_in)

    a, b, x = (table[:, i].view(K, 1, 1) for i in range(3))
    cands = valid & (t2 == a) & (nxt == b) & (nxt >= 0)  # (K, R, 128)

    # slot-0 parity: a candidate hits iff its logical rank minus the rank of
    # the last non-candidate before it is odd (-1 before the stream start)
    c0 = cands[0]
    rowpop = valid.sum(1)
    hits = cands.clone()
    if not ablate & ABL_NOPARITY:
        col = torch.arange(LAYOUT, device=dev)
        grank = (torch.cumsum(rowpop, 0) - rowpop)[:, None] + col
        ncr = torch.where(c0 | ~valid, -1, grank)
        last_nc = torch.cummax(ncr.reshape(-1), 0).values.view(R, LAYOUT)
        parity_hit = c0 & (((grank - last_nc) & 1) == 1)
        hits[0] = torch.where(table[0, 0] == table[0, 1], parity_hit, c0)
    hit = hits.any(0)

    written = t2
    for m in range(K):
        written = torch.where(hits[m], x[m], written)
    killed = torch.zeros_like(valid)
    if not ablate & ABL_NOKILLS:
        killed[:, 1:] = hit[:, :-1]
        if not ablate & ABL_NOEDGEK:
            edge_hit = (hit & is_last).any(1)
            killed[1:, 0] |= edge_hit[:-1]
        killed &= valid
    keep = valid & ~killed

    if not ablate & ABL_NOSTORE:
        t2.copy_(written if ablate & ABL_NOCOMPACT else compact_rows(written, keep))

    if ablate & ABL_NOMINKEPT:
        min_kept = torch.tensor(BIG, device=dev)
    else:
        rowkept = keep.sum(1)
        nonempty = torch.nonzero(rowpop > 0).flatten()
        interior = rowkept[nonempty[:-1]]
        min_kept = interior.min() if interior.numel() else torch.tensor(BIG, device=dev)
    stats = torch.cat([
        hits.sum((1, 2)), keep.sum().view(1), min_kept.view(1),
    ]).to(torch.int32)
    return tokens, stats


def merge_pass_multi(tokens: torch.Tensor, table: torch.Tensor):
    """Apply up to 4 merges at once in one pass, in place (see the module
    docstring and :func:`merge_pass_multi_reference` for the contract).

    A CPU tensor runs the plain twin. A CUDA tensor launches the CUDA
    kernel ``csrc/merge.cu`` (built at first launch) or raises; any other
    device raises. ``merge_pass_multi.launches`` counts kernel launches.
    """
    if not _build.on_card(tokens, "the merge kernel"):
        return merge_pass_multi_reference(tokens, table)
    out = _launch(tokens, table, None)
    merge_pass_multi.launches += 1
    return out


merge_pass_multi.launches = 0


def merge_pass_ablated(tokens: torch.Tensor, table: torch.Tensor, variant: str):
    """One pass of the merge kernel with the pieces of ``variant`` (a key of
    ``VARIANTS``) switched off, in place; same arguments and stats layout as
    :func:`merge_pass_multi`. A CPU tensor runs
    :func:`merge_pass_ablated_reference`; a CUDA tensor launches the kernel
    or raises. ``merge_pass_ablated.launches`` counts kernel launches."""
    mask = _variant_mask(variant)
    if not _build.on_card(tokens, "the merge kernel"):
        return merge_pass_ablated_reference(tokens, table, variant)
    out = _launch(tokens, table, mask)
    merge_pass_ablated.launches += 1
    return out


merge_pass_ablated.launches = 0


def _variant_mask(variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {', '.join(VARIANTS)}")
    return VARIANTS[variant]


def merge_pass(tokens: torch.Tensor, first: int, second: int, new_token: int):
    """Single-pair pass (K = 1): stats are [nhits, new_length, min_kept]."""
    table = torch.tensor([[first, second, new_token]], dtype=torch.int32,
                         device=tokens.device)
    return merge_pass_multi(tokens, table)


def _check_shapes(tokens: torch.Tensor, table: torch.Tensor) -> None:
    if tokens.dtype != torch.int32 or tokens.dim() != 1:
        raise ValueError(f"tokens must be 1-D int32, got {tokens.dtype} {tuple(tokens.shape)}")
    n = tokens.shape[0]
    if n == 0 or n % LAYOUT:
        raise ValueError(f"token capacity {n} must be a positive multiple of {LAYOUT}")
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[1] != 3:
        raise ValueError(f"table must be int32 [K, 3], got {table.dtype} {tuple(table.shape)}")
    if not 1 <= table.shape[0] <= MAX_SLOTS:
        raise ValueError(f"table holds {table.shape[0]} slots; 1 to {MAX_SLOTS} allowed")
    if table.device != tokens.device:
        raise ValueError(f"table on {table.device}, tokens on {tokens.device}")


P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PASS = _build.Entry("merge", "zbpe_merge_pass", (P, LL, P, I, P, P))
_PASS_ABLATED = _build.Entry("merge", "zbpe_merge_pass_ablated", (P, LL, P, I, P, P, I))

# Work arrays kept between passes, by (device, capacity); the oldest goes
# when more capacities than this are in use (the trainer halves its
# capacity, so it uses a few).
WORK_CACHE = 8
_work: dict = {}


@functools.cache
def _work_ints(n: int) -> int:
    """int32s of scratch a pass over ``n`` tokens needs, as the C side
    (``zbpe_merge_work_ints``) computes it; asked once per capacity."""
    fn = _build.library("merge").zbpe_merge_work_ints
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_longlong]
    return fn(n)


def _work_for(tokens: torch.Tensor) -> torch.Tensor:
    """The work array of ``tokens``' device and capacity: zeroed once, then
    left by each pass in the state the next pass needs. Passes that share it
    run in order on one stream."""
    key = (tokens.device, tokens.shape[0])
    work = _work.get(key)
    if work is None:
        if len(_work) >= WORK_CACHE:
            del _work[next(iter(_work))]
        work = _work[key] = torch.zeros(_work_ints(tokens.shape[0]), dtype=torch.int32,
                                        device=tokens.device)
    return work


def launch_grid(n: int, K: int) -> int:
    """Blocks of the persistent grid that the production pass over ``n``
    tokens with a ``K``-slot table launches on the current CUDA device: the
    blocks that fit on the card at once (occupancy API), at most one a
    4096-token tile. Needs the built kernel; launches nothing."""
    fn = _build.library("merge").zbpe_merge_grid
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int]
    grid = fn(n, K)
    if grid < 0:
        raise ValueError(f"the merge kernel takes no pass over {n} tokens with {K} slots")
    return grid


def _launch(tokens: torch.Tensor, table: torch.Tensor, mask):
    """One pass on CUDA tensors: the production entry for ``mask`` None,
    else the ablated entry with that mask."""
    _check_shapes(tokens, table)
    if not (tokens.is_contiguous() and table.is_contiguous()):
        raise ValueError("tokens and table must be contiguous")
    if tokens.data_ptr() % 16:
        raise ValueError("tokens must be 16-byte aligned")
    n, K = tokens.shape[0], table.shape[0]
    stats = tokens.new_empty(K + 2)
    args = (tokens.data_ptr(), n, table.data_ptr(), K, _work_for(tokens).data_ptr(),
            stats.data_ptr())
    if mask is None:
        _PASS(tokens.get_device(), *args)
    else:
        _PASS_ABLATED(tokens.get_device(), *args, mask)
    return tokens, stats


# ------------------------------------------------------- the kernel's plan

# Geometry of csrc/merge.cu (tests/test_torch_merge_plan.py reads it back):
# a tile is TILE_ROWS rows of 128 tokens, a block THREADS threads.
TILE_ROWS = 32
THREADS = 256

# The slot-0 parity carry. A prefix of the stream is the pair (s, m): its
# token count and the rank of its last slot-0 non-candidate (-1 if none). A
# slot-0 candidate at rank s hits iff (s - m) is odd.
CARRY_IDENTITY = (0, -1)


def carry_combine(p1: tuple, p2: tuple) -> tuple:
    """The carry of a prefix p1 followed by a span p2 (whose m is a rank
    within the span): associative, with identity ``CARRY_IDENTITY``."""
    (s1, m1), (s2, m2) = p1, p2
    return s1 + s2, max(m1, s1 + m2 if m2 >= 0 else -1)


def carry_bit(p: tuple) -> int:
    """h = (s - m) mod 2, all the kernel keeps of a carry: the next token
    hits, if it is a slot-0 candidate, iff h is 1."""
    return (p[0] - p[1]) & 1


# What a span does to h, as two bits (csrc/merge.cu's FN_NC and FN_Q): with
# a non-candidate, h after it is FN_Q; without, h ^ FN_Q.
FN_Q, FN_NC = 1, 2


def carry_fn(p: tuple) -> int:
    """The two-bit function on h of a span whose carry is ``p``."""
    s, m = p
    return FN_NC | ((s - m) & 1) if m >= 0 else s & 1


def fn_compose(later: int, earlier: int) -> int:
    return later if later & FN_NC else (earlier & FN_NC) | ((earlier ^ later) & FN_Q)


def fn_apply(f: int, h: int) -> int:
    return f & FN_Q if f & FN_NC else h ^ (f & FN_Q)


def look_back_bits(words: dict, g: int):
    """The kernel's look-back of tile g > 0 (``look_back`` in csrc/merge.cu)
    on the status words published so far, ``words[j] = (inclusive, fn or h,
    edge)``: ``edge`` is an inclusive tile's edge hit, else an aggregate's
    (EC, ED, EX). Returns (h entering tile g, edge hit of tile g-1, the
    inclusive words it publishes for the tiles it passed), or None while a
    word the kernel would spin on is missing. Lane l of a window reads tile
    base - l, the first window from g - 1; a window waits for the words up
    to its first inclusive one, and windows of 32 compose until one holds
    it. When the first window holds it, the tiles between get their
    inclusive words."""
    acc, prev, base = 0, None, g - 1
    while True:
        lanes = [(True, 1, 0) if base - lane < 0 else words.get(base - lane)
                 for lane in range(32)]
        first = next((lane for lane, w in enumerate(lanes) if w is not None and w[0]), 32)
        if any(w is None for w in lanes[: first + 1]):
            return None
        head = base == g - 1
        if head:
            prev = lanes[0]
            if first == 0:
                return prev[1], prev[2], {}
        fns = [w[1] if lane < first else FN_NC | w[1] if lane == first else 0
               for lane, w in enumerate(lanes)]
        suffix = [0] * 33  # suffix[l]: lanes l..31 composed, lane l last
        for lane in range(31, -1, -1):
            suffix[lane] = fn_compose(fns[lane], suffix[lane + 1])
        if head and first < 32:
            helped = {}
            for lane in range(1, first):
                ec, ed, ex = lanes[lane][2]
                h_before = suffix[lane + 1] & FN_Q
                helped[base - lane] = (True, suffix[lane] & FN_Q,
                                       int(ec or (ed and (h_before ^ ex))))
            h_prev = suffix[1] & FN_Q
            _, f_prev, (ec, ed, ex) = prev
            return fn_apply(f_prev, h_prev), int(ec or (ed and (h_prev ^ ex))), helped
        acc = fn_compose(acc, suffix[1] if head else suffix[0])
        if first < 32:
            break
        base -= 32
    h_prev = acc & FN_Q
    _, f_prev, (ec, ed, ex) = prev
    return fn_apply(f_prev, h_prev), int(ec or (ed and (h_prev ^ ex))), {}


class Deadlock(RuntimeError):
    """No block of a replay can move: every one waits on a missing word."""


def _tile_view(rows: np.ndarray, peek: int, table: np.ndarray):
    """(valid, is_last, candidates [K, rows, 128]) of a tile's rows, the
    next tile's head ``peek`` following its last row."""
    n = rows.shape[0]
    valid = rows >= 0
    nxt_in = np.concatenate([rows[:, 1:], np.full((n, 1), PAD, rows.dtype)], 1)
    heads = np.concatenate([rows[1:, 0], [peek]])
    is_last = valid & (nxt_in < 0)
    nxt = np.where(is_last, heads[:, None], nxt_in)
    a, b = table[:, 0, None, None], table[:, 1, None, None]
    cands = valid[None] & (rows[None] == a) & (nxt[None] == b) & (nxt >= 0)[None]
    return valid, is_last, cands


def _summary(rows: np.ndarray, peek: int, table: np.ndarray, parity: bool) -> dict:
    """What a tile publishes before it looks back: its carry (count, local
    rank of its last slot-0 non-candidate), its edge token, and the
    kernel's bits for them, built from the rows' functions as the kernel
    builds them."""
    valid, is_last, cands = _tile_view(rows, peek, table)
    pop = valid.sum(1)
    nc = valid & ~cands[0]
    col = np.arange(LAYOUT)
    rank = (np.cumsum(pop) - pop)[:, None] + col
    lastnc = int(rank[nc].max()) if nc.any() else -1
    cnt = int(pop.sum())
    edge0 = edgeo = False
    if pop[-1]:
        p = pop[-1] - 1
        edge0, edgeo = bool(cands[0, -1, p]), bool(cands[1:, -1, p].any())
    info = {"carry": (cnt, lastnc), "edge0": edge0, "edgeo": edgeo, "le": cnt - 1,
            "lastnc": lastnc}
    if parity:
        row_nc = np.where(nc, col, -1).max(1)
        fns = [FN_NC | ((int(pop[r]) - int(row_nc[r])) & 1) if row_nc[r] >= 0 else int(pop[r]) & 1
               for r in range(rows.shape[0])]
        excl = 0
        for f in fns[:-1]:
            excl = fn_compose(f, excl)
        tile_fn = fn_compose(fns[-1], excl)
        assert tile_fn == carry_fn(info["carry"])  # the bits are the pair's image
        p, ncr = int(pop[-1]) - 1, int(row_nc[-1])
        ec = ed = ex = 0
        if edgeo:
            ec = 1
        elif edge0:
            if ncr >= 0:
                ec = (p - ncr) & 1
            elif excl & FN_NC:
                ec = ((excl & FN_Q) + p) & 1
            else:
                ed, ex = 1, ((excl & FN_Q) ^ p) & 1
        info["bits"] = (tile_fn, (ec, ed, ex))
    return info


def _edge_hit(info: dict, excl: tuple) -> bool:
    """Whether a tile's edge token hits, given the carry entering the tile."""
    if info["edgeo"]:
        return True
    if not info["edge0"]:
        return False
    s, m = excl
    last = s + info["lastnc"] if info["lastnc"] >= 0 else m
    return (s + info["le"] - last) & 1 == 1


def _apply(rows: np.ndarray, peek: int, table: np.ndarray, parity: bool, excl: tuple,
           kill_in: bool):
    """A tile's pass given the carry and head kill entering it: (new rows,
    changed rows, hits per slot, kept per row, edge hit)."""
    valid, is_last, cands = _tile_view(rows, peek, table)
    pop = valid.sum(1)
    hits = cands.copy()
    if parity:
        s, m = excl
        rank = s + (np.cumsum(pop) - pop)[:, None] + np.arange(LAYOUT)
        ncr = np.where(valid & ~cands[0], rank, -1).reshape(-1)
        before = np.maximum.accumulate(np.concatenate([[m], ncr[:-1]])).reshape(rows.shape)
        hits[0] = cands[0] & ((rank - before) & 1 == 1)
    hit = hits.any(0)
    killed = np.zeros_like(valid)
    killed[:, 1:] = hit[:, :-1]
    edge = (hit & is_last).any(1)
    killed[1:, 0] |= edge[:-1]
    killed[0, 0] |= kill_in
    killed &= valid
    keep = valid & ~killed
    written = rows.copy()
    for k in range(table.shape[0]):
        written = np.where(hits[k], table[k, 2], written)
    out = np.full_like(rows, PAD)
    for r in range(rows.shape[0]):
        kept = written[r][keep[r]]
        out[r, : kept.size] = kept
    changed = (hit | killed).any(1)
    return out, changed, hits.sum((1, 2)), keep.sum(1), bool(edge[-1])


def replay_pass(tokens: np.ndarray, table: np.ndarray, *, tile_rows: int = TILE_ROWS,
                blocks: int = 4, seed: int = 0):
    """Replay the kernel's single-launch pass in numpy: ``blocks`` blocks
    take tiles of ``tile_rows`` rows in order from a counter (each holding
    at most two, as the kernel's double buffer does), and a random
    interleaving (``seed``) runs their steps: take, load (the tile's rows
    and the next tile's head, from the live array, at any time before the
    tile's summary), summary (publish), look back (when the words it needs
    exist; both the pair carry and the kernel's bits, which must agree),
    apply (write the changed rows into the live array), finish (the block's
    partial; the last block folds the stats). Raises :class:`Deadlock` if
    every block waits. Returns (tokens out, stats) as
    :func:`merge_pass_multi` does."""
    table = np.asarray(table, np.int32).reshape(-1, 3)
    K = table.shape[0]
    live = np.array(tokens, np.int32).reshape(-1, LAYOUT)
    nrows = live.shape[0]
    G = -(-nrows // tile_rows)
    parity = bool(table[0, 0] == table[0, 1] and table[0, 0] >= 0)
    rng = np.random.default_rng(seed)
    words, pairs, infos = {}, {}, {}  # kernel bits; the pair carries; summaries
    counter = 0
    # per block, the tiles it holds: [g, rows, stage, peek, carry in, kill in]
    held = [[] for _ in range(blocks)]
    exhausted, finished = [False] * blocks, [False] * blocks
    acc = [{"hits": np.zeros(K, np.int64), "kept": 0, "min": BIG, "lasttile": -1,
            "lastkept": -1} for _ in range(blocks)]

    def rows_of(g):
        r = live[g * tile_rows:(g + 1) * tile_rows]
        pad = np.full((tile_rows - r.shape[0], LAYOUT), PAD, np.int32)
        return np.concatenate([r, pad]).copy()

    def take(b):
        nonlocal counter
        g, counter = counter, counter + 1
        if g >= G:
            exhausted[b] = True
        else:
            held[b].append([g, None, -1, PAD, CARRY_IDENTITY, False])
        return True

    def carry_before(j):
        """The pair carry entering tile j, from the words published."""
        i, tail = j - 1, CARRY_IDENTITY
        while i >= 0 and i not in pairs:
            tail = carry_combine(infos[i]["carry"], tail)
            i -= 1
        return carry_combine(pairs[i] if i >= 0 else CARRY_IDENTITY, tail)

    def advance(b):
        tile = held[b][0]
        g, rows, stage = tile[0], tile[1], tile[2]
        if stage == -1:  # the load lands: the rows, and the next tile's head
            tile[1] = rows_of(g)
            tile[3] = int(live[(g + 1) * tile_rows, 0]) if g + 1 < G else PAD
            tile[2] = 0
            return True
        if stage == 0:  # summary and publish
            info = infos[g] = _summary(rows, tile[3], table, parity)
            if not parity:
                words[g] = (True, 0, int(info["edge0"] or info["edgeo"]))
            elif g == 0:
                pairs[g] = info["carry"]
                words[g] = (True, carry_bit(info["carry"]), int(_edge_hit(info, CARRY_IDENTITY)))
            else:
                words[g] = (False, *info["bits"])
            tile[2] = 1
            return True
        if stage == 1:  # look back
            if g > 0 and not parity:
                if g - 1 not in words:
                    return False
                tile[5] = bool(words[g - 1][2])
            elif g > 0:
                got = look_back_bits(words, g)
                if got is None:
                    return False
                excl = carry_before(g)
                prev_incl, _, prev_edge = words[g - 1]
                ehit_prev = bool(prev_edge) if prev_incl else _edge_hit(infos[g - 1],
                                                                        carry_before(g - 1))
                assert got[:2] == (carry_bit(excl), int(ehit_prev)), (g, got, excl, ehit_prev)
                for j, word in got[2].items():  # the tiles the look-back passed
                    assert words[j][0] or word == (True, carry_bit(carry_before(j + 1)),
                                                   int(_edge_hit(infos[j], carry_before(j))))
                    words[j] = word
                tile[4], tile[5] = excl, ehit_prev
                pairs[g] = carry_combine(excl, infos[g]["carry"])
                words[g] = (True, carry_bit(pairs[g]), int(_edge_hit(infos[g], excl)))
            tile[2] = 2
            return True
        # apply: the tile's changed rows into the live array, its stats
        out, changed, hits, kept, ehit = _apply(rows, tile[3], table, parity, tile[4], tile[5])
        assert ehit == bool(words[g][2])  # the edge hit the tile published
        for r in np.flatnonzero(changed):
            if g * tile_rows + r < nrows:
                live[g * tile_rows + r] = out[r]
        a = acc[b]
        a["hits"] += hits
        a["kept"] += int(kept.sum())
        ne = np.flatnonzero((rows >= 0).any(1))
        if ne.size:  # defer the tile's last non-empty row
            a["min"] = min([a["min"], *kept[ne[:-1]].tolist()])
            if a["lasttile"] >= 0:
                a["min"] = min(a["min"], a["lastkept"])
            a["lasttile"], a["lastkept"] = g, int(kept[ne[-1]])
        held[b].pop(0)
        return True

    def step(b):
        can_take = len(held[b]) < 2 and not exhausted[b]
        if not held[b]:
            if can_take:
                return take(b)
            finished[b] = True  # the block's partial is acc[b]
            return True
        if can_take and rng.random() < 0.5:
            return take(b)
        return advance(b) or (can_take and take(b))

    while not all(finished):
        order = rng.permutation(blocks)
        if not any(step(int(b)) for b in order if not finished[b]):
            raise Deadlock(f"no block can move: {held}")
    # the last block's fold: every partial, and every deferred row but the
    # stream's last
    hits = sum(p["hits"] for p in acc)
    kept = sum(p["kept"] for p in acc)
    last = max(p["lasttile"] for p in acc)
    mins = [p["min"] for p in acc] + [p["lastkept"] for p in acc
                                      if p["lasttile"] >= 0 and p["lasttile"] != last]
    stats = np.array([*hits.tolist(), kept, min(mins)], np.int64)
    return live.reshape(-1), stats.astype(np.int32)
