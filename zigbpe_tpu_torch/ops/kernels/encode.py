"""Batched merge-table replay (the serving path): the CUDA kernel's wrapper,
its plain PyTorch twin, and the host-side grouping of the merge table.

Counterpart of ``zigbpe_tpu/ops/pallas/encode.py`` (``encode_rows_grouped``,
``encode_rows_pallas``, ``group_merges``, ``schedule_merges``); the kernel is
``csrc/encode.cu``, and :func:`replay_rows` replays its plan in numpy (its
layout, staging, probes, published words and in-place writes) for the CPU
tests.

Contract of :func:`encode_rows_grouped`: ``tokens`` is a [B, L] int32 batch,
one document per row, each row its byte tokens followed by PAD (= -1); a
PAD anywhere in a row is dropped, so a row's stream is its valid tokens in
order. The grouped table (``gtable`` int32[P, cap, 3], ``glens``
int32[P]) replays over every row, group by group. All members of a group apply at once, with their
candidates taken from the row as it stood before the pass; a group whose
only member has a == b resolves overlapping runs leftmost-greedy (``aaa`` ->
[X, a]); members with ``j >= glen`` or a negative new token do nothing. The
groups must be as :func:`group_merges` or :func:`schedule_merges` build them
(chain-free, pairwise distinct): then the result equals sequential replay of
the table (reference basic_tokenizer.zig:71-88). Rows never link. Returns
new tensors ``(out, lengths)``: each row of ``out`` a prefix of tokens with a
PAD tail, and ``lengths = (out >= 0).sum(1)``. With P == 0 the rows come back
unchanged.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import LAYOUT, PAD, _build, compact_rows

MAX_CAP = 1024  # members per group the kernel's shared-memory table holds


def encode_kernel_supported(row_length: int) -> bool:
    """The kernel's shape rule: a row length of 128*R tokens with
    8 <= R <= 256 (1024 to 32768 tokens). The device is not part of the
    rule: the tensor's device picks kernel or twin."""
    return row_length % LAYOUT == 0 and 8 <= row_length // LAYOUT <= 256


def group_merges(merges, cap: int = 16):
    """Host-side: greedily group CONSECUTIVE merge-table entries that can
    replay SIMULTANEOUSLY in one fused pass. Entries i != j fuse when every
    pair is distinct, no member has a == b (the overlap-parity case stays a
    singleton), no member's (a, b) references a group member's minted
    token, and the group is CHAIN-FREE: no member's b equals another
    member's a.

    Soundness (why simultaneous == sequential here): (1) no member can
    DESTROY another's candidate — a destroyed candidate would need one of
    its two tokens hit or killed by another member, and every such case
    forces a == a' with b == b' (distinct pairs), b_i == a_j, or
    a_i == b_j, all excluded; (2) no member can CREATE another's candidate
    — every adjacency created by a merge has that member's minted token on
    its left, and minted tokens are never referenced in-group; (3) within
    one member, a != b makes candidates non-overlapping, so leftmost-greedy
    fires all of them. Hence applying all members' original-stream
    candidates at once reproduces sequential replay
    (basic_tokenizer.zig:71-88) bit-exactly.

    Real 1K-merge text tables fuse well (measured: cap=16 gives ~122
    chain-free passes for 1024 merges vs ~105 for the weaker
    minted-independence condition — but chain-freedom removes the
    per-member alive-mask chain from the kernel, ~2.4x less work per
    member).

    Returns (gtable int32[P, cap, 3] PAD-filled, glens int32[P]).
    """
    t = np.asarray(merges, np.int64).reshape(-1, 3)
    n = len(t)
    groups = []
    i = 0
    while i < n:
        g = 1
        minted = {int(t[i, 2])}
        pairs = {(int(t[i, 0]), int(t[i, 1]))}
        a_set = {int(t[i, 0])}
        b_set = {int(t[i, 1])}
        ok = t[i, 0] != t[i, 1] and t[i, 2] >= 0
        while ok and g < cap and i + g < n:
            a, b, x = (int(v) for v in t[i + g])
            if (
                a == b or x < 0 or (a, b) in pairs
                or a in minted or b in minted
                or a in b_set or b in a_set  # chain-freedom
            ):
                break
            minted.add(x)
            pairs.add((a, b))
            a_set.add(a)
            b_set.add(b)
            g += 1
        groups.append(g)
        i += g
    P = len(groups)
    gtable = np.full((P, cap, 3), PAD, np.int32)
    pos = 0
    for p, g in enumerate(groups):
        gtable[p, :g] = t[pos : pos + g]
        pos += g
    return gtable, np.asarray(groups, np.int32)


def schedule_merges(merges, cap: int = 16):
    """Reorder-with-equivalence scheduling: greedily list-schedule the merge
    table into simultaneous chain-free groups over its INDEPENDENCE DAG —
    the stronger version of :func:`group_merges`, which only fuses
    consecutive runs.

    Two merges are independent iff their pairs are distinct, no token is
    chained across them (b_i == a_j or b_j == a_i), neither references the
    other's minted token, and — when either has a == b (overlap parity) —
    their token sets are fully disjoint. Independent merges COMMUTE: each
    one's candidate set on any stream is invariant under the other's
    application (destroying a candidate would need a member token consumed,
    which forces one of the excluded equalities; every created adjacency
    involves the minted token, which is never referenced). Hence replaying
    any topological linear extension of the dependency DAG — reachable
    from training order by adjacent transpositions of independent pairs —
    produces the same output for EVERY input, and independent entries
    within one step may apply simultaneously (the group_merges argument).

    The greedy: walk the remaining entries in original order; an entry is
    READY when all of its not-yet-scheduled earlier interactors are gone;
    add ready entries pairwise-independent with the current group until
    ``cap``. Real 1K text tables schedule to ~2-3x fewer passes than
    consecutive grouping (the tail of a trained table is full of mutually
    independent but interleaved merges).

    Returns (gtable int32[P, cap, 3] PAD-filled, glens int32[P]).
    """
    t = np.asarray(merges, np.int64).reshape(-1, 3)
    n = len(t)

    def indep(i, j):
        ai, bi, xi = t[i]
        aj, bj, xj = t[j]
        if ai == aj and bi == bj:
            return False
        if xi in (aj, bj, xj) or xj in (ai, bi):
            return False
        if bi == aj or bj == ai:
            return False
        if ai == bi or aj == bj:
            return not ({ai, bi, xi} & {aj, bj, xj})
        return True

    # interactors[j] = earlier entries j must wait for (list kept sorted)
    interacts = [
        [i for i in range(j) if not indep(i, j)] for j in range(n)
    ]
    scheduled = np.zeros(n, bool)
    order = []
    groups = []
    remaining = list(range(n))
    while remaining:
        group = []
        keep = []
        for idx in remaining:
            if len(group) >= cap:
                keep.append(idx)
                continue
            if any(not scheduled[i] for i in interacts[idx]):
                keep.append(idx)
                continue
            ai, bi = t[idx, 0], t[idx, 1]
            if ai == bi and group:
                keep.append(idx)  # parity merges run as singletons
                continue
            if group and (t[group[0], 0] == t[group[0], 1]):
                keep.append(idx)
                continue
            if all(indep(g, idx) for g in group):
                group.append(idx)
            else:
                keep.append(idx)
        for g in group:
            scheduled[g] = True
        order.extend(group)
        groups.append(len(group))
        remaining = keep
    P = len(groups)
    gtable = np.full((P, cap, 3), PAD, np.int32)
    pos = 0
    for p, g in enumerate(groups):
        gtable[p, :g] = t[order[pos : pos + g]]
        pos += g
    return gtable, np.asarray(groups, np.int32)


def shift_left(t: torch.Tensor) -> torch.Tensor:
    """Each row's next token (PAD after the last slot)."""
    return torch.cat([t[:, 1:], torch.full_like(t[:, :1], PAD)], dim=1)


def parity_hits(cand: torch.Tensor) -> torch.Tensor:
    """Leftmost-greedy hits among the candidates of an a == b pair in a
    batch of prefix rows: a candidate hits iff its distance to the last
    non-candidate before it (-1 before the row) is odd."""
    col = torch.arange(cand.shape[1], device=cand.device)
    last_nc = torch.cummax(torch.where(cand, -1, col), dim=1).values
    return cand & (((col - last_nc) & 1) == 1)


def encode_rows_grouped_reference(tokens: torch.Tensor, gtable: torch.Tensor,
                                  glens: torch.Tensor):
    """Plain PyTorch twin of the encode kernel (same contract, same arrays;
    see the module docstring). Rows are first compacted to prefixes, then
    each group applies in one vectorised pass over the whole batch."""
    _check_shapes(tokens, gtable, glens)
    if gtable.shape[0] == 0:
        return tokens.clone(), (tokens >= 0).sum(1, dtype=torch.int32)
    t = compact_rows(tokens, tokens >= 0)
    for group, glen in zip(gtable.tolist(), glens.tolist()):
        live = [m for m in group[:glen] if m[2] >= 0]
        if not live:
            continue
        valid = t >= 0
        nxt = shift_left(t)
        if glen == 1 and live[0][0] == live[0][1]:
            a, _, x = live[0]
            hit = parity_hits(valid & (t == a) & (nxt == a))
            written = torch.where(hit, x, t)
        else:
            hit = torch.zeros_like(valid)
            written = t
            for a, b, x in live:
                cand = (t == a) & (nxt == b) & (nxt >= 0)
                written = torch.where(cand, x, written)
                hit |= cand
        killed = torch.zeros_like(hit)
        killed[:, 1:] = hit[:, :-1]
        t = compact_rows(written, valid & ~killed)
    return t, (t >= 0).sum(1, dtype=torch.int32)


def encode_rows_grouped(tokens: torch.Tensor, gtable: torch.Tensor,
                        glens: torch.Tensor):
    """Replay a grouped merge table over a [B, L] batch of document rows
    (see the module docstring for the contract). Returns (out, lengths).

    A CPU tensor runs the plain twin. A CUDA tensor launches the CUDA
    kernel ``csrc/encode.cu`` (built at first launch) or raises; any other
    device raises. ``encode_rows_grouped.launches`` counts kernel launches.
    """
    if not _build.on_card(tokens, "the encode kernel"):
        return encode_rows_grouped_reference(tokens, gtable, glens)
    return _launch(tokens, gtable, glens)


encode_rows_grouped.launches = 0


def encode_rows(tokens: torch.Tensor, merges, cap: int = 16):
    """Group the (M, 3) merge table on the host (:func:`group_merges`) and
    replay it. Callers on a hot path should cache the grouping and call
    :func:`encode_rows_grouped` directly."""
    merges = merges.cpu().numpy() if isinstance(merges, torch.Tensor) else merges
    gtable, glens = group_merges(np.asarray(merges, np.int32), cap=cap)
    return encode_rows_grouped(
        tokens, torch.from_numpy(gtable).to(tokens.device),
        torch.from_numpy(glens).to(tokens.device),
    )


def _check_shapes(tokens: torch.Tensor, gtable: torch.Tensor,
                  glens: torch.Tensor) -> None:
    if tokens.dtype != torch.int32 or tokens.dim() != 2:
        raise ValueError(f"tokens must be 2-D int32 [B, L], got {tokens.dtype} "
                         f"{tuple(tokens.shape)}")
    L = tokens.shape[1]
    if not encode_kernel_supported(L):
        raise ValueError(f"row length {L} must be 128*R with 8 <= R <= 256")
    if gtable.dtype != torch.int32 or gtable.dim() != 3 or gtable.shape[2] != 3:
        raise ValueError(f"gtable must be int32 [P, cap, 3], got {gtable.dtype} "
                         f"{tuple(gtable.shape)}")
    P, cap = gtable.shape[:2]
    if glens.dtype != torch.int32 or tuple(glens.shape) != (P,):
        raise ValueError(f"glens must be int32 [{P}], got {glens.dtype} "
                         f"{tuple(glens.shape)}")
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"group capacity {cap}; 1 to {MAX_CAP} allowed")
    if gtable.device != tokens.device or glens.device != tokens.device:
        raise ValueError(f"gtable on {gtable.device}, glens on {glens.device}, "
                         f"tokens on {tokens.device}")


P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENCODE_ROWS = _build.Entry("encode", "zbpe_encode_rows", (P, P, P, LL, I, P, P, I, I))


def smem_bytes(row_length: int, groups: int, cap: int) -> int:
    """Dynamic shared memory of one block of the encode kernel, in bytes,
    for rows of ``row_length`` tokens and ``groups`` groups of ``cap``
    members, as the C side (``zbpe_encode_smem_bytes``) computes it
    (:func:`smem_words` is the same count, kept on the host)."""
    fn = _build.library("encode").zbpe_encode_smem_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [I, I, I]
    return fn(row_length, groups, cap)


def _launch(tokens: torch.Tensor, gtable: torch.Tensor, glens: torch.Tensor):
    _check_shapes(tokens, gtable, glens)
    B, L = tokens.shape
    P, cap = gtable.shape[:2]
    if P == 0 or B == 0:  # nothing to replay: rows are their own encodings
        return tokens.clone(), (tokens >= 0).sum(1, dtype=torch.int32)
    if not (tokens.is_contiguous() and gtable.is_contiguous() and glens.is_contiguous()):
        raise ValueError("tokens, gtable and glens must be contiguous")
    if tokens.data_ptr() % 16:
        raise ValueError("tokens must be 16-byte aligned")
    out = torch.empty_like(tokens)
    lengths = tokens.new_empty(B)
    _ENCODE_ROWS(tokens.get_device(), tokens.data_ptr(), out.data_ptr(), lengths.data_ptr(), B,
                 L, gtable.data_ptr(), glens.data_ptr(), P, cap)
    encode_rows_grouped.launches += 1
    return out, lengths


# ------------------------------------------------------- the kernel's plan

# Constants of csrc/encode.cu (tests/test_torch_encode_plan.py reads them
# back from the source).
STEPS = 32  # steps of a warp: lane l holds positions W + 32k + l, k < STEPS
MAX_THREADS = 1024
MIN_SLOTS, MAX_SLOTS, SLOTS_PER_MEMBER = 64, 4096, 16
SEEDS = 32  # multipliers tried for a collision-free table
CTL, RAW = 4, 100  # control words of a buffer; the staging warp's raw members
NARROW = 65535  # ids below this pack two to a 32-bit key
EMPTY = 0xFFFFFFFF
MULT0, MULT_STEP = 0x9E3779B1, 0x7F4A7C16  # seed s multiplies by MULT0 + s * MULT_STEP
HASH_A, HASH_B = 0x9E3779B1, 0x85EBCA77  # the linear-probing table's hash
SKIP, PERFECT, GENERAL, PARITY = 0, 1, 2, 3
_U32 = 0xFFFFFFFF


def table_slots(cap: int) -> tuple[int, int]:
    """(slots, shift) of a pass table: a power of two >= 16 * cap (at least
    MIN_SLOTS, at most MAX_SLOTS, which is 4 * cap at cap 1024), and
    32 - log2(slots)."""
    slots, shift = MIN_SLOTS, 26
    while slots < SLOTS_PER_MEMBER * cap and slots < MAX_SLOTS:
        slots, shift = slots * 2, shift - 1
    return slots, shift


def block_warps(row_length: int, lanes: int = 32, steps: int = STEPS) -> int:
    """Warps of a block: one for each ``lanes * steps`` positions of the
    row (32 warps, MAX_THREADS threads, at the longest row)."""
    return -(-row_length // (lanes * steps))


def row_words(row_length: int, lanes: int = 32, steps: int = STEPS) -> int:
    """Shared words of the row: the warps' spans and the PAD sentinel,
    rounded up to 16 bytes."""
    return block_warps(row_length, lanes, steps) * lanes * steps + 4


def smem_words(row_length: int, cap: int) -> int:
    """Dynamic shared memory of one block of the encode kernel, in int32
    words: the row, two tables of three words a slot (first ids or packed
    keys, second ids, new ids), two buffers of control words, the raw
    members and the published words (2 x 32 kept counts, 32 last
    non-candidates)."""
    slots, _ = table_slots(cap)
    return row_words(row_length) + 6 * slots + 2 * CTL + RAW + 3 * 32


def pack_key(a, b):
    """The packed key of a pair of ids below NARROW: a << 16 | b (the
    kernel's ``__byte_perm(b, a, 0x5410)``, the low halves of both)."""
    return ((np.asarray(a, np.int64) & 0xFFFF) << 16) | (np.asarray(b, np.int64) & 0xFFFF)


def perfect_slot(key, mult: int, shift: int):
    return ((np.asarray(key, np.int64) * mult) & _U32) >> shift


def general_hash(a, b, shift: int):
    a, b = np.asarray(a, np.int64) & _U32, np.asarray(b, np.int64) & _U32
    return ((a * HASH_A + b * HASH_B) & _U32) >> shift


class PassTable:
    """A pass's table as the staging warp leaves it: the mode, the
    multiplier (PERFECT), the parity pair's a and new id, and the slot
    arrays of :func:`table_slots` (k0: packed key or first id, EMPTY if free; k1:
    second id; xs: new id)."""

    def __init__(self, cap: int):
        self.slots, self.shift = table_slots(cap)
        self.k0 = np.full(self.slots, EMPTY, np.int64)
        self.k1 = np.zeros(self.slots, np.int64)
        self.xs = np.zeros(self.slots, np.int64)
        self.mode, self.mult, self.a, self.x = SKIP, 0, PAD, PAD

    def insert(self, a: int, b: int, x: int) -> None:
        h = int(general_hash(a, b, self.shift))
        while self.k0[h] != EMPTY:
            h = (h + 1) & (self.slots - 1)
        self.k0[h], self.k1[h], self.xs[h] = a, b, x

    def lookup(self, a: int, b: int):
        """The new id of the pair (a, b), or None: a width test, one load
        and one compare for a PERFECT table, a linear probe for a GENERAL
        one."""
        if self.mode == PERFECT:
            if max(a & _U32, b & _U32) >= NARROW:
                return None
            key = int(pack_key(a, b))
            h = int(perfect_slot(key, self.mult, self.shift))
            return int(self.xs[h]) if self.k0[h] == key else None
        if a < 0 or b < 0:
            return None
        h = int(general_hash(a, b, self.shift))
        while self.k0[h] != EMPTY:
            if self.k0[h] == a and self.k1[h] == b:
                return int(self.xs[h])
            h = (h + 1) & (self.slots - 1)
        return None


def stage_table(members: np.ndarray, glen: int, cap: int, rng=None) -> PassTable:
    """The staging warp's ``stage``: group ``members`` (int[cap, 3]) with
    length ``glen`` as the table of its pass. Up to 32 members: SKIP with
    none live, PARITY for a singleton with a == b, PERFECT when the live
    members' ids are all below NARROW and one of SEEDS multipliers puts
    them in distinct slots, else GENERAL. Past 32 members: GENERAL (or
    SKIP). GENERAL inserts in a random order (the lanes' atomicCAS race)."""
    rng = rng or np.random.default_rng(0)
    t = PassTable(cap)
    glen = min(int(glen), cap)
    m = np.asarray(members, np.int64)[: max(glen, 0)]
    live = m[(m >= 0).all(1)] if len(m) else m.reshape(0, 3)
    if glen > 0:
        t.a, t.x = int(m[0, 0]), int(m[0, 2])
    t.mode = GENERAL
    if not len(live):
        t.mode = SKIP
    elif glen <= 32 and glen == 1 and m[0, 0] == m[0, 1]:
        t.mode = PARITY
    elif glen <= 32 and (np.maximum(live[:, 0], live[:, 1]) < NARROW).all():
        keys = pack_key(live[:, 0], live[:, 1])
        for s in range(SEEDS):
            mult = (MULT0 + s * MULT_STEP) & _U32
            h = perfect_slot(keys, mult, t.shift)
            if len(np.unique(h)) == len(h):
                t.mode, t.mult = PERFECT, mult
                t.k0[h], t.xs[h] = keys, live[:, 2]
                break
    if t.mode == GENERAL:
        for a, b, x in live[rng.permutation(len(live))].tolist():
            t.insert(a, b, x)
    return t


_EVEN = 0x55555555


def parity_step_hits(cm: int, run: int, base: int = 0) -> int:
    """The hits of one step of an a == b pass, as the kernel computes them
    on the warp's candidate mask ``cm`` (bit l: the position base + l is a
    candidate), with ``run`` the last non-candidate position before the
    step (the kernel's steps start at even positions). A run of candidates
    starting at lane s > 0 hits at the lanes of s's parity; the run at lane
    0 at the parity of run + 1 - base. Adding the starts of the even runs
    to cm carries through those runs and marks them."""
    starts = cm & ~(cm << 1) & _U32
    first_even = int(bool(cm & 1) and not (run + 1 - base) & 1)
    even_starts = (starts & _EVEN & ~1) | first_even
    even_runs = cm & (((cm + even_starts) & _U32) ^ cm)
    return (even_runs & _EVEN) | (cm & ~even_runs & ~_EVEN & _U32)


def step_places(keep: np.ndarray, valid: np.ndarray, out: int):
    """The kernel's places for one step's kept lanes (``keep``, ``valid``:
    bool[lanes]) when the lanes' place at this step is ``out`` + lane less
    the drops before the step: each lane's place less the drops below it
    in the step. Returns (places of the kept lanes, out for the next
    step)."""
    lanes = len(keep)
    drop = valid & ~keep
    below = np.concatenate([[0], np.cumsum(drop)[:-1]])
    places = out + np.arange(lanes) - below
    return places[keep], out + lanes - int(drop.sum())


class _Block:
    """One block replaying a row: the row words in shared memory (PAD
    after the row), its warps (lane l of warp w holds positions
    w * lanes * steps + lanes * k + l, k < steps) and the words they
    publish. A pass loads, probes, publishes, waits, and writes; the
    record of loads still pending when the writes begin must be empty."""

    def __init__(self, row: np.ndarray, lanes: int, steps: int, rng):
        self.L, self.lanes, self.steps, self.rng = len(row), lanes, steps, rng
        self.warps = block_warps(self.L, lanes, steps)
        self.span = lanes * steps
        self.s = np.full(row_words(self.L, lanes, steps), PAD, np.int64)
        self.s[: self.L] = row
        w, k, lane = np.meshgrid(np.arange(self.warps), np.arange(steps), np.arange(lanes),
                                 indexing="ij")
        self.pos = w * self.span + lanes * k + lane  # [warps, steps, lanes]
        self.W = np.arange(self.warps) * self.span
        self.n = self.L

    def load(self):
        """The tokens at the warps' positions and the word after each,
        loaded in a random warp order (the read phase); a warp wholly past
        the row loads nothing. Returns (tok, right, valid), [warps, steps,
        lanes] each."""
        assert self.s[self.n] == PAD, "the sentinel after the row is not PAD"
        live = self.W < self.n
        self.pending = {int(p) for w in np.flatnonzero(live) for p in self.pos[w].ravel()}
        for w in self.rng.permutation(np.flatnonzero(live)):
            self.pending.difference_update(self.pos[w].ravel().tolist())
        tok = np.where(live[:, None, None], self.s[self.pos], PAD)
        right = np.where(live[:, None, None], self.s[self.pos + 1], PAD)
        return tok, right, self.pos < self.n

    def kills(self, hit, kill0):
        """A hit drops the token after it: lane l + 1's at the same step,
        or lane 0's at the next step after the last lane; ``kill0[w]`` drops
        warp w's first token (the pair across the boundary hit)."""
        kill = np.zeros_like(hit)
        kill[:, :, 1:] = hit[:, :, :-1]
        kill[:, 1:, 0] = hit[:, :-1, -1]
        kill[:, 0, 0] = kill0
        return kill

    def compact(self, tok, keep, valid, hit=None) -> None:
        """Each warp's word (kept count, whether it dropped a token), the
        barrier, the offsets from the words, and the writes in a random
        warp order: a warp that dropped nothing moves as one block, and
        stays put unless one of its pairs hit (its last, which drops the
        next warp's first token); one that dropped writes step by step,
        each kept lane at its rank among the step's kept lanes. No write
        may land on a word still pending, on a word written before, or
        after its source."""
        hit = np.zeros_like(keep) if hit is None else hit
        kept = keep.sum((1, 2))
        dropped = (keep != valid).any((1, 2))
        assert not self.pending, "a write phase began before every load was done"
        total = int(kept.sum())
        if not dropped.any():
            return
        offsets = np.concatenate([[0], np.cumsum(kept)[:-1]])
        written = set()
        for w in self.rng.permutation(self.warps):
            if not dropped[w]:
                if offsets[w] == self.W[w] and not hit[w].any():
                    continue
                src = self.pos[w][valid[w]]
                dst = offsets[w] + src - self.W[w]
                vals = tok[w][valid[w]]
            else:
                dst, src, vals, out = [], [], [], offsets[w]
                for k in range(self.steps):
                    places, out = step_places(keep[w, k], valid[w, k], out)
                    dst += places.tolist()
                    src += self.pos[w, k][keep[w, k]].tolist()
                    vals += tok[w, k][keep[w, k]].tolist()
            for d, p, v in zip(dst, src, vals):
                assert d not in written, "two writes to one word"
                assert d <= p, "a kept token moved after its source"
                written.add(int(d))
                self.s[int(d)] = v
        moved = {int(d) for w in np.flatnonzero(~dropped)
                 if offsets[w] == self.W[w] and not hit[w].any() for d in self.pos[w][valid[w]]}
        assert written | moved == set(range(total))
        self.s[total] = PAD
        self.n = total


def _fused(blk: _Block, table: PassTable, tok, right, valid):
    """Independent probes: the pair at a position is (its token, the token
    after it) as loaded, with no test of whether the pair before it hit; a
    hit takes its new id. A warp's lane 0 probes the pair across the
    boundary with the warp before. Returns (new tokens, keep, hit)."""
    hit = np.zeros(tok.shape, bool)
    new = tok.copy()
    memo = {}
    for idx in zip(*np.nonzero(valid)):
        pair = (int(tok[idx]), int(right[idx]))
        if pair not in memo:
            memo[pair] = table.lookup(*pair)
        if memo[pair] is not None:
            hit[idx], new[idx] = True, memo[pair]
    kill0 = np.array([w > 0 and blk.W[w] < blk.n and
                      table.lookup(int(blk.s[blk.W[w] - 1]), int(blk.s[blk.W[w]]))
                      is not None for w in range(blk.warps)])
    return new, valid & ~blk.kills(hit, kill0), hit


def _parity(blk: _Block, table: PassTable, tok, right, valid):
    """The a == b pass as the kernel runs it on a warp: each lane's
    candidate bits over its steps, transposed so that step k's mask (one
    bit a lane, in position order) sits with step k; each step's last
    non-candidate; the warp's word (the last of them); after the barrier,
    the last non-candidate before each step (a max-scan over the steps from
    the largest earlier word); each step's hits from its mask
    (:func:`parity_step_hits`); the hits transposed back to the lanes. A
    candidate hits iff its distance to the last non-candidate before it is
    odd. Returns (new, keep, hit)."""
    a = table.a
    cand = (tok == a) & (right == a) & valid
    lane_bits = 1 << np.arange(blk.lanes, dtype=np.int64)
    # [warps, steps]: step k's mask, bit l for lane l (the transposed bits)
    masks = (cand.astype(np.int64) * lane_bits).sum(2)
    full = (1 << blk.lanes) - 1
    last = np.where(masks != full,
                    blk.W[:, None] + blk.lanes * np.arange(blk.steps)[None]
                    + np.array([[(full & ~int(m)).bit_length() - 1 for m in row]
                                for row in masks]), -1)
    words = [int(last[w].max()) if blk.W[w] < blk.n else -1 for w in range(blk.warps)]
    hit = np.zeros(tok.shape, bool)
    kill0 = np.zeros(blk.warps, bool)
    for w in np.flatnonzero(blk.W < blk.n):
        before = max([-1, *words[:w]])
        runs = np.maximum.accumulate(np.concatenate([[before], last[w][:-1]]))
        for k in range(blk.steps):
            hits = parity_step_hits(int(masks[w, k]), int(runs[k]), int(blk.pos[w, k, 0]))
            hit[w, k] = (hits >> np.arange(blk.lanes)) & 1
        W = blk.W[w]
        kill0[w] = W > 0 and blk.s[W - 1] == a and blk.s[W] == a and (W - 1 - before) & 1
    return np.where(hit, table.x, tok), valid & ~blk.kills(hit, kill0), hit


_LOW = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)


def transpose32(words) -> list:
    """The kernel's ``transpose32``: five rounds of shuffles over a warp's
    32 words (lane i's bit j becomes lane j's bit i), each swapping the
    off-diagonal blocks of half the size."""
    x = [int(v) & _U32 for v in words]
    for r, m in enumerate(_LOW):
        j = 16 >> r
        t = [x[lane ^ j] for lane in range(32)]
        x = [((x[i] & ~m) | ((t[i] >> j) & m)) & _U32 if i & j
             else ((x[i] & m) | ((t[i] << j) & ~m)) & _U32 for i in range(32)]
    return x


def replay_rows(tokens: np.ndarray, gtable: np.ndarray, glens: np.ndarray, *,
                lanes: int = 32, steps: int = STEPS, seed: int = 0):
    """The encode kernel's plan replayed in numpy over every row of
    ``tokens`` ([B, L] int32): warps striped over the row with the PAD
    sentinel after it, the first pass dropping PAD, then per pass the
    table staged during the pass before into the other of two buffers
    (:func:`stage_table`; a pass never probes the buffer being staged),
    independent probes, the published per-warp words and the offsets
    formed from them, the parity run start carried across warps, and
    in-place writes in a random warp order after every load is done.
    ``lanes`` and ``steps`` may be small, so that rows of a few hundred
    tokens cross many warps. Returns (out, lengths) as the kernel does."""
    tokens = np.asarray(tokens, np.int64)
    gtable = np.asarray(gtable, np.int64)
    glens = np.asarray(glens, np.int64)
    P, cap = gtable.shape[:2]
    rng = np.random.default_rng(seed)
    out = np.full(tokens.shape, PAD, np.int32)
    lengths = np.zeros(len(tokens), np.int32)
    for r, row in enumerate(tokens):
        blk = _Block(row, lanes, steps, rng)
        buffers = [stage_table(gtable[0], glens[0], cap, rng) if P else None, None]
        tok, _, valid = blk.load()
        blk.compact(tok, valid & (tok >= 0), valid)
        for p in range(P):
            table = buffers[p & 1]
            staged = None
            if p + 1 < P:  # the staging warp fills the other buffer during this pass
                staged = stage_table(gtable[p + 1], glens[p + 1], cap, rng)
            if table.mode != SKIP:
                tok, right, valid = blk.load()
                if table.mode == PARITY:
                    new, keep, hit = _parity(blk, table, tok, right, valid)
                else:
                    new, keep, hit = _fused(blk, table, tok, right, valid)
                blk.compact(new, keep, valid, hit)
            buffers[(p + 1) & 1] = staged
        out[r, : blk.n] = blk.s[: blk.n]
        lengths[r] = blk.n
    return out, lengths
