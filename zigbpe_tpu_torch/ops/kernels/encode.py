"""Batched merge-table replay (the serving path): the CUDA kernel's wrapper,
its plain PyTorch twin, and the host-side grouping of the merge table.

Counterpart of ``zigbpe_tpu/ops/pallas/encode.py`` (``encode_rows_grouped``,
``encode_rows_pallas``, ``group_merges``, ``schedule_merges``); the kernel is
``csrc/encode.cu``.

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
    import numpy as np

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
    import numpy as np

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
    import numpy as np

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
    members, as the C side (``zbpe_encode_smem_bytes``) computes it."""
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
