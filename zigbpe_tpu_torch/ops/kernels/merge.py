"""Fused greedy merge + row-local compaction: the CUDA kernel's wrapper and
its plain PyTorch twin.

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

**Ablated passes** (:func:`merge_pass_ablated`, the port of the ablated
copies in ``scripts/probe_merge_budget.py``): the same kernel compiled with
one piece switched off, to measure what each piece costs. ``VARIANTS``
maps each name to the kernel's compile-time mask (``csrc/merge.cu``):

- ``full``: nothing off; the production pass.
- ``nofast``: every row is written, not only the rows that change; tokens
  and stats equal ``full``'s.
- ``noparity``: no slot-0 rank parity (and no whole-tile summary read for
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
- ``copy``: the apply launch alone loads each tile and stores it back;
  tokens unchanged, stats zero.
"""

from __future__ import annotations

import ctypes
import functools

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


@functools.cache
def _work_ints(n: int) -> int:
    """int32s of scratch a pass over ``n`` tokens needs, as the C side
    (``zbpe_merge_work_ints``) computes it; asked once per capacity."""
    fn = _build.library("merge").zbpe_merge_work_ints
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_longlong]
    return fn(n)


def _launch(tokens: torch.Tensor, table: torch.Tensor, mask):
    """One pass on CUDA tensors: the production entry for ``mask`` None,
    else the ablated entry with that mask."""
    _check_shapes(tokens, table)
    if not (tokens.is_contiguous() and table.is_contiguous()):
        raise ValueError("tokens and table must be contiguous")
    if tokens.data_ptr() % 16:
        raise ValueError("tokens must be 16-byte aligned")
    n, K = tokens.shape[0], table.shape[0]
    work = tokens.new_empty(_work_ints(n))
    stats = tokens.new_empty(K + 2)
    args = (tokens.data_ptr(), n, table.data_ptr(), K, work.data_ptr(), stats.data_ptr())
    if mask is None:
        _PASS(tokens.get_device(), *args)
    else:
        _PASS_ABLATED(tokens.get_device(), *args, mask)
    return tokens, stats
