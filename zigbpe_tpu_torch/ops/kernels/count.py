"""The exact-count verify pass of lazy selection: the CUDA kernel's wrapper
and its plain PyTorch twin.

It replaces no Pallas kernel: the JAX package counts in XLA
(``zigbpe_tpu/ops/core.py`` ``select_top_pair_lazy``, ``count_fn`` at
:301). The kernel is ``csrc/count.cu``, which reads the stream once and
looks each slot up in a small hash table of the queries in shared memory.

:func:`count_queries` takes ``stream``, an int32 tensor [N] of packed pair
ids (-1 where a slot holds no pair), and ``queries``, an int32 or int64
tensor [Q] of pair ids >= 0, 0 <= Q <= ``MAX_QUERIES``, which may repeat.
It returns int32 [Q]: the number of slots of the stream equal to each
query, the query taken as int32 (a wider one wraps as a cast does). A
negative query counts nothing. The kernel reads int64 queries, which the
trainer makes; int32 ones are widened first.

A CPU tensor runs the twin (:func:`count_queries_reference`, the stream
compared with every query in chunks of ``CHUNK`` slots); a CUDA tensor
launches the kernel or raises. ``count_queries.launches`` counts kernel
launches, each through :class:`_build.Entry`.

:func:`count_plan` states the launch geometry as the C entry computes it
(``count_geometry`` in ``csrc/count.cu``, whose constants of the same
names these are): the table's size and the copies of each count from Q,
the grid from N and the SM count. The wrapper does not call it; the CPU tests replay it, and
``chip_smoke.py`` holds it equal to the C side's (:func:`device_plan`) on
the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

CHUNK = 1 << 20        # the twin's slots a comparison
THREADS = 512          # a block
VECS = 4               # 16-byte vectors a thread a step
BLOCKS_PER_SM = 4      # at most
MAX_QUERIES = 8192
MIN_BITS = 8           # the smallest table: 256 entries
LOAD_BITS = 4          # entries >= 16 Q, up to 2^MAX_BITS
MAX_BITS = 14
COPIES = 32            # copies of a count, at most: one a lane
COUNT_BYTES = 49152    # a block's counts, at most
HASH = 2654435761      # a key's home entry: (key * HASH mod 2^32) >> (32 - bits)


class CountPlan(NamedTuple):
    qbits: int          # log2 of the queries rounded up to a power of two
    bits: int           # log2 of the table's entries (key, dense index), 8 bytes each
    copies: int         # copies of each count (lane l adds to copy l mod copies)
    smem: int           # bytes of a block's entries and counts
    n4: int             # whole 16-byte vectors of the stream
    steps: int          # steps of THREADS * VECS vectors; block b takes b, b + grid, ...
    sms: int            # SMs of the device
    blocks_per_sm: int  # min(BLOCKS_PER_SM, the kernel's occupancy at smem bytes)
    grid: int           # min(max(steps, 1), sms * blocks_per_sm)


def count_plan(n: int, nq: int, sms: int, occupancy: int) -> CountPlan:
    """The launch of :func:`count_queries` for a stream of ``n`` slots and
    ``nq`` queries on a card of ``sms`` SMs on which ``occupancy`` blocks
    fit at the plan's shared memory. Refuses what the C entry refuses."""
    if n < 0 or not 1 <= nq <= MAX_QUERIES:
        raise ValueError(f"zbpe_count_queries takes no n={n} nq={nq}")
    qbits = (nq - 1).bit_length()
    bits = min(max(qbits + LOAD_BITS, MIN_BITS), MAX_BITS)
    copies = COPIES
    while copies > 1 and (copies << qbits) * 4 > COUNT_BYTES:
        copies //= 2
    n4 = n // 4
    steps = -(-n4 // (THREADS * VECS))
    bps = min(max(occupancy, 1), BLOCKS_PER_SM)
    return CountPlan(qbits, bits, copies, (1 << bits) * 8 + (copies << qbits) * 4, n4, steps,
                     sms, bps, min(max(steps, 1), sms * bps))


def home(key: int, bits: int) -> int:
    """The first entry the table probes for ``key`` (>= 0)."""
    return (key * HASH % 2**32) >> (32 - bits)


def _check(stream: torch.Tensor, queries: torch.Tensor) -> None:
    if stream.dtype != torch.int32 or stream.dim() != 1:
        raise ValueError(f"stream must be 1-d int32, got {stream.dtype} {tuple(stream.shape)}")
    if queries.dtype not in (torch.int32, torch.int64) or queries.dim() != 1:
        raise ValueError(f"queries must be 1-d int32 or int64, got {queries.dtype} "
                         f"{tuple(queries.shape)}")
    if queries.shape[0] > MAX_QUERIES:
        raise ValueError(f"count_queries takes at most {MAX_QUERIES} queries, got "
                         f"{queries.shape[0]}")
    if queries.device != stream.device:
        raise ValueError(f"queries on {queries.device}, stream on {stream.device}")


def count_queries_reference(stream: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`count_queries`: one pass over the stream, in
    chunks so the comparison matrix stays small. The queries take the
    stream's dtype, so the stream is never widened."""
    _check(stream, queries)
    out = torch.zeros(queries.shape[0], dtype=torch.int64, device=stream.device)
    queries = queries.to(stream.dtype)
    for chunk in stream.split(CHUNK):
        out += (chunk[None, :] == queries[:, None]).sum(1)
    return out.masked_fill_(queries < 0, 0).to(torch.int32)


P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_COUNT = _build.Entry("count", "zbpe_count_queries", (P, LL, P, I, P))


def count_queries(stream: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """The int32 count of each query in ``stream`` (module docstring)."""
    if not _build.on_card(stream, "count_queries"):
        return count_queries_reference(stream, queries)
    _check(stream, queries)
    if not stream.is_contiguous() or stream.data_ptr() % 16:
        raise ValueError("stream must be contiguous and 16-byte aligned")
    if not queries.is_contiguous():
        raise ValueError("queries must be contiguous")
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=stream.device)
    if queries.shape[0] == 0 or stream.shape[0] == 0:
        return out.zero_()
    queries = queries.long()  # the kernel reads int64, as the trainer makes them
    _COUNT(stream.get_device(), stream.data_ptr(), stream.shape[0], queries.data_ptr(),
           queries.shape[0], out.data_ptr())  # zeroes out
    count_queries.launches += 1
    return out


count_queries.launches = 0


def device_plan(n: int, nq: int) -> CountPlan:
    """The geometry the C entry launches for these arguments on the current
    device, as ``zbpe_count_plan`` reports it."""
    fn = _build.library("count").zbpe_count_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [LL, I, P]
    out = (LL * len(CountPlan._fields))()
    rc = fn(n, nq, out)
    if rc:
        raise ValueError(f"zbpe_count_plan refused n={n} nq={nq}: CUDA error {rc}")
    return CountPlan(*out)
