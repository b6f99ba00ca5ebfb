"""Multi-host runtime helpers on ``torch.distributed``.

Counterpart of ``zigbpe_tpu/parallel/multihost.py``. Every process calls
:func:`initialize` (explicit arguments, or the variables ``torchrun``
sets), then :func:`train_from_files` with the same arguments: each rank
reads only its own contiguous byte range of the corpus files and trains
data-parallel (``train_dp``); selection verifies candidate pairs with
exact integer all-reduces, so merges equal a single-process run's.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..ops import core

# How long a collective may wait for the other ranks before it raises.
DEFAULT_TIMEOUT_S = 600.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Bring up the default process group from explicit arguments or the
    ``torchrun`` variables MASTER_ADDR / MASTER_PORT, WORLD_SIZE and RANK
    (``coordinator_address`` is ``host:port``). Does nothing at one process.

    The backend is ``nccl`` for a CUDA ``device`` and ``gloo`` for the CPU
    unless ``backend`` says otherwise; nothing switches either on its own,
    and a CUDA device without a card raises. With a CUDA device the
    process's current device is set first: its index, else LOCAL_RANK
    (default 0)."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if num_processes <= 1:
        return
    if not coordinator_address:
        raise ValueError("a multi-process run needs a coordinator address (host:port)")
    dev = core.resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else int(env.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def process_info():
    """(rank, world size) of this process (0, 1 without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_data_group():
    """The data group over every process of the job."""
    from .train_dp import data_group

    return data_group()


def train_from_files(
    paths,
    vocab_size: int,
    group=None,
    device="cuda",
    chunk_rounds: int = 64,
    verbose: bool = False,
    shrink: bool = True,
    checkpoint_dir=None,
    checkpoint_every_chunks: int = 4,
    resume: bool = True,
    stats=None,
):
    """Multi-process data-parallel training entry point: every process calls
    it with the same arguments after :func:`initialize`. Each rank reads
    only its own byte range of the concatenated ``paths``
    (``train_dp.shard_corpus_from_files``) on ``device``; a resumed run
    re-shards the checkpoint's stream. Returns the merges on every rank."""
    from . import train_dp as dp

    g = dp.data_group(group)
    M = dp._validate_vocab(vocab_size)
    start_merges, start_ids, start_occ = (
        dp._load_resume(checkpoint_dir, vocab_size, M) if resume else ([], None, None)
    )
    if start_ids is not None:
        tokens = dp.shard_token_ids(start_ids, g, device)
        total = int(start_ids.size)
        ub_max_row = None  # a resumed stream can populate any row
    else:
        tokens, total = dp.shard_corpus_from_files(paths, g, device)
        ub_max_row = 256  # a fresh byte corpus
    return dp.train_dp_tokens(
        tokens, total, vocab_size, g,
        ub_max_row=ub_max_row,
        start_merges=start_merges,
        start_occ=start_occ if start_occ is not None else (),
        chunk_rounds=chunk_rounds, verbose=verbose, shrink=shrink,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every_chunks=checkpoint_every_chunks, stats=stats,
    )
