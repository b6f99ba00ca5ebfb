"""Mid-training checkpoint / resume.

A copy of ``zigbpe_tpu/utils/checkpoint.py`` (numpy and serde only), so the
two packages write the same files and each resumes the other's
checkpoints. The complete training state is the merge list so far, their
occurrence counts and the compacted token stream, so a checkpoint is a
merges.txt (the interchange artifact) plus a small npz with the residual
token stream and a meta.json.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import List, Optional, Tuple

import numpy as np

from . import serde

Merge = Tuple[int, int, int]

_STATE = "state.npz"
_MERGES = "merges.txt"
_META = "meta.json"


def save(
    path: str | os.PathLike,
    merges: List[Merge],
    tokens: np.ndarray,
    vocab_size: int,
    occupancy: Optional[np.ndarray] = None,
) -> None:
    """Write a resumable checkpoint directory. ``tokens`` is the compacted
    (valid-only) int32 token stream after ``len(merges)`` rounds."""
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    serde.save(merges, p / _MERGES)
    np.savez_compressed(
        p / _STATE,
        tokens=np.asarray(tokens, dtype=np.int32),
        occupancy=np.asarray(
            occupancy if occupancy is not None else np.zeros(len(merges), np.int32),
            dtype=np.int32,
        ),
    )
    (p / _META).write_text(
        json.dumps(
            {
                "format": "zigbpe-tpu-checkpoint-v1",
                "vocab_size": int(vocab_size),
                "num_merges": len(merges),
                "num_tokens": int(np.asarray(tokens).size),
            }
        )
    )


def load(path: str | os.PathLike):
    """Load a checkpoint -> (merges, tokens, vocab_size, occupancy)."""
    p = pathlib.Path(path)
    meta = json.loads((p / _META).read_text())
    if meta.get("format") != "zigbpe-tpu-checkpoint-v1":
        raise ValueError(f"not a zigbpe-tpu checkpoint: {path}")
    merges = serde.load(p / _MERGES)
    state = np.load(p / _STATE)
    tokens = state["tokens"]
    if tokens.size != meta["num_tokens"] or len(merges) != meta["num_merges"]:
        raise ValueError(f"corrupt checkpoint at {path}: size mismatch with meta")
    return merges, tokens, int(meta["vocab_size"]), state["occupancy"]


def exists(path: str | os.PathLike) -> bool:
    p = pathlib.Path(path)
    return (p / _META).exists() and (p / _STATE).exists() and (p / _MERGES).exists()
