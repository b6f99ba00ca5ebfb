"""BasicTokenizer — the framework's flagship model, on PyTorch.

Counterpart of ``zigbpe_tpu/models/basic_tokenizer.py``: train / encode /
decode / serialize / deserialize, plus TimeStats-style profiling, with the
reference's semantics (zig-bpe src/basic_tokenizer.zig:52-349). The merge
list is the entire model; order is the model.

Differences from the reference, by design:

* ``train`` and ``load_merges`` replace the model instead of appending to
  any pre-existing merge list.
* Empty/1-byte corpora train zero merges instead of underflowing.
* Decode is iterative with cycle detection instead of unbounded recursion.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from ..ops import core
from ..utils import serde
from ..utils.profiling import TimeStats
from . import oracle

Merge = Tuple[int, int, int]

VOCAB_START = 256

# Inputs below this size encode on the host (NumPy backend) under "auto".
_DEVICE_ENCODE_THRESHOLD = 1 << 16


class InvalidTokenError(ValueError):
    pass


def _encode_capacity(n: int) -> int:
    cap = 256
    while cap < n:
        cap *= 2
    return cap


class BasicTokenizer:
    """Host-facing tokenizer model backed by the PyTorch device path on
    ``device`` (a CUDA card, or the CPU's plain PyTorch path)."""

    def __init__(self, merges: Optional[Iterable[Sequence[int]]] = None,
                 device="cuda"):
        self.merges: List[Merge] = [tuple(int(v) for v in m) for m in merges or []]
        self.device = core.resolve_device(device)
        self.time_stats = TimeStats()
        self._device_merges = None  # cached (M, 3) int32 tensor on device

    # ------------------------------------------------------------------ train

    def train(
        self,
        text: bytes | str,
        vocab_size: int,
        verbose: bool = False,
        backend: str = "auto",
        **kwargs,
    ) -> "BasicTokenizer":
        """Train the merge table (reference basic_tokenizer.zig:140-205).

        backend: 'device' (the PyTorch path on this tokenizer's device),
        'host' (NumPy), 'oracle' (pure Python), or 'auto' (= device).
        """
        if isinstance(text, str):
            text = text.encode("utf-8")
        if backend == "auto":
            backend = "device"
        if backend == "device":
            from .. import train as train_mod

            self.merges = train_mod.train(
                text, vocab_size, verbose=verbose, stats=self.time_stats,
                device=self.device, **kwargs,
            )
        elif backend == "host":
            from . import numpy_backend

            self.merges = numpy_backend.train(text, vocab_size, verbose=verbose)
        elif backend == "oracle":
            self.merges = oracle.train(text, vocab_size, verbose=verbose)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        self._device_merges = None
        return self

    # ----------------------------------------------------------------- encode

    def encode(self, text: bytes | str, backend: str = "auto") -> List[int]:
        """Encode text by replaying merges in training order
        (reference basic_tokenizer.zig:71-88). backend: 'device', 'host',
        'oracle', or 'auto' (device from 64 KiB up, host below)."""
        if isinstance(text, str):
            text = text.encode("utf-8")
        if backend == "auto":
            backend = "device" if len(text) >= _DEVICE_ENCODE_THRESHOLD else "host"
        if backend == "host":
            from . import numpy_backend

            return numpy_backend.encode(text, self.merges)
        if backend == "oracle":
            return oracle.encode(text, self.merges)
        if backend != "device":
            raise ValueError(f"unknown backend {backend!r}")
        if not self.merges:
            return list(text)
        if self._device_merges is None:
            self._device_merges = torch.tensor(self.merges, dtype=torch.int32,
                                               device=self.device)
        tokens, _ = core.pad_tokens(text, _encode_capacity(max(len(text), 1)),
                                    self.device)
        out, length = core.encode_replay(tokens, self._device_merges)
        return out[:length].tolist()

    # ----------------------------------------------------------------- decode

    def decode(self, token_ids: Sequence[int]) -> bytes:
        """Decode token ids back to bytes (reference
        basic_tokenizer.zig:90-138) — iterative memoized expansion with O(1)
        table lookups instead of the reference's linear scans + recursion."""
        table = {nt: (a, b) for a, b, nt in self.merges}
        memo: dict[int, bytes] = {}

        def expand(tok: int) -> bytes:
            if tok < VOCAB_START:
                if tok < 0:
                    raise InvalidTokenError(f"invalid token id {tok}")
                return bytes([tok])
            stack = [tok]
            in_progress = set()
            while stack:
                t = stack[-1]
                if t in memo or t < VOCAB_START:
                    stack.pop()
                    continue
                if t not in table:
                    raise InvalidTokenError(f"unknown token id {t}")
                a, b = table[t]
                pending = [x for x in (a, b) if x >= VOCAB_START and x not in memo]
                if pending:
                    if t in in_progress:
                        raise InvalidTokenError(f"cyclic merge table at token {t}")
                    in_progress.add(t)
                    stack.extend(pending)
                else:
                    memo[t] = b"".join(
                        bytes([x]) if x < VOCAB_START else memo[x] for x in (a, b)
                    )
                    in_progress.discard(t)
                    stack.pop()
            return memo[tok]

        return b"".join(expand(int(t)) for t in token_ids)

    # ------------------------------------------------------------------ serde

    def save_merges(self, path: str | os.PathLike) -> None:
        """Serialize to merges.txt format (basic_tokenizer.zig:319-330)."""
        serde.save(self.merges, path)

    def load_merges(self, path: str | os.PathLike) -> "BasicTokenizer":
        """Load a merges.txt model (basic_tokenizer.zig:332-348); replaces
        the current merge list."""
        self.merges = serde.load(path)
        self._device_merges = None
        return self

    @classmethod
    def from_merges_file(cls, path: str | os.PathLike, device="cuda") -> "BasicTokenizer":
        return cls(serde.load(path), device=device)

    # ------------------------------------------------------------------ misc

    @property
    def vocab_size(self) -> int:
        return VOCAB_START + len(self.merges)

    def __len__(self) -> int:
        return len(self.merges)
