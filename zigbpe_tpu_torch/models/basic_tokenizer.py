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

import numpy as np
import torch

from ..native import lists as native_lists
from ..ops import core
from ..ops import encode_batch as eb
from ..ops.kernels import encode as kenc
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
        self._grouped_merges = None  # cached (gtable, glens) tensors on device

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
        The device backend passes ``kwargs`` on to :func:`train.train`
        (``chunk_rounds``, ``checkpoint_dir``, ``checkpoint_every_chunks``,
        ``resume``, ``detailed_stats``, ...) and times its phases into
        ``self.time_stats``.
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
        self._grouped_merges = None
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
        tokens, _ = core.pad_tokens(text, _encode_capacity(max(len(text), 1)),
                                    self.device)
        out, length = core.encode_replay(tokens, self._merges_tensor())
        return out[:length].tolist()

    def encode_batch(self, docs, row_length: Optional[int] = None) -> List[List[int]]:
        """Encode a batch of documents as padded rows on this tokenizer's
        device — the serving-path API (BASELINE.json config 3). Each row is
        independent; semantics per row are identical to :meth:`encode`.

        Rows of 1024 to 32768 tokens (a multiple of 128) replay the
        scheduled merge table in one launch of the encode kernel; other row
        lengths take the plain per-merge batch replay. The choice is by
        shape only.

        The lists hold the vocabulary's ints from one shared table
        (``native.lists``), or new ints where its library cannot be built.

        Each call records the spans ``encode.pad``, ``encode.schedule``,
        ``encode.kernel``, ``encode.copy`` and ``encode.lists``, counts its
        rows under ``encode_rows.kernel`` or ``encode_rows.plain``, and its
        ids under ``encode_ids.shared`` (from the table) and
        ``encode_ids.made`` (new ints), in ``self.time_stats``."""
        if not docs:
            return []
        docs = [d.encode("utf-8") if isinstance(d, str) else bytes(d) for d in docs]
        if not self.merges:
            return [list(d) for d in docs]
        if row_length:
            L = row_length
        else:
            # tight power-of-two capacity, floored at the kernel's 1024
            # tokens only where the kernel then takes the rows
            L = _encode_capacity(max((len(d) for d in docs), default=1))
            if kenc.encode_kernel_supported(max(L, 1024)):
                L = max(L, 1024)
        ts = self.time_stats
        with ts.span("encode.pad"):
            tokens, _ = eb.pad_batch(docs, L, self.device)
        grouped = kenc.encode_kernel_supported(L)
        ts.count("encode_rows.kernel" if grouped else "encode_rows.plain", len(docs))
        with ts.span("encode.schedule"):
            table = self._grouped_tables() if grouped else self._merges_tensor()
        with ts.span("encode.kernel"):
            if grouped:
                out, lengths = kenc.encode_rows_grouped(tokens, *table)
            else:
                out, lengths = eb.encode_batch(tokens, table)
        with ts.span("encode.copy"):
            out = out.cpu()
        with ts.span("encode.lists"):
            ids, shared, made = native_lists.row_lists(out, lengths, self.vocab_size)
        ts.count("encode_ids.shared", shared)
        ts.count("encode_ids.made", made)
        return ids

    def _grouped_tables(self):
        if self._grouped_merges is None:
            gt, gl = kenc.schedule_merges(np.asarray(self.merges, np.int32), cap=32)
            self._grouped_merges = (torch.from_numpy(gt).to(self.device),
                                    torch.from_numpy(gl).to(self.device))
        return self._grouped_merges

    def _merges_tensor(self) -> torch.Tensor:
        if self._device_merges is None:
            self._device_merges = torch.tensor(self.merges, dtype=torch.int32,
                                               device=self.device)
        return self._device_merges

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
        self._grouped_merges = None
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
