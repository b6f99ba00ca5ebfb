"""The yardstick's table of peaks and the bytes a kernel's work needs."""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM part, at its 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(kind: str) -> float | None:
    peak = PEAKS.get(kind)
    return peak["hbm_bytes_per_s"] if peak else None


def encode_bytes(calls) -> int:
    """Device-memory bytes one batched replay of each call needs at least:
    every document token read once as int32, every id written once as
    int32, and one int32 length a document. Padding is not counted: it is
    the program's choice, not the inputs' need."""
    return sum(4 * c.nbytes + 4 * c.ids + 4 * c.docs for c in calls)
