"""The lazy selection's verify batch for deep merge tables, A/B/C.

    python -m zigbpe_tpu_torch.probes select_batch [--mb 8] [--vocab 1280]

Port of ``scripts/ab_select_batch.py``. The conformance corpus tiled to
``nbytes`` is staged once (``train.upload``); then for ``select_batch`` 8,
16 and 32 in turn, ``train.train_device`` trains a clone of it (made
outside the span) to ``vocab``: one warm-up run, then the median of
``runs`` runs with the range (CUDA events on the card, the host clock on the
CPU). Every run of every batch must give the merges of the first run, or it
raises: the batch is a speed knob, never a change of result.
"""

from __future__ import annotations

import torch

from .. import train
from ..ops.core import resolve_device
from ..measure import device_field
from . import device_line, spread, time_runs
from .budget import tiled_corpus

BATCHES = (8, 16, 32)


def run(device="cuda", nbytes: int = 8 << 20, vocab: int = 1280, runs: int = 1) -> dict:
    """Train with each batch; print and return (median, min, max) ms and
    MB/s of each, and the merges. Raises if any run's merges differ."""
    dev = resolve_device(device)
    data = tiled_corpus(nbytes)
    tokens, length, ub_block = train.upload(data, dev)
    mb = len(data) / 1e6
    print(device_line(dev))
    state, ref, rows = {}, None, {}
    for batch in BATCHES:
        got = []

        def trained(batch=batch, got=got):
            got.append(train.train_device(state["toks"], length, vocab,
                                          ub_seed_block=ub_block, select_batch=batch))

        ms = time_runs(trained, dev, runs, setup=lambda: state.update(toks=tokens.clone()))
        ref = got[0] if ref is None else ref
        if any(m != ref for m in got):
            raise RuntimeError(f"select_batch={batch} diverges from select_batch={BATCHES[0]}")
        med, lo, hi = spread(ms)
        rows[batch] = {"ms": (med, lo, hi), "mbps": mb / (med / 1e3)}
        print(f"batch={batch:3d}: {med / 1e3:6.2f}s  {mb / (med / 1e3):6.2f} MB/s  "
              f"({len(ref)} merges)  [{lo / 1e3:.2f}-{hi / 1e3:.2f}s]")
    return {"device": device_field(dev), "vocab": vocab, "rows": rows, "merges": ref}
