"""Per-round split of the training hot loop: selection, merge and the rest.

    python -m zigbpe_tpu_torch.probes breakdown [--mb 32] [--rounds 64]

Port of ``scripts/profile_breakdown.py``. On the conformance corpus tiled
to ``nbytes``, staged as the trainer stages it (``train.upload``, the
table seeded from the host byte-pair histogram), three variants of
``rounds`` rounds each:

- ``full``: ``core.train_chunk_lazy`` at the capacity the trainer starts
  at, with the arguments the JAX script's call resolves to: the function's
  defaults ``select_batch=8`` and ``merge_group=1`` (one merge a pass; the
  trainer itself passes ``merge_group=4``). Its merges must equal the native
  trainer's first ``rounds``;
- ``replay``: ``core.encode_replay`` over the native trainer's first
  ``rounds`` merges: the merge passes alone;
- ``select``: ``core.select_top_pair_lazy`` ``rounds`` times with the merge
  stubbed: the found bin is zeroed and its row maximum recomputed, so the
  loop advances while the corpus never changes.

``derived`` gives merge (replay), select and other (full less both) in ms
a round. Then one ``merge_pass_multi`` launch at this capacity (the JAX
script's ``1pal_mrg``). The JAX script's ``1xla_mrg`` row times the XLA
formulation of the merge pass, which the port does not have: it is left
out.

Each row: one warm-up run, then the median of ``runs`` runs with the
range; CUDA events on the card, the host clock on the CPU. Every run starts
from copies of the staged stream and table made outside its span.
"""

from __future__ import annotations

import sys

import torch

from .. import train
from ..measure import device_field, host_ms
from ..native import fastio
from ..ops import core
from ..ops.core import resolve_device
from ..ops.kernels import merge as kmerge
from . import device_line, spread, time_runs
from .budget import tiled_corpus

SELECT_BATCH = 8  # train_chunk_lazy's defaults, which the JAX script's call takes
MERGE_GROUP = 1
ONE_PASS = (101, 32, 256)  # the JAX script's single pass: (e, space) -> 256


def select_chunk(tokens: torch.Tensor, ub: torch.Tensor, V: int, rounds: int) -> int:
    """``rounds`` lazy selections with the merge stubbed (``ub`` is updated
    in place); returns the sum of the selected counts."""
    u2 = ub.view(V, V)
    rm = core.rowmax_of(ub, V)
    acc = 0
    for _ in range(rounds):
        ta, tb, cnt, ub, rm = core.select_top_pair_lazy(ub, tokens, V, rowmax=rm)
        u2[ta, tb] = 0
        rm[ta] = u2[ta].max()
        acc += cnt
    return acc


def run(device="cuda", nbytes: int = 32 << 20, rounds: int = 64, runs: int = 5) -> dict:
    """Time the three variants and the single pass; print and return the
    rows ((median, min, max) ms of a whole variant) and the derived split
    (ms a round). Raises if ``full`` gives other merges than the native
    trainer."""
    dev = resolve_device(device)
    if not fastio.available():
        raise RuntimeError("the native library did not build: no merges to replay")
    V = 256 + rounds
    data = tiled_corpus(nbytes)
    gold, ms = host_ms(lambda: fastio.train(data, V), torch.device("cpu"))
    print(f"native train ({len(data)} bytes, {rounds} merges): {ms / 1e3:.2f}s", file=sys.stderr)
    mtab = torch.tensor(gold, dtype=torch.int32, device=dev).view(-1, 3)
    tokens, length, ub_block = train.upload(data, dev)
    ub0 = train._place_byte_hist(ub_block, V)
    state = {}

    def fresh_full():
        state.update(toks=tokens.clone(), ub=ub0.clone(),
                     mg=torch.full((rounds, 3), core.PAD, dtype=torch.int32, device=dev),
                     occ=torch.zeros((rounds,), dtype=torch.int32, device=dev))

    def full():
        state["out"] = core.train_chunk_lazy(
            state["toks"], length, state["ub"], state["mg"], state["occ"], 0, V, rounds,
            select_batch=SELECT_BATCH, merge_group=MERGE_GROUP)

    one = torch.tensor([ONE_PASS], dtype=torch.int32, device=dev)
    variants = {
        "full": (full, fresh_full),
        "replay": (lambda: core.encode_replay(state["toks"], mtab),
                   lambda: state.update(toks=tokens.clone())),
        "select": (lambda: select_chunk(tokens, state["ub"], V, rounds),
                   lambda: state.update(ub=ub0.clone())),
        "1pal_mrg": (lambda: kmerge.merge_pass_multi(state["toks"], one),
                     lambda: state.update(toks=tokens.clone())),
    }
    print(device_line(dev))
    print(f"breakdown: {len(data)} bytes at capacity {tokens.shape[0]}, {rounds} rounds, "
          f"select_batch {SELECT_BATCH}, merge_group {MERGE_GROUP}; median [min-max] of "
          f"{runs} runs")
    rows = {}
    for name, (fn, setup) in variants.items():
        rows[name] = spread(time_runs(fn, dev, runs, setup=setup))
        if name == "full":
            _, _, _, merges, _, k, _ = state["out"]
            if k != rounds or merges.tolist() != [list(m) for m in gold]:
                raise RuntimeError("full gave other merges than the native trainer")
        med, lo, hi = rows[name]
        per = f"  {med / rounds:8.3f} ms/round" if name != "1pal_mrg" else ""
        print(f"{name:8s}: {med:10.3f} ms total{per}  [{lo:.3f}-{hi:.3f}]")
    derived = {"merge": rows["replay"][0] / rounds, "select": rows["select"][0] / rounds,
               "other": (rows["full"][0] - rows["replay"][0] - rows["select"][0]) / rounds}
    print(f"\nderived: merge={derived['merge']:.3f} ms/rd  select~={derived['select']:.3f} "
          f"ms/rd  other~={derived['other']:.3f} ms/rd")
    return {"device": device_field(dev), "capacity": tokens.shape[0], "rounds": rounds,
            "select_batch": SELECT_BATCH, "merge_group": MERGE_GROUP, "rows": rows,
            "derived": derived}
