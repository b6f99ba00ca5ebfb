#!/usr/bin/env python3
"""Smoke run of the PyTorch port (zigbpe_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass:

1. build   — compile the CUDA kernels of ``zigbpe_tpu_torch/csrc/`` (one
             nvcc per source, all at once, sm_90a) and, beside them, the
             native host runtime (``zigbpe_tpu_torch/native/fastio.cpp``,
             g++) into ``zigbpe_tpu_torch/_build/``, and print the ptxas
             lines of the production kernels (the merge kernel's mask-0
             instantiation) and the largest register count and any spill of
             the ablated merge instantiations;
2. kernel  — the merge kernel (one launch a pass on a persistent grid)
             against its plain PyTorch twin (run on a CPU copy) at 1 tile,
             many tiles, a tile count that is no multiple of the grid (with a
             ragged last tile) and 2^25 tokens: K = 1 with a != b, K = 1 with
             a == b and runs spanning many tiles, K = 2, 3 and 4 groups from
             a real training run, disabled slots, a second pass on the
             row-local output and a draining degenerate corpus; the 2^25 K = 4
             and a == b passes 50 times each from one input (races in the
             look-back or the head read); two capacities in turns (each its
             own work array). Tokens and hit counts / new length must be
             equal and the min_kept <= 1 decision must agree;
   timing  — the K = 4, K = 1 a == b and K = 1 a != b passes at 2^25 tokens
             in turns with the kernel's copy variant and clone, and the twin,
             with CUDA events;
   verify  — the verify pass's count (count_queries, csrc/count.cu) against
             its twin on the card: the corpus's pair ids at 2^24 and 2^23
             slots under their 105 commonest pairs (int32 and int64
             queries, and with one pair in 30% of the slots), seeded ragged
             lengths up to 8192 queries, an all-PAD stream, and its geometry
             against the Python plan; timed at both lengths in turns with
             the twin and by device time (a CUDA graph), beside one read of
             the stream; then 1 MiB trained to vocab 400 on the card through
             it (its launches equal the verify passes) and on the CPU, with
             equal merges;
3. probes  — the measurement probes' kernels against their twins (run on
             the card): copy_blocks, copy_carry and copy_peek for int32 and
             int16 at R = 8 and every block size of the floor probe, at 2^25
             tokens of seeded data with negatives and on zeros, and their
             launch geometry against the Python plan; every variant of
             merge_pass_ablated at 1 tile, many tiles, 2^25 tokens and a run
             of a spanning every tile, with an a != b and an a == b table
             and 2- and 4-slot groups
             (tokens and hits / length equal, the min_kept <= 1 decision
             agreeing); opmix at 2^25 tokens, int32 and int16, reps 0/4/16,
             on seeded data and zeros; onehot_hist's launch geometry against
             the Python plan, and the kernel at 2^25 tokens for every V, S
             and mode of the hist probe (and S = 8 with skip), on the probe's
             tokens, on tokens with negatives, tokens past V and hit-free
             subchunks, on all zeros (every token a hit, one bin) and all
             ones (no hit, one bin); the lowering kernels at the shapes of
             scripts/probe_mosaic_ops.py on its values and seeded ones (all
             exact but dot_tn on normal values, rtol 1e-4, atol 1e-3), and
             rows_to_column and transpose also at ragged, misaligned, 2^25
             and tall (2^22, 1) shapes, each launch's geometry against the
             Python plan; onehot_dot exactly at 2^25 seeded tokens, on a
             column whose bin (0, 0) passes 2^24 and at ragged n, and
             dot_tn exactly on integer values at (2^20,8)^T(2^20,128) and
             ragged shapes, on normal values at K = 4096 (bitwise equal over
             repeats), with both C geometries against onehot_plan and
             dot_plan; both timed in turns with bincount / matmul at the
             script's shapes and at 2^25 tokens and (2^20,8)^T(2^20,128)
             (per call, device time from a CUDA graph, the bound). Each is
             timed against its twin (and one PyTorch
             call where one computes the same function) in spans of 20
             calls; in turns (kernel, call, call, kernel) with that call:
             copy_blocks with clone at 2^25 int16 and int32, copy_carry and
             copy_peek with copy_blocks, onehot_hist with bincount and on all
             zeros with the probe's tokens, and rows_to_column and transpose
             at the script's shape (also device time from a CUDA graph and
             host enqueue time) and at 2^25 int32, beside their bytes bound;
             iota_mod_add also by device time from a CUDA graph; then
             iota_mod_add exactly at (32, 128), (7, 5), (64, 1000) and
             (262144, 128) for several m, on a view 4 bytes off 16 (also
             through its entry: the scalar path) and past 2^32 elements
             on both paths (row slices), its geometry against iota_plan,
             and timed at 2^25 in turns with torch.add(x, r) and by device
             time beside its bytes bound. Then
             ``python -m zigbpe_tpu_torch.probes`` floor, pipeline (both
             tables), budget, alu16, hist and lowering run at full size and
             print their tables;
4. encode-kernel — the encode kernel against its twin (on a CPU copy) and
             the oracle, at rows of 1024 and 32768 tokens: every case of
             tests/test_encode_kernel.py, 8 seeds of the adversarial fuzz of
             tests/test_encode_fuzz.py (rebuilt here), and one 32768-byte run
             of ``a`` under doubling merges;
5. golden  — BasicTokenizer(device="cuda") trains the conformance corpus to
             vocab 300 (exactly tests/data/merges.txt), encodes it on the
             card (128,451 tokens, equal to the CPU twin path) and decodes
             it back; ``python -m zigbpe_tpu_torch.cli demo`` round-trips the
             probe;
6. scale   — the corpus tiled to 32 MiB, trained to vocab 512 on the card
             with the table seeded on the host (the native library must be
             built, and count_pairs must run twice: the host count, then its
             placement) and cross-checked against the native C++ trainer
             (the port's native runtime, zigbpe_tpu_torch.native.fastio);
             the 32 MiB corpus encoded on the card equals the native
             encoder's ids; the host seed and the device seed, and the
             native and Python reads of the 32 MiB file, timed in turns
             (``python -m zigbpe_tpu_torch.probes seed``);
7. sorted  — training past LAZY_VOCAB_MAX (sort-based selection, one
             K = 1 merge pass a round): BasicTokenizer(device="cuda") trains
             the conformance corpus to vocab 32768, exactly the native C++
             trainer's 32512 merges (computed on a thread from the end of
             phase 1); the corpus encodes on the card and decodes back, and
             its first 16 KiB encode to the native encoder's ids. The same
             training with a checkpoint directory, its checkpoint then
             rewound to 16000 merges and resumed on the card, and with
             detailed_stats (its sort_pairs / replace_pairs report printed)
             each give the same merges. The corpus tiled to 32 MiB trains to
             vocab 32768 (timed: MB/s, ms a merge, merge passes), and its
             first 256 merges equal phase 6's, which the lazy path chose.
             One selection is timed three ways on 32768 tokens and on the
             32 MiB: the port's (torch.unique counts the runs), the JAX
             function's cummax over run starts, and a binary search for
             each run's start; all three must agree;
   dp      — the data-parallel trainer (parallel/train_dp.py) in this
             process on an NCCL group of world size 1 on cuda:0: the 32 MiB
             tiled corpus to vocab 512 through train_dp (twice; equal to
             phase 6's merges, the native trainer's, with the table seeded
             on the host; MB/s, ms a merge, merge passes, collectives a
             round and the TimeStats phases); the host-seeded tables equal
             the device-seeded ones (replicated, fresh and resumed, and
             row-sharded), and the replicated ones are timed in turns;
             the conformance corpus to DP_SHARDED_VOCAB on the row-sharded
             table (equal to the native trainer's first merges);
             multihost.train_from_files on the 32 MiB in a file with a
             checkpoint every chunk, then resumed from the checkpoint rewound
             to DP_RESUME_AT merges (both equal to phase 6's); and one
             a == b and one a != b shard merge at the 32 MiB's shard size,
             with the running maximum two ways;
   dp-ranks — DP_RANKS child processes of this script on the one card, all
             on cuda:0, in a gloo group (NCCL takes no two ranks on one
             device), so shard boundaries and empty ranks run on the card:
             the conformance corpus to vocab 512 (a prefix of the native
             32768 merges; each rank checksums its replicated table and
             merges and all-gathers the checksums, which must agree),
             a == b runs across ranks to vocab 272 and b"aaab" to vocab 300
             (the port's oracle), the corpus to DP_RANKS_SHARDED_VOCAB on
             the row-sharded table (LAZY_VOCAB_MAX lowered to
             DP_RANKS_LAZY_VOCAB_MAX; a native prefix) and train_from_files
             to vocab 300 (tests/data/merges.txt; each rank reports the
             bytes it read); every rank must launch the merge kernel;
8. serving — BASELINE.json config 3: a 1024-merge table trained by the
             native trainer on the first 1 MiB, scheduled with
             schedule_merges(cap=32). BasicTokenizer(device="cuda")
             .encode_batch on the corpus cut into 101 documents (L = 16384)
             equals the CPU path and the native encoder, and on 1024 of the
             1 GiB's 32768-byte rows (L = 32768) equals the twin on the card
             and, on 16 rows, the native encoder; each call is one launch.
             The corpus tiled to 1 GiB (32,768 rows of 32,768 tokens) goes
             through the encode kernel in one launch, and 4096 rows spread
             over the batch equal the twin (run on the card) and 64 rows the
             native encoder. Times the kernel and the twin on 1024 rows, the
             kernel on the whole 1 GiB and encode_batch of the 1024 rows.
             On the 1024 rows: 20 launches from one input, each equal to the
             first; ids >= 65536 (the byte e moved to 70101 in rows and
             table) equal to the twin on 64 rows; and a pass split by part,
             four tables timed in turns (dead: every new id -1, so each pass
             is skipped; miss: pairs that never occur, so every token is
             probed and nothing hits; the real table; parity: a == b
             singletons), each equal to the twin on 64 rows;
9. bench   — the measurement entry points, each through its ``run`` in
             this process: ``zigbpe_tpu_torch.bench`` at 8 MiB to vocab 512
             (one timed run); config 2
             (``scripts.run_config2``) at 16 MiB and 512 merges, equal to
             the native trainer and through merges.txt and back; config 3
             (``scripts.run_config3``) at the full 1 GiB, whose 307,958,775
             tokens out in 47 fused passes must be the TPU run's
             (CONFIG3_r5.json); ``probes breakdown`` at 8 MiB and 64
             rounds (its ``full`` equal to the native trainer); ``probes
             encode`` at 1 GiB under the ``group_merges`` table, giving
             config 3's tokens out; ``probes select_batch`` at 8 MiB to
             vocab 512, its three batches equal to the native trainer;
10. count  — each kernel's launch counter, zeroed just before its path
             (the probe kernels: the six probes of phase 3; merge: phases
             5-6, and again phase 7, and again dp, and again bench;
             encode: the two encode_batch calls of phase 8, and again
             bench), is > 0 just after it; each dp-ranks child counts its
             own from zero.

Prints each phase's result and wall time, then a JSON line of kernels, the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Exits non-zero without a result when there
is no CUDA device or any phase fails.

    python3 chip_smoke.py --encode-split

builds only the encode kernel, prints its ptxas line, runs phase 4's cases
and the pass split of phase 8 on the first 1024 serving rows, and stops.

    python3 chip_smoke.py --bench

builds the merge and encode kernels and the native library, runs phase 9
alone, and stops.

    python3 chip_smoke.py --count

builds the count kernel, prints its ptxas lines, runs the verify phase
alone, and stops.

    python3 chip_smoke.py --products [--time-only]

builds the lowering kernels, prints their ptxas lines, holds onehot_dot,
dot_tn and iota_mod_add to their twins and their plans (not with
--time-only, which any version of the three wrappers runs), reads bin
(0, 0) of the fault column, times the products at the five shapes of
phase 3 and iota_mod_add at 2^25, and stops.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from zigbpe_tpu_torch.native import fastio
from zigbpe_tpu_torch.probes import (INT32_LANES_PER_SM, SMS, bound_ms, int32_bound_ms,
                                      max_sm_clock_hz, smem_bound_ms, time_runs)
from zigbpe_tpu_torch.probes.budget import tiled_corpus

ROOT = pathlib.Path(__file__).resolve().parent
CORPUS = ROOT / "tests" / "data" / "taylorswift.txt"
GOLDEN = ROOT / "tests" / "data" / "merges.txt"
PROBE = "hello world!!!? (안녕하세요!) lol123 😉"
SCALE_BYTES = 32 << 20  # bench.py's headline corpus: 32 MiB
SCALE_VOCAB = 512       # 256 merges
GOLDEN_TOKENS = 128451
SERVE_BYTES = 1 << 30   # BASELINE.json config 3: 1 GiB ...
SERVE_ROW = 32768       # ... as rows of 32768 tokens ...
SERVE_MERGES = 1024     # ... under a frozen 1K-merge table
SERVE_TABLE_BYTES = 1 << 20  # trained on the first 1 MiB, as bench.py does
SERVE_DOCS = 1024       # config 3's rows sent through encode_batch
SORTED_VOCAB = 32768    # past LAZY_VOCAB_MAX: Mistral-7B-v0.3's vocab_size
SORTED_SCALE_BYTES = 32 << 20  # the tiled corpus trained to SORTED_VOCAB
SORTED_HEAD_BYTES = 16 << 10   # encoded on the card against the native encoder
SORTED_RESUME_AT = 16000       # merges kept when the checkpoint is rewound
# the dp phase's row-sharded run, held against the first merges of
# native_32768: vocab 32768 took 206.6-399.4 s there (6.4-12.3 ms a round,
# host-bound: about 290 launches and five host syncs a round)
DP_SHARDED_VOCAB = 16384
DP_RESUME_AT = 128             # merges kept when the dp checkpoint is rewound
DP_FILES_CHUNK = 128           # rounds a chunk there: a checkpoint of the 32 MiB a chunk
DP_RANKS = 4                   # gloo ranks of the dp-ranks phase, all on cuda:0
# their row-sharded run: the conformance corpus to 1024 with LAZY_VOCAB_MAX
# lowered to 257 (as the CPU tests lower it), so the four ranks own rows
# 0-255, 256-511, 512-767 and 768-1023 and every new row lands on another
# rank. Vocab 9000 took 520.0 s there: 8744 rounds of about 7.8 collectives
# at 7.7 ms each through gloo with four processes on one card.
DP_RANKS_SHARDED_VOCAB = 1024
DP_RANKS_LAZY_VOCAB_MAX = 257
DP_PARITY = (b"a" * 9000 + b"bc" * 600 + b"a" * 7000, 272)  # a == b runs across ranks
DP_TINY = (b"aaab", 300)       # fewer bytes than ranks: some start empty
DP_GROUP_TIMEOUT_S = 300       # a collective that waits longer raises
# the bench phase: the measurement entry points at sizes that keep it short
BENCH_BYTES = 8 << 20          # bench (one timed run), breakdown and select_batch
BENCH_ROUNDS = 64              # breakdown's rounds
BENCH_SELECT_VOCAB = 512       # select_batch's vocab
CONFIG2_BYTES = 16 << 20       # config 2 cut from 100 MiB ...
CONFIG2_MERGES = 512           # ... and 1024 merges
# config 3 at its full 1 GiB (SERVE_BYTES), as CONFIG3_r5.json recorded it on
# the TPU: these depend only on the bytes
CONFIG3_TOKENS_OUT = 307_958_775
CONFIG3_PASSES = 47
KERNELS = ("merge", "encode", "copy", "opmix", "hist", "lowering", "count")
# the verify pass of lazy selection on the 1K trainer's streams: 16 and 8 MiB
# of bytes, vocab 1280, 105 queries a pass (select_batch 32)
COUNT_STREAMS = (1 << 24, 1 << 23)
COUNT_VOCAB = 1280
COUNT_QUERIES = 105
COUNT_TRAIN_BYTES = 1 << 20  # trained to COUNT_TRAIN_VOCAB on the card and on the CPU
COUNT_TRAIN_VOCAB = 400


class PhaseError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def padded(data: bytes, cap: int) -> np.ndarray:
    arr = np.full(cap, -1, np.int32)
    arr[: len(data)] = np.frombuffer(data, np.uint8)
    return arr


def commonest_repeat() -> int:
    """The byte b whose pair (b, b) is commonest in the corpus."""
    b = np.frombuffer(CORPUS.read_bytes(), np.uint8)
    return int(np.bincount(b[:-1][b[:-1] == b[1:]], minlength=256).argmax())


def first_group(merges, K: int = 4):
    """The first K consecutive trained merges that form a valid group for
    one simultaneous pass: distinct, chain-free both ways, a != b past slot
    0, no slot referencing another slot's minted token."""
    for s in range(len(merges) - K + 1):
        g = merges[s: s + K]
        minted = {x for _, _, x in g}
        ok = all(a != b for a, b, _ in g[1:]) and len({(a, b) for a, b, _ in g}) == K
        ok = ok and not any(a in minted or b in minted for a, b, _ in g)
        ok = ok and all(g[i][1] != g[j][0] for i in range(K) for j in range(K) if i != j)
        if ok:
            return [list(m) for m in g]
    raise PhaseError("no valid 4-merge group in the trained table")


def first_difference(got, want) -> int:
    """Index of the first merge at which two merge lists differ."""
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                min(len(got), len(want)))


# ------------------------------------------------------------------ native

def native_train(data: bytes, vocab: int):
    """The native C++ trainer's merges (the port's host runtime,
    zigbpe_tpu_torch/native/fastio.cpp, built with g++ in phase 1)."""
    return fastio.train(data, vocab)


def native_encode(data: bytes, merges) -> np.ndarray:
    return np.asarray(fastio.encode(data, merges), np.int32)


# ------------------------------------------------------------------ phases

def log_ptxas(name: str, path: pathlib.Path) -> None:
    """Print the ptxas lines (registers, shared memory, spills) of the
    production kernels in ``path``'s build log, and the largest register
    count and any spill of the ablated merge instantiations."""
    ablated = []  # (registers, spill bytes, kernel)
    for entry in path.with_suffix(".log").read_text().split("Compiling entry function")[1:]:
        fn = re.search(r"[a-z_]+_kernel(I\w*?EE)?", entry)[0]
        # merge.cu's kernel is a template on the slots it tests and an
        # ablation mask: the production pass is mask 0 (Lj0E), the
        # others are the probes'
        if re.search(r"merge_kernelILi\dELj[1-9]\d*E", fn):
            ablated.append((int(re.search(r"Used (\d+) registers", entry)[1]),
                            int(re.search(r"(\d+) bytes spill stores", entry)[1]), fn))
        else:
            log(f"  ptxas {name} {fn}: " + "; ".join(
                line.strip() for line in entry.splitlines()
                if "registers" in line or "spill" in line))
    if ablated:
        spills = ", ".join(f"{fn} {b} B" for _, b, fn in ablated if b) or "none"
        log(f"  ptxas {name}: {len(ablated)} ablated instantiations, at most "
            f"{max(r for r, _, _ in ablated)} registers, spill stores: {spills}")


def phase_build():
    from zigbpe_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()

    def timed(name):
        t = time.perf_counter()
        path = _build.build(name)
        return path, time.perf_counter() - t

    def timed_native():
        t = time.perf_counter()
        return fastio.build(), time.perf_counter() - t

    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        native = pool.submit(timed_native)
        built = list(pool.map(timed, KERNELS))
    for name, (path, secs) in zip(KERNELS, built):
        log_ptxas(name, path)
        log(f"[build] ok: {path.relative_to(ROOT)} in {secs:.2f} s")
    ok, secs = native.result()
    require(ok and fastio.available(), "the native library did not build (g++)")
    log(f"[build] ok: native host runtime {fastio.library_path().relative_to(ROOT)} "
        f"(g++ {' '.join(fastio.CXX_FLAGS)}) in {secs:.2f} s")
    log(f"[build] all {len(KERNELS)} kernels and the native library built in "
        f"{time.perf_counter() - t0:.2f} s")
    return {name: secs for name, (_, secs) in zip(KERNELS, built)}


def merge_agrees(torch, got, gstats, want, wstats, K: int) -> bool:
    """Tokens, hits and length equal; the min_kept <= 1 decision agrees."""
    gs, ws = gstats.cpu(), wstats.cpu()
    return (torch.equal(got, want) and gs[: K + 1].tolist() == ws[: K + 1].tolist()
            and bool((gs[K + 1] <= 1) == (ws[K + 1] <= 1)))


def repeat_check(torch, km, label: str, arr: np.ndarray, table, reps: int) -> None:
    """``reps`` passes of the kernel from the same input, each equal to the
    twin's pass: a race in the look-back or the head read would show as one
    pass that differs."""
    t = torch.tensor(table, dtype=torch.int32).reshape(-1, 3)
    want, wstats = km.merge_pass_multi_reference(torch.from_numpy(arr.copy()), t)
    src, want, t = (x.cuda() for x in (torch.from_numpy(arr), want, t))
    work = torch.empty_like(src)
    for r in range(reps):
        work.copy_(src)
        _, gstats = km.merge_pass_multi(work, t)
        require(merge_agrees(torch, work, gstats, want, wstats, t.shape[0]),
                f"{label} pass {r} of {reps} from one input != twin: gpu {gstats.tolist()} "
                f"twin {wstats.tolist()}")
    log(f"  {label} n={arr.size}: {reps} passes from one input, each == twin "
        f"(stats {wstats.tolist()})")


def alternate_check(torch, km, caps, group, aa: int, rounds: int = 3) -> None:
    """Passes at two capacities in turns on one device, each equal to the
    twin: each capacity keeps its own work array between its passes."""
    rng = np.random.default_rng(11)
    inputs = {cap: padded(tiled_corpus(cap - int(rng.integers(1, 300))), cap) for cap in caps}
    for _ in range(rounds):
        for cap, arr in inputs.items():
            for table in (group, [(aa, aa, 256)]):
                t = torch.tensor(table, dtype=torch.int32)
                want, wstats = km.merge_pass_multi_reference(torch.from_numpy(arr.copy()), t)
                got, gstats = km.merge_pass_multi(torch.from_numpy(arr).cuda(), t.cuda())
                require(merge_agrees(torch, got.cpu(), gstats, want, wstats, t.shape[0]),
                        f"alternating capacities: cap {cap} table {table} != twin")
    dev = torch.device("cuda", torch.cuda.current_device())
    require(all((dev, cap) in km._work for cap in caps), "a capacity lost its work array")
    log(f"  capacities {list(caps)} in turns, {rounds} rounds x 2 tables: each pass == twin, "
        f"one work array each")


def phase_kernel(torch, group, group2):
    from zigbpe_tpu_torch.ops.kernels import merge as km

    worst = 0

    def check(name, arr, table):
        nonlocal worst
        table = np.asarray(table, np.int32).reshape(-1, 3)
        K = table.shape[0]
        gtok, gstats = km.merge_pass_multi(
            torch.from_numpy(arr.copy()).cuda(), torch.from_numpy(table).cuda()
        )
        torch.cuda.synchronize()
        ctok, cstats = km.merge_pass_multi_reference(
            torch.from_numpy(arr.copy()), torch.from_numpy(table)
        )
        g, c = gtok.cpu().numpy(), ctok.numpy()
        gs, cs = gstats.cpu().numpy(), cstats.numpy()
        err = int(np.abs(g.astype(np.int64) - c).max())
        err = max(err, int(np.abs(gs[: K + 1].astype(np.int64) - cs[: K + 1]).max()))
        worst = max(worst, err)
        same = err == 0 and (gs[K + 1] <= 1) == (cs[K + 1] <= 1)
        log(f"  {name:34s} n={arr.size:>9} K={K} stats={gs.tolist()} "
            f"max_abs_err={err} {'ok' if same else 'MISMATCH'}")
        require(same, f"kernel != twin on {name}: gpu {gs.tolist()} cpu {cs.tolist()}")
        return c, int(cs[K + 1])

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    aa = commonest_repeat()
    disabled = [group[0], [-2, -2, -2], [-2, -2, -2], group[1]]
    # a tile count that is no multiple of the persistent grid, and a ragged
    # last tile
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grids = {K: km.launch_grid(1 << 25, K) for K in range(1, 5)}
    grid = grids[4]
    odd_cap = (2 * grid + grid // 2 + 7) * 4096 - 5 * 128
    log("  persistent grid at 2^25 tokens: " + ", ".join(
        f"K={K} {b} blocks ({b / sms:g} an SM)" for K, b in grids.items())
        + f"; odd capacity {odd_cap} = {odd_cap / 4096:.2f} tiles")
    for cap in (4096, 128 * 1000, odd_cap, 1 << 25):
        arr = padded(tiled_corpus(cap - int(rng.integers(1, 300))), cap)
        check(f"K=1 a!=b cap={cap}", arr, [group[0]])
        check(f"K=1 a==b cap={cap}", arr, [(aa, aa, 256)])
        check(f"K=2 real group cap={cap}", arr, group[:2])
        check(f"K=3 real group cap={cap}", arr, group[:3])
        mid, _ = check(f"K=4 real group cap={cap}", arr, group)
        check(f"K=4 disabled slots cap={cap}", arr, disabled)
        check(f"K=4 next group, 2nd pass cap={cap}", mid, group2)
    big = padded(tiled_corpus((1 << 25) - 77), 1 << 25)
    for label, table in (("K=4", group), ("K=1 a==b", [(aa, aa, 256)])):
        repeat_check(torch, km, label, big, table, 50)
    alternate_check(torch, km, (4096 * 3 + 128 * 7, 128 * 1000), group, aa)
    run = padded(b"a" * ((1 << 20) - 3) + b"xy", 1 << 20)
    for r in range(3):  # the a-run spans every tile; each pass halves it
        t = 97 if r == 0 else 255 + r
        run, _ = check(f"a-run spanning tiles r={r}", run, [(t, t, 256 + r)])
    drain = padded(b"a" * 1024 + b"bcd" * 400, 4096)
    flagged = False
    for r in range(10):
        t = 97 if r == 0 else 255 + r
        drain, min_kept = check(f"draining corpus r={r}", drain, [(t, t, 256 + r)])
        if min_kept <= 1:  # the trainers' contract: recompact now
            flagged = True
            drain = np.concatenate([drain[drain >= 0], drain[drain < 0]])
    require(flagged, "the draining corpus never reported min_kept <= 1")
    log(f"[kernel] ok: kernel == twin on every case, max_abs_err {worst}, "
        f"{time.perf_counter() - t0:.1f} s")
    return worst


def time_pass(fn, src, table, reps):
    """Mean ms of fn(tokens, table) over ``reps`` runs after a warm-up, on a
    fresh copy of ``src`` each run, CUDA events around the pass only."""
    work = src.clone()
    return statistics.fmean(time_runs(lambda: fn(work, table), src.device, reps,
                                      setup=lambda: work.copy_(src)))


def phase_timing(torch, group, card):
    """Each pass at 2^25 tokens (K = 4 real group, K = 1 a == b, K = 1
    a != b) in turns with the kernel's ``copy`` variant (its own floor) and
    ``clone`` (pass, copy, clone, clone, copy, pass), and the plain twin.
    Returns {label: (kernel ms, twin ms)}."""
    from zigbpe_tpu_torch.ops.kernels import merge as km

    aa = commonest_repeat()
    src = torch.from_numpy(padded(tiled_corpus((1 << 25) - 100), 1 << 25)).cuda()
    bound, by = bound_ms(2 * 4 * (1 << 25))
    fns = {"pass": km.merge_pass_multi, "copy": lambda w, t: km.merge_pass_ablated(w, t, "copy"),
           "clone": lambda w, t: w.clone()}
    out = {}
    for label, table in (("K=4", group), ("K=1 a==b", [[aa, aa, 256]]),
                         ("K=1 a!=b", [group[0]])):
        t = torch.tensor(table, dtype=torch.int32, device="cuda")
        runs = {name: [] for name in fns}
        for name in ("pass", "copy", "clone", "clone", "copy", "pass"):
            runs[name].append(time_pass(fns[name], src, t, 20))
        ms, cp, cl = (statistics.fmean(runs[name]) for name in fns)
        plain = time_pass(km.merge_pass_multi_reference, src, t, 5)
        log(f"[timing] merge pass at 2^25 tokens, {label}: kernel {ms:.4f} ms "
            f"({runs['pass'][0]:.4f}, {runs['pass'][1]:.4f}), copy variant {cp:.4f}, clone "
            f"{cl:.4f} (in turns); kernel / copy {ms / cp:.3f}, kernel / clone {ms / cl:.3f}, "
            f"bound {bound:.4f} ms ({by}), share of bound {bound / ms:.3f}; plain PyTorch twin "
            f"{plain:.4f} ms (CUDA events, mean); {card}")
        out[label] = (ms, plain)
    return out


def count_case(torch, n: int):
    """The trainer's first verify pass on ``n`` bytes of the tiled corpus:
    its packed pair-id stream at COUNT_VOCAB and, as queries, the
    COUNT_QUERIES commonest pairs (the bounds lazy selection pops first)."""
    from zigbpe_tpu_torch.ops import core

    tokens = torch.from_numpy(padded(tiled_corpus(n), n)).cuda()
    a, b = core.pair_streams(tokens, 128)
    pids = torch.where(b >= 0, a * COUNT_VOCAB + b, -1)
    held, counts = torch.unique(pids[pids >= 0], return_counts=True)
    return pids, held[counts.argsort(descending=True)[:COUNT_QUERIES]].long()


def check_count(torch, card: str) -> dict:
    """count_queries against its twin (run on the card): on the corpus's
    pair ids at COUNT_STREAMS, with one pair in 30% of the slots, on an
    all-PAD stream, at ragged lengths and up to MAX_QUERIES queries, int32
    and int64; the C geometry against count_plan. Then timed at
    COUNT_STREAMS with COUNT_QUERIES queries in turns with the twin (kernel,
    twin, twin, kernel; CUDA events, per call) and by device time (a CUDA
    graph), beside its bound: one read of the stream. Returns the kernels
    line's row at 2^24."""
    from zigbpe_tpu_torch.ops.kernels import count as kc

    def same(pids, q, what):
        got, want = kc.count_queries(pids, q), kc.count_queries_reference(pids, q)
        require(torch.equal(got, want), f"count_queries != twin: {what}, max_abs_err "
                f"{int((got - want).abs().max())}")

    g = torch.Generator(device="cuda").manual_seed(41)
    for n in COUNT_STREAMS:
        pids, q = count_case(torch, n)
        same(pids, q, f"corpus n={n}")
        same(pids, q.int(), f"corpus n={n}, int32 queries")
        hot = torch.where(torch.rand(n, generator=g, device="cuda") < 0.3, q[0].int(), pids)
        same(hot, q, f"30% one pair n={n}")
    # the twin holds a Q x min(n, 2^20) comparison and its int64 cast: wide
    # query sets only on short streams
    cases = [(n, nq) for n in (0, 1, 3, 1000, 4096 * 4 + 7) for nq in (1, 105, 4096,
                                                                        kc.MAX_QUERIES)]
    for n, nq in cases + [((1 << 23) + 3, 1), ((1 << 23) + 3, 105)]:
        pids = torch.randint(-1, 5 * nq, (n,), generator=g, device="cuda", dtype=torch.int32)
        q = torch.randint(0, 6 * nq, (nq,), generator=g, device="cuda")
        same(pids, q, f"seeded n={n} nq={nq}")
    same(torch.full((1 << 22,), -1, dtype=torch.int32, device="cuda"),
         torch.arange(COUNT_QUERIES, device="cuda"), "all PAD")
    for n, nq in ((1 << 24, 105), (1 << 23, 57), (3, 1), (0, 5), (4096, 8192), (1 << 20, 512)):
        got = kc.device_plan(n, nq)
        require(got == kc.count_plan(n, nq, got.sms, got.blocks_per_sm),
                f"count geometry {got} != plan at n={n} nq={nq}")
    log(f"  count_queries == twin: the corpus's pairs at {COUNT_STREAMS} (int32 and int64 "
        f"queries, and 30% one pair), seeded ragged lengths up to {kc.MAX_QUERIES} queries, all "
        f"PAD; C geometry == Python plan ({got.sms} SMs)")
    row = None
    for n in COUNT_STREAMS:
        pids, q = count_case(torch, n)
        ks, ts = in_turns(lambda: kc.count_queries(pids, q),
                          lambda: kc.count_queries_reference(pids, q), pids.device)
        dev_ms = graph_ms(torch, lambda: kc.count_queries(pids, q))
        ms, plain = statistics.fmean(ks), statistics.fmean(ts)
        bound, by = bound_ms(4 * n)
        plan = kc.device_plan(n, COUNT_QUERIES)
        log(f"[verify] count_queries at n = {n}, {COUNT_QUERIES} queries (the corpus's commonest "
            f"pairs at vocab {COUNT_VOCAB}): kernel {ms:.4f} ms ({ks[0]:.4f}, {ks[1]:.4f}), "
            f"device (CUDA graph of 20) {dev_ms:.5f} ms, plain PyTorch twin {plain:.4f} ms "
            f"({ts[0]:.4f}, {ts[1]:.4f}); bound {bound:.4f} ms ({by}), device share of bound "
            f"{bound / dev_ms:.3f}; grid {plan.grid} x {kc.THREADS}, table 2^{plan.bits}, "
            f"{plan.copies} copies of each count; {card}")
        if row is None:
            row = {"max_abs_err": 0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                   "bound_ms": bound, "bound_by": by, "library_ms": None}
    return row


def train_counted(torch) -> int:
    """COUNT_TRAIN_BYTES of the tiled corpus to COUNT_TRAIN_VOCAB on the card,
    whose merges must be the CPU's; returns the count kernel's launches."""
    from zigbpe_tpu_torch import BasicTokenizer
    from zigbpe_tpu_torch.ops.kernels import count as kc

    text = tiled_corpus(COUNT_TRAIN_BYTES)
    kc.count_queries.launches = 0
    tok = BasicTokenizer(device="cuda").train(text, COUNT_TRAIN_VOCAB)
    launches = kc.count_queries.launches
    require(launches > 0, "the count kernel never launched in training")
    require(tok.time_stats.counters["verify_passes"] == launches,
            f"{launches} count launches for {tok.time_stats.counters['verify_passes']} passes")
    require(tok.merges == BasicTokenizer(device="cpu").train(text, COUNT_TRAIN_VOCAB).merges,
            "training on the card learned other merges than on the CPU")
    log(f"[verify] ok: {COUNT_TRAIN_BYTES} bytes to vocab {COUNT_TRAIN_VOCAB}: the CPU's merges, "
        f"{launches} count launches ({tok.time_stats.counters['verify_queries']} queries)")
    return launches


def count_main(torch, card: str) -> int:
    """``python3 chip_smoke.py --count``: build the count kernel, print its
    ptxas lines, check and time it, and train once through it."""
    from zigbpe_tpu_torch.ops.kernels import _build

    log_ptxas("count", _build.build("count"))
    row = run_phase("verify", check_count, torch, card)
    launches = train_counted(torch)
    print(json.dumps({"count_queries": {"launches": launches, **row}, "card": card}))
    return 0


COPY_KERNELS = ("copy_blocks", "copy_carry", "copy_peek")
PROBE_SOURCES = (  # (kernel, source, the TPU kernel's pallas_call it replaces)
    ("merge_pass_ablated", "zigbpe_tpu_torch/csrc/merge.cu",
     "scripts/probe_merge_budget.py:287"),
    ("copy_blocks", "zigbpe_tpu_torch/csrc/copy.cu",
     "scripts/probe_floor.py:37; scripts/probe_pipeline.py:39, :168"),
    ("copy_carry", "zigbpe_tpu_torch/csrc/copy.cu", "scripts/probe_pipeline.py:65"),
    ("copy_peek", "zigbpe_tpu_torch/csrc/copy.cu", "scripts/probe_pipeline.py:98"),
    ("opmix", "zigbpe_tpu_torch/csrc/opmix.cu", "scripts/probe_alu16.py:66"),
    ("onehot_hist", "zigbpe_tpu_torch/csrc/hist.cu", "scripts/probe_hist.py:88"),
    ("rows_to_column", "zigbpe_tpu_torch/csrc/lowering.cu", "scripts/probe_mosaic_ops.py:21"),
    ("transpose", "zigbpe_tpu_torch/csrc/lowering.cu", "scripts/probe_mosaic_ops.py:21"),
    ("iota_mod_add", "zigbpe_tpu_torch/csrc/lowering.cu", "scripts/probe_mosaic_ops.py:21"),
    ("dot_tn", "zigbpe_tpu_torch/csrc/lowering.cu", "scripts/probe_mosaic_ops.py:21, :77"),
    ("onehot_dot", "zigbpe_tpu_torch/csrc/lowering.cu", "scripts/probe_mosaic_ops.py:97"),
)
PROBE_KERNELS = tuple(name for name, _, _ in PROBE_SOURCES)
DOT_RTOL, DOT_ATOL = 1e-4, 1e-3  # dot_tn on normal values: f32 sums in another order


def probe_wrappers() -> dict:
    """Each probe kernel's wrapper, whose ``launches`` counts its launches."""
    from zigbpe_tpu_torch.ops.kernels import copy as kc, hist as kh, lowering as kl
    from zigbpe_tpu_torch.ops.kernels import merge as km, opmix as ko

    return {"merge_pass_ablated": km.merge_pass_ablated,
            **{name: getattr(kc, name) for name in COPY_KERNELS},
            "opmix": ko.opmix, "onehot_hist": kh.onehot_hist,
            **{fn.__name__: fn for fn in kl.KERNELS}}


def per_call_ms(fn, device, calls: int = 20, runs: int = 5) -> float:
    """Mean ms per call of ``fn()`` over ``runs`` spans of ``calls`` calls
    back to back (CUDA events), so that a span holds device time and not
    the host's launch gap."""
    return statistics.fmean(time_runs(lambda: [fn() for _ in range(calls)], device,
                                      runs)) / calls


def abs_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def opmix_input(torch, rows: int, dtype, R: int = 256):
    """Seeded tokens from {-1, 32, 101, 300, 0..400} on the card, with 101
    before 32 inside blocks and across every block's end."""
    g = torch.Generator(device="cuda").manual_seed(9)
    pool = torch.tensor([-1, 32, 101, 300] * 40 + list(range(401)), dtype=dtype, device="cuda")
    x = pool[torch.randint(0, pool.numel(), (rows * 128,), generator=g, device="cuda")]
    heads = torch.nonzero(x[:-1] == 101).view(-1)[::2]
    x[heads + 1] = 32
    x[R * 128 - 1::R * 128] = 101
    x[R * 128::R * 128] = 32
    return x.view(rows, 128)


def sass_counts(path: pathlib.Path) -> dict:
    """Instructions of each kernel in a built library, NOPs left out, by
    mangled name (``cuobjdump -sass``)."""
    from zigbpe_tpu_torch.ops.kernels import _build

    tool = pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head[1]
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?[A-Z]", line) \
                and not re.search(r"\bNOP\b", line):
            counts[name] += 1
    return counts


def opmix_ops_per_token_rep(elem: int) -> float | None:
    """SASS instructions a thread issues per token and rep in the op mix:
    the reps-16 kernel's count less the reps-0 kernel's (both straight-line
    code), over 16 reps of the 32 / elem tokens a lane holds; None when the
    SASS shows neither."""
    from zigbpe_tpu_torch.ops.kernels import _build

    counts = sass_counts(_build.build("opmix"))
    by = {}
    for fn, n in counts.items():
        m = re.search(r"opmix_kernelILi(\d)ELi(\d+)E", fn)
        if m:
            by[int(m[1]), int(m[2])] = n
    if (elem, 16) not in by or (elem, 0) not in by:
        return None
    return (by[elem, 16] - by[elem, 0]) / (16 * (32 // elem))


def check_opmix(torch, rows: int, card: str) -> dict:
    from zigbpe_tpu_torch.ops.kernels import opmix as ko
    from zigbpe_tpu_torch.probes import alu16

    worst = 0
    for dtype in (torch.int32, torch.int16):
        data = opmix_input(torch, rows, dtype)
        for label, x in (("seeded", data), ("zeros", torch.zeros_like(data))):
            for reps in alu16.REPS:
                got, want = ko.opmix(x, 256, reps), ko.opmix_reference(x, 256, reps)
                err = int((got.long() - want.long()).abs().max())
                worst = max(worst, err)
                require(err == 0 and got.dtype == x.dtype,
                        f"opmix != twin: {dtype} reps={reps} {label}, max_abs_err {err}")
        fired = int((ko.opmix_reference(data, 256, 1) == 300).sum() - (data == 300).sum())
        log(f"  opmix == twin: {dtype}, 2^25 tokens, R = 256, reps {alu16.REPS}, seeded "
            f"({fired} candidates fire in one rep) and zeros")
    out = {}
    for dtype in (torch.int16, torch.int32):  # int32 last: its row is the JSON's
        x = torch.zeros((rows, 128), dtype=dtype, device="cuda")
        ms = per_call_ms(lambda: ko.opmix(x, 256, 16), x.device)
        plain = per_call_ms(lambda: ko.opmix_reference(x, 256, 16), x.device, calls=5, runs=3)
        bytes_ms, _ = bound_ms(2 * x.numel() * x.element_size())
        # the integer work: SASS instructions per token and rep on every
        # INT32 lane at the card's maximum SM clock
        per = opmix_ops_per_token_rep(x.element_size())
        clock = max_sm_clock_hz()
        alu_ms = int32_bound_ms(per * 16 * x.numel(), clock) if per is not None else 0.0
        bound, by = (alu_ms, "operations") if alu_ms > bytes_ms else (bytes_ms, "bytes")
        alu = (f"{alu_ms:.4f} ms ({per:.3f} SASS instructions a token and rep over {SMS} SMs "
               f"x {INT32_LANES_PER_SM} lanes at {clock / 1e9:.3f} GHz)" if per is not None
               else "not measured (no SASS of the kernel)")
        log(f"[probes] opmix {dtype} at 2^25 tokens, R = 256, reps 16: kernel {ms:.4f} ms, "
            f"plain PyTorch twin {plain:.4f} ms; bound {bound:.4f} ms ({by}): bytes "
            f"{bytes_ms:.4f} ms, INT32 {alu}; kernel / bound {ms / bound:.3f}; {card}")
        out = {"max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bound,
               "bound_by": by, "library_ms": None}
    return out


def hist_edge_tokens(torch, rows: int):
    """Seeded tokens in [-300, 5000) on the card (negatives and tokens past
    every V count nowhere) in which every third 32-row subchunk has no
    multiple of 7."""
    g = torch.Generator(device="cuda").manual_seed(13)
    t = torch.randint(-300, 5000, (rows, 128), generator=g, device="cuda", dtype=torch.int32)
    sub = t.view(-1, 32 * 128)
    sub[1::3] += (sub[1::3] % 7 == 0).to(torch.int32)
    return t


HIST_PLAN_CASES = (  # (rows, R, S, vocab, density_mod, skip): the probe's, ragged, extremes
    (262144, 256, 32, 4352, 7, False), (262144, 256, 8, 512, 7, True),
    (262144, 256, 32, 1280, 0, True), (262080, 96, 96, 4608, 7, True), (77, 77, 1, 1, 3, True),
    (8, 8, 8, 129, 1, False), (24, 24, 8, 4608, 2, True))


def check_hist_plans() -> None:
    """The geometry zbpe_hist launches (zbpe_hist_plan) equals hist_plan at
    the card's SM count and occupancy, for every instantiation."""
    from zigbpe_tpu_torch.ops.kernels import hist as kh

    pers = set()
    for args in HIST_PLAN_CASES:
        shown = kh.device_plan(*args)
        want = kh.hist_plan(*args, shown.sms, shown.blocks_per_sm)
        require(shown == want, f"hist geometry for {args}: C side {shown} != plan {want}")
        pers.add((shown.per, args[-1]))
    require(len(pers) == 3, f"the hist plan cases miss an instantiation: {sorted(pers)}")
    log(f"  onehot_hist: C geometry == Python plan on {len(HIST_PLAN_CASES)} cases "
        f"(3 instantiations; {shown.sms} SMs)")


def check_hist(torch, rows: int, card: str) -> dict:
    from zigbpe_tpu_torch.ops.kernels import hist as kh
    from zigbpe_tpu_torch.probes import hist as hp

    check_hist_plans()
    worst = 0
    x = hp.tokens(rows * 128, torch.device("cuda"))
    edge = hist_edge_tokens(torch, rows)
    zeros = torch.zeros_like(x)  # every token 0, a hit: one bin
    ones = torch.ones_like(x)    # every token 1, no hit: one bin
    cases = hp.CASES + (("S= 8 skip-on dense", 8, hp.DENSITY, True),)
    for label, data in (("probe tokens", x), ("edge tokens", edge), ("all zeros", zeros),
                        ("all ones", ones)):
        for V in hp.VOCABS:
            for name, S, dmod, skip in cases:
                (out, h), (tw_out, tw_h) = (kh.onehot_hist(data, 256, V, S, dmod, skip),
                                            kh.onehot_hist_reference(data, 256, V, S, dmod, skip))
                err = max(int((out - tw_out).abs().max()), int((h - tw_h).abs().max()))
                worst = max(worst, err)
                require(err == 0 and h.shape == (2 * kh.vocab_rows(V), 128),
                        f"onehot_hist != twin: {label} V={V} {name}, max_abs_err {err}")
        kept = kh.kept_subchunks(data, 256, 32, hp.DENSITY, True)
        log(f"  onehot_hist == twin: {label}, V {hp.VOCABS}, every case; S = 32 with skip "
            f"keeps {int(kept.sum())} of {kept.numel()} subchunks")
    require(not bool(kh.kept_subchunks(edge, 256, 32, hp.DENSITY, True).all()),
            "the edge tokens have no hit-free subchunk")
    V, S = 4352, 32
    span = kh.vocab_rows(V) * 128
    bins = (x + (x % hp.DENSITY == 0).to(torch.int32) * span).view(-1).long()
    ks, ls = in_turns(lambda: kh.onehot_hist(x, 256, V, S, hp.DENSITY, False),
                      lambda: torch.bincount(bins, minlength=2 * span), x.device)
    ms, library = statistics.fmean(ks), statistics.fmean(ls)
    plain = per_call_ms(lambda: kh.onehot_hist_reference(x, 256, V, S, hp.DENSITY, False),
                        x.device)
    zs, os_ = in_turns(lambda: kh.onehot_hist(zeros, 256, V, S, hp.DENSITY, False),
                       lambda: kh.onehot_hist(x, 256, V, S, hp.DENSITY, False), x.device)
    bound, by = hp.bound(x, V)
    mma = hp.onehot_mma_ms(x, 256, V, S, hp.DENSITY, False)
    log(f"[probes] onehot_hist at 2^25 tokens, R = 256, V = {V}, S = {S}, dense: kernel "
        f"{ms:.4f} ms ({ks[0]:.4f}, {ks[1]:.4f}), plain PyTorch twin {plain:.4f} ms, "
        f"torch.bincount of the bins (no copy) {library:.4f} ms ({ls[0]:.4f}, {ls[1]:.4f}), "
        f"bound {bound:.4f} ms ({by}), {bound / ms:.3f} of it; the TPU's one-hot products "
        f"on the tensor cores at peak bf16 {mma:.4f} ms; target kernel <= bincount: "
        f"{'held' if ms <= library else 'missed'}; {card}")
    log(f"[probes] onehot_hist all zeros (every token a hit, one bin) at the same shape, in "
        f"turns with the probe's tokens: {statistics.fmean(zs):.4f} ms ({zs[0]:.4f}, "
        f"{zs[1]:.4f}) against {statistics.fmean(os_):.4f} ms ({os_[0]:.4f}, {os_[1]:.4f}), "
        f"{bound / statistics.fmean(zs):.3f} of the bound; {card}")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": library}


COPY_SHAPES = ((32, 128), (262144, 128), (1, 1), (1, 5), (77, 1), (77, 128), (1000, 77),
               (4097, 129), (1 << 22, 1))  # the script's, 2^25, ragged, and more row
# tiles than grid.y holds (65,535)
COPY_CALLS = {"rows_to_column": lambda t: t.view(-1, 1).clone(),  # one PyTorch call each
              "transpose": lambda t: t.t().contiguous()}


def check_copies(torch) -> None:
    """rows_to_column and transpose against their twins (exact) on seeded
    int32 at every COPY_SHAPES shape, each as views 0, 4, 8 and 12 bytes
    past 16; each launch's geometry as the C side computes it
    (zbpe_lowering_plan) equals the Python plan, and the cases take every
    path (the four transpose variants, the vector and the scalar column).
    Then the column's head, on pointers aligned alike 4, 8 and 12 bytes past
    16, through its entry (the wrapper's output is always aligned)."""
    from zigbpe_tpu_torch.ops.kernels import lowering as kl
    from zigbpe_tpu_torch.probes import lowering as lp

    g = torch.Generator(device="cuda").manual_seed(23)
    paths = set()
    for shape in COPY_SHAPES:
        n = shape[0] * shape[1]
        base = torch.randint(-2**31, 2**31 - 1, (n + 3,), generator=g, device="cuda",
                             dtype=torch.int32)
        for off in range(4):
            x = base[off:off + n].view(shape)
            for kernel in (kl.rows_to_column, kl.transpose):
                got, want = kernel(x), lp.twin(kernel)(x)
                require(got.shape == want.shape and got.dtype == want.dtype
                        and torch.equal(got, want),
                        f"{kernel.__name__} != twin on {shape} {4 * off} bytes off")
                src, dst = x.data_ptr(), got.data_ptr()
                if kernel is kl.rows_to_column:
                    plan = kl.column_plan(n, src, dst)
                    paths.add(("column", plan.vecs > 0))
                    shown = kl.device_plan(kernel, src, dst, n)
                else:
                    plan = kl.transpose_plan(*shape, src, dst)
                    paths.add(("transpose", plan.load_vec, plan.store_vec))
                    shown = kl.device_plan(kernel, src, dst, *shape)
                require(tuple(map(int, plan)) == shown, f"{kernel.__name__} on {shape} "
                        f"{4 * off} bytes off: plan {plan} != the C side's {shown}")
    require(len(paths) == 6, f"the cases miss a path: {sorted(paths)}")
    n = (1 << 20) + 5
    src = torch.randint(-2**31, 2**31 - 1, (n + 3,), generator=g, device="cuda",
                        dtype=torch.int32)
    for off in (1, 2, 3):
        buf = torch.full((n + 3,), -7, dtype=torch.int32, device="cuda")
        s, d = src[off:off + n].data_ptr(), buf[off:off + n].data_ptr()
        plan = kl.column_plan(n, s, d)
        require(plan.head == 4 - off and plan.vecs > 0 and kl.device_plan(
            kl.rows_to_column, s, d, n) == tuple(plan), f"column head plan {plan}")
        kl._ROWS_TO_COLUMN(src.get_device(), s, d, n)
        want = torch.full_like(buf, -7)
        want[off:off + n] = src[off:off + n]
        require(torch.equal(buf, want), f"rows_to_column's head path wrong {4 * off} bytes off")
    log(f"  rows_to_column and transpose == twins (exact) at {len(COPY_SHAPES)} shapes x 4 "
        f"offsets, C geometry == Python plan on each, paths {sorted(paths)}; column head "
        f"4-12 bytes off == source")


def in_turns(fn_a, fn_b, device, calls: int = 20,
             runs: int = 5) -> tuple[list[float], list[float]]:
    """per_call_ms of fn_a and fn_b in turns: a, b, b, a."""
    a1, b1, b2, a2 = (per_call_ms(f, device, calls, runs) for f in (fn_a, fn_b, fn_b, fn_a))
    return [a1, a2], [b1, b2]


def graph_ms(torch, fn, calls: int = 20, replays: int = 10) -> float:
    """Device ms per call of ``fn()``: a CUDA graph captures ``calls`` calls,
    and runs of ``replays`` replays are timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kept = [fn() for _ in range(calls)]
    runs = time_runs(lambda: [graph.replay() for _ in range(replays)], torch.device("cuda"), 3)
    del kept
    return statistics.fmean(runs) / (calls * replays)


def host_us(torch, fn, calls: int = 2000) -> float:
    """Host microseconds to enqueue one call of ``fn()``, over ``calls`` calls
    back to back after a warm-up (the card synchronised before and after,
    outside the span)."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def time_copy(torch, name: str, x, card: str) -> tuple[float, float]:
    """A redesigned copy kernel against its one PyTorch call, in turns, at
    the script's shape ``x`` (per call, device time from a CUDA graph, host
    enqueue time) and at 2^25 int32 (262144, 128), each beside its bytes
    bound and the design's targets. Returns (kernel ms, call ms) per call at
    the script's shape."""
    from zigbpe_tpu_torch.ops.kernels import lowering as kl

    kernel, call = getattr(kl, name), COPY_CALLS[name]
    dev = x.device
    ks, cs = in_turns(lambda: kernel(x), lambda: call(x), dev)
    k_dev, c_dev = graph_ms(torch, lambda: kernel(x)), graph_ms(torch, lambda: call(x))
    k_host, c_host = host_us(torch, lambda: kernel(x)), host_us(torch, lambda: call(x))
    ms, lib = statistics.fmean(ks), statistics.fmean(cs)
    bound, _ = bound_ms(2 * x.numel() * 4)
    log(f"[probes] {name} at {tuple(x.shape)}: per call (turns kernel, call, call, kernel) "
        f"kernel {ms:.4f} ms ({ks[0]:.4f}, {ks[1]:.4f}), one PyTorch call {lib:.4f} ms "
        f"({cs[0]:.4f}, {cs[1]:.4f}); device per call (CUDA graph of 20) kernel {k_dev:.5f} ms, "
        f"call {c_dev:.5f} ms; host enqueue per call kernel {k_host:.2f} us, call "
        f"{c_host:.2f} us; bound {bound:.6f} ms (bytes); target kernel <= call: "
        f"{'held' if ms <= lib else 'missed'}; {card}")
    big = torch.randint(-2**31, 2**31 - 1, (262144, 128), device="cuda", dtype=torch.int32,
                        generator=torch.Generator(device="cuda").manual_seed(29))
    require(torch.equal(kernel(big), call(big)), f"{name} != its PyTorch call at 2^25")
    kb, cb = in_turns(lambda: kernel(big), lambda: call(big), dev)
    big_ms, big_lib = statistics.fmean(kb), statistics.fmean(cb)
    bound, _ = bound_ms(2 * big.numel() * 4)
    log(f"[probes] {name} at (262144, 128) = 2^25 int32: kernel {big_ms:.4f} ms "
        f"({kb[0]:.4f}, {kb[1]:.4f}), one PyTorch call {big_lib:.4f} ms ({cb[0]:.4f}, "
        f"{cb[1]:.4f}), bound {bound:.4f} ms (bytes), kernel / bound {big_ms / bound:.3f}; "
        f"target <= 2x bound: {'held' if big_ms <= 2 * bound else 'missed'}, target <= call: "
        f"{'held' if big_ms <= big_lib else 'missed'}; {card}")
    return ms, lib


def check_lowering(torch, card: str) -> dict:
    """Every lowering construct against its twin at the script's shapes, on
    the script's values and on seeded ones (exact), dot_tn also on normal
    values (within DOT_RTOL, DOT_ATOL), onehot_dot and dot_tn on
    check_products' cases, the redesigned copies on check_copies' and
    iota_mod_add on check_iota's; then each kernel timed (the copies by
    time_copy, dot_tn and onehot_dot by time_products, iota_mod_add at 2^25
    by time_iota)."""
    from zigbpe_tpu_torch.ops.kernels import lowering as kl
    from zigbpe_tpu_torch.probes import lowering as lp

    dev = torch.device("cuda")
    worst = {}
    for seed in (None, 17):
        for construct, kernel, args in lp.constructs(dev, seed):
            got, want = kernel(*args), lp.twin(kernel)(*args)
            require(got.shape == want.shape and got.dtype == want.dtype,
                    f"{construct}: {tuple(got.shape)} {got.dtype} against "
                    f"{tuple(want.shape)} {want.dtype}")
            err = abs_err(got, want)
            require(err == 0, f"{construct} != twin (seed {seed}): max_abs_err {err}")
            worst[kernel.__name__] = max(worst.get(kernel.__name__, 0.0), err)
    g = torch.Generator(device="cuda").manual_seed(19)
    for K, M in ((256, 128), (4096, 8)):  # the (256,128) product and the skinny one
        a = torch.randn((K, M), generator=g, device="cuda").to(torch.bfloat16)
        b = torch.randn((K, 128), generator=g, device="cuda").to(torch.bfloat16)
        got, want = kl.dot_tn(a, b), kl.dot_tn_reference(a, b)
        err = abs_err(got, want)
        require(bool(((got - want).abs() <= DOT_ATOL + DOT_RTOL * want.abs()).all()),
                f"dot_tn != twin on normal values {tuple(a.shape)}, {tuple(b.shape)}: "
                f"max_abs_err {err}")
        worst["dot_tn"] = max(worst["dot_tn"], err)
    log(f"  lowering kernels == twins at the script's shapes (exact; dot_tn on normal values "
        f"within rtol {DOT_RTOL}, atol {DOT_ATOL}): max_abs_err {worst}")
    for name, err in check_products(torch).items():
        worst[name] = max(worst[name], err)
    check_copies(torch)
    check_iota(torch)
    products = time_products(torch, card)
    time_iota(torch, card)
    script = {"dot_tn": PRODUCT_CASES[0][0], "onehot_dot": PRODUCT_CASES[2][0]}

    v = lp.inputs(dev)
    x, f, t1 = v["x"], v["f"], v["t1"]
    n32 = x.numel() * 4
    timed = {  # kernel, twin, one PyTorch call or None, (bytes, flops)
        "rows_to_column": (lambda: kl.rows_to_column(x), lambda: kl.rows_to_column_reference(x),
                           lambda: x.view(-1, 1).clone(), (2 * n32, 0)),
        "transpose": (lambda: kl.transpose(x), lambda: kl.transpose_reference(x),
                      lambda: x.t().contiguous(), (2 * n32, 0)),
        "iota_mod_add": (lambda: kl.iota_mod_add(x, 4), lambda: kl.iota_mod_add_reference(x, 4),
                         None, (2 * n32, 0)),
        "dot_tn": (lambda: kl.dot_tn(f, f), lambda: kl.dot_tn_reference(f, f),
                   lambda: torch.matmul(f.t().float(), f.float()),
                   (2 * f.numel() * 2 + 128 * 128 * 4, 2 * 256 * 128 * 128)),
        "onehot_dot": (lambda: kl.onehot_dot(t1), lambda: kl.onehot_dot_reference(t1),
                       lambda: torch.bincount(t1.view(-1), minlength=1024),
                       (t1.numel() * 4 + 8 * 128 * 4, 0)),  # a count: no products
    }
    out = {}
    for name, (kernel, twin, library, (nbytes, flops)) in timed.items():
        if name in COPY_CALLS:
            ms, lib = time_copy(torch, name, x, card)
        elif name in script:  # time_products timed it in turns with its call
            ms, lib = products[script[name]]["ms"], products[script[name]]["library_ms"]
        else:
            ms, lib = per_call_ms(kernel, dev), per_call_ms(library, dev) if library else None
        plain = per_call_ms(twin, dev)
        bound, by = bound_ms(nbytes, flops)
        log(f"[probes] {name} at the script's shapes: kernel {ms:.4f} ms, plain PyTorch twin "
            f"{plain:.4f} ms, one PyTorch call {'none' if lib is None else f'{lib:.4f} ms'}, "
            f"bound {bound:.6f} ms ({by}); {card}")
        if name == "iota_mod_add":  # time_copy and time_products log the others' device times
            k_dev = graph_ms(torch, kernel)
            log(f"[probes] {name} device per call (CUDA graph of 20): kernel {k_dev:.5f} ms, "
                f"bound {bound:.6f} ms, kernel / bound {k_dev / bound:.1f}; {card}")
        out[name] = {"max_abs_err": worst[name], "ms": ms, "plain_ms": plain,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib}
    return out


PRODUCT_CASES = (  # (label, kernel, shape): the script's shapes, then shapes the card bounds
    ("dot_tn (256,128)^T(256,128)", "dot_tn", (256, 128, 128)),
    ("dot_tn (4096,8)^T(4096,128)", "dot_tn", (4096, 8, 128)),
    ("onehot_dot (4096,1)", "onehot_dot", (4096,)),
    ("dot_tn (2^20,8)^T(2^20,128)", "dot_tn", (1 << 20, 8, 128)),
    ("onehot_dot (2^25,1)", "onehot_dot", (1 << 25,)),
)
SPAN_MS = 20.0  # a timed span of a product case holds about this much work


def product_case(torch, kernel: str, shape, seed: int = 31):
    """(kernel call, its one PyTorch call, bytes, bf16 operations) of a
    timed product case on seeded inputs: integer-valued bf16 in [-2, 2] for
    dot_tn (a: (K, M), b: (K, N)), tokens in [0, 1024) for onehot_dot
    (bincount takes no negative token)."""
    from zigbpe_tpu_torch.ops.kernels import lowering as kl

    g = torch.Generator(device="cuda").manual_seed(seed)
    if kernel == "dot_tn":
        K, M, N = shape
        a = torch.randint(-2, 3, (K, M), generator=g, device="cuda").to(torch.bfloat16)
        b = torch.randint(-2, 3, (K, N), generator=g, device="cuda").to(torch.bfloat16)
        return (lambda: kl.dot_tn(a, b), lambda: torch.matmul(a.t().float(), b.float()),
                2 * K * (M + N) + 4 * M * N, 2 * K * M * N)
    t = torch.randint(0, 1024, (shape[0], 1), generator=g, device="cuda", dtype=torch.int32)
    return (lambda: kl.onehot_dot(t), lambda: torch.bincount(t.view(-1), minlength=1024),
            4 * t.numel() + 4 * 1024, 0)


def time_products(torch, card: str, cases=PRODUCT_CASES) -> dict:
    """Each product case in turns with its one PyTorch call (kernel, call,
    call, kernel; CUDA events, per call) and by device time from a CUDA
    graph (the kernel, and matmul; bincount reads its input's maximum on
    the host, so no graph takes it), beside its bound. A span holds about
    SPAN_MS of work (1-20 calls), so that a slow kernel takes few repeats.
    Returns {label: {ms, library_ms, device_ms, library_device_ms,
    bound_ms, bound_by}}."""
    dev = torch.device("cuda")
    out = {}
    for label, name, shape in cases:
        kernel, library, nbytes, flops = product_case(torch, name, shape)
        one = min(time_runs(kernel, dev, 2))
        calls = max(1, min(20, int(SPAN_MS / max(one, 1e-3))))
        replays = max(1, min(10, int(SPAN_MS / max(one * calls, 1e-3))))
        ks, cs = in_turns(kernel, library, dev, calls, 5 if calls > 1 else 2)
        k_dev = graph_ms(torch, kernel, calls, replays)
        c_dev = graph_ms(torch, library, calls, replays) if name == "dot_tn" else None
        bound, by = bound_ms(nbytes, flops)
        ms, lib = statistics.fmean(ks), statistics.fmean(cs)
        call = "matmul of the casts" if name == "dot_tn" else "bincount"
        log(f"[products] {label}: per call (turns kernel, call, call, kernel; spans of "
            f"{calls}) kernel {ms:.5f} ms ({ks[0]:.5f}, {ks[1]:.5f}), {call} {lib:.5f} ms "
            f"({cs[0]:.5f}, {cs[1]:.5f}); device per call (CUDA graph of {calls}, {replays} "
            f"replays) kernel {k_dev:.5f} ms, {call} "
            f"{'no graph' if c_dev is None else f'{c_dev:.5f} ms'}; bound {bound:.6f} ms "
            f"({by}), kernel device / bound {k_dev / bound:.2f}; {card}")
        out[label] = {"ms": ms, "library_ms": lib, "device_ms": k_dev,
                      "library_device_ms": c_dev, "bound_ms": bound, "bound_by": by}
        del kernel, library
    return out


IOTA_BIG = (262144, 128)  # 2^25 int32: where iota_mod_add's bytes count
IOTA_CASES = (((32, 128), 4), ((7, 5), 1), ((7, 5), 3), ((64, 1000), 7), (IOTA_BIG, 4),
              (IOTA_BIG, 128), (IOTA_BIG, 1000))  # (shape, m), exact against the twin
# past 2^32 elements (4,295,098,368 each, 16 GiB of int32): odd cols take
# the scalar path, cols % 4 == 0 the vector one
IOTA_WIDE = (("scalar", (131072, 32769), 1000), ("vector", (32768, 131076), 7))
IOTA_PLAN_SHAPES = ((32, 128), (7, 5), (64, 1000), IOTA_BIG, (131072, 32769), (32768, 131076),
                    (1, 1), (3, 4 << 20), (1 << 28, 1))  # the last at grid.y's limit


def check_iota(torch) -> None:
    """iota_mod_add exactly against its twin on seeded int32 at IOTA_CASES
    and on a (64, 1000) view 4 bytes past 16 (through the wrapper, which
    aligns it, and through the entry on the view's own pointers: the scalar
    path); each launch's geometry as the C side computes it (kind 4 of
    zbpe_lowering_plan) equal to iota_plan, also at IOTA_PLAN_SHAPES
    without a launch. Then past 2^32 elements, one IOTA_WIDE shape a path,
    in sequence with memory freed between: the first 64 rows, 64 spread
    through the middle and the last 64 against the twin of those rows
    (peak about 32 GiB)."""
    from zigbpe_tpu_torch.ops.kernels import lowering as kl

    g = torch.Generator(device="cuda").manual_seed(47)

    def ints(n):
        return torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device="cuda",
                             dtype=torch.int32)

    def plan_check(shape, src, dst, what):
        shown = kl.IotaPlan(*kl.device_plan(kl.iota_mod_add, src, dst, *shape))
        want = kl.iota_plan(*shape, src, dst, shown.sms)
        require(shown == want, f"iota_mod_add geometry {what}: C side {shown} != plan {want}")
        return shown

    def exact(got, want, what):
        require(got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want),
                f"iota_mod_add != twin {what}: max_abs_err {abs_err(got, want)}")

    paths = set()
    for shape, m in IOTA_CASES:
        x = ints(shape[0] * shape[1]).view(shape)
        got = kl.iota_mod_add(x, m)
        exact(got, kl.iota_mod_add_reference(x, m), f"at {shape}, m = {m}")
        paths.add(plan_check(shape, x.data_ptr(), got.data_ptr(), f"at {shape}").vec)
    shape, m, n = (64, 1000), 7, 64000
    view = ints(n + 4)[1:1 + n].view(shape)  # 4 bytes past 16
    want = kl.iota_mod_add_reference(view, m)
    exact(kl.iota_mod_add(view, m), want, "on a view 4 bytes off 16")
    buf = torch.full((n + 4,), -7, dtype=torch.int32, device="cuda")
    src, dst = view.data_ptr(), buf[1:1 + n].data_ptr()
    paths.add(plan_check(shape, src, dst, "4 bytes off 16").vec)
    kl._IOTA_MOD_ADD(view.get_device(), src, dst, *shape, m)
    full = torch.full_like(buf, -7)
    full[1:1 + n] = want.view(-1)
    exact(buf, full, "through the entry on pointers 4 bytes off 16 (scalar path)")
    require(paths == {False, True}, f"the cases miss a path: vec in {paths}")
    ptr = buf.data_ptr()
    for shape in IOTA_PLAN_SHAPES:
        for off in (0, 4):
            plan_check(shape, ptr + off, ptr, f"at {shape}, {off} bytes off (no launch)")
    del view, buf, full, want
    log(f"  iota_mod_add == twin (exact) at (shape, m) in {IOTA_CASES} and on a view 4 bytes "
        f"off 16 (wrapper and entry); C geometry == iota_plan on each launch and at "
        f"{len(IOTA_PLAN_SHAPES)} shapes x 2 offsets; paths vector and scalar")
    for label, shape, m in IOTA_WIDE:
        t0 = time.perf_counter()
        x = torch.empty(shape, dtype=torch.int32, device="cuda")
        x.random_(-2**31, 2**31 - 1, generator=g)
        out = kl.iota_mod_add(x, m)
        plan = plan_check(shape, x.data_ptr(), out.data_ptr(), f"at {shape}")
        require(plan.vec == (label == "vector"), f"{shape} took the wrong path: {plan}")
        rows = shape[0]
        idx = torch.cat([torch.arange(64), torch.linspace(64, rows - 65, 64).long(),
                         torch.arange(rows - 64, rows)]).cuda()
        exact(out[idx], kl.iota_mod_add_reference(x[idx], m), f"at {shape} ({label} path), "
              f"rows {idx[:3].tolist()} ... {idx[-3:].tolist()}")
        log(f"  iota_mod_add == twin (exact) past 2^32 elements: {shape} = {x.numel():,} "
            f"int32, m = {m}, the {label} path, on 192 rows (first, middle spread, last); "
            f"plan {tuple(plan)} ({time.perf_counter() - t0:.1f} s)")
        del x, out, idx
        torch.cuda.empty_cache()


def time_iota(torch, card: str) -> None:
    """iota_mod_add at IOTA_BIG with m = 4: per call in turns with the
    yardstick ``torch.add(x, r)``, r = arange(cols) % m made once outside
    the span (one PyTorch call over the same bytes, not the same function),
    and by device time from a CUDA graph of 20 calls; beside the bytes
    bound. Then device time at the script's (32, 128), where launch latency
    bounds it."""
    from zigbpe_tpu_torch.ops.kernels import lowering as kl
    from zigbpe_tpu_torch.probes import lowering as lp

    dev = torch.device("cuda")
    x = torch.randint(-2**31, 2**31 - 1, IOTA_BIG, device="cuda", dtype=torch.int32,
                      generator=torch.Generator(device="cuda").manual_seed(43))
    r = (torch.arange(IOTA_BIG[1], device="cuda", dtype=torch.int32) % 4)
    kernel, add = lambda: kl.iota_mod_add(x, 4), lambda: torch.add(x, r)
    require(torch.equal(kernel(), add()), "iota_mod_add != torch.add(x, r) at 2^25")
    ks, cs = in_turns(kernel, add, dev)
    k_dev, c_dev = graph_ms(torch, kernel), graph_ms(torch, add)
    bound, by = bound_ms(2 * x.numel() * 4)
    ms, add_ms = statistics.fmean(ks), statistics.fmean(cs)
    log(f"[iota] iota_mod_add at {IOTA_BIG} = 2^25 int32, m = 4: per call (turns kernel, add, "
        f"add, kernel) kernel {ms:.5f} ms ({ks[0]:.5f}, {ks[1]:.5f}), yardstick torch.add(x, r) "
        f"{add_ms:.5f} ms ({cs[0]:.5f}, {cs[1]:.5f}); device per call (CUDA graph of 20) kernel "
        f"{k_dev:.5f} ms, torch.add {c_dev:.5f} ms; bound {bound:.6f} ms ({by}), kernel device "
        f"/ bound {k_dev / bound:.3f}, bound / kernel device {bound / k_dev:.3f}; {card}")
    small = lp.inputs(dev)["x"]
    runs = [graph_ms(torch, lambda: kl.iota_mod_add(small, 4)) for _ in range(3)]
    log(f"[iota] iota_mod_add at {tuple(small.shape)}, m = 4: device per call (CUDA graph of 20, "
        f"3 graphs) {', '.join(f'{ms * 1e3:.4f}' for ms in runs)} us; {card}")


FAULT_BIN = (1 << 24) + (1 << 20)  # bin (0, 0) of the fault column: 17,825,792
ONEHOT_PLAN_NS = (16, 4096, 4112, 5 * 16384 + 48, 1 << 25, (1 << 25) + 16, (1 << 32) + 16)
DOT_PLAN_SHAPES = ((256, 128, 128), (4096, 128, 8), (1 << 20, 128, 8), (4112, 48, 24),
                   (272, 208, 8), (512, 512, 256), (16, 16, 8), (1 << 33, 128, 8))  # (K, P, Q)
DOT_EXACT_SHAPES = ((1 << 20, 8, 128), (4112, 48, 24), (272, 8, 208), (512, 512, 256),
                    (16, 16, 8), (4096, 128, 128))  # (K, M, N) of a and b


def fault_column(torch):
    """2^25 tokens: 2^24 zeros, then 2^20 groups of 16 that each hold one 0
    and fifteen 1s. Bin (0, 0) must read FAULT_BIN, past the integers f32
    holds exactly (2^24): an f32 count that holds 2^24 stays there when 1
    is added."""
    tail = torch.ones((1 << 20, 16), dtype=torch.int32, device="cuda")
    tail[:, 0] = 0
    zeros = torch.zeros(1 << 24, dtype=torch.int32, device="cuda")
    return torch.cat([zeros, tail.view(-1)]).view(-1, 1)


def check_product_plans(torch) -> None:
    """The geometry the C entries of onehot_dot and dot_tn launch (kinds 2
    and 3 of zbpe_lowering_plan) equals onehot_plan and dot_plan at the
    card's SM count and occupancy, on the script's, the scaled and ragged
    shapes and on n and K past 2^32 (no memory is read); both sides refuse
    a pointer off 16 bytes."""
    from zigbpe_tpu_torch.ops.kernels import lowering as kl

    buf = torch.zeros(64, dtype=torch.int32, device="cuda")
    ptr = buf.data_ptr()
    for n in ONEHOT_PLAN_NS:
        shown = kl.OnehotPlan(*kl.device_plan(kl.onehot_dot, ptr, 0, n))
        want = kl.onehot_plan(n, ptr, shown.sms, shown.blocks_per_sm)
        require(shown == want, f"onehot_dot geometry at n={n}: C side {shown} != plan {want}")
    for K, P, Q in DOT_PLAN_SHAPES:
        shown = kl.DotPlan(*kl.device_plan(kl.dot_tn, ptr, ptr + 16, K, P, Q))
        want = kl.dot_plan(K, P, Q, ptr, ptr + 16, shown.sms)
        require(shown == want, f"dot_tn geometry at {(K, P, Q)}: C side {shown} != plan {want}")
    for call in (lambda: kl.device_plan(kl.onehot_dot, ptr + 4, 0, 4096),
                 lambda: kl.onehot_plan(4096, ptr + 4, 132, 1),
                 lambda: kl.device_plan(kl.dot_tn, ptr + 8, ptr, 256, 128, 128),
                 lambda: kl.dot_plan(256, 128, 128, ptr + 8, ptr, 132)):
        try:
            call()
        except ValueError:
            continue
        raise PhaseError("a plan took a pointer off 16 bytes")
    log(f"  onehot_dot and dot_tn: C geometry == Python plan on {len(ONEHOT_PLAN_NS)} and "
        f"{len(DOT_PLAN_SHAPES)} shapes ({shown.sms} SMs), both refuse pointers off 16 bytes")


def check_products(torch) -> dict:
    """onehot_dot and dot_tn at the shapes the card bounds, against their
    twins: onehot_dot exactly at 2^25 seeded tokens in [-200, 1300), on the
    fault column (bin (0, 0) == FAULT_BIN), at ragged n and on a view 4
    bytes past 16; dot_tn exactly on integer-valued bf16 in [-2, 2] at
    DOT_EXACT_SHAPES (every partial sum below 2^22, so any order is exact),
    within DOT_RTOL, DOT_ATOL on normal values at K = 4096, and bitwise
    equal over repeats (the split order fold). Then check_product_plans.
    Returns the worst max_abs_err of each."""
    from zigbpe_tpu_torch.ops.kernels import lowering as kl

    g = torch.Generator(device="cuda").manual_seed(37)
    worst = {"onehot_dot": 0.0, "dot_tn": 0.0}

    def exact(name, got, want, what):
        err = abs_err(got, want)
        require(got.shape == want.shape and got.dtype == want.dtype and err == 0,
                f"{name} != twin {what}: max_abs_err {err}")

    def tokens(n):
        return torch.randint(-200, 1300, (n, 1), generator=g, device="cuda", dtype=torch.int32)

    col = fault_column(torch)
    got = kl.onehot_dot(col)
    exact("onehot_dot", got, kl.onehot_dot_reference(col), "on the fault column")
    require(float(got[0, 0]) == FAULT_BIN, f"fault column bin (0, 0) {float(got[0, 0])}")
    del col
    for n in (16, 4112, 5 * 16384 + 48, 1 << 25):
        t = tokens(n)
        exact("onehot_dot", kl.onehot_dot(t), kl.onehot_dot_reference(t), f"at n={n}")
    view = tokens(4100).view(-1)[1:4097].view(4096, 1)  # 4 bytes past 16
    exact("onehot_dot", kl.onehot_dot(view), kl.onehot_dot_reference(view), "4 bytes off")
    log(f"  onehot_dot == twin (exact): the fault column (bin (0, 0) = {FAULT_BIN}), seeded "
        f"tokens in [-200, 1300) at n = 16, 4112, 81968 and 2^25, a view 4 bytes off")

    for K, M, N in DOT_EXACT_SHAPES:
        a = torch.randint(-2, 3, (K, M), generator=g, device="cuda").to(torch.bfloat16)
        b = torch.randint(-2, 3, (K, N), generator=g, device="cuda").to(torch.bfloat16)
        exact("dot_tn", kl.dot_tn(a, b), kl.dot_tn_reference(a, b),
              f"on integer values at ({K},{M})^T({K},{N})")
    del a, b
    for M in (128, 8):
        a = torch.randn((4096, M), generator=g, device="cuda").to(torch.bfloat16)
        b = torch.randn((4096, 128), generator=g, device="cuda").to(torch.bfloat16)
        got, want = kl.dot_tn(a, b), kl.dot_tn_reference(a, b)
        err = abs_err(got, want)
        require(bool(((got - want).abs() <= DOT_ATOL + DOT_RTOL * want.abs()).all()),
                f"dot_tn != twin on normal values (4096,{M})^T(4096,128): max_abs_err {err}")
        worst["dot_tn"] = max(worst["dot_tn"], err)
        require(all(torch.equal(got, kl.dot_tn(a, b)) for _ in range(5)),
                f"dot_tn differs between runs at (4096,{M})^T(4096,128)")
    log(f"  dot_tn == twin (exact) on integer values at (K, M, N) in {DOT_EXACT_SHAPES}; on "
        f"normal values at K = 4096 within rtol {DOT_RTOL}, atol {DOT_ATOL} (max_abs_err "
        f"{worst['dot_tn']}), bitwise equal over 5 repeats")
    check_product_plans(torch)
    return worst


def products_main(torch, card: str, time_only: bool) -> int:
    """``python3 chip_smoke.py --products [--time-only]``: build the
    lowering kernels, print their ptxas lines, hold dot_tn, onehot_dot and
    iota_mod_add to their twins and plans (check_products, check_iota;
    skipped with --time-only, which any version of the three wrappers runs)
    and time them (time_products, time_iota)."""
    from zigbpe_tpu_torch.ops.kernels import _build

    log_ptxas("lowering", _build.build("lowering"))
    from zigbpe_tpu_torch.ops.kernels import lowering as kl

    if not time_only:
        check_products(torch)
        check_iota(torch)
    col = fault_column(torch)
    got = kl.onehot_dot(col)
    log(f"[products] onehot_dot on the fault column: bin (0, 0) = {float(got[0, 0]):.1f} "
        f"(the count is {FAULT_BIN}), equal to the twin: "
        f"{torch.equal(got, kl.onehot_dot_reference(col))}")
    del col, got
    time_products(torch, card)
    time_iota(torch, card)
    return 0


COPY_PLAN_CASES = ((262144, 256), (262144, 8), (77, 7), (1, 1), (24, 8), (1025, 25),
                   (4096, 2048))  # (rows, R): the probes', ragged, R = 8


def check_copy_plans() -> None:
    """The geometry each copy entry launches (zbpe_copy_plan) equals
    copy_plan, int32 and int16, on every case it takes."""
    from zigbpe_tpu_torch.ops.kernels import copy as kc

    n = 0
    for rows, R in COPY_PLAN_CASES:
        for elem in (4, 2):
            for name in COPY_KERNELS:
                if name == "copy_peek" and (rows % 8 or R % 8):
                    continue
                shown, want = kc.device_plan(rows, R, elem, name), kc.copy_plan(rows, R, elem, name)
                require(shown == want, f"{name} geometry rows={rows} R={R} elem={elem}: C side "
                        f"{shown} != plan {want}")
                n += 1
    log(f"  copy kernels: C geometry == Python plan on {n} cases")


def time_copies(torch, rows: int, card: str) -> dict:
    """copy_blocks in turns with clone (kernel, call, call, kernel), and
    copy_carry and copy_peek in turns with copy_blocks, at 2^25 tokens of
    int16 and then int32 (whose row is returned), R = 256, beside the bytes
    bound and the design's targets; each twin timed alone."""
    from zigbpe_tpu_torch.ops.kernels import copy as kc

    out = {}
    for dtype in (torch.int16, torch.int32):
        x = torch.zeros((rows, 128), dtype=dtype, device="cuda")
        bound, _ = bound_ms(2 * x.numel() * x.element_size())
        ks, cs = in_turns(lambda: kc.copy_blocks(x, 256), x.clone, x.device)
        blocks, clone = statistics.fmean(ks), statistics.fmean(cs)
        log(f"[probes] copy_blocks {dtype} at 2^25 tokens, R = 256, in turns (kernel, clone, "
            f"clone, kernel): kernel {blocks:.4f} ms ({ks[0]:.4f}, {ks[1]:.4f}), torch.clone "
            f"{clone:.4f} ms ({cs[0]:.4f}, {cs[1]:.4f}), kernel / clone {blocks / clone:.4f}, "
            f"bound {bound:.4f} ms, {bound / blocks:.3f} of it; target within 2% of clone: "
            f"{'held' if blocks <= 1.02 * clone else 'missed'}; {card}")
        out["copy_blocks"] = {"ms": blocks, "library_ms": clone,
                              "plain_ms": per_call_ms(lambda: kc.copy_blocks_reference(x, 256),
                                                      x.device)}
        word = torch.empty(1, dtype=torch.int32, device="cuda")
        for name in ("copy_carry", "copy_peek"):
            fn = getattr(kc, name)
            ns, bs = in_turns(lambda: fn(x, 256), lambda: kc.copy_blocks(x, 256), x.device)
            ms, base = statistics.fmean(ns), statistics.fmean(bs)
            log(f"[probes] {name} {dtype} at 2^25 tokens, R = 256, in turns with copy_blocks: "
                f"{ms:.4f} ms ({ns[0]:.4f}, {ns[1]:.4f}) against {base:.4f} ms ({bs[0]:.4f}, "
                f"{bs[1]:.4f}), ratio {ms / base:.4f}; target within 3% of copy_blocks: "
                f"{'held' if ms <= 1.03 * base else 'missed'}; {card}")
            twin = getattr(kc, f"{name}_reference")
            out[name] = {"ms": ms, "library_ms": None,
                         "plain_ms": per_call_ms(lambda: twin(x, 256), x.device)}
        ns, zs = in_turns(lambda: kc.copy_carry(x, 256),
                          lambda: (word.zero_(), kc.copy_blocks(x, 256)), x.device)
        log(f"[probes] copy_carry {dtype} in turns with a 4-byte zero_() and copy_blocks (the "
            f"count word's zeroing as its own stream operation): {statistics.fmean(ns):.4f} ms "
            f"({ns[0]:.4f}, {ns[1]:.4f}) against {statistics.fmean(zs):.4f} ms ({zs[0]:.4f}, "
            f"{zs[1]:.4f}); {card}")
    return out


def phase_probes(torch, group, card):
    """The probe kernels against their twins (on the card), then the six
    probes at full size with every probe kernel's count from zero. Returns
    {kernel: {launches, max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms}}."""
    from zigbpe_tpu_torch.ops.kernels import copy as kc, merge as km
    from zigbpe_tpu_torch.probes import alu16, budget, floor, hist, lowering, pipeline

    t0 = time.perf_counter()
    worst = dict.fromkeys(("merge_pass_ablated", *COPY_KERNELS), 0)
    rows = (1 << 25) // 128
    rng = np.random.default_rng(5)
    for np_dtype in (np.int32, np.int16):
        host = rng.integers(-1000, 30000, (rows, 128)).astype(np_dtype)
        if np_dtype == np.int32:  # look-ahead tokens that make the sum wrap
            host[::8, 0] = rng.integers(1 << 30, (1 << 31) - 1, rows // 8)
        data = torch.from_numpy(host).cuda()
        for label, x in (("seeded", data), ("zeros", torch.zeros_like(data))):
            for R in (8, *floor.BLOCK_ROWS):
                for name in COPY_KERNELS:
                    got = getattr(kc, name)(x, R)
                    want = getattr(kc, f"{name}_reference")(x, R)
                    if name == "copy_blocks":
                        got, want = (got,), (want,)
                    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
                    worst[name] = max(worst[name], err)
                    require(err == 0 and got[0].dtype == x.dtype,
                            f"{name} != twin: {x.dtype} R={R} {label}, max_abs_err {err}")
        log(f"  copy kernels == twins: {data.dtype}, R in {(8, *floor.BLOCK_ROWS)}, seeded "
            f"and zeros")
    del data, x, got, want
    check_copy_plans()

    aa = commonest_repeat()
    cases = [(f"cap={cap}", padded(tiled_corpus(cap - int(rng.integers(1, 300))), cap))
             for cap in (4096, 128 * 1000, 1 << 25)]
    cases.append(("a-run spanning tiles", padded(b"a" * ((1 << 20) - 3) + b"xy", 1 << 20)))
    for label, arr in cases:
        src = torch.from_numpy(arr).cuda()
        # K = 1 runs the masks' KT = 1 instantiations, K = 2 and 4 their KT = 4 ones
        for table in ([group[0]], [(aa, aa, 256)], group[:2], group):
            t = torch.tensor(table, dtype=torch.int32, device="cuda")
            K = t.shape[0]
            for variant in km.VARIANTS:
                gtok, gst = km.merge_pass_ablated(src.clone(), t, variant)
                ctok, cst = km.merge_pass_ablated_reference(src.clone(), t, variant)
                err = max(int((gtok - ctok).abs().max()),
                          int((gst[:K + 1].long() - cst[:K + 1].long()).abs().max()))
                worst["merge_pass_ablated"] = max(worst["merge_pass_ablated"], err)
                same = err == 0 and bool((gst[K + 1] <= 1) == (cst[K + 1] <= 1))
                require(same, f"merge_pass_ablated {variant} != twin on {label} {table}: "
                        f"gpu {gst.tolist()} twin {cst.tolist()}")
        log(f"  merge_pass_ablated == twin, every variant: {label} n={arr.size} "
            f"(tables {group[0]}, {(aa, aa, 256)}, the group's first 2 and all 4)")
    log(f"[probes] ok: merge and copy probe kernels == twins, max_abs_err {worst} "
        f"({time.perf_counter() - t0:.1f} s)")

    # kernel against twin at the probes' shapes, both on the card
    rows_out = time_copies(torch, rows, card)
    src = torch.from_numpy(padded(tiled_corpus((1 << 25) - 100), 1 << 25)).cuda()
    t = torch.tensor([group[0]], dtype=torch.int32, device="cuda")
    rows_out["merge_pass_ablated"] = {
        "ms": time_pass(lambda w, tb: km.merge_pass_ablated(w, tb, "full"), src, t, 20),
        "plain_ms": time_pass(lambda w, tb: km.merge_pass_ablated_reference(w, tb, "full"),
                              src, t, 5),
        "library_ms": None}
    stream = bound_ms(2 * 4 * rows * 128)  # one read and one write of 2^25 int32 tokens
    for name, row in rows_out.items():
        row.update(max_abs_err=worst[name], bound_ms=stream[0], bound_by=stream[1])
    row = rows_out["merge_pass_ablated"]
    log(f"[probes] merge_pass_ablated at 2^25 int32 tokens (full pass of {group[0]}): kernel "
        f"{row['ms']:.4f} ms, plain PyTorch twin {row['plain_ms']:.4f} ms (CUDA events, mean "
        f"per call); {card}")
    del src

    t1 = time.perf_counter()
    rows_out["opmix"] = check_opmix(torch, rows, card)
    rows_out["onehot_hist"] = check_hist(torch, rows, card)
    rows_out.update(check_lowering(torch, card))
    log(f"[probes] ok: opmix, onehot_hist and the lowering kernels == twins "
        f"({time.perf_counter() - t1:.1f} s)")

    # the probes' own path, each counter from zero
    wrappers = probe_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    floor.run("cuda")
    pipeline.run("cuda")
    pipeline.run("cuda", loop=True)
    budget.run("cuda")
    alu16.run("cuda")
    hist.run("cuda")
    lowering.run("cuda")
    return {name: {"launches": wrappers[name].launches, **rows_out[name]}
            for name in PROBE_KERNELS}


def phase_golden(torch):
    from zigbpe_tpu_torch import BasicTokenizer, serde

    t0 = time.perf_counter()
    corpus = CORPUS.read_bytes()
    tok = BasicTokenizer(device="cuda").train(corpus, 300)
    train_s = time.perf_counter() - t0
    require(tok.merges == serde.load(GOLDEN), "golden merges differ from tests/data/merges.txt")
    t1 = time.perf_counter()
    ids = tok.encode(corpus, backend="device")
    enc_s = time.perf_counter() - t1
    require(len(ids) == GOLDEN_TOKENS, f"encode gave {len(ids)} tokens, want {GOLDEN_TOKENS}")
    twin_ids = BasicTokenizer(tok.merges, device="cpu").encode(corpus, backend="device")
    require(ids == twin_ids, "card encode differs from the CPU twin path")
    require(tok.decode(ids) == corpus, "decode does not give back the corpus")
    log(f"[golden] ok: 44 merges == merges.txt (train {train_s:.3f} s), "
        f"{len(ids)} tokens (encode {enc_s:.3f} s), decode round trip")

    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t2 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "zigbpe_tpu_torch.cli", "demo", "--device", "cuda",
             "--corpus", str(CORPUS), "--out", str(pathlib.Path(tmp) / "merges.txt")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
        )
        require(proc.returncode == 0, f"cli demo exited {proc.returncode}: {proc.stderr[-2000:]}")
        lines = proc.stdout.splitlines()
        require(len(lines) >= 2 and lines[1] == PROBE, f"cli demo probe: {proc.stdout!r}")
        require((pathlib.Path(tmp) / "merges.txt").read_bytes() == GOLDEN.read_bytes(),
                "cli demo merges.txt differs from the golden file")
        log(f"[golden] ok: cli demo on cuda round-trips the probe "
            f"({time.perf_counter() - t2:.1f} s)")


def phase_scale(torch, card):
    from zigbpe_tpu_torch import BasicTokenizer
    from zigbpe_tpu_torch.ops.kernels import merge as km
    from zigbpe_tpu_torch.probes import seed as seed_probe

    data = tiled_corpus(SCALE_BYTES)
    mb = len(data) / 1e6
    require(fastio.available(), "the native library is not loaded: no host seed")
    runs = []
    for _ in range(2):  # the first run includes one-time CUDA set-up
        passes0 = km.merge_pass_multi.launches
        t0 = time.perf_counter()
        tok = BasicTokenizer(device="cuda").train(data, SCALE_VOCAB)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, km.merge_pass_multi.launches - passes0))
        seeds = tok.time_stats.phases["count_pairs"]
        require(seeds.calls == 2, f"count_pairs ran {seeds.calls} times, not 2 (the host "
                "seed, then its placement)")
    train_s, passes = runs[-1]
    require(len(tok.merges) == SCALE_VOCAB - 256, f"{len(tok.merges)} merges")
    log(f"[scale] host seed taken: count_pairs 2 calls, {seeds.total_s * 1e3:.3f} ms in all; "
        + ", ".join(f"{name} {acc.calls} x {acc.total_s * 1e3:.3f} ms"
                    for name, acc in tok.time_stats.phases.items()))
    t1 = time.perf_counter()
    ids = tok.encode(data, backend="device")
    enc_s = time.perf_counter() - t1
    log(f"[scale] card training: {mb:.3f} MB to vocab {SCALE_VOCAB}: "
        f"{train_s:.3f} s = {mb / train_s:.2f} MB/s (first run {runs[0][0]:.3f} s), "
        f"{passes} merge passes, {train_s / (SCALE_VOCAB - 256) * 1e3:.3f} ms/merge; {card}")
    log(f"[scale] card encode: {mb:.3f} MB, {len(ids)} tokens in {enc_s:.3f} s "
        f"= {mb / enc_s:.2f} MB/s; {card}")

    t2 = time.perf_counter()
    want = native_train(data, SCALE_VOCAB)
    nat_train_s = time.perf_counter() - t2
    require(tok.merges == want, "card merges differ from the native C++ trainer's")
    t3 = time.perf_counter()
    want_ids = native_encode(data, want)
    nat_enc_s = time.perf_counter() - t3
    require(np.array_equal(np.asarray(ids, np.int32), want_ids),
            "card encode differs from the native C++ encoder's")
    log(f"[scale] ok: 256 merges == native C++ trainer ({nat_train_s:.1f} s, "
        f"{mb / nat_train_s:.2f} MB/s one core), ids == native encoder "
        f"({nat_enc_s:.1f} s)")
    rows = seed_probe.run("cuda", SCALE_BYTES, SCALE_VOCAB, runs=5)
    log(f"[scale] ok: host seed == device seed at {mb:.3f} MB, vocab {SCALE_VOCAB}; ms "
        "(median of 5 in turns, host clock, device synchronised): "
        + ", ".join(f"{name} {med:.3f} ({lo:.3f}-{hi:.3f})"
                    for name, (med, lo, hi) in rows.items()) + f"; {card}")
    return tok.merges


def sync_free_select(torch, tokens, V: int, runs: str):
    """select_top_pair_sorted without a wait on the device, for timing
    beside the port's: the sorted packed keys' run lengths from a cummax
    over run starts (``runs="cummax"``, the JAX function's formulation) or
    from a binary search for each run's start (``"searchsorted"``); V*V
    must fit int32."""
    from zigbpe_tpu_torch.ops import core

    invalid = 2**31 - 1
    a, b = core.pair_streams(tokens, 128)
    s = torch.sort(torch.where(b >= 0, a * V + b, invalid)).values
    idx = torch.arange(s.shape[0], device=s.device)
    boundary = s[1:] != s[:-1]
    one = boundary.new_ones(1)
    if runs == "cummax":
        start = torch.cummax(torch.where(torch.cat([one, boundary]), idx, -1), 0).values
    else:
        start = torch.searchsorted(s, s)
    run = torch.where(torch.cat([boundary, one]) & (s != invalid), idx + 1 - start, 0)
    count = run.max()
    top = torch.where(run == count, s, -1).max()
    return top // V, top % V, count


def phase_sorted(torch, card, lazy_merges, native_32768):
    """Training past LAZY_VOCAB_MAX, where each round sorts the stream's
    pairs: the conformance corpus to vocab 32768 plainly, resumed from a
    rewound checkpoint and with the detailed split, each exactly the native
    trainer's merges (``native_32768``, a future computing them); then the
    tiled corpus to vocab 32768, whose first 256 merges must equal the lazy
    path's (``lazy_merges``, phase 6's)."""
    from zigbpe_tpu_torch import BasicTokenizer, train
    from zigbpe_tpu_torch.ops import core
    from zigbpe_tpu_torch.ops.kernels import merge as km
    from zigbpe_tpu_torch.utils import checkpoint
    from zigbpe_tpu_torch.utils.profiling import TimeStats

    V = SORTED_VOCAB
    require(V > train.LAZY_VOCAB_MAX, "the sorted phase must train past LAZY_VOCAB_MAX")
    corpus = CORPUS.read_bytes()

    # (a) conformance: the native trainer's merges, encode on the card
    t0 = time.perf_counter()
    tok = BasicTokenizer(device="cuda").train(corpus, V)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    want = native_32768.result()
    wait_s = time.perf_counter() - t1
    require(len(want) == V - 256, f"native trainer gave {len(want)} merges")
    require(tok.merges == want, "card merges differ from the native C++ trainer's from "
            f"merge {first_difference(tok.merges, want)}")
    ids = tok.encode(corpus, backend="device")
    require(tok.decode(ids) == corpus, "decode does not give back the corpus")
    head = corpus[:SORTED_HEAD_BYTES]
    head_ids = tok.encode(head, backend="device")
    require(np.array_equal(np.asarray(head_ids, np.int32), native_encode(head, want)),
            "card encode of the first 16 KiB differs from the native encoder's")
    log(f"[sorted] ok: {len(corpus)} bytes to vocab {V}: {len(want)} merges == "
        f"native C++ trainer in {plain_s:.3f} s on the card ({plain_s / len(want) * 1e3:.3f} "
        f"ms/merge; native finished {wait_s:.1f} s later); corpus -> {len(ids)} tokens, "
        f"decode round trip; first {SORTED_HEAD_BYTES} bytes -> {len(head_ids)} ids == "
        f"native encoder; {card}")

    # (b) resume: a checkpointed run, its checkpoint rewound part-way as
    # tests/test_checkpoint.py simulates a crash, resumed on the card
    with tempfile.TemporaryDirectory() as ck:
        t2 = time.perf_counter()
        got = BasicTokenizer(device="cuda").train(corpus, V, checkpoint_dir=ck).merges
        ck_s = time.perf_counter() - t2
        require(got == want, "checkpointed run differs from the native merges")
        saved, _, vocab, occ = checkpoint.load(ck)
        require(vocab == V and len(saved) > SORTED_RESUME_AT, f"checkpoint holds {len(saved)}")
        checkpoint.save(ck, saved[:SORTED_RESUME_AT],
                        native_encode(corpus, want[:SORTED_RESUME_AT]), V,
                        occ[:SORTED_RESUME_AT])
        t3 = time.perf_counter()
        resumed = BasicTokenizer(device="cuda").train(corpus, V, checkpoint_dir=ck).merges
        resume_s = time.perf_counter() - t3
        require(resumed == want, "resumed run differs from the native merges")
    log(f"[sorted] ok: checkpointed run ({ck_s:.3f} s, {len(saved)} merges in its last "
        f"checkpoint) and a run resumed at merge {SORTED_RESUME_AT} ({resume_s:.3f} s) == "
        f"native C++ trainer; {card}")

    # (c) the detailed split: per-round phases, device-synced
    stats = TimeStats()
    tok = BasicTokenizer(device="cuda")
    tok.time_stats = stats
    t4 = time.perf_counter()
    tok.train(corpus, V, detailed_stats=True)
    detailed_s = time.perf_counter() - t4
    require(tok.merges == want, "detailed run differs from the native merges")
    for line in stats.report().splitlines():
        log(f"[sorted]   {line.strip()}")
    sort_ms = stats.phases["sort_pairs"].total_s * 1e3
    repl_ms = stats.phases["replace_pairs"].total_s * 1e3
    rounds = stats.phases["sort_pairs"].calls
    log(f"[sorted] ok: detailed run == native ({detailed_s:.3f} s): per round sort_pairs "
        f"{sort_ms / rounds:.4f} ms, replace_pairs {repl_ms / rounds:.4f} ms "
        f"(sort {sort_ms / (sort_ms + repl_ms):.3f} of the two); {card}")

    # (d) scale: the tiled corpus to vocab V
    data = tiled_corpus(SORTED_SCALE_BYTES)
    mb = len(data) / 1e6
    passes0 = km.merge_pass_multi.launches
    t5 = time.perf_counter()
    tok = BasicTokenizer(device="cuda").train(data, V)
    torch.cuda.synchronize()
    scale_s = time.perf_counter() - t5
    passes = km.merge_pass_multi.launches - passes0
    require(len(tok.merges) == V - 256, f"{len(tok.merges)} merges on the tiled corpus")
    require(tok.merges[:len(lazy_merges)] == lazy_merges,
            "the sorted path's first merges differ from the lazy path's")
    log(f"[sorted] card training: {mb:.3f} MB to vocab {V}: {scale_s:.3f} s = "
        f"{mb / scale_s:.2f} MB/s, {passes} merge passes, "
        f"{scale_s / (V - 256) * 1e3:.3f} ms/merge; first {len(lazy_merges)} merges == the "
        f"lazy path's (phase 6); {card}")

    # one selection, the port's (torch.unique counts the runs and waits on
    # the device for their number) against two that never wait, on the
    # corpus's head (the size of most rounds) and the tiled corpus
    forms = {"unique": lambda t: core.select_top_pair_sorted(t, V, 128),
             "cummax": lambda t: sync_free_select(torch, t, V, "cummax"),
             "searchsorted": lambda t: sync_free_select(torch, t, V, "searchsorted")}
    for stream in (corpus[:train.MIN_CAPACITY], data):
        tokens, _ = core.pad_tokens(stream, len(stream), "cuda")
        got = torch.stack(forms["unique"](tokens)).tolist()
        ms = {}
        for name, fn in forms.items():
            require(torch.stack(fn(tokens)).tolist() == got, f"{name} selection disagrees")
            ms[name] = statistics.fmean(time_runs(lambda: fn(tokens), tokens.device, 3))
        log(f"[sorted] one selection over {len(stream)} tokens ({tuple(got)}), ms a call "
            "(CUDA events, mean of 3): " + ", ".join(f"{n} {t:.4f}" for n, t in ms.items())
            + f"; {card}")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def check_dp_seeds(torch, dp, data: bytes, lazy_merges, g, dev, card) -> None:
    """At world size 1 the host-seeded tables equal the device-seeded ones:
    the replicated table of ``data`` at SCALE_VOCAB, of its stream resumed
    at DP_RESUME_AT merges, and the row-sharded table of the conformance
    corpus at DP_SHARDED_VOCAB. The two replicated seeds that train_dp
    takes at world size 1 (fresh: the native byte histogram; resumed:
    np.unique over the stream) are timed in turns against the device seed
    of the staged stream (init_ub_dp) that larger groups take."""
    from zigbpe_tpu_torch.probes import seed as seed_probe, spread

    t0 = time.perf_counter()
    V = SCALE_VOCAB
    fresh_tokens = dp.shard_corpus(data, g, dev)
    ids = native_encode(data, lazy_merges[:DP_RESUME_AT])
    resumed_tokens = dp.shard_token_ids(ids, g, dev)
    seeds = {
        "fresh host": lambda: dp._replicated_ub_from_entries(*dp._byte_pair_entries(data),
                                                             vocab_size=V, device=dev),
        "fresh device": lambda: dp.init_ub_dp(fresh_tokens, V, g),
        "resumed host": lambda: dp._replicated_ub_from_entries(*dp._host_pair_entries(ids),
                                                               vocab_size=V, device=dev),
        "resumed device": lambda: dp.init_ub_dp(resumed_tokens, V, g),
    }
    for stream in ("fresh", "resumed"):
        require(torch.equal(seeds[f"{stream} host"](), seeds[f"{stream} device"]()),
                f"the host-seeded replicated table of the {stream} stream differs from the "
                "device seed")
    times = seed_probe.in_turns(seeds, dev, runs=5)
    del fresh_tokens, resumed_tokens
    corpus = CORPUS.read_bytes()
    Vs = DP_SHARDED_VOCAB
    host = dp._sharded_ub_from_entries(*dp._byte_pair_entries(corpus), vocab_size=Vs, group=g,
                                       device=dev)
    device_seed = dp.init_ub_sharded_dp(dp.shard_corpus(corpus, g, dev), Vs, g, max_row=256)
    require(torch.equal(host, device_seed),
            "the host-seeded row-sharded table differs from the device seed")
    log(f"[dp] ok: world size 1, host seeds == device seeds: replicated at vocab {V} "
        f"(fresh, and resumed at merge {DP_RESUME_AT}), row-sharded {tuple(host.shape)} at "
        f"vocab {Vs} ({time.perf_counter() - t0:.1f} s)")
    log(f"[dp] replicated seeds at vocab {V}, fresh {len(data)} bytes and resumed {ids.size} "
        "tokens; ms (median of 5 in turns, host clock, device synchronised): "
        + ", ".join(f"{name} {med:.3f} ({lo:.3f}-{hi:.3f})"
                    for name, (med, lo, hi) in ((n, spread(ms)) for n, ms in times.items()))
        + f"; {card}")


def phase_dp(torch, card, lazy_merges, native_32768):
    """The data-parallel trainer in one process: an NCCL group of world size
    1 on cuda:0 (every collective a real NCCL call). (a) The 32 MiB tiled
    corpus to SCALE_VOCAB through train_dp, equal to phase 6's merges (the
    native trainer's), timed twice; (b) the conformance corpus to
    DP_SHARDED_VOCAB on the row-sharded table, equal to the native
    trainer's first merges; (c) multihost.train_from_files on the 32 MiB in
    a file with a checkpoint every chunk, then resumed from its checkpoint
    rewound to DP_RESUME_AT merges, both equal to (a); then one a == b
    shard merge (and an a != b one) at (a)'s shard size. Returns the merge
    kernel launches of (a)-(c), counted from zero (the caller zeroes the
    count just before the phase)."""
    import datetime

    import torch.distributed as dist

    from zigbpe_tpu_torch.ops.kernels import merge as km
    from zigbpe_tpu_torch.parallel import multihost, train_dp as dp
    from zigbpe_tpu_torch.utils import checkpoint
    from zigbpe_tpu_torch.utils.profiling import TimeStats

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT_S))
    try:
        # (a) full width: 32 MiB to vocab 512
        data = tiled_corpus(SCALE_BYTES)
        mb = len(data) / 1e6
        runs, host_seeds = [], []
        byte_entries = dp._byte_pair_entries  # counts the host seeds train_dp takes
        dp._byte_pair_entries = lambda d: host_seeds.append(len(d)) or byte_entries(d)
        try:
            for _ in range(2):  # the first run includes one-time set-up
                g, stats = dp.DataGroup(), TimeStats()
                passes0 = km.merge_pass_multi.launches
                t0 = time.perf_counter()
                merges = dp.train_dp(data, SCALE_VOCAB, g, device=dev, stats=stats)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0, km.merge_pass_multi.launches - passes0,
                             g.collectives))
                require(merges == lazy_merges, "train_dp merges differ from phase 6's (native) "
                        f"from merge {first_difference(merges, lazy_merges)}")
        finally:
            dp._byte_pair_entries = byte_entries
        require(host_seeds == [len(data)] * 2, f"train_dp took {len(host_seeds)} host seeds in "
                "2 runs at world size 1")
        wall, passes, colls = runs[-1]
        n = len(merges)
        log(f"[dp] ok: NCCL world 1, {mb:.3f} MB to vocab {SCALE_VOCAB}: {n} merges == native "
            f"C++ trainer in {wall:.3f} s = {mb / wall:.2f} MB/s (first run {runs[0][0]:.3f} s), "
            f"{wall / n * 1e3:.3f} ms/merge, {passes} merge passes, {colls / n:.2f} "
            f"collectives a round; {card}")
        for line in stats.report().splitlines():
            log(f"[dp]   {line.strip()}")
        check_dp_seeds(torch, dp, data, lazy_merges, g, dev, card)

        # (b) the row-sharded table
        V = DP_SHARDED_VOCAB
        require(V > dp.LAZY_VOCAB_MAX, "the sharded run must pass LAZY_VOCAB_MAX")
        want = native_32768.result()[: V - 256]
        corpus = CORPUS.read_bytes()
        g = dp.DataGroup()
        t1 = time.perf_counter()
        merges = dp.train_dp(corpus, V, g, device=dev)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t1
        require(merges == want, "sharded train_dp differs from the native merges from merge "
                f"{first_difference(merges, want)}")
        log(f"[dp] ok: row-sharded table, {len(corpus)} bytes to vocab {V}: {len(merges)} "
            f"merges == native C++ trainer in {sharded_s:.3f} s ({sharded_s / len(merges) * 1e3:.3f} "
            f"ms/merge, {g.collectives / len(merges):.2f} collectives a round); {card}")

        # (c) from files, checkpointed every chunk, then resumed midway
        with tempfile.TemporaryDirectory() as tmp:
            path, ck = pathlib.Path(tmp) / "corpus.bin", pathlib.Path(tmp) / "ck"
            path.write_bytes(data)
            t2 = time.perf_counter()
            got = multihost.train_from_files([path], SCALE_VOCAB, device=dev,
                                             chunk_rounds=DP_FILES_CHUNK, checkpoint_dir=ck,
                                             checkpoint_every_chunks=1)
            files_s = time.perf_counter() - t2
            require(got == lazy_merges, "train_from_files differs from phase 6's merges")
            saved, _, vocab, occ = checkpoint.load(ck)
            require(vocab == SCALE_VOCAB and saved == lazy_merges, "the last checkpoint")
            checkpoint.save(ck, saved[:DP_RESUME_AT],
                            native_encode(data, lazy_merges[:DP_RESUME_AT]), vocab,
                            occ[:DP_RESUME_AT])
            t3 = time.perf_counter()
            resumed = multihost.train_from_files([path], SCALE_VOCAB, device=dev,
                                                 checkpoint_dir=ck)
            resume_s = time.perf_counter() - t3
            require(resumed == lazy_merges, "the resumed run differs from phase 6's merges")
        log(f"[dp] ok: train_from_files with a checkpoint every chunk ({files_s:.3f} s) and "
            f"resumed at merge {DP_RESUME_AT} ({resume_s:.3f} s) == native C++ trainer; {card}")
        launches = km.merge_pass_multi.launches  # zeroed just before the phase

        # one a == b shard merge at (a)'s shard size, and an a != b one
        g = dp.DataGroup()
        tokens = dp.shard_corpus(data, g, dev)
        edges = dp._gather_edges(tokens, g)
        rep = commonest_repeat()
        aa = statistics.fmean(time_runs(
            lambda: dp._parity_merge_shard(tokens, rep, 256, edges, g), dev, 3))
        work = [tokens]
        ab = statistics.fmean(time_runs(
            lambda: dp._kernel_merge_shard(work[0], *lazy_merges[0][:2], 256, edges, 0), dev, 3,
            setup=lambda: work.__setitem__(0, tokens.clone())))
        x = torch.where(tokens == rep, -1, torch.arange(tokens.shape[0], device=dev))
        require(torch.equal(dp._prefix_max(x), torch.cummax(x, 0).values),
                "the two-level running maximum differs from torch.cummax")
        two = statistics.fmean(time_runs(lambda: dp._prefix_max(x), dev, 3))
        one = statistics.fmean(time_runs(lambda: torch.cummax(x, 0), dev, 3))
        log(f"[dp] one shard merge over {tokens.shape[0]} tokens (capacity; {len(data)} valid), "
            f"ms (CUDA events, mean of 3): a == b ({rep},{rep}) {aa:.4f}, a != b "
            f"{tuple(lazy_merges[0][:2])} {ab:.4f}; its running maximum: two-level {two:.4f}, "
            f"torch.cummax of the 1-D tensor {one:.4f}; {card}")
        return launches
    finally:
        dist.destroy_process_group()


def dp_rank_main(rank: int, world: int, port: int, tmp: pathlib.Path) -> int:
    """One rank of the dp-ranks phase: a gloo group of ``world`` processes,
    all on cuda:0, running every case and writing its results to
    ``tmp/rank<rank>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    from zigbpe_tpu_torch.ops.kernels import merge as km
    from zigbpe_tpu_torch.parallel import multihost, train_dp as dp

    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT_S))
    g = dp.DataGroup()
    corpus = CORPUS.read_bytes()
    out, secs, colls = {}, {}, {}

    def case(name, fn):
        c0, t0 = g.collectives, time.perf_counter()
        out[name] = fn()
        secs[name], colls[name] = time.perf_counter() - t0, g.collectives - c0
        print(f"rank {rank}: {name} {secs[name]:.3f} s", file=sys.stderr, flush=True)

    def replicated_512():
        # kept table: the replicated state every rank must hold alike
        tokens = dp.shard_corpus(corpus, g, dev)
        ub = dp.init_ub_dp(tokens, SCALE_VOCAB, g)
        merges = dp.train_dp_tokens(tokens, len(corpus), SCALE_VOCAB, g, ub=ub)
        digest = hashlib.sha256(ub.cpu().numpy().tobytes() + json.dumps(merges).encode())
        out["checksums"] = g.all_gather(torch.tensor(
            [int.from_bytes(digest.digest()[:7], "little")], device=dev)).flatten().tolist()
        return merges

    def files():
        path = [tmp / "corpus.txt"]
        tokens, total = dp.shard_corpus_from_files(path, g, dev)
        out["files_read"] = [int((tokens >= 0).sum()), total]
        return multihost.train_from_files(path, 300, g, device=dev)

    case("corpus_512", replicated_512)
    case("parity", lambda: dp.train_dp(DP_PARITY[0], DP_PARITY[1], g, device=dev))
    case("tiny", lambda: dp.train_dp(DP_TINY[0], DP_TINY[1], g, device=dev))
    lazy_max, dp.LAZY_VOCAB_MAX = dp.LAZY_VOCAB_MAX, DP_RANKS_LAZY_VOCAB_MAX
    case("sharded", lambda: dp.train_dp(corpus, DP_RANKS_SHARDED_VOCAB, g, device=dev))
    dp.LAZY_VOCAB_MAX = lazy_max
    case("files", files)
    out.update(seconds=secs, collectives=colls, launches=km.merge_pass_multi.launches)
    (tmp / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def phase_dp_ranks(torch, card, native_32768):
    """DP_RANKS processes on the one card, all on cuda:0, in a gloo group
    (NCCL takes no two ranks on one device): the conformance corpus to
    SCALE_VOCAB (a prefix of native_32768), DP_PARITY and DP_TINY against
    the port's oracle, the corpus to DP_RANKS_SHARDED_VOCAB on the
    row-sharded table (LAZY_VOCAB_MAX lowered; a prefix of native_32768),
    and train_from_files
    (golden merges.txt; each rank reports the bytes it read); every rank's
    checksum of its replicated table and merges must agree, and every rank
    must have launched the merge kernel. Returns the ranks' launches."""
    from zigbpe_tpu_torch import serde
    from zigbpe_tpu_torch.models import oracle
    from zigbpe_tpu_torch.parallel import train_dp as dp

    native = native_32768.result()
    corpus = CORPUS.read_bytes()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "corpus.txt").write_bytes(corpus)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--dp-rank", str(r), str(DP_RANKS), str(port), str(tmp)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ) for r in range(DP_RANKS)]
        try:
            outs = [p.communicate(timeout=2 * DP_GROUP_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                p.kill()
        wall = time.perf_counter() - t0
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            require(p.returncode == 0, f"rank {r} exited {p.returncode}: {err[-3000:]}")
        res = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(DP_RANKS)]
    want = {
        "corpus_512": native[: SCALE_VOCAB - 256],
        "parity": oracle.train(*DP_PARITY),
        "tiny": oracle.train(*DP_TINY),
        "sharded": native[: DP_RANKS_SHARDED_VOCAB - 256],
        "files": serde.load(GOLDEN),
    }
    for name, merges in want.items():
        for r, got in enumerate(res):
            got = [tuple(m) for m in got[name]]
            require(got == merges, f"rank {r}: {name} differs from merge "
                    f"{first_difference(got, merges)}")
    for r, got in enumerate(res):
        start, end, _ = dp.shard_range(len(corpus), r, DP_RANKS)
        require(got["files_read"] == [end - start, len(corpus)],
                f"rank {r} read {got['files_read']}, not its range [{start}, {end})")
        require(got["checksums"] == res[0]["checksums"], f"rank {r}'s checksums differ")
        require(got["launches"] > 0, f"rank {r} never launched the merge kernel")
    require(len(set(res[0]["checksums"])) == 1, "the ranks' replicated tables differ")
    r0 = res[0]
    log(f"[dp-ranks] ok: {DP_RANKS} gloo ranks on cuda:0 in {wall:.1f} s; every case == its "
        "reference on every rank (corpus to 512 and to "
        f"{DP_RANKS_SHARDED_VOCAB} sharded == native prefixes, a == b runs and empty ranks == "
        "oracle, files == merges.txt); checksums agree; merge launches by rank "
        f"{[x['launches'] for x in res]}; {card}")
    for name, s in r0["seconds"].items():
        n = len(r0[name])
        log(f"[dp-ranks]   {name}: {n} merges in {s:.3f} s ({s / max(n, 1) * 1e3:.3f} ms/merge), "
            f"{r0['collectives'][name] / max(n, 1):.2f} collectives a round (rank 0)")
    return sum(x["launches"] for x in res)


# ------------------------------------------------------ encode kernel cases

JAX_FUZZ_SEEDS = (0, 1, 2, 3, 5, 6, 7, 8)  # both groupers, caps 4, 8 and 16
FUZZ_PMAX = 32


def adversarial_table(rng, n_merges):
    """tests/test_encode_fuzz.py's generator: tables biased toward the
    grouping predicate's hard cases (repeated pairs, minted tokens fed back
    in, chains, a == b, re-minted and far out-of-range ids)."""
    alphabet = [97, 98, 99, 100]
    minted = []
    table = []
    next_new = 256
    for _ in range(n_merges):
        pool = alphabet + minted
        r = rng.random()
        if r < 0.15 and minted:
            a = b = int(rng.choice(minted))
        elif r < 0.3:
            a = b = int(rng.choice(alphabet))
        else:
            a = int(rng.choice(pool))
            b = int(rng.choice(pool))
        r2 = rng.random()
        if r2 < 0.08:
            x = int(rng.choice([9000, 40000, 65535]))
        elif r2 < 0.16 and minted:
            x = int(rng.choice(minted))
        else:
            x = next_new
            next_new += 1
        minted.append(x)
        table.append((a, b, x))
    return table


def fuzz_docs(rng, k):
    out = [bytes(rng.integers(97, 101, int(rng.integers(0, 600)), dtype=np.uint8))
           for _ in range(k)]
    return out + [b"", b"a" * 37]


def encode_cases():
    """(name, docs, merges, grouped table) of tests/test_encode_kernel.py's
    cases (grouped as encode_rows groups them) and of the chosen fuzz seeds
    (grouped and padded to FUZZ_PMAX groups as the fuzz test does)."""
    from zigbpe_tpu_torch.models import oracle
    from zigbpe_tpu_torch.ops.kernels import encode as ke

    rng = np.random.default_rng(21)  # drawn in test_encode_kernel.py's order
    data = bytes(rng.integers(97, 104, 4000, dtype=np.uint8))
    trained = oracle.train(data, 300)
    docs = [bytes(rng.integers(97, 104, int(rng.integers(1, 900)), dtype=np.uint8))
            for _ in range(4)] + [b"", b"a", b"aaaaaaa"]
    independent = [(97, 97, 256), (256, 97, 257), (98, 99, 258)]
    cases = [
        ("trained table", docs, trained),
        ("rows independent a", [b"aaaab bc", b"zzz"], independent),
        ("rows independent b", [b"aaaab bc", b"aaaa", b"bcbcbc"], independent),
        ("row collapsing", [b"a" * 8], [(97, 97, 256), (256, 256, 257), (257, 257, 258)]),
        ("out-of-range ids", [b"abcabc"], [(97, 98, 9000), (9000, 99, 257)]),
        ("PAD rows in table", [b"abcabc"], [(97, 98, 256), (-1, -1, -1), (256, 99, 257)]),
        ("empty table", [b"abcabc", b""], []),
    ]
    out = [(name, d, m, ke.group_merges(np.asarray(m, np.int32).reshape(-1, 3), cap=16))
           for name, d, m in cases]
    for seed in JAX_FUZZ_SEEDS:
        rng = np.random.default_rng(1000 + seed)
        table = adversarial_table(rng, int(rng.integers(1, 25)))
        docs = fuzz_docs(rng, 3)
        cap = int(rng.choice([4, 8, 16]))
        grouper = ke.schedule_merges if seed % 2 else ke.group_merges
        gt, gl = grouper(np.asarray(table, np.int32), cap=cap)
        gt_p = np.full((FUZZ_PMAX, cap, 3), -1, np.int32)
        gt_p[: gt.shape[0]] = gt
        gl_p = np.zeros((FUZZ_PMAX,), np.int32)
        gl_p[: gl.shape[0]] = gl
        out.append((f"fuzz seed {seed} {grouper.__name__} cap={cap}", docs, table,
                    (gt_p, gl_p)))
    doubling = [(97, 97, 256)] + [(256 + i, 256 + i, 257 + i) for i in range(14)]
    out.append(("32768-byte run of a, doubling", [b"a" * 32768], doubling,
                ke.schedule_merges(np.asarray(doubling, np.int32), cap=32)))
    return out


def encode_both(torch, buf, gt, gl):
    """The encode kernel on the card and its twin on a CPU copy, on the same
    rows. Returns the twin's (out, lengths) as numpy and max |kernel - twin|."""
    from zigbpe_tpu_torch.ops.kernels import encode as ke

    gout, glen = ke.encode_rows_grouped(torch.from_numpy(buf).cuda(),
                                        torch.from_numpy(gt).cuda(),
                                        torch.from_numpy(gl).cuda())
    torch.cuda.synchronize()
    cout, clen = ke.encode_rows_grouped_reference(
        torch.from_numpy(buf), torch.from_numpy(gt), torch.from_numpy(gl))
    err = max(int((gout.cpu().long() - cout.long()).abs().max()),
              int((glen.cpu().long() - clen.long()).abs().max()))
    return cout.numpy(), clen.numpy(), err


def phase_encode_kernel(torch):
    from zigbpe_tpu_torch.models import oracle

    worst = 0
    for name, docs, merges, (gt, gl) in encode_cases():
        live = [tuple(m) for m in merges if m[2] >= 0]
        for L in (1024, 32768):
            if max(len(d) for d in docs) > L:
                continue
            buf = np.full((len(docs), L), -1, np.int32)
            for i, d in enumerate(docs):
                buf[i, : len(d)] = np.frombuffer(d, np.uint8)
            out, lens, err = encode_both(torch, buf, gt, gl)
            worst = max(worst, err)
            rows = [out[i, : lens[i]].tolist() for i in range(len(docs))]
            same = err == 0 and rows == [oracle.encode(d, live) for d in docs]
            log(f"  {name:40s} L={L:>5} B={len(docs)} P={gt.shape[0]:>2} cap={gt.shape[1]:>2} "
                f"max_abs_err={err} {'ok' if same else 'MISMATCH'}")
            require(same, f"encode kernel != twin or oracle on {name} at L={L}")
    log(f"[encode-kernel] ok: kernel == twin == oracle on every case, max_abs_err {worst}")
    return worst


def phase_serving(torch, card, build_s):
    from zigbpe_tpu_torch import BasicTokenizer
    from zigbpe_tpu_torch.ops import core
    from zigbpe_tpu_torch.ops.kernels import encode as ke

    data = tiled_corpus(SERVE_BYTES)
    t0 = time.perf_counter()
    table = native_train(data[:SERVE_TABLE_BYTES], 256 + SERVE_MERGES)
    require(len(table) == SERVE_MERGES, f"native trainer gave {len(table)} merges")
    gt_np, gl_np = ke.schedule_merges(np.asarray(table, np.int32), cap=32)
    P = gt_np.shape[0]
    digest = hashlib.sha256(np.asarray(table, np.int32).tobytes()).hexdigest()[:12]
    log(f"  table: {SERVE_MERGES} merges trained natively on 1 MiB (sha256 {digest}), "
        f"scheduled into P={P} fused passes of cap 32 ({time.perf_counter() - t0:.1f} s)")

    # the user's path, its launch count from zero: encode_batch on documents
    # of mixed length (L = 16384, the first call schedules the table), then
    # on SERVE_DOCS of config 3's 32768-byte rows (L = 32768). Each call is
    # one launch of the encode kernel.
    corpus = CORPUS.read_bytes()
    cuts = np.sort(np.random.default_rng(3).choice(np.arange(1, len(corpus)), 99,
                                                   replace=False)).tolist()
    docs = [corpus[a:b] for a, b in zip([0, *cuts], [*cuts, len(corpus)])] + [b""]
    B = SERVE_BYTES // SERVE_ROW
    serve_idx = np.linspace(0, B - 1, SERVE_DOCS).astype(np.int64)
    row_docs = [data[i * SERVE_ROW:(i + 1) * SERVE_ROW] for i in serve_idx.tolist()]
    tok = BasicTokenizer(table, device="cuda")
    ke.encode_rows_grouped.launches = 0
    t1 = time.perf_counter()
    ids = tok.encode_batch(docs)
    batch_s = time.perf_counter() - t1
    mixed_launches = ke.encode_rows_grouped.launches
    t = time.perf_counter()
    row_ids = tok.encode_batch(row_docs)
    row_s = [time.perf_counter() - t]
    launches = ke.encode_rows_grouped.launches
    require(mixed_launches == 1, f"encode_batch of the mixed documents launched the "
            f"encode kernel {mixed_launches} times, want 1")
    require(launches == 2, f"encode_batch of {SERVE_DOCS} rows of {SERVE_ROW} bytes "
            f"launched the encode kernel {launches - mixed_launches} times, want 1")
    again = []  # kept, so that no timed span frees an earlier call's lists
    for _ in range(2):  # cached table: the call's steady latency
        t = time.perf_counter()
        again.append(tok.encode_batch(row_docs))
        row_s.append(time.perf_counter() - t)
    require(all(a == row_ids for a in again), "repeated encode_batch calls differ")
    del again

    require(ids == BasicTokenizer(table, device="cpu").encode_batch(docs),
            "card encode_batch differs from the CPU path")
    for d, got in zip(docs, ids):
        require(got == native_encode(d, table).tolist(),
                "card encode_batch differs from the native C++ encoder")
    L_docs = max(len(d) for d in docs)
    log(f"[serving] ok: encode_batch of {len(docs)} documents (longest {L_docs} bytes, "
        f"1 launch) in {batch_s:.3f} s == CPU path == native encoder")

    # and at config 3 size: 1 GiB as 32768 rows of 32768 tokens, uploaded
    # as uint8 and widened on the card
    t2 = time.perf_counter()
    tokens, _ = core.pad_tokens(data, SERVE_BYTES, "cuda")
    rows = tokens.view(B, SERVE_ROW)
    gt, gl = torch.from_numpy(gt_np).cuda(), torch.from_numpy(gl_np).cuda()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t2

    tw_out, tw_len = ke.encode_rows_grouped_reference(
        rows[torch.from_numpy(serve_idx).cuda()], gt, gl)
    tw_out, tw_len = tw_out.cpu().numpy(), tw_len.cpu().numpy()
    for k, got in enumerate(row_ids):
        require(np.array_equal(np.asarray(got, np.int32), tw_out[k, : tw_len[k]]),
                f"encode_batch row {serve_idx[k]} differs from the twin")
    for k in np.linspace(0, SERVE_DOCS - 1, 16).astype(np.int64).tolist():
        require(row_ids[k] == native_encode(row_docs[k], table).tolist(),
                f"encode_batch row {serve_idx[k]} differs from the native C++ encoder")
    log(f"[serving] ok: encode_batch of {SERVE_DOCS} documents of {SERVE_ROW} bytes "
        f"(L = {SERVE_ROW}, 1 launch) == twin on the card, 16 of them == native "
        f"encoder; host clock per call {', '.join(f'{s * 1e3:.3f}' for s in row_s)} ms "
        f"(first, then 2 more); {card}")

    t3 = time.perf_counter()
    direct0 = ke.encode_rows_grouped.launches
    out, lens = ke.encode_rows_grouped(rows, gt, gl)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t3
    require(ke.encode_rows_grouped.launches - direct0 == 1, "1 GiB replay: not 1 launch")

    lens_h = lens.cpu().numpy()
    n_out = int(lens_h.astype(np.int64).sum())
    require(out.shape == (B, SERVE_ROW) and out.dtype == torch.int32, "output shape")
    require(bool((lens_h > 0).all()), "a row encoded to nothing")
    require(torch.equal((out >= 0).sum(1, dtype=torch.int32), lens), "lengths != valid counts")
    require(int(out.max()) < 256 + SERVE_MERGES and int(out.min()) >= -1, "ids out of range")
    worst = 0
    pick = np.unique(np.linspace(0, B - 1, min(4096, B)).astype(np.int64))
    t4 = time.perf_counter()
    for chunk in np.array_split(pick, 4):
        idx = torch.from_numpy(chunk).cuda()
        tw_out, tw_len = ke.encode_rows_grouped_reference(rows[idx], gt, gl)
        worst = max(worst, int((tw_out - out[idx]).abs().max()),
                    int((tw_len - lens[idx]).abs().max()))
    require(worst == 0, f"encode kernel != twin on the 1 GiB batch (max_abs_err {worst})")
    twin_check_s = time.perf_counter() - t4
    for i in np.linspace(0, B - 1, 64).astype(np.int64).tolist():
        want = native_encode(data[i * SERVE_ROW:(i + 1) * SERVE_ROW], table)
        require(np.array_equal(out[i, : lens_h[i]].cpu().numpy(), want),
                f"row {i} differs from the native C++ encoder")
    log(f"[serving] ok: 1 GiB = {B} rows x {SERVE_ROW} tokens -> {n_out} tokens "
        f"({SERVE_BYTES / n_out:.4f} bytes/token); {len(pick)} rows == twin (max_abs_err {worst}, "
        f"{twin_check_s:.1f} s), 64 rows == native encoder; upload {upload_s:.3f} s, "
        f"first replay {first_s:.3f} s")
    del out, lens

    sub = rows[:1024]
    ms_runs = time_runs(lambda: ke.encode_rows_grouped(sub, gt, gl), sub.device, 5)
    plain_runs = time_runs(lambda: ke.encode_rows_grouped_reference(sub, gt, gl), sub.device, 2)
    full_runs = time_runs(lambda: ke.encode_rows_grouped(rows, gt, gl), rows.device, 3)
    ms, plain, full = map(statistics.fmean, (ms_runs, plain_runs, full_runs))
    mbps = SERVE_BYTES / 1e6 / (full / 1e3)
    smem = ke.smem_bytes(SERVE_ROW, P, 32)
    # the bound of the 1024 rows: 8 B a token of device memory, or the
    # shared-memory traffic of the passes, each pass with a live member
    # reading the rows' tokens and writing the kept ones (as the twin, run
    # one group at a time, counts them), whichever is larger
    t, moved = sub, 0
    for p in range(P):
        if not any(m[2] >= 0 for m in gt_np[p][: gl_np[p]]):
            continue
        n_in = int((t >= 0).sum())
        t, _ = ke.encode_rows_grouped_reference(t, gt[p: p + 1], gl[p: p + 1])
        moved += 4 * (n_in + int((t >= 0).sum()))
    del t
    hbm_ms, _ = bound_ms(8 * sub.numel())
    clock = max_sm_clock_hz()
    sm_ms = smem_bound_ms(moved, clock)
    bound = max(hbm_ms, sm_ms)
    log(f"[serving] encode kernel bound on 1024 rows: {bound:.4f} ms (bytes): device memory "
        f"{hbm_ms:.4f} ms (8 B a token), shared memory {sm_ms:.4f} ms ({moved} B over {P} "
        f"passes at {SMS} SMs x 128 B a clock, {clock / 1e9:.3f} GHz); kernel / bound "
        f"{ms / bound:.2f}; {card}")
    log(f"[serving] encode kernel, 1024 rows x {SERVE_ROW} tokens, P={P}: kernel "
        f"{ms:.4f} ms (mean of 5: {', '.join(f'{t:.4f}' for t in ms_runs)}), plain "
        f"PyTorch twin {plain:.4f} ms (mean of 2: "
        f"{', '.join(f'{t:.4f}' for t in plain_runs)}) (CUDA events); {card}")
    log(f"[serving] encode kernel over 1 GiB ({B} x {SERVE_ROW}): {full:.3f} ms "
        f"(mean of 3: {', '.join(f'{t:.3f}' for t in full_runs)}) = {mbps:.1f} MB/s; "
        f"dynamic shared memory {smem} B per block; build {build_s:.2f} s; {card}")
    require(smem == 4 * ke.smem_words(SERVE_ROW, 32), "smem_words disagrees with the C side")

    encode_repeat_check(torch, ke, sub, gt, gl)
    wide_check(torch, ke, sub[:64], gt_np, gl_np)
    encode_split(torch, sub, split_tables(data[: sub.numel()], gt_np, gl_np), card)
    return {"launches": launches, "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": "bytes"}


# ------------------------------------------------------- encode pass split

SPLIT_ROUNDS = 7
SPLIT_ROWS = 1024


def split_tables(data: bytes, gt_np: np.ndarray, gl_np: np.ndarray) -> dict:
    """The four grouped tables that split an encode pass by part, for the
    rows cut from ``data`` (SERVE_ROW bytes each), beside the real table
    (``gt_np``, ``gl_np``), all of its shape [P, cap, 3]:

    dead   -- the real table with every new id -1: every pass is skipped, so
              it times the load, the store and the table staging;
    miss   -- P groups of cap byte pairs that never stand next to each other
              in the rows, each group's first bytes and second bytes drawn
              from disjoint halves of the bytes present (so chain-free):
              every token is probed and nothing hits;
    real   -- the table itself: probes, hits and compaction;
    parity -- P singleton groups with a == b on the bytes whose doubled pair
              is commonest in the rows, in turn: the a == b path.
    """
    P, cap = gt_np.shape[:2]
    d = np.frombuffer(data, np.uint8).reshape(-1, SERVE_ROW).astype(np.int64)
    pairs = np.bincount((d[:, :-1] * 256 + d[:, 1:]).ravel(), minlength=65536).reshape(256, 256)
    present = np.flatnonzero(np.bincount(d.ravel(), minlength=256))
    dead = gt_np.copy()
    dead[..., 2] = -1
    rng = np.random.default_rng(8)
    miss = np.full((P, cap, 3), -1, np.int32)
    for p in range(P):
        side = rng.random(len(present)) < 0.5
        never = [(a, b) for a in present[side] for b in present[~side] if pairs[a, b] == 0]
        pick = np.asarray(never, np.int32)[rng.choice(len(never), cap, replace=False)]
        miss[p, :, :2] = pick
        miss[p, :, 2] = 256 + p * cap + np.arange(cap)
    doubled = np.diagonal(pairs)
    runs = np.argsort(-doubled, kind="stable")[: min(8, np.count_nonzero(doubled))]
    parity = np.full((P, cap, 3), -1, np.int32)
    for p in range(P):
        b = int(runs[p % len(runs)])
        parity[p, 0] = (b, b, 256 + p)
    full, one = np.full(P, cap, np.int32), np.ones(P, np.int32)
    return {"dead": (dead, gl_np), "miss": (miss, full), "real": (gt_np, gl_np),
            "parity": (parity, one)}


def encode_split(torch, rows, tables: dict, card: str, check_rows: int = 64) -> dict:
    """Each table of ``tables`` (name -> (gtable, glens) numpy) through the
    encode kernel over ``rows`` (a [B, L] int32 tensor on the card): the
    kernel equals its twin on ``check_rows`` rows spread over the batch, then
    the tables are timed in turns, SPLIT_ROUNDS rounds after a warm-up, one
    call each with CUDA events. Prints and returns name -> (median, min, max)
    ms, and the differences a pass: probes (miss - dead), hits and
    compaction (real - miss), the a == b path (parity - dead)."""
    from zigbpe_tpu_torch.ops.kernels import encode as ke

    dev = {name: (torch.from_numpy(gt).cuda(), torch.from_numpy(gl).cuda())
           for name, (gt, gl) in tables.items()}
    idx = torch.from_numpy(np.unique(np.linspace(0, rows.shape[0] - 1, check_rows)
                                     .astype(np.int64))).cuda()
    for name, (gt, gl) in dev.items():
        out, lens = ke.encode_rows_grouped(rows, gt, gl)
        tw_out, tw_len = ke.encode_rows_grouped_reference(rows[idx], gt, gl)
        err = max(int((tw_out - out[idx]).abs().max()), int((tw_len - lens[idx]).abs().max()))
        require(err == 0, f"encode kernel != twin on the {name} table (max_abs_err {err})")
    del out, lens
    times = {name: [] for name in dev}
    for _ in range(SPLIT_ROUNDS + 1):
        for name, (gt, gl) in dev.items():
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            ke.encode_rows_grouped(rows, gt, gl)
            e1.record()
            e1.synchronize()
            times[name].append(e0.elapsed_time(e1))
    result = {name: (statistics.median(t[1:]), min(t[1:]), max(t[1:]))
              for name, t in times.items()}
    B, L = rows.shape
    P = next(iter(tables.values()))[0].shape[0]
    for name, (med, lo, hi) in result.items():
        log(f"[split] {name:6s} {med:.4f} ms (median of {SPLIT_ROUNDS}, {lo:.4f}-{hi:.4f}); "
            f"{B} rows x {L}, P={P}; kernel == twin on {len(idx)} rows")
    us = {k: v[0] * 1e3 / P for k, v in result.items()}
    log(f"[split] a pass over the batch: probes (miss - dead) {us['miss'] - us['dead']:.2f} us, "
        f"hits and compaction (real - miss) {us['real'] - us['miss']:.2f} us, a == b path "
        f"(parity - dead) {us['parity'] - us['dead']:.2f} us; load, store and staging (dead) "
        f"{result['dead'][0]:.4f} ms in all; {card}")
    return result


def split_main(torch, card: str) -> int:
    """``python3 chip_smoke.py --encode-split``: build the encode kernel,
    print its ptxas line, hold it to its twin and the oracle on the cases
    of phase 4, and split a pass by part on the serving rows (SPLIT_ROWS
    rows of config 3's 1 GiB, its table scheduled at cap 32)."""
    from zigbpe_tpu_torch.ops import core
    from zigbpe_tpu_torch.ops.kernels import _build, encode as ke

    log_ptxas("encode", _build.build("encode"))
    phase_encode_kernel(torch)
    data = tiled_corpus(SPLIT_ROWS * SERVE_ROW)
    table = native_train(data[:SERVE_TABLE_BYTES], 256 + SERVE_MERGES)
    gt_np, gl_np = ke.schedule_merges(np.asarray(table, np.int32), cap=32)
    rows = core.pad_tokens(data, len(data), "cuda")[0].view(SPLIT_ROWS, SERVE_ROW)
    encode_split(torch, rows, split_tables(data, gt_np, gl_np), card)
    return 0


REPEATS = 20


def encode_repeat_check(torch, ke, rows, gt, gl) -> None:
    """REPEATS launches on one input, each equal to the first (a race
    between warps, or in the staging, would show as a difference)."""
    first, first_len = ke.encode_rows_grouped(rows, gt, gl)
    for i in range(REPEATS - 1):
        out, lens = ke.encode_rows_grouped(rows, gt, gl)
        require(torch.equal(out, first) and torch.equal(lens, first_len),
                f"encode kernel: repeat {i + 1} of {REPEATS} differs from the first")
    log(f"[serving] ok: {REPEATS} launches on {rows.shape[0]} rows x {rows.shape[1]} "
        f"are equal")


WIDE = 70000  # an id offset past 65535


def wide_check(torch, ke, rows, gt_np, gl_np) -> None:
    """Ids >= 65536: the byte ``e`` becomes WIDE + 101 in the rows and in the
    table's pairs, so groups that hold it take the linear-probing table and
    the others probe with the width test; kernel == twin (run on the card)."""
    e = ord("e")
    wrows = torch.where(rows == e, rows + WIDE, rows)
    gt_w = gt_np.copy()
    pairs = gt_w[..., :2]
    pairs[pairs == e] += WIDE
    gt, gl = torch.from_numpy(gt_w).cuda(), torch.from_numpy(gl_np).cuda()
    out, lens = ke.encode_rows_grouped(wrows, gt, gl)
    tw_out, tw_len = ke.encode_rows_grouped_reference(wrows, gt, gl)
    err = max(int((tw_out - out).abs().max()), int((tw_len - lens).abs().max()))
    require(err == 0, f"encode kernel != twin with ids >= 65536 (max_abs_err {err})")
    require(bool((out >= WIDE).any()), "the wide-id rows kept no wide id")
    log(f"[serving] ok: ids >= 65536 (e -> {WIDE + e}) on {rows.shape[0]} rows: kernel == "
        f"twin, max_abs_err {err}")


# ------------------------------------------------------------------ bench

def phase_bench(torch, card):
    """The port's measurement entry points, called in this process through
    their ``run`` functions: bench, config 2 and config 3, and the probes
    breakdown, encode and select_batch. Returns the merge and encode
    kernels' launches on this path."""
    from zigbpe_tpu_torch import bench
    from zigbpe_tpu_torch.ops.kernels import encode as ke, merge as km
    from zigbpe_tpu_torch.probes import breakdown, encode, select_batch
    from zigbpe_tpu_torch.scripts import run_config2, run_config3

    km.merge_pass_multi.launches = ke.encode_rows_grouped.launches = 0
    t0 = time.perf_counter()
    line = bench.run("cuda", BENCH_BYTES, SCALE_VOCAB - 256, runs=1)
    require(all(np.isfinite(line[k]) and line[k] > 0 for k in (
        "value", "upload_s", "warmup_s", "native_baseline_mbps",
        "encode_mbps_1kmerge_batched")), f"bench line: {line}")
    require(line["device"] == card, f"bench names {line['device']!r}, not {card!r}")
    log(f"[bench] ok: bench at {BENCH_BYTES} bytes, 1 run ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(line)}")

    t1 = time.perf_counter()
    line = run_config2.run("cuda", CONFIG2_BYTES, CONFIG2_MERGES)
    require(line["conforms_to_native"], "config 2: the card's merges differ from the native "
            "trainer's")
    require(line["serde_roundtrip"], "config 2: merges.txt does not round-trip")
    log(f"[bench] ok: config 2 at {CONFIG2_BYTES} bytes and {CONFIG2_MERGES} merges == native "
        f"({time.perf_counter() - t1:.1f} s): {json.dumps(line)}")

    t2 = time.perf_counter()
    line = run_config3.run("cuda", SERVE_BYTES)
    require((line["rows"], line["row_tokens"]) == (SERVE_BYTES // SERVE_ROW, SERVE_ROW),
            f"config 3 rows: {line}")
    require(line["tokens_out"] == CONFIG3_TOKENS_OUT and line["fused_passes"] == CONFIG3_PASSES,
            f"config 3 gave {line['tokens_out']} tokens in {line['fused_passes']} passes, the "
            f"TPU run {CONFIG3_TOKENS_OUT} in {CONFIG3_PASSES}")
    log(f"[bench] ok: config 3 at 1 GiB: {CONFIG3_TOKENS_OUT} tokens, {CONFIG3_PASSES} passes "
        f"as on the TPU ({time.perf_counter() - t2:.1f} s): {json.dumps(line)}")

    t3 = time.perf_counter()
    rows = breakdown.run("cuda", BENCH_BYTES, BENCH_ROUNDS, runs=2)  # raises off the native
    log(f"[bench] ok: breakdown at {BENCH_BYTES} bytes, {BENCH_ROUNDS} rounds, full == native "
        f"({time.perf_counter() - t3:.1f} s)")
    t4 = time.perf_counter()
    enc = encode.run("cuda", SERVE_BYTES, SERVE_ROW, runs=2)
    require(enc["tokens_out"] == CONFIG3_TOKENS_OUT,
            f"probes encode at 1 GiB gave {enc['tokens_out']} tokens, config 3 "
            f"{CONFIG3_TOKENS_OUT}")
    log(f"[bench] ok: probes encode at 1 GiB, group_merges table of {enc['fused_passes']} "
        f"passes: {CONFIG3_TOKENS_OUT} tokens as config 3 ({time.perf_counter() - t4:.1f} s)")
    t5 = time.perf_counter()
    sb = select_batch.run("cuda", BENCH_BYTES, BENCH_SELECT_VOCAB, runs=1)  # raises on a split
    want = native_train(tiled_corpus(BENCH_BYTES), BENCH_SELECT_VOCAB)
    require(sb["merges"] == want, "select_batch's merges differ from the native trainer's")
    log(f"[bench] ok: select_batch 8/16/32 at {BENCH_BYTES} bytes to vocab "
        f"{BENCH_SELECT_VOCAB}: equal merges == native ({time.perf_counter() - t5:.1f} s); "
        f"derived ms a round: " + ", ".join(f"{k} {v:.3f}" for k, v in rows["derived"].items()))
    launches = {"merge": km.merge_pass_multi.launches, "encode": ke.encode_rows_grouped.launches}
    require(all(launches.values()), f"a kernel never launched on the bench path: {launches}")
    return launches


def bench_main(torch, card: str) -> int:
    """``python3 chip_smoke.py --bench``: build the merge and encode kernels
    and the native library, and run the bench phase alone."""
    from zigbpe_tpu_torch.ops.kernels import _build

    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_build.build, ("merge", "encode")))
    require(fastio.build() and fastio.available(), "the native library did not build (g++)")
    launches = run_phase("bench", phase_bench, torch, card)
    log(f"[count] ok: on the bench path the merge kernel launched {launches['merge']} times, "
        f"the encode kernel {launches['encode']}")
    return 0


def run_phase(name, fn, *args):
    t0 = time.perf_counter()
    result = fn(*args)
    log(f"[{name}] wall {time.perf_counter() - t0:.1f} s")
    return result


def main() -> int:
    if sys.argv[1:2] == ["--dp-rank"]:
        rank, world, port, tmp = sys.argv[2:6]
        return dp_rank_main(int(rank), int(world), int(port), pathlib.Path(tmp))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    card = card_line()
    log(card)
    if sys.argv[1:] == ["--encode-split"]:
        return split_main(torch, card)
    if sys.argv[1:2] == ["--products"]:
        return products_main(torch, card, sys.argv[2:] == ["--time-only"])
    if sys.argv[1:] == ["--bench"]:
        return bench_main(torch, card)
    if sys.argv[1:] == ["--count"]:
        return count_main(torch, card)
    from zigbpe_tpu_torch.ops.kernels import encode as ke, merge as km

    t_all = time.perf_counter()
    build_s = run_phase("build", phase_build)
    # the native trainer takes most of a minute on one core for the sorted
    # phase's merges (it releases the interpreter lock): start it now
    native_pool = ThreadPoolExecutor(1)
    native_32768 = native_pool.submit(native_train, CORPUS.read_bytes(),
                                      SORTED_VOCAB)
    # a real K=4 group: the golden run's trained table
    golden = [tuple(int(v) for v in line.split(",")) for line in GOLDEN.read_text().split()]
    group = first_group(golden)
    group2 = first_group(golden[golden.index(tuple(group[-1])) + 1:])
    log(f"  real groups from the golden training: {group} then {group2}")
    max_err = run_phase("kernel", phase_kernel, torch, group, group2)
    timing = run_phase("timing", phase_timing, torch, group, card)
    count = run_phase("verify", check_count, torch, card)
    count["launches"] = train_counted(torch)
    probes = run_phase("probes", phase_probes, torch, group, card)
    enc_err = run_phase("encode-kernel", phase_encode_kernel, torch)

    km.merge_pass_multi.launches = 0
    run_phase("golden", phase_golden, torch)
    lazy_merges = run_phase("scale", phase_scale, torch, card)
    launches = km.merge_pass_multi.launches
    km.merge_pass_multi.launches = 0
    run_phase("sorted", phase_sorted, torch, card, lazy_merges, native_32768)
    sorted_launches = km.merge_pass_multi.launches
    km.merge_pass_multi.launches = 0
    dp_launches = run_phase("dp", phase_dp, torch, card, lazy_merges, native_32768)
    dp_ranks_launches = run_phase("dp-ranks", phase_dp_ranks, torch, card, native_32768)
    native_pool.shutdown()
    serving = run_phase("serving", phase_serving, torch, card, build_s["encode"])
    bench_launches = run_phase("bench", phase_bench, torch, card)
    require(launches > 0, "the merge kernel never launched on the train/encode path")
    require(sorted_launches > 0, "the merge kernel never launched on the sorted training path")
    require(dp_launches > 0, "the merge kernel never launched on the data-parallel path")
    require(serving["launches"] > 0, "the encode kernel never launched on the serving path")
    for name, row in probes.items():
        require(row["launches"] > 0, f"{name} never launched on the probes' path")
    log(f"[count] ok: merge kernel launched {launches} times on the train/encode path and "
        f"{sorted_launches} on the sorted training path, {dp_launches} on the dp path and "
        f"{dp_ranks_launches} on the dp-ranks path (over {DP_RANKS} ranks), "
        f"encode kernel {serving['launches']} times on the encode_batch path; on the bench "
        f"path merge {bench_launches['merge']}, encode {bench_launches['encode']}; on the "
        f"probes' path " + ", ".join(f"{n} {r['launches']}" for n, r in probes.items()))
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")

    ms, plain = timing["K=4"]
    # bounds: a pass over 2^25 int32 tokens reads and writes each once; the
    # encode kernel's comes from phase_serving (its shared-memory passes)
    pass_bound, pass_by = bound_ms(2 * 4 * (1 << 25))
    kernels = [{
        "name": "merge_pass_multi", "route": "cuda",
        "source": "zigbpe_tpu_torch/csrc/merge.cu",
        "replaces": "zigbpe_tpu/ops/pallas/merge.py:222",
        "launches": (launches + sorted_launches + dp_launches + dp_ranks_launches
                     + bench_launches["merge"]),
        "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain,
        "bound_ms": pass_bound, "bound_by": pass_by, "library_ms": None,
    }, {
        "name": ke.encode_rows_grouped.__name__, "route": "cuda",
        "source": "zigbpe_tpu_torch/csrc/encode.cu",
        "replaces": "zigbpe_tpu/ops/pallas/encode.py:238",
        "launches": serving["launches"] + bench_launches["encode"],
        "max_abs_err": max(enc_err, serving["max_abs_err"]),
        "ms": serving["ms"], "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"], "bound_by": serving["bound_by"], "library_ms": None,
    }, {
        "name": "count_queries", "route": "cuda", "source": "zigbpe_tpu_torch/csrc/count.cu",
        "replaces": None, **count,
    }]
    for name, source, replaces in PROBE_SOURCES:
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, **probes[name]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
