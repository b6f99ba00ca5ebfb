#!/usr/bin/env python3
"""Smoke run of the PyTorch port (zigbpe_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass:

1. build   — compile the CUDA kernels of ``zigbpe_tpu_torch/csrc/`` (nvcc,
             sm_90a) into ``zigbpe_tpu_torch/_build/``;
2. kernel  — the merge kernel against its plain PyTorch twin (run on a CPU
             copy) at 1 tile, many tiles and 2^25 tokens: K = 1 with a != b,
             K = 1 with a == b and runs spanning many tiles, K = 4 groups
             from a real training run, disabled slots, a second pass on the
             row-local output and a draining degenerate corpus. Tokens and
             hit counts / new length must be equal and the min_kept <= 1
             decision must agree. Then both are timed at 2^25 tokens with
             CUDA events;
3. golden  — BasicTokenizer(device="cuda") trains the conformance corpus to
             vocab 300 (exactly tests/data/merges.txt), encodes it on the
             card (128,451 tokens, equal to the CPU twin path) and decodes
             it back; ``python -m zigbpe_tpu_torch.cli demo`` round-trips the
             probe;
4. scale   — the corpus tiled to 32 MiB, trained to vocab 512 on the card
             and cross-checked against the native C++ trainer
             (zigbpe_tpu/native/fastio.cpp, built with g++ and called by
             path); the 32 MiB corpus encoded on the card equals the native
             encoder's ids;
5. count   — the merge kernel's launch counter, zeroed before phase 3, is
             > 0 after phase 4.

Prints each phase's result and wall time, then a JSON line of kernels, the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Exits non-zero without a result when there
is no CUDA device or any phase fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
CORPUS = ROOT / "tests" / "data" / "taylorswift.txt"
GOLDEN = ROOT / "tests" / "data" / "merges.txt"
NATIVE_SRC = ROOT / "zigbpe_tpu" / "native" / "fastio.cpp"
PROBE = "hello world!!!? (안녕하세요!) lol123 😉"
SCALE_BYTES = 32 << 20  # bench.py's headline corpus: 32 MiB
SCALE_VOCAB = 512       # 256 merges
GOLDEN_TOKENS = 128451


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


def tiled_corpus(total: int) -> bytes:
    seed = CORPUS.read_bytes()
    return (seed * (total // len(seed) + 1))[:total]


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


# ------------------------------------------------------------------ native

def native_library() -> ctypes.CDLL:
    """The repo's C++ host trainer/encoder, built from source by path."""
    from zigbpe_tpu_torch.ops.kernels import _build

    digest = hashlib.sha256(NATIVE_SRC.read_bytes()).hexdigest()[:16]
    lib_path = _build.BUILD_DIR / f"libzigbpe_native_{digest}.so"
    if not lib_path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(NATIVE_SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.zbpe_train.restype = ctypes.c_int64
    lib.zbpe_train.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                               ctypes.c_void_p]
    lib.zbpe_encode.restype = ctypes.c_int64
    lib.zbpe_encode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_int64, ctypes.c_void_p]
    return lib


def native_train(lib, data: bytes, vocab: int):
    out = np.zeros(3 * (vocab - 256), np.int32)
    k = lib.zbpe_train(data, len(data), vocab, out.ctypes.data)
    require(k >= 0, "native trainer rejected its arguments")
    return [tuple(int(v) for v in row) for row in out[: 3 * k].reshape(-1, 3)]


def native_encode(lib, data: bytes, merges) -> np.ndarray:
    flat = np.asarray(merges, np.int32).reshape(-1)
    out = np.zeros(len(data), np.int32)
    n = lib.zbpe_encode(data, len(data), flat.ctypes.data, len(merges), out.ctypes.data)
    return out[:n]


# ------------------------------------------------------------------ phases

def phase_build():
    from zigbpe_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    path = _build.build("merge")
    secs = time.perf_counter() - t0
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"[build] ok: {path.relative_to(ROOT)} in {secs:.2f} s")


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
    for cap in (4096, 128 * 1000, 1 << 25):
        arr = padded(tiled_corpus(cap - int(rng.integers(1, 300))), cap)
        check(f"K=1 a!=b cap={cap}", arr, [group[0]])
        check(f"K=1 a==b cap={cap}", arr, [(aa, aa, 256)])
        mid, _ = check(f"K=4 real group cap={cap}", arr, group)
        check(f"K=4 disabled slots cap={cap}", arr, disabled)
        check(f"K=4 next group, 2nd pass cap={cap}", mid, group2)
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


def time_pass(torch, fn, src, table, reps):
    """Mean ms of fn(tokens, table) on a fresh copy of ``src`` each rep,
    CUDA events around the pass only."""
    work = src.clone()
    fn(work, table)  # warm-up
    times = []
    for _ in range(reps):
        work.copy_(src)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(work, table)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return sum(times) / len(times)


def phase_timing(torch, group):
    from zigbpe_tpu_torch.ops.kernels import merge as km

    aa = commonest_repeat()
    src = torch.from_numpy(padded(tiled_corpus((1 << 25) - 100), 1 << 25)).cuda()
    out = {}
    for label, table in (("K=4", group), ("K=1 a==b", [[aa, aa, 256]])):
        t = torch.tensor(table, dtype=torch.int32, device="cuda")
        ms = time_pass(torch, km.merge_pass_multi, src, t, 20)
        plain = time_pass(torch, km.merge_pass_multi_reference, src, t, 5)
        log(f"[timing] merge pass at 2^25 tokens, {label}: kernel {ms:.4f} ms, "
            f"plain PyTorch twin {plain:.4f} ms (CUDA events, mean)")
        out[label] = (ms, plain)
    return out


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

    data = tiled_corpus(SCALE_BYTES)
    mb = len(data) / 1e6
    runs = []
    for _ in range(2):  # the first run includes one-time CUDA set-up
        passes0 = km.merge_pass_multi.launches
        t0 = time.perf_counter()
        tok = BasicTokenizer(device="cuda").train(data, SCALE_VOCAB)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, km.merge_pass_multi.launches - passes0))
    train_s, passes = runs[-1]
    require(len(tok.merges) == SCALE_VOCAB - 256, f"{len(tok.merges)} merges")
    t1 = time.perf_counter()
    ids = tok.encode(data, backend="device")
    enc_s = time.perf_counter() - t1
    log(f"[scale] card training: {mb:.3f} MB to vocab {SCALE_VOCAB}: "
        f"{train_s:.3f} s = {mb / train_s:.2f} MB/s (first run {runs[0][0]:.3f} s), "
        f"{passes} merge passes, {train_s / (SCALE_VOCAB - 256) * 1e3:.3f} ms/merge; {card}")
    log(f"[scale] card encode: {mb:.3f} MB, {len(ids)} tokens in {enc_s:.3f} s "
        f"= {mb / enc_s:.2f} MB/s; {card}")

    lib = native_library()
    t2 = time.perf_counter()
    want = native_train(lib, data, SCALE_VOCAB)
    nat_train_s = time.perf_counter() - t2
    require(tok.merges == want, "card merges differ from the native C++ trainer's")
    t3 = time.perf_counter()
    want_ids = native_encode(lib, data, want)
    nat_enc_s = time.perf_counter() - t3
    require(np.array_equal(np.asarray(ids, np.int32), want_ids),
            "card encode differs from the native C++ encoder's")
    log(f"[scale] ok: 256 merges == native C++ trainer ({nat_train_s:.1f} s, "
        f"{mb / nat_train_s:.2f} MB/s one core), ids == native encoder "
        f"({nat_enc_s:.1f} s)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    card = card_line()
    log(card)
    sys.path.insert(0, str(ROOT))
    from zigbpe_tpu_torch.ops.kernels import merge as km

    t_all = time.perf_counter()
    phase_build()
    # a real K=4 group: the golden run's trained table
    golden = [tuple(int(v) for v in line.split(",")) for line in GOLDEN.read_text().split()]
    group = first_group(golden)
    group2 = first_group(golden[golden.index(tuple(group[-1])) + 1:])
    log(f"  real groups from the golden training: {group} then {group2}")
    max_err = phase_kernel(torch, group, group2)
    timing = phase_timing(torch, group)

    km.merge_pass_multi.launches = 0
    phase_golden(torch)
    phase_scale(torch, card)
    launches = km.merge_pass_multi.launches
    require(launches > 0, "the merge kernel never launched on the main path")
    log(f"[count] ok: merge kernel launched {launches} times on the main path")
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")

    ms, plain = timing["K=4"]
    kernels = [{
        "name": "merge_pass_multi", "route": "cuda",
        "source": "zigbpe_tpu_torch/csrc/merge.cu",
        "replaces": "zigbpe_tpu/ops/pallas/merge.py:222",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
