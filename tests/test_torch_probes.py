"""The measurement probes of the port (``zigbpe_tpu_torch.probes``) and the
twins of their kernels, on the CPU.

(a) The ablated merge pass (``merge_pass_ablated_reference``) against the
    Pallas budget kernel of ``scripts/probe_merge_budget.py``
    (``make_variant``, imported by path, run in TPU interpret mode) at one
    shape, R = 8, G = 2, NP = 2, on seeded row-local streams and one real
    stream of the corpus. Only what both define is compared: the Pallas
    probe writes "garbage for ablated variants" (probe_merge_budget.py:9-10)
    into its output array, and its stats are (hits summed over the passes,
    the last pass's length, the last pass's min_kept), so ``full``'s hits
    and length must be equal and the min_kept <= 1 decision agree (the
    Pallas kernel folds min_kept only over the blocks it processes);
    ``copy`` leaves the last stream in the Pallas output and the tokens
    unchanged in the port; ``nostore`` has ``full``'s stats in both;
    ``nominkept`` has min_kept = BIG in both; ``noparity`` equals ``full``
    in both when no slot has a == b.
(b) Every variant's twin equals a numpy statement of its definition (the
    ``merge.py`` docstring), written on the logical stream with a loop.
(c) The copy twins equal numpy statements of the Pallas copy bodies
    (probe_floor.py:33-34, probe_pipeline.py:48-61, 81-95) and of the
    look-ahead index map (probe_pipeline.py:103-107).
(d) The three probes run on the CPU at small sizes and print one row
    per variant, block size and dtype.
All values are integers, so every comparison is exact.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from zigbpe_tpu_torch.ops.kernels import copy as kcopy
from zigbpe_tpu_torch.ops.kernels import merge as kmerge
from zigbpe_tpu_torch.probes import __main__ as probes_main
from zigbpe_tpu_torch.probes import budget, floor, pipeline

REPO = Path(__file__).resolve().parents[1]
BIG = 2**31 - 1
PAD = -1
R, G, NP = 8, 2, 2          # the one Pallas shape compared
ROWS = R * G                # rows of 128 tokens per stream

# the Pallas probe's switches for the variants compared
# (scripts/probe_merge_budget.py:345-359)
JAX_VARIANTS = {
    "full": {},
    "noparity": dict(parity=False),
    "nominkept": dict(minkept=False),
    "nostore": dict(store=False),
    "copy": dict(candidates=False, parity=False, minkept=False, kills=False,
                 destscan=False, bitmove=False, edgekills=False, fastpath=False),
}


def _row_local(rng, alphabet, pops) -> np.ndarray:
    arr = np.full((ROWS, 128), PAD, np.int32)
    for r, n in enumerate(pops):
        arr[r, :n] = rng.choice(alphabet, n)
    return arr.reshape(-1)


def _first_stream(name: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if name == "corpus":
        data = budget.tiled_corpus(ROWS * 128 - 95)
        arr = np.full(ROWS * 128, PAD, np.int32)
        arr[: len(data)] = np.frombuffer(data, np.uint8)
        return arr
    if name == "a_run":  # runs of a that cross rows and tiles
        pops = [128] * 5 + [3, 128, 2] + [128] * 6 + [77, 0]
        return _row_local(rng, [97, 97, 97, 98], pops)
    pops = rng.integers(2, 129, ROWS)
    return _row_local(rng, [97, 98, 99, 256], pops)


TABLES = {
    "random_ab": [(97, 98, 256), (256, 99, 257)],
    "random_aa": [(97, 97, 256), (256, 256, 257)],
    "corpus": [(101, 32, 256), (44, 32, 257)],  # the golden table's first two
    "a_run": [(97, 97, 256), (256, 256, 257)],
}


@functools.cache
def _streams(name: str) -> tuple[np.ndarray, np.ndarray]:
    """(table [NP, 3], streams [NP, ROWS*128]): NP inputs, each the previous
    one after its merge (the production twin), as the probe makes them."""
    table = np.asarray(TABLES[name], np.int32)
    s = [_first_stream(name)]
    for p in range(NP - 1):
        t = torch.from_numpy(s[-1].copy())
        kmerge.merge_pass_multi(t, torch.from_numpy(table[p: p + 1]))
        s.append(t.numpy())
    return table, np.stack(s)


@functools.cache
def _budget_module():
    spec = importlib.util.spec_from_file_location(
        "probe_merge_budget", REPO / "scripts" / "probe_merge_budget.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def _jax_call(variant: str):
    make = _budget_module().make_variant
    return jax.jit(make(variant, R, G, NP, ROWS, **JAX_VARIANTS[variant]))


@functools.cache
def _jax(variant: str, name: str):
    """The Pallas budget kernel's (output, stats) on the named streams."""
    table, streams = _streams(name)
    with pltpu.force_tpu_interpret_mode():
        out, stats = _jax_call(variant)(
            jnp.asarray(table.reshape(-1)), jnp.asarray(streams.reshape(-1, 128)),
            jnp.zeros((ROWS, 128), jnp.int32))
        return np.asarray(out).reshape(-1), np.asarray(stats)


@functools.cache
def _port(variant: str, name: str):
    """The twin's per-pass (outputs [NP, N], stats [NP, 3])."""
    table, streams = _streams(name)
    outs, stats = [], []
    for p in range(NP):
        t, st = kmerge.merge_pass_ablated(torch.from_numpy(streams[p].copy()),
                                          torch.from_numpy(table[p: p + 1]), variant)
        outs.append(t.numpy())
        stats.append(st.numpy())
    return np.stack(outs), np.stack(stats)


JAX_CASES = [(v, n) for v in JAX_VARIANTS for n in ("random_ab", "random_aa", "corpus")
             if not (v == "noparity" and n == "random_aa")]


@pytest.mark.parametrize("variant,name", JAX_CASES)
def test_ablated_twin_agrees_with_pallas_budget_kernel(variant, name):
    table, streams = _streams(name)
    jout, jstats = _jax(variant, name)
    tout, tstats = _port(variant, name)
    if variant == "full":
        assert int(jstats[0]) == int(tstats[:, 0].sum())
        assert int(jstats[1]) == int(tstats[-1, 1])
        assert (jstats[2] <= 1) == (tstats[-1, 2] <= 1)
    elif variant == "copy":
        np.testing.assert_array_equal(jout, streams[-1])
        np.testing.assert_array_equal(tout, streams)
        assert not tstats.any()
    elif variant == "nostore":
        np.testing.assert_array_equal(jstats, _jax("full", name)[1])
        np.testing.assert_array_equal(tstats, _port("full", name)[1])
        np.testing.assert_array_equal(tout, streams)
    elif variant == "nominkept":
        assert int(jstats[2]) == BIG and (tstats[:, 2] == BIG).all()
        np.testing.assert_array_equal(tstats[:, :2], _port("full", name)[1][:, :2])
    else:  # noparity, on tables with no a == b
        assert all(a != b for a, b, _ in table)
        np.testing.assert_array_equal(jstats, _jax("full", name)[1])
        np.testing.assert_array_equal(tout, _port("full", name)[0])
        np.testing.assert_array_equal(tstats, _port("full", name)[1])


def _np_pass(arr: np.ndarray, merge, variant: str):
    """One pass of ``variant`` as its definition states it: leftmost-greedy
    hits on the logical stream (every candidate hits under noparity), each
    hit's partner killed (within its row only under noedgek, never under
    nokills), rows compacted (hits written in place under nocompact)."""
    a, b, x = (int(v) for v in merge)
    m = kmerge.VARIANTS[variant]
    rows = arr.reshape(-1, 128)
    if m & kmerge.ABL_COPY:
        return arr.copy(), [0, 0, 0]
    r_idx, c_idx = np.nonzero(rows >= 0)  # row-major order is the logical order
    toks = rows[r_idx, c_idx]
    n = len(toks)
    hit = np.zeros(n, bool)
    greedy = a == b and not m & kmerge.ABL_NOPARITY
    i = 0
    while i < n - 1:
        if toks[i] == a and toks[i + 1] == b:
            hit[i] = True
            i += 2 if greedy else 1
        else:
            i += 1
    killed = np.zeros(n, bool)
    if not m & kmerge.ABL_NOKILLS:
        for i in np.nonzero(hit)[0]:
            if not m & kmerge.ABL_NOEDGEK or r_idx[i + 1] == r_idx[i]:
                killed[i + 1] = True
    vals = np.where(hit, x, toks)
    keep = ~killed
    out = rows.copy()
    if not m & kmerge.ABL_NOSTORE:
        if m & kmerge.ABL_NOCOMPACT:
            out[r_idx, c_idx] = vals
        else:
            out[:] = PAD
            for r in range(rows.shape[0]):
                kept = vals[(r_idx == r) & keep]
                out[r, : len(kept)] = kept
    rowkept = np.bincount(r_idx[keep], minlength=rows.shape[0])
    nonempty = np.nonzero((rows >= 0).sum(1))[0]
    interior = rowkept[nonempty[:-1]]
    min_kept = BIG if m & kmerge.ABL_NOMINKEPT or not interior.size else int(interior.min())
    return out.reshape(-1), [int(hit.sum()), int(keep.sum()), min_kept]


@pytest.mark.parametrize("name", sorted(TABLES))
@pytest.mark.parametrize("variant", list(kmerge.VARIANTS))
def test_ablated_twin_matches_its_definition(variant, name):
    table, streams = _streams(name)
    tout, tstats = _port(variant, name)
    for p in range(NP):
        want, want_stats = _np_pass(streams[p], table[p], variant)
        np.testing.assert_array_equal(tout[p], want)
        assert tstats[p].tolist() == want_stats


def test_ablated_variants_differ_where_defined():
    """The a-run streams cross rows, so the pieces switched off change the
    result: the definitions are not vacuous on the inputs above."""
    full_out, full = _port("full", "a_run")
    assert full[0, 0] > 0
    for variant in ("noparity", "noedgek", "nocompact", "nokills"):
        out, stats = _port(variant, "a_run")
        assert not np.array_equal(out, full_out) or not np.array_equal(stats, full), variant


def _copy_input(kind: str, dtype) -> np.ndarray:
    if kind == "zeros":
        return np.zeros((128, 128), dtype)
    rng = np.random.default_rng(3)
    x = rng.integers(-5, 100, (128, 128)).astype(dtype)
    if dtype == np.int32:  # look-ahead tokens large enough for the sum to wrap
        x[::8, 0] = rng.integers(2**30, 2**31 - 1, 16)
    return x


def _np_blocks(x: np.ndarray, Rb: int):
    """The Pallas grid: block i holds rows [i R, (i + 1) R); its look-ahead
    input is the 8-row block min((i + 1) R // 8, rows // 8 - 1)."""
    rows = x.shape[0]
    for i in range(rows // Rb):
        yield x[i * Rb:(i + 1) * Rb], x[min((i + 1) * (Rb // 8), rows // 8 - 1) * 8:][:8]


def _wrap(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


@pytest.mark.parametrize("kind", ["seeded", "zeros"])
@pytest.mark.parametrize("Rb", [8, 16, 64])
@pytest.mark.parametrize("dtype", [np.int32, np.int16])
@pytest.mark.parametrize("kernel", ["copy_blocks", "copy_carry", "copy_peek"])
def test_copy_twins_match_the_pallas_bodies(kernel, dtype, Rb, kind):
    x = _copy_input(kind, dtype)
    out = getattr(kcopy, kernel)(torch.from_numpy(x), Rb)
    if kernel == "copy_blocks":
        got = out
    else:
        got, acc = out
        assert acc.dtype == torch.int32 and acc.shape == (1,)
        carry = 0
        for t, n_ref in _np_blocks(x, Rb):
            carry += int((t >= 0).sum())  # probe_pipeline.py:57
            if kernel == "copy_peek":
                carry += int(n_ref[0, 0])  # probe_pipeline.py:90
        assert int(acc[0]) == _wrap(carry)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), x)  # o_ref[:] = i_ref[:]


def test_budget_probe_runs_on_the_cpu(capsys):
    res = budget.run("cpu", nbytes=1 << 14, np_passes=2, runs=3)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device cpu")
    for name in kmerge.VARIANTS:
        assert sum(line.startswith(f"{name:10s}: ") and "ms/pass" in line for line in lines) == 1
    rows = res["rows"]
    assert list(rows) == list(kmerge.VARIANTS) and res["launches"] == {}
    assert rows["full"]["hits"] > 0 and rows["copy"]["hits"] == 0
    for name in ("nofast", "noparity", "nostore"):  # a != b merges: full's stats
        assert (rows[name]["hits"], rows[name]["length"]) == (rows["full"]["hits"],
                                                              rows["full"]["length"])
    assert rows["nominkept"]["min_kept"] == BIG


def test_floor_probe_runs_on_the_cpu(capsys):
    res = floor.run("cpu", n_tokens=1 << 14, block_rows=(8, 32, 128), passes=4, runs=3)
    out = capsys.readouterr().out
    assert [(r["dtype"], r["R"]) for r in res] == [
        (d, b) for d in ("int32", "int16") for b in (8, 32, 128)]
    for r in res:
        assert f"copy {r['dtype']:6s} R={r['R']:5d}" in out
        assert "gb_s" not in r  # no device metric from a CPU run
    assert "GB/s" not in out


@pytest.mark.parametrize("loop", [False, True])
def test_pipeline_probe_runs_on_the_cpu(capsys, loop):
    res = pipeline.run("cpu", n_tokens=1 << 14, block_rows=8, loop=loop, passes=4, runs=3)
    want = ["copy x4", "merge x4"] if loop else ["copy", "copy+carry", "copy+peek", "merge"]
    assert [r["case"] for r in res] == want
    out = capsys.readouterr().out
    assert all(f"{name:12s}: " in out for name in want)


def test_probe_cli_budget_on_the_cpu(capsys):
    assert probes_main.main(["--device", "cpu", "--runs", "1", "budget", "--mb", "1",
                             "--np", "2"]) == 0
    out = capsys.readouterr().out
    assert "budget: 1048576 bytes" in out and out.count("ms/pass") == len(kmerge.VARIANTS)
