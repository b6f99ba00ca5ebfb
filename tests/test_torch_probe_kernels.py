"""The twins of the last three probe kernels (``ops.kernels.opmix``,
``ops.kernels.hist``, ``ops.kernels.lowering``) against the Pallas kernels
they replace, on the CPU, and the three probes that run them.

The scripts define their Pallas kernels inside ``main()``, so no test can
import them. This file restates each Pallas body verbatim, as source text
(``ALU16_SRC``: scripts/probe_alu16.py:41-58 and its call :65-74;
``HIST_SRC``: scripts/probe_hist.py:41-83 and its call :87-101;
``MOSAIC_*``: scripts/probe_mosaic_ops.py:21, :34-63, :29-30, :67-74,
:87-95), executes it in TPU interpret mode, and holds the twin equal to
it. ``test_restated_bodies_match_the_scripts`` fails as soon as a restated
line no longer appears in its script. Every result is an integer or a sum
of bf16 products exact in f32, so comparisons are exact, except ``dot_tn``
on seeded normal values: f32 sums over K <= 4096 taken in another order,
at rtol 1e-4, atol 1e-3.
"""

import functools
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from zigbpe_tpu_torch.ops.kernels import hist as khist
from zigbpe_tpu_torch.ops.kernels import lowering as klow
from zigbpe_tpu_torch.ops.kernels import opmix as kopmix
from zigbpe_tpu_torch.probes import __main__ as probes_main
from zigbpe_tpu_torch.probes import alu16, hist, lowering

REPO = Path(__file__).resolve().parents[1]
LANES = 128

ALU16_SRC = '''
def shift_left1(x, fill):
    # flat shift by 1: lane concat + row fixup (the kernel's hot pattern)
    R_, C = x.shape
    a = jnp.concatenate([x[:, 1:], jnp.full((R_, 1), fill, x.dtype)], axis=1)
    b = jnp.concatenate([x[1:, :1], jnp.full((1, 1), fill, x.dtype)], axis=0)
    col = jax.lax.broadcasted_iota(jnp.int32, (R_, C), 1)
    return jnp.where(col == C - 1, jnp.broadcast_to(b, (R_, C)), a)

def opmix_kernel(i_ref, o_ref, *, dt, reps):
    tok = i_ref[:]
    fill = jnp.asarray(-1, dt)
    acc = tok
    for _ in range(reps):
        nxt = shift_left1(acc, fill)
        cand = (acc == jnp.asarray(101, dt)) & (nxt == jnp.asarray(32, dt))
        acc = jnp.where(cand, jnp.asarray(300, dt), acc)
        acc = jnp.where(nxt < 0, acc, jnp.maximum(acc, nxt))
    o_ref[:] = acc

def one(x):
    return pl.pallas_call(
        functools.partial(opmix_kernel, dt=dt, reps=reps),
        grid=(G,),
        in_specs=[pl.BlockSpec((R, LANES), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((R, LANES), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((rows, LANES), dt),
    )(x)
'''

HIST_SRC = '''
def kern(tok_ref, out_ref, hist_ref, acc):
    i = pl.program_id(0)

    @pl.when(i == 0)
    def _():
        acc[:] = jnp.zeros_like(acc)

    tok = tok_ref[:]
    out_ref[:] = tok
    if density_mod:
        m = ((tok % density_mod) == 0).astype(jnp.float32)
    else:
        m = jnp.zeros((R, LANES), jnp.float32)
    hi_iota = jax.lax.broadcasted_iota(jnp.int32, (S * LANES, 2 * Vh), 1) % Vh
    lo_iota = jax.lax.broadcasted_iota(jnp.int32, (S * LANES, LANES), 1)
    half = jax.lax.broadcasted_iota(jnp.int32, (S * LANES, 2 * Vh), 1) >= Vh
    for s in range(R // S):
        t = tok[s * S : (s + 1) * S, :].reshape(S * LANES, 1)
        ms = m[s * S : (s + 1) * S, :].reshape(S * LANES, 1)

        def do():
            hi = (t >> 7) == hi_iota
            # two masks stacked in one operand: [mL block | mR block]
            mm = jnp.where(half, ms, 1.0 - ms)
            a = jnp.where(hi, mm, 0.0).astype(ot)
            lo = ((t & 127) == lo_iota).astype(ot)
            acc[:] += jax.lax.dot_general(
                a, lo, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )

        if skip:
            nh = jnp.sum(ms)

            @pl.when(nh > 0)
            def _(do=do):
                do()
        else:
            do()

    @pl.when(i == pl.num_programs(0) - 1)
    def _():
        hist_ref[:] = acc[:].astype(jnp.int32)

def one(t):
    return pl.pallas_call(
        kern,
        grid=(G,),
        in_specs=[pl.BlockSpec((R, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=(
            pl.BlockSpec((R, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((rows, LANES), jnp.int32),
            jax.ShapeDtypeStruct((2 * Vh, 128), jnp.int32),
        ),
        scratch_shapes=[pltpu.VMEM((2 * Vh, 128), jnp.float32)],
    )(t)
'''

MOSAIC_CALL = "r = pl.pallas_call(kern, out_shape=out_shape)(*ins)"

MOSAIC_LAMBDAS = '''
lambda i, o: o.__setitem__(slice(None), i[:].reshape(4096, 1)),
lambda i, o: o.__setitem__(slice(None), i[:].reshape(-1)[:, None]),
lambda i, o: o.__setitem__(slice(None), i[:].T),
lambda i, o: o.__setitem__(
    slice(None),
    (jax.lax.broadcasted_iota(jnp.int32, (32, 128), 1) % 4) + i[:],
),
lambda i, o: o.__setitem__(
    slice(None),
    jax.lax.dot_general(
        i[:], i[:], (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    ),
),
'''

MOSAIC_DEFS = '''
x = jnp.arange(32 * 128, dtype=jnp.int32).reshape(32, 128) % 500
f = jnp.ones((256, 128), jnp.bfloat16)
g = jnp.ones((4096, 8), jnp.bfloat16)
h = jnp.ones((4096, 128), jnp.bfloat16)

def skinny(a_ref, b_ref, o_ref):
    o_ref[:] = jax.lax.dot_general(
        a_ref[:], b_ref[:], (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )

def onehot_dot(t_ref, o_ref):
    t = t_ref[:]  # (4096, 1)
    hi = ((t >> 7) == jax.lax.broadcasted_iota(jnp.int32, (4096, 8), 1)).astype(jnp.bfloat16)
    lo = ((t & 127) == jax.lax.broadcasted_iota(jnp.int32, (4096, 128), 1)).astype(jnp.bfloat16)
    o_ref[:] = jax.lax.dot_general(
        hi, lo, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
    )

t1 = (jnp.arange(4096, dtype=jnp.int32) % 500)[:, None]
'''

RESTATED = {
    "probe_alu16.py": [ALU16_SRC],
    "probe_hist.py": [HIST_SRC],
    "probe_mosaic_ops.py": [MOSAIC_CALL, MOSAIC_LAMBDAS, MOSAIC_DEFS],
}


def _exec(src: str, **params) -> dict:
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, functools=functools, LANES=LANES,
              **params)
    exec(textwrap.dedent(src), ns)
    return ns


@pytest.mark.parametrize("script", sorted(RESTATED))
def test_restated_bodies_match_the_scripts(script):
    have = {line.strip() for line in (REPO / "scripts" / script).read_text().splitlines()}
    for src in RESTATED[script]:
        for line in src.splitlines():
            assert not line.strip() or line.strip() in have, (script, line)


# ------------------------------------------------------------------ opmix

OPMIX_ROWS, OPMIX_R = 32, 8  # 4 blocks of 8 rows


def _opmix_input(dtype) -> np.ndarray:
    """Tokens that make candidates fire and block ends matter: 101 before
    32, -1, 300 and values in [0, 400]."""
    rng = np.random.default_rng(17)
    pool = np.concatenate([[-1, 32, 101, 300] * 40, np.arange(0, 401)])
    x = rng.choice(pool, (OPMIX_ROWS, LANES)).astype(dtype)
    flat = x.reshape(-1)
    flat[rng.choice(flat.size - 1, 300, replace=False)] = 101  # some followed by 32 ...
    heads = np.nonzero(flat[:-1] == 101)[0]
    flat[heads[::2] + 1] = 32
    block = OPMIX_R * LANES  # ... and 101, 32 across each block's end
    flat[block - 1 :: block] = 101
    flat[block :: block] = 32
    return x


@functools.cache
def _opmix_pallas(dtype, reps: int) -> np.ndarray:
    ns = _exec(ALU16_SRC, dt=jnp.dtype(dtype), reps=reps, R=OPMIX_R,
               G=OPMIX_ROWS // OPMIX_R, rows=OPMIX_ROWS)
    with pltpu.force_tpu_interpret_mode():
        return np.array(ns["one"](jnp.asarray(_opmix_input(dtype))))


@pytest.mark.parametrize("reps", [0, 4])
@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_opmix_twin_matches_the_pallas_body(dtype, reps):
    x = _opmix_input(dtype)
    got = kopmix.opmix(torch.from_numpy(x), OPMIX_R, reps)
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), _opmix_pallas(dtype, reps))


def test_opmix_fill_is_per_block():
    """A 101 at a block's last slot before a 32 at the next block's head is
    no candidate: the shift reads -1 there, not the next block."""
    x = np.zeros((2 * OPMIX_R, LANES), np.int32)
    x[OPMIX_R - 1, -1], x[OPMIX_R, 0] = 101, 32
    x[0, 0], x[0, 1] = 101, 32
    out = kopmix.opmix(torch.from_numpy(x), OPMIX_R, 1).numpy()
    assert out[OPMIX_R - 1, -1] == 101 and out[0, 0] == 300
    assert kopmix.opmix(torch.from_numpy(x), 2 * OPMIX_R, 1).numpy()[OPMIX_R - 1, -1] == 300


# ------------------------------------------------------------------ hist

HIST_ROWS, HIST_R, HIST_S = 32, 16, 8  # 2 blocks, 4 subchunks of 8 rows
DMOD = 7


def _hist_input() -> np.ndarray:
    """Subchunk 0 has hits; 1 and 3 none; 2 only the negative hit -7, so it
    is kept and counts in the first half. Negatives and tokens up to 5000
    (above Vh * 128 at V = 512 and 1280) count nowhere."""
    rng = np.random.default_rng(23)
    every = np.concatenate([np.arange(-20, 1400), [5000, 2**31 - 1, -(2**31)]])
    nohit = every[every % DMOD != 0]
    sub = HIST_S * LANES
    x = np.concatenate([rng.choice(every, sub), rng.choice(nohit, sub),
                        rng.choice(nohit, sub), rng.choice(nohit, sub)]).astype(np.int32)
    x[2 * sub + 100] = -DMOD
    return x.reshape(HIST_ROWS, LANES)


HIST_CASES = [(V, mode) for V in (512, 1280) for mode in ("dense", "skip-dense", "skip-nohit")]
MODES = {"dense": (DMOD, False), "skip-dense": (DMOD, True), "skip-nohit": (0, True)}


@functools.cache
def _hist_pallas(V: int, mode: str):
    density_mod, skip = MODES[mode]
    ns = _exec(HIST_SRC, R=HIST_R, S=HIST_S, Vh=-(-V // 128), G=HIST_ROWS // HIST_R,
               rows=HIST_ROWS, density_mod=density_mod, skip=skip, ot=jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        out, h = ns["one"](jnp.asarray(_hist_input()))
    return np.asarray(out), np.asarray(h)


@pytest.mark.parametrize("V,mode", HIST_CASES)
def test_hist_twin_matches_the_pallas_body(V, mode):
    x = _hist_input()
    density_mod, skip = MODES[mode]
    out, h = khist.onehot_hist(torch.from_numpy(x), HIST_R, V, HIST_S, density_mod, skip)
    want_out, want_h = _hist_pallas(V, mode)
    assert out.dtype == torch.int32 and h.dtype == torch.int32
    assert h.shape == (2 * khist.vocab_rows(V), LANES)
    np.testing.assert_array_equal(out.numpy(), want_out)
    np.testing.assert_array_equal(h.numpy(), want_h)


def test_hist_cases_are_not_vacuous():
    """The skip drops the hit-free subchunks (so skip-dense differs from
    dense), subchunk 2 is kept for its negative hit, hits land in the
    second half, and out-of-range tokens count nowhere."""
    x = _hist_input()
    dense = _hist_pallas(512, "dense")[1]
    skipped = _hist_pallas(512, "skip-dense")[1]
    assert not np.array_equal(dense, skipped) and dense[4:].sum() > 0
    sub = x.reshape(4, -1)
    in_range = (sub >= 0) & (sub < 512)
    assert skipped.sum() == in_range[[0, 2]].sum() < dense.sum() == in_range.sum()
    assert not _hist_pallas(512, "skip-nohit")[1].any()


def test_hist_kept_subchunks():
    x = torch.from_numpy(_hist_input())
    assert khist.kept_subchunks(x, HIST_R, HIST_S, DMOD, True).tolist() == [True, False, True,
                                                                            False]
    assert khist.kept_subchunks(x, HIST_R, HIST_S, DMOD, False).all()
    assert not khist.kept_subchunks(x, HIST_R, HIST_S, 0, True).any()


# ------------------------------------------------------------------ lowering

@functools.cache
def _mosaic():
    ns = _exec(MOSAIC_DEFS)
    exec("lambdas = (\n" + MOSAIC_LAMBDAS + ")", ns)
    exec("def call(kern, out_shape, *ins):\n    " + MOSAIC_CALL + "\n    return r", ns)
    return ns


def _mosaic_run(kern, shape, dtype, *ins):
    ns = _mosaic()
    with pltpu.force_tpu_interpret_mode():
        return np.array(ns["call"](kern, jax.ShapeDtypeStruct(shape, dtype),
                                     *(jnp.asarray(i) for i in ins)))


def _seeded_ints(shape) -> np.ndarray:
    return np.random.default_rng(31).integers(-3000, 3000, shape).astype(np.int32)


def _bf16_ints(shape, seed) -> np.ndarray:
    """Integer-valued bf16 inputs (exact products and f32 sums)."""
    v = np.random.default_rng(seed).integers(-4, 5, shape).astype(np.float32)
    return np.asarray(jnp.asarray(v, jnp.bfloat16))


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("data", ["script", "seeded"])
def test_rows_to_column_matches_both_reshapes(which, data):
    x = np.array(_mosaic()["x"]) if data == "script" else _seeded_ints((32, 128))
    want = _mosaic_run(_mosaic()["lambdas"][which], (4096, 1), jnp.int32, x)
    got = klow.rows_to_column(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("data", ["script", "seeded"])
def test_transpose_matches(data):
    x = np.array(_mosaic()["x"]) if data == "script" else _seeded_ints((32, 128))
    want = _mosaic_run(_mosaic()["lambdas"][2], (128, 32), jnp.int32, x)
    np.testing.assert_array_equal(klow.transpose(torch.from_numpy(x)).numpy(), want)


IOTA_CASES = {  # (shape, m, a view 4 bytes off 16) on seeded full-range int32
    "1x1-m1": ((1, 1), 1, False), "7x5-m1": ((7, 5), 1, False), "7x5-m3": ((7, 5), 3, False),
    "64x1000-m7": ((64, 1000), 7, False), "32x128-m1000": ((32, 128), 1000, False),
    "64x1000-m7-view": ((64, 1000), 7, True),
}


@pytest.mark.parametrize("data", ["script", "seeded", *IOTA_CASES])
def test_iota_mod_add_matches(data):
    """The Pallas body at the script's (32, 128) in interpret mode; at the
    other shapes and moduli the same jnp formula (probe_mosaic_ops.py:47-54
    with the shape and m as parameters), on values whose sums wrap."""
    if data in IOTA_CASES:
        (rows, cols), m, view = IOTA_CASES[data]
        flat = np.random.default_rng(rows * cols + m).integers(
            -2**31, 2**31, rows * cols + 1, dtype=np.int32)
        x = flat[1:] if view else flat[:-1]
        want = np.asarray(jax.lax.broadcasted_iota(jnp.int32, (rows, cols), 1) % m
                          + jnp.asarray(x.reshape(rows, cols)))
        xt = torch.from_numpy(flat)[1:] if view else torch.from_numpy(flat)[:-1]
        got = klow.iota_mod_add(xt.view(rows, cols), m)
    else:
        m = 4
        x = np.array(_mosaic()["x"]) if data == "script" else _seeded_ints((32, 128))
        want = _mosaic_run(_mosaic()["lambdas"][3], (32, 128), jnp.int32, x)
        got = klow.iota_mod_add(torch.from_numpy(x), m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("data", ["script", "ints", "normal"])
def test_dot_tn_matches_the_bf16_product(data):
    if data == "script":
        f = np.array(_mosaic()["f"])
    elif data == "ints":
        f = _bf16_ints((256, 128), 41)
    else:
        f = np.asarray(jnp.asarray(np.random.default_rng(43).standard_normal((256, 128)),
                                   jnp.bfloat16))
    want = _mosaic_run(_mosaic()["lambdas"][4], (128, 128), jnp.float32, f)
    got = klow.dot_tn(_to_torch(f), _to_torch(f))
    assert got.dtype == torch.float32 and got.shape == (128, 128)
    if data == "normal":  # f32 sums over K = 256 in another order
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("data", ["script", "ints"])
def test_dot_tn_matches_the_skinny_product(data):
    ns = _mosaic()
    if data == "script":
        g, h = np.array(ns["g"]), np.array(ns["h"])
    else:
        g, h = _bf16_ints((4096, 8), 47), _bf16_ints((4096, 128), 53)
    want = _mosaic_run(ns["skinny"], (8, 128), jnp.float32, g, h)
    got = klow.dot_tn(_to_torch(g), _to_torch(h))
    assert got.shape == (8, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("data", ["script", "seeded"])
def test_onehot_dot_matches(data):
    ns = _mosaic()
    if data == "script":
        t = np.array(ns["t1"])
    else:  # negatives and tokens past the 8 hi rows count nowhere
        t = np.random.default_rng(59).integers(-200, 1300, (4096, 1)).astype(np.int32)
    want = _mosaic_run(ns["onehot_dot"], (8, 128), jnp.float32, t)
    got = klow.onehot_dot(torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == (8, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    if data == "script":
        assert float(got.sum()) == 4096.0
    else:
        assert float(got.sum()) == ((t >= 0) & (t < 1024)).sum() < 4096


def test_dot_tn_shapes():
    a = torch.ones((16, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        klow.dot_tn(a, torch.ones((16, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="share K"):
        klow.dot_tn(torch.ones((24, 16), dtype=torch.bfloat16), a)
    assert klow.dot_tn(a, torch.ones((16, 16), dtype=torch.bfloat16)).shape == (8, 16)


# ------------------------------------------------------------------ probes

def test_alu16_probe_runs_on_the_cpu(capsys):
    res = alu16.run("cpu", n_tokens=1 << 13, block_rows=8, passes=2, runs=2)
    out = capsys.readouterr().out
    assert [(r["dtype"], r["reps"]) for r in res] == [
        (d, r) for r in (0, 4, 16) for d in ("int32", "int16")]
    assert out.count("int16 ALU speedup") == 2 and "GB/s" not in out
    assert all("gb_s" not in r for r in res)


def test_hist_probe_runs_on_the_cpu(capsys):
    res = hist.run("cpu", n_tokens=1 << 13, block_rows=32, vocabs=(512,), passes=2, runs=2)
    out = capsys.readouterr().out
    assert [r["case"] for r in res] == ["copy"] + [f"hist V=  512 {c[0]}" for c in hist.CASES]
    assert "over copy" in out and "bound" not in out


def test_hist_probe_bound():
    """The bound is the function's bytes at every V; the one-hot products are
    the design's cost, counted only on the subchunks that run."""
    x = hist.tokens(1 << 15, torch.device("cpu"))
    ms, by = hist.bound(x, 4352)
    assert by == "bytes" and ms == pytest.approx((2 * 4 * (1 << 15) + 68 * 512) / 3.35e12 * 1e3)
    assert hist.onehot_mma_ms(x, 256, 4352, 32, hist.DENSITY, False) == pytest.approx(
        2 * 128 * 68 * (1 << 15) / 989e12 * 1e3)
    assert hist.onehot_mma_ms(x, 256, 4352, 32, 0, True) == 0


def test_lowering_probe_runs_on_the_cpu(capsys):
    res = lowering.run("cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "OK   onehot+dot from (4096,1) input, sum=4096.0"
    assert len(res) == 7 and all(line.startswith("OK   ") for line in lines[1:])


def test_lowering_seeded_inputs_keep_the_script_shapes():
    """The seeded inputs the card check runs the constructs on have the
    script's shapes and types, and tokens that count nowhere."""
    cpu = torch.device("cpu")
    script, seeded = lowering.inputs(cpu), lowering.inputs(cpu, 17)
    assert {k: (v.shape, v.dtype) for k, v in seeded.items()} == {
        k: (v.shape, v.dtype) for k, v in script.items()}
    assert (seeded["t1"] < 0).any() and (seeded["t1"] >= 8 * LANES).any()
    for name, kernel, args in lowering.constructs(cpu, 17):
        assert torch.equal(kernel(*args), lowering.twin(kernel)(*args)), name


@pytest.mark.parametrize("probe", ["alu16", "hist", "lowering"])
def test_probe_cli_runs_the_new_probes_on_the_cpu(capsys, probe):
    args = ["--device", "cpu", "--runs", "1", probe]
    if probe != "lowering":
        args += ["--tokens", str(1 << 15), "--passes", "1"]
    assert probes_main.main(args) == 0
    out = capsys.readouterr().out
    assert {"alu16": "int16 ALU speedup at reps=16", "hist": "hist V= 4352 S=32 skip-on nohit",
            "lowering": "OK   skinny dot"}[probe] in out
