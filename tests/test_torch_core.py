"""The port's core ops against their JAX originals on the same numpy inputs,
and the port's copies of the host modules against their originals.

Every value is an integer, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from zigbpe_tpu.models import numpy_backend as j_numpy_backend
from zigbpe_tpu.models import oracle as j_oracle
from zigbpe_tpu.ops import core as jcore
from zigbpe_tpu.ops.pallas import merge as pm
from zigbpe_tpu.utils import profiling as j_profiling
from zigbpe_tpu.utils import serde as j_serde
from zigbpe_tpu_torch.models import numpy_backend as t_numpy_backend
from zigbpe_tpu_torch.models import oracle as t_oracle
from zigbpe_tpu_torch.ops import core as tcore
from zigbpe_tpu_torch.utils import profiling as t_profiling
from zigbpe_tpu_torch.utils import serde as t_serde
from zigbpe_tpu_torch.utils.state import TrainState

V = 300


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.int32))


def _n(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _row_local_stream(seed: int) -> np.ndarray:
    """A row-local layout as the merge kernel leaves it: a random byte
    corpus after one merge pass (rows hold prefixes of varying length)."""
    r = np.random.default_rng(seed)
    data = bytes(r.integers(97, 101, 3900, dtype=np.uint8))
    arr, _ = jcore.pad_tokens(data, 4096)
    out, _ = pm.merge_pass_pallas(arr, 97, 98, 256, block_rows=8, interpret=True)
    out = np.asarray(out)
    assert len(set((out.reshape(-1, 128) >= 0).sum(1).tolist())) > 1
    return out


STREAMS = {
    "global": lambda: np.asarray(jcore.pad_tokens(
        bytes(np.random.default_rng(3).integers(97, 103, 1000, dtype=np.uint8)), 1024)[0]),
    "row_local": lambda: _row_local_stream(4),
}


@pytest.mark.parametrize("data,cap", [
    (b"hello world", 16), (b"hello world", 128), (b"", 256),
    (bytes(range(256)) * 3, 1024), (b"x" * 100, 100),
])
def test_pad_tokens(data, cap):
    jt, jn = jcore.pad_tokens(data, cap)
    tt, tn = tcore.pad_tokens(data, cap)
    assert tt.dtype == torch.int32 and tn == int(jn)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_pad_token_ids():
    ids = np.random.default_rng(1).integers(0, 700, 300).astype(np.int32)
    jt, jn = jcore.pad_token_ids(ids, 512)
    tt, tn = tcore.pad_token_ids(ids, 512)
    assert tn == int(jn)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("layout_block", [None, 128])
def test_pair_streams(stream, layout_block):
    arr = STREAMS[stream]()
    ja, jb = jcore.pair_streams(jnp.asarray(arr), layout_block)
    ta, tb = tcore.pair_streams(_t(arr), layout_block)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_compact_stream(stream):
    arr = STREAMS[stream]()
    jt, jn = jcore.compact_stream(jnp.asarray(arr))
    tt, tn = tcore.compact_stream(_t(arr))
    assert tn == int(jn)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("stream,layout_block", [
    ("global", None), ("global", 128), ("row_local", 128),
])
def test_pair_histogram(stream, layout_block):
    arr = STREAMS[stream]()
    jh = jcore.pair_histogram(jnp.asarray(arr), V, layout_block)
    th = tcore.pair_histogram(_t(arr), V, layout_block)
    assert th.dtype == torch.int32
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("seed", range(3))
def test_select_top_pair(seed):
    r = np.random.default_rng(seed)
    hist = r.integers(0, 5, V * V).astype(np.int32)  # many ties at the max
    want = [int(x) for x in jcore.select_top_pair(jnp.asarray(hist), V)]
    got = [int(x) for x in tcore.select_top_pair(_t(hist), V)]
    assert got == want
    zero = [int(x) for x in tcore.select_top_pair(torch.zeros(V * V, dtype=torch.int32), V)]
    assert zero[2] == 0


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_count_pair_and_rowmax(stream):
    arr = STREAMS[stream]()
    for a, b in [(97, 98), (98, 97), (100, 100), (256, 99), (1, 2)]:
        want = int(jcore.count_pair(jnp.asarray(arr), a, b, 128))
        assert int(tcore.count_pair(_t(arr), a, b, 128)) == want
    ub = np.asarray(jcore.pair_histogram(jnp.asarray(arr), V, 128))
    np.testing.assert_array_equal(
        tcore.rowmax_of(_t(ub), V).numpy(), np.asarray(jcore.rowmax_of(jnp.asarray(ub), V))
    )


@pytest.mark.parametrize("ta,tb,nhits", [(97, 98, 7), (97, 97, 3), (5, 9, 0), (120, 4, 10**6)])
def test_update_ub_after_merge(ta, tb, nhits):
    r = np.random.default_rng(ta * 1000 + tb)
    ub = np.zeros((V, V), np.int32)
    ub[:280] = r.integers(0, 50, (280, V))
    ub = ub.reshape(-1)
    rm = np.asarray(jcore.rowmax_of(jnp.asarray(ub), V))
    new_id = 280
    jub, jrm = jcore.update_ub_after_merge(
        jnp.asarray(ub), jnp.asarray(rm), ta, tb, new_id, nhits, V
    )
    tub, trm = _t(ub), _t(rm)
    out_ub, out_rm = tcore.update_ub_after_merge(tub, trm, ta, tb, new_id, nhits, V)
    assert out_ub is tub and out_rm is trm  # in place
    np.testing.assert_array_equal(tub.numpy(), np.asarray(jub))
    np.testing.assert_array_equal(trm.numpy(), np.asarray(jrm))


def _lazy_case(name):
    arr = STREAMS["row_local"]()
    exact = np.asarray(jcore.pair_histogram(jnp.asarray(arr), V, 128))
    stale = exact.copy()
    stale[5 * V + 7] = stale[200 * V + 3] = 10**6
    rm = np.asarray(jcore.rowmax_of(jnp.asarray(stale), V))
    rm_inflated = rm.copy()
    rm_inflated[17] = rm_inflated[97] = 10**6
    cases = {
        "exact": (exact, None, {}),
        "stale": (stale, None, {}),
        "stale_rowmax": (stale, rm, {}),
        "inflated_rowmax": (stale, rm_inflated, {}),
        "hot": (stale, None, {"hot": 256}),
        "wide_verified": (stale, None, {"hot": 97, "col_k": 3, "batch": 16,
                                        "return_verified": True}),
        "protect": (stale, None, {"protect_from": 100, "return_verified": True}),
    }
    return arr, cases[name]


@pytest.mark.parametrize("name", ["exact", "stale", "stale_rowmax", "inflated_rowmax",
                                  "hot", "wide_verified", "protect"])
def test_select_top_pair_lazy(name):
    arr, (ub, rm, kw) = _lazy_case(name)
    jres = jcore.select_top_pair_lazy(
        jnp.asarray(ub), jnp.asarray(arr), V, layout_block=128,
        rowmax=None if rm is None else jnp.asarray(rm), **kw,
    )
    tub = _t(ub)
    tres = tcore.select_top_pair_lazy(
        tub, _t(arr), V, layout_block=128, rowmax=None if rm is None else _t(rm), **kw,
    )
    assert list(tres[:3]) == [int(x) for x in jres[:3]]
    # the returned bound table stays sound and its row cache exact
    hist = _n(tcore.pair_histogram(_t(arr), V, 128))
    assert (tub.numpy() >= hist).all()
    np.testing.assert_array_equal(tres[4].numpy(), tcore.rowmax_of(tub, V).numpy())
    if kw.get("return_verified"):
        pa, pb = tres[5], tres[6]
        assert (tres[0], tres[1]) in set(zip(pa, pb))  # the answer was verified
        u2 = tub.numpy().reshape(V, V)
        h2 = hist.reshape(V, V)
        for a, b in zip(pa, pb):  # verified bins hold exact live counts
            if a < kw.get("protect_from", V) and b < kw.get("protect_from", V):
                assert u2[a, b] == h2[a, b]


def test_train_state_round_trip():
    arr = STREAMS["row_local"]()
    ub = np.asarray(jcore.pair_histogram(jnp.asarray(arr), V, 128))
    merges = np.full((V - 256, 3), -1, np.int32)
    merges[0] = (97, 98, 256)
    occ = np.zeros(V - 256, np.int32)
    occ[0] = 11
    st = TrainState.from_numpy(arr, 3000, ub, merges, occ, 1)
    assert st.tokens.dtype == torch.int32 and st.k == 1 and st.length == 3000
    back = st.numpy()
    for key, want in [("tokens", arr), ("ub", ub), ("merges", merges), ("occupancy", occ)]:
        np.testing.assert_array_equal(back[key], want)


# --------------------------------------------------- copied host modules

_DATA = [b"", b"a", b"aaaa", b"hello world hello", bytes(
    np.random.default_rng(9).integers(97, 104, 2000, dtype=np.uint8))]


@pytest.mark.parametrize("i", range(len(_DATA)))
def test_oracle_copy_matches(i):
    data = _DATA[i]
    want = j_oracle.train(data, 290)
    assert t_oracle.train(data, 290) == want
    assert t_oracle.encode(data, want) == j_oracle.encode(data, want)
    ids = j_oracle.encode(data, want)
    assert t_oracle.decode(ids, want) == j_oracle.decode(ids, want) == data


@pytest.mark.parametrize("i", range(len(_DATA)))
def test_numpy_backend_copy_matches(i):
    data = _DATA[i]
    want = j_numpy_backend.train(data, 290)
    assert t_numpy_backend.train(data, 290) == want
    assert t_numpy_backend.encode(data, want) == j_numpy_backend.encode(data, want)


def test_serde_copy_matches(tmp_path):
    merges = j_oracle.train(_DATA[4], 300)
    text = j_serde.dumps(merges)
    assert t_serde.dumps(merges) == text
    assert t_serde.loads(text) == j_serde.loads(text)
    t_serde.save(merges, tmp_path / "m.txt")
    assert j_serde.load(tmp_path / "m.txt") == merges
    for bad in ["1,2\n", "1,2,x\n", "1,2,70000\n"]:
        with pytest.raises(j_serde.MergesFormatError):
            j_serde.loads(bad)
        with pytest.raises(t_serde.MergesFormatError):
            t_serde.loads(bad)


def test_time_stats_copy_matches():
    stats = {}
    for mod in (j_profiling, t_profiling):
        ts = mod.TimeStats()
        for name in ["count_pairs", "merge_rounds", "merge_rounds"]:
            with ts.phase(name):
                pass
        report = ts.report().splitlines()
        stats[mod] = [(n, a.calls) for n, a in ts.phases.items()], [
            line.split(":")[0] for line in report
        ]
        assert not mod.TimeStats.null().phases
    assert stats[j_profiling] == stats[t_profiling]


def test_profiling_trace_writes_a_trace_file(tmp_path):
    """``trace`` (the counterpart of the JAX package's jax.profiler trace)
    writes a torch.profiler trace of the block into its log directory."""
    import json

    log_dir = tmp_path / "trace"
    with t_profiling.trace(log_dir):
        tcore.select_top_pair_sorted(_t(STREAMS["global"]()), V)
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("sort" in str(e.get("name", "")) for e in events)
