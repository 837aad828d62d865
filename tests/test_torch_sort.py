"""The port's device top-k and sort held against the JAX package on the same
numpy-seeded inputs.

- ``_encode_sort_words`` equals the JAX function word for word (int64,
  int32, bool, f32 with -0.0, f64 in three words, ascending and
  descending) and declines where it declines (NaN, inf, strings, nulls).
- The top-k body (hyperspace_tpu_torch/plan/gpu_exec.py
  ``_build_topk_kernel``) and the sort body (``_build_sort_kernel``)
  against the JAX package's on the CPU: the permutations are exact, over
  heavy ties, -0.0, negative keys and pads.
- The executor's ORDER BY chain (device top-k, host top-k, device sort,
  host sort) takes the reference's route for each shape, and its result
  equals the reference's row for row.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.columnar.table import Column as JColumn, ColumnBatch as JBatch
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.plan import executor as jex
from hyperspace_tpu.plan import tpu_exec as jtx
from hyperspace_tpu.plan.nodes import InMemoryScan as JScan, Limit as JLimit, Sort as JSort
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.columnar.table import Column as TColumn, ColumnBatch as TBatch
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan import executor as tex
from hyperspace_tpu_torch.plan import gpu_exec as tgx
from hyperspace_tpu_torch.plan.nodes import InMemoryScan as TScan, Limit as TLimit, Sort as TSort


def _key_arrays(n: int = 5000, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    f32 = rng.normal(0, 3, n).astype(np.float32)
    f32[::7] = 0.0
    f32[3::11] = -0.0
    f64 = rng.uniform(-1e5, 1e5, n)
    f64[::5] = np.round(f64[::5], 1)
    return {
        "i64": rng.integers(-(2**40), 2**40, n),
        "i64_ties": rng.integers(-3, 3, n).astype(np.int64),
        "i32": rng.integers(-50, 50, n).astype(np.int32),
        "i16": rng.integers(-9, 9, n).astype(np.int16),
        "bool": rng.integers(0, 2, n).astype(bool),
        "f32": f32,
        "f64": f64,
    }


@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("name", sorted(_key_arrays()))
def test_encode_sort_words_matches_jax(name, asc):
    a = _key_arrays()[name]
    want = jtx._encode_sort_words(JColumn(a, str(a.dtype)), asc)
    got = tgx._encode_sort_words(TColumn(a, str(a.dtype)), asc)
    assert len(got) == len(want) == {"i64": 2, "i64_ties": 2, "f64": 3}.get(name, 1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint32
        np.testing.assert_array_equal(g, w)


def test_encode_sort_words_declines_where_jax_declines():
    cases = [
        (np.array([1.0, np.nan], np.float32), None),
        (np.array([1.0, np.inf]), None),
        (np.array([1.0, 1e300]), None),
        (np.array([1.0, 1 + 2.0**-52, np.pi]), None),  # exact in three words
        (np.array([1, 2], np.int64), np.array([True, False])),
    ]
    for a, validity in cases:
        jc, tc = JColumn(a, str(a.dtype), validity), TColumn(a, str(a.dtype), validity)
        want = jtx._encode_sort_words(jc, True)
        got = tgx._encode_sort_words(tc, True)
        assert (got is None) == (want is None), a
    s = TColumn.from_values(["b", "a"])
    assert tgx._encode_sort_words(s, True) is None


# ---------------------------------------------------------------------------
# the bodies
# ---------------------------------------------------------------------------

def _topk_cases():
    rng = np.random.default_rng(1)
    n = 6000
    f32 = rng.normal(0, 2, n).astype(np.float32)
    f32[::5] = -0.0
    f32[1::5] = 0.0
    f32[2::13] = -3.5
    return {
        "i32_heavy_ties": rng.integers(0, 4, n).astype(np.int32),
        "i32_negative": rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32),
        "i32_extremes": np.array([2**31 - 1, -(2**31), 0, -1] * 1500, np.int32),
        "f32_signed_zeros": f32,
    }


@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("k", [1, 10, 100, 4096])
@pytest.mark.parametrize("case", sorted(_topk_cases()))
def test_topk_body_matches_jax(case, k, asc):
    x = _topk_cases()[case]
    n = len(x)
    padded = 8192  # pads encode to the minimum and must never win
    arr = np.zeros(padded, dtype=x.dtype)
    arr[:n] = x
    want = np.asarray(jtx._build_topk_kernel(k, asc, padded)(jnp.asarray(arr), jnp.int32(n)))
    got = tgx._build_topk_kernel(k, asc)(torch.from_numpy(arr), n).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got < n).all()


@pytest.mark.parametrize("names", [("i32",), ("f32",), ("i64_ties", "f64"),
                                   ("bool", "i16", "f64", "i64")])
@pytest.mark.parametrize("asc", [True, False])
def test_sort_body_matches_jax(names, asc):
    arrays = _key_arrays(3000, seed=2)
    words = []
    for i, name in enumerate(names):
        a = arrays[name]
        words += tgx._encode_sort_words(TColumn(a, str(a.dtype)), asc ^ (i % 2 == 1))
    n, padded = 3000, 4096
    ops = []
    for w in words:
        arr = np.full(padded, 0xFFFFFFFF, dtype=np.uint32)
        arr[:n] = w
        ops.append(arr)
    want = np.asarray(jtx._build_sort_kernel(len(words), padded)(
        *[jnp.asarray(o) for o in ops], jnp.arange(padded, dtype=np.int32)))
    got = tgx._build_sort_kernel(len(words))(
        *[torch.from_numpy(o.view(np.int32)) for o in ops]).numpy()
    np.testing.assert_array_equal(got, want)
    # and it is the host's stable lexsort
    host = np.lexsort([np.asarray(o) for o in reversed(ops)])
    np.testing.assert_array_equal(got, host)


# ---------------------------------------------------------------------------
# the executor chain
# ---------------------------------------------------------------------------

def _order_batch(n: int, seed: int = 4):
    rng = np.random.default_rng(seed)
    return {
        "row": np.arange(n, dtype=np.int64),
        "day": rng.integers(8035, 10590, n).astype(np.int32),
        "price64": np.round(rng.uniform(900, 105_000, n), 2),
        "price32": rng.uniform(900, 105_000, n).astype(np.float32),
        "okey": rng.integers(0, n // 4 + 1, n),
    }


# (name, orders, limit or None, rows, the port's expected route)
CHAIN_CASES = [
    ("topk_int_ties", [("day", True)], 10, 20000, "device_topk"),
    ("topk_f32_desc", [("price32", False)], 100, 20000, "device_topk"),
    ("topk_f64", [("price64", False)], 10, 20000, "host_topk"),
    ("topk_two_keys", [("price64", False), ("okey", True)], 20, 20000, "host_topk"),
    ("topk_small", [("day", True)], 10, 3000, "host_topk"),
    ("topk_small_heavy_ties", [("okey", True)], 10, 3000, "host_sort"),
    ("topk_heavy_ties_two_keys", [("okey", True), ("day", False)], 10, 40000,
     "device_sort"),
    ("topk_k_ge_n", [("day", False)], 5000, 4500, "device_sort"),
    ("sort_two_keys", [("day", True), ("okey", False)], None, 20000, "device_sort"),
    ("sort_f64", [("price64", True)], None, 8000, "device_sort"),
    ("sort_small", [("okey", True)], None, 1000, "host_sort"),
]


def _plan(M, Scan, Sort, Limit, Col, Batch, cols, orders, limit):
    batch = Batch({n: Col(a, str(a.dtype)) for n, a in cols.items()})
    plan = Sort([(M.col(c), asc) for c, asc in orders], Scan(batch))
    return plan if limit is None else Limit(limit, plan)


@pytest.mark.parametrize("name,orders,limit,n,route", CHAIN_CASES,
                         ids=[c[0] for c in CHAIN_CASES])
def test_order_chain_takes_the_reference_route(name, orders, limit, n, route, tmp_path,
                                               monkeypatch):
    cols = _order_batch(n)
    js = J.HyperspaceSession(str(tmp_path / "j"), conf={JC.EXEC_TPU_ENABLED: True})
    ts = T.HyperspaceSession(str(tmp_path / "t"), device="cpu")
    jroutes = []

    def spy(label, orig):
        def f(*a, **kw):
            out = orig(*a, **kw)
            if out is not None:
                jroutes.append(label)
            return out
        return f

    monkeypatch.setattr(jtx, "try_device_topk", spy("device_topk", jtx.try_device_topk))
    monkeypatch.setattr(jtx, "try_device_sort", spy("device_sort", jtx.try_device_sort))
    monkeypatch.setattr(jex, "_try_topk_batch", spy("host_topk", jex._try_topk_batch))
    jout = jex.execute_plan(
        _plan(JX, JScan, JSort, JLimit, JColumn, JBatch, cols, orders, limit), js)
    jroutes, troutes = [], jroutes
    monkeypatch.setattr(tex, "_try_topk_batch", spy("host_topk", tex._try_topk_batch))
    tout = tex.execute_plan(
        _plan(TX, TScan, TSort, TLimit, TColumn, TBatch, cols, orders, limit), ts)
    troutes, jroutes = jroutes, troutes
    stats = ts.device_stats
    troutes += ["device_topk"] * stats.device_topk + ["device_sort"] * stats.device_sort
    assert (troutes or ["host_sort"]) == (jroutes or ["host_sort"]) == [route]
    got, want = tout.to_pydict(), jout.to_pydict()
    assert len(got["row"]) == (n if limit is None else min(limit, n))
    for c in cols:  # the same rows in the same order
        np.testing.assert_array_equal(np.asarray(got[c]), np.asarray(want[c]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_topk_cases()))
def test_cuda_order_bodies_match_the_cpu(cuda_device, case):
    """The top-k and sort bodies on CUDA tensors give the CPU's
    permutations (torch.topk and the stable sorts differ by device)."""
    x = torch.from_numpy(_topk_cases()[case])
    for k in (1, 100, 4096):
        for asc in (True, False):
            body = tgx._build_topk_kernel(k, asc)
            assert torch.equal(body(x.to(cuda_device), len(x)).cpu(), body(x, len(x)))
    arrays = _key_arrays(6000, seed=3)
    words = []
    for name in ("i64_ties", "f64", "i32"):
        a = arrays[name]
        words += tgx._encode_sort_words(TColumn(a, str(a.dtype)), True)
    ops = [torch.from_numpy(w.view(np.int32)) for w in words]
    body = tgx._build_sort_kernel(len(words))
    assert torch.equal(body(*[o.to(cuda_device) for o in ops]).cpu(), body(*ops))
