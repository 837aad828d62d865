"""The port's device-tier fragment bodies (hyperspace_tpu_torch/plan/gpu_exec.py,
on the CPU) held against the JAX package's (hyperspace_tpu/plan/tpu_exec.py)
on the same inputs: __graft_entry__.entry()'s Q6 columns, and seeded
grouped inputs.

The JAX side runs with HYPERSPACE_FORCE_PALLAS=1, so kernel-shaped fragments
take its Pallas route (interpret mode on the CPU). Route parity: the kernels
the JAX body traced (spied on) are exactly the kernels the port's wrappers
ran. Counts and integer sums are exact; f32 sums agree within relative 1e-4.
"""

import numpy as np
import pytest
import torch

from hyperspace_tpu.ops import pallas_kernels as PK
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.plan import tpu_exec
from hyperspace_tpu_torch.ops import cuda_kernels as K
from hyperspace_tpu_torch.ops.intsum import combine_int_chunks
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan import gpu_exec
from hyperspace_tpu_torch.state import device_columns

REL = 1e-4
KERNELS = ("filter_weighted_sum", "filter_sum", "filter_grouped_multi_sum")


@pytest.fixture()
def jax_kernel_spy(monkeypatch):
    """Force the JAX Pallas route and record which Pallas kernels its
    fragment bodies trace."""
    monkeypatch.setenv("HYPERSPACE_FORCE_PALLAS", "1")
    called = []
    for name in KERNELS:
        original = getattr(PK, name)

        def spy(*args, _name=name, _orig=original, **kw):
            called.append(_name)
            return _orig(*args, **kw)

        monkeypatch.setattr(PK, name, spy)
    return called


def _port_calls(fn):
    before = dict(K.PLAIN_CALLS)
    out = fn()
    return out, [k for k in KERNELS for _ in range(K.PLAIN_CALLS[k] - before[k])]


def _assert_value_close(got, want):
    if isinstance(want, tuple):  # exact int chunks: recombine both sides
        np.testing.assert_array_equal(
            combine_int_chunks([np.asarray(g) for g in got]),
            combine_int_chunks([np.asarray(w) for w in want]),
        )
        return
    got = np.asarray(got, dtype=np.float64).reshape(-1)
    want = np.asarray(want, dtype=np.float64).reshape(-1)
    assert got.shape == want.shape
    for g, w in zip(got, want):
        assert g == w or abs(g - w) <= REL * abs(w), (g, w)


def _q6_pred(col):
    return (
        (col("l_shipdate") >= 8766)
        & (col("l_shipdate") < 9131)
        & (col("l_discount") >= 0.05)
        & (col("l_discount") <= 0.07)
        & (col("l_quantity") < 24)
    )


@pytest.fixture(scope="module")
def entry_inputs():
    from __graft_entry__ import entry

    _kernel, (cols, mask) = entry()
    return {k: np.asarray(v) for k, v in cols.items()}, np.asarray(mask)


GLOBAL_CASES = {
    "weighted_sum": (
        lambda col, lit: [("sum", col("l_extendedprice") * col("l_discount")), ("count", None)],
        ["filter_weighted_sum"],
    ),
    "plain_sum": (
        lambda col, lit: [("count", None), ("sum", col("l_extendedprice"))],
        ["filter_sum"],
    ),
    # an integer measure needs the exact chunked sum: both fall back to the
    # generic body, and neither runs a kernel
    "integer_sum_fallback": (
        lambda col, lit: [("sum", col("l_shipdate")), ("count", None)],
        [],
    ),
    "generic": (
        lambda col, lit: [
            ("sum", col("l_extendedprice") * (lit(1.0) - col("l_discount"))),
            ("min", col("l_quantity")),
            ("max", col("l_shipdate")),
            ("avg", col("l_discount")),
            ("avg", col("l_shipdate")),
            ("count", None),
        ],
        [],
    ),
}


@pytest.mark.parametrize("case", sorted(GLOBAL_CASES))
def test_fused_kernel_matches_reference(case, entry_inputs, jax_kernel_spy):
    aggs, expected = GLOBAL_CASES[case]
    cols_np, mask_np = entry_inputs
    import jax.numpy as jnp

    j_kernel = tpu_exec._build_kernel(_q6_pred(JX.col), (), aggs(JX.col, JX.lit))
    j_matched, j_out = j_kernel({k: jnp.asarray(v) for k, v in cols_np.items()},
                                jnp.asarray(mask_np))
    cols, mask = device_columns(cols_np, "cpu")
    assert bool(mask.all()) and mask.numpy().tolist() == mask_np.tolist()
    p_kernel = gpu_exec._build_kernel(_q6_pred(TX.col), (), aggs(TX.col, TX.lit))
    (p_matched, p_out), port_calls = _port_calls(lambda: p_kernel(cols, mask))
    assert jax_kernel_spy == port_calls == expected
    assert int(p_matched) == int(j_matched) > 0
    assert len(p_out) == len(j_out)
    for got, want in zip(gpu_exec._fetch(p_out), j_out):
        _assert_value_close(got, want)


def _grouped_inputs(n=16_384, num_groups=6, seed=5):
    rng = np.random.default_rng(seed)
    cols = {
        "l_shipdate": rng.integers(8000, 10600, n).astype(np.int32),
        "l_quantity": rng.integers(1, 51, n).astype(np.float32),
        "l_extendedprice": rng.uniform(900, 105_000, n).astype(np.float32),
        "l_discount": np.round(rng.uniform(0, 0.1, n), 2).astype(np.float32),
    }
    gids = rng.integers(0, num_groups, n).astype(np.int32)
    return cols, gids


GROUPED_CASES = {
    "sums": (
        lambda col, lit: [
            ("sum", col("l_quantity")),
            ("sum", col("l_extendedprice")),
            ("sum", col("l_extendedprice") * (lit(1.0) - col("l_discount"))),
            ("count", None),
        ],
        (),
        ["filter_grouped_multi_sum"],
    ),
    "count_only": (lambda col, lit: [("count", None)], (), ["filter_grouped_multi_sum"]),
    "projected_sum": (
        lambda col, lit: [("count", None), ("sum", col("disc_price"))],
        (("disc_price", lambda col, lit: col("l_extendedprice") * col("l_discount")),),
        ["filter_grouped_multi_sum"],
    ),
    "integer_sum_fallback": (
        lambda col, lit: [("sum", col("l_shipdate")), ("count", None)], (), [],
    ),
    "generic": (
        lambda col, lit: [
            ("avg", col("l_quantity")),
            ("min", col("l_extendedprice")),
            ("max", col("l_shipdate")),
            ("avg", col("l_shipdate")),
            ("count", None),
        ],
        (),
        [],
    ),
}


@pytest.mark.parametrize("case", sorted(GROUPED_CASES))
def test_grouped_kernel_matches_reference(case, jax_kernel_spy):
    import jax.numpy as jnp

    aggs, projs, expected = GROUPED_CASES[case]
    cols_np, gids_np = _grouped_inputs()
    seg_pad = 16
    pred = lambda col: col("l_shipdate") <= 9500  # noqa: E731
    j_kernel = tpu_exec._build_grouped_kernel(
        pred(JX.col), tuple((n, e(JX.col, JX.lit)) for n, e in projs),
        aggs(JX.col, JX.lit), seg_pad,
    )
    mask_np = np.ones(len(gids_np), dtype=bool)
    j_counts, j_first, j_out = j_kernel(
        {k: jnp.asarray(v) for k, v in cols_np.items()}, jnp.asarray(gids_np),
        jnp.asarray(mask_np),
    )
    cols, mask = device_columns(cols_np, "cpu")
    gids = torch.from_numpy(gids_np)
    p_kernel = gpu_exec._build_grouped_kernel(
        pred(TX.col), tuple((n, e(TX.col, TX.lit)) for n, e in projs),
        aggs(TX.col, TX.lit), seg_pad,
    )
    (p_counts, p_first, p_out), port_calls = _port_calls(lambda: p_kernel(cols, gids, mask))
    assert jax_kernel_spy == port_calls == expected
    np.testing.assert_array_equal(p_counts.numpy()[:6], np.asarray(j_counts)[:6])
    np.testing.assert_array_equal(p_first.numpy()[:6], np.asarray(j_first)[:6])
    for got, want in zip(gpu_exec._fetch(p_out), j_out):
        if isinstance(want, tuple):
            _assert_value_close(tuple(g[:6] for g in got), tuple(np.asarray(w)[:6] for w in want))
        else:
            _assert_value_close(got[:6], np.asarray(want)[:6])


def test_generic_grouped_large_domain_is_deterministic():
    """Past 64 group slots the float segment sum sorts by group and reduces
    each segment; it matches the JAX body and repeats bit for bit."""
    import jax.numpy as jnp

    cols_np, gids_np = _grouped_inputs(n=32_768, num_groups=100, seed=8)
    seg_pad = 128
    aggs = lambda col: [("sum", col("l_extendedprice")), ("avg", col("l_quantity")),  # noqa: E731
                        ("count", None)]
    j_counts, _j_first, j_out = tpu_exec._build_grouped_kernel(
        JX.col("l_discount") >= 0.03, (), aggs(JX.col), seg_pad
    )({k: jnp.asarray(v) for k, v in cols_np.items()}, jnp.asarray(gids_np),
      jnp.ones(len(gids_np), dtype=bool))
    cols, mask = device_columns(cols_np, "cpu")
    kernel = gpu_exec._build_grouped_kernel(TX.col("l_discount") >= 0.03, (), aggs(TX.col), seg_pad)
    first = kernel(cols, torch.from_numpy(gids_np), mask)
    again = kernel(cols, torch.from_numpy(gids_np), mask)
    for a, b in zip(first[2], again[2]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(first[0].numpy()[:100], np.asarray(j_counts)[:100])
    for got, want in zip(gpu_exec._fetch(first[2]), j_out):
        _assert_value_close(got[:100], np.asarray(want)[:100])


def test_route_is_part_of_the_kernel_key():
    from hyperspace_tpu_torch.columnar.table import Field, Schema
    from hyperspace_tpu_torch.plan.kernel_cache import fused_fingerprint
    from hyperspace_tpu_torch.plan.nodes import FileScan

    cols, _ = device_columns({"x": np.ones(4, np.float32)}, "cpu")
    assert gpu_exec.kernel_route(torch.device("cpu")) == "plain"
    assert gpu_exec.kernel_route(torch.device("cuda", 0)) == "cuda"
    scan = FileScan(["/lake"], "parquet", Schema([Field("x", "float32")]), [])
    args = (scan, None, (), [("count", None)], cols)
    assert fused_fingerprint("plain", *args) != fused_fingerprint("cuda", *args)
