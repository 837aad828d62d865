"""The port's kernel wrappers (hyperspace_tpu_torch/ops/cuda_kernels.py)
held against the JAX package's Pallas kernels on the same inputs.

On the CPU the wrappers run their plain PyTorch versions (ops/reference.py)
and the Pallas kernels run in interpret mode, as tests/test_pallas_and_dist.py
runs them. Counts must be exact; f32 sums agree within relative 1e-4, the
reference's own tolerance (the two sum in different orders). The CUDA
kernels themselves run only on the card: the test marked ``cuda`` holds them
against the plain versions there and skips without one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hyperspace_tpu.ops import pallas_kernels as PK
from hyperspace_tpu_torch.ops import cuda_kernels as K
from hyperspace_tpu_torch.ops import reference as R

REL = 1e-4
SIZES = [0, 1, 1023, 1024, 1025, 5000]


def _inputs(n: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    pred = rng.random(n) < 0.3
    xs = [rng.uniform(1, 1000, n).astype(np.float32) for _ in range(k)]
    gids = rng.integers(0, K.MAX_GROUPS, n).astype(np.int32)
    return pred, xs, gids


def _edge_inputs(n: int, k: int, seed: int):
    """As _inputs, with gids that also fall outside [0, G): negative, in
    [G, 16) and >= 16, on rows where pred holds and where it does not."""
    pred, xs, _ = _inputs(n, k, seed)
    gids = np.random.default_rng(seed + 1).integers(-3, 20, n).astype(np.int32)
    return pred, xs, gids


def _assert_sums_close(got, want):
    got = np.asarray(got, dtype=np.float64).reshape(-1)
    want = np.asarray(want, dtype=np.float64).reshape(-1)
    assert got.shape == want.shape
    for g, w in zip(got, want):
        assert g == w or abs(g - w) <= REL * abs(w), (g, w)


def _plain_call_delta(name, fn):
    before = dict(K.PLAIN_CALLS)
    launches = dict(K.LAUNCHES)
    out = fn()
    assert K.LAUNCHES == launches  # CPU tensors never launch a kernel
    assert K.PLAIN_CALLS[name] == before[name] + 1
    return out


@pytest.mark.parametrize("n", SIZES)
def test_filter_weighted_sum_matches_pallas(n):
    pred, (x, y), _ = _inputs(n, 2, n)
    rev, cnt = PK.filter_weighted_sum(jnp.asarray(pred), jnp.asarray(x), jnp.asarray(y))
    s, c = _plain_call_delta(
        "filter_weighted_sum",
        lambda: K.filter_weighted_sum(
            torch.from_numpy(pred), torch.from_numpy(x), torch.from_numpy(y)
        ),
    )
    assert s.dtype == torch.float32 and c.dtype == torch.int32
    assert s.shape == () and c.shape == ()
    assert int(c) == int(cnt) == int(pred.sum())
    _assert_sums_close(float(s), float(rev))


@pytest.mark.parametrize("n", SIZES)
def test_filter_sum_matches_pallas(n):
    pred, (x,), _ = _inputs(n, 1, n + 7)
    total, cnt = PK.filter_sum(jnp.asarray(pred), jnp.asarray(x))
    s, c = _plain_call_delta(
        "filter_sum", lambda: K.filter_sum(torch.from_numpy(pred), torch.from_numpy(x))
    )
    assert int(c) == int(cnt) == int(pred.sum())
    _assert_sums_close(float(s), float(total))


_GROUPED_CASES = [(n, 4, 1) for n in SIZES] + [
    (5000, groups, k) for groups in (1, 4, 16) for k in (0, 1, 3)
]


@pytest.mark.parametrize("n,groups,k", _GROUPED_CASES)
def test_filter_grouped_multi_sum_matches_pallas(n, groups, k):
    _check_grouped_against_pallas(*_inputs(n, k, 31 * n + 7 * groups + k), groups)


def _check_grouped_against_pallas(pred, xs, gids, groups):
    k = len(xs)
    sums, counts = PK.filter_grouped_multi_sum(
        jnp.asarray(pred), jnp.asarray(gids), [jnp.asarray(x) for x in xs], groups
    )
    p_sums, p_counts = _plain_call_delta(
        "filter_grouped_multi_sum",
        lambda: K.filter_grouped_multi_sum(
            torch.from_numpy(pred), torch.from_numpy(gids),
            [torch.from_numpy(x) for x in xs], groups,
        ),
    )
    assert p_counts.dtype == torch.int32 and p_counts.shape == (groups,)
    np.testing.assert_array_equal(p_counts.numpy(), np.asarray(counts))
    assert len(p_sums) == len(sums) == k
    for got, want in zip(p_sums, sums):
        assert got.dtype == torch.float32 and got.shape == (groups,)
        _assert_sums_close(got.numpy(), np.asarray(want))


# k = 4 fills one launch of the grouped kernel; k = 5 takes two
_GROUPED_EDGE_CASES = [
    (5000, groups, k) for groups in (1, 6, 16) for k in (0, 4, 5)
] + [(1025, 6, 1), (1025, 16, 3)]


@pytest.mark.parametrize("n,groups,k", _GROUPED_EDGE_CASES)
def test_filter_grouped_multi_sum_out_of_range_gids_match_pallas(n, groups, k):
    pred, xs, gids = _edge_inputs(n, k, 53 * n + 7 * groups + k)
    outside = (gids < 0) | (gids >= groups)
    assert (pred & (gids < 0)).any() and (pred & (gids >= 16)).any()
    assert (~pred & outside).any()
    if groups < 16:
        assert (pred & (gids >= groups) & (gids < 16)).any()
    _check_grouped_against_pallas(pred, xs, gids, groups)
    # rows outside [0, G) count nowhere
    _, p_counts = K.filter_grouped_multi_sum(
        torch.from_numpy(pred), torch.from_numpy(gids), [torch.from_numpy(x) for x in xs],
        groups,
    )
    want = np.bincount(gids[pred & ~outside], minlength=groups)
    np.testing.assert_array_equal(p_counts.numpy(), want)


@pytest.mark.parametrize("n,groups", [(0, 4), (1025, 6), (5000, 16)])
def test_filter_grouped_sum_matches_pallas(n, groups):
    pred, (x,), gids = _edge_inputs(n, 1, 11 * n + groups)
    sums, counts = PK.filter_grouped_sum(
        jnp.asarray(pred), jnp.asarray(gids), jnp.asarray(x), groups
    )
    p_sums, p_counts = _plain_call_delta(
        "filter_grouped_multi_sum",
        lambda: K.filter_grouped_sum(
            torch.from_numpy(pred), torch.from_numpy(gids), torch.from_numpy(x), groups
        ),
    )
    assert p_sums.dtype == torch.float32 and p_sums.shape == (groups,)
    assert p_counts.dtype == torch.int32 and p_counts.shape == (groups,)
    np.testing.assert_array_equal(p_counts.numpy(), np.asarray(counts))
    _assert_sums_close(p_sums.numpy(), np.asarray(sums))


def test_grouped_rejects_more_than_sixteen_groups():
    from hyperspace_tpu_torch.exceptions import KernelError

    pred, _, gids = _inputs(10, 0, 1)
    with pytest.raises(KernelError):
        K.filter_grouped_multi_sum(torch.from_numpy(pred), torch.from_numpy(gids), [], 17)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1025, 1_000_003])
def test_cuda_kernels_match_plain(cuda_device, n):
    """Each CUDA kernel against its plain version on the card: aligned
    inputs, then offset views with each column misaligned by a different
    number of rows (which the kernels take through their scalar loops);
    gids outside [0, G); G in {1, 6, 16} and k in {0, 1, 3, 4, 5} (five
    measures run as two passes of the grouped kernel). Two launches give
    the same bits."""
    for po, go, xo in ((0, 0, 0), (1, 2, 3), (3, 1, 2)):
        pred, xs, gids = _edge_inputs(n + 3, 5, n + po)
        pred_d = torch.from_numpy(pred).to(cuda_device)[po:po + n]
        gids_d = torch.from_numpy(gids).to(cuda_device)[go:go + n]
        xs_d = [torch.from_numpy(x).to(cuda_device)[xo:xo + n] for x in xs]
        for name, args in (("filter_weighted_sum", (pred_d, xs_d[0], xs_d[1])),
                           ("filter_sum", (pred_d, xs_d[0]))):
            before = K.LAUNCHES[name]
            s, c = getattr(K, name)(*args)
            s2, c2 = getattr(K, name)(*args)
            ps, pc = getattr(R, name)(*args)
            assert K.LAUNCHES[name] == before + 2
            assert torch.equal(s, s2) and torch.equal(c, c2)
            assert int(c) == int(pc)
            _assert_sums_close(float(s), float(ps))
        for groups in (1, 6, 16):
            for k in (0, 1, 3, 4, 5):
                sums, counts = K.filter_grouped_multi_sum(pred_d, gids_d, xs_d[:k], groups)
                sums2, counts2 = K.filter_grouped_multi_sum(pred_d, gids_d, xs_d[:k], groups)
                p_sums, p_counts = R.filter_grouped_multi_sum(pred_d, gids_d, xs_d[:k], groups)
                assert torch.equal(counts, counts2)
                assert all(torch.equal(a, b) for a, b in zip(sums, sums2))
                assert torch.equal(counts.cpu(), p_counts.cpu())
                assert len(sums) == k
                for got, want in zip(sums, p_sums):
                    _assert_sums_close(got.cpu().numpy(), want.cpu().numpy())
            one, one_counts = K.filter_grouped_sum(pred_d, gids_d, xs_d[0], groups)
            multi, multi_counts = K.filter_grouped_multi_sum(pred_d, gids_d, xs_d[:1], groups)
            assert torch.equal(one, multi[0]) and torch.equal(one_counts, multi_counts)


def _minmax_inputs(n: int, case: str, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1000, 1000, n).astype(np.float32)
    valid = rng.random(n) < 0.5
    if case == "all_invalid":
        valid[:] = False
    elif case == "int":
        x = rng.integers(-(2**20), 2**20, n).astype(np.int32)
    elif case in ("nan_valid", "nan_invalid") and n:
        i = n // 2
        x[i] = np.nan
        valid[i] = case == "nan_valid"
    return x, valid


_MINMAX_CASES = [(n, "random") for n in SIZES] + [
    (n, case) for n in (1, 1025, 5000)
    for case in ("all_invalid", "nan_valid", "nan_invalid", "int")
]


def _same_value(a: float, b: float) -> bool:
    return (np.isnan(a) and np.isnan(b)) or a == b


@pytest.mark.parametrize("n,case", _MINMAX_CASES)
def test_masked_min_max_matches_pallas(n, case):
    x, valid = _minmax_inputs(n, case, 17 * n + len(case))
    mn, mx = PK.masked_min_max(jnp.asarray(x), jnp.asarray(valid))
    p_mn, p_mx = _plain_call_delta(
        "masked_min_max",
        lambda: K.masked_min_max(torch.from_numpy(x), torch.from_numpy(valid)),
    )
    assert p_mn.dtype == p_mx.dtype == torch.float32
    assert p_mn.shape == p_mx.shape == ()
    assert _same_value(float(p_mn), float(mn)) and _same_value(float(p_mx), float(mx))
    if case == "nan_valid":
        assert np.isnan(float(p_mn)) and np.isnan(float(p_mx))
    elif case == "all_invalid" or n == 0 or not valid.any():
        assert float(p_mn) == np.inf and float(p_mx) == -np.inf
    else:
        vals = x[valid].astype(np.float32)
        assert float(p_mn) == vals.min() and float(p_mx) == vals.max()


@pytest.mark.cuda
@pytest.mark.parametrize("n,case", [(0, "random"), (1025, "nan_valid"), (1025, "nan_invalid"),
                                    (1_000_003, "random"), (1_000_003, "int"),
                                    (1025, "all_invalid")])
def test_cuda_masked_min_max_matches_plain(cuda_device, n, case):
    x, valid = _minmax_inputs(n, case, n)
    x_d = torch.from_numpy(x).to(cuda_device)
    v_d = torch.from_numpy(valid).to(cuda_device)
    got = K.masked_min_max(x_d, v_d)
    again = K.masked_min_max(x_d, v_d)
    want = R.masked_min_max(x_d, v_d)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))  # same bits
        assert _same_value(float(a), float(w))
