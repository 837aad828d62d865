"""The device forms of the sketch and z-order arithmetic: the port's
``segment_min_max_torch``, ``bloom_build_bits_torch``,
``bloom_probe_bits_torch`` and ``interleave_bits_torch`` against the numpy
forms the index paths use (bit for bit) and against the JAX package's
``*_jnp`` forms on the same seeded inputs.

JAX runs without x64 here, so its forms see 32-bit data only: they are
compared on float32, int32 and uint32 inputs, the numpy forms on every
dtype. The cases cover empty segments, NaN rows, segments whose rows are
all NaN, no rows at all, row counts and field widths that are not a
multiple of 32, absent probe keys and multi-column keys. The ``cuda``
cases run the same comparisons on the card and skip without one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hyperspace_tpu.ops import sketch as JS
from hyperspace_tpu.ops import zorder as JZ
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.ops import sketch as TS
from hyperspace_tpu_torch.ops import zorder as TZ

CPU = torch.device("cpu")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device forms' card run")
    return torch.device("cuda", 0)


def _segment_case(case: str, dtype, n: int, seed: int):
    """(values, segment_ids, num_segments) of one case."""
    rng = np.random.default_rng(seed)
    segments = 9
    seg = rng.integers(0, segments, n)
    if dtype.kind == "f":
        values = (rng.normal(size=n) * 1000).astype(dtype)
    else:
        info = np.iinfo(dtype)
        values = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    if case == "empty_segments":  # segments 2 and 7 hold no row
        seg[seg == 2] = 3
        seg[seg == 7] = 8
    elif case == "nan" and dtype.kind == "f":
        values[::5] = np.nan
    elif case == "all_invalid" and dtype.kind == "f":  # segment 4's rows are all NaN
        values[seg == 4] = np.nan
        values[rng.integers(0, max(n, 1), n // 10)] = np.nan
    return values, seg, segments


def _assert_same(got: torch.Tensor, want: np.ndarray):
    got = got.cpu().numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got.view(f"u{got.itemsize}"), want.view(f"u{want.itemsize}"))


SEGMENT_CASES = ("random", "empty_segments", "nan", "all_invalid")
SEGMENT_ROWS = (0, 1, 31, 33, 1000, 4097)


@pytest.mark.parametrize("case", SEGMENT_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64, np.int16,
                                   np.uint8])
@pytest.mark.parametrize("n", SEGMENT_ROWS)
def test_segment_min_max_equals_the_numpy_form(case, dtype, n):
    values, seg, segments = _segment_case(case, np.dtype(dtype), n, n + len(case))
    want = TS.segment_min_max_np(values, seg, segments)
    got = TS.segment_min_max_torch(values, seg, segments, CPU)
    for g, w in zip(got, want):
        _assert_same(g, w)
    # the port's numpy form is the JAX package's
    for g, w in zip(want, JS.segment_min_max_np(values, seg, segments)):
        assert np.array_equal(g, w, equal_nan=True)


@pytest.mark.parametrize("case", SEGMENT_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("n", (1, 33, 1000))
def test_segment_min_max_equals_the_jnp_form(case, dtype, n):
    values, seg, segments = _segment_case(case, np.dtype(dtype), n, 7 * n + len(case))
    got = TS.segment_min_max_torch(torch.from_numpy(values), torch.from_numpy(seg), segments,
                                   CPU)
    want = JS.segment_min_max_jnp(jnp.asarray(values), jnp.asarray(seg), segments)
    for g, w in zip(got, want):
        _assert_same(g, np.asarray(w))


def test_segment_min_max_all_nan_rows_keep_the_empty_bounds():
    values = np.full(6, np.nan, np.float32)
    mins, maxs = TS.segment_min_max_torch(values, np.array([0, 0, 1, 1, 1, 0]), 3, CPU)
    assert mins.tolist() == [np.inf] * 3 and maxs.tolist() == [-np.inf] * 3


def test_segment_min_max_refuses_a_dtype_it_cannot_order():
    with pytest.raises(HyperspaceError, match="no device form"):
        TS.segment_min_max_torch(np.arange(4, dtype=np.uint32), np.zeros(4, np.int64), 1, CPU)


def _words(kind: str, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    if kind == "int32":
        return [rng.integers(-(2 ** 31), 2 ** 31, n).astype(np.int32)]
    if kind == "uint32":  # a string column's hash words
        return [rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)]
    if kind == "int64":
        return [rng.integers(-(2 ** 62), 2 ** 62, n)]
    if kind == "float64":
        w = rng.normal(size=n) * 1e6
        w[::7] = np.nan
        return [w]
    if kind == "float32":
        return [rng.normal(size=n).astype(np.float32)]
    if kind == "two_columns":
        return [rng.integers(0, 1000, n), rng.normal(size=n).astype(np.float32)]
    raise ValueError(kind)


BLOOM_KINDS = ("int32", "uint32", "int64", "float64", "float32", "two_columns")
BLOOM_ROWS = (1, 33, 500, 1027)


def _host_filter(words: list, n: int):
    bf = TS.BloomFilter.create(n, 0.01)
    bf.add_words(words)
    return bf


@pytest.mark.parametrize("kind", BLOOM_KINDS)
@pytest.mark.parametrize("n", BLOOM_ROWS)
def test_bloom_build_and_probe_equal_the_host_filter(kind, n):
    words = _words(kind, n, n)
    bf = _host_filter(words, n)
    bits = TS.bloom_build_bits_torch(words, bf.num_bits, bf.num_hashes, CPU)
    assert bits.dtype == torch.uint8 and bits.shape == (bf.num_bits,)
    assert np.array_equal(TS.pack_bits(bits.numpy()), bf.bits)
    assert TS.bloom_probe_bits_torch(bits, words, bf.num_hashes, CPU).all()
    # absent keys: the same false positives as the host filter
    absent = _words(kind, 4 * n + 3, n + 1)
    got = TS.bloom_probe_bits_torch(bits, absent, bf.num_hashes, CPU).numpy()
    assert np.array_equal(got, bf.might_contain_words(absent))


def test_bloom_probe_of_an_empty_filter_finds_nothing():
    m, k = TS.bloom_params(100, 0.01)
    bits = torch.zeros(m, dtype=torch.uint8)
    words = _words("int64", 300, 5)
    assert not TS.bloom_probe_bits_torch(bits, words, k, CPU).any()
    assert not TS.BloomFilter(m, k).might_contain_words(words).any()


@pytest.mark.parametrize("kind", ("int32", "uint32", "float32"))
@pytest.mark.parametrize("n", (1, 33, 500))
def test_bloom_build_and_probe_equal_the_jnp_forms(kind, n):
    words = _words(kind, n, 3 * n)
    m, k = TS.bloom_params(n, 0.01)
    got = TS.bloom_build_bits_torch(words, m, k, CPU)
    want = JS.bloom_build_bits_jnp([jnp.asarray(w) for w in words], m, k)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the built keys and as many others
    probe = [np.concatenate([words[0], _words(kind, n, 1)[0]])]
    hits = TS.bloom_probe_bits_torch(got, probe, k, CPU).numpy()
    want_hits = JS.bloom_probe_bits_jnp(want, [jnp.asarray(probe[0])], k)
    assert np.array_equal(hits, np.asarray(want_hits))
    assert hits[:n].all()


INTERLEAVE_WIDTHS = ((8, 8), (10, 6), (5, 5, 5), (12, 3, 1), (16,), (7, 9, 11), (32,), (1,),
                     (3, 13))


@pytest.mark.parametrize("widths", INTERLEAVE_WIDTHS)
@pytest.mark.parametrize("n", (0, 1, 33, 777))
def test_interleave_bits_equals_the_host_and_jnp_forms(widths, n):
    rng = np.random.default_rng(sum(widths) + n)
    fields = [(rng.integers(0, 1 << w, n, dtype=np.uint64), w) for w in widths]
    want = TZ.interleave_bits(fields)
    assert np.array_equal(want, JZ.interleave_bits(fields))
    got = TZ.interleave_bits_torch(fields, CPU)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy().astype(np.uint64), want)
    if n:
        dev = JZ.interleave_bits_jnp([(jnp.asarray(c.astype(np.uint32)), w) for c, w in fields])
        assert np.array_equal(np.asarray(dev).astype(np.uint64), want)
    # uint32 codes and tensors give the same addresses
    as32 = [(torch.from_numpy(c.astype(np.uint32).view(np.int32)), w) for c, w in fields]
    assert torch.equal(TZ.interleave_bits_torch(as32, CPU), got)


def test_interleave_bits_torch_refuses_what_the_reference_refuses():
    with pytest.raises(HyperspaceError, match="limited to 32 bits, got 33"):
        TZ.interleave_bits_torch([(np.zeros(2, np.uint64), 20), (np.zeros(2, np.uint64), 13)],
                                 CPU)
    with pytest.raises(HyperspaceError, match="No fields"):
        TZ.interleave_bits_torch([], CPU)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (0, 33, 1_000_003))
def test_device_forms_on_the_card_equal_the_numpy_forms(cuda_device, n):
    for dtype in (np.float32, np.float64, np.int32, np.int64):
        for case in SEGMENT_CASES:
            values, seg, segments = _segment_case(case, np.dtype(dtype), n, n)
            got = TS.segment_min_max_torch(values, seg, segments, cuda_device)
            assert got[0].device.type == "cuda"
            for g, w in zip(got, TS.segment_min_max_np(values, seg, segments)):
                _assert_same(g, w)
    for kind in BLOOM_KINDS:
        words = _words(kind, max(n, 1), n)
        bf = _host_filter(words, max(n, 1))
        bits = TS.bloom_build_bits_torch(words, bf.num_bits, bf.num_hashes, cuda_device)
        assert np.array_equal(TS.pack_bits(bits.cpu().numpy()), bf.bits)
        absent = _words(kind, max(n, 1), n + 1)
        got = TS.bloom_probe_bits_torch(bits, absent, bf.num_hashes, cuda_device)
        assert np.array_equal(got.cpu().numpy(), bf.might_contain_words(absent))
    for widths in INTERLEAVE_WIDTHS:
        rng = np.random.default_rng(n)
        fields = [(rng.integers(0, 1 << w, n, dtype=np.uint64), w) for w in widths]
        got = TZ.interleave_bits_torch(fields, cuda_device)
        assert np.array_equal(got.cpu().numpy().astype(np.uint64), TZ.interleave_bits(fields))
