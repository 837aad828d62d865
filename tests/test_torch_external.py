"""The port's pandas TPC-H answers (benchmark/external.py) against the JAX
package's module and against the port's own queries.

Over one small TPC-H lake (20,000 lineitem rows, seed 42):

- each ``pandas_*`` query of the port equals the JAX module's, frame for
  frame (the same pandas code over the same files);
- each equals the port's ``collect()`` of the same TPC-H query with
  Hyperspace on over ``tpch_indexes`` and the device tier on the CPU:
  keys and counts exact, in the same row order, float columns within
  relative 1e-4 (the device tier sums in f32), through ``answer_columns``,
  which takes the pandas answer's columns by the port's names.
"""

import os

import numpy as np
import pandas as pd
import pytest

from hyperspace_tpu.benchmark import external as jext
from hyperspace_tpu.benchmark import tpch as jtpch
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.benchmark import external as text
from hyperspace_tpu_torch.benchmark import tpch as ttpch

ROWS = 20_000
REL = 1e-4


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpch_external"))
    lake = os.path.join(root, "lake")
    jtpch.generate_tpch(lake, rows_lineitem=ROWS, seed=42)
    session = T.HyperspaceSession(os.path.join(root, "wh"), device="cpu")
    ttpch.tpch_indexes(session, T.Hyperspace(session), lake)
    return lake, session.enable_hyperspace()


def test_the_query_set_is_the_jax_packages():
    assert list(text.PANDAS_TPCH) == list(jext.PANDAS_TPCH)
    assert set(text.PANDAS_TPCH) == set(ttpch.TPCH_QUERIES)
    for q, fn in text.PANDAS_TPCH.items():
        assert fn.__name__ == jext.PANDAS_TPCH[q].__name__ == f"pandas_{q}"


@pytest.mark.parametrize("q", sorted(jext.PANDAS_TPCH))
def test_pandas_answers_equal_the_jax_modules(lake, q):
    root, _session = lake
    got, want = text.PANDAS_TPCH[q](root), jext.PANDAS_TPCH[q](root)
    assert type(got) is type(want)
    if isinstance(want, float):
        assert got == want
    else:
        pd.testing.assert_frame_equal(got, want)
        assert len(want) > 0


@pytest.mark.parametrize("q", sorted(jext.PANDAS_TPCH))
def test_pandas_answers_equal_the_ports_collect(lake, q):
    root, session = lake
    result = ttpch.TPCH_QUERIES[q](session, root).to_pydict()
    want = text.answer_columns(text.PANDAS_TPCH[q](root), list(result))
    assert list(want) == list(result)
    for name, w in want.items():
        g = np.asarray(result[name])
        assert len(g) == len(w) > 0, name
        if w.dtype.kind == "f":
            assert np.all(np.abs(g - w) <= REL * np.abs(w)), name
        else:
            assert g.tolist() == w.tolist(), name


def test_answer_columns_takes_a_frame_by_the_ports_names():
    frame = pd.DataFrame({"b": [1, 2], "a": [3.0, 4.0], "extra": [0, 0]})
    out = text.answer_columns(frame, ["a", "b"])
    assert list(out) == ["a", "b"] and out["b"].tolist() == [1, 2]
    assert text.answer_columns(2.5, ["revenue"])["revenue"].tolist() == [2.5]
