"""The static checks, the port against the JAX package on the same inputs
(the counterparts of tests/test_staticcheck.py).

- The plan verifier: over one TPC-H warehouse (20k lineitem rows, seed 3,
  ``tpch_indexes`` with sample twins) that the JAX package builds and both
  read, every TPC-H plan, the port's kernel-shaped forms and a sampled
  q3_revenue plan verify clean in both packages; for each of the 14
  violation codes, the same planted corruption in both packages' plans
  gives the same ``(code, path)`` list.
- The lock audit: a planted inversion and a transitive cycle raise
  ``LockOrderError`` with the JAX package's cycle; in a fresh process,
  after the same short query mix in each package, the registered lock
  names and guarded-state names equal the JAX package's but for a named
  list.
- The lifecycle audit: a leaked pin and a leaked stream are named with
  their acquire chain; an 8-way cancellation storm and a crash cell on the
  port's scheduler end quiescent; the ``staticcheck.lifecycle.*`` deltas
  of one sequence equal the JAX package's.

The env knobs and the lint are tests/test_torch_hslint.py's.
"""

import json
import os
import subprocess
import sys
import threading
from dataclasses import replace

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import serve as JSV
from hyperspace_tpu.benchmark import tpch as jtpch
from hyperspace_tpu.ingest import REGISTRY as JPINS
from hyperspace_tpu.meta.entry import FileInfo as JFileInfo
from hyperspace_tpu.models import sample_store as JSS
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.plan import nodes as JN
from hyperspace_tpu.plan import sampling as JS
from hyperspace_tpu.staticcheck import concurrency as JCC
from hyperspace_tpu.staticcheck import lifecycle as JLC
from hyperspace_tpu.staticcheck import plan_verifier as JPV
from hyperspace_tpu.telemetry.metrics import REGISTRY as JREG
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import serve as TSV
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch.ingest import REGISTRY as TPINS
from hyperspace_tpu_torch.meta.entry import FileInfo as TFileInfo
from hyperspace_tpu_torch.models import sample_store as TSS
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan import nodes as TN
from hyperspace_tpu_torch.plan import sampling as TS
from hyperspace_tpu_torch.staticcheck import concurrency as TCC
from hyperspace_tpu_torch.staticcheck import lifecycle as TLC
from hyperspace_tpu_torch.staticcheck import plan_verifier as TPV
from hyperspace_tpu_torch.telemetry.metrics import REGISTRY as TREG
from hyperspace_tpu_torch.utils import faults as TF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax": {"X": JX, "N": JN, "S": JS, "SS": JSS, "PV": JPV, "CC": JCC, "LC": JLC,
            "reg": JREG, "pins": JPINS, "serve": JSV, "FileInfo": JFileInfo},
    "torch": {"X": TX, "N": TN, "S": TS, "SS": TSS, "PV": TPV, "CC": TCC, "LC": TLC,
              "reg": TREG, "pins": TPINS, "serve": TSV, "FileInfo": TFileInfo},
}
FR = 0.1


def _val(pkg: str, name: str) -> int:
    m = PKGS[pkg]["reg"].get(name)
    return 0 if m is None else int(m.value)


# ---------------------------------------------------------------------------
# the plan verifier
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_wh(tmp_path_factory):
    """A TPC-H lake and its tpch_indexes with 0.1 sample twins, built by the
    JAX package; each package opens its own session over it."""
    root = str(tmp_path_factory.mktemp("tpch_sc"))
    mp = pytest.MonkeyPatch()
    mp.setenv("HYPERSPACE_APPROX", "1")
    mp.setenv("HYPERSPACE_APPROX_FRACTIONS", "0.1")
    try:
        jtpch.generate_tpch(root, rows_lineitem=20_000, seed=3)
        js = J.HyperspaceSession(warehouse_dir=root)
        jtpch.tpch_indexes(js, J.Hyperspace(js), root)
    finally:
        mp.undo()
    sessions = {"jax": J.HyperspaceSession(warehouse_dir=root).enable_hyperspace(),
                "torch": T.HyperspaceSession(root, device="cpu").enable_hyperspace()}
    return root, sessions


def _lookup(pkg: str, s, root: str):
    X = PKGS[pkg]["X"]
    return s.read.parquet(os.path.join(root, "lineitem")).filter(X.col("l_orderkey") == 7).agg(
        X.Sum(X.col("l_extendedprice")).alias("s"), X.Count(X.lit(1)).alias("n"))


def _q3_revenue(pkg: str, s, root: str):
    """tpch.q3_revenue of the port, written in each package's API."""
    X = PKGS[pkg]["X"]
    li = s.read.parquet(os.path.join(root, "lineitem"))
    od = s.read.parquet(os.path.join(root, "orders"))
    return (
        li.select("l_orderkey", "l_extendedprice", "l_discount")
        .join(od.select("o_orderkey", "o_orderdate"), X.col("l_orderkey") == X.col("o_orderkey"))
        .filter(X.col("o_orderdate") < 9500)
        .agg(X.Sum(X.col("l_extendedprice") * (X.lit(1.0) - X.col("l_discount")))
             .alias("revenue"), X.Count(X.lit(1)).alias("count"))
    )


def _plan(pkg: str, tpch_wh, name: str):
    root, sessions = tpch_wh
    s = sessions[pkg]
    if name == "lookup":
        return _lookup(pkg, s, root).optimized_plan()
    if name == "sampled":
        sp = PKGS[pkg]["S"].build_sampled_plan(s, _q3_revenue(pkg, s, root).optimized_plan(), FR)
        assert not isinstance(sp, str), f"{pkg}: the sampled tier declined: {sp}"
        return sp.plan
    tp = jtpch if pkg == "jax" else ttpch
    return tp.TPCH_QUERIES[name](s, root).optimized_plan()


def _scans(plan, N, indexed=None, bucketed=None, sampled=None) -> list:
    out = []
    for n in plan.preorder():
        if not isinstance(n, N.FileScan):
            continue
        if indexed is not None and (n.index_info is not None) != indexed:
            continue
        if bucketed is not None and (n.bucket_spec is not None) != bucketed:
            continue
        if sampled is not None and (n.sample_spec is not None) != sampled:
            continue
        out.append(n)
    return out


def _found(pkg: str, tpch_wh, plan) -> list:
    vs = PKGS[pkg]["PV"].verify_plan(plan, tpch_wh[1][pkg], raise_on_violation=False)
    return [(v.code, v.path) for v in vs]


def test_every_tpch_plan_and_a_sampled_plan_verify_clean(tpch_wh):
    root, sessions = tpch_wh
    for pkg in PKGS:
        runs0, nodes0 = _val(pkg, "staticcheck.plan.runs"), _val(pkg, "staticcheck.plan.nodes")
        names = sorted(jtpch.TPCH_QUERIES) + ["lookup", "sampled"]
        for name in names:
            assert _found(pkg, tpch_wh, _plan(pkg, tpch_wh, name)) == [], (pkg, name)
        assert _val(pkg, "staticcheck.plan.runs") - runs0 == len(names)
        assert _val(pkg, "staticcheck.plan.nodes") > nodes0
    fns = {**ttpch.QUERIES, **ttpch.SPAN_QUERIES, **ttpch.JOIN_QUERIES,
           **ttpch.LOOKUP_QUERIES, "q3_revenue": ttpch.q3_revenue}
    for name, fn in fns.items():  # the port's kernel-shaped forms
        assert _found("torch", tpch_wh, fn(sessions["torch"], root).optimized_plan()) == [], name


def test_verified_plans_render_the_same_nodes(tpch_wh):
    """The walks visit the same number of nodes in both packages (the node
    paths the codes name rest on equal plan shapes)."""
    for name in sorted(jtpch.TPCH_QUERIES) + ["sampled"]:
        nodes = {}
        for pkg in PKGS:
            n0 = _val(pkg, "staticcheck.plan.nodes")
            PKGS[pkg]["PV"].verify_plan(_plan(pkg, tpch_wh, name), tpch_wh[1][pkg])
            nodes[pkg] = _val(pkg, "staticcheck.plan.nodes") - n0
        assert nodes["torch"] == nodes["jax"], name


def _p_schema_unresolved(p, plan, ctx):
    scan = _scans(plan, p["N"], indexed=True)[0]
    scan.required_columns = list(scan.required_columns or scan.full_schema.names) + ["nope"]
    return plan


def _p_duplicate_output(p, plan, ctx):
    scan = _scans(plan, p["N"], indexed=True)[0]
    cols = list(scan.required_columns or scan.full_schema.names)
    scan.required_columns = cols + cols[:1]
    return plan


def _p_duplicate_file(p, plan, ctx):
    scan = _scans(plan, p["N"], indexed=True)[0]
    scan.files = list(scan.files) + [scan.files[0]]
    return plan


def _p_file_not_in_index(p, plan, ctx):
    scan = _scans(plan, p["N"], indexed=True)[0]
    stray = os.path.join(ctx["root"], "lineitem", sorted(os.listdir(
        os.path.join(ctx["root"], "lineitem")))[0])
    scan.files = list(scan.files) + [p["FileInfo"].from_path(stray)]
    return plan


def _p_bucket_spec_column(p, plan, ctx):
    scan = _scans(plan, p["N"], bucketed=True)[0]
    bs = scan.bucket_spec
    scan.bucket_spec = p["N"].BucketSpec(bs.num_buckets, ["nope"], bs.sort_columns)
    return plan


def _p_prune_layout(p, plan, ctx):
    scan = [n for n in _scans(plan, p["N"], indexed=True) if n.prune_spec is not None][0]
    scan.prune_spec = replace(scan.prune_spec, num_buckets=scan.prune_spec.num_buckets + 3)
    return plan


def _p_prune_out_of_range(p, plan, ctx):
    scan = [n for n in _scans(plan, p["N"], indexed=True) if n.prune_spec is not None][0]
    scan.prune_spec = replace(scan.prune_spec,
                              bucket_keep=frozenset({scan.prune_spec.num_buckets + 5}))
    return plan


def _p_prune_file_not_in_keep(p, plan, ctx):
    scan = [n for n in _scans(plan, p["N"], indexed=True) if n.prune_spec is not None][0]
    kept = set(scan.prune_spec.bucket_keep or ())
    other = next(b for b in range(scan.prune_spec.num_buckets) if b not in kept)
    scan.prune_spec = replace(scan.prune_spec, bucket_keep=frozenset({other}))
    return plan


def _p_prune_sketch(p, plan, ctx):
    X = p["X"]
    scan = [n for n in _scans(plan, p["N"], indexed=True) if n.prune_spec is not None][0]
    scan.prune_spec = replace(scan.prune_spec, sketch_conjuncts=(X.col("l_tax") == 1,),
                              sketch_capability=())
    return plan


def _p_join_buckets(p, plan, ctx):
    scan = _scans(plan, p["N"], bucketed=True)[0]
    bs = scan.bucket_spec
    scan.bucket_spec = p["N"].BucketSpec(bs.num_buckets * 2, bs.bucket_columns, bs.sort_columns)
    if scan.prune_spec is not None:
        scan.prune_spec = replace(scan.prune_spec, num_buckets=bs.num_buckets * 2)
    return plan


def _p_union_schema(p, plan, ctx):
    X = p["X"]
    other = p["N"].Project([X.col(plan.schema.names[0])], plan)
    return p["N"].Union([plan, other])


def _p_sample_not_declared(p, plan, ctx):
    SS = p["SS"]
    scan = _scans(plan, p["N"], sampled=True)[0]
    half = 0.5
    files = []
    for f in scan.files:
        d, base = os.path.split(f.name)
        _frac, data = SS.parse_sample_name(base)
        files.append(replace(f, name=SS.sample_path(os.path.join(d, data), half)))
    scan.files = files
    scan.sample_spec = replace(scan.sample_spec, fraction=half, ppm=SS.fraction_ppm(half))
    return plan


def _p_sample_not_twin(p, plan, ctx):
    SS = p["SS"]
    scan = _scans(plan, p["N"], sampled=True)[0]
    scan.files = [replace(f, name=os.path.join(os.path.dirname(f.name), SS.parse_sample_name(
        os.path.basename(f.name))[1])) for f in scan.files]
    return plan


def _p_sample_fraction(p, plan, ctx):
    # the sample-store metas of the pinned version list no 0.1 tier
    SS = p["SS"]
    load = SS.load_sample_meta

    def stripped(path):
        meta = load(path)
        if meta is not None:
            meta = {**meta, "kept": {k: v for k, v in meta["kept"].items()
                                     if k != str(SS.fraction_ppm(FR))}}
        return meta

    ctx["monkeypatch"].setattr(SS, "load_sample_meta", stripped)
    return plan


PLANTED = {
    "SCHEMA_UNRESOLVED": ("q6", _p_schema_unresolved),
    "DUPLICATE_OUTPUT_COLUMN": ("q6", _p_duplicate_output),
    "DUPLICATE_FILE": ("q6", _p_duplicate_file),
    "FILE_NOT_IN_INDEX": ("q6", _p_file_not_in_index),
    "BUCKET_SPEC_COLUMN_UNKNOWN": ("q3", _p_bucket_spec_column),
    "PRUNE_SPEC_LAYOUT_MISMATCH": ("lookup", _p_prune_layout),
    "PRUNE_BUCKET_OUT_OF_RANGE": ("lookup", _p_prune_out_of_range),
    "PRUNE_FILE_NOT_IN_KEEP": ("lookup", _p_prune_file_not_in_keep),
    "PRUNE_SKETCH_NOT_DECLARED": ("lookup", _p_prune_sketch),
    "JOIN_BUCKET_MISMATCH": ("q3", _p_join_buckets),
    "UNION_SCHEMA_MISMATCH": ("lookup", _p_union_schema),
    "SAMPLE_NOT_DECLARED": ("sampled", _p_sample_not_declared),
    "SAMPLE_FILE_NOT_TWIN": ("sampled", _p_sample_not_twin),
    "SAMPLE_FRACTION_MISMATCH": ("sampled", _p_sample_fraction),
}


@pytest.mark.parametrize("code", sorted(PLANTED))
def test_planted_corruption_names_the_same_code_and_path(code, tpch_wh, monkeypatch):
    query, plant = PLANTED[code]
    found = {}
    for pkg, p in PKGS.items():
        assert getattr(p["PV"], code) == code
        plan = plant(p, _plan(pkg, tpch_wh, query),
                     {"root": tpch_wh[0], "monkeypatch": monkeypatch})
        v0 = _val(pkg, f"staticcheck.plan.violation.{code}")
        found[pkg] = _found(pkg, tpch_wh, plan)
        assert _val(pkg, f"staticcheck.plan.violation.{code}") > v0
        with pytest.raises(p["PV"].PlanInvariantError):
            p["PV"].verify_plan(plan, tpch_wh[1][pkg])
    assert code in {c for c, _path in found["torch"]}
    assert found["torch"] == found["jax"]


def test_verify_knob_runs_the_verifier_in_optimized_plan_and_sampling(tpch_wh, monkeypatch):
    root, sessions = tpch_wh
    s = sessions["torch"]
    plain = _lookup("torch", s, root).collect().to_pydict()
    runs0 = _val("torch", "staticcheck.plan.runs")
    _lookup("torch", s, root).optimized_plan()
    assert _val("torch", "staticcheck.plan.runs") == runs0  # off by default
    monkeypatch.setenv("HYPERSPACE_VERIFY_PLAN", "1")
    monkeypatch.setenv("HYPERSPACE_APPROX", "1")
    assert _lookup("torch", s, root).collect().to_pydict() == plain
    assert _val("torch", "staticcheck.plan.runs") == runs0 + 1
    with TS.approx_scope(FR):
        _q3_revenue("torch", s, root).collect()
    # the exact plan in optimized_plan, then the sampled plan before it runs
    assert _val("torch", "staticcheck.plan.runs") == runs0 + 3


# ---------------------------------------------------------------------------
# the lock-order audit
# ---------------------------------------------------------------------------


@pytest.fixture()
def lock_audit():
    prev = {pkg: p["CC"].set_audit(True) for pkg, p in PKGS.items()}
    for p in PKGS.values():
        p["CC"].reset_order_graph()
    yield
    for pkg, p in PKGS.items():
        p["CC"].reset_order_graph()
        p["CC"].set_audit(prev[pkg])


def _nest(a, b) -> None:
    with a:
        with b:
            pass


def _cycle(pkg: str, names: list, closing: tuple):
    CC = PKGS[pkg]["CC"]
    locks = {n: CC.TrackedLock(n) for n in names}
    for x, y in zip(names, names[1:]):
        _nest(locks[x], locks[y])
    v0 = _val(pkg, "staticcheck.lock.violations")
    with pytest.raises(CC.LockOrderError) as ei:
        _nest(locks[closing[0]], locks[closing[1]])
    assert _val(pkg, "staticcheck.lock.violations") == v0 + 1
    assert not locks[closing[0]].locked() and not locks[closing[1]].locked()
    return ei.value


@pytest.mark.parametrize("names,closing", [
    (["sc.test.a", "sc.test.b"], ("sc.test.b", "sc.test.a")),
    (["sc.test.p", "sc.test.q", "sc.test.r"], ("sc.test.r", "sc.test.p")),
], ids=["inversion", "transitive"])
def test_planted_lock_cycle_raises_the_reference_cycle(lock_audit, names, closing):
    errs = {pkg: _cycle(pkg, names, closing) for pkg in PKGS}
    assert errs["torch"].cycle == errs["jax"].cycle
    assert set(errs["torch"].cycle) == set(names)
    head = str(errs["torch"]).split(";")[0]
    assert head == str(errs["jax"]).split(";")[0]


def test_declared_order_seeds_the_graph(lock_audit):
    for p in PKGS.values():
        p["CC"].declare_order("sc.decl.outer", "sc.decl.inner")
        with pytest.raises(p["CC"].LockOrderError):
            p["CC"].declare_order("sc.decl.inner", "sc.decl.outer")
    assert TCC.DECLARED_EDGES == JCC.DECLARED_EDGES


def test_audit_off_costs_one_check_and_records_nothing():
    lock = TCC.TrackedLock("sc.test.off")
    prev = TCC.set_audit(False)
    try:
        a0 = _val("torch", "staticcheck.lock.acquisitions")
        with lock:
            assert lock.locked()
        assert _val("torch", "staticcheck.lock.acquisitions") == a0
    finally:
        TCC.set_audit(prev)


_REGISTRY_PROBE = r"""
import json, os, sys, tempfile
sys.path.insert(0, {repo!r})
import numpy as np, pyarrow as pa, pyarrow.parquet as pq
import jax
jax.config.update("jax_platforms", "cpu")
import hyperspace_tpu as J, hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu.staticcheck import concurrency as JCC
from hyperspace_tpu_torch.staticcheck import concurrency as TCC
root = tempfile.mkdtemp()
os.makedirs(os.path.join(root, "src"))
pq.write_table(pa.table({{"k": np.arange(200) % 17, "v": np.arange(200, dtype=np.float64)}}),
               os.path.join(root, "src", "p.parquet"))
out = {{}}
for pkg, M, X, CC in (("jax", J, JX, JCC), ("torch", T, TX, TCC)):
    ws = os.path.join(root, pkg)
    s = M.HyperspaceSession(ws, device="cpu") if pkg == "torch" else M.HyperspaceSession(ws)
    if pkg == "jax":
        s.set_conf(JC.EXEC_TPU_ENABLED, True)
    hs = M.Hyperspace(s)
    src = os.path.join(root, "src")
    hs.create_index(s.read.parquet(src), M.CoveringIndexConfig("ix", ["k"], ["v"]))
    s.enable_hyperspace()
    q = lambda: s.read.parquet(src).filter(X.col("k") == 3).agg(X.Sum(X.col("v")).alias("s"))
    q().collect(); q().collect()
    sched = M.serve.QueryScheduler(max_concurrent=2, queue_depth=4)
    sched.submit_query(q(), label="q").result(60)
    sched.shutdown()
    hs.append("ix", s.read.parquet(src))
    q().collect()
    out[pkg] = {{"locks": sorted(CC.registered_locks()),
                "guarded": sorted(g.name for g in CC.guarded_state())}}
print(json.dumps(out))
"""

# named in JAX-package modules the port has no counterpart of (the TPU
# backend state and its breaker, the mesh tier's caches and budgets), and
JAX_ONLY_LOCKS = {"backend.state", "kernel_cache.kernel_mesh",
                  # its process-wide caches per kernel family: the port's one
                  # cache per session serves every kind
                  "kernel_cache.kernel_topk", "kernel_cache.kernel_sort",
                  "kernel_cache.kernel_join"}
JAX_ONLY_GUARDED = {"utils.backend._state", "utils.backend._breaker", "serve.budget._DEVICES"}
# the port's own: the CUDA kernels' build and counts, the kernel audit's
# hazard list, and the budget singletons the port keeps as two lists
TORCH_ONLY_LOCKS = {"cuda_kernels.build", "cuda_kernels.counts", "kernel_audit.hazards"}
TORCH_ONLY_GUARDED = {"ops.cuda_kernels.BUILD_LOG", "ops.cuda_kernels._libs",
                      "ops.cuda_kernels.LAUNCHES", "ops.cuda_kernels.PLAIN_CALLS",
                      "native.CALLS", "native._lib", "serve.budget._DEVICE",
                      "serve.budget._GLOBAL", "staticcheck.kernel_audit.F64_ALLOW",
                      "staticcheck.kernel_audit._FOUND"}


def test_lock_and_guard_registries_match_the_reference_after_a_query_mix():
    code = _REGISTRY_PROBE.format(repo=REPO)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"JAX_PLATFORMS": "cpu", "HYPERSPACE_IO_THREADS": "2"})
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=180, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    jl, tl = set(out["jax"]["locks"]), set(out["torch"]["locks"])
    jg, tg = set(out["jax"]["guarded"]), set(out["torch"]["guarded"])
    assert jl - tl == JAX_ONLY_LOCKS
    assert tl - jl == TORCH_ONLY_LOCKS
    assert jg - tg == JAX_ONLY_GUARDED
    assert tg - jg == TORCH_ONLY_GUARDED
    for name in ("trace.roots", "metrics.registry", "kernel_cache.kernel", "serve.scheduler",
                 "serve.tenants", "ingest.writer:ix", "telemetry.approx", "lru.lru",
                 "rpc_meter", "native.load", "io.cache.index_chunk", "device_cache.device"):
        assert name in tl, name


# ---------------------------------------------------------------------------
# the lifecycle audit
# ---------------------------------------------------------------------------


@pytest.fixture()
def life_audit():
    prev = {pkg: p["LC"].set_audit(True) for pkg, p in PKGS.items()}
    for p in PKGS.values():
        p["LC"].reset()
    yield
    for pkg, p in PKGS.items():
        p["LC"].reset()
        p["LC"].set_audit(prev[pkg])


class _Entry:
    """The fields a pin reads of a log entry."""

    name, id = "ix", 3

    class content:  # noqa: N801
        @staticmethod
        def files():
            return ()

    @staticmethod
    def index_version_dirs():
        return ["v__=0"]


def _leak_pin(pkg: str):
    return PKGS[pkg]["pins"].pin("/nonexistent/ix", _Entry())


def _leak_stream(pkg: str):
    return PKGS[pkg]["serve"].global_budget().stream("sc-leak")


@pytest.mark.parametrize("kind,leak", [("snapshot.pin", _leak_pin),
                                       ("budget.stream", _leak_stream)],
                         ids=["pin", "stream"])
def test_a_leak_is_named_with_its_acquire_chain(life_audit, kind, leak):
    for pkg, p in PKGS.items():
        handle = leak(pkg)
        l0 = _val(pkg, "staticcheck.lifecycle.leaks")
        with pytest.raises(p["LC"].ResourceLeakError) as ei:
            p["LC"].check_quiescent()
        assert [h.kind for h in ei.value.leaks] == [kind]
        msg = str(ei.value)
        assert kind in msg and "test_a_leak_is_named_with_its_acquire_chain" in msg
        assert "_leak_" in ei.value.leaks[0].site
        assert _val(pkg, "staticcheck.lifecycle.leaks") == l0 + 1
        if kind == "snapshot.pin":
            p["pins"].release(handle)
        else:
            handle.close()
        assert p["LC"].check_quiescent() == []


def _sequence(pkg: str, root) -> None:
    """Pins, a protection, streams and a wave grant, acquired and released
    in the same order in either package."""
    p = PKGS[pkg]
    snap = p["pins"].pin("/nonexistent/ix", _Entry())
    p["pins"].protect_version("/nonexistent/ix", 0)
    p["pins"].protect_version("/nonexistent/ix", 0)
    p["serve"].global_budget().stream("sc-a").close()
    st = p["serve"].device_budget().stream("sc-b")
    st.close()
    p["pins"].unprotect_version("/nonexistent/ix", 0)
    p["pins"].unprotect_version("/nonexistent/ix", 0)
    p["pins"].release(snap)


def test_lifecycle_deltas_equal_the_reference(life_audit, tmp_path):
    deltas = {}
    for pkg, p in PKGS.items():
        names = ("acquires", "releases", "leaks")
        before = {n: _val(pkg, f"staticcheck.lifecycle.{n}") for n in names}
        _sequence(pkg, tmp_path)
        assert p["LC"].check_quiescent() == []
        deltas[pkg] = {n: _val(pkg, f"staticcheck.lifecycle.{n}") - before[n] for n in names}
    assert deltas["torch"] == deltas["jax"]
    assert deltas["torch"]["acquires"] == deltas["torch"]["releases"] == 5


def _multifile(root) -> str:
    rng = np.random.default_rng(3)
    for i in range(6):
        n = 2500 + i * 97
        p = os.path.join(str(root), "t", f"part-{i}.parquet")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        pq.write_table(pa.table({"k": rng.integers(0, 40, n), "x": rng.uniform(0, 100, n)}), p)
    return os.path.join(str(root), "t")


def test_cancellation_storm_and_crash_cell_end_quiescent(life_audit, tmp_path, monkeypatch):
    """Eight served streaming queries cancelled mid-flight, then one whose
    scan hits an injected crash: every budget stream, attribution scope
    and pin is released, and check_quiescent() finds nothing."""
    monkeypatch.setenv("HYPERSPACE_IO_THREADS", "4")
    monkeypatch.setenv("HYPERSPACE_STREAM_CHUNK_MB", "0.01")
    src = _multifile(tmp_path)
    s = T.HyperspaceSession(str(tmp_path / "wh"), device="cpu")
    q = lambda: s.read.parquet(src).filter(TX.col("k") > 3).agg(  # noqa: E731
        TX.Sum(TX.col("x")).alias("s"), TX.Count(TX.lit(1)).alias("n"))
    want = q().collect().to_pydict()
    a0 = _val("torch", "staticcheck.lifecycle.acquires")
    sched = TSV.QueryScheduler(max_concurrent=8, queue_depth=16)
    try:
        handles = [sched.submit_query(q(), label=f"storm{i}") for i in range(8)]
        for h in handles[::2]:
            h.cancel()
        outcomes = set()
        for h in handles:
            try:
                assert h.result(60).to_pydict() == want
                outcomes.add("done")
            except TSV.QueryCancelledError:
                outcomes.add("cancelled")
        assert "cancelled" in outcomes
        assert sched.drain(60)
        TF.arm("io.read_file:crash_before:n=1")
        h = sched.submit_query(q(), label="crash")
        with pytest.raises(TF.InjectedCrash):
            h.result(60)
        assert sched.drain(60)
    finally:
        TF.disarm()
        sched.shutdown(wait=True, cancel=True)
    for _ in range(200):  # straggler read-ahead tasks end on their own
        if not TLC.live_handles():
            break
        threading.Event().wait(0.01)
    assert TLC.check_quiescent() == []
    assert _val("torch", "staticcheck.lifecycle.acquires") > a0
    assert TSV.global_budget().held_bytes() == 0 and TPINS.active_pins() == 0
