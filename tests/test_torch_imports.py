"""The port stands alone: importing hyperspace_tpu_torch (every module, the
telemetry, analysis, ingest, cache, fault-injection, serving, sampling,
adaptive, static-check, camelCase, mesh, benchmark, gate and example ones
included) and chip_smoke.py, or running a gate or an example as a
module, loads neither JAX nor the JAX package; and the device tier runs
on CUDA unless the caller asks for the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
sys.path.insert(0, {repo!r})
import hyperspace_tpu_torch
for m in pkgutil.walk_packages(hyperspace_tpu_torch.__path__, "hyperspace_tpu_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0].startswith("jax") or m.split(".")[0] == "hyperspace_tpu"
)
print(json.dumps({{"bad": bad, "loaded": sorted(m for m in sys.modules
                                               if m.startswith("hyperspace_tpu_torch"))}}))
"""


def test_port_imports_no_jax_and_no_reference_package():
    # a subprocess: this test process has imported jax already (conftest)
    code = _PROBE.format(repo=REPO, smoke=os.path.join(REPO, "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=REPO, env=env, check=True,
    )
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    for module in ("plan.gpu_exec", "ops.cuda_kernels", "ops.zorder", "plan.pruning",
                   "models.zorder.fields", "models.zorder.index", "models.zorder.rule",
                   "models.dataskipping.sketches", "models.dataskipping.index",
                   "models.dataskipping.rule", "models.dataskipping.sketch_store",
                   "ops.sketch", "plan.passes", "actions.refresh", "actions.optimize",
                   "actions.lifecycle", "meta.cache", "index_manager", "sources.interfaces",
                   "sources.default", "sources.manager", "sources.delta", "sources.iceberg",
                   "utils.partitions", "utils.workers", "utils.rpc_meter", "telemetry",
                   "telemetry.metrics", "telemetry.trace", "telemetry.events",
                   "telemetry.logger", "telemetry.plan_stats", "analysis.display",
                   "analysis.whynot", "analysis.explain", "analysis.statistics",
                   "analysis.minmax_analysis", "utils.faults", "utils.retry", "utils.lru",
                   "ingest", "ingest.snapshots", "ingest.actions", "ingest.compaction",
                   "cache", "cache.result_cache", "cache.view_maintenance",
                   "serve", "serve.budget", "serve.context", "serve.tenant", "serve.qos",
                   "serve.scheduler", "telemetry.attribution", "telemetry.index_ledger",
                   "telemetry.workload", "telemetry.exporter", "models.sample_store",
                   "plan.sampling", "plan.adaptive", "staticcheck",
                   "staticcheck.concurrency", "staticcheck.lifecycle",
                   "staticcheck.plan_verifier", "staticcheck.kernel_audit", "compat",
                   "parallel", "parallel.mesh", "parallel.exchange", "parallel.dist_agg",
                   "parallel.dist_join", "parallel.placement", "parallel.dryrun",
                   "benchmark.tpch", "benchmark.tpcds", "benchmark.external",
                   *ENTRY_POINTS, "tools", "tools._common", "tools.differential",
                   "examples"):
        assert f"hyperspace_tpu_torch.{module}" in out["loaded"], module


# the gates' and walkthroughs' command-line entry points
ENTRY_POINTS = ("tools.differential_soak", "tools.chaos_stress", "tools.race_stress",
                "tools.trace_report", "tools.serve_smoke", "tools.qos_smoke",
                "tools.plan_stats_smoke", "tools.workload_smoke", "tools.result_cache_smoke",
                "tools.ingest_smoke", "examples.quickstart", "examples.tour",
                "examples.layout_analysis", "examples.nested_and_iceberg",
                "examples.snapshots_and_hybrid_scan")

_ENTRY_PROBE = r"""
import contextlib, io, json, runpy, sys
sys.path.insert(0, {repo!r})
usage = {{}}
for module in {modules!r}:
    sys.argv = [module, "--help"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_module(module, run_name="__main__")
        except SystemExit:
            pass
    usage[module] = out.getvalue().startswith("usage:")
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m.split(".")[0] == "hyperspace_tpu")
print(json.dumps({{"bad": bad, "usage": usage}}))
"""


def test_entry_points_run_without_jax_or_the_reference_package():
    """Each gate and example run as ``python -m`` (its --help) loads
    neither JAX nor the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    modules = [f"hyperspace_tpu_torch.{m}" for m in ENTRY_POINTS]
    proc = subprocess.run([sys.executable, "-c", _ENTRY_PROBE.format(repo=REPO, modules=modules)],
                          capture_output=True, text=True, timeout=120, cwd=REPO, env=env,
                          check=True)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "usage": dict.fromkeys(modules, True)}


def test_session_without_device_raises_instead_of_running_on_cpu(tmp_path, monkeypatch):
    import torch

    from hyperspace_tpu_torch import HyperspaceSession
    from hyperspace_tpu_torch.columnar import io as cio
    from hyperspace_tpu_torch.columnar.table import Column, ColumnBatch
    from hyperspace_tpu_torch.exceptions import DeviceUnavailableError
    from hyperspace_tpu_torch.plan.expr import Count, Sum, col, lit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cio.write_parquet(
        ColumnBatch({"x": Column(np.arange(10, dtype=np.float64), "float64")}),
        str(tmp_path / "src" / "p.parquet"),
    )
    session = HyperspaceSession(str(tmp_path / "wh"))
    df = session.read.parquet(str(tmp_path / "src"))
    query = df.filter(col("x") > 2).agg(Sum(col("x")), Count(lit(1)))
    with pytest.raises(DeviceUnavailableError):
        query.collect()
    # the host tier still answers when the device tier is off
    session.set_conf("hyperspace.tpu.exec.enabled", False)
    assert query.to_pydict()["count(1)"] == [7]
    # and an explicit CPU device runs the device tier's plain bodies
    cpu = HyperspaceSession(str(tmp_path / "wh"), device="cpu")
    out = cpu.read.parquet(str(tmp_path / "src")).filter(col("x") > 2).agg(
        Sum(col("x")), Count(lit(1))
    ).to_pydict()
    assert out == {"sum(x)": [42.0], "count(1)": [7]}
    assert cpu.device_stats.device_fragments == 1


_NATIVE_PROBE = r"""
import importlib, json, pkgutil, subprocess, sys
sys.path.insert(0, {repo!r})
calls = []
for name in ("run", "Popen", "call", "check_call", "check_output"):
    setattr(subprocess, name, lambda *a, _n=name, **k: calls.append(_n))
import hyperspace_tpu_torch
from hyperspace_tpu_torch import native
for m in pkgutil.walk_packages(hyperspace_tpu_torch.__path__, "hyperspace_tpu_torch."):
    importlib.import_module(m.name)
print(json.dumps({{"calls": calls, "loaded": len(native._lib),
                  "cdll": [m for m in sys.modules if m == "hyperspace_tpu_torch.native"]}}))
"""


def test_importing_the_native_bindings_builds_nothing():
    """The native library compiles at first use only: importing the port
    (its bindings included) starts no compiler and loads no library."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _NATIVE_PROBE.format(repo=REPO)], capture_output=True,
        text=True, timeout=120, cwd=REPO, env=env, check=True,
    )
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"calls": [], "loaded": 0, "cdll": ["hyperspace_tpu_torch.native"]}
