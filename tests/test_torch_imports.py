"""The port stands alone: importing hyperspace_tpu_torch (every module) and
chip_smoke.py loads neither JAX nor the JAX package; and the device tier
runs on CUDA unless the caller asks for the CPU."""

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
                   "models.dataskipping.sketches"):
        assert f"hyperspace_tpu_torch.{module}" in out["loaded"], module


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
