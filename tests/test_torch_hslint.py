"""The port's static-check knobs and its lint: the env registry carries
the five staticcheck knobs with the JAX package's defaults (and the reads
``tools/hslint.py`` once flagged go through it), the knobs steer the audits
when the modules are imported, and the repo's own lint finds nothing new in
the port against the JAX package's baseline, its paths mapped to the
port's."""

import json
import os
import subprocess
import sys

from hyperspace_tpu.utils import env as jenv
from hyperspace_tpu_torch.staticcheck import concurrency, kernel_audit, lifecycle, plan_verifier
from hyperspace_tpu_torch.utils import env as tenv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATICCHECK_KNOBS = ("HYPERSPACE_LOCK_AUDIT", "HYPERSPACE_LIFECYCLE_AUDIT",
                     "HYPERSPACE_VERIFY_PLAN", "HYPERSPACE_KERNEL_AUDIT",
                     "HYPERSPACE_RETRACE_WARN")


def test_env_registry_carries_the_staticcheck_knobs_with_the_reference_defaults():
    for name in STATICCHECK_KNOBS + ("HYPERSPACE_SKETCHES", "HYPERSPACE_DEVICE_BUDGET_MB"):
        assert tenv.knob(name).default == jenv.knob(name).default, name


def test_routed_reads_follow_the_knobs(monkeypatch):
    from hyperspace_tpu.models.dataskipping import sketch_store as jss
    from hyperspace_tpu.serve import budget as jb
    from hyperspace_tpu_torch.models.dataskipping import sketch_store as tss
    from hyperspace_tpu_torch.ops import cuda_kernels
    from hyperspace_tpu_torch.serve import budget as tb

    for sketches in (None, "0", "1", "bloom,zregion,nope"):
        for mb in (None, "12.5", "0", "junk"):
            for k, v in (("HYPERSPACE_SKETCHES", sketches), ("HYPERSPACE_DEVICE_BUDGET_MB", mb)):
                if v is None:
                    monkeypatch.delenv(k, raising=False)
                else:
                    monkeypatch.setenv(k, v)
            assert tss.enabled_kinds() == jss.enabled_kinds()
            assert tb.configured_device_budget_bytes() == jb.configured_device_budget_bytes()
    monkeypatch.setenv("CUDA_HOME", "/nonexistent/cuda")
    monkeypatch.setattr(cuda_kernels.shutil, "which", lambda _name: None)
    try:
        cuda_kernels._nvcc()
    except cuda_kernels.KernelError as e:
        assert "CUDA_HOME" in str(e)
    else:
        raise AssertionError("nvcc found under a nonexistent CUDA_HOME")


def _state() -> list:
    return [concurrency.audit_enabled(), lifecycle.audit_enabled(),
            kernel_audit.audit_enabled(), plan_verifier.verify_enabled(),
            tenv.env_int("HYPERSPACE_RETRACE_WARN")]


def test_knobs_steer_the_audits_at_import(monkeypatch):
    for k in STATICCHECK_KNOBS:
        if k not in os.environ:  # this process imported the modules without it
            assert _state()[STATICCHECK_KNOBS.index(k)] == tenv.knob(k).default
    code = ("import json; from hyperspace_tpu_torch.staticcheck import concurrency, "
            "lifecycle, kernel_audit, plan_verifier; from hyperspace_tpu_torch.utils import env;"
            "print(json.dumps([concurrency.audit_enabled(), lifecycle.audit_enabled(), "
            "kernel_audit.audit_enabled(), plan_verifier.verify_enabled(), "
            "env.env_int('HYPERSPACE_RETRACE_WARN')]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({k: "1" for k in STATICCHECK_KNOBS[:4]}, HYPERSPACE_RETRACE_WARN="3")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=REPO, env=env, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, True, True, True, 3]
    # the kernel audit and the verifier read their knob at every call
    monkeypatch.setenv("HYPERSPACE_KERNEL_AUDIT", "1")
    monkeypatch.setenv("HYPERSPACE_VERIFY_PLAN", "1")
    assert kernel_audit.audit_enabled() and plan_verifier.verify_enabled()


def test_hslint_finds_nothing_new_in_the_port(tmp_path):
    """The repo's own lint over the port, against the JAX package's
    baseline with its paths mapped to the port's: the port carries exactly
    the reference's debt."""
    with open(os.path.join(REPO, "tools", "hslint_baseline.txt")) as f:
        mapped = f.read().replace("hyperspace_tpu/", "hyperspace_tpu_torch/")
    baseline = tmp_path / "baseline.txt"
    baseline.write_text(mapped)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "hslint.py"), "hyperspace_tpu_torch",
         "--baseline", str(baseline)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    assert "0 new violation(s)" in proc.stdout


def test_data_skipping_build_reader_follows_the_io_threads_knob(tmp_path, monkeypatch):
    """The HS304 repair: the data-skipping build's per-file reads run on a
    ``workers.io_pool`` sized by ``io_worker_count``, as the JAX package's
    covering reader is, so ``HYPERSPACE_IO_THREADS=1`` reads on one thread
    (before, a pool of min(files, 8) threads of its own ignored the knob)."""
    import threading
    import time

    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    import hyperspace_tpu_torch as T
    from hyperspace_tpu_torch.plan import dataframe

    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(4)
    for i in range(6):
        pq.write_table(pa.table({"k": rng.integers(0, 100, 200)}), src / f"p{i}.parquet")
    collect = dataframe.DataFrame.collect
    widths = {}
    for threads in ("1", "4"):
        seen = []

        def recording(self, *a, **k):
            seen.append(threading.get_ident())
            time.sleep(0.01)  # overlap the reads, so a wider pool spreads them
            return collect(self, *a, **k)

        monkeypatch.setenv("HYPERSPACE_IO_THREADS", threads)
        monkeypatch.setattr(dataframe.DataFrame, "collect", recording)
        s = T.HyperspaceSession(str(tmp_path / f"wh{threads}"), device="cpu")
        T.Hyperspace(s).create_index(s.read.parquet(str(src)), T.DataSkippingIndexConfig(
            "ds", [T.MinMaxSketch("k")]))
        monkeypatch.setattr(dataframe.DataFrame, "collect", collect)
        assert len(seen) >= 6
        widths[threads] = len(set(seen))
    assert widths["1"] == 1 and widths["4"] > 1, widths
