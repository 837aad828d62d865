"""The parity gate: the port's public surface, knob registry and conf keys
held to the JAX package's, on the CPU. Every later change of the port keeps
this file green.

- Every module of hyperspace_tpu/ is imported beside its counterpart in
  the port. Every public top-level name of the JAX module (a def, a class,
  an assignment, a name in ``__all__``) and every public method of a
  public class must resolve in the port with ``hasattr`` (inherited
  members count). A name the port has in another module or under another
  name is a row of ``RENAMES``; a name it lacks on purpose is a row of
  ``DEPARTURES``, with its reason. Both tables are checked for stale rows.
- The knob registries: the port registers every JAX knob but the
  breaker's four, with the same kind, default and choices.
- A static walk of the port's AST: every literal ``HYPERSPACE_*`` name
  read through ``env`` is registered, every registered knob is read
  somewhere, and nothing reads one around the registry.
- Every ``hyperspace.*`` key of hyperspace_tpu/constants.py: the same key
  and default in the port's constants, and each JAX ``HyperspaceConf``
  accessor that reads it exists in the port's, with the same value on an
  empty conf and on one that sets every key.
- The names this gate found missing, each against the JAX package's
  result on the same input.
"""

import ast
import importlib
import os
import types

import numpy as np
import pytest

from hyperspace_tpu import config as jconfig
from hyperspace_tpu import constants as JC
from hyperspace_tpu.utils import env as jenv
from hyperspace_tpu_torch import config as tconfig
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.utils import env as tenv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "hyperspace_tpu")
PORT_ROOT = os.path.join(REPO, "hyperspace_tpu_torch")

# JAX modules whose counterpart has another name
MODULE_RENAMES = {
    "ops.pallas_kernels": "ops.cuda_kernels",
    "plan.tpu_exec": "plan.gpu_exec",
}
# JAX modules the port has no module for (their names are rows below)
UNPORTED_MODULES = {
    "utils.backend": "the device breaker and backend probe: the port's device tier "
                     "raises on a failed launch instead of falling back to the host",
    "utils.hashing": "one function, kept in meta/signatures.py beside its only caller",
    "utils.json_utils": "two wrappers of json.dumps/json.loads; the port's log manager "
                        "calls json directly",
}

# (JAX module, name) -> (port module, name): the port's name for it
RENAMES = {
    ("config", "HyperspaceConf.exec_tpu_enabled"):
        ("config", "HyperspaceConf.exec_device_enabled"),
    ("ops.bucketize", "sort_indices_within"): ("models.covering", "sort_indices_within"),
    ("ops.hashing", "hash32_jnp"): ("ops.hashing", "hash32_torch"),
    ("ops.hashing", "bucket_ids_jnp"): ("ops.hashing", "bucket_ids_torch"),
    ("ops.sketch", "segment_min_max_jnp"): ("ops.sketch", "segment_min_max_torch"),
    ("ops.sketch", "bloom_build_bits_jnp"): ("ops.sketch", "bloom_build_bits_torch"),
    ("ops.sketch", "bloom_probe_bits_jnp"): ("ops.sketch", "bloom_probe_bits_torch"),
    ("ops.zorder", "interleave_bits_jnp"): ("ops.zorder", "interleave_bits_torch"),
    ("plan.tpu_exec", "try_execute_tpu"): ("plan.gpu_exec", "try_execute_gpu"),
    ("models.covering", "read_source_files_parallel"):
        ("models.dataskipping.index", "read_source_files_parallel"),
    ("columnar.io", "NESTED_PREFIX"): ("constants", "NESTED_FIELD_PREFIX"),
    ("columnar.io", "INDEX_COMPRESSION"): ("constants", "INDEX_COMPRESSION_DEFAULT"),
    ("columnar.io", "source_cache_scope"): ("columnar.io", "maintenance_scope"),
    ("utils.device_cache", "DeviceArrayCache"): ("utils.device_cache", "DeviceColumnCache"),
    ("utils.device_cache", "DeviceArrayCache.occupancy_bytes"):
        ("utils.device_cache", "DeviceColumnCache.resident_bytes"),
    ("utils", "md5_hex"): ("meta.signatures", "md5_hex"),
    ("utils.hashing", "md5_hex"): ("meta.signatures", "md5_hex"),
    ("utils", "io_thread_cap"): ("utils.workers", "io_thread_cap"),
    ("utils", "io_worker_count"): ("utils.workers", "io_worker_count"),
}

# (JAX module, name) -> why the port has no counterpart
DEPARTURES = {
    ("ops.hashing", "jax_bitcast_u32"):
        "a jax.lax bitcast helper; torch tensors bitcast with Tensor.view",
    ("staticcheck.kernel_audit", "audit_jaxpr"):
        "scans a traced jaxpr; the port's kernels are CUDA and torch closures, audited "
        "by their first call (kernel_audit.audit_kernel_call)",
    ("parallel.mesh", "shard_map"):
        "the jax.experimental shard_map shim; the port's mesh runs one torch program "
        "per device ordinal (parallel/mesh.py)",
    ("native", "logger"):
        "the JAX package logs a failed native build and falls back to numpy; the "
        "port raises NativeError instead",
    ("plan.kernel_cache", "KERNEL_CACHE"):
        "process-wide jitted-kernel caches; the port's kernel caches belong to the "
        "session (session.kernel_cache and its kinds)",
    ("plan.kernel_cache", "TOPK_CACHE"): "as KERNEL_CACHE: the port's are per session",
    ("plan.kernel_cache", "SORT_CACHE"): "as KERNEL_CACHE: the port's are per session",
    ("plan.kernel_cache", "JOIN_CACHE"): "as KERNEL_CACHE: the port's are per session",
    ("utils.device_cache", "DEVICE_CACHE"):
        "process-wide device arrays; the port's device cache belongs to the session "
        "(session.device_cache), sized when the session is made",
    ("utils.device_cache", "HOST_DERIVED_CACHE"):
        "as DEVICE_CACHE: session.host_derived_cache",
    ("utils.env", "render_docs_section"):
        "writes the JAX registry's table into docs/performance.md, the JAX package's "
        "document; the port prints its table (python -m hyperspace_tpu_torch.utils.env)",
    ("utils.env", "update_docs"): "writes docs/performance.md, as render_docs_section",
    ("utils", "to_json"): "utils.json_utils is not ported (UNPORTED_MODULES)",
    ("utils", "from_json"): "utils.json_utils is not ported (UNPORTED_MODULES)",
    ("utils.json_utils", "to_json"): "utils.json_utils is not ported (UNPORTED_MODULES)",
    ("utils.json_utils", "from_json"): "utils.json_utils is not ported (UNPORTED_MODULES)",
}
for _name in ("CLOSED", "OPEN", "HALF_OPEN", "LATCHED", "safe_backend",
              "safe_device_count", "classify_device_failure",
              "breaker_state", "breaker_snapshot", "device_healthy", "device_strict",
              "record_device_success", "record_device_failure"):
    DEPARTURES[("utils.backend", _name)] = UNPORTED_MODULES["utils.backend"]

# the JAX registry's knobs the port does not register
BREAKER_KNOBS = {"HYPERSPACE_BACKEND_TIMEOUT", "HYPERSPACE_BREAKER_COOLDOWN",
                 "HYPERSPACE_DEVICE_STRICT", "HYPERSPACE_FORCE_PALLAS"}
# conf defaults the port sets otherwise, by decision
CONF_DEFAULT_DEPARTURES = {
    "EXEC_TPU_ENABLED_DEFAULT": "the port's device tier runs on the card by default",
}


# ---------------------------------------------------------------------------
# the public surface
# ---------------------------------------------------------------------------

def _jax_modules() -> list[str]:
    out = []
    for dirpath, _dirs, files in os.walk(JAX_ROOT):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), JAX_ROOT)[:-3]
                parts = rel.split(os.sep)
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                out.append(".".join(parts))
    return sorted(out)


JAX_MODULES = _jax_modules()


def _is_main_guard(node) -> bool:
    t = node.test
    return (isinstance(t, ast.Compare) and isinstance(t.left, ast.Name)
            and t.left.id == "__name__")


def public_surface(module: str) -> dict:
    """name -> public method names (None for a name that is no class) of
    the JAX module's source."""
    path = os.path.join(JAX_ROOT, *module.split(".")) if module else JAX_ROOT
    path = os.path.join(path, "__init__.py") if os.path.isdir(path) else path + ".py"
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out: dict = {}

    def visit(body):
        for st in body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[st.name] = None
            elif isinstance(st, ast.ClassDef):
                out[st.name] = [b.name for b in st.body
                                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                                and not b.name.startswith("_")]
            elif isinstance(st, (ast.Assign, ast.AnnAssign)):
                targets = st.targets if isinstance(st, ast.Assign) else [st.target]
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            out.setdefault(n.id, None)
                if (isinstance(st, ast.Assign) and isinstance(st.value, (ast.List, ast.Tuple))
                        and any(isinstance(t, ast.Name) and t.id == "__all__"
                                for t in st.targets)):
                    for n in ast.literal_eval(st.value):
                        out.setdefault(n, None)
            elif isinstance(st, ast.If) and not _is_main_guard(st):
                visit(st.body)
                visit(st.orelse)
            elif isinstance(st, ast.Try):
                visit(st.body)
                for h in st.handlers:
                    visit(h.body)
                visit(st.orelse)
                visit(st.finalbody)

    visit(tree.body)
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _port_module(module: str):
    name = MODULE_RENAMES.get(module, module)
    return importlib.import_module("hyperspace_tpu_torch" + (f".{name}" if name else ""))


def _resolve(module: str, dotted: str):
    obj = importlib.import_module("hyperspace_tpu_torch" + (f".{module}" if module else ""))
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def missing_names(module: str) -> list[str]:
    """The JAX module's public names and methods the port lacks."""
    importlib.import_module("hyperspace_tpu" + (f".{module}" if module else ""))
    port = None if module in UNPORTED_MODULES else _port_module(module)
    missing = []
    for name, methods in sorted(public_surface(module).items()):
        key = (module, name)
        if key in DEPARTURES:
            continue
        if key in RENAMES:
            obj = _resolve(*RENAMES[key])
        elif port is not None and hasattr(port, name):
            obj = getattr(port, name)
        else:
            missing.append(name)
            continue
        for m in methods or ():
            mkey = (module, f"{name}.{m}")
            if mkey in DEPARTURES:
                continue
            if mkey in RENAMES:
                _resolve(*RENAMES[mkey])
            elif not hasattr(obj, m):
                missing.append(f"{name}.{m}")
    return missing


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_resolves_in_the_port(module):
    assert missing_names(module) == []


def test_every_jax_module_has_its_counterpart():
    for module in JAX_MODULES:
        name = MODULE_RENAMES.get(module, module)
        path = os.path.join(PORT_ROOT, *name.split("."))
        exists = os.path.isdir(path) or os.path.exists(path + ".py")
        assert exists != (module in UNPORTED_MODULES), module


def test_the_tables_have_no_stale_rows():
    """Each row names a JAX name that exists and that the port does not
    already have under the same name in the same module; each rename's
    target resolves; each departure and unported module has its reason."""
    assert all(m in JAX_MODULES for m in UNPORTED_MODULES)
    assert all(m in JAX_MODULES for m in MODULE_RENAMES)
    for table in (RENAMES, DEPARTURES):
        for module, dotted in table:
            surface = public_surface(module)
            name, _, method = dotted.partition(".")
            assert name in surface, (module, dotted)
            assert not method or method in (surface[name] or ()), (module, dotted)
            if module in UNPORTED_MODULES:
                continue
            try:
                _resolve(MODULE_RENAMES.get(module, module), dotted)
            except AttributeError:
                continue
            raise AssertionError(f"{module}:{dotted} resolves in the port as it is")
    for target in RENAMES.values():
        _resolve(*target)
    for reason in [*DEPARTURES.values(), *UNPORTED_MODULES.values(),
                   *CONF_DEFAULT_DEPARTURES.values()]:
        assert isinstance(reason, str) and len(reason.split()) >= 3


# ---------------------------------------------------------------------------
# the knob registry
# ---------------------------------------------------------------------------

def test_the_knob_registry_equals_the_jax_packages():
    jax = {k.name: k for k in jenv.all_knobs()}
    port = {k.name: k for k in tenv.all_knobs()}
    assert BREAKER_KNOBS <= set(jax)
    assert set(port) == set(jax) - BREAKER_KNOBS
    for name, k in port.items():
        j = jax[name]
        assert (k.kind, k.default, k.choices) == (j.kind, j.default, j.choices), name
        assert type(k.default) is type(j.default) or k.kind == "float", name
        assert os.path.exists(os.path.join(PORT_ROOT, k.owner)), (name, k.owner)
        assert k.doc, name


_READERS = {"env_str", "env_int", "env_float", "env_bool", "read_raw", "knob", "cache_bytes"}


def _port_sources():
    for dirpath, _dirs, files in os.walk(PORT_ROOT):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path, encoding="utf-8") as fh:
                    yield os.path.relpath(path, PORT_ROOT), ast.parse(fh.read())


def _literal(node):
    if node.args and isinstance(node.args[0], ast.Constant) and isinstance(
            node.args[0].value, str):
        return node.args[0].value
    return None


def knob_reads() -> tuple[dict, list]:
    """(knob -> port modules reading it through env, reads of a
    HYPERSPACE_* name around it)."""
    reads: dict = {}
    around = []
    for rel, tree in _port_sources():
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                f = node.func
                fname = (f.attr if isinstance(f, ast.Attribute)
                         else f.id if isinstance(f, ast.Name) else None)
                lit = _literal(node)
                if lit is None or not lit.startswith("HYPERSPACE_"):
                    continue
                if fname in _READERS:
                    reads.setdefault(lit, set()).add(rel)
                elif fname in ("getenv", "get") and rel != os.path.join("utils", "env.py"):
                    around.append((rel, node.lineno, lit))
            elif (isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Constant)
                  and str(node.slice.value).startswith("HYPERSPACE_")
                  and rel != os.path.join("utils", "env.py")):
                around.append((rel, node.lineno, node.slice.value))
    return reads, around


def test_every_knob_read_is_registered_and_every_registered_knob_is_read():
    reads, around = knob_reads()
    registered = {k.name for k in tenv.all_knobs()}
    assert sorted(set(reads) - registered) == []
    assert sorted(registered - set(reads)) == []
    assert around == []
    # the owner named in the registry reads its knob
    for k in tenv.all_knobs():
        assert k.owner in reads[k.name], (k.name, k.owner, reads[k.name])


def test_the_static_check_sees_the_sketch_knobs():
    """The three sketch knobs the port used to ignore are read now, where
    the JAX package reads them."""
    reads, _ = knob_reads()
    store = os.path.join("models", "dataskipping", "sketch_store.py")
    for name in ("HYPERSPACE_SKETCH_BLOOM_FPP", "HYPERSPACE_SKETCH_BLOOM_NDV",
                 "HYPERSPACE_SKETCH_CACHE_MB"):
        assert store in reads[name], name


@pytest.mark.parametrize("name,raw,want", [
    ("HYPERSPACE_PIPELINE_DEPTH", None, 2), ("HYPERSPACE_PIPELINE_DEPTH", "5", 5),
    ("HYPERSPACE_SKETCH_BLOOM_FPP", "0.001", 0.001), ("HYPERSPACE_SKETCHES", None, None),
    ("HYPERSPACE_APPROX_FRACTIONS", "0.5", "0.5"), ("HYPERSPACE_MESH", "1", True),
    ("HYPERSPACE_MESH", "true", False), ("HYPERSPACE_MESH", None, False),
])
def test_the_accessors_parse_as_the_jax_packages(name, raw, want, monkeypatch):
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    kind = tenv.knob(name).kind
    read = {"int": "env_int", "float": "env_float", "bool": "env_bool"}.get(kind, "env_str")
    assert getattr(tenv, read)(name) == getattr(jenv, read)(name) == want


def test_unregistered_names_need_a_default(monkeypatch):
    monkeypatch.delenv("HYPERSPACE_NO_SUCH_KNOB", raising=False)
    for env in (tenv, jenv):
        with pytest.raises(KeyError):
            env.env_int("HYPERSPACE_NO_SUCH_KNOB")
        with pytest.raises(KeyError):
            env.knob("HYPERSPACE_NO_SUCH_KNOB")
        assert env.env_int("HYPERSPACE_NO_SUCH_KNOB", 7) == 7
        assert env.read_raw("HYPERSPACE_NO_SUCH_KNOB") is None


def test_the_table_prints_every_knob():
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "hyperspace_tpu_torch.utils.env"],
                         capture_output=True, text=True, timeout=60, cwd=REPO,
                         check=True).stdout
    rows = [r for r in out.splitlines() if r.startswith("| `HYPERSPACE_")]
    assert len(rows) == len(tenv.all_knobs()) == len(jenv.all_knobs()) - len(BREAKER_KNOBS)
    assert tenv.markdown_table() == out.strip()


# ---------------------------------------------------------------------------
# conf keys and accessors
# ---------------------------------------------------------------------------

CONF_KEYS = sorted(n for n in dir(JC) if not n.startswith("_")
                   and isinstance(getattr(JC, n), str)
                   and getattr(JC, n).startswith("hyperspace."))


@pytest.mark.parametrize("name", CONF_KEYS)
def test_every_conf_key_has_its_counterpart(name):
    assert getattr(TC, name) == getattr(JC, name)
    default = f"{name}_DEFAULT"
    if hasattr(JC, default):
        if default in CONF_DEFAULT_DEPARTURES:
            assert getattr(TC, default) != getattr(JC, default)
        else:
            assert getattr(TC, default) == getattr(JC, default)


def _conf_accessors() -> dict:
    """JAX HyperspaceConf property -> the key constants it reads."""
    with open(os.path.join(JAX_ROOT, "config.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
               and n.name == "HyperspaceConf")
    out = {}
    for fn in cls.body:
        if isinstance(fn, ast.FunctionDef) and any(
                isinstance(d, ast.Name) and d.id == "property" for d in fn.decorator_list):
            out[fn.name] = sorted({n.attr for n in ast.walk(fn) if isinstance(n, ast.Attribute)
                                   and isinstance(n.value, ast.Name) and n.value.id == "C"
                                   and n.attr in CONF_KEYS})
    return out


ACCESSORS = _conf_accessors()
# a value other than the default for every key an accessor reads
CONF_SAMPLES = {
    "APPLY_ENABLED": False,
    "DEFAULT_SOURCE_FORMATS": "parquet, CSV",
    "HYBRID_SCAN_ENABLED": True,
    "HYBRID_SCAN_MAX_APPENDED_RATIO": 0.5,
    "HYBRID_SCAN_MAX_DELETED_RATIO": 0.1,
    "INDEX_LINEAGE_ENABLED": "true",
    "FILTER_RULE_USE_BUCKET_SPEC": "yes",
    "INDEX_NUM_BUCKETS": "16",
    "INDEX_NUM_BUCKETS_LEGACY": 4,
    "OPTIMIZE_FILE_SIZE_THRESHOLD": 1 << 20,
    "INDEX_CACHE_EXPIRY_SECONDS": "60",
    "ZORDER_TARGET_SOURCE_BYTES_PER_PARTITION": 64 * 1024,
    "ZORDER_QUANTILE_ENABLED": "true",
    "ZORDER_QUANTILE_RELATIVE_ERROR": 0.05,
    "DATASKIPPING_TARGET_INDEX_DATA_FILE_SIZE": 1 << 20,
    "DATASKIPPING_MAX_INDEX_DATA_FILE_COUNT": "12",
    "DATASKIPPING_AUTO_PARTITION_SKETCH": False,
    "EXEC_TPU_ENABLED": "1",
    "EXEC_EXACT_F64_AGG": True,
    "EXEC_MESH_DEVICES": 4,
    "EXEC_MESH_SLICES": 2,
    "BUILD_MAX_BYTES_IN_MEMORY": 1 << 26,
    "INDEX_FORMAT": "arrow",
    "INDEX_STATS_COLUMNS": "ALL",
    "INDEX_COMPRESSION": "zstd",
    "EVENT_LOGGER_CLASS": "x.Logger",
    "DISPLAY_MODE": "html",
}


@pytest.mark.parametrize("accessor", sorted(ACCESSORS))
def test_every_conf_accessor_reads_as_the_jax_packages(accessor):
    port_name = RENAMES.get(("config", f"HyperspaceConf.{accessor}"),
                            (None, f"HyperspaceConf.{accessor}"))[1].split(".")[1]
    assert hasattr(tconfig.HyperspaceConf, port_name)
    keys = ACCESSORS[accessor]
    assert keys and all(k in CONF_SAMPLES for k in keys), keys
    empty = (getattr(tconfig.HyperspaceConf({}), port_name),
             getattr(jconfig.HyperspaceConf({}), accessor))
    if any(f"{k}_DEFAULT" in CONF_DEFAULT_DEPARTURES for k in keys):
        assert empty[0] != empty[1]
    else:
        assert empty[0] == empty[1]
    conf = {getattr(JC, k): v for k, v in CONF_SAMPLES.items()}
    got = getattr(tconfig.HyperspaceConf(conf), port_name)
    assert got == getattr(jconfig.HyperspaceConf(conf), accessor)
    assert got != empty[1] or accessor == "num_buckets"  # the legacy key yields to the key


@pytest.mark.parametrize("bad", [0.0, 1.0, "2"])
def test_the_quantile_error_is_validated_as_in_jax(bad):
    from hyperspace_tpu.exceptions import HyperspaceError as JError
    from hyperspace_tpu_torch.exceptions import HyperspaceError as TError

    conf = {JC.ZORDER_QUANTILE_RELATIVE_ERROR: bad}
    with pytest.raises(TError, match="relativeError"):
        tconfig.HyperspaceConf(conf).zorder_quantile_relative_error
    with pytest.raises(JError, match="relativeError"):
        jconfig.HyperspaceConf(conf).zorder_quantile_relative_error


# ---------------------------------------------------------------------------
# the names this gate filled, against the JAX package on the same input
# ---------------------------------------------------------------------------

def test_split64_and_merge64_equal_the_jax_packages():
    from hyperspace_tpu.ops import hashing as jh
    from hyperspace_tpu_torch.ops import hashing as th

    rng = np.random.default_rng(64)
    ints = np.concatenate([rng.integers(-(2**63), 2**63 - 1, 1000, dtype=np.int64),
                           np.array([0, -1, 2**63 - 1, -(2**63)], dtype=np.int64)])
    floats = np.concatenate([rng.normal(0, 1e12, 1000), [0.0, -0.0, np.inf, -np.inf]])
    for arr in (ints, floats, ints.astype(np.int32)):
        got, want = th.split64_np(arr), jh.split64_np(arr)
        assert all(g.dtype == w.dtype == np.int32 for g, w in zip(got, want))
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        back = th.merge64_np(*got, arr.dtype)
        assert back.dtype == jh.merge64_np(*want, arr.dtype).dtype
        assert np.array_equal(back.view(np.uint8), jh.merge64_np(*want, arr.dtype).view(np.uint8))
        assert np.array_equal(back, arr)


def test_native_facts_equal_the_jax_packages():
    """The same facts but ``loaded``, which says whether each package's
    library loaded (the JAX package's writes its library in place, so a
    worker racing another's first build may fall back to numpy)."""
    from hyperspace_tpu import native as jn
    from hyperspace_tpu_torch import native as tn

    assert tn.available() is True
    jax_loaded = jn.available()
    got, want = tn.build_facts(), jn.build_facts()
    assert got.pop("loaded") is True
    assert want.pop("loaded") is jax_loaded
    assert got == want
    assert got["abi"] == tn.ABI_VERSION


class _Entry:
    """The fields SnapshotRegistry.pin reads of a log entry."""

    def __init__(self, name, id_, versions):
        self.name, self.id = name, id_
        self._versions = versions
        self.content = types.SimpleNamespace(files=lambda: [f"v__={v}/part-0" for v in versions])

    def index_version_dirs(self):
        return [f"v__={v}" for v in self._versions]


def test_snapshot_pins_and_state_equal_the_jax_packages(tmp_path):
    from hyperspace_tpu.ingest.snapshots import SnapshotRegistry as JReg
    from hyperspace_tpu_torch.ingest.snapshots import SnapshotRegistry as TReg

    path = str(tmp_path / "idx")
    trace = {}
    for label, reg in (("jax", JReg()), ("torch", TReg())):
        a = reg.pin(path, _Entry("idx", 3, [0, 1]))
        b = reg.pin(path, _Entry("idx", 5, [1, 2]))
        reg.pin(str(tmp_path / "other"), _Entry("other", 1, [7]))
        steps = [(sorted(reg.pinned_versions(path)), reg.state())]
        reg.release(a)
        steps.append((sorted(reg.pinned_versions(path)), reg.state()))
        reg.release(b)
        reg.protect_version(path, 4)
        steps.append((sorted(reg.pinned_versions(path)), reg.state()))
        trace[label] = steps
    assert trace["torch"] == trace["jax"]
    assert trace["torch"][0][0] == [0, 1, 2] and trace["torch"][-1][0] == []


def test_the_query_ledgers_last_seq_equals_the_jax_packages():
    from hyperspace_tpu.telemetry.attribution import QueryStatsLedger as JLedger
    from hyperspace_tpu_torch.telemetry.attribution import QueryStatsLedger as TLedger

    seqs = {}
    for label, ledger in (("jax", JLedger(window=2)), ("torch", TLedger(window=2))):
        out = [ledger.last_seq()]
        stats = []
        for i in range(4):
            ctx = types.SimpleNamespace(query_id=i + 1, label=f"q{i}", priority=0,
                                        tenant="default")
            stats.append(ledger.begin(ctx))
            out.append(ledger.last_seq())
        for st in stats[:3]:
            ledger.finish(st, "ok")
            out.append(ledger.last_seq())
        seqs[label] = out
    assert seqs["torch"] == seqs["jax"] == [0, 1, 2, 3, 4, 4, 4, 4]


def test_the_transient_entry_equals_the_jax_packages(tmp_path):
    from hyperspace_tpu.actions import base as jbase
    from hyperspace_tpu.actions import states as JS
    from hyperspace_tpu_torch.actions import base as tbase
    from hyperspace_tpu_torch.actions import states as TS

    assert TS.ALL_STATES == JS.ALL_STATES
    for state in sorted(JS.ALL_STATES - JS.STABLE_STATES):
        entries = []
        for base in (jbase, tbase):
            action = type("Step", (base.Action,), {"transient_state": state})
            act = object.__new__(action)
            entries.append(act.transient_entry())
        j, t = entries
        assert t.state == j.state == state
        assert type(t).__name__ == type(j).__name__ == "LogEntry"
        strip = lambda d: {k: v for k, v in d.items() if k != "timestamp"}  # noqa: E731
        assert strip(t.to_dict()) == strip(j.to_dict())


def test_the_refreshed_relation_metadata_equals_the_jax_packages(tmp_path):
    """Each package builds a covering index over the same files (one fixed
    mtime), a file is appended, and each package's refresh action reports
    the same relation metadata for the changed source."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    import hyperspace_tpu as J
    import hyperspace_tpu_torch as T
    from hyperspace_tpu.actions.refresh import RefreshAction as JRefresh
    from hyperspace_tpu.index_manager import index_manager_for as jimf
    from hyperspace_tpu_torch.actions.refresh import RefreshAction as TRefresh
    from hyperspace_tpu_torch.index_manager import index_manager_for as timf

    src = tmp_path / "src"
    src.mkdir()

    def write(i):
        rng = np.random.default_rng(i)
        p = src / f"f{i}.parquet"
        pq.write_table(pa.table({"k": rng.integers(0, 100, 50), "v": rng.random(50)}), p)
        os.utime(p, (1_700_000_000, 1_700_000_000))

    write(0)
    write(1)
    sessions = {"jax": J.HyperspaceSession(str(tmp_path / "wh_jax")),
                "torch": T.HyperspaceSession(str(tmp_path / "wh_torch"), device="cpu")}
    for label, s in sessions.items():
        pkg = J if label == "jax" else T
        pkg.Hyperspace(s).create_index(s.read.parquet(str(src)),
                                       pkg.CoveringIndexConfig("ix", ["k"], ["v"]))
    write(2)
    got = {}
    for label, s in sessions.items():
        imf, action = (jimf, JRefresh) if label == "jax" else (timf, TRefresh)
        path, lm, dm = imf(s)._managers("ix")
        _rel, meta = action(s, path, lm, dm).refreshed_relation_metadata()
        got[label] = meta.to_dict()
    assert got["torch"] == got["jax"]
    assert "f2.parquet" in str(got["torch"])


def test_the_small_names_equal_the_jax_packages():
    """BucketSpec, Field and ColumnBatch forms, the reason code, the
    Index base's loader, the IndexConfig alias, ResultCache.get,
    CostModel.observations, KernelCache get/set/check_consistency and
    BoundedLRU get_or_put/clear, each held to the JAX package's."""
    import hyperspace_tpu as J
    import hyperspace_tpu_torch as T
    from hyperspace_tpu.cache import result_cache as jrc
    from hyperspace_tpu.columnar import table as jt
    from hyperspace_tpu.models import base as jmb
    from hyperspace_tpu.plan import kernel_cache as jkc
    from hyperspace_tpu.plan import nodes as jnodes
    from hyperspace_tpu.rules import base as jrb
    from hyperspace_tpu.serve import qos as jqos
    from hyperspace_tpu.utils import lru as jlru
    from hyperspace_tpu_torch.cache import result_cache as trc
    from hyperspace_tpu_torch.columnar import table as tt
    from hyperspace_tpu_torch.models import base as tmb
    from hyperspace_tpu_torch.plan import kernel_cache as tkc
    from hyperspace_tpu_torch.plan import nodes as tnodes
    from hyperspace_tpu_torch.rules import base as trb
    from hyperspace_tpu_torch.serve import qos as tqos
    from hyperspace_tpu_torch.utils import lru as tlru

    spec = {"numBuckets": 4, "bucketColumns": ["a"], "sortColumns": ["a", "b"]}
    for d in (spec, {"numBuckets": 2, "bucketColumns": ["x"]}):
        t, j = tnodes.BucketSpec.from_dict(d), jnodes.BucketSpec.from_dict(d)
        assert t.to_dict() == j.to_dict()
        assert (t.num_buckets, t.bucket_columns, t.sort_columns) == (
            j.num_buckets, j.bucket_columns, j.sort_columns)
    f = {"name": "l_orderkey", "type": "int64"}
    assert tt.Field.from_dict(f).to_dict() == jt.Field.from_dict(f).to_dict() == f
    data = {"a": [1, 2, 3], "b": [0.5, 1.5, 2.5], "s": ["x", "y", "x"]}
    t = tt.ColumnBatch.from_pydict(data).rename({"a": "k", "zz": "q"})
    j = jt.ColumnBatch.from_pydict(data).rename({"a": "k", "zz": "q"})
    assert t.schema.names == j.schema.names == ["k", "b", "s"]
    assert t.to_pydict() == j.to_pydict()
    assert trb.ANOTHER_INDEX_APPLIED == jrb.ANOTHER_INDEX_APPLIED
    for base in (tmb, jmb):
        with pytest.raises(NotImplementedError):
            base.Index.from_dict({})
    assert T.IndexConfig is T.CoveringIndexConfig and J.IndexConfig is J.CoveringIndexConfig

    caches = (trc.ResultCache(), jrc.ResultCache())
    assert [c.get(("nothing",)) for c in caches] == [None, None]

    models = (tqos.CostModel(), jqos.CostModel())
    for m in models:
        for label, s in (("a", 1.0), ("b", 2.0), ("a", 3.0)):
            m.update(label, s)
    assert [[m.observations(x) for x in "abc"] for m in models] == [[2, 1, 0]] * 2

    trace = []
    for kc in (tkc.KernelCache("surface_probe", 2), jkc.KernelCache("surface_probe", 2)):
        steps = [kc.get("a", "miss")]
        kc.set("a", 1)
        kc.set("b", 2)
        steps.append(kc.get("a"))
        kc.set("c", 3)  # evicts b, the least recent
        steps += [kc.get("b"), kc.get("c"), len(kc), kc.check_consistency()]
        trace.append(steps)
    assert trace[0] == trace[1] == ["miss", 1, None, 3, 2, True]

    trace = []
    for lru in (tlru.BoundedLRU(2), jlru.BoundedLRU(2)):
        built = []
        steps = [lru.get_or_put("a", lambda: built.append("a") or 1),
                 lru.get_or_put("a", lambda: built.append("a") or 9)]
        with pytest.raises(ValueError):
            lru.get_or_put("b", lambda: (_ for _ in ()).throw(ValueError("x")))
        steps.append(lru.get("b"))
        lru.clear()
        steps += [len(lru), built]
        trace.append(steps)
    assert trace[0] == trace[1] == [1, 1, None, 0, ["a"]]
