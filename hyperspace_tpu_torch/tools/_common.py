"""What the gates share: the ``float.hex()`` form of a result, the one
JSON line a gate prints, and the ``--device`` flag."""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import torch

from ..exceptions import DeviceUnavailableError


def bits(d: dict) -> str:
    """A result dict at bit precision: every float as ``float.hex()``
    (the reference's ``tools/chaos_stress._bits``)."""
    return repr({k: [x.hex() if isinstance(x, float) else x for x in v] for k, v in d.items()})


def emit(obj: dict) -> None:
    """Print the gate's one JSON line."""
    print(json.dumps(obj, default=str), flush=True)


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device of the device tier (default: the card)")


def resolve_device(name: "str | None") -> torch.device:
    """The device a gate runs on: the card unless ``name`` says otherwise.
    Asking for CUDA where there is none raises, as the session does; there
    is no fallback to the CPU."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "the gate runs on CUDA by default and torch.cuda.is_available() is "
                "false; pass --device cpu to run it on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def engine_caches(session) -> dict:
    """Every bounded cache a query of ``session`` goes through: the
    session's own (the port keeps them per session) and the process-wide
    ones, by the reference's names where it has them."""
    from ..cache.result_cache import RESULT_CACHE
    from ..columnar import io as cio
    from ..models.dataskipping import sketch_store
    from ..plan import kernel_cache as kc

    return {
        "io.index_chunk": session.index_chunk_cache,
        "io.source_col": cio._SOURCE_COL_CACHE,
        "io.rowgroup_stats": cio._ROWGROUP_STATS_CACHE,
        "io.sidecar": sketch_store._SIDECAR_CACHE,
        "device": session.device_cache,
        "host_derived": session.host_derived_cache,
        "kernel": session.kernel_cache,
        "kernel_mesh": kc.MESH_CACHE,
        "result": RESULT_CACHE,
    }


def clear_engine_caches(session) -> None:
    """Start cold: a cached chunk never re-reads and a cached kernel never
    re-builds, so warm caches would absorb the fault points."""
    for cache in engine_caches(session).values():
        cache.clear()


def cache_consistency(session) -> dict:
    """Each bounded cache's ``check_consistency()`` (call at quiescence)."""
    return {name: cache.check_consistency() for name, cache in engine_caches(session).items()}


# the TPC-H world of the chaos and race gates: seed 11, 8 buckets, small
# chunks so the streamed executor engages at their row counts
TPCH_SEED = 11
TPCH_BUCKETS = 8
GATE_ENV = {"HYPERSPACE_STREAM_CHUNK_MB": "0.5"}


def tpch_world(ws: str, rows: int, device):
    """A TPC-H lake of ``rows`` lineitem rows under ``ws``, indexed
    (``benchmark/tpch.tpch_indexes``), with the device tier and Hyperspace
    on; returns the session."""
    from .. import Hyperspace, HyperspaceSession
    from .. import constants as C
    from ..benchmark.tpch import generate_tpch, tpch_indexes

    generate_tpch(ws, rows_lineitem=rows, seed=TPCH_SEED)
    session = HyperspaceSession(warehouse_dir=ws, device=device)
    session.set_conf(C.INDEX_NUM_BUCKETS, TPCH_BUCKETS)
    session.set_conf(C.EXEC_TPU_ENABLED, True)
    tpch_indexes(session, Hyperspace(session), ws)
    session.enable_hyperspace()
    return session


def counter(name: str) -> int:
    from ..telemetry.metrics import REGISTRY

    m = REGISTRY.get(name)
    return 0 if m is None else int(m.value)


@contextlib.contextmanager
def gate_scope(env: dict, lock_audit: bool = False, lifecycle_audit: bool = False):
    """Set ``env`` (the knobs are read at every call) and the audits for
    the block, and put all back after it, so a gate called in-process
    leaves the caller's settings as they were."""
    from ..staticcheck import concurrency as cc
    from ..staticcheck import lifecycle as lc
    from ..utils import env as knobs

    saved = {k: knobs.read_raw(k) for k in env}
    os.environ.update(env)
    prev_lock = cc.set_audit(lock_audit or cc.audit_enabled())
    prev_life = lc.set_audit(lifecycle_audit or lc.audit_enabled())
    try:
        yield
    finally:
        cc.set_audit(prev_lock)
        lc.set_audit(prev_life)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
