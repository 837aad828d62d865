"""Sizing and creation of the IO thread pools (counterpart of
hyperspace_tpu/utils/workers.py).

Every IO-bound pool of the port (the parallel parquet reader in
columnar/io.py, the bucket-pair loaders of the co-partitioned join in
plan/bucket_join.py, the compaction and bucket-write pools of
models/covering.py and the min/max analyzer) sizes itself through
``io_worker_count`` and is made by ``io_pool``, so ``HYPERSPACE_IO_THREADS``
governs them all and every worker thread carries an ``hs-*`` name. pyarrow
releases the GIL while it decodes, so a small pool scales near-linearly;
a width of 1 or less means fully serial work.

It is the one sanctioned pool and thread creation site: ``tools/hslint.py``
HS304 flags ``threading.Thread`` / ``ThreadPoolExecutor`` construction
anywhere else.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

from ..staticcheck.concurrency import TrackedLock
from . import env


def io_thread_cap(default_cap: int = 8) -> int:
    """Configured pool width: ``HYPERSPACE_IO_THREADS``, default
    ``min(default_cap, nproc)``. Unparseable values mean serial (1)."""
    try:
        return int(
            env.read_raw(
                "HYPERSPACE_IO_THREADS", str(min(default_cap, os.cpu_count() or 1))
            )
        )
    except ValueError:
        return 1


def io_worker_count(n_items: int, cap: int | None = None) -> int:
    """Pool width for ``n_items`` IO-bound tasks: the configured cap,
    clamped by the item count and an optional caller cap (a memory budget
    or a core count), never below 1, since ThreadPoolExecutor needs a
    positive width even for an empty work list."""
    width = io_thread_cap()
    if cap is not None:
        width = min(width, cap)
    return max(1, min(width, n_items))


def io_pool(max_workers: int, thread_name_prefix: str = "hs-io") -> ThreadPoolExecutor:
    """The port's ThreadPoolExecutor constructor: every pool gets an
    ``hs-*`` thread-name prefix, so stack dumps and traces attribute worker
    activity."""
    return ThreadPoolExecutor(
        max_workers=max_workers, thread_name_prefix=thread_name_prefix
    )


_SHARED_POOL: "ThreadPoolExecutor | None" = None
_shared_pool_lock = TrackedLock("workers.shared_pool")


def shared_io_pool() -> ThreadPoolExecutor:
    """A process-wide decode pool of ``io_thread_cap()`` workers, so that
    concurrent streams share one bound on decode parallelism instead of
    each opening a pool of its own. Only top-level read-ahead units may
    run here: a task that waits on another task of the same pool could
    starve it. Never shut down."""
    global _SHARED_POOL
    with _shared_pool_lock:
        if _SHARED_POOL is None:
            _SHARED_POOL = ThreadPoolExecutor(
                max_workers=io_thread_cap(), thread_name_prefix="hs-engine-io"
            )
        return _SHARED_POOL


def spawn_thread(target, name: str, daemon: bool = True, args: tuple = ()) -> threading.Thread:
    """Create and start a named thread; daemon by default, so a background
    thread never blocks interpreter shutdown."""
    t = threading.Thread(target=target, name=name, daemon=daemon, args=args)
    t.start()
    return t
