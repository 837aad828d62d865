"""Cross-query kernel cache (counterpart of hyperspace_tpu/plan/kernel_cache.py).

A device-tier "kernel" is the closure that runs one fragment's body over
device columns: the filter, projections and aggregates, routed through the
hand-written CUDA kernels where the fragment's shape allows. It is keyed by
a canonical fingerprint of the fragment (route, expressions, device dtypes,
shape constants) and of the scan it reads (``scan_structure``), so a
repeated query template reuses its closure. The route ("cuda" or "plain")
is part of the key, because it is decided when the closure is built. A
build runs in a ``compile:<kind>`` span and counts ``kernel.retrace``, as
the JAX package's kernel caches do; the port's cache is the session's, so a
new session builds again where the JAX package's process-wide caches hit.

Every build feeds the static checks (staticcheck/kernel_audit.py): the
retrace watchdog always, grouping misses by kind and dtype signature
(``fingerprint_dtype_signature``), and the hazard audit of the closure's
first call under ``HYPERSPACE_KERNEL_AUDIT=1``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable

from ..staticcheck.concurrency import TrackedLock


def dtype_signature(dev_cols: dict) -> tuple:
    """Canonical (name, dtype) signature of an upload dict, order-free; a
    Wide64 word pair (a tuple of two tensors) is "wide64", so its kernel
    never serves a narrowed upload of the column."""
    return tuple(sorted((n, "wide64" if isinstance(a, tuple) else str(a.dtype))
                        for n, a in dev_cols.items()))


def fingerprint_dtype_signature(key) -> tuple:
    """The dtype-signature component of a fingerprint, by which the retrace
    watchdog groups a cache's misses. Most forms end with it, as every JAX
    fingerprint does; three do not, and name theirs here: the stacked join
    body (its join-key dtype: the bodies take any column dtype), the
    plain-join bodies and the sort body (dtype-free bodies: the empty
    signature, as the JAX package's default ``col_sig``)."""
    if key[0] == "join_agg":
        return (("key", key[2]),)
    if key[0] == "plain_join" or key[:2] == ("order", "sort"):
        return ()
    return key[-1]


class KernelCache:
    """Bounded LRU of built kernels, one per session, named as the JAX
    package's process-wide kernel cache is, and counted as it is:
    ``cache.<name>.hits``, ``misses`` (a build) and ``evictions``."""

    def __init__(self, name: str = "kernel", maxlen: int = 256):
        self.name = name
        self.maxlen = maxlen
        self._d: OrderedDict = OrderedDict()
        self._lock = TrackedLock(f"kernel_cache.{name}")

    def _count(self, event: str, n: int = 1) -> None:
        from ..telemetry.metrics import REGISTRY

        REGISTRY.counter(f"cache.{self.name}.{event}").inc(n)

    def get(self, key, default=None):
        """The kernel under ``key`` (``cache.<name>.hits``), else
        ``default`` (``cache.<name>.misses``)."""
        with self._lock:
            try:
                value = self._d[key]
            except KeyError:
                value = None
            else:
                self._d.move_to_end(key)
        if value is None:
            self._count("misses")
            return default
        self._count("hits")
        return value

    def set(self, key, value) -> None:
        evicted = 0
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxlen:
                self._d.popitem(last=False)
                evicted += 1
        if evicted:
            self._count("evictions", evicted)

    def get_or_build(self, key, builder: Callable, kind: str = "kernel"):
        with self._lock:
            kernel = self._d.get(key)
            if kernel is not None:
                self._d.move_to_end(key)
        if kernel is not None:
            self._count("hits")
            return kernel
        from ..staticcheck.kernel_audit import observe_compile
        from ..telemetry import trace
        from ..telemetry.metrics import REGISTRY
        from ..utils import faults

        self._count("misses")
        with trace.span(f"compile:{kind}"):
            # the kernel.compile fault point fires on a real build only: a
            # warm cache never builds, so never faults. Its context key is
            # ``kernel`` (the JAX package passes ``kind``, which collides
            # with the span event's own ``kind`` and raises TypeError)
            faults.fire("kernel.compile", kernel=kind)
            kernel = builder()
        REGISTRY.counter("kernel.retrace").inc()
        kernel = observe_compile(self.name, kind, key, kernel,
                                 fingerprint_dtype_signature(key))
        self.set(key, kernel)
        return kernel

    def check_consistency(self) -> bool:
        """Within its bound (call at quiescence)."""
        with self._lock:
            return len(self._d) <= self.maxlen

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        """Drop every built kernel (the next query of each template builds
        again, through the static checks)."""
        with self._lock:
            self._d.clear()


def scan_structure(n) -> tuple:
    """A FileScan's identity, its file list left out: format, columns,
    schema, pushed filter, lineage ids, index and bucket layout, options,
    partition columns, the derived pruning and the sampled tier (a sampled
    scan never shares a key with its exact twin). A raw scan's roots are part
    of it (partition values derive from them); an index scan's root, the
    common path of its files, is not."""
    ps = n.prune_spec
    prune = None
    if ps is not None:
        prune = (
            ps.index_name, ps.num_buckets, tuple(ps.key_columns), tuple(ps.sort_columns),
            tuple(sorted(ps.bucket_keep)) if ps.bucket_keep is not None else None,
            tuple(repr(c) for c in ps.rowgroup_conjuncts),
            tuple(repr(c) for c in ps.sketch_conjuncts),
            repr(ps.pred),
        )
    return (
        "FileScan",
        n.fmt,
        None if n.index_info is not None else tuple(n.root_paths),
        tuple(n.required_columns or ()),
        tuple((f.name, f.dtype) for f in n.full_schema),
        repr(n.pushed_filter),
        tuple(n.lineage_filter_ids or ()),
        (n.index_info.index_name, n.index_info.index_kind_abbr) if n.index_info else None,
        (n.bucket_spec.num_buckets, n.bucket_spec.bucket_columns, n.bucket_spec.sort_columns)
        if n.bucket_spec else None,
        tuple(n.partition_columns),
        tuple(sorted(n.options.items())),
        prune,
        n.sample_spec.structure_key() if n.sample_spec is not None else None,
    )


def fused_fingerprint(route: str, scan, pred_expr, proj_exprs, agg_list,
                      dev_cols: dict) -> tuple:
    """Global filter-aggregate kernel over ``scan``."""
    return (
        route,
        scan_structure(scan),
        repr(pred_expr),
        tuple((n, repr(e)) for n, e in proj_exprs),
        tuple((k, repr(c)) for k, c in agg_list),
        dtype_signature(dev_cols),
    )


def grouped_fingerprint(route: str, scan, seg_pad: int, pred_expr, proj_exprs, agg_list,
                        dev_cols: dict) -> tuple:
    """Grouped kernel over ``scan`` (seg_pad is baked into the body)."""
    return (
        "grouped",
        route,
        scan_structure(scan),
        seg_pad,
        repr(pred_expr),
        tuple((nm, repr(e)) for nm, e in proj_exprs),
        tuple((k, repr(c)) for k, c in agg_list),
        dtype_signature(dev_cols),
    )


def mesh_fingerprint(d: int, topology: tuple, seg_pad: int, pred_expr,
                     proj_exprs, agg_list, dev_cols: dict) -> tuple:
    """The distributed grouped kernel of parallel/dist_agg.py: the whole
    topology (axis names and per-axis sizes, and the mesh it folds on), so
    a meshSlices change between factorizations of one device count builds
    again instead of reusing the other slicing's folds."""
    return (
        "mesh",
        d,
        topology,
        seg_pad,
        repr(pred_expr),
        tuple((nm, repr(e)) for nm, e in proj_exprs),
        tuple((k, repr(c)) for k, c in agg_list),
        dtype_signature(dev_cols),
    )


def mesh_probe_fingerprint(mesh_id: int, axis, l_shape: tuple, r_shape: tuple,
                           key_dtype: str) -> tuple:
    """The co-partitioned probe of parallel/dist_join.py: the wave shapes,
    and the mesh's identity, so a closure over one mesh never serves
    another."""
    return ("mesh_probe", mesh_id, axis, l_shape, r_shape, (("key", key_dtype),))


def join_fingerprint(route: str, key_dtype: str, agg_list, residual, lfilters, rfilters,
                     col_sig: tuple) -> tuple:
    """Fused join+aggregate body of plan/device_join.py."""
    return (
        "join_agg",
        route,
        key_dtype,
        tuple((k, repr(c)) for k, c in agg_list),
        tuple(repr(r) for r in residual),
        tuple(repr(f) for f in lfilters),
        tuple(repr(f) for f in rfilters),
        col_sig,
    )


def plain_join_fingerprint(route: str, kind: str, *shape) -> tuple:
    """Plain-join bodies of plan/device_join.py: the per-bucket probe
    ("probe"), the band-stacked probe ("stacked_probe") and the run
    expansion ("expand", with its baked output pad)."""
    return ("plain_join", kind, route) + tuple(shape)


def order_fingerprint(route: str, kind: str, *params) -> tuple:
    """Device top-k ("topk": k, direction, key dtype) and sort ("sort":
    number of key words) bodies of plan/gpu_exec.py."""
    return ("order", kind, route) + tuple(params)


def bucket_join_fingerprint(route: str, kind: str, pad_r: int, key_dtype: str, agg_list,
                            residual, col_sig: tuple) -> tuple:
    """Per-bucket fused join+aggregate body of plan/device_join.py ("bucket_agg",
    or "bucket_agg_dup" for duplicate right keys), with its baked dump
    segment ``pad_r``."""
    return (
        kind,
        route,
        pad_r,
        key_dtype,
        tuple((k, repr(c)) for k, c in agg_list),
        tuple(repr(r) for r in residual),
        col_sig,
    )


# --- whole-plan fingerprints (the result cache's key, cache/result_cache.py)
#
# Two optimized plans share a cached result only when they are canonically
# identical. The fingerprint comes in two halves, so that view maintenance
# can tell "the same query template over a grown file set":
#
#   plan_structure_fingerprint: every semantic property of the plan but the
#     leaves' file lists (node kinds and arities in preorder, expression
#     reprs, each scan's structure and prune decisions, index identity);
#   plan_files_fingerprint: the (path, size, mtime) of every resolved file,
#     per scan in preorder. With equal structure, equal files mean a
#     bit-identical result, since execution over a resolved file set is
#     deterministic.


def plan_structure_fingerprint(plan) -> tuple:
    """The canonical structure of a whole optimized plan, file lists left
    out. A node's arity rides along, so the preorder cannot confuse two
    tree shapes; a Project's full expression reprs are in it (its
    describe() names only the outputs)."""
    from .nodes import FileScan, Project

    parts = []
    for n in plan.preorder():
        if isinstance(n, FileScan):
            parts.append(scan_structure(n))
        elif isinstance(n, Project):
            parts.append(("Project", 1, tuple(repr(e) for e in n.exprs)))
        else:
            parts.append((n.kind, len(n.children()), n.describe()))
    return tuple(parts)


def plan_files_fingerprint(plan) -> tuple:
    """Each scan's resolved files as sorted (path, size, mtime_ms) tuples,
    scans in preorder."""
    from .nodes import FileScan

    return tuple(
        tuple(sorted((f.name, f.size, f.modified_time) for f in n.files))
        for n in plan.preorder() if isinstance(n, FileScan)
    )


# the mesh probe's closures (parallel/dist_join.py), process-wide under the
# JAX package's name: they close over a mesh, not over a session
MESH_CACHE = KernelCache("kernel_mesh", 32)
