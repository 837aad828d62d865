"""Plan invariant verifier (counterpart of
hyperspace_tpu/staticcheck/plan_verifier.py).

An optimized plan is the product of five rewrite layers (pre-rewrite
passes, the Hyperspace index rules, predicate pushdown, column pruning,
predicate-driven pruning), each of which preserves semantics only if the
previous one kept its structural promises. This module states those
promises as checks over the final plan:

- every node's schema resolves, every expression reference binds to a
  child output column, and no node emits a duplicate column name
  (pushdown and pruning may narrow a scan but never drop or duplicate an
  output column);
- ``FileScan.files`` is non-empty (unless pruning emptied it) and, for
  index scans, a subset of the index log entry's content: a file outside
  the content set means a rewrite resurrected a vacuumed or deleted file;
- a ``PruneSpec`` agrees with the index metadata layout (num_buckets,
  key/sort columns) and with the scan's ``bucket_spec`` execution hint,
  kept bucket ids are in range, every kept file's filename bucket id is
  in the keep set, and every sketch-stage conjunct is backed by a
  DECLARED sketch capability;
- both sides of a bucketed join carry the SAME bucket count (the
  shuffle-free zip is only sound 1:1);
- a ``SampleSpec`` scan reads exactly the pinned version's sample twins
  at the declared fraction (twin naming, content containment, and
  sample-store meta agreement).

Violations raise :class:`PlanInvariantError` naming the node path (e.g.
``Join>[0]Filter>FileScan``) and land in the ``staticcheck.plan.*``
metrics family, under a ``staticcheck:plan`` span.
``HYPERSPACE_VERIFY_PLAN=1`` runs the verifier inside
``DataFrame.optimized_plan`` after ``apply_pruning`` and before a sampled
plan executes; it is a read-only walk that never mutates or replaces a
node, so a verified run is bit for bit an unverified one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from ..exceptions import HyperspaceError
from ..plan.nodes import (
    Aggregate,
    BucketUnion,
    FileScan,
    Filter,
    Join,
    LogicalPlan,
    Project,
    RepartitionByExpr,
    Sort,
    Union,
)
from ..telemetry.metrics import REGISTRY
from ..utils import env

if TYPE_CHECKING:
    from ..session import HyperspaceSession


@dataclass(frozen=True)
class Violation:
    """One failed invariant: a stable code, the node path, and the detail."""

    code: str
    path: str
    message: str

    def __str__(self) -> str:
        return f"[{self.code}] at {self.path}: {self.message}"


class PlanInvariantError(HyperspaceError):
    """Raised when an optimized plan breaks a structural invariant."""

    def __init__(self, violations: list[Violation]):
        self.violations = list(violations)
        first = self.violations[0]
        extra = (
            f" (+{len(self.violations) - 1} more)" if len(self.violations) > 1 else ""
        )
        super().__init__(f"plan invariant violated: {first}{extra}")

    @property
    def code(self) -> str:
        return self.violations[0].code

    @property
    def path(self) -> str:
        return self.violations[0].path


# violation codes (the stable vocabulary tests and dashboards key on)
SCHEMA_UNRESOLVED = "SCHEMA_UNRESOLVED"
DUPLICATE_OUTPUT_COLUMN = "DUPLICATE_OUTPUT_COLUMN"
UNRESOLVED_COLUMN_REF = "UNRESOLVED_COLUMN_REF"
EMPTY_FILE_SCAN = "EMPTY_FILE_SCAN"
DUPLICATE_FILE = "DUPLICATE_FILE"
FILE_NOT_IN_INDEX = "FILE_NOT_IN_INDEX"
REQUIRED_COLUMN_UNKNOWN = "REQUIRED_COLUMN_UNKNOWN"
PUSHED_FILTER_UNRESOLVED = "PUSHED_FILTER_UNRESOLVED"
BUCKET_SPEC_COLUMN_UNKNOWN = "BUCKET_SPEC_COLUMN_UNKNOWN"
PRUNE_SPEC_LAYOUT_MISMATCH = "PRUNE_SPEC_LAYOUT_MISMATCH"
PRUNE_BUCKET_OUT_OF_RANGE = "PRUNE_BUCKET_OUT_OF_RANGE"
PRUNE_FILE_NOT_IN_KEEP = "PRUNE_FILE_NOT_IN_KEEP"
PRUNE_SKETCH_NOT_DECLARED = "PRUNE_SKETCH_NOT_DECLARED"
JOIN_BUCKET_MISMATCH = "JOIN_BUCKET_MISMATCH"
UNION_SCHEMA_MISMATCH = "UNION_SCHEMA_MISMATCH"
SAMPLE_NOT_DECLARED = "SAMPLE_NOT_DECLARED"
SAMPLE_FRACTION_MISMATCH = "SAMPLE_FRACTION_MISMATCH"
SAMPLE_FILE_NOT_TWIN = "SAMPLE_FILE_NOT_TWIN"


class _Checker:
    def __init__(self, session: "Optional[HyperspaceSession]"):
        self.session = session
        self.violations: list[Violation] = []
        self.nodes = 0
        self._entry_files: dict[tuple[str, int], Optional[frozenset]] = {}

    # --- helpers ---
    def fail(self, code: str, path: str, message: str) -> None:
        self.violations.append(Violation(code, path, message))

    def _schema_names(self, node: LogicalPlan, path: str) -> Optional[list[str]]:
        try:
            return list(node.schema.names)
        except Exception as e:
            self.fail(SCHEMA_UNRESOLVED, path, f"schema does not resolve: {e}")
            return None

    def _check_refs(self, what: str, refs: set, avail: "Optional[list[str]]",
                    path: str) -> None:
        if avail is None:
            return
        missing = sorted(refs - set(avail))
        if missing:
            self.fail(
                UNRESOLVED_COLUMN_REF, path,
                f"{what} references {missing} not produced by the child "
                f"(available: {sorted(avail)})",
            )

    def _index_content_files(self, scan: FileScan) -> Optional[frozenset]:
        """Content file-name set of the scan's index log entry, or None when
        the check does not apply: data-skipping indexes ("DS") prune the
        SOURCE scan in place — its files are source files, never index
        content — and an unresolvable log entry must not fail verification
        of an otherwise sound plan."""
        info = scan.index_info
        if info is None or self.session is None or info.index_kind_abbr == "DS":
            return None
        key = (info.index_name, info.log_version)
        if key not in self._entry_files:
            files: Optional[frozenset] = None
            try:
                from ..index_manager import index_manager_for

                entry = index_manager_for(self.session).get_index(
                    info.index_name, info.log_version
                )
                if entry is not None:
                    files = frozenset(
                        f.name for f in entry.content.file_infos()
                    )
            except Exception:
                files = None
            self._entry_files[key] = files
        return self._entry_files[key]

    def _index_entry(self, scan: FileScan):
        info = scan.index_info
        if info is None or self.session is None:
            return None
        try:
            from ..index_manager import index_manager_for

            return index_manager_for(self.session).get_index(
                info.index_name, info.log_version
            )
        except Exception:
            return None

    # --- walk ---
    def walk(self, node: LogicalPlan, path: str) -> None:
        self.nodes += 1
        before = len(self.violations)
        if isinstance(node, FileScan):
            self._check_file_scan(node, path)
        elif isinstance(node, Filter):
            self._check_refs(
                "Filter condition", node.condition.references(),
                self._schema_names(node.child, path), path,
            )
        elif isinstance(node, Project):
            avail = self._schema_names(node.child, path)
            refs: set = set()
            for e in node.exprs:
                refs |= e.references()
            self._check_refs("Project expressions", refs, avail, path)
            self._check_unique_output(node, path)
        elif isinstance(node, Aggregate):
            avail = self._schema_names(node.child, path)
            refs = set()
            for e in node.group_exprs + node.agg_exprs:
                refs |= e.references()
            self._check_refs("Aggregate expressions", refs, avail, path)
            self._check_unique_output(node, path)
        elif isinstance(node, Sort):
            avail = self._schema_names(node.child, path)
            refs = set()
            for e, _asc in node.orders:
                refs |= e.references()
            self._check_refs("Sort keys", refs, avail, path)
        elif isinstance(node, RepartitionByExpr):
            avail = self._schema_names(node.child, path)
            refs = set()
            for e in node.exprs:
                refs |= e.references()
            self._check_refs("Repartition expressions", refs, avail, path)
        elif isinstance(node, Join):
            self._check_join(node, path)
        elif isinstance(node, (Union, BucketUnion)):
            self._check_union(node, path)

        # generic schema resolution LAST, and only when no sharper check
        # already explained this node — the precise code leads the report
        if len(self.violations) == before:
            self._schema_names(node, path)

        children = node.children()
        many = len(children) > 1
        for i, c in enumerate(children):
            seg = f"[{i}]{c.kind}" if many else c.kind
            self.walk(c, f"{path}>{seg}")

    def _check_unique_output(self, node: LogicalPlan, path: str) -> None:
        names = self._schema_names(node, path)
        if names is None:
            return
        seen: set = set()
        for n in names:
            if n in seen:
                self.fail(
                    DUPLICATE_OUTPUT_COLUMN, path,
                    f"output column {n!r} appears more than once",
                )
                return
            seen.add(n)

    # --- node checks ---
    def _check_file_scan(self, scan: FileScan, path: str) -> None:
        spec = scan.prune_spec
        full_names = set(scan.full_schema.names)

        names = [f.name for f in scan.files]
        if not names and not (spec is not None and spec.active):
            self.fail(
                EMPTY_FILE_SCAN, path,
                "scan resolved to zero files and no pruning explains it",
            )
        if len(set(names)) != len(names):
            dups = sorted({n for n in names if names.count(n) > 1})
            self.fail(DUPLICATE_FILE, path, f"duplicate files in scan: {dups}")

        # pushdown/pruning narrows a scan but never invents columns
        if scan.required_columns is not None:
            req = list(scan.required_columns)
            unknown = sorted(set(req) - full_names)
            if unknown:
                self.fail(
                    REQUIRED_COLUMN_UNKNOWN, path,
                    f"required_columns {unknown} not in the relation schema",
                )
            if len(set(req)) != len(req):
                self.fail(
                    DUPLICATE_OUTPUT_COLUMN, path,
                    f"required_columns holds duplicates: {req}",
                )
        if scan.pushed_filter is not None:
            refs = scan.pushed_filter.references()
            self._check_refs(
                "pushed filter", refs, sorted(full_names), path
            )
            if refs - full_names:
                # _check_refs already recorded UNRESOLVED_COLUMN_REF; also
                # record the pushdown-specific code tests/doc key on
                self.fail(
                    PUSHED_FILTER_UNRESOLVED, path,
                    f"pushed filter references {sorted(refs - full_names)} "
                    f"outside the relation schema",
                )
        if scan.bucket_spec is not None:
            missing = sorted(
                set(scan.bucket_spec.bucket_columns) - full_names
            )
            if missing:
                self.fail(
                    BUCKET_SPEC_COLUMN_UNKNOWN, path,
                    f"bucket_spec columns {missing} not in the relation schema",
                )

        # index scans: files must come from the index content set. A
        # sampled scan's files are derived twins — deliberately invisible
        # to content — so the sample checks below own its containment.
        sample = getattr(scan, "sample_spec", None)
        content = self._index_content_files(scan)
        if content is not None and sample is None:
            stray = sorted(set(names) - content)
            if stray:
                self.fail(
                    FILE_NOT_IN_INDEX, path,
                    f"{len(stray)} scan file(s) not in index "
                    f"{scan.index_info.index_name!r} content, e.g. {stray[0]!r}",
                )
        if sample is not None:
            self._check_sample_spec(scan, path)

        if spec is not None:
            self._check_prune_spec(scan, path)

    def _check_prune_spec(self, scan: FileScan, path: str) -> None:
        from ..models.covering import bucket_id_from_filename

        spec = scan.prune_spec
        full_names = set(scan.full_schema.names)

        missing = sorted(
            (set(spec.key_columns) | set(spec.sort_columns)) - full_names
        )
        if missing:
            self.fail(
                PRUNE_SPEC_LAYOUT_MISMATCH, path,
                f"prune_spec columns {missing} not in the relation schema",
            )
        if spec.num_buckets <= 0:
            self.fail(
                PRUNE_SPEC_LAYOUT_MISMATCH, path,
                f"prune_spec.num_buckets={spec.num_buckets} is not positive",
            )

        # the execution hint and the layout contract describe ONE layout
        if scan.bucket_spec is not None:
            if scan.bucket_spec.num_buckets != spec.num_buckets:
                self.fail(
                    PRUNE_SPEC_LAYOUT_MISMATCH, path,
                    f"prune_spec.num_buckets={spec.num_buckets} != "
                    f"bucket_spec.num_buckets={scan.bucket_spec.num_buckets}",
                )
            if tuple(scan.bucket_spec.bucket_columns) != tuple(spec.key_columns):
                self.fail(
                    PRUNE_SPEC_LAYOUT_MISMATCH, path,
                    f"prune_spec.key_columns={list(spec.key_columns)} != "
                    f"bucket_spec.bucket_columns="
                    f"{list(scan.bucket_spec.bucket_columns)}",
                )

        # the spec must agree with the index log entry's metadata layout
        entry = self._index_entry(scan)
        if entry is not None:
            dd = entry.derived_dataset
            nb = getattr(dd, "num_buckets", None)
            if nb is not None and nb != spec.num_buckets:
                self.fail(
                    PRUNE_SPEC_LAYOUT_MISMATCH, path,
                    f"prune_spec.num_buckets={spec.num_buckets} != index "
                    f"metadata num_buckets={nb}",
                )
            try:
                indexed = tuple(dd.indexed_columns())
            except Exception:
                indexed = None
            if indexed is not None and tuple(spec.key_columns) != indexed:
                self.fail(
                    PRUNE_SPEC_LAYOUT_MISMATCH, path,
                    f"prune_spec.key_columns={list(spec.key_columns)} != "
                    f"indexed columns {list(indexed)}",
                )

        # prune decision ⊆ sketch capability: every conjunct routed to the
        # exec-time sidecar stage must be boundable by a sketch the layout
        # DECLARED — a sketch conjunct outside the capability would make
        # the executor consult sketches that cannot exist, i.e. a prune
        # decision with no evidence source behind it
        if spec.sketch_conjuncts:
            from ..models.dataskipping.sketch_store import (
                capability_sketches,
                convertible,
            )

            cap_cols = {
                c.lower() for _k, cols in spec.sketch_capability for c in cols
            }
            sketches = capability_sketches(spec.sketch_capability)
            for conj in spec.sketch_conjuncts:
                refs = {r.lower() for r in conj.references()}
                if not refs <= cap_cols:
                    self.fail(
                        PRUNE_SKETCH_NOT_DECLARED, path,
                        f"sketch conjunct {conj!r} references "
                        f"{sorted(refs - cap_cols)} outside the declared "
                        f"sketch capability columns",
                    )
                    break
                if not convertible(sketches, conj):
                    self.fail(
                        PRUNE_SKETCH_NOT_DECLARED, path,
                        f"sketch conjunct {conj!r} is not boundable by any "
                        f"declared sketch capability "
                        f"({[k for k, _ in spec.sketch_capability]})",
                    )
                    break

        if spec.bucket_keep is not None:
            bad = sorted(
                b for b in spec.bucket_keep
                if not (0 <= b < spec.num_buckets)
            )
            if bad:
                self.fail(
                    PRUNE_BUCKET_OUT_OF_RANGE, path,
                    f"kept bucket ids {bad} outside [0, {spec.num_buckets})",
                )
            for f in scan.files:
                b = bucket_id_from_filename(f.name)
                if b is not None and b not in spec.bucket_keep:
                    self.fail(
                        PRUNE_FILE_NOT_IN_KEEP, path,
                        f"kept file {f.name!r} has bucket id {b} outside the "
                        f"keep set ({sorted(spec.bucket_keep)})",
                    )
                    break

    def _check_sample_spec(self, scan: FileScan, path: str) -> None:
        """A ``SampleSpec`` is a claim: this scan reads the derived sample
        twins of the pinned version at exactly ``spec.fraction``. Check the
        claim against the twin naming convention, the index entry's content
        set, and the sample-store meta — a substitution bug here silently
        changes ANSWERS (wrong scale factor / wrong rows), not just cost."""
        import os

        from ..models import sample_store

        spec = scan.sample_spec
        content = self._index_content_files(scan)

        # every substituted file must BE a twin, at the spec's fraction,
        # of a file in the pinned entry's content set
        for f in scan.files:
            d, base = os.path.split(f.name)
            parsed = sample_store.parse_sample_name(base)
            if parsed is None:
                self.fail(
                    SAMPLE_FILE_NOT_TWIN, path,
                    f"sampled scan reads {f.name!r}, which is not a sample "
                    f"twin at all",
                )
                return
            frac, base_name = parsed
            if sample_store.fraction_ppm(frac) != spec.ppm:
                self.fail(
                    SAMPLE_FILE_NOT_TWIN, path,
                    f"twin {base!r} carries fraction {frac} but the scan's "
                    f"SampleSpec declares {spec.fraction}",
                )
                return
            if content is not None and os.path.join(d, base_name) not in content:
                self.fail(
                    SAMPLE_FILE_NOT_TWIN, path,
                    f"twin {base!r} derives from {base_name!r}, which is not "
                    f"in index {scan.index_info.index_name!r} content — a "
                    f"twin of a vacuumed or foreign data file",
                )
                return

        # the pinned version must actually have twins at this fraction
        if content is not None:
            declared = any(
                os.path.exists(sample_store.sample_path(p, spec.fraction))
                for p in content
            )
            if not declared:
                self.fail(
                    SAMPLE_NOT_DECLARED, path,
                    f"SampleSpec(fraction={spec.fraction}) on a scan of "
                    f"index {scan.index_info.index_name!r}, but no content "
                    f"file of the pinned version has a sample twin at that "
                    f"fraction",
                )
                return

        # spec fraction must agree with the sample-store meta written for
        # the pinned version: a tier absent from a file's ``kept`` map was
        # never materialized for that file
        for f in scan.files:
            d, base = os.path.split(f.name)
            parsed = sample_store.parse_sample_name(base)
            if parsed is None:
                continue
            base_path = os.path.join(d, parsed[1])
            meta = sample_store.load_sample_meta(base_path)
            if meta is not None and str(spec.ppm) not in meta.get("kept", {}):
                self.fail(
                    SAMPLE_FRACTION_MISMATCH, path,
                    f"SampleSpec fraction {spec.fraction} (ppm={spec.ppm}) "
                    f"is not among the tiers the sample store materialized "
                    f"for {parsed[1]!r} "
                    f"(kept: {sorted(meta.get('kept', {}))})",
                )
                return

    def _check_join(self, join: Join, path: str) -> None:
        left_names = self._schema_names(join.left, path)
        right_names = self._schema_names(join.right, path)
        if join.condition is not None and (
            left_names is not None and right_names is not None
        ):
            self._check_refs(
                "Join condition", join.condition.references(),
                left_names + right_names, path,
            )
        # bucketed-join hint consistency: when BOTH sides carry bucketed
        # index relations, the bucket counts must zip 1:1
        left_nb = self._side_bucket_counts(join.left)
        right_nb = self._side_bucket_counts(join.right)
        if left_nb and right_nb and left_nb != right_nb:
            self.fail(
                JOIN_BUCKET_MISMATCH, path,
                f"left side bucket counts {sorted(left_nb)} != right side "
                f"{sorted(right_nb)} — the co-partitioned zip is unsound",
            )

    @staticmethod
    def _side_bucket_counts(side: LogicalPlan) -> set:
        out = set()
        for n in side.preorder():
            if isinstance(n, FileScan) and n.bucket_spec is not None:
                out.add(n.bucket_spec.num_buckets)
            elif isinstance(n, BucketUnion):
                out.add(n.bucket_spec.num_buckets)
        return out

    def _check_union(self, node: LogicalPlan, path: str) -> None:
        # executor contract: the union's output schema is child [0]'s, and
        # every other child is aligned to it BY NAME (executor.py selects
        # batches[0].schema.names) — so later children must emit a superset
        # of child [0]'s columns; hybrid scan's appended side legitimately
        # carries extra (un-pruned) index columns
        schemas = []
        for c in node.children():
            names = self._schema_names(c, path)
            if names is None:
                return
            schemas.append(names)
        first = schemas[0]
        for i, other in enumerate(schemas[1:], start=1):
            missing = sorted(set(first) - set(other))
            if missing:
                self.fail(
                    UNION_SCHEMA_MISMATCH, path,
                    f"child [{i}] emits {other} and is missing {missing} of "
                    f"child [0]'s output {first}",
                )
                return
        if isinstance(node, BucketUnion):
            for i, c in enumerate(node.children()):
                for n in c.preorder():
                    if (
                        isinstance(n, FileScan)
                        and n.bucket_spec is not None
                        and n.bucket_spec.num_buckets
                        != node.bucket_spec.num_buckets
                    ):
                        self.fail(
                            JOIN_BUCKET_MISMATCH, path,
                            f"BucketUnion child [{i}] scan has "
                            f"{n.bucket_spec.num_buckets} buckets, union "
                            f"declares {node.bucket_spec.num_buckets}",
                        )


def verify_plan(
    plan: LogicalPlan,
    session: "Optional[HyperspaceSession]" = None,
    raise_on_violation: bool = True,
) -> list[Violation]:
    """Check every structural invariant of ``plan``.

    Returns the violation list (empty = sound); with
    ``raise_on_violation`` (the default) a non-empty list raises
    :class:`PlanInvariantError` instead. Always feeds the
    ``staticcheck.plan.*`` counters.
    """
    from ..telemetry import trace

    with trace.span("staticcheck:plan"):
        checker = _Checker(session)
        checker.walk(plan, plan.kind)
    REGISTRY.counter("staticcheck.plan.runs").inc()
    REGISTRY.counter("staticcheck.plan.nodes").inc(checker.nodes)
    if checker.violations:
        REGISTRY.counter("staticcheck.plan.violations").inc(
            len(checker.violations)
        )
        for v in checker.violations:
            REGISTRY.counter(f"staticcheck.plan.violation.{v.code}").inc()
        if raise_on_violation:
            raise PlanInvariantError(checker.violations)
    return checker.violations


def verify_enabled() -> bool:
    return env.env_bool("HYPERSPACE_VERIFY_PLAN")


def maybe_verify_plan(
    plan: LogicalPlan, session: "Optional[HyperspaceSession]" = None
) -> None:
    """The ``HYPERSPACE_VERIFY_PLAN=1`` hook ``DataFrame.optimized_plan``
    calls after ``apply_pruning`` — a no-op (one env read) when disabled."""
    if verify_enabled():
        verify_plan(plan, session, raise_on_violation=True)
