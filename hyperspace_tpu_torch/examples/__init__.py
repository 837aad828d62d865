"""Walkthroughs of the port (counterparts of the reference repo's
``examples/``): the same steps, data and printed checks, over
``HyperspaceSession(..., device=...)``. Each runs on the card unless
given ``--device cpu``, and each has a ``main(device=None)`` to call
in-process:

    python -m hyperspace_tpu_torch.examples.quickstart [--device cpu]
    python -m hyperspace_tpu_torch.examples.tour [--device cpu]
    python -m hyperspace_tpu_torch.examples.layout_analysis [--device cpu]
    python -m hyperspace_tpu_torch.examples.nested_and_iceberg [--device cpu]
    python -m hyperspace_tpu_torch.examples.snapshots_and_hybrid_scan [--device cpu]

Each also holds its main query to the same query with Hyperspace off and
raises if they differ.
"""

from __future__ import annotations

import argparse

from ..tools import _common
from ..tools.differential import canon, rows_close

REL_TOL = 1e-4
EXAMPLES = ("quickstart", "tour", "layout_analysis", "nested_and_iceberg",
            "snapshots_and_hybrid_scan")


def cli(main, doc: str, argv=None) -> None:
    """Parse ``--device`` (and ``--workdir``) and run ``main``."""
    p = argparse.ArgumentParser(description=doc.strip().split("\n")[0])
    _common.add_device_flag(p)
    p.add_argument("--workdir", default=None,
                   help="directory for the example's workspace (default: a temporary one)")
    args = p.parse_args(argv)
    main(device=_common.resolve_device(args.device), workdir=args.workdir)


def same_rows(session, df) -> dict:
    """``df``'s rows with Hyperspace as the session has it, checked equal
    to the same query with Hyperspace off (canonical rows; floats within
    relative 1e-4, the device tier's f32 sums against the host's f64);
    the session's setting is kept."""
    was_on = session.is_hyperspace_enabled()
    got = df.to_pydict()
    session.disable_hyperspace()
    try:
        raw = df.to_pydict()
    finally:
        if was_on:
            session.enable_hyperspace()
    if not rows_close(canon(got), canon(raw), REL_TOL):
        raise AssertionError(f"indexed answer {got} differs from the raw answer {raw}")
    return got
