"""The differential soak: N random queries over the host, device and mesh
tiers, with a hybrid-scan mix, must match their raw answers within the
engine's float contract (counterpart of the reference repo's
``tools/differential_soak.py``, its release gate).

The world, indexes and appended file are the reference soak's. Seed s runs
``random_query(s)`` on tier ``s % 3``: the host, the device tier, or the
mesh route over ``virtual_devices(8, device)`` (hierarchical, 2 slices, on
odd seeds); hybrid scan is on where ``s % 5 == 4``. The reference closes
by asserting its device breaker never latched; the port has none, so a
device fault raises inside its seed, and a seed that raises counts as a
failure beside the mismatches.

    python -m hyperspace_tpu_torch.tools.differential_soak [N] [--device cpu]

Prints one JSON line; exit 0 iff no seed mismatched or raised.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time

import numpy as np

from .. import constants as C
from ..parallel.mesh import virtual_devices
from . import _common
from .differential import MESH_DEVICES, build_world, canon, random_query, rows_close, set_tier

TIERS = ("host", "device", "mesh")


def soak(session, root: str, seeds, device, max_failures: int = 4) -> dict:
    """Run ``seeds`` over a world built by ``build_world(soak=True)``;
    stops after ``max_failures`` failures, as the reference stops after
    four mismatches."""
    by_tier = {t: {"seeds": 0, "mismatches": 0, "errors": 0} for t in TIERS}
    hybrid = 0
    failures: list = []
    t0 = time.perf_counter()
    with virtual_devices(MESH_DEVICES, device):
        for seed in seeds:
            tier = TIERS[seed % 3]
            set_tier(session, tier, 2 if tier == "mesh" and seed % 2 else 1)
            session.set_conf(C.HYBRID_SCAN_ENABLED, seed % 5 == 4)
            hybrid += seed % 5 == 4
            by_tier[tier]["seeds"] += 1
            try:
                q = random_query(session, root, np.random.default_rng(seed))
                session.disable_hyperspace()
                expect = canon(q.to_pydict())
                session.enable_hyperspace()
                got = canon(q.to_pydict())
            except Exception as e:  # noqa: BLE001 - a raising seed fails the gate
                by_tier[tier]["errors"] += 1
                failures.append({"seed": seed, "tier": tier, "error": repr(e)})
            else:
                if not rows_close(got, expect):
                    by_tier[tier]["mismatches"] += 1
                    failures.append({"seed": seed, "tier": tier, "error": "mismatch"})
            finally:
                session.disable_hyperspace()
            if len(failures) >= max_failures:
                break
    set_tier(session, "host")
    session.set_conf(C.HYBRID_SCAN_ENABLED, False)
    return {"seeds": sum(t["seeds"] for t in by_tier.values()), "hybrid_seeds": hybrid,
            "by_tier": by_tier, "mismatches": sum(t["mismatches"] for t in by_tier.values()),
            "errors": sum(t["errors"] for t in by_tier.values()), "failures": failures,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_seeds", nargs="?", type=int, default=2500)
    _common.add_device_flag(p)
    args = p.parse_args(argv)
    device = _common.resolve_device(args.device)
    root = tempfile.mkdtemp(prefix="hs_soak_")
    try:
        session = build_world(root, device, soak=True)
        out = soak(session, root, range(args.n_seeds), device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["device"] = str(device)
    out["ok"] = not out["failures"]
    _common.emit(out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
