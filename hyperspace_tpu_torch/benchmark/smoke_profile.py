"""Where a whole ``chip_smoke.py`` run spends its seconds: the smoke's
``main()`` run under a stack sampler of the main thread.

Run from the root of a checkout, on the machine with the card:

    python3 -m hyperspace_tpu_torch.benchmark.smoke_profile [--interval S]

A daemon thread reads the main thread's stack every ``--interval`` seconds
(0.1 by default; ``sys._current_frames``, so the smoke runs unchanged and
at its own speed) and counts, per sample: every line of ``chip_smoke.py``
on the stack (inclusive seconds per smoke line), every function of the
port on it, the deepest smoke line beside the deepest port function, and
the innermost frame. Counts times the interval are seconds. They go to
``chiprun_out/smoke_profile.json``; the smoke's own output is unchanged,
and the exit code is the smoke's.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import runpy
import sys
import threading
import time

from ..utils.workers import spawn_thread

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sample(main_id: int, interval: float, stop: threading.Event, counts: dict) -> None:
    while not stop.wait(interval):
        f = sys._current_frames().get(main_id)
        frames = []
        while f is not None:
            frames.append((f.f_code.co_filename, f.f_code.co_name, f.f_lineno))
            f = f.f_back
        if not frames:
            continue
        smoke = [(n, line) for fn, n, line in frames if fn.endswith("chip_smoke.py")]
        port = [(fn.split("hyperspace_tpu_torch/")[-1], n) for fn, n, _ in frames
                if "hyperspace_tpu_torch" in fn]
        for k in {f"{n}:{line}" for n, line in smoke}:
            counts["smoke_lines"][k] += 1
        for k in {f"{a}:{b}" for a, b in port}:
            counts["port_functions"][k] += 1
        deep_smoke = f"{smoke[0][0]}:{smoke[0][1]}" if smoke else "-"
        deep_port = f"{port[0][0]}:{port[0][1]}" if port else "-"
        counts["deepest"][f"{deep_smoke} | {deep_port}"] += 1
        fn, n, line = frames[0]
        counts["innermost"][f"{os.path.basename(fn)}:{n}:{line}"] += 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--interval", type=float, default=0.1, help="seconds between samples")
    args = ap.parse_args()
    counts = {k: collections.Counter()
              for k in ("smoke_lines", "port_functions", "deepest", "innermost")}
    stop = threading.Event()
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    sampler = spawn_thread(_sample, "hs-smoke-profile",
                           args=(threading.main_thread().ident, args.interval, stop, counts))
    rc = 1
    try:
        sys.argv = ["chip_smoke.py"]
        rc = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"), run_name="smoke")["main"]()
    finally:
        stop.set()
        sampler.join()
        out = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "smoke_profile.json"), "w") as f:
            json.dump({"interval_s": args.interval, "wall_s": time.perf_counter() - t0,
                       **{k: [[name, c * args.interval] for name, c in v.most_common(400)]
                          for k, v in counts.items()}}, f, indent=0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
