"""Time masked_min_max's CUDA kernel from two source trees, in turns, on one card.

    python3 -m hyperspace_tpu_torch.benchmark.minmax_turns --other DIR [--rows N]

Builds ``ops/csrc/minmax.cu`` of this checkout (as the wrapper builds it)
and of the tree at DIR (for example a ``git archive`` of another commit)
with the same nvcc flags into ``build/kernels/``, calls each library's
``hs_masked_min_max`` on the same inputs (``--rows`` f32 values and a
random valid mask), requires the two results to be the same bits, and
prints one JSON line per reading: the device time of one call, as CUDA
events around 50 back-to-back launches over 50, in the order other, this,
this, other, twice. The last line holds each tree's median, the bytes
bound (n * 5 bytes over 3.35 TB/s) and the card's name and power limit
from nvidia-smi. Needs one NVIDIA GPU and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import cuda_kernels as K

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published HBM3 rate
LAUNCHES = 50
SLOTS = 1 << 16  # partial slots, more than either tree's first pass writes
TURNS = ("other", "this", "this", "other") * 2


def _build(source: Path) -> ctypes.CDLL:
    text = source.read_bytes() + " ".join(K.NVCC_FLAGS).encode()
    out = K.BUILD_DIR / f"libminmax-turns-{hashlib.sha1(text).hexdigest()[:12]}.so"
    if not out.exists():
        K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-o", str(out), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise K.KernelError(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.hs_masked_min_max.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2 + [
        ctypes.c_longlong] + [ctypes.c_void_p] * 4
    lib.hs_masked_min_max.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, help="root of the other source tree")
    ap.add_argument("--rows", type=int, default=1 << 26)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("minmax_turns: torch.cuda.is_available() is false; this needs the card",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    csrc = Path(K.__file__).resolve().with_name("csrc") / "minmax.cu"
    other = Path(args.other) / "hyperspace_tpu_torch" / "ops" / "csrc" / "minmax.cu"
    libs = {"this": _build(csrc), "other": _build(other)}

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    n = args.rows
    x = (torch.rand(n, generator=gen, device=dev) - 0.5) * 2000
    valid = torch.rand(n, generator=gen, device=dev) < 0.5
    bufs = {k: torch.empty(2 * SLOTS + 2, dtype=torch.float32, device=dev) for k in libs}
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(tree: str) -> None:
        base = bufs[tree].data_ptr()
        rc = libs[tree].hs_masked_min_max(0, x.data_ptr(), valid.data_ptr(), n, base,
                                          base + 4 * SLOTS, base + 8 * SLOTS, stream)
        if rc != 0:
            raise K.KernelError(f"{tree}: CUDA launch failed with cudaError {rc}")

    for tree in libs:
        call(tree)
    torch.cuda.synchronize()
    got = {k: b[2 * SLOTS:].view(torch.int32) for k, b in bufs.items()}
    if not torch.equal(got["this"], got["other"]):
        raise RuntimeError(f"the trees disagree: {got}")

    times: dict[str, list[float]] = {"this": [], "other": []}
    for tree in TURNS:
        for _ in range(3):
            call(tree)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LAUNCHES):
            call(tree)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / LAUNCHES
        times[tree].append(ms)
        print(json.dumps({"tree": tree, "device_ms": ms, "n": n, "card": card}), flush=True)
    bound_ms = n * 5 / HBM_BYTES_PER_S * 1e3
    print(json.dumps({"n": n, "bound_ms": bound_ms, "card": card,
                      "other": os.path.abspath(args.other),
                      **{f"{k}_median_ms": statistics.median(v) for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
