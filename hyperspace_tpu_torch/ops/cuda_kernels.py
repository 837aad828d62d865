"""Hand-written CUDA kernels for Hopper, built with nvcc and bound with
ctypes: the counterpart of hyperspace_tpu/ops/pallas_kernels.py.

| wrapper                    | CUDA source             | replaces (Pallas TPU kernel)              |
|----------------------------|-------------------------|-------------------------------------------|
| filter_weighted_sum        | csrc/filter_reduce.cu   | pallas_kernels.filter_weighted_sum        |
| filter_sum                 | csrc/filter_reduce.cu   | pallas_kernels.filter_sum                 |
| filter_grouped_multi_sum   | csrc/grouped_sum.cu     | pallas_kernels.filter_grouped_multi_sum   |
| filter_grouped_sum         | (the above with k = 1)  | pallas_kernels.filter_grouped_sum         |
| masked_min_max             | csrc/minmax.cu          | pallas_kernels.masked_min_max             |

Each wrapper takes tensors on one device. For CPU tensors it runs the plain
PyTorch version in ops/reference.py and counts a plain call. For CUDA tensors
it checks device, dtype, shape and contiguity, launches the kernel on the
current stream, raises KernelError on a non-zero CUDA status, and counts a
launch. It never falls back from the card to the host.

Outputs that a kernel writes in full are allocated with ``torch.empty``.
Each launch is two kernels: a first pass that leaves one partial per block,
and a fold of the partials in block order, so no float atomics are used and
two launches on the same inputs give the same bits. The first pass's grid,
and so the partials' size, is what the library reports for the device
(``hs_*_partial_*``): filter_sum and filter_grouped_multi_sum run a
persistent grid of a few blocks per SM that loads 16 rows a thread per step
through 4- and 16-byte words, and take the kernel's own scalar loop for
inputs that are not so aligned; filter_weighted_sum and masked_min_max
keep a grid of up to 1024 blocks with one row per thread in flight. The
source notes in ``csrc/`` say what bounds each kernel and why it is built
as it is.

The sources compile at first use, one nvcc per source, all started
together, into ``build/kernels/`` beside the package (a directory git
ignores); the file name carries a hash of the source, so an edited kernel
rebuilds. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

import torch

from . import reference
from ..exceptions import KernelError

MAX_GROUPS = 16  # _MAX_PALLAS_GROUPS: the grouped kernel's group slots

_CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("filter_reduce.cu", "grouped_sum.cu", "minmax.cu")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

# launches of each CUDA kernel, and calls served by the plain version for
# CPU tensors; reset_counts() zeroes both
LAUNCHES = {"filter_weighted_sum": 0, "filter_sum": 0, "filter_grouped_multi_sum": 0,
            "masked_min_max": 0}
PLAIN_CALLS = dict.fromkeys(LAUNCHES, 0)

# nvcc's output per source from the last build (ptxas register/spill report)
BUILD_LOG: dict[str, str] = {}

_build_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME); CUDA kernels cannot be built")
    return found


def _lib_path(source: str) -> Path:
    text = (_CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha1(text).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def _declare(lib: ctypes.CDLL) -> None:
    for name, args in (("hs_filter_partial_slots", [_I]),
                       ("hs_grouped_partial_blocks", [_I, _I]),
                       ("hs_grouped_max_measures", []), ("hs_grouped_slots", []),
                       ("hs_minmax_partial_slots", [])):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = _I
    if hasattr(lib, "hs_filter_weighted_sum"):
        lib.hs_filter_weighted_sum.argtypes = [_I, _P, _P, _P, _LL, _P, _P, _P, _P, _P]
        lib.hs_filter_weighted_sum.restype = _I
        lib.hs_filter_sum.argtypes = [_I, _P, _P, _LL, _P, _P, _P, _P, _P]
        lib.hs_filter_sum.restype = _I
    if hasattr(lib, "hs_filter_grouped_multi_sum"):
        lib.hs_filter_grouped_multi_sum.argtypes = [
            _I, _P, _P, ctypes.POINTER(_P), _I, _LL, _P, _P, _P, _P, _P,
        ]
        lib.hs_filter_grouped_multi_sum.restype = _I
    if hasattr(lib, "hs_masked_min_max"):
        lib.hs_masked_min_max.argtypes = [_I, _P, _P, _LL, _P, _P, _P, _P]
        lib.hs_masked_min_max.restype = _I


def build_kernels() -> float:
    """Compile every source not yet built (one nvcc each, in parallel) and
    load all of them; returns the seconds spent. Raises KernelError with
    nvcc's output when a build fails."""
    with _build_lock:
        t0 = time.perf_counter()
        todo = [s for s in SOURCES if s not in _libs]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in todo:
            out = _lib_path(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failures = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOG[src] = log
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {src} (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
        if failures:
            raise KernelError("\n".join(failures))
        for src in todo:
            lib = ctypes.CDLL(str(_lib_path(src)))
            _declare(lib)
            _libs[src] = lib
        return time.perf_counter() - t0


def _lib(source: str) -> ctypes.CDLL:
    if source not in _libs:
        build_kernels()
    return _libs[source]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, n: int, device) -> None:
    if t.device != device:
        raise KernelError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise KernelError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or t.shape[0] != n:
        raise KernelError(f"{name}: shape {tuple(t.shape)}, expected ({n},)")
    if not t.is_contiguous():
        raise KernelError(f"{name}: not contiguous")


def _raise_on(kernel: str, rc: int) -> None:
    if rc != 0:
        raise KernelError(f"{kernel}: CUDA launch failed with cudaError {rc}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _partial_slots(kernel: str, slots: int) -> int:
    """A library's partial count for a grid, or KernelError when the library
    reported a CUDA error (negative) instead."""
    if slots <= 0:
        raise KernelError(f"{kernel}: sizing the partials failed with cudaError {-slots}")
    return slots


def filter_weighted_sum(pred: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """(sum of x*y over rows where pred, as f32; count(pred), as int32),
    both 0-d tensors on pred's device. pred bool[n]; x, y float32[n]."""
    if pred.device.type == "cpu":
        PLAIN_CALLS["filter_weighted_sum"] += 1
        return reference.filter_weighted_sum(pred, x, y)
    n = pred.shape[0] if pred.dim() == 1 else -1
    for nm, t, dt in (("pred", pred, torch.bool), ("x", x, torch.float32),
                      ("y", y, torch.float32)):
        _check(f"filter_weighted_sum.{nm}", t, dt, n, pred.device)
    return _launch_filter("filter_weighted_sum", pred, (x, y))


def filter_sum(pred: torch.Tensor, x: torch.Tensor):
    """(sum of x over rows where pred, as f32; count(pred), as int32)."""
    if pred.device.type == "cpu":
        PLAIN_CALLS["filter_sum"] += 1
        return reference.filter_sum(pred, x)
    n = pred.shape[0] if pred.dim() == 1 else -1
    _check("filter_sum.pred", pred, torch.bool, n, pred.device)
    _check("filter_sum.x", x, torch.float32, n, pred.device)
    return _launch_filter("filter_sum", pred, (x,))


def _launch_filter(name: str, pred: torch.Tensor, xs: tuple):
    dev = pred.device
    n = pred.shape[0]
    if n == 0:
        return (torch.zeros((), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    out_s = torch.empty((), dtype=torch.float32, device=dev)
    out_c = torch.empty((), dtype=torch.int32, device=dev)
    lib = _lib("filter_reduce.cu")
    slots = _partial_slots(name, lib.hs_filter_partial_slots(dev.index))
    part_s = torch.empty(slots, dtype=torch.float32, device=dev)
    part_c = torch.empty(slots, dtype=torch.int32, device=dev)
    tail = (part_s.data_ptr(), part_c.data_ptr(), out_s.data_ptr(), out_c.data_ptr(),
            _stream(dev))
    if name == "filter_weighted_sum":
        rc = lib.hs_filter_weighted_sum(
            dev.index, pred.data_ptr(), xs[0].data_ptr(), xs[1].data_ptr(), n, *tail
        )
    else:
        rc = lib.hs_filter_sum(dev.index, pred.data_ptr(), xs[0].data_ptr(), n, *tail)
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    return out_s, out_c


def filter_grouped_multi_sum(
    pred: torch.Tensor, gids: torch.Tensor, xs: Sequence[torch.Tensor], num_groups: int
):
    """Per-group sums of each measure in ``xs`` plus the shared count over
    rows where pred, for a group domain of at most 16: returns (tuple of
    f32[num_groups], int32[num_groups]). ``xs`` may be empty. Rows whose gid
    lies outside [0, num_groups) count nowhere."""
    if not 1 <= num_groups <= MAX_GROUPS:
        raise KernelError(
            f"filter_grouped_multi_sum: num_groups {num_groups} outside [1, {MAX_GROUPS}]"
        )
    xs = tuple(xs)
    if pred.device.type == "cpu":
        PLAIN_CALLS["filter_grouped_multi_sum"] += 1
        return reference.filter_grouped_multi_sum(pred, gids, xs, num_groups)
    dev = pred.device
    n = pred.shape[0] if pred.dim() == 1 else -1
    _check("filter_grouped_multi_sum.pred", pred, torch.bool, n, dev)
    _check("filter_grouped_multi_sum.gids", gids, torch.int32, n, dev)
    for i, x in enumerate(xs):
        _check(f"filter_grouped_multi_sum.xs[{i}]", x, torch.float32, n, dev)
    if n == 0:
        return (
            tuple(torch.zeros(num_groups, dtype=torch.float32, device=dev) for _ in xs),
            torch.zeros(num_groups, dtype=torch.int32, device=dev),
        )
    lib = _lib("grouped_sum.cu")
    slots = lib.hs_grouped_slots()
    per_pass = lib.hs_grouped_max_measures()
    sums: list[torch.Tensor] = []
    counts = None
    # more measures than one launch takes run as several passes; the counts
    # of the first pass serve all of them
    for start in range(0, max(len(xs), 1), per_pass):
        chunk = xs[start:start + per_pass]
        k = len(chunk)
        blocks = _partial_slots("filter_grouped_multi_sum",
                                lib.hs_grouped_partial_blocks(dev.index, k))
        part_c = torch.empty(blocks * slots, dtype=torch.int32, device=dev)
        part_s = torch.empty(max(1, blocks * k * slots), dtype=torch.float32, device=dev)
        out_s = torch.empty(max(1, k * slots), dtype=torch.float32, device=dev)
        out_c = torch.empty(slots, dtype=torch.int32, device=dev)
        ptrs = (_P * per_pass)(*([x.data_ptr() for x in chunk] + [None] * (per_pass - k)))
        rc = lib.hs_filter_grouped_multi_sum(
            dev.index, pred.data_ptr(), gids.data_ptr(), ptrs, k, n,
            part_s.data_ptr(), part_c.data_ptr(), out_s.data_ptr(), out_c.data_ptr(),
            _stream(dev),
        )
        _raise_on("filter_grouped_multi_sum", rc)
        LAUNCHES["filter_grouped_multi_sum"] += 1
        if counts is None:
            counts = out_c[:num_groups]
        sums.extend(out_s[: k * slots].view(k, slots)[:, :num_groups].unbind(0))
    return tuple(sums), counts


def filter_grouped_sum(pred: torch.Tensor, gids: torch.Tensor, x: torch.Tensor,
                       num_groups: int):
    """Per-group sum of x and count over rows where pred, for a group domain
    of at most 16: (f32[num_groups], int32[num_groups]). The grouped kernel
    with one measure, as the JAX package's filter_grouped_sum is; its
    launches and plain calls count under filter_grouped_multi_sum."""
    sums, counts = filter_grouped_multi_sum(pred, gids, (x,), num_groups)
    return sums[0], counts


def masked_min_max(x: torch.Tensor, valid: torch.Tensor):
    """(min, max) of x over the rows where valid, as 0-d f32 tensors on x's
    device; (+inf, -inf) when no row is valid. x is any numeric dtype and is
    cast to f32 first, as the Pallas kernel casts it. A NaN in a valid row
    makes the result NaN (jnp.minimum/jnp.maximum semantics)."""
    if x.device.type == "cpu":
        PLAIN_CALLS["masked_min_max"] += 1
        return reference.masked_min_max(x, valid)
    dev = x.device
    n = x.shape[0] if x.dim() == 1 else -1
    xf = x.to(torch.float32).contiguous()
    _check("masked_min_max.x", xf, torch.float32, n, dev)
    _check("masked_min_max.valid", valid, torch.bool, n, dev)
    if n == 0:
        return (torch.full((), float("inf"), dtype=torch.float32, device=dev),
                torch.full((), float("-inf"), dtype=torch.float32, device=dev))
    out = torch.empty(2, dtype=torch.float32, device=dev)
    lib = _lib("minmax.cu")
    slots = lib.hs_minmax_partial_slots()
    part_mn = torch.empty(slots, dtype=torch.float32, device=dev)
    part_mx = torch.empty(slots, dtype=torch.float32, device=dev)
    rc = lib.hs_masked_min_max(
        dev.index, xf.data_ptr(), valid.data_ptr(), n, part_mn.data_ptr(),
        part_mx.data_ptr(), out.data_ptr(), _stream(dev),
    )
    _raise_on("masked_min_max", rc)
    LAUNCHES["masked_min_max"] += 1
    return out[0], out[1]
