"""Device traffic accounting: dispatches, fetches, uploads and their bytes
(counterpart of hyperspace_tpu/utils/rpc_meter.py).

The execution paths record each device dispatch (one call into a device
body or a hand-written kernel, at the JAX package's ``record_dispatch``
sites; not each CUDA kernel that a torch body launches), each blocking
device-to-host fetch (``device_get``) and each real host-to-device
transfer. Spans (telemetry/trace.py) carry the meter's deltas, and a
caller can take the delta around a block with ``METER.measure()``.

``record_dispatch``, ``record_upload`` and ``device_get`` are also the
fault injection points ``device.dispatch``, ``device.upload`` and
``device.fetch`` (utils/faults.py), as in the JAX package. An injected
device fault raises: the port has no breaker to absorb it.

Thread-safe: one lock and a few integer adds per event.
"""

from __future__ import annotations

import threading

from . import faults


def _tree_nbytes(value) -> int:
    if isinstance(value, (tuple, list)):
        return sum(_tree_nbytes(v) for v in value)
    if isinstance(value, dict):
        return sum(_tree_nbytes(v) for v in value.values())
    return getattr(value, "nbytes", 0)


class RpcMeter:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.dispatches = 0  # device body or kernel calls
        self.fetches = 0  # blocking device-to-host copies
        self.uploads = 0  # host-to-device transfers
        self.upload_bytes = 0
        self.fetch_bytes = 0

    def record_dispatch(self, n: int = 1) -> None:
        faults.fire("device.dispatch")
        with self._lock:
            self.dispatches += n

    def record_upload(self, nbytes: int, n: int = 1) -> None:
        faults.fire("device.upload")
        with self._lock:
            self.uploads += n
            self.upload_bytes += nbytes
        if self is METER:
            from ..telemetry.metrics import REGISTRY

            REGISTRY.counter("rpc.upload_bytes").inc(nbytes)

    def record_fetch(self, nbytes: int, n: int = 1) -> None:
        with self._lock:
            self.fetches += n
            self.fetch_bytes += nbytes
        if self is METER:
            from ..telemetry.metrics import REGISTRY

            REGISTRY.counter("rpc.fetch_bytes").inc(nbytes)

    def snapshot(self) -> dict:
        # all five counters under the lock the writers hold: a consistent cut
        with self._lock:
            return {
                "dispatches": self.dispatches,
                "fetches": self.fetches,
                "uploads": self.uploads,
                "upload_bytes": self.upload_bytes,
                "fetch_bytes": self.fetch_bytes,
            }

    @staticmethod
    def delta(before: dict, after: dict) -> dict:
        return {k: after[k] - before[k] for k in before}

    def delta_since(self, before: dict) -> dict:
        return self.delta(before, self.snapshot())

    def measure(self) -> "MeterDelta":
        """Context manager capturing the meter delta around a block:

            with METER.measure() as m:
                run_query()
            print(m.delta["dispatches"])
        """
        return MeterDelta(self)


class MeterDelta:
    def __init__(self, meter: RpcMeter):
        self._meter = meter
        self._before: dict = {}
        self.delta: dict = {}

    def __enter__(self) -> "MeterDelta":
        self._before = self._meter.snapshot()
        return self

    def __exit__(self, *exc) -> bool:
        self.delta = self._meter.delta_since(self._before)
        return False


METER = RpcMeter()


def _to_host(tree):
    if isinstance(tree, tuple):
        return tuple(_to_host(v) for v in tree)
    if isinstance(tree, list):
        return [_to_host(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):  # a torch.Tensor
        return tree.detach().cpu().numpy()
    return tree


def device_get(tree):
    """The one blocking device-to-host fetch: every tensor of ``tree``
    (tuples, lists and dicts nest) comes back as a numpy array, in a
    ``fetch`` span when tracing is on, and the meter counts one fetch of
    the returned bytes; a running query is charged its ``fetch`` phase."""
    from ..telemetry import attribution, trace

    with trace.span("fetch"), attribution.phase("fetch"):
        faults.fire("device.fetch")
        out = _to_host(tree)
        nbytes = _tree_nbytes(out)
        METER.record_fetch(nbytes)
        trace.add_attr("nbytes", nbytes)
    return out
