"""Skew-aware bucket-to-device placement for mesh execution (counterpart of
hyperspace_tpu/parallel/placement.py).

Covering indexes bucket both join sides alike, so bucket work units (the
band-wave items of plan/device_join.py, the streamed chunks of
plan/gpu_exec.py) are independent: any device may compute any unit, and
the host fold reassembles results in bucket and chunk order, bit for bit
the one-device results. This module decides only where each unit runs,
never what runs.

The policy: the join memory planner's per-bucket footer estimates predict
each bucket's decoded bytes. A bucket above the per-device fair share
splits into as many ranges as shares it covers (its probe chunks rotate
through them), and every range is packed, largest first, onto the least
loaded device. Buckets with no estimate take a round robin from the
query's home device, counted in ``mesh.placement.fallbacks``. Everything
is a pure function of the estimates and the device count.

Off by default: ``HYPERSPACE_MESH=1`` turns it on, over every visible
device (``HYPERSPACE_MESH_DEVICES`` caps them); with fewer than two
devices it stays off. The tests and the smoke drive it over
``parallel/mesh.virtual_devices``.
"""

from __future__ import annotations

import math
from typing import Optional

from ..telemetry import trace
from ..telemetry.metrics import REGISTRY
from ..utils import env


def mesh_enabled() -> bool:
    """``HYPERSPACE_MESH=1``: the placement switch."""
    return env.env_bool("HYPERSPACE_MESH")


def mesh_devices() -> list:
    """The devices placement may target: ``[]`` when the knob is off or
    fewer than two devices are visible."""
    if not mesh_enabled():
        return []
    try:
        cap = env.env_int("HYPERSPACE_MESH_DEVICES")
    except ValueError:
        cap = 0
    from .mesh import visible_devices

    devices = visible_devices(cap)
    return devices if len(devices) >= 2 else []


def mesh_size() -> int:
    return len(mesh_devices())


def _query_offset() -> int:
    """The serving scheduler's home device of the running query (its
    least-occupied ordinal at admission): the round robin and the packing's
    ties start there, so concurrent queries spread across the mesh."""
    from ..serve.context import current_query

    q = current_query()
    home = getattr(q, "device_home", None) if q is not None else None
    return int(home) if home is not None else 0


class Placement:
    """An immutable bucket-to-device assignment. ``chunk`` indexes a split
    bucket's probe chunks: a bucket packed into k ranges rotates its chunks
    through its k ordinals; a bucket with no estimate takes the round
    robin from the query's offset."""

    __slots__ = ("devices", "_units", "_offset")

    def __init__(self, devices: list, units: dict, offset: int):
        self.devices = devices
        self._units = units  # bucket -> tuple of ordinals, in range order
        self._offset = offset

    def ordinal_for(self, bucket: int, chunk: int = 0) -> int:
        ords = self._units.get(bucket)
        if ords is None:
            REGISTRY.counter("mesh.placement.fallbacks").inc()
            return (bucket + chunk + self._offset) % len(self.devices)
        return ords[chunk % len(ords)]

    def device_for(self, bucket: int, chunk: int = 0):
        return self.devices[self.ordinal_for(bucket, chunk)]

    def slot_for(self, bucket: int, chunk: int = 0) -> tuple:
        """The ``(ordinal, device)`` pair a band item carries into
        ``_BandScheduler.add``; hashable, so it is also the wave's key."""
        o = self.ordinal_for(bucket, chunk)
        return o, self.devices[o]


def plan_bucket_placement(estimates: dict, devices: "list | None" = None,
                          offset: int = 0) -> Optional[Placement]:
    """Largest-first packing of the predicted per-bucket decoded bytes onto
    the devices. ``estimates`` maps bucket -> predicted bytes (a bucket
    missing from it takes the round robin at lookup). None when no mesh is
    on."""
    if devices is None:
        devices = mesh_devices()
    ndev = len(devices)
    if ndev < 2:
        return None
    loads = [0.0] * ndev
    units: dict[int, tuple] = {}
    total = float(sum(estimates.values()))
    if estimates and total > 0:
        share = total / ndev
        # one work unit per fair share the bucket covers: one hot bucket
        # becomes several ranges instead of pinning one device
        work = []
        for b in sorted(estimates):
            nbytes = float(estimates[b])
            k = max(1, min(ndev, math.ceil(nbytes / share))) if nbytes > 0 else 1
            for i in range(k):
                work.append((nbytes / k, int(b), i))
        work.sort(key=lambda u: (-u[0], u[1], u[2]))
        placed: dict[int, list] = {}
        for nbytes, b, i in work:
            o = min(range(ndev), key=lambda d: (loads[d], (d - offset) % ndev))
            loads[o] += nbytes
            placed.setdefault(b, []).append((i, o))
        units = {b: tuple(o for _i, o in sorted(pairs)) for b, pairs in placed.items()}
    REGISTRY.counter("mesh.placement.buckets").inc(len(estimates))
    used = [load for load in loads if load > 0]
    ratio = (max(used) / (sum(used) / len(used))) if used else 1.0
    if estimates:
        REGISTRY.gauge("mesh.placement.devices_used").set(len(used))
        REGISTRY.gauge("mesh.placement.bytes_imbalance_ratio").set(ratio)
    if trace.enabled():
        # a zero-width marker carrying the packing's outcome
        with trace.span("mesh:place", buckets=len(estimates), devices=ndev,
                        devices_used=len(used), imbalance=round(ratio, 3)):
            pass
    return Placement(devices, units, offset)


def plan_for_strategy(strategy) -> Optional[Placement]:
    """The Placement of one bucketed join, from the memory planner's
    footer estimates (a read-only map: ``observe_actual`` writes another)."""
    devices = mesh_devices()
    if len(devices) < 2:
        return None
    estimates = {}
    if strategy is not None:
        estimates = {b: est[1] for b, est in strategy.estimates.items()}
    return plan_bucket_placement(estimates, devices, _query_offset())


class ChunkPlacer:
    """Greedy online least-loaded placement of streamed chunks, whose sizes
    are known only as they decode; deterministic in chunk order (which the
    streaming executor fixes)."""

    __slots__ = ("devices", "_loads", "_offset")

    def __init__(self, devices: list, offset: int = 0):
        self.devices = devices
        self._loads = [0] * len(devices)
        self._offset = offset

    def next(self, nbytes: int):
        """(ordinal, device) of the next chunk; charges its bytes."""
        n = len(self.devices)
        o = min(range(n), key=lambda d: (self._loads[d], (d - self._offset) % n))
        self._loads[o] += max(int(nbytes), 1)
        return o, self.devices[o]


def chunk_placer() -> Optional[ChunkPlacer]:
    """A fresh ChunkPlacer when the mesh is on; None otherwise."""
    devices = mesh_devices()
    if len(devices) < 2:
        return None
    return ChunkPlacer(devices, _query_offset())
