"""Device meshes over torch devices (counterpart of
hyperspace_tpu/parallel/mesh.py).

One process drives every device, as the JAX package's single controller
does: one session, one plan and one host fold in bucket order. A mesh is a
grid of ``MeshDevice`` ordinals with the reference's axis names, ``"shards"``
or ``("dcn", "ici")`` when hierarchical (row i of the grid is slice i). The
reference's collectives become loops over the shards:

- a ``shard_map`` body runs once per shard, on that shard's device (its
  work is queued on the device's current stream);
- ``psum``, ``pmin`` and ``pmax`` become per-shard partials copied to the
  mesh's first device and folded there in shard order (``fold``); on a
  hierarchical mesh each slice folds first, then the slices;
- ``all_to_all`` becomes per-(source, destination) slices, each copied to
  its destination's device (parallel/exchange.py).

Rows shard in the mesh's row-major device order: on a hierarchical mesh
the row blocks run over ``("dcn", "ici")`` with the slice index major, as a
``PartitionSpec(("dcn", "ici"))`` lays them out.

``virtual_devices(n, device)`` is the counterpart of XLA's
``--xla_force_host_platform_device_count``: while it is active,
``visible_devices()`` answers with ``n`` logical ordinals over one physical
torch device. Otherwise it lists the CUDA devices, or none on a host with
no card. The tests, the smoke's mesh phase and ``dryrun_multigpu`` enter
it; it is no conf key and no knob.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager

import numpy as np
import torch

SHARD_AXIS = "shards"
# the hierarchical axes: "ici" within a slice, "dcn" across slices
AXIS_DCN = "dcn"
AXIS_ICI = "ici"
HIER_AXES = (AXIS_DCN, AXIS_ICI)

_log = logging.getLogger(__name__)


class MeshDevice:
    """One device ordinal a mesh or the placer may target: ``id`` is the
    ordinal (the JAX device's ``id``), ``device`` the torch device its
    tensors live on. Under ``virtual_devices`` several ordinals share one
    torch device; their uploads are still cached apart (``tag``)."""

    __slots__ = ("id", "device")

    def __init__(self, ordinal: int, device: torch.device):
        self.id = ordinal
        self.device = device

    @property
    def tag(self) -> str:
        """The ordinal's device-cache tag suffix: an upload made for one
        ordinal never serves another."""
        return f"d{self.id}"

    def __repr__(self) -> str:
        return f"MeshDevice({self.id}, {self.device})"


class Mesh:
    """A grid of MeshDevices with one axis name per dimension."""

    __slots__ = ("devices", "axis_names", "shape")

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        self.devices = devices  # object ndarray of MeshDevice
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def flat(self) -> list:
        """The devices in row-major (shard) order."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.flat})"


# the active virtual device list (empty: the real devices); replaced whole,
# in one slice assignment, only by virtual_devices, which the tests, the
# smoke and the dry run enter around their work; the rest only read it
_VIRTUAL: list = []  # hslint: HS305 — one atomic slice assignment per enter/exit
# one Mesh object per (devices, axes), so a mesh's identity is stable across
# calls, as the JAX package's interned meshes are (mesh_probe_fingerprint
# keys on it); setdefault keeps the first of two racing builds
_MESHES: dict = {}  # hslint: HS305 — insert-only through atomic setdefault


@contextmanager
def virtual_devices(n: int, device="cpu"):
    """``n`` logical device ordinals over one torch ``device`` while the
    block runs: the counterpart of XLA's forced host device count."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    saved = list(_VIRTUAL)
    _VIRTUAL[:] = [MeshDevice(i, dev) for i in range(n)]
    try:
        yield list(_VIRTUAL)
    finally:
        _VIRTUAL[:] = saved


def visible_devices(cap: int = 0) -> list:
    """The devices scale-out placement may target: the virtual ordinals
    while ``virtual_devices`` is active, else one per CUDA device (none on
    a host with no card). ``cap`` > 0 clamps the list
    (``HYPERSPACE_MESH_DEVICES``); the order is stable for the process's
    lifetime, which placement's determinism leans on."""
    if _VIRTUAL:
        devices = list(_VIRTUAL)
    elif torch.cuda.is_available():
        devices = [MeshDevice(i, torch.device("cuda", i))
                   for i in range(torch.cuda.device_count())]
    else:
        devices = []
    if cap > 0:
        devices = devices[:cap]
    return devices


def _mesh(devices: list, shape: tuple, axis_names: tuple) -> Mesh:
    key = (tuple((d.id, str(d.device)) for d in devices), shape, axis_names)
    mesh = _MESHES.get(key)
    if mesh is None:
        grid = np.empty(len(devices), dtype=object)
        grid[:] = devices
        mesh = _MESHES.setdefault(key, Mesh(grid.reshape(shape), axis_names))
    return mesh


def device_mesh(num_devices: int | None = None, axis: str = SHARD_AXIS) -> Mesh:
    devices = visible_devices()
    n = num_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"Requested {n} devices, have {len(devices)}")
    return _mesh(devices[:n], (n,), (axis,))


def hierarchical_mesh(num_slices: int, devices_per_slice: int) -> Mesh:
    """A 2-D (dcn, ici) mesh: row i of the device grid is slice i."""
    devices = visible_devices()
    n = num_slices * devices_per_slice
    if n > len(devices):
        raise ValueError(f"Requested {n} devices, have {len(devices)}")
    return _mesh(devices[:n], (num_slices, devices_per_slice), HIER_AXES)


def is_hierarchical(mesh: Mesh) -> bool:
    """True for multi-axis (multi-slice) meshes: the row-moving paths (the
    build exchange, the mesh join probe) stay within one slice."""
    return len(mesh.axis_names) != 1


def slice_submeshes(mesh: Mesh) -> list:
    """One flat ("shards",) mesh per slice of a hierarchical mesh (a flat
    mesh is its own one slice)."""
    if not is_hierarchical(mesh):
        return [mesh]
    return [_mesh(list(row), (len(row),), (SHARD_AXIS,)) for row in mesh.devices]


def mesh_row_axes(mesh: Mesh):
    """The axis spec that shards rows over every device of the mesh: the
    one axis of a flat mesh, the (dcn, ici) pair of a hierarchical one."""
    names = tuple(mesh.axis_names)
    return names[0] if len(names) == 1 else names


def num_shards(mesh: Mesh, axis=None) -> int:
    if axis is None:
        axis = mesh_row_axes(mesh)
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis]


def shard_devices(mesh: Mesh, axis=None) -> list:
    """The devices rows shard over, in shard order. Rows shard over every
    axis of the mesh: a sub-axis of a hierarchical mesh is not a row axis."""
    if axis is not None and axis != mesh_row_axes(mesh):
        raise ValueError(f"rows shard over {mesh_row_axes(mesh)!r}, not {axis!r}")
    return mesh.flat


def shard_rows(mesh: Mesh, arr: np.ndarray, axis=None, fill=0) -> list:
    """A host array padded (with ``fill``) to a multiple of the shard count
    and split into one tensor per shard, each on its shard's device."""
    devices = shard_devices(mesh, axis)
    d = len(devices)
    a = np.asarray(arr)
    padded = -(-len(a) // d) * d
    if padded != len(a):
        a = np.concatenate([a, np.full(padded - len(a), fill, dtype=a.dtype)])
    per = padded // d
    return [torch.from_numpy(a[i * per:(i + 1) * per].copy()).to(dev.device)
            for i, dev in enumerate(devices)]


def replicated(mesh: Mesh, arr: np.ndarray) -> list:
    """One copy of a host array on every device of the mesh."""
    t = torch.from_numpy(np.array(arr))
    return [t.to(dev.device) for dev in mesh.flat]


_FOLDS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def fold(mesh: Mesh, parts: list, op: str = "sum") -> torch.Tensor:
    """The psum/pmin/pmax of per-shard partials (in shard order): copied to
    the mesh's first device and folded there in shard order; a
    hierarchical mesh folds each slice, then the slices' results."""
    home = mesh.flat[0].device
    f = _FOLDS[op]
    rows = mesh.devices.shape[0] if is_hierarchical(mesh) else 1
    per = len(parts) // rows
    out = None
    for r in range(rows):
        acc = None
        for p in parts[r * per:(r + 1) * per]:
            p = p.to(home)
            acc = p if acc is None else f(acc, p)
        out = acc if out is None else f(out, acc)
    return out


def active_mesh(session) -> Mesh | None:
    """The execution mesh ``hyperspace.tpu.exec.meshDevices`` asks for, when
    that many devices exist; None otherwise. Too few devices is a decline:
    counted in the session's ``device_stats.declines`` and logged."""
    if session is None:
        return None
    n = session.conf.exec_mesh_devices
    if n <= 1:
        return None
    have = len(visible_devices())
    if have < n:
        _log.info("meshDevices=%d asks for more devices than the %d visible: "
                  "no mesh", n, have)
        stats = getattr(session, "device_stats", None)
        if stats is not None:
            stats.declines["mesh_too_few_devices"] = (
                stats.declines.get("mesh_too_few_devices", 0) + 1)
        return None
    slices = session.conf.exec_mesh_slices
    if slices > 1:
        return hierarchical_mesh(slices, n // slices)
    return device_mesh(n)
