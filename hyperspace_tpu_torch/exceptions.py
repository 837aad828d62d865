"""Hyperspace exception types (counterpart of hyperspace_tpu/exceptions.py)."""


class HyperspaceError(Exception):
    """Base error for all hyperspace_tpu_torch failures."""


class NoChangesError(HyperspaceError):
    """Raised by an action's op() when there is nothing to do; the surrounding
    transaction is abandoned without a state transition."""


class ConcurrentWriteError(HyperspaceError):
    """Optimistic-concurrency violation: another writer already committed the
    target log id."""


class UnknownIndexKindError(HyperspaceError):
    """A log entry names an index kind this package does not load (the JAX
    package's data-skipping kind, for one)."""

    def __init__(self, kind):
        super().__init__(f"Unknown index kind: {kind!r}")
        self.kind = kind


class DeviceUnavailableError(HyperspaceError):
    """The session asked for the CUDA device tier (the default) on a machine
    where ``torch.cuda.is_available()`` is false. Pass ``device="cpu"`` to
    run the device tier's plain PyTorch bodies on the host instead."""


class KernelError(HyperspaceError):
    """A hand-written CUDA kernel failed to build or launch, or was handed
    tensors it does not take. Never caught by the device tier: a broken
    kernel fails the query instead of silently running on the host."""


class NativeError(HyperspaceError):
    """The native host library (hyperspace_tpu_torch/native) failed to build
    or load. Never caught: the host paths that call it do not fall back to
    their numpy forms."""
