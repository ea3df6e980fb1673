"""The one place that picks each stage's implementation for the device.

The front end (FIRs, quadrature demod, DC blocker, Doppler mix) and the
TX chain are plain XLA on every platform.  Only the M&M clock has two
implementations:

- ``"kernel"`` — the Pallas kernel of ``ops/mm_clock.py``;
- ``"scan"``   — the vmapped ``lax.scan`` reference.

On a GPU the kernel runs compiled.  On the CPU, which only the tests and
local tools use, the default is the scan, and the kernel runs in Pallas
interpret mode when a caller asks for it by name.  Any other platform is
an error: nothing falls back silently.
"""

from __future__ import annotations

from typing import NamedTuple

CLOCKS = ("kernel", "scan")


class Impl(NamedTuple):
    platform: str
    clock: str  # default clock implementation: "kernel" | "scan"
    interpret: bool  # Pallas kernels in interpret mode


_BY_PLATFORM = {
    "gpu": Impl("gpu", "kernel", False),
    "cpu": Impl("cpu", "scan", True),
}


def select(platform: str | None = None) -> Impl:
    """Implementation choice for ``platform`` (default: JAX's first device)."""
    if platform is None:
        import jax

        platform = jax.devices()[0].platform
    try:
        return _BY_PLATFORM[platform]
    except KeyError:
        raise RuntimeError(
            f"no implementation for JAX platform {platform!r}; "
            f"supported: {sorted(_BY_PLATFORM)}"
        ) from None


def clock_backend(requested: str | None = None) -> str:
    """The clock to run: ``requested`` if given, else the platform's default."""
    clock = select().clock if requested is None else requested
    if clock not in CLOCKS:
        raise ValueError(f"unknown clock backend {clock!r}; expected one of {CLOCKS}")
    return clock


def require_gpu() -> Impl:
    """For entry points that serve or measure: the platform must be a GPU.

    Raises instead of falling back to the CPU, so a machine without a
    visible GPU fails at start-up rather than running somewhere else."""
    impl = select()
    if impl.platform != "gpu":
        raise RuntimeError(
            f"JAX found no GPU (first device platform: {impl.platform!r}); "
            "this entry point runs on a GPU only"
        )
    return impl
