"""Device introspection and the fused-fallback warning machinery.

Counterpart of ``ciao_tpu/runtime.py``. One place answers "is there a
CUDA device for the kernels?", and one place emits the one-time warnings
when a run on the GPU lands on the stepwise PyTorch path for a reason
the user can fix.
"""

from __future__ import annotations

import contextlib
import warnings

import torch

_FALLBACK_WARNED: set = set()
_EXPECTED_DEPTH = 0


@contextlib.contextmanager
def expected_fallback():
    """Scope in which a fused-fallback is EXPECTED — a caller knowingly
    takes the stepwise path. Warnings inside the scope are dropped
    without consuming the one-time dedup slot, so a user's own later
    config with the same reason still warns."""
    global _EXPECTED_DEPTH
    _EXPECTED_DEPTH += 1
    try:
        yield
    finally:
        _EXPECTED_DEPTH -= 1


def on_cuda() -> bool:
    """Whether a CUDA device is present — the target of the port's
    kernels and the scope of the fallback warnings (CPU runs are
    expected to be unfused: silent there)."""
    return torch.cuda.is_available()


def warn_fused_fallback(who: str, reason: str, remedy: str) -> None:
    """One-time (per facade+reason) warning that this GPU run will use
    the stepwise PyTorch path instead of the CUDA kernel. Names the
    reason and the remedy; silent without a CUDA device."""
    if not on_cuda():
        return
    if _EXPECTED_DEPTH:
        return
    key = (who, reason)
    if key in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(key)
    warnings.warn(
        f"{who}: this configuration runs on the stepwise PyTorch path, "
        f"not the CUDA kernel — {reason}. Remedy: {remedy}",
        stacklevel=3,
    )


def reset_fallback_warnings() -> None:
    """Clear the one-time dedup set (test isolation)."""
    _FALLBACK_WARNED.clear()
