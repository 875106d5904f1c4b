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


def default_device() -> torch.device:
    """Where an entry point runs when the caller names no device and
    passes no tensor to take it from: the first CUDA device when one is
    present, else the CPU. The CPU is for callers who ask for it."""
    return torch.device("cuda", 0) if on_cuda() else torch.device("cpu")


def entry_device(device=None) -> torch.device:
    """The device of an entry point or example (``entry()``, an example's
    ``main``): the one the caller names, else the first CUDA device. With
    no card and no device named it raises, rather than run on the CPU
    unasked."""
    if device is not None:
        return torch.device(device)
    if not on_cuda():
        raise RuntimeError("no CUDA device: this entry point runs on the "
                           "card; pass device='cpu' to run it on the CPU")
    return torch.device("cuda", 0)


def require_exact_f32_matmul(device, who: str) -> None:
    """Raise if f32 matrix products on ``device`` would run in TF32.

    TF32 keeps about three decimal digits: it would put ~1e-3 relative
    noise into the plain kernel versions and into the compensated polish
    gradient, whose point is to beat the f32 floor of rel ~4e-5. The
    check leaves the process-wide flags as it found them: the caller sets
    ``torch.backends.cuda.matmul.allow_tf32 = False``. CPU products are
    exact f32 whatever the flags say."""
    if torch.device(device).type != "cuda":
        return
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            f"{who} needs exact f32 matrix products, but TF32 is on "
            f"(allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
            f"float32_matmul_precision="
            f"{torch.get_float32_matmul_precision()!r}); set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


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
