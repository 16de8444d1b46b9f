"""Process-wide flags, the counterpart of ``vec_ode_tpu/config.py``. They
change diagnostics only, never numerics.

``warn_on_fallback``: when True, a batched solve that declines a kernel
path (the whole-loop kernel, or the step kernels under a callable drive or
a ``lc.TracedNorm``) emits a ``warnings.warn`` naming the rule that
declined it; ``Solution.path`` names the path taken either way. Off by
default: CPU runs decline the kernels by design.
"""

from __future__ import annotations

import warnings

warn_on_fallback: bool = False


def _warn_fallback(reason: str) -> None:
    """Warn, where ``warn_on_fallback`` is on, that a batched solve left a
    kernel path for ``reason``."""
    if not warn_on_fallback:
        return
    warnings.warn(
        "vec_ode_tpu_torch: batched solve declined a kernel path "
        f"({reason}); see Solution.path and the stepper's "
        "fused_loop_solve for the rules.",
        stacklevel=3,
    )


def _decline(reason: str):
    """A kernel path declined for ``reason``: the opt-in warning, and None
    for the caller to return, so that its caller runs the next path."""
    _warn_fallback(reason)
