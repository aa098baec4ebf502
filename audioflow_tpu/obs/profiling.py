"""jax.profiler integration (the tracing hook the reference never had on its
DSP path, SURVEY §5.1)."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Capture a device trace viewable in TensorBoard/XProf; no-op if dir
    empty. A profiler failure and an error in the traced body both raise."""
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
