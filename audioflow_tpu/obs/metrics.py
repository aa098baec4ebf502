"""Throughput/timing metrics for graph runs."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


class Timer:
    """Wall-clock context manager: ``with Timer() as t: ...; t.elapsed``."""

    def __enter__(self):
        self.start = time.perf_counter()
        self.elapsed = 0.0
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False


@dataclass
class RunMetrics:
    """Per-run counters (the AppStats-per-run analog, lifecycle/mod.rs:209-256,
    extended with the north-star throughput numbers)."""

    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    batches: int = 0
    files: int = 0
    failed_files: int = 0
    compile_seconds: float = 0.0
    n_devices: int = 1
    extra: dict = field(default_factory=dict)

    @property
    def realtime_factor(self) -> float:
        """audio-seconds processed per wall-second (the headline metric)."""
        return self.audio_seconds / self.wall_seconds if self.wall_seconds > 0 else 0.0

    @property
    def realtime_factor_per_chip(self) -> float:
        return self.realtime_factor / max(self.n_devices, 1)

    def to_dict(self) -> dict:
        return {
            "audio_seconds": self.audio_seconds,
            "wall_seconds": self.wall_seconds,
            "batches": self.batches,
            "files": self.files,
            "failed_files": self.failed_files,
            "compile_seconds": self.compile_seconds,
            "n_devices": self.n_devices,
            "realtime_factor": self.realtime_factor,
            "realtime_factor_per_chip": self.realtime_factor_per_chip,
            **self.extra,
        }


def measure_throughput(fn, x, audio_seconds: float, iters: int = 10, warmup: int = 2) -> RunMetrics:
    """Time ``iters`` executions of ``fn(x)``, excluding compile.

    All iterations run inside ONE jitted ``lax.scan`` program whose carry
    perturbs the next input by ``acc * 1e-30`` — a loop-carried data
    dependency, so XLA cannot hoist the body as loop-invariant — and the
    single scalar readback at the end waits for every iteration. The number
    is device time per iteration with one dispatch amortized over ``iters``.
    """
    import jax
    import jax.numpy as jnp

    def leaf0(y):
        return jax.tree_util.tree_leaves(y)[0]

    perturbable = jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)

    def make_loop(n):
        @jax.jit
        def loop(xx):
            def body(acc, _):
                xi = xx + acc * jnp.asarray(1e-30, xx.dtype) if perturbable else xx
                y = fn(xi)
                s = jnp.real(leaf0(y).ravel()[0]).astype(jnp.float32)
                return acc + s * jnp.float32(1e-9), None
            acc, _ = jax.lax.scan(body, jnp.zeros((), jnp.float32), None, length=n)
            return acc
        return loop

    m = RunMetrics()
    loop = make_loop(iters)
    with Timer() as tc:
        final = float(loop(x))  # compile + first run
    m.compile_seconds = tc.elapsed
    for _ in range(max(warmup - 1, 0)):
        float(loop(x))
    with Timer() as t:
        final = float(loop(x))
    assert final == final, "NaN in benchmark chain"
    m.wall_seconds = t.elapsed
    m.audio_seconds = audio_seconds * iters
    m.batches = iters
    return m
