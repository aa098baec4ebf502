"""Small shared utilities: rational-rate math, padding, pytree helpers, the
persistent compile cache."""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Sequence

import numpy as np


def rational_rate(input_rate: int, output_rate: int) -> tuple[int, int]:
    """Reduce a sample-rate conversion to coprime (up=L, down=M).

    48000->16000 -> (1, 3); 44100->16000 -> (160, 441).
    """
    if input_rate <= 0 or output_rate <= 0:
        raise ValueError("sample rates must be positive")
    g = math.gcd(input_rate, output_rate)
    return output_rate // g, input_rate // g


def round_up(x: int, multiple: int) -> int:
    """Round ``x`` up to the nearest multiple."""
    return -(-x // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_to(x: np.ndarray, length: int, axis: int = -1, value: float = 0.0) -> np.ndarray:
    """Pad ``x`` along ``axis`` to ``length`` with ``value`` (no-op if long enough)."""
    axis = axis % x.ndim
    cur = x.shape[axis]
    if cur >= length:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, length - cur)
    return np.pad(x, widths, constant_values=value)


def stack_padded(arrays: Sequence[np.ndarray], multiple: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Stack variable-length 1-D arrays into [batch, T] plus a lengths vector.

    T is the max length rounded up to ``multiple`` (static shapes for jit).
    """
    if not arrays:
        raise ValueError("empty batch")
    lengths = np.array([a.shape[-1] for a in arrays], dtype=np.int32)
    target = round_up(int(lengths.max()), multiple)
    out = np.stack([pad_to(np.asarray(a), target) for a in arrays])
    return out, lengths


#: where the entry points keep XLA's persistent compile cache when
#: ``JAX_COMPILATION_CACHE_DIR`` is unset: a fixed path (the path is part of
#: the cache key, so a directory that moves never hits)
DEFAULT_COMPILE_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``JAX_COMPILATION_CACHE_DIR``
    when set (JAX reads it itself; no other path is set), else at
    :data:`DEFAULT_COMPILE_CACHE`. Returns the directory in use. Call it from
    an entry point, before the first compile."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_COMPILE_CACHE))
    return str(DEFAULT_COMPILE_CACHE)
