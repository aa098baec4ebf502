"""Precision-controlled matmul for fidelity-critical kernels.

Kernels whose math must match the float64-designed coefficients (biquad
Toeplitz, resample banks, DFT banks, mel projection) route through
:func:`mm` / :func:`em`, which take a named precision tier:

* ``"highest"`` — full float32 products (the framework default);
* ``"high"`` — about 16 mantissa bits: three bf16 passes (hi*hi + hi*lo +
  lo*hi). The per-op "high" defaults and their ``audioflow validate``
  budgets were set at this accuracy;
* ``"default"`` — one reduced-precision pass (bf16 or TF32, 8-10 bits).

A tier names an accuracy, not an XLA enum: what ``lax.Precision.HIGH``
lowers to depends on the platform. On the GPU a float32 dot at HIGH runs in
TF32 (about 10 bits), so there "high" names the three-pass bf16 algorithm
explicitly. :data:`DOT_PRECISION` is the one table that holds the mapping.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_P = jax.lax.Precision

#: tier -> dot precision, per ``jax.default_backend()`` platform
DOT_PRECISION = {
    "cpu": {"default": _P.DEFAULT, "high": _P.HIGH, "highest": _P.HIGHEST},
    "gpu": {
        "default": _P.DEFAULT,
        "high": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
        "highest": _P.HIGHEST,
    },
}

TIERS = ("default", "high", "highest")

_default: str = "highest"


def set_default_matmul_precision(name: str) -> None:
    """Set the framework-wide precision for fidelity-critical matmuls."""
    global _default
    if name not in TIERS:
        raise ValueError(f"unknown precision {name!r}; known: {sorted(TIERS)}")
    _default = name


def get_default_matmul_precision() -> str:
    return _default


def _platform() -> str:
    return jax.default_backend()


def dot_precision(tier: str | None = None):
    """The ``precision=`` argument of a dot at ``tier`` (None = the
    framework default) on the current platform."""
    tier = tier or _default
    table = DOT_PRECISION.get(_platform())
    if table is None:
        raise ValueError(
            f"no precision table for platform {_platform()!r}; known: {sorted(DOT_PRECISION)}"
        )
    if tier not in table:
        raise ValueError(f"unknown precision {tier!r}; known: {sorted(TIERS)}")
    return table[tier]


def conv_precision(tier: str | None = None) -> jax.lax.Precision:
    """The ``precision=`` of a convolution at ``tier``. A dot algorithm
    preset does not apply to convolutions, so a tier that maps to one takes
    the next enum that keeps its accuracy (HIGHEST)."""
    p = dot_precision(tier)
    return p if isinstance(p, jax.lax.Precision) else _P.HIGHEST


def mm(a: jnp.ndarray, b: jnp.ndarray, precision: str | None = None) -> jnp.ndarray:
    """matmul with f32 accumulation at the named precision tier."""
    return jnp.matmul(
        a, b, precision=dot_precision(precision), preferred_element_type=jnp.float32
    )


def em(subscripts: str, *operands, precision: str | None = None) -> jnp.ndarray:
    """einsum with f32 accumulation at the named precision tier (for
    contractions over a non-trailing axis, e.g. the factored DFT stages)."""
    return jnp.einsum(
        subscripts, *operands, precision=dot_precision(precision),
        preferred_element_type=jnp.float32,
    )
