"""PCM quantization ops.

Bit-exact device-side equivalent of the reference's wire packing
(reference: src-tauri/src/modules/network/websocket.rs:246-251):
``(x.clamp(-1.0, 1.0) * 32767.0) as i16`` — note Rust's ``as i16`` truncates
toward zero, so this uses trunc, not round. The little-endian byte/base64
framing lives host-side in :mod:`audioflow_tpu.sinks.wire`.
"""

from __future__ import annotations

import jax.numpy as jnp


def quantize_i16(x: jnp.ndarray) -> jnp.ndarray:
    """f32 [-1, 1] -> int16, reference-parity (clamp, scale 32767, trunc)."""
    scaled = jnp.clip(x, -1.0, 1.0) * 32767.0
    return jnp.trunc(scaled).astype(jnp.int16)


def dequantize_i16(x: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """int16 -> f32 in [-1, 1) using the symmetric 1/32768 convention."""
    return x.astype(dtype) / 32768.0


def quantize_i16_round(x: jnp.ndarray) -> jnp.ndarray:
    """Higher-quality variant: round-half-to-even instead of trunc."""
    scaled = jnp.clip(x, -1.0, 1.0) * 32767.0
    return jnp.round(scaled).astype(jnp.int16)
