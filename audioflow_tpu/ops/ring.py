"""Device-resident ring buffer.

The reference's ring buffer (capture.rs:83-161) is the thread-crossing between
the OS audio callback and the consumer. The on-device analog keeps the ring
as device-memory state inside the streaming session (SURVEY §2.2): a fixed
``[..., capacity]`` buffer plus read/write cursors, updated functionally with
traced-shift rolls + selects so a jitted producer/consumer step lowers to
dynamic slices, never a general scatter. Leading dims ride along (one ring per batch
lane, shared cursors — the session always pushes full-width).

This is the accumulator behind ``StreamSession.push``: irregular host pushes
land in the ring with no host-side concatenation; full chunks are read out
(zero-padded on flush, exactly the BatchResampler::flush semantics) and fed
to the jitted graph step.

Behavioral quirks preserved (SURVEY §7.4):
* usable capacity is ``capacity - 1`` (one slot reserved, capture.rs:108-111);
* writes are partial on overflow and return the count written, never block;
* reads return up to ``size`` values and the count (0 when empty).

Shapes must be static under jit, so ``write``/``read`` move fixed-size blocks
with masks; the returned counts are traced scalars.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Ring(NamedTuple):
    buf: jnp.ndarray  # [..., capacity]
    read_pos: jnp.ndarray  # i32 scalar
    write_pos: jnp.ndarray  # i32 scalar


def ring_init(capacity: int, lead_shape: tuple = (), dtype=jnp.float32) -> Ring:
    if capacity < 2:
        raise ValueError("capacity must be >= 2 (one slot is reserved)")
    z = jnp.zeros((), jnp.int32)
    return Ring(jnp.zeros((*lead_shape, capacity), dtype), z, z)


def ring_available(ring: Ring) -> jnp.ndarray:
    """Samples available to read (capture.rs:148-152)."""
    cap = ring.buf.shape[-1]
    return (ring.write_pos - ring.read_pos) % cap


def ring_free(ring: Ring) -> jnp.ndarray:
    """Writable space = capacity - 1 - available (capacity-1 semantics)."""
    return ring.buf.shape[-1] - 1 - ring_available(ring)


def ring_write(ring: Ring, data: jnp.ndarray, n=None) -> tuple[Ring, jnp.ndarray]:
    """Write up to ``n`` (default ``data.shape[-1]``) samples of ``data``;
    partial on overflow. Returns (ring, n_written).

    ``n`` may be a traced scalar smaller than the data width: callers pad
    ``data`` to a small set of bucket shapes and pass the true length, so
    irregular push sizes reuse a handful of compiled programs instead of
    recompiling per shape (jit caches by shape; each extra shape is a fresh
    compile)."""
    cap = ring.buf.shape[-1]
    if n is None:
        n = data.shape[-1]
    n_write = jnp.minimum(n, ring_free(ring))
    width = data.shape[-1]  # static; n may be traced
    # Vectorized circular write WITHOUT a scatter of thousands of indices:
    # rotate the (zero-padded) data so element j of the buffer pairs with
    # data[(j - write_pos) mod cap] (jnp.roll with a traced shift lowers to
    # two cheap dynamic slices), then select the written window. The window
    # [write_pos, write_pos + n_write) never self-overlaps (n_write <= free
    # <= cap - 1), so selection is exact — including partial writes.
    if width < cap:
        pads = [(0, 0)] * (data.ndim - 1) + [(0, cap - width)]
        data = jnp.pad(data, pads)
    else:
        data = data[..., :cap]
    src = jnp.roll(data, ring.write_pos, axis=-1)
    # window membership WITHOUT an elementwise modulo over the buffer:
    # rel in (-cap, cap); the wrapped part of the window is
    # rel < 0 with rel + cap < n_write.
    rel = jnp.arange(cap, dtype=jnp.int32) - ring.write_pos
    take = jnp.where(rel >= 0, rel < n_write, rel + cap < n_write)
    buf = jnp.where(take, src, ring.buf)
    return Ring(buf, ring.read_pos, (ring.write_pos + n_write) % cap), n_write


def ring_read(ring: Ring, size: int) -> tuple[Ring, jnp.ndarray, jnp.ndarray]:
    """Read up to ``size``; returns (ring, values [..., size] zero-padded,
    n_read).

    The reference returns None when empty (capture.rs:125-145); here the
    traced equivalent is ``n_read == 0``.
    """
    cap = ring.buf.shape[-1]
    n_read = jnp.minimum(size, ring_available(ring))
    # gather-free circular read: rotate the buffer so read_pos lands at 0
    # (traced-shift roll = two dynamic slices), then a static head slice
    rot = jnp.roll(ring.buf, -ring.read_pos, axis=-1)
    if size <= cap:
        head = rot[..., :size]
    else:
        pads = [(0, 0)] * (rot.ndim - 1) + [(0, size - cap)]
        head = jnp.pad(rot, pads)
    mask = jnp.arange(size) < n_read
    vals = jnp.where(mask, head, 0)
    return Ring(ring.buf, (ring.read_pos + n_read) % cap, ring.write_pos), vals, n_read


def ring_clear(ring: Ring) -> Ring:
    z = jnp.zeros((), jnp.int32)
    return Ring(ring.buf, z, z)


# --------------------------------------------------------------------------
# linear staging buffer — the session's measured-fast accumulator
# --------------------------------------------------------------------------

class Staging(NamedTuple):
    """Device-resident linear accumulator: ``buf [..., size]`` + fill count.

    The wrap-around Ring above is the capture.rs parity component; for the
    hot session path its circular addressing (a scatter, a modulo or
    full-buffer rolls per write) is the wrong primitive. A linear buffer
    needs ONE dynamic_update_slice per
    push (write width = the padded piece, not the capacity) and one
    static-slice + shift per drained chunk, with no wrap arithmetic at all
    — the session never wraps because it drains every full chunk eagerly
    (residual < chunk by invariant).
    """

    buf: jnp.ndarray  # [..., size]
    count: jnp.ndarray  # i32 scalar — valid samples at the front


def staging_init(size: int, lead_shape: tuple = (), dtype=jnp.float32) -> Staging:
    return Staging(jnp.zeros((*lead_shape, size), dtype), jnp.zeros((), jnp.int32))


def staging_push(st: Staging, data: jnp.ndarray, n=None) -> Staging:
    """Append ``n`` (default full width) samples of ``data``.

    Callers guarantee ``count + width <= size`` (the session's headroom
    split), so the dynamic_update_slice start never clamps. Padding beyond
    ``n`` lands in the buffer but is masked by the count on reads.
    """
    if n is None:
        n = data.shape[-1]
    starts = (jnp.zeros((), jnp.int32),) * (st.buf.ndim - 1) + (st.count,)
    buf = jax.lax.dynamic_update_slice(st.buf, data.astype(st.buf.dtype), starts)
    return Staging(buf, st.count + n)


def staging_take(st: Staging, size: int) -> tuple[Staging, jnp.ndarray, jnp.ndarray]:
    """Read up to ``size`` samples from the front (zero-padded past the
    count, BatchResampler::flush semantics); shift the remainder down.

    Returns (staging, values [..., size], n_read).
    """
    n_read = jnp.minimum(size, st.count)
    mask = jnp.arange(size, dtype=jnp.int32) < n_read
    vals = jnp.where(mask, st.buf[..., :size], 0)
    # compact: drop the first `size` positions (static slice + zero tail)
    widths = [(0, 0)] * (st.buf.ndim - 1) + [(0, min(size, st.buf.shape[-1]))]
    shifted = jnp.pad(st.buf[..., size:], widths)
    return Staging(shifted, jnp.maximum(st.count - n_read, 0)), vals, n_read
