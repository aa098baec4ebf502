"""Sample-rate conversion as one matmul.

Design
------
A rational resampler (up=L, down=M) is a polyphase filter bank: output ``n``
uses phase ``p = (n*M) % L`` of the bank and an input window anchored at
``(n*M) // L``. Phases repeat with period L, so a block of ``G`` consecutive
outputs (G a multiple of L) consumes exactly ``ipb = G*M/L`` inputs and can be
written as

    y_block [G] = x_window [ipb + K] @ W [ipb + K, G]

where ``W`` is a banded matrix holding the phase weights. The whole resample
is then ``frame(x, ipb+K, ipb) @ W`` — a single dense matmul that XLA tiles
onto the device's matrix units, instead of the reference's per-128-sample
serial rubato calls (src-tauri/src/modules/audio/resampler.rs:43-49,132-147).
The extra multiply-by-zeros of the band is ~10x flops, which the matrix
units absorb; the op stays bound by memory bandwidth. Batch is vmapped/leading-dim'd for free.

Two filter banks are provided:

* ``kaiser``: windowed-sinc polyphase (the north star's "polyphase sinc"),
  alignment-compatible with ``scipy.signal.resample_poly``;
* ``cubic``: 4-tap cubic-Lagrange interpolation — the same polynomial rubato's
  ``FastFixedIn(PolynomialDegree::Cubic)`` evaluates (interpolation of 4
  uniform points between the middle two), for reference-parity mode
  (resampler.rs:43-49).

Passthrough when rates match, parity with resampler.rs:33-39.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

import jax.numpy as jnp

from ..utils import cdiv, rational_rate
from ._mm import mm


# --------------------------------------------------------------------------
# filter design (host-side, float64)
# --------------------------------------------------------------------------

def kaiser_sinc_bank(up: int, down: int, half_width: int = 16, beta: float = 8.555) -> np.ndarray:
    """Windowed-sinc polyphase bank ``[up, K]``.

    ``half_width`` is scaled by ``ceil(down/up)`` when decimating so the
    anti-alias lowpass keeps ~2*half_width taps per *output* period — a
    fixed-length prototype would be far too short for strong decimation
    (e.g. 96k->16k). Effective K = 2*half_width*ceil(down/up) + 1; the
    prototype has odd length ``N = (K-1)*up + 1`` at the upsampled rate,
    cutoff ``1/max(up, down)`` (normalized), gain ``up`` to compensate
    zero-stuffing. bank[p, t] = h_full[(K-1-t)*up + p], so
    ``y[n] = sum_t bank[p, t] * x[n*down//up - (K-1)//2 + t]``.
    """
    half_eff = half_width * max(1, cdiv(down, up))
    n_total = 2 * half_eff * up + 1
    c = half_eff * up  # (N-1)/2, exactly divisible by up
    fc = 1.0 / max(up, down)
    k = np.arange(n_total, dtype=np.float64) - c
    h = up * fc * np.sinc(fc * k) * np.kaiser(n_total, beta)
    k_taps = 2 * half_eff + 1
    h_pad = np.zeros(k_taps * up, dtype=np.float64)
    h_pad[:n_total] = h
    bank = np.zeros((up, k_taps), dtype=np.float64)
    for p in range(up):
        for t in range(k_taps):
            idx = (k_taps - 1 - t) * up + p
            if idx < n_total:
                bank[p, t] = h_pad[idx]
    return bank


def cubic_lagrange_bank(up: int) -> np.ndarray:
    """4-tap cubic-Lagrange bank ``[up, 4]`` for fractions p/up.

    Identical polynomial to rubato's ``interp_cubic`` (Lagrange cubic through
    4 uniform points evaluated between the middle two):
      a0=y1; a1=-y0/3 - y1/2 + y2 - y3/6; a2=(y0+y2)/2 - y1;
      a3=(y1-y2)/2 + (y3-y0)/6;  y = ((a3*f + a2)*f + a1)*f + a0.
    Offset convention: ``y[n] = sum_t bank[p, t] * x[n*down//up - 1 + t]``.
    """
    f = np.arange(up, dtype=np.float64)[:, None] / up
    y0 = -f / 3.0 + f * f / 2.0 - f**3 / 6.0
    y1 = 1.0 - f / 2.0 - f * f + f**3 / 2.0
    y2 = f + f * f / 2.0 - f**3 / 2.0
    y3 = -f / 6.0 + f**3 / 6.0
    return np.concatenate([y0, y1, y2, y3], axis=1)


def linear_bank(up: int) -> np.ndarray:
    """2-tap linear interpolation bank (rubato PolynomialDegree::Linear analog)."""
    f = np.arange(up, dtype=np.float64)[:, None] / up
    return np.concatenate([1.0 - f, f], axis=1)


def _kaiser_entry(up, down, **kw):
    bank = kaiser_sinc_bank(up, down, **kw)
    return bank, -((bank.shape[1] - 1) // 2)


_BANKS = {
    "kaiser": _kaiser_entry,
    "cubic": lambda L, M, **kw: (cubic_lagrange_bank(L), -1),
    "linear": lambda L, M, **kw: (linear_bank(L), 0),
}


# --------------------------------------------------------------------------
# block-matmul machinery
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ResamplePlan:
    """Static compilation plan for one (rate pair, mode) resampler."""

    up: int
    down: int
    offset: int  # window anchor relative to n*down//up
    block_out: int  # G: outputs per block (multiple of up)
    ipb: int  # inputs per block = G*down/up
    k_taps: int
    matrix: np.ndarray  # [ipb + k_taps, G] float32 banded weights

    @property
    def lookahead(self) -> int:
        """Future input samples needed per output (streaming delay)."""
        return self.offset + self.k_taps - 1

    @property
    def history(self) -> int:
        """Past input samples needed (streaming carry length)."""
        return max(0, -self.offset)


def _block_matrix(bank: np.ndarray, up: int, down: int, g: int, n_shift: int = 0) -> np.ndarray:
    """Banded weight matrix for a block of ``g`` outputs starting at absolute
    output index ``n_shift`` (mod up); rows are window positions relative to
    the block's first window start."""
    k_taps = bank.shape[1]
    q0 = ((n_shift) * down) // up
    width = ((n_shift + g - 1) * down) // up - q0 + k_taps
    w = np.zeros((width, g), dtype=np.float64)
    for gg in range(g):
        n = n_shift + gg
        p = (n * down) % up
        base = (n * down) // up - q0
        w[base : base + k_taps, gg] = bank[p]
    return w.astype(np.float32)


@lru_cache(maxsize=64)
def make_plan(
    input_rate: int,
    output_rate: int,
    mode: str = "kaiser",
    min_block_out: int = 128,
    half_width: int = 16,
    beta: float = 8.555,
) -> ResamplePlan:
    L, M = rational_rate(input_rate, output_rate)
    kw = {"half_width": half_width, "beta": beta} if mode == "kaiser" else {}
    try:
        bank, offset = _BANKS[mode](L, M, **kw)
    except KeyError:
        raise ValueError(f"unknown resample mode {mode!r}; known: {sorted(_BANKS)}") from None
    k_taps = bank.shape[1]
    g = max(L, cdiv(min_block_out, L) * L)
    ipb = g * M // L
    w = _block_matrix(bank, L, M, g)
    assert w.shape[0] <= ipb + k_taps
    if w.shape[0] < ipb + k_taps:
        w = np.pad(w, ((0, ipb + k_taps - w.shape[0]), (0, 0)))
    return ResamplePlan(L, M, offset, g, ipb, k_taps, w)


def _resolve_precision(precision: str | None) -> str:
    """Effective precision tier for the band matmul.

    Default = the framework-wide setting ("highest"): the op is bound by
    memory, not flops, so a lower tier buys little, while the validate
    error vs the float64 oracle would grow from ~1e-6 toward the 1e-4
    budget. Callers who want the speed mode pass ``precision="high"``
    explicitly (error budgets in docs/DESIGN.md §6b).
    """
    if precision is not None:
        return precision
    from ._mm import get_default_matmul_precision

    return get_default_matmul_precision()


def _banded_matmul(
    x: jnp.ndarray, w: jnp.ndarray, n_blocks: int, ipb: int, dtype,
    precision: str | None = None,
) -> jnp.ndarray:
    """Compute ``windows(x) @ w`` without materializing the windows.

    ``w [width, G]`` acts on overlapped windows of ``x`` at stride ``ipb``
    (width >= ipb). Decompose the band into ceil(width/ipb) segments, each a
    matmul whose left operand is a cheap shifted *reshape* of ``x`` — the
    full [..., n_blocks, width] window tensor (roughly width/ipb times the
    signal) never hits HBM.
    """
    width = w.shape[0]
    need = n_blocks * ipb + width
    t = x.shape[-1]
    if t < need:
        pads = [(0, 0)] * (x.ndim - 1) + [(0, need - t)]
        x = jnp.pad(x, pads)
    w = jnp.asarray(w, dtype)
    y = None
    for j0 in range(0, width, ipb):
        w_j = min(ipb, width - j0)
        seg = x[..., j0 : j0 + n_blocks * ipb].reshape(*x.shape[:-1], n_blocks, ipb)
        part = mm(seg[..., :w_j], w[j0 : j0 + w_j], precision=_resolve_precision(precision))
        y = part if y is None else y + part
    return y


def resample_apply(
    x: jnp.ndarray,
    plan: ResamplePlan,
    n_out: int | None = None,
    precision: str | None = None,
) -> jnp.ndarray:
    """Resample ``x [..., T]`` with a prebuilt plan. Tail is zero-padded
    (matches BatchResampler::flush, resampler.rs:150-166)."""
    t = x.shape[-1]
    if n_out is None:
        n_out = cdiv(t * plan.up, plan.down)
    lp = plan.history
    if lp:
        pads = [(0, 0)] * (x.ndim - 1) + [(lp, 0)]
        x = jnp.pad(x, pads)
    n_blocks = cdiv(n_out, plan.block_out)
    dt = x.dtype if x.dtype != jnp.float64 else jnp.float32
    # Long signals: run the SAME band matmul block-by-block inside lax.scan.
    # The one-shot matmul over [.., n_blocks, ipb] windows is bound by
    # locality, not flops; chunked-scan processing keeps each step's
    # shifted-window relayout and matmul working set small.
    blocks_per_step = max(1, 8192 // plan.ipb)
    if n_blocks > 2 * blocks_per_step:
        y = _banded_matmul_scan(
            x, plan.matrix, n_blocks, plan.ipb, dt, precision, blocks_per_step
        )
    else:
        y = _banded_matmul(x, plan.matrix, n_blocks, plan.ipb, dt, precision)
        y = y.reshape(*y.shape[:-2], n_blocks * plan.block_out)
    return y[..., :n_out].astype(x.dtype)


def _banded_matmul_scan(
    x: jnp.ndarray, w: np.ndarray, n_blocks: int, ipb: int, dtype,
    precision: str | None, blocks_per_step: int,
) -> jnp.ndarray:
    """Chunked-scan form of :func:`_banded_matmul` (see resample_apply)."""
    import jax

    width = w.shape[0]
    g = w.shape[1]
    n_steps = cdiv(n_blocks, blocks_per_step)
    step_in = blocks_per_step * ipb
    need = n_steps * step_in + width
    t = x.shape[-1]
    if t < need:
        pads = [(0, 0)] * (x.ndim - 1) + [(0, need - t)]
        x = jnp.pad(x, pads)
    wd = jnp.asarray(w, dtype)

    def body(_, i):
        seg = jax.lax.dynamic_slice_in_dim(x, i * step_in, step_in + width, axis=-1)
        y = _banded_matmul(seg, wd, blocks_per_step, ipb, dtype, precision)
        return None, y  # [..., blocks_per_step, g]

    _, ys = jax.lax.scan(body, None, jnp.arange(n_steps, dtype=jnp.int32))
    lead = ys.shape[1:-2]
    ys = jnp.moveaxis(ys, 0, len(lead))  # [..., n_steps, bps, g]
    return ys.reshape(*lead, n_steps * blocks_per_step * g)


# --------------------------------------------------------------------------
# streaming (fixed-shape chunk steps with carried history)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class StreamResamplePlan:
    """Static plan for chunked streaming resampling.

    Chunk k (input samples ``[k*chunk_in, (k+1)*chunk_in)``) emits the fixed
    count ``n_out_chunk = chunk_in*up/down`` of consecutive outputs, offset by
    the (negative) constant ``n0``: the m-th output overall is offline output
    ``n0 + m`` of the zero-prehistory stream. Concatenated streaming output
    with the first ``-n0`` samples dropped equals the offline resampler
    exactly (verified in tests). Carry = last ``hist`` input samples.

    This is the on-device analog of the reference's BatchResampler accumulate/chunk
    semantics (resampler.rs:114-167), with fixed shapes for jit.
    """

    up: int
    down: int
    chunk_in: int
    n_out_chunk: int
    n0: int  # output-index shift (<= 0); -n0 == streaming latency in output samples
    hist: int  # carried input samples
    block_out: int
    ipb: int
    k_taps: int
    matrix: np.ndarray  # [ipb + k_taps, block_out] f32

    @property
    def latency_out(self) -> int:
        return -self.n0


def stream_chunk_multiple(input_rate: int, output_rate: int, min_block_out: int = 128) -> int:
    """Inputs-per-block of the streaming plan: valid streaming chunk sizes
    are multiples of this (the single source of truth for graph-layer
    granularity computation)."""
    up, down = rational_rate(input_rate, output_rate)
    g = max(up, cdiv(min_block_out, up) * up)
    return g * down // up


@lru_cache(maxsize=64)
def make_stream_plan(
    input_rate: int,
    output_rate: int,
    mode: str = "kaiser",
    chunk_in: int = 4096,
    min_block_out: int = 128,
    half_width: int = 16,
    beta: float = 8.555,
) -> StreamResamplePlan:
    L, M = rational_rate(input_rate, output_rate)
    kw = {"half_width": half_width, "beta": beta} if mode == "kaiser" else {}
    try:
        bank, offset = _BANKS[mode](L, M, **kw)
    except KeyError:
        raise ValueError(f"unknown resample mode {mode!r}; known: {sorted(_BANKS)}") from None
    k_taps = bank.shape[1]
    g = max(L, cdiv(min_block_out, L) * L)
    ipb = stream_chunk_multiple(input_rate, output_rate, min_block_out)
    if chunk_in % ipb != 0:
        raise ValueError(
            f"chunk_in={chunk_in} must be a multiple of {ipb} "
            f"(= {g}*{M}/{L}) for rates {input_rate}->{output_rate}"
        )
    noc = chunk_in * L // M
    # largest n0 such that the last output of a chunk never reads past the
    # chunk's final input sample: ((n0+noc-1)*M)//L + offset + k_taps - 1 <= chunk_in - 1
    n0 = (chunk_in - k_taps - offset) * L // M - noc + 1
    while ((n0 + noc - 1) * M) // L + offset + k_taps - 1 > chunk_in - 1:
        n0 -= 1
    n0 = min(n0, 0)
    hist = -((n0 * M) // L + offset)
    assert hist >= 0, (n0, offset, hist)
    # block matrix with phases shifted by n0; n_shift must keep the row-0
    # alignment: window start of block b, col 0 is q(n0 + b*g) relative to
    # buf position b*ipb. Because g is a multiple of L, q advances by exactly
    # ipb per block, so one matrix serves all blocks.
    w = _block_matrix(bank, L, M, g, n_shift=n0)
    assert w.shape[0] <= ipb + k_taps
    if w.shape[0] < ipb + k_taps:
        w = np.pad(w, ((0, ipb + k_taps - w.shape[0]), (0, 0)))
    return StreamResamplePlan(L, M, chunk_in, noc, n0, hist, g, ipb, k_taps, w)


def resample_stream_init(plan: StreamResamplePlan, lead_shape=(), dtype=jnp.float32) -> jnp.ndarray:
    """Zero history carry ``[..., hist]`` (matches the offline zero left-pad)."""
    return jnp.zeros((*lead_shape, plan.hist), dtype)


def resample_stream_step(
    plan: StreamResamplePlan,
    carry: jnp.ndarray,
    chunk: jnp.ndarray,
    precision: str | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One streaming step: ``chunk [..., chunk_in]`` -> ``[..., n_out_chunk]``."""
    if chunk.shape[-1] != plan.chunk_in:
        raise ValueError(f"chunk length {chunk.shape[-1]} != plan chunk_in {plan.chunk_in}")
    buf = jnp.concatenate([carry, chunk], axis=-1)
    n_blocks = plan.n_out_chunk // plan.block_out
    dt = buf.dtype if buf.dtype != jnp.float64 else jnp.float32
    y = _banded_matmul(buf, plan.matrix, n_blocks, plan.ipb, dt, precision)
    y = y.reshape(*buf.shape[:-1], plan.n_out_chunk).astype(chunk.dtype)
    new_carry = buf[..., buf.shape[-1] - plan.hist :] if plan.hist else carry
    return new_carry, y


def resample(
    x: jnp.ndarray,
    input_rate: int,
    output_rate: int,
    mode: str = "kaiser",
    **kwargs,
) -> jnp.ndarray:
    """Resample ``[..., T]`` from input_rate to output_rate.

    Identity passthrough when rates match (resampler.rs:33-39 parity).
    """
    if input_rate == output_rate:
        return x
    precision = kwargs.pop("precision", None)
    return resample_apply(
        x, make_plan(input_rate, output_rate, mode, **kwargs), precision=precision
    )
