"""Biquad IIR filters and cascades via blocked state-space matmuls.

The hard part (SURVEY §7.3 #1): IIR recurrences are inherently sequential in
time, which is hostile to matrix units. Instead of a per-sample
scan, a cascade of biquads is lifted to state-space form and processed in
blocks of ``Bk`` samples:

    y_blk  = x_blk @ T^t + s0 @ O^t          (matmuls)
    s_next = s0 @ (A^Bk)^t + x_blk @ U^t

where ``T`` is the lower-triangular Toeplitz matrix of the cascade's impulse
response, ``O`` stacks C·A^i, and ``U`` stacks A^(Bk-1-j)·B — all precomputed
host-side in float64 from the exact recurrence, so the math per block is
exact up to one f32 matmul rounding (vs the reference's serial f32 loop). The
only sequential dependency left is a length-(T/Bk) `lax.scan` carrying the
2k-dim state, with every step a batch-parallel matmul.

Filter design follows the RBJ Audio-EQ-Cookbook (lowpass/highpass/bandpass/
notch/allpass/peaking/shelves) — the standard parametric-EQ formulas the
north-star config 3 ("high-pass + 5-band parametric EQ + limiter") needs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from ._mm import mm


# --------------------------------------------------------------------------
# design (RBJ cookbook), float64 host-side
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Biquad:
    """Normalized biquad (a0 == 1): y += b0 x + b1 x' + b2 x'' - a1 y' - a2 y''."""

    b0: float
    b1: float
    b2: float
    a1: float
    a2: float

    def as_ba(self) -> tuple[np.ndarray, np.ndarray]:
        return (
            np.array([self.b0, self.b1, self.b2], dtype=np.float64),
            np.array([1.0, self.a1, self.a2], dtype=np.float64),
        )


def _rbj(fc: float, fs: float, q: float):
    w0 = 2.0 * math.pi * fc / fs
    return math.cos(w0), math.sin(w0) / (2.0 * q)


def _norm(b0, b1, b2, a0, a1, a2) -> Biquad:
    return Biquad(b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)


def lowpass(fc: float, fs: float, q: float = 0.7071067811865476) -> Biquad:
    cosw, alpha = _rbj(fc, fs, q)
    return _norm((1 - cosw) / 2, 1 - cosw, (1 - cosw) / 2, 1 + alpha, -2 * cosw, 1 - alpha)


def highpass(fc: float, fs: float, q: float = 0.7071067811865476) -> Biquad:
    cosw, alpha = _rbj(fc, fs, q)
    return _norm((1 + cosw) / 2, -(1 + cosw), (1 + cosw) / 2, 1 + alpha, -2 * cosw, 1 - alpha)


def bandpass(fc: float, fs: float, q: float = 1.0) -> Biquad:
    """Constant 0 dB peak gain bandpass."""
    cosw, alpha = _rbj(fc, fs, q)
    return _norm(alpha, 0.0, -alpha, 1 + alpha, -2 * cosw, 1 - alpha)


def notch(fc: float, fs: float, q: float = 1.0) -> Biquad:
    cosw, alpha = _rbj(fc, fs, q)
    return _norm(1.0, -2 * cosw, 1.0, 1 + alpha, -2 * cosw, 1 - alpha)


def allpass(fc: float, fs: float, q: float = 0.7071067811865476) -> Biquad:
    cosw, alpha = _rbj(fc, fs, q)
    return _norm(1 - alpha, -2 * cosw, 1 + alpha, 1 + alpha, -2 * cosw, 1 - alpha)


def peaking(fc: float, fs: float, gain_db: float, q: float = 1.0) -> Biquad:
    """Parametric EQ band."""
    a = 10.0 ** (gain_db / 40.0)
    cosw, alpha = _rbj(fc, fs, q)
    return _norm(1 + alpha * a, -2 * cosw, 1 - alpha * a, 1 + alpha / a, -2 * cosw, 1 - alpha / a)


def low_shelf(fc: float, fs: float, gain_db: float, q: float = 0.7071067811865476) -> Biquad:
    a = 10.0 ** (gain_db / 40.0)
    cosw, alpha = _rbj(fc, fs, q)
    two_sqrt_a_alpha = 2.0 * math.sqrt(a) * alpha
    return _norm(
        a * ((a + 1) - (a - 1) * cosw + two_sqrt_a_alpha),
        2 * a * ((a - 1) - (a + 1) * cosw),
        a * ((a + 1) - (a - 1) * cosw - two_sqrt_a_alpha),
        (a + 1) + (a - 1) * cosw + two_sqrt_a_alpha,
        -2 * ((a - 1) + (a + 1) * cosw),
        (a + 1) + (a - 1) * cosw - two_sqrt_a_alpha,
    )


def high_shelf(fc: float, fs: float, gain_db: float, q: float = 0.7071067811865476) -> Biquad:
    a = 10.0 ** (gain_db / 40.0)
    cosw, alpha = _rbj(fc, fs, q)
    two_sqrt_a_alpha = 2.0 * math.sqrt(a) * alpha
    return _norm(
        a * ((a + 1) + (a - 1) * cosw + two_sqrt_a_alpha),
        -2 * a * ((a - 1) + (a + 1) * cosw),
        a * ((a + 1) + (a - 1) * cosw - two_sqrt_a_alpha),
        (a + 1) - (a - 1) * cosw + two_sqrt_a_alpha,
        2 * ((a - 1) - (a + 1) * cosw),
        (a + 1) - (a - 1) * cosw - two_sqrt_a_alpha,
    )


# --------------------------------------------------------------------------
# state space + blocked plan
# --------------------------------------------------------------------------

def biquad_state_space(bq: Biquad):
    """DF2-transposed state space: s in R^2, y = C s + D x."""
    a_mat = np.array([[-bq.a1, 1.0], [-bq.a2, 0.0]], dtype=np.float64)
    b_vec = np.array([bq.b1 - bq.a1 * bq.b0, bq.b2 - bq.a2 * bq.b0], dtype=np.float64)
    c_vec = np.array([1.0, 0.0], dtype=np.float64)
    d = float(bq.b0)
    return a_mat, b_vec, c_vec, d


def cascade_state_space(biquads: tuple[Biquad, ...]):
    """Series connection of biquads -> one (A, B, C, D) of order 2*len."""
    a_mat, b_vec, c_vec, d = biquad_state_space(biquads[0])
    for bq in biquads[1:]:
        a2, b2, c2, d2 = biquad_state_space(bq)
        n1, n2 = a_mat.shape[0], a2.shape[0]
        a_new = np.zeros((n1 + n2, n1 + n2))
        a_new[:n1, :n1] = a_mat
        a_new[n1:, n1:] = a2
        a_new[n1:, :n1] = np.outer(b2, c_vec)
        b_new = np.concatenate([b_vec, b2 * d])
        c_new = np.concatenate([c_vec * d2, c2])
        a_mat, b_vec, c_vec, d = a_new, b_new, c_new, d * d2
    return a_mat, b_vec, c_vec, d


@dataclass(frozen=True)
class IIRPlan:
    """Precomputed blocked-scan matrices for one biquad cascade."""

    order: int  # state dimension (2 * n_stages)
    block: int
    t_mat: np.ndarray  # [Bk, Bk] lower-tri Toeplitz of impulse response (f32)
    o_mat: np.ndarray  # [Bk, order]  state -> output contribution
    u_mat: np.ndarray  # [order, Bk]  input -> next-state contribution
    a_pow: np.ndarray  # [order, order]  A^Bk
    a_pows: np.ndarray  # [Bk + 1, order, order]  A^k for exact partial blocks


@lru_cache(maxsize=64)
def make_iir_plan(biquads: tuple[Biquad, ...], block: int = 128) -> IIRPlan:
    a_mat, b_vec, c_vec, d = cascade_state_space(tuple(biquads))
    n = a_mat.shape[0]
    # impulse response h[0..block-1] and powers of A, exactly, in f64
    h = np.zeros(block, dtype=np.float64)
    h[0] = d
    powers = np.zeros((block + 1, n, n), dtype=np.float64)
    powers[0] = np.eye(n)
    for k in range(1, block + 1):
        powers[k] = a_mat @ powers[k - 1]
    for k in range(1, block):
        h[k] = c_vec @ powers[k - 1] @ b_vec
    idx = np.arange(block)
    t_mat = np.where(idx[:, None] >= idx[None, :], h[np.maximum(idx[:, None] - idx[None, :], 0)], 0.0)
    o_mat = np.stack([c_vec @ powers[i] for i in range(block)])  # [Bk, n]
    u_mat = np.stack([powers[block - 1 - j] @ b_vec for j in range(block)], axis=1)  # [n, Bk]
    return IIRPlan(
        n,
        block,
        t_mat.astype(np.float32),
        o_mat.astype(np.float32),
        u_mat.astype(np.float32),
        powers[block].astype(np.float32),
        powers.astype(np.float32),
    )


def iir_apply(
    x: jnp.ndarray,
    plan: IIRPlan,
    zi: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Filter ``x [..., T]`` through the cascade. Returns (y, final_state).

    ``zi [..., order]`` is the initial state (zeros if None) — it is both the
    streaming carry and the checkpoint format. T need not be a block
    multiple: the tail runs through exact partial-block matrices, so the
    returned state is the state at sample T (not advanced through padding).
    """
    t_len = x.shape[-1]
    bk = plan.block
    n_full = t_len // bk
    tail = t_len - n_full * bk
    lead = x.shape[:-1]
    if t_len == 0:
        return x, (zi if zi is not None else jnp.zeros((*lead, plan.order), x.dtype))
    dt = x.dtype if x.dtype != jnp.float64 else jnp.float32
    t_m = jnp.asarray(plan.t_mat, dt)
    o_m = jnp.asarray(plan.o_mat, dt)
    u_m = jnp.asarray(plan.u_mat, dt)
    a_p = jnp.asarray(plan.a_pow, dt)
    if zi is None:
        zi = jnp.zeros((*lead, plan.order), dt)

    def step(s, xb):
        y = mm(xb, t_m.T) + mm(s, o_m.T)
        s_next = mm(s, a_p.T) + mm(xb, u_m.T)
        return s_next.astype(dt), y.astype(dt)

    s_end = zi
    y_main = None
    if n_full:
        blocks = jnp.moveaxis(
            x[..., : n_full * bk].reshape(*lead, n_full, bk), -2, 0
        )  # [n_full, ..., Bk]
        s_end, ys = jax.lax.scan(step, zi, blocks)
        y_main = jnp.moveaxis(ys, 0, -2).reshape(*lead, n_full * bk)
    if tail == 0:
        return y_main, s_end

    # exact partial block: y = x_t @ T[:tail,:tail]^t + s @ O[:tail]^t,
    # s' = s @ (A^tail)^t + x_t @ U[:, Bk-tail:]^t (u_mat[:, j] = A^(Bk-1-j) B)
    xt = x[..., n_full * bk :]
    y_tail = mm(xt, jnp.asarray(plan.t_mat[:tail, :tail], dt).T) + mm(
        s_end, jnp.asarray(plan.o_mat[:tail], dt).T
    )
    s_out = mm(s_end, jnp.asarray(plan.a_pows[tail], dt).T) + mm(
        xt, jnp.asarray(plan.u_mat[:, bk - tail :], dt).T
    )
    y_tail = y_tail.astype(dt)
    s_out = s_out.astype(dt)
    if y_main is None:
        return y_tail, s_out
    return jnp.concatenate([y_main, y_tail], axis=-1), s_out


def biquad_chain(
    x: jnp.ndarray,
    biquads: tuple[Biquad, ...] | list[Biquad],
    block: int = 128,
    zi: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Convenience: design plan + apply in one call (plans are LRU-cached)."""
    plan = make_iir_plan(tuple(biquads), block)
    return iir_apply(x, plan, zi)
