"""Sequence parallelism: one long signal sharded over the TIME axis.

Batch sharding (the default, `parallel/__init__.py`) scales by files; this
module scales a SINGLE long signal across chips — the "sequence parallel"
axis. The only cross-chip dependency in a framed frontend is the frame
overlap at shard boundaries, so each shard fetches a halo of
``n_fft - hop`` samples from its right neighbor with ONE
``jax.lax.ppermute`` between neighbor devices and then frames/transforms purely locally —
no all-gather, no resharding of the big tensor, and the spectral output
stays sharded over its frame axis for downstream frame-local stages
(mel/log/features). The halo is the SPMD analog of the streaming carry
(SURVEY §5.7): same math, chips instead of scan steps.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "sequence_sharded_fir",
    "sequence_sharded_frontend",
    "sequence_sharded_graph",
    "sequence_sharded_iir",
    "sequence_sharded_limiter",
    "sequence_sharded_master",
    "sequence_sharded_resample",
    "sequence_sharded_spectrogram",
]


def _validate_2d(x, what):
    from ..errors import AudioError, ErrorCode

    if x.ndim != 2:
        raise AudioError(
            f"{what} takes [batch, T], got {x.shape}",
            code=ErrorCode.SHAPE_MISMATCH,
        )


def sequence_sharded_spectrogram(
    x: jnp.ndarray,
    mesh: Mesh,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    power: bool = True,
    precision: str | None = None,
    axis: str = "data",
    win_length: int | None = None,
    impl: str = "matmul",
):
    """Spectrogram of ``x [batch, T]`` with T sharded over ``mesh[axis]``.

    Requires ``T % (n_devices * hop) == 0`` and a local shard of at least
    ``n_fft`` samples. Returns ``[batch, T // hop, bins]`` sharded over the
    frame axis; frames 0 .. (T - n_fft) // hop agree with the unsharded
    ``ops.spectrogram(x, center=False)`` to f32 reassociation (~1e-6
    relative — identical framing and banks, different dot batching); the
    trailing frames window into a zero tail (the last shard has no right
    neighbor), the streaming zero-pad convention.

    Collective footprint: exactly one ``ppermute`` of the
    ``n_fft - hop``-sample halo per shard — asserted collective-free
    otherwise in the tests (no all-gather of the signal).
    """
    from ..errors import AudioError, ErrorCode
    from ..ops import spectrogram

    n_dev = mesh.shape[axis]
    t = x.shape[-1]
    if x.ndim != 2:
        raise AudioError(
            f"sequence_sharded_spectrogram takes [batch, T], got {x.shape}",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    if t % (n_dev * hop):
        raise AudioError(
            f"T = {t} must divide into {n_dev} shards of whole hops "
            f"(T % (n_devices * hop) == 0; hop = {hop})",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    local_t = t // n_dev
    if local_t < n_fft:
        raise AudioError(
            f"local shard {local_t} < n_fft {n_fft}; use fewer devices or "
            f"longer input",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    halo = n_fft - hop

    def local(xl):
        # xl [batch, local_t]; fetch the right neighbor's first `halo`
        # samples (the last shard receives ppermute's zero fill = the global
        # zero-pad tail convention)
        if halo > 0:
            nxt = jax.lax.ppermute(
                xl[..., :halo], axis,
                perm=[(i + 1, i) for i in range(n_dev - 1)],
            )
            xe = jnp.concatenate([xl, nxt], axis=-1)
        else:
            xe = xl
        # (local_t + halo - n_fft) // hop + 1 == local_t // hop frames
        return spectrogram(
            xe, n_fft, hop, window=window, win_length=win_length,
            center=False, power=power, impl=impl, precision=precision,
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P(None, axis),
        out_specs=P(None, axis, None),
    )
    xs = jax.device_put(x, NamedSharding(mesh, P(None, axis)))
    return fn(xs)


def sequence_sharded_resample(
    x: jnp.ndarray,
    mesh: Mesh,
    input_rate: int,
    output_rate: int,
    mode: str = "kaiser",
    precision: str | None = None,
    axis: str = "data",
    **plan_kwargs,
):
    """Resample ``x [batch, T]`` with T sharded over ``mesh[axis]``.

    The polyphase band matmul's only cross-shard dependency is the filter
    support at shard boundaries: each shard fetches ``plan.history`` samples
    from its LEFT neighbor and ``plan.lookahead`` from its RIGHT neighbor —
    two ``ppermute`` halo exchanges (the SPMD analog of the streaming
    resampler's carried history + chunk lookahead, ops/resample.py
    StreamResamplePlan) — then runs the identical banded block-matmul
    purely locally. The edge shards receive ppermute's zero fill, which IS
    the offline convention (zero prehistory, zero-pad tail,
    resampler.rs:150-166), so the result equals the unsharded
    :func:`~audioflow_tpu.ops.resample` output exactly (same blocks, same
    weights — tested at 1e-6).

    Requires ``T % (n_devices * plan.ipb) == 0`` (the streaming chunk
    granularity, `ops.resample.stream_chunk_multiple`); returns
    ``[batch, T * up / down]`` sharded over the output time axis.
    """
    from ..errors import AudioError, ErrorCode
    from ..ops.resample import _banded_matmul, make_plan

    if input_rate == output_rate:
        return jax.device_put(x, NamedSharding(mesh, P(None, axis)))
    plan = make_plan(input_rate, output_rate, mode, **plan_kwargs)
    _validate_2d(x, "sequence_sharded_resample")
    n_dev = mesh.shape[axis]
    t = x.shape[-1]
    if t % (n_dev * plan.ipb):
        raise AudioError(
            f"T = {t} must divide into {n_dev} shards of whole resample "
            f"blocks (T % (n_devices * {plan.ipb}) == 0 for "
            f"{input_rate}->{output_rate})",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    local_t = t // n_dev
    hist, look = plan.history, plan.lookahead
    if local_t < max(hist, look):
        raise AudioError(
            f"local shard {local_t} < filter halo {max(hist, look)}; use "
            f"fewer devices or longer input",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    n_blocks = local_t // plan.ipb

    def local(xl):
        parts = []
        if hist:
            parts.append(jax.lax.ppermute(
                xl[..., -hist:], axis,
                perm=[(i, i + 1) for i in range(n_dev - 1)],
            ))
        parts.append(xl)
        if look:
            parts.append(jax.lax.ppermute(
                xl[..., :look], axis,
                perm=[(i + 1, i) for i in range(n_dev - 1)],
            ))
        xe = jnp.concatenate(parts, axis=-1) if len(parts) > 1 else xl
        dt = xe.dtype if xe.dtype != jnp.float64 else jnp.float32
        y = _banded_matmul(xe, plan.matrix, n_blocks, plan.ipb, dt, precision)
        return y.reshape(*xl.shape[:-1], n_blocks * plan.block_out).astype(xl.dtype)

    fn = jax.shard_map(local, mesh=mesh, in_specs=P(None, axis), out_specs=P(None, axis))
    return fn(jax.device_put(x, NamedSharding(mesh, P(None, axis))))


def sequence_sharded_fir(
    x: jnp.ndarray,
    mesh: Mesh,
    h,
    axis: str = "data",
):
    """Causal FIR of ``x [batch, T]`` with T sharded over ``mesh[axis]``.

    ``y[n] = sum_k h[k] x[n-k]`` needs exactly ``K-1`` samples of left
    context per shard — the streaming carry ``zi`` of
    :func:`~audioflow_tpu.ops.fir_apply` — fetched with ONE ``ppermute``
    from the left neighbor (shard 0 receives zero fill = the offline zero
    prehistory). Each shard then runs the XLA conv locally (impl='direct';
    the conv partitions cleanly, unlike the FFT path — see
    tests/test_parallel.py FFT sharding notes). Same-length output, sharded
    over the same time axis; equals the unsharded op exactly.
    """
    from ..errors import AudioError, ErrorCode
    from ..ops.fir import fir_apply

    _validate_2d(x, "sequence_sharded_fir")
    h = np.asarray(h)
    k = h.shape[-1]
    n_dev = mesh.shape[axis]
    t = x.shape[-1]
    if t % n_dev:
        raise AudioError(
            f"T = {t} must divide over {n_dev} devices",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    if t // n_dev < k - 1:
        raise AudioError(
            f"local shard {t // n_dev} < K-1 = {k - 1} halo; use fewer "
            f"devices or longer input",
            code=ErrorCode.SHAPE_MISMATCH,
        )

    def local(xl):
        hj = jnp.asarray(h, xl.dtype)
        if k > 1:
            zi = jax.lax.ppermute(
                xl[..., -(k - 1):], axis,
                perm=[(i, i + 1) for i in range(n_dev - 1)],
            )
        else:
            zi = None
        y, _ = fir_apply(xl, hj, zi=zi, impl="direct")
        return y

    fn = jax.shard_map(local, mesh=mesh, in_specs=P(None, axis), out_specs=P(None, axis))
    return fn(jax.device_put(x, NamedSharding(mesh, P(None, axis))))


from functools import lru_cache


@lru_cache(maxsize=32)
def _iir_shard_aux(biquads: tuple, block: int, local_t: int):
    """Host-side pieces for the time-sharded IIR: the cascade plan, the
    shard-length state-transition ``M = (A^L)^T`` (the cross-shard carry
    map), and the truncated observability matrix ``Q[n] = C A^n`` (the
    initial-state output response, cut where it decays below 1e-10 — a few
    thousand rows for any stable EQ). All float64, cast to f32."""
    from ..ops.biquad import cascade_state_space, make_iir_plan

    plan = make_iir_plan(biquads, block)
    a_mat, b_vec, c_vec, _d = cascade_state_space(biquads)
    m = np.linalg.matrix_power(a_mat, local_t)
    rows, q = [], c_vec.astype(np.float64)
    while len(rows) < local_t:
        rows.append(q)
        if np.abs(q).max() < 1e-10:
            break
        q = q @ a_mat
    q_mat = np.stack(rows)  # [n_eff, order]
    return plan, m.T.astype(np.float32), q_mat.astype(np.float32)


def sequence_sharded_iir(
    x: jnp.ndarray,
    mesh: Mesh,
    biquads,
    block: int = 128,
    axis: str = "data",
):
    """Biquad-cascade IIR of ``x [batch, T]`` with T sharded over
    ``mesh[axis]`` (SURVEY §7.3 #1 across chips).

    An IIR has no finite halo — every output sample depends on ALL earlier
    input — so the finite-halo ppermute pattern of the other SP ops cannot
    apply. But the streaming carry is a state vector evolving AFFINELY:
    ``s_out = s_in @ (A^L)^T + v`` where ``v`` is the shard's local
    response from rest. Affine maps compose associatively, so:

    1. every shard runs the blocked state-space filter locally from rest
       (``ops.biquad.iir_apply``, zi=0) -> local output ``y0`` + final
       state ``v`` ``[batch, order]``;
    2. ONE ``all_gather`` of the tiny states (``n_dev * batch * order``
       floats — e.g. 8*2*12 = 192) and an unrolled n_dev-step affine
       prefix give each shard its exact incoming state ``s_in``;
    3. the output correction is a single matmul: ``y = y0 + s_in @ Q^T``
       with ``Q[n] = C A^n`` truncated where the response decays below
       f32 significance (exact by linearity: output = zero-state response
       + zero-input response).

    Collective footprint: exactly one small all-gather — the big signal
    never moves. Equals the unsharded :func:`~audioflow_tpu.ops.biquad_chain`
    to f32 reassociation (~1e-6, tested < 1e-5).
    """
    from ..errors import AudioError, ErrorCode
    from ..ops._mm import mm
    from ..ops.biquad import iir_apply

    _validate_2d(x, "sequence_sharded_iir")
    n_dev = mesh.shape[axis]
    t = x.shape[-1]
    if t % n_dev:
        raise AudioError(
            f"T = {t} must divide over {n_dev} devices",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    local_t = t // n_dev
    plan, m_t, q_mat = _iir_shard_aux(tuple(biquads), block, local_t)
    n_eff = q_mat.shape[0]

    def local(xl):
        # zero initial state, marked device-varying for shard_map's scan
        zi0 = jax.lax.pcast(
            jnp.zeros((*xl.shape[:-1], plan.order), xl.dtype),
            (axis,), to="varying",
        )
        y0, v = iir_apply(xl, plan, zi=zi0)  # zero-state local pass
        vg = jax.lax.all_gather(v, axis)  # [n_dev, batch, order] (tiny)
        m_dev = jnp.asarray(m_t, v.dtype)
        s = jnp.zeros_like(v)
        prefixes = [s]
        for j in range(n_dev - 1):  # static unroll; s_in[i+1] = s_in[i]M + v[i]
            s = mm(s, m_dev) + vg[j]
            prefixes.append(s)
        s_in = jax.lax.dynamic_index_in_dim(
            jnp.stack(prefixes), jax.lax.axis_index(axis), 0, keepdims=False
        )
        corr = mm(s_in, jnp.asarray(q_mat, v.dtype).T)  # [batch, n_eff]
        return y0.at[..., :n_eff].add(corr.astype(y0.dtype))

    fn = jax.shard_map(local, mesh=mesh, in_specs=P(None, axis), out_specs=P(None, axis))
    return fn(jax.device_put(x, NamedSharding(mesh, P(None, axis))))


def _sequence_sharded_env_gain(
    x: jnp.ndarray,
    mesh: Mesh,
    release_ms: float,
    sample_rate: int,
    gain_fn,
    axis: str,
    what: str,
):
    """Shared skeleton of the time-sharded peak-release dynamics family
    (limiter / compressor / noise gate — they differ only in the gain map
    applied to the envelope).

    The instant-attack/exponential-release envelope
    ``e[n] = max(|x[n]|, r e[n-1])`` is max-plus AFFINE in log space
    (``le -> max(le + L log r, m_local)``), so the cross-shard carry
    composes exactly like :func:`sequence_sharded_iir`'s linear state:
    local log-domain cummax from rest, one all-gather of the scalar
    per-shard carries, an unrolled max-plus prefix, and an elementwise
    correction ``le[n] = max(le0[n], le_in + (n+1) log r)`` (the incoming
    envelope decays through the shard — the max-plus analog of ``C A^n``).
    Matches the unsharded envelope to f32 log/exp rounding.
    """
    from ..errors import AudioError, ErrorCode

    _validate_2d(x, what)
    n_dev = mesh.shape[axis]
    t = x.shape[-1]
    if t % n_dev:
        raise AudioError(
            f"T = {t} must divide over {n_dev} devices",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    local_t = t // n_dev
    log_r = float(np.log(np.exp(-1.0 / (release_ms * 1e-3 * sample_rate))))
    neg = jnp.float32(-1e30)

    from ..ops.dynamics import log_envelope_from_rest

    def local(xl):
        le0 = log_envelope_from_rest(jnp.log(jnp.maximum(jnp.abs(xl), 1e-30)), log_r)
        m_i = le0[..., -1]  # per-shard max-plus carry [batch]
        mg = jax.lax.all_gather(m_i, axis)  # [n_dev, batch] (tiny)
        le = jnp.full_like(m_i, neg)
        prefixes = [le]
        for j in range(n_dev - 1):  # le_in[i+1] = max(le_in[i] + L lr, m[i])
            le = jnp.maximum(le + local_t * log_r, mg[j])
            prefixes.append(le)
        le_in = jax.lax.dynamic_index_in_dim(
            jnp.stack(prefixes), jax.lax.axis_index(axis), 0, keepdims=False
        )
        decay = le_in[..., None] + (
            jnp.arange(1, local_t + 1, dtype=xl.dtype) * log_r
        )
        env = jnp.exp(jnp.maximum(le0, decay))
        return xl * gain_fn(env)

    fn = jax.shard_map(local, mesh=mesh, in_specs=P(None, axis), out_specs=P(None, axis))
    return fn(jax.device_put(x, NamedSharding(mesh, P(None, axis))))


def sequence_sharded_limiter(
    x: jnp.ndarray,
    mesh: Mesh,
    threshold_db: float = -1.0,
    release_ms: float = 50.0,
    sample_rate: int = 16000,
    axis: str = "data",
):
    """Peak limiter of ``x [batch, T]`` with T sharded over ``mesh[axis]``
    (see :func:`_sequence_sharded_env_gain` for the max-plus carry math).
    Matches the unsharded :func:`~audioflow_tpu.ops.limiter` to f32
    log/exp rounding."""
    thresh = 10.0 ** (threshold_db / 20.0)

    def gain(env):
        return jnp.minimum(1.0, thresh / jnp.maximum(env, 1e-30))

    return _sequence_sharded_env_gain(
        x, mesh, release_ms, sample_rate, gain, axis, "sequence_sharded_limiter"
    )


def sequence_sharded_master(
    x: jnp.ndarray,
    mesh: Mesh,
    sample_rate: int = 16000,
    bands: tuple | None = None,
    limiter_db: float = -1.0,
    release_ms: float = 50.0,
    axis: str = "data",
):
    """Benchmark config 3 (high-pass + 5-band EQ + limiter,
    ``models.master_chain_graph``) on ONE long signal, time-sharded end to
    end: the EQ's linear state and the limiter's max-plus envelope both
    ride the affine-carry composition — two tiny all-gathers total, the
    signal itself never leaves its shard."""
    if bands is None:
        from ..models.pipelines import eq_bands_default  # lazy: no cycle

        bands = eq_bands_default(sample_rate)
    y = sequence_sharded_iir(x, mesh, bands, axis=axis)
    return sequence_sharded_limiter(
        y, mesh, limiter_db, release_ms, sample_rate, axis=axis
    )


def _sequence_sharded_framed(
    x: jnp.ndarray,
    mesh: Mesh,
    halo: int,
    hop: int,
    n_fft: int,
    local_apply,
    axis: str,
    what: str,
):
    """Generic right-halo framed stage: fetch ``halo`` samples from the
    right neighbor (= the node's streaming overlap carry, exchanged across
    chips instead of scan steps), run the node's offline center=False op on
    the extended shard, keep the shard's own ``local_t // hop`` frames.
    ``halo`` must be >= ``n_fft - hop`` and a hop multiple (every framed
    node's ``_carry_len`` is)."""
    from ..errors import AudioError, ErrorCode

    _validate_2d(x, what)
    n_dev = mesh.shape[axis]
    t = x.shape[-1]
    if t % (n_dev * hop):
        raise AudioError(
            f"{what}: T = {t} must divide into {n_dev} shards of whole hops "
            f"(T % (n_devices * hop) == 0; hop = {hop})",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    local_t = t // n_dev
    if local_t < n_fft:
        raise AudioError(
            f"{what}: local shard {local_t} < n_fft {n_fft}; use fewer "
            f"devices or longer input",
            code=ErrorCode.SHAPE_MISMATCH,
        )

    def local(xl):
        if halo > 0:
            nxt = jax.lax.ppermute(
                xl[..., :halo], axis,
                perm=[(i + 1, i) for i in range(n_dev - 1)],
            )
            xe = jnp.concatenate([xl, nxt], axis=-1)
        else:
            xe = xl
        out = local_apply(xe)
        return out[..., : local_t // hop, :]

    fn = jax.shard_map(
        local, mesh=mesh, in_specs=P(None, axis), out_specs=P(None, axis, None)
    )
    return fn(jax.device_put(x, NamedSharding(mesh, P(None, axis))))


def _sequence_sharded_preemphasis(
    x: jnp.ndarray, mesh: Mesh, coeff: float, axis: str
):
    """Time-sharded first-order pre-emphasis: one 1-sample left halo
    ppermute; shard 0 applies the Kaldi position-0 convention (prev of the
    very first sample is the sample itself — graph/nodes.py Preemphasis),
    which in SPMD is simply "the shard holding global position 0"."""
    from ..errors import AudioError, ErrorCode

    _validate_2d(x, "sequence_sharded_preemphasis")
    n_dev = mesh.shape[axis]
    t = x.shape[-1]
    if t % n_dev:
        raise AudioError(
            f"T = {t} must divide over {n_dev} devices",
            code=ErrorCode.SHAPE_MISMATCH,
        )

    def local(xl):
        prev_last = jax.lax.ppermute(
            xl[..., -1:], axis, perm=[(i, i + 1) for i in range(n_dev - 1)]
        )
        prev = jnp.concatenate([prev_last, xl[..., :-1]], axis=-1)
        first_here = (jax.lax.axis_index(axis) == 0) & (
            jax.lax.iota(jnp.int32, xl.shape[-1]) == 0
        )
        prev = jnp.where(first_here, xl, prev)
        return xl - coeff * prev

    fn = jax.shard_map(local, mesh=mesh, in_specs=P(None, axis), out_specs=P(None, axis))
    return fn(jax.device_put(x, NamedSharding(mesh, P(None, axis))))


def _sequence_sharded_deltas(
    x: jnp.ndarray, mesh: Mesh, width: int, axis: str
):
    """Time-sharded first-order delta features over ``x [B, T, F]`` with the
    FRAME axis sharded: fetch ``width // 2`` frames from BOTH neighbors
    (two ppermutes), run the offline op on the extended block, slice the
    shard's own frames. The global edge shards replace ppermute's zero
    fill with their own first/last frame repeated — exactly the offline
    op's edge replication, so the result equals unsharded
    :func:`~audioflow_tpu.ops.add_deltas` end to end (orders=(1,); higher
    orders replicate the INTERMEDIATE delta sequence at the global edges,
    which a finite halo cannot reproduce — the same reason they have no
    streaming form, graph/nodes.py::Deltas)."""
    from ..errors import AudioError, ErrorCode
    from ..ops import add_deltas

    if x.ndim != 3:
        raise AudioError(
            f"sequence_sharded_deltas takes [batch, frames, bins], got {x.shape}",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    n_dev = mesh.shape[axis]
    t = x.shape[-2]
    n_side = width // 2
    if t % n_dev:
        raise AudioError(
            f"frames = {t} must divide over {n_dev} devices",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    if t // n_dev < n_side:
        raise AudioError(
            f"local shard {t // n_dev} frames < halo {n_side}; use fewer "
            f"devices or longer input",
            code=ErrorCode.SHAPE_MISMATCH,
        )

    def local(xl):
        idx = jax.lax.axis_index(axis)
        left = jax.lax.ppermute(
            xl[:, -n_side:], axis, perm=[(i, i + 1) for i in range(n_dev - 1)]
        )
        right = jax.lax.ppermute(
            xl[:, :n_side], axis, perm=[(i + 1, i) for i in range(n_dev - 1)]
        )
        rep_first = jnp.repeat(xl[:, :1], n_side, axis=1)
        rep_last = jnp.repeat(xl[:, -1:], n_side, axis=1)
        left = jnp.where(idx == 0, rep_first, left)
        right = jnp.where(idx == n_dev - 1, rep_last, right)
        xe = jnp.concatenate([left, xl, right], axis=1)
        out = add_deltas(xe, width, (1,))
        return out[:, n_side : n_side + xl.shape[1]]

    fn = jax.shard_map(
        local, mesh=mesh, in_specs=P(None, axis, None),
        out_specs=P(None, axis, None),
    )
    return fn(jax.device_put(x, NamedSharding(mesh, P(None, axis, None))))


def sequence_sharded_graph(graph, mesh: Mesh, axis: str = "data"):
    """Map a :class:`~audioflow_tpu.graph.Graph` node chain onto time-sharded
    execution (the product surface over the
    ``sequence_sharded_*`` machinery): returns ``fn(x [batch, T])`` running
    every node with T sharded over ``mesh[axis]`` — finite-halo framed
    nodes ride their streaming-carry halos (one ppermute each), the
    IIR/limiter family rides the affine/max-plus carry composition (one
    tiny all-gather each), frame-local nodes run purely locally, and the
    big tensors never leave their shards. Call via
    ``parallel.compile_sharded(graph, mesh, shard="time")``.

    Node coverage (a node outside it raises a typed
    ``CONFIG_VALIDATION_ERROR`` naming itself):

    * halo: ``Spectrogram`` / ``LogMelSpec`` (center=False — the sharded
      frame grid cannot reflect-pad globally), ``Resample``, ``Fir``,
      ``Preemphasis`` (1-sample halo + the Kaldi position-0 convention on
      the shard holding global sample 0);
    * carry composition: ``BiquadChain`` (affine state), ``Limiter`` /
      ``Compressor`` / ``NoiseGate`` (max-plus envelope);
    * global statistics: ``Cmvn`` (per-utterance mean/var over the sharded
      frame axis — GSPMD reduces it to one tiny all-reduce);
    * frame halo: ``Deltas`` (orders=(1,) — width//2 frames from both
      neighbors, global-edge replication on the end shards);
    * local: ``Gain``, ``Magnitude``, ``Power``, ``MelProject``, ``Mfcc``,
      ``QuantizeI16`` (sample/frame-local — GSPMD keeps them collective-
      free, asserted in tests);
    * ``Stft`` raises: XLA's FFT op does not partition (it would all-gather
      the time axis) — use ``Spectrogram`` (matmul DFT) instead.

    Output equals the unsharded ``graph.chain`` on the fully-covered
    region: framed stages zero-fill past the final shard (the streaming
    zero-pad tail convention), matching offline up to the last
    ``ceil(n_fft/hop) - 1`` frames; sample-domain chains match end to end.
    """
    from ..errors import AudioError, ErrorCode
    from ..graph.nodes import (
        BiquadChain, Cmvn, Compressor, Deltas, Fir, Gain, Limiter,
        LogMelSpec, Magnitude, MelProject, Mfcc, NoiseGate, Power,
        Preemphasis, QuantizeI16, Resample, Spectrogram, Stft,
    )
    from ..ops import dynamics as _dyn
    from ..ops import spectrogram as _spec_op

    local_types = (Gain, Magnitude, Power, MelProject, Mfcc, QuantizeI16)
    stages = []
    for i, node in enumerate(graph.nodes):
        name = f"node {i} ({type(node).__name__})"
        if isinstance(node, Resample):
            stages.append(
                lambda x, n=node: sequence_sharded_resample(
                    x, mesh, n.input_rate, n.output_rate, n.mode, axis=axis
                )
            )
        elif isinstance(node, Spectrogram):
            if node.center:
                raise AudioError(
                    f"{name}: time sharding needs center=False (the sharded "
                    "frame grid cannot reflect-pad globally)",
                    code=ErrorCode.CONFIG_VALIDATION_ERROR,
                )
            stages.append(
                # n=node early-binds the loop variable at BOTH lambda depths
                # (the inner default n=n evaluates when the outer runs, so it
                # must reference the outer's parameter, not the loop var)
                lambda x, n=node: _sequence_sharded_framed(
                    x, mesh, n._carry_len, n.hop, n.n_fft,
                    lambda xe, n=n: _spec_op(
                        xe, n.n_fft, n.hop, n.window, n.win_length,
                        center=False, power=n.power, impl=n.impl,
                        precision=n.precision,
                    ),
                    axis, f"sequence_sharded_graph[{type(n).__name__}]",
                )
            )
        elif isinstance(node, LogMelSpec):
            if node.center:
                raise AudioError(
                    f"{name}: time sharding needs center=False (the sharded "
                    "frame grid cannot reflect-pad globally)",
                    code=ErrorCode.CONFIG_VALIDATION_ERROR,
                )
            stages.append(
                lambda x, n=node: _sequence_sharded_framed(
                    x, mesh, n._carry_len, n.hop, n.n_fft,
                    lambda xe: n._run(xe, False),
                    axis, f"sequence_sharded_graph[{type(n).__name__}]",
                )
            )
        elif isinstance(node, Stft):
            raise AudioError(
                f"{name}: XLA's FFT op does not partition over the time axis "
                "(it would all-gather the signal); use Spectrogram (matmul "
                "DFT) for time-sharded graphs",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )
        elif isinstance(node, Fir):
            stages.append(
                lambda x, n=node: sequence_sharded_fir(x, mesh, n._h(), axis=axis)
            )
        elif isinstance(node, Preemphasis):
            stages.append(
                lambda x, n=node: _sequence_sharded_preemphasis(
                    x, mesh, n.coeff, axis
                )
            )
        elif isinstance(node, Deltas):
            if tuple(node.orders) != (1,):
                raise AudioError(
                    f"{name}: time sharding supports orders=(1,) only "
                    "(higher orders edge-replicate the intermediate delta "
                    "sequence at the global edges, which a finite halo "
                    "cannot reproduce — same limit as streaming)",
                    code=ErrorCode.CONFIG_VALIDATION_ERROR,
                )
            stages.append(
                lambda x, n=node: _sequence_sharded_deltas(
                    x, mesh, n.width, axis
                )
            )
        elif isinstance(node, Cmvn):
            # per-utterance statistics over the SHARDED frame axis: apply
            # directly — GSPMD turns the time mean/var into one tiny
            # all-reduce of the per-shard sums (exact; the one legitimate
            # all-reduce a time-sharded chain can carry)
            stages.append(lambda x, n=node: n.apply(x))
        elif isinstance(node, BiquadChain):
            stages.append(
                lambda x, n=node: sequence_sharded_iir(
                    x, mesh, n.biquads, n.block, axis=axis
                )
            )
        elif isinstance(node, Limiter):
            stages.append(
                lambda x, n=node: sequence_sharded_limiter(
                    x, mesh, n.threshold_db, n.release_ms, n.sample_rate,
                    axis=axis,
                )
            )
        elif isinstance(node, Compressor):
            stages.append(
                lambda x, n=node: _sequence_sharded_env_gain(
                    x, mesh, n.release_ms, n.sample_rate,
                    lambda env: _dyn.compressor_gain(
                        env, n.threshold_db, n.ratio, n.knee_db
                    ),
                    axis, "sequence_sharded_graph[Compressor]",
                )
            )
        elif isinstance(node, NoiseGate):
            stages.append(
                lambda x, n=node: _sequence_sharded_env_gain(
                    x, mesh, n.release_ms, n.sample_rate,
                    lambda env: _dyn.gate_gain(env, n.threshold_db, n.floor_db),
                    axis, "sequence_sharded_graph[NoiseGate]",
                )
            )
        elif isinstance(node, local_types):
            stages.append(lambda x, n=node: n.apply(x))
        else:
            raise AudioError(
                f"{name} has no sequence-parallel mapping; supported: "
                "Resample/Spectrogram/LogMelSpec/Fir (finite halo), "
                "BiquadChain (affine carry), Limiter/Compressor/NoiseGate "
                "(max-plus carry), Gain/Magnitude/Power/MelProject/Mfcc/"
                "QuantizeI16 (local). Batch-shard instead "
                "(compile_sharded(..., shard='batch')) or stream on one "
                "chip (Graph.scan_stream).",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def run(x):
        for s in stages:
            x = s(x)
        return x

    return run


def sequence_sharded_frontend(
    x: jnp.ndarray,
    mesh: Mesh,
    input_rate: int,
    output_rate: int,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 64,
    mode: str = "kaiser",
    window: str = "hann",
    log_base: str = "ln",
    precision: str | None = None,
    axis: str = "data",
):
    """The flagship decode->resample->log-mel frontend on ONE long signal,
    time-sharded end to end (SURVEY §2.6/§5.7's carry<=>halo claim realized
    across the whole chain).

    ``x [batch, T]`` at ``input_rate`` -> log-mel ``[batch, frames, n_mels]``
    with every stage sharded over ``mesh[axis]``: resample exchanges its
    filter halo, the spectrogram exchanges its frame-overlap halo, and the
    mel projection + log are frame-local — collective footprint is
    ppermutes ONLY (HLO-asserted in tests: zero gathers/reduces), and the
    big tensors never leave their shards. Equals the unsharded
    resample->spectrogram->log_mel pipeline on the fully-covered frames.

    Requires ``T % (n_devices * ipb) == 0`` (resample granularity) and the
    resampled shard length divisible by ``hop``.
    """
    from ..errors import AudioError, ErrorCode
    from ..ops import mel_filterbank
    from ..ops.mel import log_mel

    y = sequence_sharded_resample(
        x, mesh, input_rate, output_rate, mode, precision=precision, axis=axis
    )
    n_dev = mesh.shape[axis]
    if (y.shape[-1] // n_dev) % hop:
        raise AudioError(
            f"resampled shard {y.shape[-1] // n_dev} not a multiple of "
            f"hop {hop}; pick T so T*up/down divides into whole hops per "
            f"device",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    s = sequence_sharded_spectrogram(
        y, mesh, n_fft, hop, window=window, power=True, precision=precision,
        axis=axis,
    )
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, output_rate)
    return log_mel(s, jnp.asarray(fb), log_base=log_base)
