import numpy as np
import pytest
import scipy.signal

import jax.numpy as jnp

from audioflow_tpu.ops import make_plan, resample, resample_apply
from audioflow_tpu.ops.resample import cubic_lagrange_bank, kaiser_sinc_bank
from audioflow_tpu.utils import cdiv, rational_rate


def _prototype_from_bank(bank, up):
    """Reconstruct the odd-length prototype h_full from the polyphase bank."""
    k = bank.shape[1]
    h = np.zeros(k * up)
    for p in range(up):
        for t in range(k):
            h[(k - 1 - t) * up + p] = bank[p, t]
    # strip trailing structural zeros down to odd length 2*half*up+1
    n_total = 2 * ((k - 1) // 2) * up + 1
    return h[:n_total]


@pytest.mark.parametrize("in_rate,out_rate", [(48000, 16000), (44100, 16000), (16000, 48000), (22050, 16000)])
def test_kaiser_matches_scipy_resample_poly(rng, in_rate, out_rate):
    up, down = rational_rate(in_rate, out_rate)
    x = rng.standard_normal(8192).astype(np.float64)
    bank = kaiser_sinc_bank(up, down, half_width=16)
    h_full = _prototype_from_bank(bank, up)
    # scipy multiplies an array window by `up` internally; our bank already
    # carries the zero-stuffing gain, so divide it out for the oracle call
    want = scipy.signal.resample_poly(x, up, down, window=h_full / up)
    got = np.asarray(resample(jnp.asarray(x, jnp.float32), in_rate, out_rate, mode="kaiser"))
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_passthrough_same_rate(rng):
    x = jnp.asarray(rng.standard_normal(100).astype(np.float32))
    y = resample(x, 16000, 16000)
    np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


def test_sine_fidelity_44k_to_16k():
    """A bandlimited tone must survive resampling with correct frequency/amplitude."""
    f0, in_rate, out_rate = 1000.0, 44100, 16000
    t_in = np.arange(44100 * 2) / in_rate
    x = np.sin(2 * np.pi * f0 * t_in).astype(np.float32)
    y = np.asarray(resample(jnp.asarray(x), in_rate, out_rate, mode="kaiser"))
    t_out = np.arange(len(y)) / out_rate
    want = np.sin(2 * np.pi * f0 * t_out)
    # ignore filter edge transients
    m = 200
    np.testing.assert_allclose(y[m:-m], want[m : len(y) - m], atol=2e-3)


def _cubic_oracle(x, up, down, n_out):
    """Serial float64 cubic-Lagrange resampler: the rubato interp_cubic polynomial."""
    y = np.zeros(n_out)
    xp = np.pad(x.astype(np.float64), (1, 4))
    for n in range(n_out):
        q, p = divmod(n * down, up)
        f = p / up
        y0, y1, y2, y3 = xp[q : q + 4]  # x[q-1 : q+3] in original coords
        a0 = y1
        a1 = -y0 / 3.0 - y1 / 2.0 + y2 - y3 / 6.0
        a2 = (y0 + y2) / 2.0 - y1
        a3 = (y1 - y2) / 2.0 + (y3 - y0) / 6.0
        y[n] = ((a3 * f + a2) * f + a1) * f + a0
    return y


@pytest.mark.parametrize("in_rate,out_rate", [(48000, 16000), (44100, 16000), (16000, 24000)])
def test_cubic_matches_serial_oracle(rng, in_rate, out_rate):
    up, down = rational_rate(in_rate, out_rate)
    x = rng.standard_normal(2048).astype(np.float32)
    got = np.asarray(resample(jnp.asarray(x), in_rate, out_rate, mode="cubic"))
    want = _cubic_oracle(x, up, down, cdiv(2048 * up, down))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_cubic_bank_interpolates_exactly():
    """At f=0 the bank must return y1; Lagrange property: exact on cubics."""
    bank = cubic_lagrange_bank(8)
    np.testing.assert_allclose(bank[0], [0, 1, 0, 0], atol=1e-15)
    # cubic polynomial through points p(-1..2), check interpolation at f=3/8
    coeffs = np.array([0.3, -1.2, 0.5, 2.0])
    pts = np.polyval(coeffs, np.array([-1.0, 0.0, 1.0, 2.0]))
    got = bank[3] @ pts
    np.testing.assert_allclose(got, np.polyval(coeffs, 3 / 8), atol=1e-12)


def test_batched_resample(rng):
    x = rng.standard_normal((4, 3000)).astype(np.float32)
    y = np.asarray(resample(jnp.asarray(x), 48000, 16000))
    assert y.shape == (4, 1000)
    y0 = np.asarray(resample(jnp.asarray(x[0]), 48000, 16000))
    np.testing.assert_allclose(y[0], y0, atol=1e-6)


def test_plan_cached():
    p1 = make_plan(48000, 16000, "kaiser")
    p2 = make_plan(48000, 16000, "kaiser")
    assert p1 is p2


def test_resample_apply_explicit_n_out(rng):
    x = jnp.asarray(rng.standard_normal(1000).astype(np.float32))
    plan = make_plan(48000, 16000, "cubic")
    y = resample_apply(x, plan, n_out=100)
    assert y.shape == (100,)


def test_linear_mode(rng):
    """2-tap linear interpolation mode (rubato Linear analog)."""
    x = np.arange(300, dtype=np.float32)  # exactly linear signal
    y = np.asarray(resample(jnp.asarray(x), 48000, 32000, mode="linear"))
    # linear interp of a linear ramp is exact: y[n] = n * 1.5
    n = np.arange(len(y) - 3)
    np.testing.assert_allclose(y[: len(n)], n * 1.5, atol=1e-4)


@pytest.mark.parametrize("rates", [(8000, 48000), (96000, 16000), (22050, 44100)])
def test_extreme_ratio_round_trips(rng, rates):
    """Strong up/down ratios keep bandlimited content intact."""
    in_rate, out_rate = rates
    f0 = min(in_rate, out_rate) * 0.1
    t = np.arange(in_rate) / in_rate
    x = np.sin(2 * np.pi * f0 * t).astype(np.float32)
    y = np.asarray(resample(jnp.asarray(x), in_rate, out_rate))
    t2 = np.arange(len(y)) / out_rate
    want = np.sin(2 * np.pi * f0 * t2)
    m = len(y) // 10
    np.testing.assert_allclose(y[m:-m], want[m : len(y) - m], atol=5e-3)


# ---------------------------------------------------- rubato seam fixtures

def _rubato_fixture_path():
    """Path to the rubato seam golden npz, regenerating it from the
    deterministic serial-oracle generator if absent (.gitignore excludes
    *.npz, so a fresh checkout has only the generator)."""
    import os
    import sys

    golden = os.path.join(os.path.dirname(__file__), "golden")
    path = os.path.join(golden, "rubato_seams.npz")
    if not os.path.exists(path):
        sys.path.insert(0, golden)
        try:
            from gen_rubato_seams import generate
        finally:
            sys.path.pop(0)
        np.savez_compressed(path, **generate())
    return path


def test_streaming_cubic_matches_rubato_seam_fixtures():
    """The streaming cubic mode vs checked-in golden
    vectors from an independent serial port of rubato FastFixedIn's
    accumulate/chunk semantics (f64 phase accumulator carried across
    128-sample chunk seams, f32 polynomial arithmetic, zero-pad flush —
    tests/golden/gen_rubato_seams.py, from resampler.rs:43-49,114-167).

    The serial stream emits output n as soon as its window completes, so
    concatenated-output index n IS offline output index n; our streaming
    plan emits offline output n0+m at stream position m, so dropping the
    first -n0 stream samples aligns the two. Both share the zero
    prehistory and zero-pad tail conventions. <1e-4 everywhere, on three
    rate pairs, with our chunking deliberately different from the
    fixture's 128-sample seams (both must be seam-invariant)."""
    import os

    from audioflow_tpu.ops.resample import (
        make_stream_plan, resample_stream_init, resample_stream_step,
        stream_chunk_multiple,
    )

    data = np.load(_rubato_fixture_path())
    for in_rate, out_rate in [(48000, 16000), (44100, 16000), (16000, 24000)]:
        key = f"{in_rate}_{out_rate}"
        x = data[f"x_{key}"]
        want = data[f"y_{key}"]
        ipb = stream_chunk_multiple(in_rate, out_rate)
        chunk_in = ipb * 2  # NOT the fixture's 128 — seam positions differ
        plan = make_stream_plan(in_rate, out_rate, "cubic", chunk_in=chunk_in)
        n_chunks = -(-len(x) // chunk_in)
        xp = np.zeros(n_chunks * chunk_in, np.float32)
        xp[: len(x)] = x
        carry = resample_stream_init(plan)
        outs = []
        for k in range(n_chunks):
            carry, y = resample_stream_step(
                plan, carry, jnp.asarray(xp[k * chunk_in : (k + 1) * chunk_in])
            )
            outs.append(np.asarray(y))
        got = np.concatenate(outs)[plan.latency_out :]
        n = min(len(got), len(want))
        assert n > len(want) - 2 * plan.block_out  # nearly full coverage
        np.testing.assert_allclose(got[:n], want[:n], atol=1e-4)


def test_rubato_seam_fixture_generator_is_deterministic():
    """The checked-in npz equals a fresh in-memory regeneration — the
    fixture file cannot silently drift from its generator."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
    try:
        from gen_rubato_seams import generate
    finally:
        sys.path.pop(0)
    data = np.load(_rubato_fixture_path())
    fresh = generate()
    for k in fresh:
        np.testing.assert_array_equal(np.asarray(data[k]), np.asarray(fresh[k]), err_msg=k)


def test_serial_seam_oracle_chunk_invariance():
    """The serial oracle itself is seam-invariant: one 128-chunk stream ==
    one whole-signal pass of the same accumulator math (the property that
    makes it a valid seam reference)."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
    try:
        from gen_rubato_seams import SerialFastFixedIn
    finally:
        sys.path.pop(0)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(1280).astype(np.float32)
    a = SerialFastFixedIn(44100, 16000, chunk_size=128)
    ya = np.concatenate([a.process(x[k : k + 128]) for k in range(0, 1280, 128)])
    b = SerialFastFixedIn(44100, 16000, chunk_size=1280)
    yb = b.process(x)
    np.testing.assert_array_equal(ya, yb)
