import numpy as np
import pytest

import jax.numpy as jnp

from audioflow_tpu.ops import (
    compressor,
    dequantize_i16,
    energy_to_dbfs,
    gain_db,
    limiter,
    peak_normalize,
    quantize_i16,
    quantize_i16_round,
    rms_normalize,
    to_mono,
)
from audioflow_tpu.ops.dynamics import envelope_peak_release


def test_gain_db(rng):
    x = jnp.asarray(rng.standard_normal(100).astype(np.float32))
    np.testing.assert_allclose(np.asarray(gain_db(x, 6.0)), np.asarray(x) * 10 ** 0.3, rtol=1e-5)


def test_to_mono_matches_reference_average():
    """capture.rs:30-42: interleaved channel mean."""
    x = jnp.asarray(np.array([1.0, 3.0, 2.0, 4.0, -1.0, 1.0], np.float32))
    got = np.asarray(to_mono(x, 2))
    np.testing.assert_allclose(got, [2.0, 3.0, 0.0])
    np.testing.assert_array_equal(np.asarray(to_mono(x, 1)), np.asarray(x))


def test_to_mono_drops_ragged_tail():
    x = jnp.asarray(np.arange(7, dtype=np.float32))
    assert to_mono(x, 2).shape == (3,)


def test_peak_normalize(rng):
    x = jnp.asarray((rng.standard_normal(1000) * 0.1).astype(np.float32))
    y = np.asarray(peak_normalize(x, 0.9))
    np.testing.assert_allclose(np.abs(y).max(), 0.9, rtol=1e-5)


def test_rms_normalize(rng):
    x = jnp.asarray(rng.standard_normal(10000).astype(np.float32))
    y = np.asarray(rms_normalize(x, target_db=-20.0))
    rms_db = 20 * np.log10(np.sqrt((y**2).mean()))
    np.testing.assert_allclose(rms_db, -20.0, atol=1e-3)


def test_energy_to_dbfs_neg_inf():
    out = np.asarray(energy_to_dbfs(jnp.asarray([0.0, -1.0, 1.0, 0.01], jnp.float32)))
    assert np.isneginf(out[0]) and np.isneginf(out[1])
    np.testing.assert_allclose(out[2:], [0.0, -40.0], atol=1e-4)


def test_envelope_matches_serial_loop(rng):
    x = np.abs(rng.standard_normal(2000)).astype(np.float32)
    r = 0.995
    got = np.asarray(envelope_peak_release(jnp.asarray(x), r))
    e, want = 0.0, np.zeros_like(x)
    for i, v in enumerate(x):
        e = max(float(v), r * e)
        want[i] = e
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("t", [96, 97, 1000])
def test_blocked_log_envelope_matches_serial_loop(rng, t):
    """Blocks of 32 samples (ragged tail included), composed across blocks,
    over two lanes with silence that the release has to bridge."""
    from audioflow_tpu.ops.dynamics import log_envelope_from_rest

    x = np.abs(rng.standard_normal((2, t))).astype(np.float32)
    x[:, 10:80] = 0.0
    r = 0.97
    got = np.exp(np.asarray(log_envelope_from_rest(
        jnp.log(jnp.maximum(jnp.asarray(x), 1e-30)), float(np.log(r)), block=32)))
    want = np.zeros_like(x)
    e = np.full(2, 1e-30)
    for i in range(t):
        e = np.maximum(np.maximum(x[:, i], 1e-30), r * e)
        want[:, i] = e
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_envelope_keeps_float32_precision_on_long_signals():
    """Three million samples (about three minutes at 16 kHz, 50 ms release):
    one cummax over the whole length would add a ramp of 3750, whose float32
    rounding alone is 2e-4 of the envelope."""
    t = 3_000_000
    x = np.abs(0.4 * np.random.default_rng(1).standard_normal(t)).astype(np.float32)
    x[t // 3 : t // 3 + 5000] = 0.0
    r = float(np.exp(-1.0 / (50e-3 * 16000)))
    got = np.asarray(envelope_peak_release(jnp.asarray(x), r), np.float64)
    ramp = np.arange(t) * -np.log(r)
    lx = np.log(np.maximum(x.astype(np.float64), 1e-30)) + ramp
    want = np.exp(np.maximum.accumulate(lx) - ramp)
    assert np.max(np.abs(got - want) / want) < 5e-6


def test_limiter_caps_peaks(rng):
    x = (rng.standard_normal(8000) * 2.0).astype(np.float32)
    y = np.asarray(limiter(jnp.asarray(x), threshold_db=-1.0, sample_rate=16000))
    thresh = 10 ** (-1.0 / 20.0)
    assert np.abs(y).max() <= thresh * 1.0001
    # quiet passages pass through unchanged
    q = jnp.asarray(np.full(1000, 0.01, np.float32))
    np.testing.assert_allclose(np.asarray(limiter(q, -1.0)), np.asarray(q), rtol=1e-5)


def test_compressor_reduces_loud(rng):
    x = jnp.asarray(np.full(4000, 0.5, np.float32))
    y = np.asarray(compressor(x, threshold_db=-20.0, ratio=4.0))
    assert np.abs(y[100:]).max() < 0.5


def test_quantize_trunc_parity():
    """websocket.rs:246-251: (clamp * 32767) as i16 — truncation toward zero."""
    x = jnp.asarray(np.array([0.0, 1.0, -1.0, 2.0, -2.0, 0.5, -0.5, 1e-5, -1e-5], np.float32))
    got = np.asarray(quantize_i16(x))
    want = np.array([0, 32767, -32767, 32767, -32767, 16383, -16383, 0, 0], np.int16)
    np.testing.assert_array_equal(got, want)


def test_quantize_trunc_vs_round():
    x = jnp.asarray(np.array([0.99999], np.float32))
    assert int(quantize_i16(x)[0]) == 32766  # trunc(32766.67)
    assert int(quantize_i16_round(x)[0]) == 32767


def test_quantize_round_trip(rng):
    x = jnp.asarray(rng.uniform(-0.999, 0.999, 1000).astype(np.float32))
    y = np.asarray(dequantize_i16(quantize_i16(x)))
    # trunc loses up to 1 LSB; the 32767-vs-32768 scale mismatch adds ~0.5 LSB
    np.testing.assert_allclose(y, np.asarray(x), atol=2.0 / 32767)
