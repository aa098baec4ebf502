"""YIN pitch tracking: serial float64 oracle, tone accuracy, edge behavior."""

import numpy as np
import pytest

import jax.numpy as jnp

from audioflow_tpu import ops

FS = 16000


def _cmnd_oracle(fr: np.ndarray, w: int) -> np.ndarray:
    """Serial float64 CMND straight from the YIN paper (steps 1-3)."""
    fr = fr.astype(np.float64)
    d = np.zeros(w + 1)
    for tau in range(w + 1):
        diff = fr[:w] - fr[tau : tau + w]
        d[tau] = (diff * diff).sum()
    dn = np.ones(w + 1)
    run = 0.0
    for tau in range(1, w + 1):
        run += d[tau]
        dn[tau] = d[tau] * tau / run if run > 0 else 1.0
    return dn


def test_cmnd_matches_serial_oracle(rng):
    fr = (0.5 * np.sin(2 * np.pi * 220.0 * np.arange(1024) / FS)
          + 0.05 * rng.standard_normal(1024)).astype(np.float32)
    got = np.asarray(ops.cmnd_frames(jnp.asarray(fr[None, :]), 512))[0]
    want = _cmnd_oracle(fr, 512)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    assert got[0] == 1.0


@pytest.mark.parametrize("f0", [110.0, 220.3, 441.0, 987.0])
def test_yin_pure_tone_accuracy(f0):
    t = np.arange(FS) / FS
    x = jnp.asarray((0.5 * np.sin(2 * np.pi * f0 * t)).astype(np.float32))
    est = np.asarray(ops.yin(x, FS, fmin=80, fmax=1200))
    mid = est[4:-4]
    assert np.abs(mid - f0).max() / f0 < 0.01, (f0, mid.min(), mid.max())


def test_yin_missing_fundamental():
    """Harmonics 2f+3f+4f with no energy at f: YIN still reports f (the
    period is 1/f) — the classic case spectral peak-picking gets wrong."""
    f0 = 150.0
    t = np.arange(FS) / FS
    x = sum(0.3 * np.sin(2 * np.pi * k * f0 * t + 0.7 * k) for k in (2, 3, 4))
    est = np.asarray(ops.yin(jnp.asarray(x.astype(np.float32)), FS, fmin=80, fmax=500))
    assert np.abs(est[4:-4] - f0).max() / f0 < 0.01


def test_yin_voicing_separates_tone_from_noise(rng):
    t = np.arange(FS) / FS
    tone = 0.5 * np.sin(2 * np.pi * 330.0 * t[: FS // 2])
    noise = 0.5 * rng.standard_normal(FS // 2)
    x = jnp.asarray(np.concatenate([tone, noise]).astype(np.float32))
    f0, ap = ops.yin_voicing(x, FS, fmin=80, fmax=1200)
    f0, ap = np.asarray(f0), np.asarray(ap)
    n = len(f0)
    assert ap[2 : n // 2 - 4].max() < 0.1  # periodic half: deep troughs
    assert ap[n // 2 + 4 : -2].min() > 0.3  # noise half: no periodicity


def test_yin_batched_and_silence(rng):
    x = np.zeros((2, FS // 2), np.float32)
    x[1] = 0.4 * np.sin(2 * np.pi * 220.0 * np.arange(FS // 2) / FS)
    f0, ap = ops.yin_voicing(jnp.asarray(x), FS, fmin=80, fmax=1200)
    assert f0.shape == ap.shape and f0.shape[0] == 2
    # silence: CMND defined to 1 (unvoiced), f0 finite (no NaNs anywhere)
    assert np.isfinite(np.asarray(f0)).all()
    assert np.asarray(ap)[0].min() >= 0.99
    assert np.abs(np.asarray(f0)[1][4:-4] - 220.0).max() < 3.0


def test_yin_acf_impls_agree(rng):
    """The matmul ACF and the FFT ACF (the default) are the same math; on
    any backend at "highest" they agree to f32 noise."""
    t = np.arange(FS) / FS
    x = (0.4 * np.sin(2 * np.pi * 220.0 * t)
         + 0.05 * rng.standard_normal(FS)).astype(np.float32)
    f_fft = np.asarray(ops.yin(jnp.asarray(x), FS, impl="fft"))
    f_mm = np.asarray(ops.yin(jnp.asarray(x), FS, impl="matmul", precision="highest"))
    assert np.abs(f_fft - f_mm).max() < 0.01  # Hz
    d_fft = np.asarray(ops.cmnd_frames(jnp.asarray(x[None, :1024]), 512, 200, "fft"))
    d_mm = np.asarray(ops.cmnd_frames(jnp.asarray(x[None, :1024]), 512, 200,
                                      "matmul", "highest"))
    np.testing.assert_allclose(d_mm, d_fft, atol=5e-5)
    with pytest.raises(ValueError):
        ops.cmnd_frames(jnp.zeros((2, 1024)), 512, 200, "dct")


def test_yin_validation_errors():
    x = jnp.zeros(4096, jnp.float32)
    with pytest.raises(ValueError):
        ops.yin(x, FS, fmin=8000.0, fmax=9000.0)  # lags collapse below 2
    with pytest.raises(ValueError):
        ops.cmnd_frames(jnp.zeros((4, 100)), 80)  # needs frame >= 2*win


def test_yin_node_offline_and_streaming(rng):
    from audioflow_tpu.config import graph_from_spec, graph_to_spec
    from audioflow_tpu.graph import Yin, chain

    t = np.arange(2 * FS) / FS
    x = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    g = chain(Yin(fmin=80, fmax=1200, frame_length=1024, hop=256, center=False), input_rate=FS)
    out = np.asarray(g.chain(jnp.asarray(x)))
    assert out.shape[-1] == 2
    assert np.abs(out[4:-4, 0] - 220.0).max() < 3.0
    # exact streaming at the declared latency
    chunk = g.chunk_granularity() * 8
    streamed = np.asarray(g.scan_stream(jnp.asarray(x[: len(x) // chunk * chunk]), chunk))
    lat = g.stream_latency(chunk)
    n = min(streamed.shape[0] - lat, out.shape[0])
    np.testing.assert_allclose(streamed[lat : lat + n], out[:n], rtol=2e-4, atol=1e-4)
    # spec round-trip
    g2 = graph_from_spec(graph_to_spec(g))
    assert g2.nodes[0].fmax == 1200
    # center=True: offline only
    from audioflow_tpu.errors import AudioError

    gc = chain(Yin(center=True), input_rate=FS)
    with pytest.raises(AudioError):
        gc.init_state(2048)


# ---------------------------------------------------------------------------
# pYIN
# ---------------------------------------------------------------------------


def _pyin_oracle(frames, sr, fmin, fmax, hop, n_thr, lam, resolution,
                 switch_prob, no_trough_prob, max_rate, masses):
    """Serial float64 pYIN mirroring the documented conventions of
    ops.pitch.pyin_frames (single [F, L] frame stack)."""
    f_count, l = frames.shape
    w = l // 2
    tau_lo = max(int(np.floor(sr / fmax)), 2)
    tau_hi = min(int(np.ceil(sr / fmin)), w - 1)
    t_max = min(tau_hi + 1, w)
    dn = np.stack([_cmnd_oracle(fr, w)[: t_max + 1] for fr in frames])
    lags = np.arange(t_max + 1)
    in_range = (lags >= tau_lo) & (lags <= tau_hi)
    prev = np.concatenate([dn[:, :1], dn[:, :-1]], 1)
    nxt = np.concatenate([dn[:, 1:], dn[:, -1:]], 1)
    trough = (dn < prev) & (dn <= nxt) & in_range
    denom = prev - 2 * dn + nxt
    delta = np.where(np.abs(denom) > 1e-12,
                     0.5 * (prev - nxt) / np.where(denom == 0, 1.0, denom), 0.0)
    delta = np.clip(delta, -0.5, 0.5)
    f0_lag = sr / np.maximum(lags + delta, 1.0)

    thr = np.linspace(0, 1, n_thr + 1)[1:]
    prob = np.zeros_like(dn)
    geo = 1.0 - np.exp(-lam)
    for fi in range(f_count):
        nt = 0.0
        tr = np.where(trough[fi])[0]
        for m in range(n_thr):
            q = [tau for tau in tr if dn[fi, tau] < thr[m]]
            if not q:
                nt += masses[m]
                continue
            norm = 1.0 - np.exp(-lam * len(q))
            for r, tau in enumerate(q):
                prob[fi, tau] += masses[m] * np.exp(-lam * r) * geo / norm
        if len(tr):
            gmin = tr[np.argmin(dn[fi, tr])]
            prob[fi, gmin] += no_trough_prob * nt

    voiced_prob = np.clip(prob.sum(1), 0, 1)
    nbps = max(1, round(1.0 / resolution))
    n_bins = int(np.floor(12 * nbps * np.log2(fmax / fmin))) + 1
    bins = np.clip(np.round(12 * nbps * np.log2(f0_lag / fmin)).astype(int),
                   0, n_bins - 1)
    obs_v = np.zeros((f_count, n_bins))
    for fi in range(f_count):
        for tau in range(t_max + 1):
            obs_v[fi, bins[fi, tau]] += prob[fi, tau]

    half = max(1, round(max_rate * 12 * nbps * hop / sr))
    tri = 1.0 - np.abs(np.arange(-half, half + 1)) / (half + 1.0)
    tri = tri / tri.sum()
    n2 = 2 * n_bins
    log_a = np.full((n2, n2), -np.inf)
    for i in range(n_bins):
        for k in range(-half, half + 1):
            j = i + k
            if 0 <= j < n_bins:
                t = np.log(tri[k + half])
                log_a[i, j] = t + np.log1p(-switch_prob)
                log_a[i, j + n_bins] = t + np.log(switch_prob)
                log_a[i + n_bins, j + n_bins] = t + np.log1p(-switch_prob)
                log_a[i + n_bins, j] = t + np.log(switch_prob)
    log_obs = np.concatenate(
        [np.log(np.maximum(obs_v, 1e-30)),
         np.broadcast_to(np.log(np.maximum((1 - voiced_prob[:, None]) / n_bins,
                                           1e-30)), obs_v.shape)], 1)
    # dense Viterbi, first-index-wins argmax (source order: v bins asc, u asc
    # — matches the banded impl's block-then-offset preference)
    dlt = -np.log(n2) + log_obs[0]
    bp = np.zeros((f_count, n2), int)
    for fi in range(1, f_count):
        scores = dlt[:, None] + log_a
        bp[fi] = np.argmax(scores, 0)
        dlt = scores[bp[fi], np.arange(n2)] + log_obs[fi]
    states = np.zeros(f_count, int)
    states[-1] = int(np.argmax(dlt))
    for fi in range(f_count - 1, 0, -1):
        states[fi - 1] = bp[fi, states[fi]]

    voiced = states < n_bins
    bin_dec = np.where(voiced, states, states - n_bins)
    centers = fmin * 2.0 ** (np.arange(n_bins) / (12.0 * nbps))
    f0 = np.zeros(f_count)
    for fi in range(f_count):
        cand = [(prob[fi, tau], f0_lag[fi, tau]) for tau in range(t_max + 1)
                if trough[fi, tau] and bins[fi, tau] == bin_dec[fi]
                and prob[fi, tau] > 0]
        f0[fi] = max(cand)[1] if cand else centers[bin_dec[fi]]
    return f0, voiced, voiced_prob, states


def test_pyin_matches_serial_oracle(rng):
    sr, fl, hop = 8000, 512, 128
    t = np.arange(int(1.5 * sr)) / sr
    x = (0.4 * np.sin(2 * np.pi * (150 + 60 * t) * t)).astype(np.float32)
    x[: sr // 4] = 0.05 * rng.standard_normal(sr // 4).astype(np.float32)
    x += 0.01 * rng.standard_normal(x.shape).astype(np.float32)
    from audioflow_tpu.ops.framing import frame as _frame
    from audioflow_tpu.ops.pitch import _beta_interval_masses, pyin_frames

    fr = np.asarray(_frame(jnp.asarray(x), fl, hop))
    kw = dict(hop=hop, n_thresholds=16, resolution=0.5)
    f0, vf, vp = pyin_frames(jnp.asarray(fr), sr, 100.0, 400.0, **kw)
    masses = _beta_interval_masses(2.0, 18.0, 16)
    of0, ovf, ovp, ost = _pyin_oracle(
        fr.astype(np.float64), sr, 100.0, 400.0, hop, 16, 2.0, 0.5,
        0.01, 0.01, 35.92, masses)
    vp_got = np.asarray(vp)
    np.testing.assert_allclose(vp_got, ovp, atol=5e-3)
    vf_got = np.asarray(vf)
    agree = (vf_got == ovf).mean()
    assert agree >= 0.9, f"voiced-flag agreement {agree}"
    # f0 agreement where both decoders say voiced
    sel = vf_got & ovf
    rel = np.abs(np.asarray(f0)[sel] - of0[sel]) / of0[sel]
    assert np.median(rel) < 5e-3 and (rel < 0.06).mean() > 0.95, (
        rel.max(), np.median(rel))


def test_pyin_tone_voicing_segmentation(rng):
    sr = 16000
    t = np.arange(2 * sr) / sr
    x = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    x[: sr // 2] = 0.01 * rng.standard_normal(sr // 2).astype(np.float32)
    f0, vf, vp = ops.pyin(jnp.asarray(x), sr, fmin=80, fmax=500)
    f0, vf, vp = map(np.asarray, (f0, vf, vp))
    assert (~vf[2 : sr // 2 // 256 - 2]).all()  # noise head: unvoiced
    mid = slice(sr // 2 // 256 + 4, len(f0) - 4)
    assert vf[mid].all()
    assert np.abs(f0[mid] - 220.0).max() < 1.0
    assert vp[mid].min() > 0.5


def test_pyin_batched_shapes():
    sr = 8000
    x = np.zeros((2, 3, sr), np.float32)
    x[..., :] = 0.3 * np.sin(2 * np.pi * 200.0 * np.arange(sr) / sr)
    f0, vf, vp = ops.pyin(jnp.asarray(x), sr, fmin=100, fmax=400,
                          frame_length=512, hop=256, resolution=0.5)
    assert f0.shape == vf.shape == vp.shape and f0.shape[:2] == (2, 3)
    assert np.abs(np.asarray(f0)[..., 4:-4] - 200.0).max() < 2.0


def test_pyin_validation_errors():
    x = jnp.zeros(4096, jnp.float32)
    with pytest.raises(ValueError):
        ops.pyin(x, FS, resolution=0.0)
    with pytest.raises(ValueError):
        ops.pyin(x, FS, switch_prob=1.5)


def test_beta_interval_masses_match_scipy():
    from scipy.stats import beta as beta_dist

    from audioflow_tpu.ops.pitch import _beta_interval_masses

    for a, b, m in [(2.0, 18.0, 100), (1.0, 1.0, 7), (3.5, 4.5, 13)]:
        got = _beta_interval_masses(a, b, m)
        edges = np.linspace(0, 1, m + 1)
        want = np.diff(beta_dist.cdf(edges, a, b))
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert abs(got.sum() - 1.0) < 1e-9


def test_pyin_node_offline_and_spec_roundtrip():
    from audioflow_tpu.config import graph_from_spec, graph_to_spec
    from audioflow_tpu.errors import AudioError
    from audioflow_tpu.graph import Pyin, chain

    t = np.arange(FS) / FS
    x = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    g = chain(Pyin(fmin=80, fmax=500, resolution=0.5), input_rate=FS)
    out = np.asarray(g.chain(jnp.asarray(x)))
    assert out.shape[-1] == 3
    f0, vflag, vprob = out[..., 0], out[..., 1], out[..., 2]
    assert vflag[4:-4].min() == 1.0 and np.abs(f0[4:-4] - 220.0).max() < 2.0
    assert vprob[4:-4].min() > 0.5
    g2 = graph_from_spec(graph_to_spec(g))
    assert g2.nodes[0].resolution == 0.5
    # whole-sequence Viterbi: streaming must be refused
    with pytest.raises(AudioError):
        g.init_state(2048)


def test_piptrack_tone_and_chord(rng):
    t = np.arange(FS) / FS
    x = (0.5 * np.sin(2 * np.pi * 440.0 * t)
         + 0.3 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    s = ops.magnitude(ops.stft(jnp.asarray(x), 2048, 512))
    pitches, mags = ops.piptrack(s, FS, 2048, fmin=150, fmax=2000)
    pitches, mags = np.asarray(pitches), np.asarray(mags)
    assert pitches.shape == s.shape and mags.shape == s.shape
    mid = pitches[5:-5]
    for want in (440.0, 1000.0):
        # some candidate within 2 Hz of each partial, every mid frame
        hit = (np.abs(mid - want) < 2.0).any(axis=-1)
        assert hit.all(), want
    # candidates only where mags > 0; outside the band nothing fires
    freqs = np.arange(s.shape[-1]) * FS / 2048
    outside = (freqs < 150) | (freqs > 2000)
    assert (pitches[..., outside] == 0).all()
    assert ((pitches > 0) == (mags > 0)).all()


# --- streaming pYIN: fixed-lag Viterbi smoothing ---


def test_online_pyin_matches_offline_decode_on_steady_pitch(rng):
    """Fixed-lag smoothing == the whole-sequence Viterbi outside the lag
    window on steady-pitch material (the decode converges well before the
    lag horizon)."""
    sr, fl, hop, lag = 8000, 512, 128, 12
    t = np.arange(2 * sr) / sr
    x = (0.4 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    x += 0.01 * rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(n_thresholds=16, resolution=0.5)
    f0, vf, vp = ops.pyin_online(jnp.asarray(x), sr, 100.0, 400.0, fl, hop, lag, **kw)
    from audioflow_tpu.ops.framing import frame as _frame

    of0, ovf, ovp = ops.pyin_frames(
        _frame(jnp.asarray(x), fl, hop), sr, 100.0, 400.0, hop=hop, **kw
    )
    # emission j decodes frame j - lag; compare away from the two edges
    dec_f0, dec_vf = np.asarray(f0)[lag:], np.asarray(vf)[lag:]
    n = dec_f0.shape[0]
    sl = slice(5, n - 5)
    assert (dec_vf[sl] == np.asarray(ovf)[:n][sl]).all()
    np.testing.assert_allclose(dec_f0[sl], np.asarray(of0)[:n][sl], rtol=1e-6)


def test_online_pyin_node_stream_equals_offline_chunk_invariant(rng):
    """OnlinePyin streams exactly (== offline apply at the declared
    whole-unit latency) for multiple chunk sizes — the framework streaming
    invariant; modulated pitch so the decode is nontrivial."""
    from audioflow_tpu.graph import chain
    from audioflow_tpu.graph.nodes import OnlinePyin

    sr = 8000
    t = np.arange(int(2.5 * sr)) / sr
    f_tr = 180 + 40 * np.sin(2 * np.pi * 0.7 * t)
    x = (0.4 * np.sin(2 * np.pi * np.cumsum(f_tr) / sr)).astype(np.float32)
    x += 0.01 * rng.standard_normal(x.shape).astype(np.float32)
    node = OnlinePyin(
        fmin=100.0, fmax=400.0, frame_length=512, hop=128, lag=10,
        n_thresholds=16, resolution=0.5, sample_rate=sr,
    )
    g = chain(node, input_rate=sr)
    offline = np.asarray(g.chain(jnp.asarray(x)))
    assert offline.shape[-1] == 3
    for chunk_mult in (4, 16):
        chunk = g.chunk_granularity() * chunk_mult
        n_use = (len(x) // chunk) * chunk
        streamed = np.asarray(g.scan_stream(jnp.asarray(x[:n_use]), chunk))
        lat = g.stream_latency(chunk)
        assert lat == node._carry_len // node.hop + node.lag
        n = streamed.shape[0] - lat
        np.testing.assert_array_equal(streamed[lat : lat + n], offline[:n])
    # mid-stream decode matches the steady-state pitch trajectory
    f0, vflag = offline[..., 0], offline[..., 1]
    sel = vflag[8:-8] == 1.0
    assert sel.mean() > 0.9
    want = f_tr[(np.arange(len(f0)) * 128)[8:-8][sel]]
    rel = np.abs(f0[8:-8][sel] - want) / want
    assert np.median(rel) < 0.02, np.median(rel)


def test_online_pyin_plan_validation():
    with pytest.raises(ValueError):
        ops.make_online_pyin_plan(8000, lag=0)
    with pytest.raises(ValueError):
        ops.make_online_pyin_plan(8000, resolution=0.0)
    with pytest.raises(ValueError):
        ops.make_online_pyin_plan(8000, switch_prob=1.5)


def test_pyin_viterbi_impl_validation():
    x = jnp.zeros(8000, jnp.float32)
    with pytest.raises(ValueError, match="viterbi impl"):
        ops.pyin(x, 16000, 80, 1200, viterbi_impl="nope")
    # the removed Pallas decoder is an unknown impl like any other
    fr = jnp.zeros((2, 8, 2048), jnp.float32)
    with pytest.raises(ValueError, match="known: auto, xla"):
        ops.pyin_frames(fr, 16000, 80, 1200, viterbi_impl="pallas")
