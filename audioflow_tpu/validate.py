"""Numerics validation: max|delta| of every kernel vs an independent float64
serial oracle (numpy only — no scipy dependency in the package). The headline
budget is max abs err < 1e-4 (BASELINE.md)."""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from . import ops
from .ops.resample import cubic_lagrange_bank, kaiser_sinc_bank
from .utils import cdiv, rational_rate


def _oracle_lfilter(b, a, x):
    """Direct-form II transposed, float64, serial."""
    y = np.zeros_like(x, dtype=np.float64)
    s1 = s2 = 0.0
    for n, xn in enumerate(x):
        yn = b[0] * xn + s1
        s1 = b[1] * xn - a[1] * yn + s2
        s2 = b[2] * xn - a[2] * yn
        y[n] = yn
    return y


def _oracle_polyphase(x, bank, up, down, offset, n_out, block=16384):
    """float64 polyphase resample: y[n] = bank[p] . x[q : q + K] with
    q = n*down // up + offset and p = n*down % up (zero outside x)."""
    k = bank.shape[1]
    xp = np.pad(np.asarray(x, np.float64), (max(0, -offset), k + up))
    bank = np.asarray(bank, np.float64)
    y = np.empty(n_out)
    taps = np.arange(k)
    for s in range(0, n_out, block):
        n = np.arange(s, min(s + block, n_out), dtype=np.int64)
        q = (n * down) // up + offset + max(0, -offset)
        y[n] = np.einsum("nk,nk->n", bank[(n * down) % up], xp[q[:, None] + taps])
    return y


def oracle_log_mel(
    x: np.ndarray,
    input_rate: int,
    target_rate: int = 16000,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 128,
    floor: float = 1e-10,
) -> np.ndarray:
    """float64 evaluation of the log-mel frontend (``log_mel_frontend``:
    kaiser polyphase resample -> center=False hann power spectrogram ->
    slaney mel -> ln) for one signal ``x [T]`` -> ``[frames, n_mels]``,
    from the same oracles as the rows below: the resample bank, a windowed
    rFFT and the float64 mel filterbank."""
    y = np.asarray(x, np.float64)
    if input_rate != target_rate:
        up, down = rational_rate(input_rate, target_rate)
        bank = kaiser_sinc_bank(up, down, 16)
        y = _oracle_polyphase(
            y, bank, up, down, -((bank.shape[1] - 1) // 2), cdiv(len(y) * up, down)
        )
    n_frames = 1 + (len(y) - n_fft) // hop
    frames = y[np.arange(n_frames)[:, None] * hop + np.arange(n_fft)]
    w = ops.get_window("hann", n_fft).astype(np.float64)
    power = np.abs(np.fft.rfft(frames * w, axis=-1)) ** 2
    fb = ops.mel_filterbank(n_fft // 2 + 1, n_mels, target_rate, dtype=np.float64)
    return np.log(np.maximum(power @ fb, floor))


def run_validation(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    report: dict = {}

    # resample kaiser
    x = rng.standard_normal(4096).astype(np.float32)
    up, down = rational_rate(44100, 16000)
    bank = kaiser_sinc_bank(up, down, 16)
    got = np.asarray(ops.resample(jnp.asarray(x), 44100, 16000, "kaiser"))
    offset = -((bank.shape[1] - 1) // 2)
    want = _oracle_polyphase(x, bank, up, down, offset, cdiv(len(x) * up, down))
    report["resample_kaiser"] = float(np.abs(got - want).max())

    # resample cubic (rubato-parity polynomial)
    bank_c = cubic_lagrange_bank(up)
    got = np.asarray(ops.resample(jnp.asarray(x), 44100, 16000, "cubic"))
    want = _oracle_polyphase(x, bank_c, up, down, -1, cdiv(len(x) * up, down))
    report["resample_cubic"] = float(np.abs(got - want).max())

    # biquad chain
    chain = (
        ops.highpass(80.0, 16000.0),
        ops.peaking(1000.0, 16000.0, 4.0, 1.0),
        ops.peaking(3000.0, 16000.0, -3.0, 1.2),
    )
    xb = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    got, _ = ops.biquad_chain(jnp.asarray(xb), chain)
    want = xb.astype(np.float64)
    for bq in chain:
        b, a = bq.as_ba()
        want = _oracle_lfilter(b, a, want)
    report["biquad_chain"] = float(np.abs(np.asarray(got) - want).max())

    # stft magnitude
    w = ops.get_window("hann", 512)
    frames = np.stack([xb[i * 128 : i * 128 + 512] for i in range(20)])
    want = np.abs(np.fft.rfft(frames * w, axis=-1))
    got = np.asarray(ops.magnitude(ops.stft(jnp.asarray(xb[: 20 * 128 + 512 - 128]), 512, 128, center=False)))[:20]
    report["stft_magnitude"] = float(np.abs(got - want).max() / max(want.max(), 1e-9))

    # matmul spectrogram (the default impl, at its per-op precision cap
    # DFT_PRECISION_DEFAULT='high' — this row is the accelerator gate for
    # that tier; relative to the spectral peak like the stft row)
    got = np.asarray(
        ops.spectrogram(jnp.asarray(xb[: 20 * 128 + 512 - 128]), 512, 128, center=False, power=False)
    )[:20]
    report["spectrogram_matmul"] = float(np.abs(got - want).max() / max(want.max(), 1e-9))

    # mel projection
    fb = ops.mel_filterbank(257, 64, 16000, dtype=np.float64)
    spec = rng.random((20, 257)).astype(np.float32)
    got = np.asarray(ops.apply_mel(jnp.asarray(spec), fb.astype(np.float32)))
    want = spec.astype(np.float64) @ fb
    report["mel_project"] = float(np.abs(got - want).max())

    # quantize: exact
    xq = rng.uniform(-1.2, 1.2, 1000).astype(np.float32)
    got = np.asarray(ops.quantize_i16(jnp.asarray(xq)))
    want = np.trunc(np.clip(xq, -1, 1).astype(np.float64) * 32767).astype(np.int16)
    report["quantize_i16"] = float(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())

    # vad state equality over random frames
    from .ops.vad import VadConfig

    frames = (rng.standard_normal((100, 160)) * rng.choice([0.001, 0.1], 100)[:, None]).astype(
        np.float32
    )
    cfg = VadConfig(threshold_db=-35.0)
    _, states = ops.vad_scan(jnp.asarray(frames), cfg)
    # serial oracle
    sm, sil, spc, st = 0.0, 0, 0, 0
    mism = 0
    for i, f in enumerate(frames):
        e = float((f.astype(np.float64) ** 2).mean())
        sm = cfg.smoothing_factor * e + (1 - cfg.smoothing_factor) * sm
        det = sm if cfg.smoothing_factor > 0 else e
        db = 20 * np.log10(det) if det > 0 else -np.inf
        isp = db > cfg.threshold_db
        if st == 0:
            if isp:
                spc, sil, st = 1, 0, 1
        elif st == 1:
            if isp:
                spc, sil = spc + 1, 0
            else:
                sil += 1
                if sil >= cfg.silence_timeout_frames:
                    st = 2 if spc >= cfg.min_speech_frames else 0
                    spc = 0
        else:
            st, sil = 0, 0
        mism += int(st != int(states[i]))
    report["vad_state_mismatches"] = mism

    # BS.1770 loudness: the spec's calibration identity (997 Hz 0 dBFS sine
    # -> -3.0103 LKFS; the -0.691 offset cancels the K-shelf gain there).
    # The row is |measured - (-3.0103)| so it shares the 1e-4-style budget
    # scale-free (loudness is already a log quantity). Gated at 1e-2 LU via
    # its own key: the biquad engine is exact, but 5 s of f32 mean-squares
    # accumulate ~1e-3 LU; anything near 1e-2 means a filter-design break.
    xl = np.sin(2 * np.pi * 997.0 * np.arange(5 * 48000) / 48000.0).astype(np.float32)
    li = float(ops.integrated_loudness(jnp.asarray(xl), 48000))
    report["loudness_997_anchor_lu"] = abs(li - (-3.0103))

    # YIN: 220 Hz tone recovered to < 0.5 Hz mid-signal (relative row)
    xy = (0.5 * np.sin(2 * np.pi * 220.0 * np.arange(16000) / 16000.0)).astype(np.float32)
    f0 = np.asarray(ops.yin(jnp.asarray(xy), 16000, fmin=80, fmax=1200))
    report["yin_220_rel"] = float(np.abs(f0[4:-4] - 220.0).max() / 220.0)

    # CQT: 440 Hz tone must land in its bin at the unit-amplitude
    # convention (ops/cqt.py normalization) — gates the per-octave matmul
    # kernels at their shipped precision. Row is |mag - 1| at the
    # tone bin, forced to 1.0 if the argmax bin is wrong.
    tq = np.arange(16000, dtype=np.float64) / 16000.0
    xq2 = np.sin(2 * np.pi * 440.0 * tq).astype(np.float32)
    cq = np.asarray(ops.cqt(jnp.asarray(xq2), 16000, n_bins=48, fmin=110.0))
    mid = cq[cq.shape[0] // 2]
    k440 = 24  # 2 octaves above fmin=110
    report["cqt_440_mag_err"] = (
        float(abs(mid[k440] - 1.0)) if int(np.argmax(mid)) == k440 else 1.0
    )

    # icqt painless row: worst-bin tone round-trip SNR at a painless config
    # (hop 48 <= icqt_max_hop 54 for 48 bins from 110 Hz at 16 kHz) — gates
    # the diagonal dual bank design + synthesis matmul + OLA at shipped
    # precision. Reported NEGATED (so the row is "smaller is
    # better" like the rest): row = -min_snr_db, budget -30 (>= 30 dB).
    # Design study: 38.2 dB worst (bin 0) in float64; f32/'high' < 1 dB.
    import jax as _jx

    icqt_freqs = ops.cqt_frequencies(48, 110.0)
    icqt_rt = _jx.jit(
        lambda z: ops.icqt(
            ops.cqt(z, 16000, 48, 48, 110.0, output="complex"),
            16000, 48, 48, 110.0, length=24000,
        )
    )
    snrs = []
    for k_i in (0, 24, 47):
        xt = np.sin(
            2 * np.pi * icqt_freqs[k_i] * np.arange(24000) / 16000.0
        ).astype(np.float32)
        yt = np.asarray(icqt_rt(jnp.asarray(xt)))
        lo, hi = 8000, 16000
        e = yt[lo:hi] - xt[lo:hi]
        snrs.append(
            10.0 * np.log10((xt[lo:hi] ** 2).sum() / max((e ** 2).sum(), 1e-30))
        )
    report["icqt_painless_snr_db"] = -float(min(snrs))

    # icqt at the FRAMEWORK DEFAULTS (hop 256 / 84 bins / C1 fmin / 16 kHz
    # — 11x past the painless cliff; the hybrid LS-dual + sinusoid inverse,
    # ops/cqt.py::_icqt_hybrid): worst tone SNR over the structurally worst
    # bins — the hop-alias-colliding bottom pair (0, 1), a mid painless bin
    # (21), the full crossfade band (41-44), a mid sin-branch bin (63), and
    # the top edge pair (82, 83); these samples cover every failure mode a
    # full 84-bin sweep shows. Same negated convention, budget -30 (>= 30 dB); f64 prototype
    # measured >= ~36 dB worst. NOTE this row measures the hybrid's BEST
    # CASE (bin-center tones) by design; its broadband envelope is the two
    # rows below.
    hyb_bins = (0, 1, 21, 41, 42, 43, 44, 63, 82, 83)
    hyb_freqs = ops.cqt_frequencies(84)
    t_hyb = 64000  # 4 s: the LS dual support is nd/2 = 16896 per edge
    nv = np.arange(t_hyb)
    rows_h = [np.sin(2 * np.pi * hyb_freqs[k] * nv / 16000.0) for k in hyb_bins]
    # broadband rows (the honest envelope): band noise
    # in the sin-branch region and a 150 Hz harmonic complex
    zn = rng.standard_normal(t_hyb)
    zf = np.fft.rfft(zn)
    fgrid = np.fft.rfftfreq(t_hyb, 1.0 / 16000.0)
    zf[(fgrid < 800.0) | (fgrid > 2000.0)] = 0
    noise_hi = np.fft.irfft(zf, t_hyb)
    noise_hi /= np.abs(noise_hi).max() * 2.0
    harm = sum(
        (0.5 / (i + 1)) * np.sin(2 * np.pi * 150.0 * (i + 1) * nv / 16000.0)
        for i in range(12)
    )
    xb_h = np.stack(rows_h + [noise_hi, harm]).astype(np.float32)
    icqt_hyb = _jx.jit(
        lambda z: ops.icqt(
            ops.cqt(z, 16000, 256, 84, output="complex"),
            16000, 256, 84, length=t_hyb,
        )
    )
    yb_h = np.asarray(icqt_hyb(jnp.asarray(xb_h)))
    lo, hi = 17000, t_hyb - 17000
    e_h = yb_h[:, lo:hi] - xb_h[:, lo:hi]
    snr_h = 10.0 * np.log10(
        (xb_h[:, lo:hi] ** 2).sum(axis=1) / np.maximum((e_h ** 2).sum(axis=1), 1e-30)
    )
    report["icqt_tone_snr_db"] = -float(snr_h[: len(hyb_bins)].min())
    # published as-is (NOT negated): the hybrid is a tone reconstructor in
    # the sin-branch region — ~-10 dB on 800-2000 Hz noise, ~8 dB on the
    # harmonic complex. The gate is a sanity band (documented behavior, not
    # a quality bar); the broadband-faithful inverse is the multirate row.
    report["icqt_hybrid_noise_snr_db"] = float(snr_h[len(hyb_bins)])
    report["icqt_hybrid_harm_snr_db"] = float(snr_h[len(hyb_bins) + 1])

    # multirate CQT (cqt(multirate=True), per-octave painless hops): TRUE
    # broadband inversion at the framework default config — the same noise
    # band and harmonic complex the hybrid fails, PLUS the top-octave skirt
    # tones (bins 79-81: the alias-image failure mode the r5 full-bin sweep
    # caught at the N/3 top hop — multirate_hops docstring) and the edge
    # pair (0, 83). Gated >= 30 dB (negated convention; design f64
    # measured 60.0 / 57.3 dB broadband, >= ~54 dB sweep-worst tone).
    icqt_mr = _jx.jit(
        lambda z: ops.icqt(
            ops.cqt(z, 16000, multirate=True, output="complex"), length=t_hyb
        )
    )
    mr_tones = [
        np.sin(2 * np.pi * hyb_freqs[k] * nv / 16000.0) for k in (0, 79, 80, 81, 83)
    ]
    xb_m = np.stack([noise_hi, harm] + mr_tones).astype(np.float32)
    yb_m = np.asarray(icqt_mr(jnp.asarray(xb_m)))
    e_m = yb_m[:, lo:hi] - xb_m[:, lo:hi]
    snr_m = 10.0 * np.log10(
        (xb_m[:, lo:hi] ** 2).sum(axis=1) / np.maximum((e_m ** 2).sum(axis=1), 1e-30)
    )
    report["icqt_multirate_noise_snr_db"] = -float(snr_m.min())

    # matmul-ACF banks vs the FFT correlation (impl="matmul" of YIN/tempo
    # rides these banks at 'high'; identical math, so the row is the
    # numerics gate for the bank construction + precision tier).
    # Relative to acf(0) (the natural scale of a correlation).
    xa = (0.4 * np.sin(2 * np.pi * 220.0 * np.arange(4096) / 16000.0)).astype(
        np.float32
    ) + 0.05 * rng.standard_normal(4096).astype(np.float32)
    fr_a = jnp.asarray(np.stack([xa[:2048], xa[1024:3072]]))
    from .ops.pitch import _acf_fft, _acf_matmul

    acf_f = np.asarray(_acf_fft(fr_a[..., : 1024 + 256], 1024, 256))
    acf_m = np.asarray(_acf_matmul(fr_a[..., : 1024 + 256], 1024, 256, None))
    report["acf_matmul_rel"] = float(
        np.abs(acf_m - acf_f).max() / max(np.abs(acf_f[..., 0]).max(), 1e-9)
    )

    # pYIN: 220 Hz tone -> decoded voiced with f0 within 0.5 Hz mid-signal
    # (gates the candidate scan + scatter + banded Viterbi end to end;
    # forced to 1.0 if any mid frame decodes unvoiced)
    f0p, vfp, _ = ops.pyin(
        jnp.asarray(xy), 16000, fmin=80, fmax=1200, resolution=0.5,
        n_thresholds=32,
    )
    f0p, vfp = np.asarray(f0p)[4:-4], np.asarray(vfp)[4:-4]
    report["pyin_220_rel"] = (
        float(np.abs(f0p - 220.0).max() / 220.0) if vfp.all() else 1.0
    )

    # griffin_lim at its shipped "default" tier: spectral-convergence error
    # of a 16-iteration tone reconstruction. The iteration renormalizes, so
    # a single-pass dot converges like a full float32 one; a change that
    # breaks that would blow this up. Budget 0.2 (0.14 at float32 on CPU).
    import jax as _jax

    xg = (0.5 * np.sin(2 * np.pi * 440.0 * np.arange(16000) / 16000.0)).astype(
        np.float32
    )
    mag_g = _jax.jit(lambda z: ops.magnitude(ops.stft(z, 1024, 256)))(
        jnp.asarray(xg)
    )
    yg = _jax.jit(
        lambda m: ops.griffin_lim(m, 1024, 256, n_iter=16)
    )(mag_g)
    rec_g = np.asarray(
        _jax.jit(lambda z: ops.magnitude(ops.stft(z, 1024, 256)))(yg)
    )
    mg = np.asarray(mag_g)
    fg = min(rec_g.shape[0], mg.shape[0])
    report["griffinlim_tone_err"] = float(
        np.linalg.norm(rec_g[:fg] - mg[:fg]) / np.linalg.norm(mg)
    )

    # mel NNLS inversion at its shipped "high" tier: the mel projection of
    # the reconstruction must match the target mel after 64 iterations
    fb_n = ops.mel_filterbank(513, 64, 16000)
    s_n = (rng.random((20, 513)) ** 2).astype(np.float32)
    m_n = ops.apply_mel(jnp.asarray(s_n), fb_n)
    m_rec = np.asarray(ops.apply_mel(ops.mel_to_stft(m_n, fb_n, n_iter=64), fb_n))
    report["mel_nnls_rel"] = float(
        np.abs(m_rec - np.asarray(m_n)).max() / np.asarray(m_n).max()
    )

    # FIR direct path vs float64 serial convolution (gates the conv
    # precision rule — a conv at a reduced-precision default is ~3e-3 off)
    hf = ops.fir_design(65, 2000.0, 16000.0)
    xf = (0.3 * rng.standard_normal(4000)).astype(np.float32)
    got_f, _ = ops.fir_apply(jnp.asarray(xf), hf, impl="direct")
    want_f = np.convolve(xf.astype(np.float64), hf)[:4000]
    report["fir_direct"] = float(np.abs(np.asarray(got_f) - want_f).max())

    float_keys = [
        k
        for k in report
        if k
        not in (
            "vad_state_mismatches",
            "quantize_i16",
            "loudness_997_anchor_lu",
            "yin_220_rel",
            "cqt_440_mag_err",
            "icqt_painless_snr_db",
            "icqt_tone_snr_db",
            "icqt_hybrid_noise_snr_db",
            "icqt_hybrid_harm_snr_db",
            "icqt_multirate_noise_snr_db",
            "acf_matmul_rel",
            "pyin_220_rel",
            "griffinlim_tone_err",
            "mel_nnls_rel",
        )
    ]
    report["max_abs_err"] = max(report[k] for k in float_keys)
    report["pass"] = bool(
        report["max_abs_err"] < 1e-4
        and report["vad_state_mismatches"] == 0
        and report["quantize_i16"] == 0
        and report["loudness_997_anchor_lu"] < 1e-2
        and report["yin_220_rel"] < 5e-3
        and report["cqt_440_mag_err"] < 5e-2
        and report["icqt_painless_snr_db"] < -30.0
        and report["icqt_tone_snr_db"] < -30.0
        and -25.0 < report["icqt_hybrid_noise_snr_db"] < 10.0
        and 0.0 < report["icqt_hybrid_harm_snr_db"] < 25.0
        and report["icqt_multirate_noise_snr_db"] < -30.0
        and report["acf_matmul_rel"] < 1e-3
        and report["pyin_220_rel"] < 5e-3
        and report["griffinlim_tone_err"] < 0.2
        and report["mel_nnls_rel"] < 5e-3
    )
    return report
