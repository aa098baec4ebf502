"""pYIN's banded Viterbi decode against a float64 numpy decoder.

Kept apart from test_pitch.py: compiling the decode at resolution 0.1 (469
bins, a 139-bin band) takes minutes on the CPU backend, and test files are
the unit the parallel test run spreads over workers."""

import numpy as np
import pytest

import jax.numpy as jnp


def _banded_viterbi64(log_v, log_u, half, switch_prob):
    """float64 two-track banded Viterbi: states are (voiced bin | unvoiced
    bin); a step moves at most ``half`` bins with triangular weights and
    stays on (log1p(-p)) or switches (log p) track. Returns [F] states
    (unvoiced = n_bins + bin)."""
    f_count, n = log_v.shape
    tri = 1.0 - np.abs(np.arange(-half, half + 1)) / (half + 1.0)
    lk = np.log(tri / tri.sum())
    stay, switch = np.log1p(-switch_prob), np.log(switch_prob)

    def band(d):  # best source per target bin: (score, source bin)
        pad = np.concatenate([np.full(half, -np.inf), d, np.full(half, -np.inf)])
        win = np.lib.stride_tricks.sliding_window_view(pad, 2 * half + 1) + lk
        arg = np.argmax(win, axis=1)
        return win[np.arange(n), arg], np.arange(n) + arg - half

    dv = -np.log(2 * n) + log_v[0]
    du = -np.log(2 * n) + log_u[0]
    back = []
    for t in range(1, f_count):
        bv, sv = band(dv)
        bu, su = band(du)
        # ties go to the same track (the strict > of the banded decoder)
        from_u_v = bu + switch > bv + stay
        from_u_u = ~(bv + switch > bu + stay)
        src_v = np.where(from_u_v, su + n, sv)
        src_u = np.where(from_u_u, su + n, sv)
        dv = log_v[t] + np.where(from_u_v, bu + switch, bv + stay)
        du = log_u[t] + np.where(from_u_u, bu + stay, bv + switch)
        back.append(np.concatenate([src_v, src_u]))
    states = [int(np.argmax(np.concatenate([dv, du])))]
    for bp in reversed(back):
        states.append(int(bp[states[-1]]))
    return np.asarray(states[::-1])


def _glide_with_gap(sr=16000, seconds=1.0, shift=0):
    t = np.arange(int(sr * seconds)) / sr
    x = 0.5 * np.sin(2 * np.pi * (180.0 + 90.0 * t) * t)
    gap = slice(int(0.35 * sr), int(0.6 * sr))
    x[gap] = 0.001 * np.random.default_rng(7).standard_normal(gap.stop - gap.start)
    return np.roll(x, shift).astype(np.float32)


@pytest.mark.parametrize("resolution", [0.5, 0.1])
@pytest.mark.parametrize("batched", [False, True], ids=["unbatched", "batched"])
def test_pyin_viterbi_matches_float64_banded_viterbi(resolution, batched):
    """The scan decode (states -> voiced flag and refined f0) equals a
    float64 numpy banded Viterbi run on the same observations."""
    from audioflow_tpu.ops.framing import frame as _frame
    from audioflow_tpu.ops.pitch import (
        _pitch_bin_centers, _pyin_hmm_consts, _pyin_log_obs, _pyin_observations, pyin_frames,
    )

    sr, fl, hop, fmin, fmax = 16000, 2048, 256, 80.0, 1200.0
    xs = [_glide_with_gap()] + ([_glide_with_gap(shift=3000)] if batched else [])
    x = np.stack(xs) if batched else xs[0]
    fr = _frame(jnp.asarray(x), fl, hop)
    kw = dict(n_thresholds=16, resolution=resolution)
    f0, vflag, _ = pyin_frames(fr, sr, fmin, fmax, hop=hop, **kw)
    obs_v, vprob, trough, prob, f0_lag, bins, n_bins, nbps = _pyin_observations(
        fr, sr, fmin, fmax, **kw)
    log_v, log_u = _pyin_log_obs(obs_v, vprob, n_bins)
    half = _pyin_hmm_consts(sr, hop, nbps, 35.92, 0.01, jnp.float32)[0]
    centers = np.asarray(_pitch_bin_centers(fmin, n_bins, nbps, jnp.float32))
    lanes = range(len(xs)) if batched else [None]
    for lane in lanes:
        sel = (lambda a: np.asarray(a)[lane]) if batched else np.asarray
        states = _banded_viterbi64(sel(log_v).astype(np.float64), sel(log_u).astype(np.float64),
                                   half, 0.01)
        voiced = states < n_bins
        b = np.where(voiced, states, states - n_bins)
        assert voiced.any() and (~voiced).any()
        np.testing.assert_array_equal(sel(vflag), voiced)
        # refined f0: the decoded bin's most probable trough, else its center
        score = np.where(sel(trough) & (sel(bins) == b[:, None]), sel(prob), -1.0)
        best = np.argmax(score, axis=1)
        want = np.where(score.max(axis=1) > 0, sel(f0_lag)[np.arange(len(b)), best], centers[b])
        # the unvoiced track's observations are flat across bins, so its bin
        # is a near-tie that float32 and float64 may break differently: f0
        # is compared where the frame is voiced
        np.testing.assert_allclose(sel(f0)[voiced], want[voiced], rtol=1e-6)
