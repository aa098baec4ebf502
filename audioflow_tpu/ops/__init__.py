"""Kernel library: the on-device replacement of the reference's DSP modules
(reference: src-tauri/src/modules/audio/) plus the north-star ops.

Everything here is pure-functional jnp/lax code with static shapes, meant
to be composed by :mod:`audioflow_tpu.graph` into one jitted XLA program.
"""

from . import (
    augment,
    biquad,
    cqt as cqt_mod,
    decompose,
    dynamics,
    effects,
    features,
    fir,
    framing,
    griffinlim,
    loudness,
    lpc as lpc_mod,
    mel,
    phase_vocoder,
    pitch,
    quantize,
    resample,
    rhythm,
    ring,
    segment,
    sequence,
    stft,
    vad,
    windows,
)
from ._mm import get_default_matmul_precision, set_default_matmul_precision
from .biquad import (
    Biquad,
    allpass,
    bandpass,
    biquad_chain,
    high_shelf,
    highpass,
    iir_apply,
    low_shelf,
    lowpass,
    make_iir_plan,
    notch,
    peaking,
)
from .augment import freq_mask, spec_augment, time_mask
from .dynamics import (
    agc,
    cmvn,
    deemphasis,
    compressor,
    compressor_gain,
    energy_to_dbfs,
    gate_gain,
    preemphasis,
    gain_db,
    limiter,
    mean_square_energy,
    noise_gate,
    peak_normalize,
    rms_normalize,
    split_silence,
    to_mono,
    trim_silence,
)
from .effects import chorus, feedback_delay, flanger, tremolo, vibrato
from .decompose import hpss, hpss_mask, median_filter, nmf, nmf_separate, noise_profile, spectral_gate
from .features import (
    add_deltas,
    chroma,
    chroma_filterbank,
    contrast_bands,
    delta,
    fft_frequencies,
    frame_rms,
    pcen,
    pcen_smoother,
    spectral_bandwidth,
    spectral_centroid,
    spectral_contrast,
    spectral_features,
    spectral_flatness,
    spectral_flux,
    spectral_rolloff,
    stack_memory,
    tonnetz,
    tonnetz_basis,
    zero_crossing_rate,
)
from .cqt import (
    FMIN_C1,
    MultirateCqt,
    chroma_cqt,
    cqt,
    cqt_frequencies,
    cqt_lengths,
    cqt_multirate,
    cqt_window_length,
    icqt,
    icqt_max_hop,
    icqt_multirate,
    multirate_hops,
)
from .fir import convolve, fir_apply, fir_design
from .framing import frame, num_frames, overlap_add
from .griffinlim import griffin_lim
from .loudness import (
    integrated_loudness,
    k_weight,
    k_weighting,
    loudness_range,
    momentary_loudness,
    normalize_loudness,
    shortterm_loudness,
    true_peak,
)
from .lpc import lpc, lpc_from_autocorr, lpc_residual_energy
from .mel import (
    apply_mel,
    dct_matrix,
    log_mel,
    log_mel_fused,
    mel_filterbank,
    mel_to_audio,
    mel_to_stft,
    mfcc,
    mfcc_to_audio,
    mfcc_to_log_mel,
)
from .phase_vocoder import phase_vocoder, pitch_shift, time_stretch
from .pitch import (
    ACF_PRECISION_DEFAULT,
    OnlinePyinPlan,
    cmnd_frames,
    make_online_pyin_plan,
    online_pyin_init,
    online_pyin_step,
    piptrack,
    pyin,
    pyin_frames,
    pyin_online,
    yin,
    yin_frames,
    yin_voicing,
)
from .quantize import dequantize_i16, quantize_i16, quantize_i16_round
from .resample import ResamplePlan, make_plan, resample, resample_apply
from .rhythm import (
    autocorrelate,
    beat_track,
    make_online_beat_plan,
    online_beat_init,
    online_beat_step,
    online_beat_track,
    onset_strength,
    peak_pick,
    tempo,
    tempo_frequencies,
    tempogram,
)
from .ring import Ring, ring_available, ring_clear, ring_free, ring_init, ring_read, ring_write
from .segment import (
    cross_similarity,
    novelty_curve,
    recurrence_matrix,
    segment_boundaries,
    self_similarity,
)
from .sequence import dtw, max_plus_band, max_plus_band_argmax, transition_local, viterbi
from .stft import istft, magnitude, power, spectrogram, stft
from .vad import VAD_LEVELS, VadCarry, VadConfig, is_speaking, vad_init, vad_scan, vad_step
from .windows import get_window

__all__ = [k for k in dir() if not k.startswith("_")]
