"""Energy-based voice-activity detection as a `lax.scan`.

Formula-exact port of the reference's 3-state VAD
(reference: src-tauri/src/modules/audio/vad.rs:56-205), preserving its
quirks deliberately (SURVEY §7.4):

* "RMS" energy is mean-of-squares with NO sqrt (vad.rs:157-168);
* dBFS = 20*log10(mean-square), -inf for <= 0 (vad.rs:171-176);
* EMA smoothing s <- a*e + (1-a)*s, but detection uses the *raw* energy when
  a == 0 (vad.rs:101-112);
* state machine Silence(0) -> Speech(1) -> Ending(2), where Ending is emitted
  exactly once and reverts to Silence on the next frame regardless of input
  (vad.rs:121-151); speech shorter than ``min_speech_frames`` is dropped;
* the returned state is the post-update state of each frame.

The per-frame carry ``(smoothed, silence_frames, speech_frames, state)`` is
O(1), so arbitrarily long streams run in constant memory — the carry is also
the session checkpoint format (SURVEY §5.4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .dynamics import energy_to_dbfs, mean_square_energy

SILENCE, SPEECH, ENDING = 0, 1, 2


@dataclass(frozen=True)
class VadConfig:
    """Defaults match vad.rs:34-43 (-50 dB, a=0.3, 15 frames ~ 300 ms, 3 frames)."""

    threshold_db: float = -50.0
    smoothing_factor: float = 0.3
    silence_timeout_frames: int = 15
    min_speech_frames: int = 3


# VAD "levels" for coarse sensitivity selection (vad.rs:8-17). The reference
# never maps levels to thresholds (scribe_client.rs:395-404 are stubs); we give
# them concrete, documented meanings.
VAD_LEVELS = {
    "aggressive": VadConfig(threshold_db=-55.0),
    "balanced": VadConfig(threshold_db=-50.0),
    "relaxed": VadConfig(threshold_db=-40.0),
}


class VadCarry(NamedTuple):
    smoothed: jnp.ndarray  # f32 scalar
    silence_frames: jnp.ndarray  # i32 scalar
    speech_frames: jnp.ndarray  # i32 scalar
    state: jnp.ndarray  # i32 scalar in {0,1,2}


def vad_init(lead_shape=(), dtype=jnp.float32) -> VadCarry:
    z = jnp.zeros(lead_shape, dtype)
    zi = jnp.zeros(lead_shape, jnp.int32)
    return VadCarry(z, zi, zi, zi)


def vad_step(cfg: VadConfig, carry: VadCarry, energy: jnp.ndarray) -> tuple[VadCarry, jnp.ndarray]:
    """One frame update given the frame's mean-square energy. Returns new state."""
    alpha = jnp.asarray(cfg.smoothing_factor, energy.dtype)
    smoothed = alpha * energy + (1.0 - alpha) * carry.smoothed
    # vad.rs:108-112 — this branch is on a *config* value, resolved at trace time
    detection = smoothed if cfg.smoothing_factor > 0.0 else energy
    dbfs = energy_to_dbfs(detection)
    is_speech = dbfs > cfg.threshold_db

    st, sil, spc = carry.state, carry.silence_frames, carry.speech_frames

    # --- Silence branch (vad.rs:122-128)
    sil_state = jnp.where(is_speech, SPEECH, SILENCE)
    sil_speech = jnp.where(is_speech, 1, spc)
    sil_silence = jnp.where(is_speech, 0, sil)

    # --- Speech branch (vad.rs:129-145)
    sp_speech_ct = jnp.where(is_speech, spc + 1, spc)
    sp_silence_ct = jnp.where(is_speech, 0, sil + 1)
    timeout = jnp.logical_and(~is_speech, sp_silence_ct >= cfg.silence_timeout_frames)
    long_enough = spc >= cfg.min_speech_frames
    sp_state = jnp.where(timeout, jnp.where(long_enough, ENDING, SILENCE), SPEECH)
    sp_speech_ct = jnp.where(timeout, 0, sp_speech_ct)

    # --- Ending branch (vad.rs:146-150): unconditionally back to Silence
    end_state, end_sil = jnp.asarray(SILENCE, jnp.int32), jnp.asarray(0, jnp.int32)

    in_sil = st == SILENCE
    in_spc = st == SPEECH
    new_state = jnp.where(in_sil, sil_state, jnp.where(in_spc, sp_state, end_state))
    new_sil = jnp.where(in_sil, sil_silence, jnp.where(in_spc, sp_silence_ct, end_sil))
    new_spc = jnp.where(in_sil, sil_speech, jnp.where(in_spc, sp_speech_ct, spc))

    new = VadCarry(
        smoothed,
        new_sil.astype(jnp.int32),
        new_spc.astype(jnp.int32),
        new_state.astype(jnp.int32),
    )
    return new, new.state


def vad_scan(
    frames: jnp.ndarray,
    cfg: VadConfig = VadConfig(),
    carry: VadCarry | None = None,
) -> tuple[VadCarry, jnp.ndarray]:
    """Run VAD over ``frames [..., n_frames, frame_len]``.

    Returns (carry with leading shape ``[...]``, states ``[..., n_frames]``).
    The scan is over time; all leading axes ride along elementwise, so one
    scan serves the whole batch.
    """
    energies = mean_square_energy(frames, axis=-1)  # [..., n_frames]
    lead = energies.shape[:-1]
    if carry is None:
        carry = vad_init(lead, energies.dtype)
    en_t = jnp.moveaxis(energies, -1, 0)  # [n_frames, ...]
    carry, states = jax.lax.scan(lambda c, e: vad_step(cfg, c, e), carry, en_t)
    return carry, jnp.moveaxis(states, 0, -1)


def vad_energy_db(carry: VadCarry) -> jnp.ndarray:
    """Current smoothed energy in dB (vad.rs:192-194 parity)."""
    return energy_to_dbfs(carry.smoothed)


def is_speaking(carry: VadCarry) -> jnp.ndarray:
    return carry.state == SPEECH
