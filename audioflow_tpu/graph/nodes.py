"""Flow-graph nodes: typed, hashable configs wrapping the kernel library.

Each node is a frozen dataclass (hashable → usable as a jit static argument,
SURVEY §5.6) with two execution modes:

* ``apply(x)`` — offline whole-array transform; the graph chains these into
  one traced function that jit compiles to a single XLA program (the north
  star's "chained transform nodes compile to a single jitted XLA program").
* ``init_carry(...)`` / ``step(carry, chunk)`` — streaming mode with O(1)
  carried state (resampler history, STFT overlap, IIR state, VAD machine,
  limiter envelope), the on-device analog of the reference's accumulate-and-chunk
  pipeline (capture ring -> BatchResampler -> VAD, SURVEY §3.3). Carries are
  ordinary pytrees, so they double as the checkpoint format (SURVEY §5.4).

Data domains: "samples" (PCM [..., T]), "frames" (spectral [..., T, F]),
"any". The graph validates domain adjacency at construction.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from .. import ops
from ..errors import AudioError, ErrorCode
import importlib

from ..ops import biquad as _biquad
from ..ops import vad as _vad

# `ops.resample` the attribute is the re-exported *function*; fetch the
# submodule itself for the streaming-plan API
_resample = importlib.import_module("audioflow_tpu.ops.resample")

_REGISTRY: dict[str, type] = {}


def register_node(cls):
    """Register a node class for config (de)serialization by name."""
    _REGISTRY[cls.__name__] = cls
    return cls


def node_registry() -> dict[str, type]:
    return dict(_REGISTRY)


@dataclass(frozen=True)
class Node:
    """Base node. Subclasses override the class attrs + methods they need."""

    domain_in = "samples"
    domain_out = "samples"
    streamable = True
    # When True, Graph.stream_step passes step(carry, chunk, first_index=i)
    # where i is the chunk-relative index of the stream's first real (offline
    # position 0) sample — negative once passed, >= chunk length before it
    # arrives. For nodes whose edge convention is position-dependent and so
    # not a zero-input fixpoint (Preemphasis' Kaldi y[0] = x[0] - k*x[0]).
    wants_first_index = False
    # When True, Graph.stream_step does NOT zero this node's upstream-warmup
    # input region (Graph._warmups). Default False is right for recursive/
    # accumulating nodes (biquad, limiter, VAD EMA): offline they start from
    # zero state at sample 0, so the preroll must look like zeros. Opt out
    # for nodes whose streaming design *consumes* the preroll — e.g. Istft's
    # WOLA identity-reconstruction, whose wsum ramp bookkeeping counts every
    # incoming frame and is exact for any prefix but wrong for zeroed frames.
    warmup_passthrough = False

    # --- rate/meta propagation -------------------------------------------
    def rate_out(self, rate_in: int | None) -> int | None:
        return rate_in

    def bind(self, rate_in: int | None) -> "Node":
        """Resolve rate-dependent defaults (sample_rate=None) at graph build."""
        if rate_in is not None and getattr(self, "sample_rate", "x") is None:
            return dataclasses.replace(self, sample_rate=rate_in)
        return self

    # --- offline ----------------------------------------------------------
    def apply(self, x: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    # --- streaming ---------------------------------------------------------
    def chunk_multiple(self) -> int:
        """Streaming chunks entering this node must be a multiple of this."""
        return 1

    def validate_chunk(self, n_in: int) -> None:
        m = self.chunk_multiple()
        if n_in % m:
            raise AudioError(
                f"{type(self).__name__}: chunk {n_in} not a multiple of {m}",
                code=ErrorCode.SHAPE_MISMATCH,
            )

    def out_len(self, n_in: int) -> int:
        return n_in

    def latency(self, n_in: int) -> int:
        """Streaming latency in *output* units for chunk size n_in."""
        return 0

    def init_carry(self, lead_shape: tuple, n_in: int, dtype=jnp.float32):
        return None

    def step(self, carry, chunk):
        return carry, self.apply(chunk)


@register_node
@dataclass(frozen=True)
class ToMono(Node):
    """Interleaved multi-channel -> mono mean (capture.rs:30-42)."""

    channels: int = 2

    def apply(self, x):
        return ops.to_mono(x, self.channels)

    def chunk_multiple(self):
        return self.channels

    def out_len(self, n_in):
        return n_in // self.channels


@register_node
@dataclass(frozen=True)
class Resample(Node):
    """Rational resampler (polyphase matmul); resampler.rs equivalent."""

    input_rate: int = 48000
    output_rate: int = 16000
    mode: str = "kaiser"

    def rate_out(self, rate_in):
        return self.output_rate

    def bind(self, rate_in):
        if rate_in is not None and rate_in != self.input_rate:
            raise AudioError(
                f"Resample node expects input rate {self.input_rate}, graph carries {rate_in}",
                code=ErrorCode.SHAPE_MISMATCH,
            )
        return self

    @property
    def _identity(self) -> bool:
        return self.input_rate == self.output_rate

    def apply(self, x):
        return ops.resample(x, self.input_rate, self.output_rate, self.mode)

    def _stream_plan(self, n_in):
        return _resample.make_stream_plan(self.input_rate, self.output_rate, self.mode, chunk_in=n_in)

    def chunk_multiple(self):
        if self._identity:
            return 1
        return _resample.stream_chunk_multiple(self.input_rate, self.output_rate)

    def out_len(self, n_in):
        return n_in if self._identity else self._stream_plan(n_in).n_out_chunk

    def latency(self, n_in):
        return 0 if self._identity else self._stream_plan(n_in).latency_out

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        if self._identity:
            return None
        return _resample.resample_stream_init(self._stream_plan(n_in), lead_shape, dtype)

    def step(self, carry, chunk):
        if self._identity:
            return carry, chunk
        return _resample.resample_stream_step(self._stream_plan(chunk.shape[-1]), carry, chunk)


@register_node
@dataclass(frozen=True)
class BiquadChain(Node):
    """Cascade of biquads (north-star config 3's EQ chain)."""

    biquads: tuple[_biquad.Biquad, ...] = ()
    block: int = 128

    def __post_init__(self):
        if not self.biquads:
            raise AudioError("empty biquad chain", code=ErrorCode.CONFIG_VALIDATION_ERROR)

    @property
    def _plan(self):
        return _biquad.make_iir_plan(tuple(self.biquads), self.block)

    def apply(self, x):
        y, _ = _biquad.iir_apply(x, self._plan)
        return y

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return jnp.zeros((*lead_shape, self._plan.order), dtype)

    def step(self, carry, chunk):
        y, s = _biquad.iir_apply(chunk, self._plan, zi=carry)
        return s, y


@register_node
@dataclass(frozen=True)
class Gain(Node):
    db: float = 0.0

    def apply(self, x):
        return ops.gain_db(x, self.db)


@register_node
@dataclass(frozen=True)
class PeakNormalize(Node):
    """Whole-signal op: offline only."""

    target_peak: float = 1.0
    streamable = False

    def apply(self, x):
        return ops.peak_normalize(x, self.target_peak)


@register_node
@dataclass(frozen=True)
class RmsNormalize(Node):
    target_db: float = -20.0
    streamable = False

    def apply(self, x):
        return ops.rms_normalize(x, self.target_db)


@register_node
@dataclass(frozen=True)
class Limiter(Node):
    """Peak limiter; envelope carry makes streaming exact."""

    threshold_db: float = -1.0
    release_ms: float = 50.0
    sample_rate: int | None = None

    def _coeff(self) -> float:
        if self.sample_rate is None:
            raise AudioError("Limiter.sample_rate unresolved; set input_rate on the graph")
        return float(np.exp(-1.0 / (self.release_ms * 1e-3 * self.sample_rate)))

    def apply(self, x):
        return ops.limiter(x, self.threshold_db, self.release_ms, self.sample_rate)

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return jnp.zeros(lead_shape, dtype)

    def step(self, carry, chunk):
        r = self._coeff()
        env = ops.dynamics.envelope_peak_release(jnp.abs(chunk), r)
        t = chunk.shape[-1]
        decay = carry[..., None] * (r ** jnp.arange(1, t + 1, dtype=chunk.dtype))
        env = jnp.maximum(env, decay)
        thresh = 10.0 ** (self.threshold_db / 20.0)
        g = jnp.minimum(1.0, thresh / jnp.maximum(env, 1e-30))
        return env[..., -1], chunk * g


@register_node
@dataclass(frozen=True)
class Compressor(Node):
    """Downward compressor (threshold/ratio/knee); envelope carry makes
    streaming exact, same machinery as :class:`Limiter`."""

    threshold_db: float = -20.0
    ratio: float = 4.0
    release_ms: float = 100.0
    knee_db: float = 0.0
    sample_rate: int | None = None

    def _coeff(self) -> float:
        if self.sample_rate is None:
            raise AudioError("Compressor.sample_rate unresolved; set input_rate on the graph")
        return float(np.exp(-1.0 / (self.release_ms * 1e-3 * self.sample_rate)))

    def apply(self, x):
        return ops.compressor(
            x, self.threshold_db, self.ratio, self.release_ms, self.sample_rate, self.knee_db
        )

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return jnp.zeros(lead_shape, dtype)

    def step(self, carry, chunk):
        r = self._coeff()
        env = ops.dynamics.envelope_peak_release(jnp.abs(chunk), r)
        t = chunk.shape[-1]
        decay = carry[..., None] * (r ** jnp.arange(1, t + 1, dtype=chunk.dtype))
        env = jnp.maximum(env, decay)
        g = ops.dynamics.compressor_gain(env, self.threshold_db, self.ratio, self.knee_db)
        return env[..., -1], chunk * g


@register_node
@dataclass(frozen=True)
class Agc(Node):
    """Automatic gain control (slow leveler, ops/dynamics.py::agc). The
    gain-dB scalar is the streaming carry, so streamed == offline exactly
    when chunks are block multiples (``chunk_multiple`` enforces it)."""

    target_db: float = -20.0
    block: int = 1024
    max_gain_db: float = 30.0
    up_db_per_s: float = 6.0
    down_db_per_s: float = 60.0
    floor_db: float = -55.0
    sample_rate: int | None = None

    def _rate(self):
        if self.sample_rate is None:
            raise AudioError("Agc.sample_rate unresolved; set input_rate on the graph")
        return self.sample_rate

    def apply(self, x):
        y, _ = ops.agc(
            x, self.target_db, self.block, self.max_gain_db,
            self.up_db_per_s, self.down_db_per_s, self._rate(), self.floor_db,
        )
        return y

    def chunk_multiple(self):
        return self.block

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return jnp.zeros(lead_shape, dtype)

    def step(self, carry, chunk):
        y, g = ops.agc(
            chunk, self.target_db, self.block, self.max_gain_db,
            self.up_db_per_s, self.down_db_per_s, self._rate(), self.floor_db,
            gain0=carry,
        )
        return g, y


@register_node
@dataclass(frozen=True)
class NoiseGate(Node):
    """Hard downward gate below ``threshold_db`` (attenuates by ``floor_db``);
    same exact-streaming envelope carry as :class:`Limiter`."""

    threshold_db: float = -60.0
    release_ms: float = 100.0
    floor_db: float = -80.0
    sample_rate: int | None = None

    def _coeff(self) -> float:
        if self.sample_rate is None:
            raise AudioError("NoiseGate.sample_rate unresolved; set input_rate on the graph")
        return float(np.exp(-1.0 / (self.release_ms * 1e-3 * self.sample_rate)))

    def apply(self, x):
        return ops.noise_gate(
            x, self.threshold_db, self.release_ms, self.sample_rate, self.floor_db
        )

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return jnp.zeros(lead_shape, dtype)

    def step(self, carry, chunk):
        r = self._coeff()
        env = ops.dynamics.envelope_peak_release(jnp.abs(chunk), r)
        t = chunk.shape[-1]
        decay = carry[..., None] * (r ** jnp.arange(1, t + 1, dtype=chunk.dtype))
        env = jnp.maximum(env, decay)
        return env[..., -1], chunk * ops.dynamics.gate_gain(env, self.threshold_db, self.floor_db)


@register_node
@dataclass(frozen=True)
class Stft(Node):
    """samples -> complex frames. Streaming keeps a hop-aligned overlap tail;
    the stream equals offline STFT (center=False) of the zero-prehistory
    signal, with cdiv(n_fft, hop) - 1 frames of latency.

    Sharding note: XLA does not partition its FFT op, so a batch-sharded Stft
    all-gathers the batch (verified in tests). Use :class:`Spectrogram`
    (matmul-DFT, shards with zero collectives) unless the complex spectrum is
    needed downstream (ISTFT/phase vocoder)."""

    n_fft: int = 1024
    hop: int = 256
    window: str = "hann"
    center: bool = True

    domain_out = "frames"

    def apply(self, x):
        return ops.stft(x, self.n_fft, self.hop, window=self.window, center=self.center)

    def chunk_multiple(self):
        return self.hop

    @property
    def streamable(self):  # center-padding needs the whole signal
        return not self.center

    def validate_chunk(self, n_in):
        super().validate_chunk(n_in)
        if self.center:
            raise AudioError(
                f"{type(self).__name__}: streaming requires center=False "
                "(center-padding needs the whole signal)",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def out_len(self, n_in):
        return n_in // self.hop

    @property
    def _carry_len(self) -> int:
        # hop-aligned history (>= n_fft - hop) so streamed frames stay on the
        # offline hop grid even when hop does not divide n_fft
        return (-(-self.n_fft // self.hop) - 1) * self.hop

    def latency(self, n_in):
        return self._carry_len // self.hop

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return jnp.zeros((*lead_shape, self._carry_len), dtype)

    def step(self, carry, chunk):
        buf = jnp.concatenate([carry, chunk], axis=-1)
        spec = ops.stft(buf, self.n_fft, self.hop, window=self.window, center=False)
        return buf[..., buf.shape[-1] - self._carry_len :], spec


@register_node
@dataclass(frozen=True)
class Spectrogram(Node):
    """Fused power/magnitude spectrogram: windowed real DFT as two matmuls
    (impl='matmul') or via rfft.
    Streaming semantics identical to Stft."""

    n_fft: int = 1024
    hop: int = 256
    window: str = "hann"
    center: bool = True
    power: bool = True
    impl: str = "matmul"
    win_length: int | None = None
    precision: str | None = None  # None -> ops.stft.DFT_PRECISION_DEFAULT

    domain_out = "frames"

    def apply(self, x):
        return ops.spectrogram(
            x, self.n_fft, self.hop, self.window, self.win_length,
            center=self.center, power=self.power, impl=self.impl,
            precision=self.precision,
        )

    def chunk_multiple(self):
        return self.hop

    @property
    def streamable(self):  # center-padding needs the whole signal
        return not self.center

    def validate_chunk(self, n_in):
        super().validate_chunk(n_in)
        if self.center:
            raise AudioError(
                "Spectrogram: streaming requires center=False "
                "(center-padding needs the whole signal)",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def out_len(self, n_in):
        return n_in // self.hop

    @property
    def _carry_len(self) -> int:
        # hop-aligned history (>= n_fft - hop); see Stft._carry_len
        return (-(-self.n_fft // self.hop) - 1) * self.hop

    def latency(self, n_in):
        return self._carry_len // self.hop

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return jnp.zeros((*lead_shape, self._carry_len), dtype)

    def step(self, carry, chunk):
        buf = jnp.concatenate([carry, chunk], axis=-1)
        spec = ops.spectrogram(
            buf, self.n_fft, self.hop, self.window, self.win_length,
            center=False, power=self.power, impl=self.impl,
            precision=self.precision,
        )
        return buf[..., buf.shape[-1] - self._carry_len :], spec


@register_node
@dataclass(frozen=True)
class Magnitude(Node):
    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        return ops.magnitude(x)


@register_node
@dataclass(frozen=True)
class Power(Node):
    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        return ops.power(x)


@register_node
@dataclass(frozen=True)
class LogMelSpec(Node):
    """Fused log-mel spectrogram: two zero-pad-waste dots
    (ops/mel.py::log_mel_fused), the same features as the Spectrogram +
    MelProject pair at the same precisions. Streaming
    semantics identical to Spectrogram (hop-aligned overlap carry)."""

    n_fft: int = 1024
    hop: int = 256
    n_mels: int = 128
    window: str = "hann"
    win_length: int | None = None
    center: bool = False
    f_min: float = 0.0
    f_max: float | None = None
    htk: bool = False
    norm: str | None = "slaney"
    log: str | None = "ln"
    floor: float = 1e-10
    sample_rate: int | None = None
    dft_precision: str | None = None
    fb_precision: str = "highest"

    domain_out = "frames"

    def _fb(self):
        if self.sample_rate is None:
            raise AudioError("LogMelSpec.sample_rate unresolved; set input_rate on the graph")
        return ops.mel_filterbank(
            self.n_fft // 2 + 1, self.n_mels, self.sample_rate,
            self.f_min, self.f_max, self.htk, self.norm,
        )

    def _run(self, x, center):
        return ops.log_mel_fused(
            x, self._fb(), self.n_fft, self.hop, self.window, self.win_length,
            center=center, floor=self.floor, log_base=self.log,
            dft_precision=self.dft_precision, fb_precision=self.fb_precision,
        )

    def apply(self, x):
        return self._run(x, self.center)

    def chunk_multiple(self):
        return self.hop

    @property
    def streamable(self):  # center-padding needs the whole signal
        return not self.center

    def validate_chunk(self, n_in):
        super().validate_chunk(n_in)
        if self.center:
            raise AudioError(
                "LogMelSpec: streaming requires center=False",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def out_len(self, n_in):
        return n_in // self.hop

    @property
    def _carry_len(self) -> int:
        return (-(-self.n_fft // self.hop) - 1) * self.hop

    def latency(self, n_in):
        return self._carry_len // self.hop

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return jnp.zeros((*lead_shape, self._carry_len), dtype)

    def step(self, carry, chunk):
        buf = jnp.concatenate([carry, chunk], axis=-1)
        out = self._run(buf, False)
        return buf[..., buf.shape[-1] - self._carry_len :], out


@register_node
@dataclass(frozen=True)
class MelProject(Node):
    """power/magnitude frames -> (log-)mel features; one matmul."""

    n_mels: int = 128
    sample_rate: int | None = None
    f_min: float = 0.0
    f_max: float | None = None
    htk: bool = False
    norm: str | None = "slaney"
    log: str | None = "ln"  # None -> linear mel
    floor: float = 1e-10

    domain_in = "frames"
    domain_out = "frames"

    def _fb(self, n_freqs):
        if self.sample_rate is None:
            raise AudioError("MelProject.sample_rate unresolved; set input_rate on the graph")
        return ops.mel_filterbank(
            n_freqs, self.n_mels, self.sample_rate, self.f_min, self.f_max, self.htk, self.norm
        )

    def apply(self, x):
        fb = self._fb(x.shape[-1])
        if self.log is None:
            return ops.apply_mel(x, fb)
        return ops.log_mel(x, fb, self.floor, self.log)


@register_node
@dataclass(frozen=True)
class Mfcc(Node):
    n_mfcc: int = 13
    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        return ops.mfcc(x, self.n_mfcc)


def _resolve_vad_level(node) -> None:
    """Resolve a named VAD sensitivity preset into ``threshold_db`` (frozen
    dataclass, so via object.__setattr__). Unknown names fail loudly."""
    if not node.level:
        return
    levels = _vad.VAD_LEVELS
    if node.level not in levels:
        raise AudioError(
            f"unknown VAD level {node.level!r}; known: {sorted(levels)}",
            code=ErrorCode.CONFIG_VALIDATION_ERROR,
        )
    object.__setattr__(node, "threshold_db", levels[node.level].threshold_db)


@register_node
@dataclass(frozen=True)
class Vad(Node):
    """Energy VAD over fixed frames; emits int32 states (0/1/2) per frame.

    ``level`` is a named sensitivity preset ("aggressive"/"balanced"/
    "relaxed", the reference's VadLevel enum, vad.rs:8-17 + the
    get/set_vad_level commands, commands.rs:482-511) that resolves to a
    threshold via :data:`audioflow_tpu.ops.vad.VAD_LEVELS`, overriding
    ``threshold_db``. Empty string = use ``threshold_db`` directly.
    """

    frame_len: int = 320  # 20 ms @ 16 kHz, the reference capture cadence
    threshold_db: float = -50.0
    smoothing_factor: float = 0.3
    silence_timeout_frames: int = 15
    min_speech_frames: int = 3
    level: str = ""

    domain_out = "frames"

    def __post_init__(self):
        _resolve_vad_level(self)

    def _cfg(self):
        return _vad.VadConfig(
            self.threshold_db,
            self.smoothing_factor,
            self.silence_timeout_frames,
            self.min_speech_frames,
        )

    def _frames(self, x):
        n = x.shape[-1] // self.frame_len
        return x[..., : n * self.frame_len].reshape(*x.shape[:-1], n, self.frame_len)

    def apply(self, x):
        _, states = _vad.vad_scan(self._frames(x), self._cfg())
        return states

    def chunk_multiple(self):
        return self.frame_len

    def out_len(self, n_in):
        return n_in // self.frame_len

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return _vad.vad_init(lead_shape, dtype)

    def step(self, carry, chunk):
        return _vad.vad_scan(self._frames(chunk), self._cfg(), carry)


@register_node
@dataclass(frozen=True)
class QuantizeI16(Node):
    """Wire-parity f32 -> i16 (websocket.rs:246-251)."""

    rounding: str = "trunc"  # "trunc" (reference parity) or "round"
    domain_in = "any"
    domain_out = "any"

    def apply(self, x):
        if self.rounding == "trunc":
            return ops.quantize_i16(x)
        return ops.quantize_i16_round(x)


@register_node
@dataclass(frozen=True)
class TimeStretch(Node):
    """Phase-vocoder time stretch (offline; changes duration)."""

    rate: float = 1.0
    n_fft: int = 1024
    hop: int = 256
    streamable = False

    def apply(self, x):
        return ops.time_stretch(x, self.rate, self.n_fft, self.hop)


@register_node
@dataclass(frozen=True)
class PitchShift(Node):
    semitones: float = 0.0
    sample_rate: int | None = None
    n_fft: int = 1024
    hop: int = 256
    streamable = False

    def apply(self, x):
        return ops.pitch_shift(x, self.semitones, self.sample_rate, self.n_fft, self.hop)


@register_node
@dataclass(frozen=True)
class Preemphasis(Node):
    """ASR-standard first-order high-pass (y[n] = x[n] - k*x[n-1]).

    Streaming carries the previous chunk's last sample so streamed == offline.
    The Kaldi edge convention (y[0] = x[0] - k*x[0], i.e. prev of the very
    first sample is the sample itself) is position-dependent, so unlike
    every zero-prehistory recurrence it is NOT a fixpoint of zero input:
    downstream of a latency-bearing node, the graph's warmup zeroing alone
    would make the first real sample read prev=0. The node therefore opts
    into ``wants_first_index`` and the graph passes the offline position of
    sample 0 (``Graph._warmups``) so the edge convention lands on the right
    sample regardless of upstream latency.
    """

    coeff: float = 0.97
    wants_first_index = True

    def apply(self, x):
        return ops.preemphasis(x, self.coeff)

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        # (previous sample, started flag); the flag serves direct step()
        # callers — inside a Graph, first_index supersedes it
        return (jnp.zeros((*lead_shape, 1), dtype), jnp.zeros((*lead_shape, 1), bool))

    def step(self, carry, chunk, first_index=None):
        prev_sample, started = carry
        if first_index is None:
            prev0 = jnp.where(started, prev_sample, chunk[..., :1])
            prev = jnp.concatenate([prev0, chunk[..., :-1]], axis=-1)
        else:
            prev = jnp.concatenate([prev_sample, chunk[..., :-1]], axis=-1)
            pos = jnp.arange(chunk.shape[-1])
            prev = jnp.where(pos == first_index, chunk, prev)
        new_carry = (chunk[..., -1:], jnp.ones_like(started))
        return new_carry, chunk - self.coeff * prev


@register_node
@dataclass(frozen=True)
class Cmvn(Node):
    """Per-utterance cepstral mean/variance normalization (offline only)."""

    norm_var: bool = False
    streamable = False
    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        return ops.cmvn(x, self.norm_var)


@register_node
@dataclass(frozen=True)
class LoudnessNormalize(Node):
    """EBU R128 loudness normalization: pure gain to ``target_lufs``
    integrated loudness (BS.1770-4 gated meter), optionally capped at a
    true-peak ceiling. Per-utterance two-pass — offline only, like
    :class:`Cmvn`."""

    target_lufs: float = -23.0
    max_true_peak_db: float | None = -1.0
    sample_rate: int | None = None
    streamable = False

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError(
                "LoudnessNormalize.sample_rate unresolved; set input_rate on the graph"
            )
        return ops.normalize_loudness(
            x, self.sample_rate, self.target_lufs, self.max_true_peak_db
        )


@register_node
@dataclass(frozen=True)
class SpectralFeatures(Node):
    """Magnitude frames -> stacked spectral descriptors
    ``[..., F, len(features)]`` (ops/features.py; librosa conventions).
    Feed from ``Spectrogram(power=False)``. Stateless per frame except
    "flux", which compares against the previous frame: streaming it needs
    ``n_bins`` (to size the prev-frame carry) and uses
    ``wants_first_index`` so the stream's offline frame 0 fluxes against
    itself, exactly as offline."""

    features: tuple = ("centroid", "bandwidth", "rolloff", "flatness")
    sample_rate: int | None = None
    n_bins: int | None = None

    domain_in = "frames"
    domain_out = "frames"
    wants_first_index = True

    @property
    def streamable(self):
        return "flux" not in self.features or self.n_bins is not None

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError(
                "SpectralFeatures.sample_rate unresolved; set input_rate on the graph"
            )
        n_fft = 2 * (x.shape[-1] - 1)
        return ops.spectral_features(x, self.sample_rate, n_fft, tuple(self.features))

    def validate_chunk(self, n_in):
        super().validate_chunk(n_in)
        if "flux" in self.features and self.n_bins is None:
            raise AudioError(
                "SpectralFeatures: streaming 'flux' needs n_bins (the "
                "spectrogram bin count) to size the prev-frame carry",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        if "flux" not in self.features:
            return None
        return jnp.zeros((*lead_shape, 1, self.n_bins), dtype)

    def step(self, carry, chunk, first_index=None):
        if carry is None:  # no flux: stateless per frame
            return None, self.apply(chunk)
        n_fft = 2 * (chunk.shape[-1] - 1)
        cols = []
        for name in self.features:
            if name == "flux":
                f = ops.spectral_flux(chunk, prev=carry)
                if first_index is not None:
                    pos = jnp.arange(chunk.shape[-2])
                    f = jnp.where(pos == first_index, 0.0, f)
                cols.append(f)
            else:
                cols.append(
                    ops.spectral_features(chunk, self.sample_rate, n_fft, (name,))[..., 0]
                )
        return chunk[..., -1:, :], jnp.stack(cols, axis=-1)


@register_node
@dataclass(frozen=True)
class Chroma(Node):
    """Power frames -> chromagram ``[..., F, n_chroma]`` (pitch classes,
    ops/features.py::chroma; librosa conventions, C = index 0). Stateless
    per frame — streams trivially. Feed from ``Spectrogram(power=True)``.
    Note: ``norm=True`` scales per frame by the frame max, which is exact
    under streaming (the max is within-frame)."""

    n_chroma: int = 12
    norm: bool = True
    tuning: float = 0.0
    sample_rate: int | None = None

    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError("Chroma.sample_rate unresolved; set input_rate on the graph")
        n_fft = 2 * (x.shape[-1] - 1)
        return ops.chroma(x, self.sample_rate, n_fft, self.n_chroma, self.norm, self.tuning)


@register_node
@dataclass(frozen=True)
class SpectralContrast(Node):
    """Magnitude frames -> octave-band spectral contrast
    ``[..., F, n_bands + 1]`` in dB (ops/features.py::spectral_contrast).
    Stateless per frame — streams trivially. Feed from
    ``Spectrogram(power=False)``."""

    n_bands: int = 6
    fmin: float = 200.0
    quantile: float = 0.02
    sample_rate: int | None = None

    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError(
                "SpectralContrast.sample_rate unresolved; set input_rate on the graph"
            )
        n_fft = 2 * (x.shape[-1] - 1)
        return ops.spectral_contrast(
            x, self.sample_rate, n_fft, self.n_bands, self.fmin, self.quantile
        )


@register_node
@dataclass(frozen=True)
class Tonnetz(Node):
    """Chroma frames -> 6-D tonal centroids ``[..., F, 6]``
    (ops/features.py::tonnetz, Harte/Sandler circles). Stateless per frame
    — streams trivially. Feed from :class:`Chroma`."""

    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        return ops.tonnetz(x)


@register_node
@dataclass(frozen=True)
class Cqt(Node):
    """samples -> constant-Q magnitude/power frames ``[..., F, n_bins]``
    (ops/cqt.py; per-octave matmul kernels). Streaming mirrors Stft's
    hop-aligned overlap carry (center=False), so streamed == offline
    exactly; the analysis window is the lowest bin's kernel length, so the
    carry is long (several thousand samples for fmin=C1) but O(1)."""

    hop: int = 256
    n_bins: int = 84
    fmin: float = ops.FMIN_C1
    bins_per_octave: int = 12
    window: str = "hann"
    filter_scale: float = 1.0
    center: bool = True
    output: str = "magnitude"
    impl: str = "split"
    precision: str | None = None
    sample_rate: int | None = None

    domain_out = "frames"

    def _rate(self):
        if self.sample_rate is None:
            raise AudioError("Cqt.sample_rate unresolved; set input_rate on the graph")
        return self.sample_rate

    def apply(self, x):
        return ops.cqt(
            x, self._rate(), self.hop, self.n_bins, self.fmin,
            self.bins_per_octave, self.window, self.filter_scale,
            center=self.center, output=self.output, impl=self.impl,
            precision=self.precision,
        )

    def chunk_multiple(self):
        return self.hop

    @property
    def streamable(self):  # center-padding needs the whole signal
        return not self.center and self.output != "complex"

    def validate_chunk(self, n_in):
        super().validate_chunk(n_in)
        if self.center:
            raise AudioError(
                "Cqt: streaming requires center=False",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def out_len(self, n_in):
        return n_in // self.hop

    @property
    def _carry_len(self) -> int:
        # the frame span F0 is a hop multiple by construction (ops/cqt.py)
        f0 = ops.cqt_window_length(
            self._rate(), self.hop, self.n_bins, self.fmin,
            self.bins_per_octave, self.filter_scale,
        )
        return f0 - self.hop

    def latency(self, n_in):
        return self._carry_len // self.hop

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return jnp.zeros((*lead_shape, self._carry_len), dtype)

    def step(self, carry, chunk):
        buf = jnp.concatenate([carry, chunk], axis=-1)
        out = ops.cqt(
            buf, self._rate(), self.hop, self.n_bins, self.fmin,
            self.bins_per_octave, self.window, self.filter_scale,
            center=False, output=self.output, impl=self.impl,
            precision=self.precision,
        )
        return buf[..., buf.shape[-1] - self._carry_len :], out


@register_node
@dataclass(frozen=True)
class OnsetStrength(Node):
    """Mel power frames -> onset envelope ``[..., F, 1]``
    (ops/rhythm.py::onset_strength; rectified dB flux over ``lag`` frames).
    Streaming carries the last ``lag`` raw frames; the offline zeros at
    frames < lag are reproduced via ``wants_first_index`` (needs ``n_bins``
    to size the carry)."""

    lag: int = 1
    n_bins: int | None = None

    domain_in = "frames"
    domain_out = "frames"
    wants_first_index = True

    @property
    def streamable(self):
        return self.n_bins is not None

    def apply(self, x):
        return ops.onset_strength(x, self.lag)[..., None]

    def validate_chunk(self, n_in):
        super().validate_chunk(n_in)
        if self.n_bins is None:
            raise AudioError(
                "OnsetStrength: streaming needs n_bins (the mel band count) "
                "to size the prev-frames carry",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return jnp.zeros((*lead_shape, self.lag, self.n_bins), dtype)

    def step(self, carry, chunk, first_index=None):
        buf = jnp.concatenate([carry, chunk], axis=-2)
        env = ops.onset_strength(buf, self.lag)[..., self.lag :, None]
        if first_index is not None:
            # offline frames < lag are zero (nothing to difference against)
            pos = jnp.arange(chunk.shape[-2])[:, None]
            env = jnp.where(pos < first_index + self.lag, 0.0, env)
        return buf[..., buf.shape[-2] - self.lag :, :], env


@register_node
@dataclass(frozen=True)
class Tempo(Node):
    """Onset envelope frames ``[..., F, 1]`` -> global tempo ``[..., 1, 1]``
    BPM (ops/rhythm.py::tempo). Whole-signal aggregation — offline only."""

    hop: int = 256
    start_bpm: float = 120.0
    std_bpm: float = 1.0
    max_tempo: float = 320.0
    ac_size: float = 8.0
    sample_rate: int | None = None
    streamable = False

    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError("Tempo.sample_rate unresolved; set input_rate on the graph")
        bpm = ops.tempo(
            x[..., 0], self.sample_rate, self.hop, self.start_bpm,
            self.std_bpm, self.max_tempo, self.ac_size,
        )
        return bpm[..., None, None]

    def out_len(self, n_in):
        return 1


@register_node
@dataclass(frozen=True)
class BeatTrack(Node):
    """Onset envelope frames ``[..., F, 1]`` -> beat mask ``[..., F, 1]``
    (1.0 at beat frames; ops/rhythm.py::beat_track, Ellis DP). Whole-signal
    dynamic programming — offline only."""

    hop: int = 256
    tightness: float = 100.0
    max_period: int = 256
    start_bpm: float = 120.0
    sample_rate: int | None = None
    streamable = False

    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError(
                "BeatTrack.sample_rate unresolved; set input_rate on the graph"
            )
        mask, _ = ops.beat_track(
            x[..., 0], self.sample_rate, self.hop,
            tightness=self.tightness, max_period=self.max_period,
            start_bpm=self.start_bpm,
        )
        return mask.astype(x.dtype)[..., None]


@register_node
@dataclass(frozen=True)
class OnlineBeats(Node):
    """Onset envelope frames ``[..., F, 1]`` -> ``[..., F, 2]`` of
    (beat mask, BPM track) from the CAUSAL tracker
    (ops/rhythm.py::online_beat_track) — the streaming counterpart of the
    whole-signal Ellis DP :class:`BeatTrack`. Carry = running
    exponentially-forgotten autocorrelation + peak window + beat clock;
    latency = ``post`` frames (the peak test's lookahead). Offline ==
    streamed exactly at that whole-unit shift; agreement with the DP on
    steady-tempo material is tested in tests/test_music.py."""

    hop: int = 256
    start_bpm: float = 120.0
    std_bpm: float = 1.0
    max_tempo: float = 320.0
    max_lag: int = 256
    ac_seconds: float = 8.0
    pre: int = 3
    post: int = 3
    delta: float = 0.07
    warmup_seconds: float = 2.0
    sample_rate: int | None = None

    domain_in = "frames"
    domain_out = "frames"
    wants_first_index = True

    def _plan(self):
        if self.sample_rate is None:
            raise AudioError(
                "OnlineBeats.sample_rate unresolved; set input_rate on the graph"
            )
        return ops.make_online_beat_plan(
            self.sample_rate, self.hop, self.start_bpm, self.std_bpm,
            self.max_tempo, self.max_lag, self.ac_seconds, self.pre,
            self.post, self.delta, self.warmup_seconds,
        )

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError(
                "OnlineBeats.sample_rate unresolved; set input_rate on the graph"
            )
        beat, bpm = ops.online_beat_track(
            x[..., 0], self.sample_rate, self.hop,
            start_bpm=self.start_bpm, std_bpm=self.std_bpm,
            max_tempo=self.max_tempo, max_lag=self.max_lag,
            ac_seconds=self.ac_seconds, pre=self.pre, post=self.post,
            delta=self.delta, warmup_seconds=self.warmup_seconds,
        )
        return jnp.stack([beat.astype(x.dtype), bpm.astype(x.dtype)], axis=-1)

    def latency(self, n_in):
        return self.post

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return ops.online_beat_init(self._plan(), lead_shape, dtype)

    def step(self, carry, chunk, first_index=None):
        env = chunk[..., 0]
        carry, (beat, bpm) = ops.online_beat_step(
            self._plan(), carry, env,
            0 if first_index is None else first_index,
        )
        out = jnp.stack([beat.astype(chunk.dtype), bpm.astype(chunk.dtype)], axis=-1)
        return carry, out


@register_node
@dataclass(frozen=True)
class OnlinePyin(Node):
    """Streaming pYIN: samples -> per-frame [f0_hz, voiced_flag,
    voiced_prob] ``[..., F, 3]`` via FIXED-LAG Viterbi smoothing
    (ops/pitch.py::online_pyin_step) — the causal counterpart of
    :class:`Pyin`'s whole-sequence decode (the rhythm family's
    :class:`OnlineBeats` precedent). Carry = hop-aligned frame overlap +
    forward max-plus messages + a ``lag``-deep backpointer/aux ring;
    latency = overlap frames + ``lag`` decode delay. Streamed == offline
    exactly at that whole-unit shift; agreement with the offline Viterbi
    outside the lag window on steady-pitch material is tested in
    tests/test_pitch.py."""

    fmin: float = 65.0
    fmax: float = 2093.0
    frame_length: int = 2048
    hop: int = 256
    lag: int = 25
    resolution: float = 0.1
    n_thresholds: int = 100
    sample_rate: int | None = None
    impl: str = "auto"
    precision: str | None = None

    domain_out = "frames"
    streamable = True

    def _plan(self):
        if self.sample_rate is None:
            raise AudioError(
                "OnlinePyin.sample_rate unresolved; set input_rate on the graph"
            )
        return ops.make_online_pyin_plan(
            self.sample_rate, self.fmin, self.fmax, self.frame_length,
            self.hop, self.lag, n_thresholds=self.n_thresholds,
            resolution=self.resolution, impl=self.impl,
            precision=self.precision,
        )

    def _stack(self, out, dtype):
        f0, vf, vp = out
        return jnp.stack(
            [f0.astype(dtype), vf.astype(dtype), vp.astype(dtype)], axis=-1
        )

    def apply(self, x):
        f0vv = ops.pyin_online(
            x, self._plan().sample_rate, self.fmin, self.fmax,
            self.frame_length, self.hop, self.lag,
            n_thresholds=self.n_thresholds, resolution=self.resolution,
            impl=self.impl, precision=self.precision,
        )
        out = self._stack(f0vv, x.dtype)
        # realign: emission at stream frame t describes frame t - lag; the
        # offline form reports AT the described frame (OnlineBeats
        # convention), so streaming is the declared-latency shift of this.
        # The last `lag` frames repeat the final decode (never compared —
        # the streamed signal ends before them).
        tail = jnp.repeat(out[..., -1:, :], self.lag, axis=-2)
        return jnp.concatenate([out[..., self.lag:, :], tail], axis=-2)

    def chunk_multiple(self):
        return self.hop

    def out_len(self, n_in):
        return n_in // self.hop

    @property
    def _carry_len(self) -> int:
        return (-(-self.frame_length // self.hop) - 1) * self.hop

    def latency(self, n_in):
        return self._carry_len // self.hop + self.lag

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return {
            "buf": jnp.zeros((*lead_shape, self._carry_len), dtype),
            "state": ops.online_pyin_init(self._plan(), lead_shape, dtype),
        }

    def step(self, carry, chunk):
        from ..ops.framing import frame as _frame

        buf = jnp.concatenate([carry["buf"], chunk], axis=-1)
        fr = _frame(buf, self.frame_length, self.hop)
        state, out = ops.online_pyin_step(
            self._plan(), carry["state"], fr,
            skip_first=self._carry_len // self.hop,
        )
        return (
            {"buf": buf[..., buf.shape[-1] - self._carry_len:], "state": state},
            self._stack(out, chunk.dtype),
        )


@register_node
@dataclass(frozen=True)
class Icqt(Node):
    """Complex constant-Q coefficients ``[..., F, n_bins]`` (a
    ``Cqt(output="complex")`` at the SAME parameters) -> waveform
    (ops/cqt.py::icqt). ``method="auto"`` picks the painless diagonal dual
    for fine hops and the hybrid LS-dual + sinusoidal-model inverse past
    the painless cliff (the framework default hop 256 / 84 bins included).
    **Hybrid signal-model restriction**: past the cliff only PEAKY/tonal
    content reconstructs (>= ~35 dB bin-center tones) — broadband noise
    there comes back at ~-10 dB, a harmonic complex ~8 dB (full figures in
    the ops.icqt docstring). For broadband-faithful inversion use
    ``ops.cqt(..., multirate=True)`` + ``ops.icqt`` at the array API (the
    multirate transform's per-octave frame rates do not fit the
    fixed-grid node dataflow). Offline only: the hybrid's dual support
    spans ``nd/2`` samples each side, so there is no constant-latency
    streaming form."""

    hop: int = 256
    n_bins: int = 84
    fmin: float = ops.FMIN_C1
    bins_per_octave: int = 12
    window: str = "hann"
    filter_scale: float = 1.0
    center: bool = True
    method: str = "auto"
    precision: str | None = None
    sample_rate: int | None = None
    streamable = False

    domain_in = "frames"
    domain_out = "samples"

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError(
                "Icqt.sample_rate unresolved; set input_rate on the graph"
            )
        return ops.icqt(
            x, self.sample_rate, self.hop, self.n_bins, self.fmin,
            self.bins_per_octave, self.window, self.filter_scale,
            center=self.center, precision=self.precision, method=self.method,
        )

    def out_len(self, n_in):
        return (n_in - 1) * self.hop


@register_node
@dataclass(frozen=True)
class CqtRoundTripMultirate(Node):
    """samples -> multirate CQT -> exact inverse -> samples in ONE node
    (ops/cqt.py::cqt_multirate + icqt_multirate — the broadband-invertible
    variant; per-octave painless hops, >= ~40 dB worst-case round trip at
    the default config vs the hybrid's tone-only reconstruction). The
    per-octave coefficient pytree stays INTERNAL to the node: its octaves
    carry different frame rates, which do not fit the graph's fixed-grid
    frames dataflow — this node is the Graph/CLI surface for the
    invertible transform (`audioflow run -g cqtroundtrip --multirate`).
    Offline only (the joint dual support spans nd/2 samples each side)."""

    hop: int = 256
    n_bins: int = 84
    fmin: float = ops.FMIN_C1
    bins_per_octave: int = 12
    window: str = "hann"
    filter_scale: float = 1.0
    precision: str | None = None
    sample_rate: int | None = None
    streamable = False

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError(
                "CqtRoundTripMultirate.sample_rate unresolved; set "
                "input_rate on the graph"
            )
        c = ops.cqt_multirate(
            x, self.sample_rate, self.hop, self.n_bins, self.fmin,
            self.bins_per_octave, self.window, self.filter_scale,
            precision=self.precision,
        )
        return ops.icqt_multirate(c, length=x.shape[-1], precision=self.precision)


@register_node
@dataclass(frozen=True)
class GriffinLim(Node):
    """Magnitude frames -> waveform via fast Griffin-Lim (iterative
    ISTFT/STFT projections, ops/griffinlim.py). Whole-signal iterative —
    offline only."""

    n_fft: int = 1024
    hop: int = 256
    window: str = "hann"
    n_iter: int = 32
    momentum: float = 0.99
    center: bool = True
    impl: str = "matmul"
    streamable = False

    domain_in = "frames"
    domain_out = "samples"

    def apply(self, x):
        return ops.griffin_lim(
            x, self.n_fft, self.hop, self.window, self.n_iter, self.momentum,
            center=self.center, impl=self.impl,
        )

    def out_len(self, n_in):
        return n_in * self.hop


@register_node
@dataclass(frozen=True)
class Fir(Node):
    """Causal FIR filter (ops/fir.py): designed windowed-sinc
    (kind/num_taps/cutoff) or explicit ``taps``. Prehistory carry makes
    streaming exact with zero latency; long kernels (convolution reverb)
    route through FFT fast convolution automatically."""

    kind: str = "lowpass"
    num_taps: int = 101
    cutoff: tuple = (4000.0,)
    window: str = "hamming"
    taps: tuple | None = None  # explicit taps override the design
    sample_rate: int | None = None

    def _h(self):
        if self.taps is not None:
            return np.asarray(self.taps, np.float32)
        if self.sample_rate is None:
            raise AudioError("Fir.sample_rate unresolved; set input_rate on the graph")
        cut = self.cutoff if len(self.cutoff) > 1 else self.cutoff[0]
        return ops.fir_design(
            self.num_taps, cut, self.sample_rate, self.kind, self.window
        ).astype(np.float32)

    def apply(self, x):
        y, _ = ops.fir_apply(x, jnp.asarray(self._h()))
        return y

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return jnp.zeros((*lead_shape, len(self._h()) - 1), dtype)

    def step(self, carry, chunk):
        y, zf = ops.fir_apply(chunk, jnp.asarray(self._h()), zi=carry)
        return zf, y


@register_node
@dataclass(frozen=True)
class Yin(Node):
    """YIN pitch tracker: samples -> per-frame [f0_hz, aperiodicity]
    ``[..., F, 2]`` (ops/pitch.py). Streaming mirrors Stft's hop-aligned
    overlap carry (center=False), so streamed == offline exactly.

    Sharding note: ``impl`` follows ops/pitch.py — "auto" runs the FFT ACF,
    the form GSPMD all-gathers under batch sharding (asserted in tests);
    the matmul ACF batch-shards with zero collectives, like every
    matmul-DFT node. Force ``impl="matmul"`` on shard-sensitive paths."""

    fmin: float = 65.0
    fmax: float = 2093.0
    frame_length: int = 2048
    hop: int = 256
    threshold: float = 0.1
    center: bool = True
    sample_rate: int | None = None
    impl: str = "auto"
    precision: str | None = None

    domain_out = "frames"

    def _rate(self):
        if self.sample_rate is None:
            raise AudioError("Yin.sample_rate unresolved; set input_rate on the graph")
        return self.sample_rate

    def apply(self, x):
        f0, ap = ops.yin_voicing(
            x, self._rate(), self.fmin, self.fmax, self.frame_length,
            self.hop, self.threshold, self.center, self.impl, self.precision,
        )
        return jnp.stack([f0, ap], axis=-1)

    def chunk_multiple(self):
        return self.hop

    @property
    def streamable(self):  # center-padding needs the whole signal
        return not self.center

    def validate_chunk(self, n_in):
        super().validate_chunk(n_in)
        if self.center:
            raise AudioError(
                "Yin: streaming requires center=False",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def out_len(self, n_in):
        return n_in // self.hop

    @property
    def _carry_len(self) -> int:
        return (-(-self.frame_length // self.hop) - 1) * self.hop

    def latency(self, n_in):
        return self._carry_len // self.hop

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return jnp.zeros((*lead_shape, self._carry_len), dtype)

    def step(self, carry, chunk):
        buf = jnp.concatenate([carry, chunk], axis=-1)
        f0, ap = ops.yin_voicing(
            buf, self._rate(), self.fmin, self.fmax, self.frame_length,
            self.hop, self.threshold, False, self.impl, self.precision,
        )
        out = jnp.stack([f0, ap], axis=-1)
        return buf[..., buf.shape[-1] - self._carry_len :], out


@register_node
@dataclass(frozen=True)
class Pyin(Node):
    """pYIN probabilistic pitch tracker: samples -> per-frame
    ``[f0_hz, voiced_flag, voiced_prob]`` stacked ``[..., F, 3]``
    (ops/pitch.py::pyin; voiced_flag is 0.0/1.0 so the node output stays one
    float tensor). The HMM Viterbi smoothing is a whole-sequence decode with
    unbounded lookback, so the node is offline-only by design (the same
    argument as Deltas order 2 — no constant-latency streaming form)."""

    fmin: float = 65.0
    fmax: float = 2093.0
    frame_length: int = 2048
    hop: int = 256
    center: bool = True
    resolution: float = 0.1
    switch_prob: float = 0.01
    sample_rate: int | None = None
    impl: str = "auto"
    precision: str | None = None
    streamable = False

    domain_out = "frames"

    def _rate(self):
        if self.sample_rate is None:
            raise AudioError("Pyin.sample_rate unresolved; set input_rate on the graph")
        return self.sample_rate

    def apply(self, x):
        f0, voiced, vprob = ops.pyin(
            x, self._rate(), self.fmin, self.fmax, self.frame_length,
            self.hop, self.center, resolution=self.resolution,
            switch_prob=self.switch_prob, impl=self.impl,
            precision=self.precision,
        )
        return jnp.stack([f0, voiced.astype(f0.dtype), vprob], axis=-1)

    def out_len(self, n_in):
        if self.center:
            n_in = n_in + 2 * (self.frame_length // 2)
        return (n_in - self.frame_length) // self.hop + 1


@register_node
@dataclass(frozen=True)
class Hpss(Node):
    """Harmonic/percussive separation (ops/decompose.py); emits the chosen
    component. Median filtering spans the whole time axis — offline only."""

    component: str = "harmonic"  # or "percussive"
    n_fft: int = 1024
    hop: int = 256
    kernel_time: int = 17
    kernel_freq: int = 17
    margin: float = 1.0
    streamable = False

    def __post_init__(self):
        if self.component not in ("harmonic", "percussive"):
            raise AudioError(
                f"Hpss.component must be 'harmonic' or 'percussive', got {self.component!r}",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def apply(self, x):
        y_h, y_p = ops.hpss(
            x, self.n_fft, self.hop, kernel_time=self.kernel_time,
            kernel_freq=self.kernel_freq, margin=self.margin,
        )
        return y_h if self.component == "harmonic" else y_p


@register_node
@dataclass(frozen=True)
class SpectralGate(Node):
    """Stationary-noise spectral gating denoiser (ops/decompose.py). The
    noise profile comes from the signal's own quietest frames — a whole-
    signal statistic, so offline only."""

    n_fft: int = 1024
    hop: int = 256
    n_std: float = 1.5
    prop_decrease: float = 1.0
    quantile: float = 0.1
    streamable = False

    def apply(self, x):
        return ops.spectral_gate(
            x, self.n_fft, self.hop, n_std=self.n_std,
            prop_decrease=self.prop_decrease, quantile=self.quantile,
        )


@register_node
@dataclass(frozen=True)
class Pcen(Node):
    """Per-channel energy normalization of mel/linear energies (frames
    domain). The offline warm start (M[0] = E[0]) is position-dependent, so
    streaming uses ``wants_first_index`` to reseed M at the stream's offline
    frame 0 — exactly like Preemphasis' edge convention. Streaming needs
    ``n_bins`` (the feature width, e.g. n_mels) to size the M carry;
    without it the node is offline-only."""

    smooth: float = 0.025
    alpha: float = 0.98
    delta: float = 2.0
    r: float = 0.5
    eps: float = 1e-6
    n_bins: int | None = None
    domain_in = "frames"
    domain_out = "frames"
    wants_first_index = True

    @property
    def streamable(self):
        return self.n_bins is not None

    def apply(self, x):
        return ops.pcen(x, self.smooth, self.alpha, self.delta, self.r, self.eps)

    def validate_chunk(self, n_in):
        super().validate_chunk(n_in)
        if self.n_bins is None:
            raise AudioError(
                "Pcen: streaming needs n_bins (the feature width) to size the"
                " smoother carry",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return jnp.zeros((*lead_shape, self.n_bins), dtype)

    def step(self, carry, chunk, first_index=None):
        from ..ops.features import pcen_smoother

        m, m_last = pcen_smoother(chunk, self.smooth, m_prev=carry, first_index=first_index)
        out = (chunk / (self.eps + m) ** self.alpha + self.delta) ** self.r - self.delta**self.r
        return m_last, out


@register_node
@dataclass(frozen=True)
class Deltas(Node):
    """Append regression deltas to features: [static, d, dd, ...] along the
    feature axis (ops/features.py::add_deltas).

    Streaming (orders=(1,) with ``n_bins`` set): the regression window reads
    width//2 future frames, so the node declares that latency and carries
    the last width-1 raw frames; the offline edge-replication at the
    stream's frame 0 is reproduced by clipping window indices at the
    ``wants_first_index`` position. Higher orders replicate the
    INTERMEDIATE delta sequence's edges offline, which has no
    constant-latency streaming form — offline only."""

    width: int = 9
    orders: tuple = (1, 2)
    n_bins: int | None = None
    domain_in = "frames"
    domain_out = "frames"
    wants_first_index = True

    @property
    def streamable(self):
        return tuple(self.orders) == (1,) and self.n_bins is not None

    def apply(self, x):
        return ops.add_deltas(x, self.width, tuple(self.orders))

    def validate_chunk(self, n_in):
        super().validate_chunk(n_in)
        if not self.streamable:
            raise AudioError(
                "Deltas: streaming needs orders=(1,) and n_bins set "
                "(higher orders edge-replicate the intermediate delta "
                "sequence, which has no constant-latency streaming form)",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def latency(self, n_in):
        return self.width // 2

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return jnp.zeros((*lead_shape, self.width - 1, self.n_bins), dtype)

    def step(self, carry, chunk, first_index=None):
        w = self.width
        n_side = w // 2
        buf = jnp.concatenate([carry, chunk], axis=-2)  # [.., w-1+m, nb]
        m = chunk.shape[-2]
        idx = jnp.arange(m)[:, None] + jnp.arange(w)[None, :]  # window j -> buf[j..j+w-1]
        if first_index is not None:
            # offline edge replication: frames before the stream's frame 0
            # (buf coordinate first_index + w - 1) read that frame instead
            idx = jnp.maximum(idx, first_index + w - 1)
        idx = jnp.minimum(idx, buf.shape[-2] - 1)
        flat = jnp.take(buf, idx.reshape(-1), axis=-2)  # [.., m*w, nb]
        win = flat.reshape(*buf.shape[:-2], m, w, buf.shape[-1])
        n = n_side
        taps = np.arange(-n, n + 1, dtype=np.float64)
        taps = taps / (2.0 * np.sum(np.arange(1, n + 1, dtype=np.float64) ** 2))
        t = jnp.asarray(taps.astype(np.float32))
        d1 = (win * t[:, None]).sum(axis=-2)
        static = win[..., n_side, :]  # the center frame, latency-aligned
        return buf[..., m:, :], jnp.concatenate([static, d1], axis=-1)


@register_node
@dataclass(frozen=True)
class VadGate(Node):
    """Mute non-speech audio: the device-side analog of the reference's
    VAD-gated egress (only speech is streamed to the ASR service, SURVEY
    §3.3). Frames whose VAD state is Speech (or Ending) pass; silence is
    zeroed. Emits samples, unlike :class:`Vad` which emits states."""

    frame_len: int = 320
    threshold_db: float = -50.0
    smoothing_factor: float = 0.3
    silence_timeout_frames: int = 15
    min_speech_frames: int = 3
    keep_ending: bool = True
    level: str = ""  # named preset, see Vad.level

    def __post_init__(self):
        _resolve_vad_level(self)

    def _cfg(self):
        return _vad.VadConfig(
            self.threshold_db,
            self.smoothing_factor,
            self.silence_timeout_frames,
            self.min_speech_frames,
        )

    def chunk_multiple(self):
        return self.frame_len

    def _gate(self, x, states):
        keep = states == _vad.SPEECH
        if self.keep_ending:
            keep = keep | (states == _vad.ENDING)
        frames = x[..., : states.shape[-1] * self.frame_len].reshape(
            *x.shape[:-1], states.shape[-1], self.frame_len
        )
        gated = frames * keep[..., None].astype(x.dtype)
        return gated.reshape(*x.shape[:-1], states.shape[-1] * self.frame_len)

    def apply(self, x):
        n = x.shape[-1] // self.frame_len
        frames = x[..., : n * self.frame_len].reshape(*x.shape[:-1], n, self.frame_len)
        _, states = _vad.vad_scan(frames, self._cfg())
        return self._gate(x, states)

    def out_len(self, n_in):
        return n_in // self.frame_len * self.frame_len

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return _vad.vad_init(lead_shape, dtype)

    def step(self, carry, chunk):
        n = chunk.shape[-1] // self.frame_len
        frames = chunk[..., : n * self.frame_len].reshape(
            *chunk.shape[:-1], n, self.frame_len
        )
        carry, states = _vad.vad_scan(frames, self._cfg(), carry)
        return carry, self._gate(chunk, states)


@register_node
@dataclass(frozen=True)
class Istft(Node):
    """Inverse STFT (WOLA): complex frames -> samples.

    Streaming (requires center=False): a frame only contributes to samples at
    or after its start, so emitting hop samples per frame is causally
    complete with ZERO latency; the carry holds the pending overlap-add tail
    plus the matching window-square tail, making the emitted stream exactly
    equal to the offline ISTFT prefix (the final n_fft-hop tail stays
    unflushed, mirroring the reference's streaming semantics of never
    emitting partial-coverage samples).
    """

    n_fft: int = 1024
    hop: int = 256
    window: str = "hann"
    center: bool = True
    impl: str = "matmul"
    domain_in = "frames"
    domain_out = "samples"
    # WOLA identity-reconstruction is exact for ANY incoming frame stream;
    # the wsum ramp carry counts every frame, so zeroed warmup frames would
    # corrupt the normalization — consume the upstream preroll instead.
    warmup_passthrough = True

    @property
    def streamable(self):  # center-padding needs the whole signal
        return not self.center

    def apply(self, x):
        return ops.istft(
            x, self.n_fft, self.hop, window=self.window, center=self.center, impl=self.impl
        )

    # streaming: chunk unit is FRAMES in, hop*frames samples out
    def validate_chunk(self, n_in):
        if self.center:
            raise AudioError(
                "Istft: streaming requires center=False",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def out_len(self, n_in):
        return n_in * self.hop

    def _window(self):
        return jnp.asarray(ops.get_window(self.window, self.n_fft, periodic=True), jnp.float32)

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        tail = self.n_fft - self.hop
        return (
            jnp.zeros((*lead_shape, tail), jnp.float32),
            jnp.zeros((tail,), jnp.float32),
        )

    def step(self, carry, spec):
        from ..ops.framing import overlap_add
        from ..ops.stft import frames_from_spec

        ola_tail, wsum_tail = carry
        w = self._window()
        m = spec.shape[-2]
        frames = frames_from_spec(spec, self.n_fft, self.impl)
        y = overlap_add(frames * w, self.hop)
        ws = overlap_add(jnp.broadcast_to(w * w, (m, self.n_fft)), self.hop)
        tail = self.n_fft - self.hop
        y = y.at[..., :tail].add(ola_tail)
        ws = ws.at[:tail].add(wsum_tail)
        emit = y[..., : m * self.hop] / jnp.maximum(ws[: m * self.hop], 1e-11)
        return (y[..., m * self.hop :], ws[m * self.hop :]), emit


@register_node
@dataclass(frozen=True)
class PhaseVocoderStretch(Node):
    """Streaming phase-vocoder time stretch: complex frames -> complex frames.

    ``rate = rate_num/rate_den`` (> 1 speeds up). Streaming carries the
    previous analysis frame (for fractional interpolation across chunk
    boundaries) and the accumulated synthesis phase, so chunk outputs are
    phase-continuous. Unlike the other nodes, the streamed output is NOT
    bit-equal to the offline :func:`ops.phase_vocoder` — phase accumulation
    starts from the zero-prehistory preroll rather than the first real frame
    (a constant per-bin phase rotation; magnitudes match and resynthesis is
    click-free). Compose as Stft(center=False) -> PhaseVocoderStretch ->
    Istft(center=False) for streaming tempo change.
    """

    rate_num: int = 5
    rate_den: int = 4
    hop: int = 256
    n_fft: int = 1024

    domain_in = "frames"
    domain_out = "frames"
    # phase accumulation is seeded from the incoming stream's first frames
    # (see class docstring); zeroed warmup frames would re-seed it from a
    # degenerate zero-magnitude frame instead of the preroll
    warmup_passthrough = True

    def __post_init__(self):
        import math as _math

        if self.rate_num <= 0 or self.rate_den <= 0:
            raise AudioError("rate must be positive", code=ErrorCode.CONFIG_VALIDATION_ERROR)
        g = _math.gcd(self.rate_num, self.rate_den)
        object.__setattr__(self, "rate_num", self.rate_num // g)
        object.__setattr__(self, "rate_den", self.rate_den // g)

    def apply(self, x):
        return ops.phase_vocoder(x, self.rate_num / self.rate_den, self.hop, self.n_fft)

    # --- streaming geometry: m input frames -> m*den/num output frames
    def chunk_multiple(self):
        return self.rate_num

    def out_len(self, n_in):
        return n_in * self.rate_den // self.rate_num

    def latency(self, n_in):
        # one-frame interpolation lookahead, expressed in output frames
        return -(-self.rate_den // self.rate_num)

    @property
    def _history(self) -> int:
        """Carried analysis frames: enough that delayed outputs never read
        before the buffer start (s_rel >= 0 for the first output)."""
        p, q = self.rate_num, self.rate_den
        n0 = -(-q // p)
        return max(1, -(-(n0 * p) // q))

    def _plan(self, m):
        """Static gather plan: buffer = [h history frames] + m new frames;
        output u (local) is global j = k*mo + u - n0, analyzing
        s_rel = (u - n0)*p/q + h relative to the buffer start."""
        import numpy as np_

        p, q = self.rate_num, self.rate_den
        mo = m * q // p
        n0 = -(-q // p)
        h = self._history
        u = np_.arange(mo)
        s_rel = (u - n0) * p / q + h
        lo = np_.floor(s_rel).astype(np_.int64)
        frac = (s_rel - lo).astype(np_.float32)
        if lo.min() < 0 or lo.max() + 1 > m + h - 1:
            # gather would silently clamp out-of-range indices into wrong
            # (time-smeared) audio — fail loudly instead
            raise AudioError(
                f"phase-vocoder plan out of bounds: lo in [{lo.min()}, {lo.max()}], "
                f"buffer m+h = {m + h}",
                code=ErrorCode.SHAPE_MISMATCH,
            )
        return mo, lo, lo + 1, frac

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        n_bins = self.n_fft // 2 + 1
        return (
            jnp.zeros((*lead_shape, self._history, n_bins), jnp.complex64),
            jnp.ones((*lead_shape, n_bins), jnp.complex64),  # accumulated phase phasor
        )

    def step(self, carry, spec):
        # same phasor math as the offline vocoder (shared helpers keep the
        # documented magnitude/phase parity between apply() and step()):
        # exp(i*increment) == s_hi*conj(s_lo)/(|s_hi||s_lo|), accumulation is
        # a cumulative complex product — zero trig on the hot path
        from ..ops.phase_vocoder import cumulative_phasor, increment_phasors

        prev, acc = carry
        m = spec.shape[-2]
        mo, lo, hi, frac = self._plan(m)
        buf = jnp.concatenate([prev, spec], axis=-2)  # [.., h+m, bins]
        mag_in = jnp.abs(buf)
        s_lo, s_hi = buf[..., lo, :], buf[..., hi, :]
        m_lo, m_hi = mag_in[..., lo, :], mag_in[..., hi, :]
        fr = jnp.asarray(frac)[..., None]
        mag = (1.0 - fr) * m_lo + fr * m_hi
        u = increment_phasors(s_lo, s_hi, m_lo, m_hi)  # [.., mo, bins]
        z = acc[..., None, :] * cumulative_phasor(u, axis=-2)
        out = mag * z
        # renormalize the carried phasor so |acc| cannot drift over
        # arbitrarily long streams (each chunk multiplies ~mo unit values)
        last = z[..., -1, :]
        last_mag = jnp.abs(last)
        ok = last_mag > 0
        last = jnp.where(ok, last / jnp.where(ok, last_mag, 1.0), 1.0 + 0.0j)
        new_carry = (buf[..., -self._history :, :], last)
        return new_carry, out


_MIX_COMBINES = ("sum", "mean", "product", "max", "min")


@register_node
@dataclass(frozen=True)
class Mix(Node):
    """Multi-branch combine: run each branch sub-chain on the SAME input and
    merge the outputs elementwise — the in-chain fork the reference's
    pipeline implies (VAD result both gates audio and feeds the level meter,
    SURVEY §3.3; dry/wet and multiband patterns generally). The whole fork
    still traces into ONE XLA program.

    ``branches`` is a tuple of node tuples. All branches must end in the
    same domain with identical output lengths and rates. ``weights`` scales
    each branch before combining (dry/wet mixing); None = unweighted.

    Streaming: each branch keeps its own carry chain; branches with smaller
    intrinsic latency are delayed (zero-filled pending buffers) up to the
    slowest branch, so the streamed mix equals the offline mix shifted by
    one whole-unit latency — the graph invariant, kept exactly.
    """

    branches: tuple = ()
    combine: str = "sum"
    weights: tuple | None = None

    domain_in = "samples"
    domain_out = "samples"

    def __post_init__(self):
        if len(self.branches) < 2:
            raise AudioError(
                "Mix needs at least 2 branches", code=ErrorCode.CONFIG_VALIDATION_ERROR
            )
        if self.combine not in _MIX_COMBINES:
            raise AudioError(
                f"unknown combine {self.combine!r}; known: {_MIX_COMBINES}",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )
        if self.weights is not None and len(self.weights) != len(self.branches):
            raise AudioError(
                f"weights ({len(self.weights)}) != branches ({len(self.branches)})",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )
        object.__setattr__(self, "branches", tuple(tuple(b) for b in self.branches))

    # --- graph construction -------------------------------------------------
    def _graphs(self):
        gs = getattr(self, "_bound_graphs", None)
        if gs is None:
            gs = self._build(None)
        return gs

    def _build(self, rate):
        from .graph import Graph

        gs = tuple(Graph(b, input_rate=rate, name=f"mix_branch_{i}")
                   for i, b in enumerate(self.branches))
        d0 = gs[0].nodes[-1].domain_out
        for g in gs[1:]:
            if g.nodes[-1].domain_out != d0:
                raise AudioError(
                    f"Mix branches end in different domains: "
                    f"{[g.nodes[-1].domain_out for g in gs]}",
                    code=ErrorCode.CONFIG_VALIDATION_ERROR,
                )
            if g.output_rate != gs[0].output_rate:
                raise AudioError(
                    f"Mix branches end at different rates: "
                    f"{[g.output_rate for g in gs]}",
                    code=ErrorCode.CONFIG_VALIDATION_ERROR,
                )
        m = self.chunk_multiple_of(gs)
        lens = {g_.chunk_lens(m)[-1] for g_ in gs}
        if len(lens) != 1:
            raise AudioError(
                f"Mix branches disagree on output length for chunk {m}: {lens}",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )
        object.__setattr__(self, "_bound_graphs", gs)
        object.__setattr__(self, "domain_out", gs[0].nodes[-1].domain_out)
        return gs

    def bind(self, rate_in):
        new = dataclasses.replace(self)
        new._build(rate_in)
        return new

    def rate_out(self, rate_in):
        return self._graphs()[0].output_rate

    @property
    def streamable(self):
        return all(g.streamable for g in self._graphs())

    # --- offline -------------------------------------------------------------
    def _merge(self, outs):
        if self.weights is not None:
            outs = [w * o for w, o in zip(self.weights, outs)]
        if self.combine == "sum":
            y = outs[0]
            for o in outs[1:]:
                y = y + o
            return y
        if self.combine == "mean":
            y = outs[0]
            for o in outs[1:]:
                y = y + o
            return y / len(outs)
        if self.combine == "product":
            y = outs[0]
            for o in outs[1:]:
                y = y * o
            return y
        fn = jnp.maximum if self.combine == "max" else jnp.minimum
        y = outs[0]
        for o in outs[1:]:
            y = fn(y, o)
        return y

    def apply(self, x):
        return self._merge([g.chain(x) for g in self._graphs()])

    # --- streaming -------------------------------------------------------------
    def chunk_multiple_of(self, gs):
        import math as _math

        m = 1
        for g in gs:
            m = _math.lcm(m, g.chunk_granularity())
        return m

    def chunk_multiple(self):
        return self.chunk_multiple_of(self._graphs())

    def out_len(self, n_in):
        return self._graphs()[0].chunk_lens(n_in)[-1]

    def latency(self, n_in):
        return max(g.stream_latency(n_in) for g in self._graphs())

    def _stream_axis(self):
        return -2 if self.domain_out == "frames" else -1

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        gs = self._graphs()
        lat = self.latency(n_in)
        states, pads = [], []
        for g in gs:
            states.append(g.init_state(n_in, lead_shape, dtype))
            need = lat - g.stream_latency(n_in)
            if need == 0:
                pads.append(None)
                continue
            import jax as _jax

            spec = _jax.eval_shape(
                lambda c, ch, g=g: g.stream_step(c, ch)[1],
                states[-1], jnp.zeros((*lead_shape, n_in), dtype),
            )
            shape = list(spec.shape)
            shape[self._stream_axis() % len(shape)] = need
            pads.append(jnp.zeros(shape, spec.dtype))
        return tuple(states), tuple(pads)

    def step(self, carry, chunk):
        import jax as _jax

        states, pads = carry
        new_states, new_pads, outs = [], [], []
        axis_hint = self._stream_axis()
        for g, st, pend in zip(self._graphs(), states, pads):
            st, y = g.stream_step(st, chunk)
            if pend is not None:
                axis = axis_hint % y.ndim
                n_out = y.shape[axis]
                buf = jnp.concatenate([pend, y], axis=axis)
                y = _jax.lax.slice_in_dim(buf, 0, n_out, axis=axis)
                pend = _jax.lax.slice_in_dim(buf, n_out, buf.shape[axis], axis=axis)
            new_states.append(st)
            new_pads.append(pend)
            outs.append(y)
        return (tuple(new_states), tuple(new_pads)), self._merge(outs)


@register_node
@dataclass(frozen=True)
class Delay(Node):
    """Feedback delay / echo (ops/effects.py::feedback_delay). The comb
    recurrence runs as a lax.scan over D-sample blocks; streaming carries
    the last D samples of input + wet line, so streamed == offline exactly
    at any chunk size."""

    delay_s: float = 0.25
    feedback: float = 0.4
    mix: float = 0.5
    sample_rate: int | None = None

    def _d(self):
        if self.sample_rate is None:
            raise AudioError("Delay.sample_rate unresolved; set input_rate on the graph")
        d = int(round(self.delay_s * self.sample_rate))
        if d < 1:
            raise AudioError(
                f"Delay: delay_s {self.delay_s} is under one sample at "
                f"{self.sample_rate} Hz",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )
        return d

    def apply(self, x):
        y, _ = ops.feedback_delay(x, self._d(), self.feedback, self.mix)
        return y

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        d = self._d()
        return (jnp.zeros((*lead_shape, d), dtype), jnp.zeros((*lead_shape, d), dtype))

    def step(self, carry, chunk):
        y, carry = ops.feedback_delay(chunk, self._d(), self.feedback, self.mix, carry)
        return carry, y


@register_node
@dataclass(frozen=True)
class Tremolo(Node):
    """Amplitude LFO (ops/effects.py::tremolo). The gain depends on the
    absolute sample position, so the node opts into ``wants_first_index``
    and streaming chunks reproduce the offline LFO phase exactly."""

    rate_hz: float = 5.0
    depth: float = 0.5
    phase: float = 0.0
    sample_rate: int | None = None
    wants_first_index = True

    def _rate(self):
        if self.sample_rate is None:
            raise AudioError("Tremolo.sample_rate unresolved; set input_rate on the graph")
        return self.sample_rate

    def apply(self, x):
        return ops.tremolo(x, self._rate(), self.rate_hz, self.depth, self.phase)

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return None

    def step(self, carry, chunk, first_index=None):
        t0 = 0 if first_index is None else -first_index
        return carry, ops.tremolo(
            chunk, self._rate(), self.rate_hz, self.depth, self.phase, t0
        )


@dataclass(frozen=True)
class _ModTapNode(Node):
    """Shared machinery for LFO-modulated-delay effects: carry = the last
    Dmax input samples (offline zeros prehistory), absolute position via
    ``first_index``.

    Streaming note: the decode math is identical streamed and offline, but
    interpolation weights are recomputed from a chunk-local index origin, so
    streamed output agrees with offline to f32 rounding (~1e-3 atol on
    unit-scale audio) rather than bit-for-bit — the one documented
    exception to the bitwise streamed==offline rule (tests pin it)."""

    sample_rate: int | None = None
    wants_first_index = True

    def _rate(self):
        if self.sample_rate is None:
            raise AudioError(
                f"{type(self).__name__}.sample_rate unresolved; set input_rate on the graph"
            )
        return self.sample_rate

    def _dmax(self):
        import numpy as _np

        return int(_np.ceil((self._base() + self._depth()) * self._rate())) + 1

    def _base(self):
        return 0.0

    def _depth(self):
        return self.depth_s  # type: ignore[attr-defined]

    def _apply_tap(self, x, t0, history):
        raise NotImplementedError

    def apply(self, x):
        return self._apply_tap(x, 0, None)

    def init_carry(self, lead_shape, n_in, dtype=jnp.float32):
        return jnp.zeros((*lead_shape, self._dmax()), dtype)

    def step(self, carry, chunk, first_index=None):
        t0 = 0 if first_index is None else -first_index
        y = self._apply_tap(chunk, t0, carry)
        new = jnp.concatenate([carry, chunk], axis=-1)[..., -self._dmax():]
        return new, y


@register_node
@dataclass(frozen=True)
class Vibrato(_ModTapNode):
    """Pitch LFO (ops/effects.py::vibrato)."""

    rate_hz: float = 5.0
    depth_s: float = 0.002
    phase: float = 0.0

    def _apply_tap(self, x, t0, history):
        return ops.vibrato(
            x, self._rate(), self.rate_hz, self.depth_s, self.phase, t0, history
        )


@register_node
@dataclass(frozen=True)
class Chorus(_ModTapNode):
    """Multi-voice ensemble (ops/effects.py::chorus)."""

    rate_hz: float = 0.8
    depth_s: float = 0.003
    base_delay_s: float = 0.02
    voices: int = 3
    mix: float = 0.5

    def _base(self):
        return self.base_delay_s

    def _apply_tap(self, x, t0, history):
        return ops.chorus(
            x, self._rate(), self.rate_hz, self.depth_s, self.base_delay_s,
            self.voices, self.mix, t0, history,
        )


@register_node
@dataclass(frozen=True)
class Flanger(_ModTapNode):
    """Swept comb (ops/effects.py::flanger)."""

    rate_hz: float = 0.25
    depth_s: float = 0.002
    base_delay_s: float = 0.001
    mix: float = 0.5

    def _base(self):
        return self.base_delay_s

    def _apply_tap(self, x, t0, history):
        return ops.flanger(
            x, self._rate(), self.rate_hz, self.depth_s, self.base_delay_s,
            self.mix, t0, history,
        )
