"""Streaming session driver: open -> push -> poll -> flush/close.

The on-device re-design of the reference's session layer
(network/scribe_client.rs:98-405): `ScribeClient` opens a socket, pushes
PCM chunks, and polls typed transcript events with partial/committed
semantics. Here the "service" is the jitted streaming graph on the device:

* ``push(samples)`` lands irregular host pushes in a **device-resident
  staging accumulator** (:class:`audioflow_tpu.ops.ring.Staging` — the
  linear form of the reference's capture ring, capture.rs:83-161; the
  wrap-around :class:`~audioflow_tpu.ops.ring.Ring` is the parity
  component, whose circular addressing costs more per write, see
  ops/ring.py) and processes every full
  chunk — the accumulate-and-chunk semantics of BatchResampler::process
  (resampler.rs:132-147). The chunk count is tracked host-side, so the whole
  push path is asynchronous dispatch: no readback, no host concatenation;
* each processed chunk yields a **partial** :class:`Result` (the
  PartialTranscript analog) whose ``data`` materializes to host **lazily**
  (on first access / sink write), so a push loop with no eager consumer runs
  at device speed instead of device+host serial; ``flush()`` zero-pads the
  tail (resampler.rs:150-166 — the ring read's zero padding is exactly the
  flush semantics) and yields the **committed** final result;
* ``poll()``/``poll_all()`` drain the result queue (try_receive analog,
  scribe_client.rs:235-245);
* ``snapshot()``/``restore()`` persist the carry pytree — the resumable
  session state the reference only kept in memory (SURVEY §5.4).

Lifecycle states mirror ConnectionState (websocket.rs:19-53).
"""

from __future__ import annotations

import enum
import queue
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from ..errors import ErrorCode, SessionError
from ..graph import Graph
from ..obs import StatsFile, get_logger
from ..sinks import EventDispatcher, Sink

_log = get_logger("session")


class SessionState(enum.Enum):
    IDLE = "idle"
    OPEN = "open"
    CLOSED = "closed"
    FAILED = "failed"


class _Stacked:
    """Shared lazy host view of one multi-chunk drain's scan output [b, ...].

    All ``b`` Results produced by a single multi-step dispatch point here, so
    the whole stacked output crosses the device->host boundary ONCE (first
    access by any of them) instead of once per chunk."""

    __slots__ = ("_raw", "_host")

    def __init__(self, raw):
        self._raw = raw
        self._host = None

    def fetch(self):
        if self._host is None:
            self._host = jax.tree_util.tree_map(np.asarray, self._raw)
            self._raw = None
        return self._host


class Result:
    """Per-chunk output (partial) or end-of-stream output (final).

    ``data`` materializes the device output to host lazily on first access,
    so producing results never blocks the push loop (device/host overlap;
    the offline runner's double-buffering analog for streaming)."""

    __slots__ = ("_raw", "_host", "_stacked", "_j", "final", "index", "timestamp")

    def __init__(
        self,
        data,
        final: bool,
        index: int,
        timestamp: float | None = None,
        _stacked: _Stacked | None = None,
        _j: int = 0,
    ):
        self._raw = data
        self._host: np.ndarray | None = None
        self._stacked = _stacked
        self._j = _j
        self.final = final
        self.index = index
        self.timestamp = time.time() if timestamp is None else timestamp

    @property
    def data(self) -> np.ndarray:
        if self._host is None:
            if self._stacked is not None:
                # one shared fetch for the whole drained block, numpy views per chunk
                self._host = jax.tree_util.tree_map(
                    lambda a: a[self._j], self._stacked.fetch()
                )
                self._stacked = None
            else:
                # tree_map handles both bare arrays and Fork's {name: array} dicts
                self._host = jax.tree_util.tree_map(np.asarray, self._raw)
                self._raw = None
        return self._host

    @property
    def materialized(self) -> bool:
        """True once the host copy exists (observable async-ness, for tests)."""
        return self._host is not None

    def __repr__(self):
        state = "host" if self.materialized else "device"
        return f"Result(index={self.index}, final={self.final}, {state})"


class StreamSession:
    """Single-stream (or fixed-lead-shape batch) streaming driver."""

    def __init__(
        self,
        graph: Graph,
        chunk_in: int | None = None,
        lead_shape: tuple = (),
        dtype=jnp.float32,
        sinks: Sequence[Sink] = (),
        events: EventDispatcher | None = None,
        emit_partials: bool = True,
        stats: StatsFile | None = None,
        ring_capacity: int | None = None,
    ):
        self.graph = graph
        gran = graph.chunk_granularity()
        if chunk_in is None:
            chunk_in = gran * max(1, 4096 // gran)
        if chunk_in % gran:
            raise SessionError(
                f"chunk_in {chunk_in} not a multiple of graph granularity {gran}",
                code=ErrorCode.SESSION_STATE_INVALID,
            )
        self.chunk_in = chunk_in
        # staging sizing: room for the residual (< chunk_in) + the largest
        # single push piece (the headroom); larger pushes are split
        self.ring_capacity = ring_capacity or (4 * chunk_in + 1)
        if self.ring_capacity < 2 * chunk_in + 1:
            raise SessionError(
                f"ring_capacity {self.ring_capacity} < 2*chunk_in+1",
                code=ErrorCode.SESSION_STATE_INVALID,
            )
        self.lead_shape = tuple(lead_shape)
        self.dtype = dtype
        self.sinks = list(sinks)
        self.events = events or EventDispatcher(enabled=False)
        self.emit_partials = emit_partials
        self.stats = stats

        self.state = SessionState.IDLE
        self._step = None
        self._carry: Any = None
        self._ring = None
        # multi-chunk drain: when >= 2 chunks sit in staging, they drain
        # through ONE jitted lax.scan multi-step (bucketed to bounded shapes)
        # — batching k chunks into one program amortizes the fixed cost of a
        # dispatch chain ~k-fold. Buckets are capped by what the staging
        # buffer can hold.
        self._multi: dict[int, Any] = {}
        self._drain_buckets = tuple(
            b for b in (8, 4, 2) if b * self.chunk_in <= self.ring_capacity
        )
        self._pending = 0  # unprocessed samples in the ring (host-tracked)
        self._results: queue.Queue[Result] = queue.Queue()
        self._chunk_index = 0
        self._samples_in = 0

    # ------------------------------------------------------------- lifecycle
    def open(self, precompile: str | bool = True) -> "StreamSession":
        """Open the session. ``precompile`` controls first-push latency:
        truthy (default) warms the per-chunk step program here — the same
        compile that would otherwise stall the FIRST ``push`` (net zero
        extra compilation, just moved off the live path); ``"all"``
        additionally compiles every multi-chunk drain-bucket program, for
        latency-critical streams that may buffer bursts."""
        if self.state is SessionState.OPEN:
            return self  # idempotent, like connect-on-connected
        if self.state is SessionState.CLOSED:
            raise SessionError("session closed", code=ErrorCode.SESSION_CLOSED)
        from ..ops import ring as _ring

        self._step = self.graph.compile_stream(donate=False)
        self._carry = self.graph.init_state(self.chunk_in, self.lead_shape, self.dtype)
        self._stage = _ring.staging_init(self.ring_capacity, self.lead_shape, self.dtype)
        self._pending = 0
        self._write = jax.jit(_ring.staging_push)
        self._take = jax.jit(_ring.staging_take, static_argnums=(1,))
        if precompile:
            # warm the jit caches with throwaway calls on the init carry and
            # staging buffer (all functional: the live state is untouched).
            # Covers the WHOLE first-push dispatch chain — step + the
            # staging write at the canonical chunk-cadence bucket shape +
            # the chunk take — not just the graph step (a first push that
            # still compiled the ring programs would stall on the compiles).
            z = jnp.zeros((*self.lead_shape, self.chunk_in), self.dtype)
            self._step(self._carry, z)
            headroom = self.ring_capacity - self.chunk_in
            m = min(self.chunk_in, headroom)
            bucket = min(headroom, max(256, 1 << (m - 1).bit_length()))
            zb = jnp.zeros((*self.lead_shape, bucket), self.dtype)
            self._write(self._stage, zb, m)
            self._take(self._stage, self.chunk_in)
            if precompile == "all":
                for b in self._drain_buckets:
                    zb = jnp.zeros(
                        (*self.lead_shape, b * self.chunk_in), self.dtype
                    )
                    self._multi_step(b)(self._carry, zb)
                    self._take(self._stage, b * self.chunk_in)
        self.state = SessionState.OPEN
        from .registry import REGISTRY

        REGISTRY.register(self)
        self.events.emit_session_state("open", chunk_in=self.chunk_in)
        return self

    def __enter__(self):
        return self.open()

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.state = SessionState.FAILED
            self.events.emit_session_state("failed")
        return False

    # ------------------------------------------------------------------ push
    def push(self, samples) -> int:
        """Feed PCM; processes every complete chunk. Returns chunks processed.

        The samples land in the device ring and full chunks are read out and
        stepped — all asynchronous dispatch (the chunk count is tracked
        host-side, so nothing reads back from the device here). Irregular
        push sizes are split/padded HOST-side to power-of-two bucket shapes
        before the device write: jit (and eager dispatch) compiles per
        shape, so without bucketing a ragged push stream recompiles the
        write path on every new length.
        """
        if self.state is not SessionState.OPEN:
            raise SessionError(
                f"push on {self.state.value} session", code=ErrorCode.SESSION_STATE_INVALID
            )
        arr = np.asarray(samples, np.float32)
        if arr.shape[:-1] != self.lead_shape:
            raise SessionError(
                f"lead shape {arr.shape[:-1]} != session lead {self.lead_shape}",
                code=ErrorCode.SHAPE_MISMATCH,
            )
        # chunk-cadence fast path: with nothing pending, staging write
        # followed by an immediate take of the same samples is an identity —
        # step the push directly. One device dispatch instead of three
        # (write/take/step), which sets the live path's latency floor. A push of
        # exactly one drain bucket takes the same shortcut through the
        # multi-chunk scan program.
        n = arr.shape[-1]
        if self._pending == 0 and n == self.chunk_in:
            self._samples_in += n
            self._process(jnp.asarray(arr, self.dtype), final=False)
            return 1
        if self._pending == 0 and (
            n % self.chunk_in == 0 and n // self.chunk_in in self._drain_buckets
        ):
            self._samples_in += n
            b = n // self.chunk_in
            self._process_multi(jnp.asarray(arr, self.dtype), b)
            return b
        # ring invariant: residual < chunk_in at every drain point, one slot
        # reserved -> headroom per write is capacity - chunk_in. Larger
        # pushes are split and interleaved with drains (overflow-free; the
        # reference's ring would partial-write instead, capture.rs:103-122,
        # but a file-batch API must never drop samples).
        headroom = self.ring_capacity - self.chunk_in
        done = 0
        for i in range(0, arr.shape[-1], headroom):
            piece = arr[..., i : i + headroom]
            m = piece.shape[-1]
            bucket = min(headroom, max(256, 1 << (m - 1).bit_length()))
            if bucket > m:
                widths = [(0, 0)] * (piece.ndim - 1) + [(0, bucket - m)]
                piece = np.pad(piece, widths)
            self._stage = self._write(self._stage, jnp.asarray(piece, self.dtype), m)
            self._pending += m
            self._samples_in += m
            while self._pending >= self.chunk_in:
                k = self._pending // self.chunk_in
                b = next((bb for bb in self._drain_buckets if bb <= k), 1)
                if b == 1:
                    self._stage, chunk, _ = self._take(self._stage, self.chunk_in)
                    self._pending -= self.chunk_in
                    self._process(chunk, final=False)
                else:
                    self._stage, flat, _ = self._take(self._stage, b * self.chunk_in)
                    self._pending -= b * self.chunk_in
                    self._process_multi(flat, b)
                done += b
        return done

    def _multi_step(self, b: int):
        """Jitted drain of ``b`` chunks in one program: lax.scan over the
        graph's stream_step (exactly :meth:`Graph.scan_stream`'s body, but
        starting from the live carry). Cached per bucket size."""
        fn = self._multi.get(b)
        if fn is None:
            step = self.graph.stream_step
            chunk = self.chunk_in

            def run(carry, flat):
                shape = flat.shape[:-1] + (b, chunk)
                chunks = jnp.moveaxis(flat.reshape(shape), -2, 0)
                return jax.lax.scan(step, carry, chunks)

            fn = self._multi[b] = jax.jit(run)
        return fn

    def _process_multi(self, flat: jnp.ndarray, b: int) -> None:
        self._carry, outs = self._multi_step(b)(self._carry, flat)
        stacked = _Stacked(outs)
        for j in range(b):
            res = Result(None, False, self._chunk_index, _stacked=stacked, _j=j)
            self._chunk_index += 1
            if self.emit_partials:
                self._results.put(res)
            for sink in self.sinks:
                sink.write(res.data)
            if self.events.enabled:
                chunk = flat[..., j * self.chunk_in : (j + 1) * self.chunk_in]
                rms = float(jnp.sqrt(jnp.mean(chunk**2)))
                peak = float(jnp.max(jnp.abs(chunk))) if chunk.size else 0.0
                self.events.emit_audio_level(rms=rms, peak=peak)
                self.events.emit_result(res.data, final=False, index=res.index)

    def _process(self, chunk: jnp.ndarray, final: bool) -> Result:
        self._carry, out = self._step(self._carry, chunk)
        res = Result(out, final, self._chunk_index)
        self._chunk_index += 1
        if self.emit_partials or final:
            self._results.put(res)
        for sink in self.sinks:
            sink.write(res.data)  # sinks need host data: materializes here
        if self.events.enabled:
            rms = float(jnp.sqrt(jnp.mean(chunk**2)))
            peak = float(jnp.max(jnp.abs(chunk))) if chunk.size else 0.0
            self.events.emit_audio_level(rms=rms, peak=peak)
            self.events.emit_result(res.data, final=final, index=res.index)
        return res

    # ------------------------------------------------------------------ poll
    def poll(self, timeout: float | None = 0.0) -> Result | None:
        """Next result or None (try_receive parity: non-blocking by default)."""
        try:
            return self._results.get(timeout=timeout) if timeout else self._results.get_nowait()
        except queue.Empty:
            return None

    def poll_all(self) -> list[Result]:
        out = []
        while True:
            r = self.poll()
            if r is None:
                return out
            out.append(r)

    # ----------------------------------------------------------------- flush
    def flush(self) -> Result | None:
        """Zero-pad and process the tail (flush parity), emitting the final
        committed result. No-op (returns None) if nothing is pending and at
        least one chunk was emitted. The ring read is already zero-padded to
        chunk_in — exactly BatchResampler::flush (resampler.rs:150-166)."""
        if self.state is not SessionState.OPEN:
            raise SessionError(
                f"flush on {self.state.value} session", code=ErrorCode.SESSION_STATE_INVALID
            )
        if self._pending == 0 and self._chunk_index > 0:
            return None
        self._stage, chunk, _ = self._take(self._stage, self.chunk_in)
        self._pending = 0
        return self._process(chunk, final=True)

    def close(self) -> dict:
        """Flush, close sinks, record stats. Returns a summary dict."""
        if self.state is SessionState.CLOSED:
            return {}
        if self.state is SessionState.OPEN and (
            self._pending > 0 or self._chunk_index == 0
        ):
            self.flush()
        for sink in self.sinks:
            sink.close()
        rate = self.graph.input_rate or 0
        audio_s = self._samples_in / rate if rate else 0.0
        if self.stats is not None:
            self.stats.record_run(audio_s)
            self.stats.save()
        self.state = SessionState.CLOSED
        from .registry import REGISTRY

        REGISTRY.unregister(self)
        self.events.emit_session_state("closed")
        _log.info("session closed: %d chunks, %.2f audio-s", self._chunk_index, audio_s)
        return {"chunks": self._chunk_index, "audio_seconds": audio_s}

    # ------------------------------------------------------------ checkpoint
    @staticmethod
    def _snapshot_path(path) -> Path:
        # np.savez appends .npz to other suffixes; normalize so snapshot and
        # restore always agree on the on-disk name
        p = Path(path)
        return p if p.suffix == ".npz" else p.with_name(p.name + ".npz")

    def snapshot(self, path: str) -> None:
        """Persist carry + pending ring samples + counters (SURVEY §5.4).

        The pending (not yet chunk-complete) samples are read out of the
        device staging buffer into the flat ``__buffer`` array, so the
        on-disk format is unchanged from the host-buffer era and restores
        anywhere."""
        leaves, treedef = jax.tree_util.tree_flatten(self._carry)
        arrays = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)}
        if self._pending:
            buffer = np.asarray(self._stage.buf)[..., : self._pending]
        else:
            buffer = np.zeros((*self.lead_shape, 0), np.float32)
        path = self._snapshot_path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            path,
            __buffer=buffer,
            __chunk_index=self._chunk_index,
            __samples_in=self._samples_in,
            **arrays,
        )

    def restore(self, path: str) -> "StreamSession":
        """Restore a snapshot into an OPEN session with identical graph/chunk."""
        self.open()
        data = np.load(self._snapshot_path(path), allow_pickle=False)
        leaves, treedef = jax.tree_util.tree_flatten(self._carry)
        restored = [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(leaves))]
        self._carry = jax.tree_util.tree_unflatten(treedef, restored)
        from ..ops import ring as _ring

        self._stage = _ring.staging_init(self.ring_capacity, self.lead_shape, self.dtype)
        self._pending = 0
        buffer = data["__buffer"]
        if buffer.shape[-1]:
            self._stage = self._write(self._stage, jnp.asarray(buffer, self.dtype), buffer.shape[-1])
            self._pending = int(buffer.shape[-1])
        self._chunk_index = int(data["__chunk_index"])
        self._samples_in = int(data["__samples_in"])
        return self


from .scribe import ScribeConfig, ScribeSession  # noqa: E402  (duplex ASR driver)
from .transcript import (  # noqa: E402
    ScribeEvent,
    ScribeEventKind,
    TranscriptAccumulator,
    parse_scribe_message,
)
