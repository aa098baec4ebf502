"""Golden-vector generator: serial port of rubato FastFixedIn's
accumulate/chunk semantics.

The reference wraps ``rubato::FastFixedIn::<f32>`` (cubic polynomial,
fixed 128-frame input chunks, resampler.rs:43-49) behind a
``BatchResampler`` that buffers arbitrary input, processes in exact
128-sample chunks (resampler.rs:132-147), and zero-pads the final partial
chunk on ``flush()`` (resampler.rs:150-166). SURVEY §7.3 #2 calls the
phase-accumulator/chunk-seam arithmetic the hard part; no Rust toolchain
exists in this environment (rubato itself cannot run), so this module is
an INDEPENDENT serial implementation of those semantics, written from the
documented behavior:

* a stateful stream: each ``process(chunk)`` call consumes exactly
  ``chunk_size`` new input samples and emits every output whose
  4-point cubic window is fully available, so the per-call output count
  VARIES (e.g. 42/43 at 48k->16k) and the leftover fractional position
  carries across the seam;
* the phase is a float64 accumulator ``idx += 1/ratio`` per output (NOT
  per-chunk re-anchored rational indexing) — chunk boundaries never touch
  it, which is exactly the seam property the fixtures pin down;
* sample arithmetic is float32 (``FastFixedIn<f32>``): the 4 input taps,
  the coerced fraction, and the Lagrange-cubic evaluation
  (rubato's interp_cubic polynomial — the same one
  ops/resample.py::cubic_lagrange_bank tabulates);
* ``flush()`` zero-pads the buffered remainder to a whole chunk and
  processes it.

Anchoring: output n sits at input position ``n / ratio`` with window
``[floor(pos)-1, floor(pos)+2]`` — the same grid as
ops/resample.py::cubic mode (offset -1), so the framework's streaming
output aligns with these vectors at its documented ``-n0`` latency with
no fractional offset. (rubato's private initial-state constant only
shifts the first emitted index by a whole number of outputs; the seam
arithmetic — what these fixtures exist to pin — is anchor-independent.)

Run from the repo root to (re)generate tests/golden/rubato_seams.npz:

    python tests/golden/gen_rubato_seams.py
"""

from __future__ import annotations

import numpy as np


def interp_cubic_f32(frac: np.float32, y: np.ndarray) -> np.float32:
    """rubato's cubic Lagrange through 4 uniform points, evaluated between
    the middle two, all arithmetic in f32 (FastFixedIn<f32>)."""
    y0, y1, y2, y3 = (np.float32(v) for v in y)
    f = np.float32(frac)
    third = np.float32(1.0 / 3.0)
    sixth = np.float32(1.0 / 6.0)
    half = np.float32(0.5)
    a0 = y1
    a1 = -third * y0 - half * y1 + y2 - sixth * y3
    a2 = half * (y0 + y2) - y1
    a3 = half * (y1 - y2) + sixth * (y3 - y0)
    return ((a3 * f + a2) * f + a1) * f + a0


class SerialFastFixedIn:
    """Stateful serial cubic resampler with FastFixedIn's chunk semantics.

    ``process(chunk)`` takes exactly ``chunk_size`` f32 samples and returns
    the f32 outputs whose windows are complete; the f64 phase accumulator
    and the 3-sample window history carry across calls.
    """

    def __init__(self, input_rate: int, output_rate: int, chunk_size: int = 128):
        self.t_ratio = float(input_rate) / float(output_rate)  # f64 step
        self.chunk_size = chunk_size
        self.idx = 0.0  # f64 position (input samples) of the NEXT output
        self.consumed = 0  # whole input samples consumed so far
        # history: input samples [consumed-3, consumed) for seam windows
        self.hist = np.zeros(3, np.float32)

    def process(self, chunk: np.ndarray) -> np.ndarray:
        assert chunk.shape == (self.chunk_size,), chunk.shape
        buf = np.concatenate([self.hist, chunk.astype(np.float32)])
        # buf[j] is input sample consumed - 3 + j
        base = self.consumed - 3
        avail_end = self.consumed + self.chunk_size  # exclusive
        out = []
        while True:
            q = int(np.floor(self.idx))
            if q + 2 >= avail_end:  # window [q-1, q+2] incomplete
                break
            frac = np.float32(self.idx - q)
            w = buf[q - 1 - base : q + 3 - base]
            out.append(interp_cubic_f32(frac, w))
            self.idx += self.t_ratio
        self.consumed = avail_end
        self.hist = buf[-3:].copy()
        return np.asarray(out, np.float32)


class SerialBatchResampler:
    """The reference's accumulate wrapper (resampler.rs:114-167): buffer
    arbitrary input, process whole 128-sample chunks, flush zero-pads."""

    def __init__(self, input_rate: int, output_rate: int, chunk_size: int = 128):
        self.inner = SerialFastFixedIn(input_rate, output_rate, chunk_size)
        self.buffer = np.zeros(0, np.float32)

    def process(self, x: np.ndarray) -> np.ndarray:
        self.buffer = np.concatenate([self.buffer, x.astype(np.float32)])
        cs = self.inner.chunk_size
        outs = []
        while len(self.buffer) >= cs:
            outs.append(self.inner.process(self.buffer[:cs]))
            self.buffer = self.buffer[cs:]
        return np.concatenate(outs) if outs else np.zeros(0, np.float32)

    def flush(self) -> np.ndarray:
        if not len(self.buffer):
            return np.zeros(0, np.float32)
        cs = self.inner.chunk_size
        chunk = np.zeros(cs, np.float32)
        chunk[: len(self.buffer)] = self.buffer
        self.buffer = np.zeros(0, np.float32)
        return self.inner.process(chunk)


RATE_PAIRS = [(48000, 16000), (44100, 16000), (16000, 24000)]


def generate(seed: int = 1234) -> dict:
    rng = np.random.default_rng(seed)
    data = {}
    for in_rate, out_rate in RATE_PAIRS:
        # length: a multiple of 128 (reference chunks) plus a ragged tail to
        # exercise the zero-pad flush; bandlimited-ish noise for stable f32
        n = 128 * 45 + 77
        x = rng.standard_normal(n).astype(np.float32)
        # push in awkward sizes so the ACCUMULATE layer seams too
        br = SerialBatchResampler(in_rate, out_rate)
        outs, counts = [], []
        pos = 0
        for sz in [100, 128, 300, 64, 1000, 13]:
            y = br.process(x[pos : pos + sz])
            outs.append(y)
            counts.append(len(y))
            pos += sz
        y = br.process(x[pos:])
        outs.append(y)
        counts.append(len(y))
        yf = br.flush()
        key = f"{in_rate}_{out_rate}"
        data[f"x_{key}"] = x
        data[f"y_{key}"] = np.concatenate(outs + [yf])
        data[f"flushlen_{key}"] = np.int64(len(yf))
        data[f"counts_{key}"] = np.asarray(counts, np.int64)
    return data


if __name__ == "__main__":
    import os

    out = os.path.join(os.path.dirname(__file__), "rubato_seams.npz")
    np.savez_compressed(out, **generate())
    d = generate()
    for in_rate, out_rate in RATE_PAIRS:
        k = f"{in_rate}_{out_rate}"
        print(k, "in", len(d[f"x_{k}"]), "out", len(d[f"y_{k}"]),
              "per-push", d[f"counts_{k}"], "flush", d[f"flushlen_{k}"])
    print("wrote", out)
