"""The flow-graph: a chain of nodes compiled to ONE jitted XLA program.

This is the framework's core API (the accelerator re-design of the reference's L3
command surface, SURVEY §1): where the reference chains per-module Rust calls
(capture -> BatchResampler -> VAD -> encode, SURVEY §3.3), a Graph traces the
whole node chain once and hands XLA a single program to fuse, tile onto the
device, and (with shardings, see :mod:`audioflow_tpu.parallel`) partition over a
device mesh.

Two execution modes:

* ``compile()`` — offline: ``fn(batch [..., T]) -> features``; one program,
  one device dispatch per batch.
* ``compile_stream(chunk_in)`` — streaming: fixed-shape ``step(state, chunk)``
  with an explicit carry pytree (the checkpoint format); ``scan_stream``
  wraps the same step in ``lax.scan`` so arbitrarily long audio runs in
  constant HBM inside a single program (SURVEY §5.7).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable

import jax
import jax.numpy as jnp

from ..errors import AudioError, ConfigError, ErrorCode
from .nodes import Node

_DOMAIN_OK = {("samples", "samples"), ("frames", "frames"), ("any", "any")}


def _domains_compatible(out_d: str, in_d: str) -> bool:
    return out_d == in_d or "any" in (out_d, in_d)


@dataclass(frozen=True)
class Graph:
    """An immutable chain of nodes with rate/domain metadata resolved."""

    nodes: tuple[Node, ...]
    input_rate: int | None = None
    name: str = "graph"
    output_rate: int | None = field(init=False, default=None)

    def __post_init__(self):
        if not self.nodes:
            raise ConfigError("graph needs at least one node")
        bound = []
        rate = self.input_rate
        domain = "samples"
        for i, node in enumerate(self.nodes):
            if not _domains_compatible(domain, node.domain_in):
                raise ConfigError(
                    f"node {i} ({type(node).__name__}) expects domain "
                    f"{node.domain_in!r} but receives {domain!r}"
                )
            node = node.bind(rate)
            bound.append(node)
            rate = node.rate_out(rate)
            if node.domain_out != "any":
                domain = node.domain_out
        object.__setattr__(self, "nodes", tuple(bound))
        object.__setattr__(self, "output_rate", rate)

    # ------------------------------------------------------------------ chain
    def chain(self, x: jnp.ndarray, taps: tuple[int, ...] = ()) -> jnp.ndarray:
        """Apply all nodes (traceable; call under jit for one XLA program).

        ``taps`` are node indices whose outputs are also returned — one
        program yields intermediate products for free (e.g. VAD states *and*
        log-mel features), since XLA keeps the shared prefix computed once.
        With taps the return is ``(final, {idx: tapped_output, ...})``.
        """
        tapped = {}
        for i, node in enumerate(self.nodes):
            x = node.apply(x)
            if i in taps:
                tapped[i] = x
        return (x, tapped) if taps else x

    def __call__(self, x):
        return self.chain(x)

    # auto-chunk threshold: below this many input samples the whole-array
    # program runs; above it, the chunked form keeps per-stage [batch, T]
    # intermediates out of device memory. On an H100 (400 W limit) config 2
    # (256 x 10 s at 44.1 kHz) ran 12.33 ms chunked vs 11.26 ms whole-array,
    # so this threshold and the chunk size are open for a sweep.
    _CHUNKED_MIN_T = 65536

    def compile(
        self,
        donate: bool = False,
        taps: tuple[int, ...] = (),
        chunked: bool | str = "auto",
    ) -> Callable:
        """One jitted program for the whole chain (optionally with taps).

        ``chunked`` — long-signal execution strategy. The whole-array
        program materializes every node's [batch, T]-sized intermediate in
        device memory between stages; running the SAME chain as a
        ``lax.scan`` over fixed chunks keeps each step's working set small,
        while the delay-alignment machinery makes the result equal to the
        whole-array program to f32 reassociation noise. ``"auto"`` (default) picks the
        chunked form when the graph is streamable, untapped, and the input
        is long; ``True``/``False`` force it.
        """
        donate_args = (0,) if donate else ()
        if taps:
            bad = [i for i in taps if not 0 <= i < len(self.nodes)]
            if bad:
                raise ConfigError(f"tap indices out of range: {bad}")
            return jax.jit(lambda x: self.chain(x, taps=tuple(taps)), donate_argnums=donate_args)
        if chunked is False:
            return jax.jit(self.chain, donate_argnums=donate_args)
        chunkable = self.streamable or self._decentered() is not None
        if chunked is True and not chunkable:
            self._check_streamable()

        def run(x):
            use = chunkable and (
                chunked is True or x.shape[-1] >= self._CHUNKED_MIN_T
            )
            return self._chunked_chain(x) if use else self.chain(x)

        return jax.jit(run, donate_argnums=donate_args)

    def _decentered(self):
        """``(pad, graph)`` when the only barrier to the chunked form is a
        center=True leading Stft/Spectrogram; None otherwise.

        center=True framing of ``x`` is BY DEFINITION center=False framing of
        ``pad(x, n_fft//2, mode='reflect')`` — identical frame count and
        values — so the pad happens once outside the scan and the rest of
        the chain streams. (True streaming, `compile_stream`, still requires
        center=False: a live stream can never reflect its not-yet-seen
        tail.)"""
        from .nodes import Spectrogram, Stft

        n0 = self.nodes[0]
        if not isinstance(n0, (Stft, Spectrogram)) or not n0.center:
            return None
        if not all(n.streamable for n in self.nodes[1:]):
            return None
        g = dataclasses.replace(
            self,
            nodes=(dataclasses.replace(n0, center=False),) + tuple(self.nodes[1:]),
        )
        return n0.n_fft // 2, g

    def _chunked_chain(self, x: jnp.ndarray) -> jnp.ndarray:
        """Offline semantics via the streaming machinery (see compile)."""
        if not self.streamable:
            pad, g = self._decentered()  # compile() guarantees it exists
            widths = [(0, 0)] * (x.ndim - 1) + [(pad, pad)]
            return g._chunked_chain(jnp.pad(x, widths, mode="reflect"))
        t = x.shape[-1]
        out_spec = jax.eval_shape(self.chain, x)
        domain = "samples"
        for n in self.nodes:
            if n.domain_out != "any":
                domain = n.domain_out
        axis = (-2 if domain == "frames" else -1) % len(out_spec.shape)
        n_out = out_spec.shape[axis]
        gran = self.chunk_granularity()
        chunk = gran * max(1, 16384 // gran)
        lat = self.stream_latency(chunk)
        m = self.chunk_lens(chunk)[-1]
        # enough zero-padded chunks that the trimmed window [lat, lat+n_out)
        # is fully produced
        n_chunks = -(-(t) // chunk)
        while n_chunks * m < lat + n_out:
            n_chunks += 1
        pad = n_chunks * chunk - t
        if pad:
            widths = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
            x = jnp.pad(x, widths)
        streamed = self.scan_stream(x, chunk)
        return jax.lax.slice_in_dim(streamed, lat, lat + n_out, axis=axis)

    def inspect(self, input_shape: tuple, dtype=jnp.float32) -> dict:
        """Compile-time introspection of the single-program graph.

        Returns XLA's cost analysis (flops, bytes accessed) plus fusion and
        collective counts from the optimized HLO — the numbers to check when
        hand-optimizing a node (SURVEY §7.3 #4: "inspect HLO; hand-fuse hot
        pairs where XLA doesn't").
        """
        compiled = jax.jit(self.chain).lower(
            jax.ShapeDtypeStruct(tuple(input_shape), dtype)
        ).compile()
        hlo = compiled.as_text()
        hlo_l = hlo.lower()
        cost = {}
        try:
            analyses = compiled.cost_analysis()
            cost = dict(analyses[0] if isinstance(analyses, (list, tuple)) else analyses)
        except Exception:  # backend may not expose cost analysis
            pass
        return {
            "flops": float(cost.get("flops", -1.0)),
            "bytes_accessed": float(cost.get("bytes accessed", -1.0)),
            "fusions": hlo_l.count(" fusion("),
            # async collectives appear as <op>-start/<op>-done pairs; counting
            # the base name minus the -done forms yields one per actual op
            "collectives": sum(
                hlo_l.count(c) - hlo_l.count(c + "-done")
                for c in ("all-reduce", "all-gather", "reduce-scatter", "collective-permute")
            ),
            "hlo_bytes": len(hlo),
        }

    # -------------------------------------------------------------- streaming
    @property
    def streamable(self) -> bool:
        return all(n.streamable for n in self.nodes)

    def _check_streamable(self):
        bad = [type(n).__name__ for n in self.nodes if not n.streamable]
        if bad:
            raise AudioError(
                f"nodes not streamable: {bad}", code=ErrorCode.CONFIG_VALIDATION_ERROR
            )

    def chunk_granularity(self) -> int:
        """Smallest valid streaming chunk (in input samples); any multiple works.

        Each node needs its incoming chunk to be a multiple of
        ``node.chunk_multiple()``; the incoming length is the input chunk
        scaled by the exact rational ratios of the preceding nodes.
        """
        import math
        from fractions import Fraction

        gran = 1
        ratio = Fraction(1)
        for node in self.nodes:
            m = node.chunk_multiple()
            # need (chunk_in * ratio) % m == 0  ->  chunk_in multiple of:
            need = (m * ratio.denominator) // math.gcd(ratio.numerator, m * ratio.denominator)
            gran = math.lcm(gran, need)
            ratio *= Fraction(node.out_len(m), m)
        return gran

    def chunk_lens(self, chunk_in: int) -> list[int]:
        """Per-node streaming chunk lengths [n_0=chunk_in, ..., n_out]."""
        lens = [chunk_in]
        n = chunk_in
        for node in self.nodes:
            node.validate_chunk(n)
            n = node.out_len(n)
            lens.append(n)
        return lens

    def _downstream_granularity(self, i: int) -> int:
        """Chunk granularity of nodes[i+1:] in units of node i's output."""
        import math
        from fractions import Fraction

        gran = 1
        ratio = Fraction(1)
        for node in self.nodes[i + 1 :]:
            m = node.chunk_multiple()
            need = (m * ratio.denominator) // math.gcd(ratio.numerator, m * ratio.denominator)
            gran = math.lcm(gran, need)
            ratio *= Fraction(node.out_len(m), m)
        return gran

    def _delays(self, chunk_in: int) -> list[int]:
        """Per-node aligned streaming delay (in that node's output units).

        A node's intrinsic latency (e.g. a resampler's filter lookahead) is a
        shift in its *output sample grid*; if it is not a whole multiple of
        the downstream chain's granularity (e.g. an STFT hop), downstream
        frames would land on a shifted grid and streaming would only
        approximate offline. Padding the delay up to that granularity makes
        the streamed output an exact (whole-unit) shift of the offline one.
        """
        lens = self.chunk_lens(chunk_in)
        out = []
        for i, node in enumerate(self.nodes):
            lat = node.latency(lens[i])
            align = self._downstream_granularity(i)
            pad = (-lat) % align if lat else 0
            out.append(lat + pad)
        return out

    def _warmups(self, chunk_in: int) -> list[int]:
        """Cumulative upstream warmup per node, in that node's INPUT units.

        The first ``warmups[i]`` units node i receives are upstream *preroll*
        — outputs a latency-bearing ancestor computed from zero history that
        correspond to nothing in the offline run. A positional node (STFT
        framing) just emits discarded preroll for them, but a recursive or
        accumulating node (biquad, limiter, VAD's EMA, ISTFT overlap-add)
        would fold them into its carry and drag a decaying transient into the
        valid region — breaking the exact streamed == shifted-offline
        invariant. ``stream_step`` therefore zeros the warmup region, which
        reproduces exactly what each node sees offline (zero prehistory):
        zero input is a fixpoint of every carried state.
        """
        from fractions import Fraction

        lens = self.chunk_lens(chunk_in)
        delays = self._delays(chunk_in)
        warm = []
        for i in range(len(self.nodes)):
            u = Fraction(0)
            for j in range(i):
                u += Fraction(delays[j] * lens[i], lens[j + 1])
            assert u.denominator == 1, (i, u)
            warm.append(int(u))
        return warm

    def stream_latency(self, chunk_in: int) -> int:
        """Total streaming latency in final-output units (exact integer)."""
        lens = self.chunk_lens(chunk_in)
        delays = self._delays(chunk_in)
        total = 0
        for i, d in enumerate(delays):
            assert (d * lens[-1]) % lens[i + 1] == 0
            total += d * lens[-1] // lens[i + 1]
        return total

    def _stream_axis(self, node: Node) -> int:
        return -2 if node.domain_out == "frames" else -1

    def init_state(self, chunk_in: int, lead_shape: tuple = (), dtype=jnp.float32):
        """Initial stream state: (carries, pendings, chunk_counter) pytree.

        ``pendings[i]`` is the zero-filled delay-alignment buffer for node i
        (None when no alignment is needed); shapes come from an abstract
        (eval_shape) pass, so nothing is computed.
        """
        self._check_streamable()
        lens = self.chunk_lens(chunk_in)
        delays = self._delays(chunk_in)
        carries = []
        n = chunk_in
        for node in self.nodes:
            carries.append(node.init_carry(lead_shape, n, dtype))
            n = node.out_len(n)

        # abstract pass for per-node output shapes/dtypes
        def _run(chunk):
            shapes = []
            x = chunk
            for node, carry in zip(self.nodes, carries):
                _, x = node.step(carry, x)
                shapes.append(x)
            return shapes

        out_specs = jax.eval_shape(_run, jnp.zeros((*lead_shape, chunk_in), dtype))
        pendings = []
        for i, node in enumerate(self.nodes):
            lat = node.latency(lens[i])
            pad = delays[i] - lat
            if pad == 0:
                pendings.append(None)
                continue
            spec = out_specs[i]
            axis = self._stream_axis(node) % len(spec.shape)
            shape = list(spec.shape)
            shape[axis] = pad
            pendings.append(jnp.zeros(shape, spec.dtype))
        return carries, pendings, jnp.zeros((), jnp.int32)

    def stream_step(self, state, chunk: jnp.ndarray):
        """One fixed-shape streaming step through every node (traceable).

        The carried ``k`` (chunk index) drives warmup zeroing (see
        :meth:`_warmups`): node i's input positions below ``warmups[i]`` are
        forced to zero so its state matches the offline zero-prehistory run.
        """
        carries, pendings, k = state
        lens = self.chunk_lens(chunk.shape[-1])
        warmups = self._warmups(chunk.shape[-1])
        new_carries, new_pendings = [], []
        x = chunk
        domain = "samples"
        for i, (node, carry, pending) in enumerate(zip(self.nodes, carries, pendings)):
            if warmups[i] and not node.warmup_passthrough:
                axis = (-2 if domain == "frames" else -1) % x.ndim
                m = lens[i]
                pos = k * m + jax.lax.iota(jnp.int32, m)
                shape = [1] * x.ndim
                shape[axis] = m
                x = jnp.where(pos.reshape(shape) >= warmups[i], x, 0)
            if node.domain_out != "any":
                domain = node.domain_out
            if node.wants_first_index:
                carry, x = node.step(carry, x, first_index=warmups[i] - k * lens[i])
            else:
                carry, x = node.step(carry, x)
            if pending is not None:
                axis = self._stream_axis(node) % x.ndim
                n_out = x.shape[axis]
                buf = jnp.concatenate([pending, x], axis=axis)
                x = jax.lax.slice_in_dim(buf, 0, n_out, axis=axis)
                pending = jax.lax.slice_in_dim(buf, n_out, buf.shape[axis], axis=axis)
            new_carries.append(carry)
            new_pendings.append(pending)
        return (new_carries, new_pendings, k + 1), x

    def compile_stream(self, donate: bool = True) -> Callable:
        """Jitted ``step(state, chunk) -> (state, out)``; donate recycles the
        carry buffers in place (no HBM churn per chunk)."""
        return jax.jit(self.stream_step, donate_argnums=(0,) if donate else ())

    def scan_stream(self, x: jnp.ndarray, chunk_in: int) -> jnp.ndarray:
        """Stream a whole signal inside one program: lax.scan over chunks.

        ``x [..., T]`` with T a multiple of chunk_in. Output chunks are
        concatenated along the streamed axis.
        """
        self._check_streamable()
        t = x.shape[-1]
        if t % chunk_in:
            raise AudioError(
                f"signal length {t} not a multiple of chunk_in {chunk_in}; pad first",
                code=ErrorCode.SHAPE_MISMATCH,
            )
        lead = x.shape[:-1]
        n_chunks = t // chunk_in
        state = self.init_state(chunk_in, lead, x.dtype)
        chunks = jnp.moveaxis(x.reshape(*lead, n_chunks, chunk_in), -2, 0)

        def body(s, c):
            s, out = self.stream_step(s, c)
            return s, out

        _, outs = jax.lax.scan(body, state, chunks)  # outs: [n_chunks, ..., m(, F)]
        outs = jnp.moveaxis(outs, 0, len(lead))  # [..., n_chunks, m(, F)]
        m = outs.shape[len(lead) + 1]
        return outs.reshape(*lead, n_chunks * m, *outs.shape[len(lead) + 2 :])


def chain(*nodes: Node, input_rate: int | None = None, name: str = "graph") -> Graph:
    """Convenience constructor: ``chain(Resample(...), Stft(...), ...)``."""
    return Graph(tuple(nodes), input_rate=input_rate, name=name)


@dataclass(frozen=True)
class Fork:
    """A trunk graph feeding N named branch graphs — multi-OUTPUT DAG support
    (the reference's pipeline fork: VAD-gated wire egress AND ungated
    features from one capture stream, SURVEY §3.3), traced into ONE jitted
    XLA program so the shared trunk is computed once.

    Unlike :class:`audioflow_tpu.graph.nodes.Mix` (which merges same-shape
    branches back into the chain), Fork's branches are independent full
    graphs with their own output domains, lengths, and streaming latencies;
    outputs are a ``{name: array}`` dict.

    Streaming: state = (trunk_state, {name: branch_state}); each branch's
    streamed output equals its offline output shifted by that branch's
    ``stream_latency`` — per-branch, no cross-branch alignment imposed.
    """

    trunk: Graph
    branches: tuple  # tuple[(name, Graph), ...]
    name: str = "fork"

    def __post_init__(self):
        if not self.branches:
            raise ConfigError("Fork needs at least one branch")
        bs = tuple((str(k), g) for k, g in self.branches)
        names = [k for k, _ in bs]
        if len(set(names)) != len(names):
            raise ConfigError(f"duplicate Fork branch names: {names}")
        out_rate = self.trunk.output_rate
        out_domain = "samples"
        for n in self.trunk.nodes:
            if n.domain_out != "any":
                out_domain = n.domain_out
        for k, g in bs:
            if not _domains_compatible(out_domain, g.nodes[0].domain_in):
                raise ConfigError(
                    f"Fork branch {k!r} expects domain {g.nodes[0].domain_in!r} "
                    f"but trunk produces {out_domain!r}"
                )
            if g.input_rate is not None and out_rate is not None and g.input_rate != out_rate:
                raise ConfigError(
                    f"Fork branch {k!r} input_rate {g.input_rate} != trunk output rate {out_rate}"
                )
        object.__setattr__(self, "branches", bs)

    @property
    def input_rate(self):
        return self.trunk.input_rate

    @property
    def streamable(self) -> bool:
        return self.trunk.streamable and all(g.streamable for _, g in self.branches)

    # ------------------------------------------------------------- offline
    def chain(self, x: jnp.ndarray) -> dict:
        y = self.trunk.chain(x)
        return {k: g.chain(y) for k, g in self.branches}

    def __call__(self, x):
        return self.chain(x)

    def compile(self, donate: bool = False) -> Callable:
        """One jitted program computing every branch (trunk runs once)."""
        return jax.jit(self.chain, donate_argnums=(0,) if donate else ())

    # ----------------------------------------------------------- streaming
    def chunk_granularity(self) -> int:
        import math
        from fractions import Fraction

        gran = self.trunk.chunk_granularity()
        # a branch's granularity constraint maps back through the trunk ratio
        ratio = Fraction(1)
        for node in self.trunk.nodes:
            m = node.chunk_multiple()
            ratio *= Fraction(node.out_len(m), m)
        for _, g in self.branches:
            m = g.chunk_granularity()
            need = (m * ratio.denominator) // math.gcd(ratio.numerator, m * ratio.denominator)
            gran = math.lcm(gran, need)
        return gran

    def _trunk_out_len(self, chunk_in: int) -> int:
        return self.trunk.chunk_lens(chunk_in)[-1]

    def _branch_pads(self, chunk_in: int) -> dict:
        """Per-branch alignment of the trunk's streaming latency: pad it up
        to the branch's chunk granularity (the same alignment Graph._delays
        applies within a chain) so each branch's streamed output is an exact
        whole-unit shift of its offline output."""
        trunk_lat = self.trunk.stream_latency(chunk_in)
        return {
            k: (-trunk_lat) % g.chunk_granularity() if trunk_lat else 0
            for k, g in self.branches
        }

    def _trunk_axis(self) -> int:
        domain = "samples"
        for n in self.trunk.nodes:
            if n.domain_out != "any":
                domain = n.domain_out
        return -2 if domain == "frames" else -1

    def stream_latency(self, chunk_in: int) -> dict:
        """Per-branch streaming latency in that branch's output units."""
        mid = self._trunk_out_len(chunk_in)
        trunk_lat = self.trunk.stream_latency(chunk_in)
        pads = self._branch_pads(chunk_in)
        out = {}
        for k, g in self.branches:
            lens = g.chunk_lens(mid)
            aligned = trunk_lat + pads[k]
            # aligned trunk latency (trunk-output units) -> branch output units
            assert (aligned * lens[-1]) % mid == 0
            out[k] = aligned * lens[-1] // mid + g.stream_latency(mid)
        return out

    def init_state(self, chunk_in: int, lead_shape: tuple = (), dtype=jnp.float32):
        mid = self._trunk_out_len(chunk_in)
        pads = self._branch_pads(chunk_in)
        trunk_state = self.trunk.init_state(chunk_in, lead_shape, dtype)
        axis = self._trunk_axis()
        spec = jax.eval_shape(
            lambda s, c: self.trunk.stream_step(s, c)[1],
            trunk_state, jnp.zeros((*lead_shape, chunk_in), dtype),
        )
        pend = {}
        for k, _ in self.branches:
            if pads[k] == 0:
                pend[k] = None
                continue
            shape = list(spec.shape)
            shape[axis % len(shape)] = pads[k]
            pend[k] = jnp.zeros(shape, spec.dtype)
        return (
            trunk_state,
            {k: g.init_state(mid, lead_shape, dtype) for k, g in self.branches},
            pend,
        )

    def stream_step(self, state, chunk: jnp.ndarray):
        trunk_state, branch_states, pend = state
        step_idx = trunk_state[2]  # trunk chunk counter (drives warmup zeroing)
        trunk_state, y = self.trunk.stream_step(trunk_state, chunk)
        axis_hint = self._trunk_axis()
        trunk_lat = self.trunk.stream_latency(chunk.shape[-1])
        y_zeroed = y
        if trunk_lat:
            # zero the trunk's own preroll so branch carries never see it
            # (the in-chain analog is Graph._warmups; branches whose head
            # node consumes the preroll — warmup_passthrough — get raw y)
            axis = axis_hint % y.ndim
            mid = y.shape[axis]
            pos = step_idx * mid + jax.lax.iota(jnp.int32, mid)
            shape = [1] * y.ndim
            shape[axis] = mid
            y_zeroed = jnp.where(pos.reshape(shape) >= trunk_lat, y, 0)
        new_states, new_pend, outs = {}, {}, {}
        for k, g in self.branches:
            yk = y if g.nodes[0].warmup_passthrough else y_zeroed
            pk = pend[k]
            if pk is not None:
                axis = axis_hint % y.ndim
                n_out = y.shape[axis]
                buf = jnp.concatenate([pk, y], axis=axis)
                yk = jax.lax.slice_in_dim(buf, 0, n_out, axis=axis)
                pk = jax.lax.slice_in_dim(buf, n_out, buf.shape[axis], axis=axis)
            new_states[k], outs[k] = g.stream_step(branch_states[k], yk)
            new_pend[k] = pk
        return (trunk_state, new_states, new_pend), outs

    def compile_stream(self, donate: bool = True) -> Callable:
        return jax.jit(self.stream_step, donate_argnums=(0,) if donate else ())

    def scan_stream(self, x: jnp.ndarray, chunk_in: int) -> dict:
        """Whole-signal streaming in one program; dict of concatenated outputs."""
        t = x.shape[-1]
        if t % chunk_in:
            raise AudioError(
                f"signal length {t} not a multiple of chunk_in {chunk_in}; pad first",
                code=ErrorCode.SHAPE_MISMATCH,
            )
        lead = x.shape[:-1]
        n_chunks = t // chunk_in
        state = self.init_state(chunk_in, lead, x.dtype)
        chunks = jnp.moveaxis(x.reshape(*lead, n_chunks, chunk_in), -2, 0)
        _, outs = jax.lax.scan(lambda s, c: self.stream_step(s, c), state, chunks)

        def merge(o, g):
            o = jnp.moveaxis(o, 0, len(lead))  # [..., n_chunks, m(, F)]
            m = o.shape[len(lead) + 1]
            return o.reshape(*lead, n_chunks * m, *o.shape[len(lead) + 2 :])

        return {k: merge(outs[k], g) for k, g in self.branches}


def fork(trunk: Graph, name: str = "fork", **branches: Graph) -> Fork:
    """Convenience constructor: ``fork(trunk, wire=g1, features=g2)``."""
    return Fork(trunk, tuple(branches.items()), name=name)
