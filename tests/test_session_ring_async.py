"""StreamSession on the device staging accumulator (SURVEY §2.2 RingBuffer —
the linear form; ops/ring.py documents why it replaces circular addressing
on the hot path) + lazy-result async push."""

import numpy as np

import jax.numpy as jnp

from audioflow_tpu.graph import Gain, Resample, chain
from audioflow_tpu.ops.ring import Staging
from audioflow_tpu.session import StreamSession


def _graph(sr=16000):
    return chain(Gain(6.0), input_rate=sr)


def test_push_accumulates_in_device_ring_not_host():
    g = _graph()
    s = StreamSession(g, chunk_in=512).open()
    assert isinstance(s._stage, Staging)  # device-resident accumulator
    # irregular pushes; residual lives in the ring, counted host-side
    assert s.push(np.ones(300, np.float32)) == 0
    assert s._pending == 300
    assert s.push(np.ones(300, np.float32)) == 1
    assert s._pending == 88
    r = s.poll()
    np.testing.assert_allclose(r.data, np.full(512, 10 ** (6.0 / 20.0)), rtol=1e-6)
    s.close()


def test_push_is_lazy_until_polled():
    """No host materialization during the push loop (no sinks/events): the
    device/host overlap — push dispatches, poll materializes."""
    g = _graph()
    s = StreamSession(g, chunk_in=256).open()
    s.push(np.random.default_rng(0).standard_normal(2048).astype(np.float32))
    queued = list(s._results.queue)
    assert len(queued) == 8
    assert not any(r.materialized for r in queued)  # still device-side
    first = s.poll()
    _ = first.data
    assert first.materialized
    rest = s.poll_all()
    assert not any(r.materialized for r in rest)
    s.close()


def test_ring_path_matches_offline_exactly():
    """Streaming through the ring with ragged pushes == offline, and a giant
    single push (auto-split across ring headroom) == offline too."""
    sr = 48000
    g = chain(Resample(sr, 16000, "kaiser"), input_rate=sr)
    rng = np.random.default_rng(1)
    x = (0.3 * rng.standard_normal(sr * 2)).astype(np.float32)
    chunk = g.chunk_granularity() * 2
    n = (len(x) // chunk) * chunk
    x = x[:n]
    offline = np.asarray(g.compile()(jnp.asarray(x)))
    lat = g.stream_latency(chunk)

    for pushes in ([x], np.array_split(x, 37)):  # one giant push; ragged pushes
        s = StreamSession(g, chunk_in=chunk).open()
        for p in pushes:
            s.push(p)
        s.flush()
        got = np.concatenate([r.data for r in s.poll_all()], axis=-1)
        m = min(got.shape[-1] - lat, offline.shape[-1])
        np.testing.assert_allclose(got[lat : lat + m], offline[:m], atol=2e-6)
        s.close()


def test_snapshot_restore_through_ring(tmp_path):
    """Mid-stream snapshot with a ring residual restores exactly (same
    on-disk format as the host-buffer era)."""
    sr = 16000
    g = _graph(sr)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(3000).astype(np.float32)

    s1 = StreamSession(g, chunk_in=1024).open()
    s1.push(x[:1500])  # one chunk processed, 476 pending in the ring
    assert s1._pending == 476
    snap = tmp_path / "mid"
    s1.snapshot(str(snap))
    s1.push(x[1500:])
    s1.flush()
    want = np.concatenate([r.data for r in s1.poll_all()], axis=-1)
    s1.close()

    s2 = StreamSession(g, chunk_in=1024).restore(str(snap))
    assert s2._pending == 476
    s2.poll_all()  # drop pre-snapshot results (already consumed by s1)
    s2.push(x[1500:])
    s2.flush()
    got = np.concatenate([r.data for r in s2.poll_all()], axis=-1)
    np.testing.assert_array_equal(got, want[1024:])
    s2.close()


def test_multi_chunk_drain_matches_single_and_offline():
    """Bulk pushes drain >=2 buffered chunks through ONE jitted lax.scan
    multi-step (bucketed 8/4/2) — same results as chunk-at-a-time, exactly
    (amortizes the fixed cost of a dispatch chain)."""
    sr = 48000
    g = chain(Resample(sr, 16000, "kaiser"), input_rate=sr)
    chunk = g.chunk_granularity() * 2
    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal(chunk * 19 + 77)).astype(np.float32)

    # bulk session: capacity sized for the 8-bucket, whole signal in one push
    sb = StreamSession(g, chunk_in=chunk, ring_capacity=17 * chunk).open()
    assert 8 in sb._drain_buckets
    sb.push(x)
    sb.flush()
    assert sb._multi, "multi-step drain was never exercised"
    bulk = np.concatenate([r.data for r in sb.poll_all()], axis=-1)
    sb.close()

    # chunk-at-a-time session (b=1 path only)
    s1 = StreamSession(g, chunk_in=chunk).open()
    for i in range(0, len(x), chunk):
        s1.push(x[i : i + chunk])
    s1.flush()
    assert not s1._multi
    single = np.concatenate([r.data for r in s1.poll_all()], axis=-1)
    s1.close()

    np.testing.assert_array_equal(bulk, single)


def test_multi_drain_results_share_one_fetch():
    """All Results of one drained block materialize from a single shared
    device->host fetch (the _Stacked holder)."""
    g = _graph()
    s = StreamSession(g, chunk_in=256, ring_capacity=17 * 256).open()
    s.push(np.ones(8 * 256, np.float32))
    rs = s.poll_all()
    assert len(rs) == 8 and not any(r.materialized for r in rs)
    holders = {id(r._stacked) for r in rs}
    assert len(holders) == 1  # one block, one holder
    _ = rs[0].data
    # the shared holder now has the host copy; the others still lazily view it
    assert rs[0].materialized and not rs[1].materialized
    np.testing.assert_allclose(rs[7].data, np.full(256, 10 ** (6.0 / 20.0)), rtol=1e-6)
    s.close()


def test_snapshot_restore_across_multi_drain(tmp_path):
    sr = 16000
    g = _graph(sr)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(8 * 512 + 300).astype(np.float32)
    s1 = StreamSession(g, chunk_in=512, ring_capacity=17 * 512).open()
    s1.push(x)  # multi-drain leaves 300 pending
    assert s1._pending == 300 and s1._multi
    snap = tmp_path / "multi"
    s1.snapshot(str(snap))
    s1.flush()
    want = np.concatenate([r.data for r in s1.poll_all()], axis=-1)
    s1.close()

    s2 = StreamSession(g, chunk_in=512, ring_capacity=17 * 512).restore(str(snap))
    assert s2._pending == 300
    s2.poll_all()
    s2.flush()
    got = np.concatenate([r.data for r in s2.poll_all()], axis=-1)
    np.testing.assert_array_equal(got, want[..., 8 * 512 :])
    s2.close()


def test_ragged_pushes_compile_bounded_shape_buckets():
    """Irregular push sizes must NOT compile one write program per length:
    push pads host-side to power-of-two buckets (jit caches by shape; each
    new shape is a fresh compile)."""
    g = _graph()
    s = StreamSession(g, chunk_in=512).open()
    orig, seen = s._write, set()

    def spy(st, data, n):
        seen.add(data.shape)
        return orig(st, data, n)

    s._write = spy
    rng = np.random.default_rng(0)
    total = 0
    for _ in range(40):
        n = int(rng.integers(1, 2500))
        s.push(rng.standard_normal(n).astype(np.float32))
        total += n
    assert s._samples_in == total  # bucket padding never leaks into the data
    assert len(seen) <= 5, seen  # 256/512/1024/2048 + headroom cap
    s.close()


def test_open_precompiles_entire_first_push_chain():
    """open(precompile=True) must warm EVERY program the first chunk-cadence
    push dispatches — graph step, staging write at the canonical bucket,
    chunk take — so the first live push never stalls on a compile. Asserted via the pjit C++ cache: sizes after open == sizes
    after the first push."""
    g = _graph()
    s = StreamSession(g, chunk_in=512).open()
    sizes = lambda: (  # noqa: E731
        s._write._cache_size(), s._take._cache_size()
    )
    warm = sizes()
    assert all(n >= 1 for n in warm), warm
    s.push(np.ones(512, np.float32))
    s.poll()
    assert sizes() == warm
    s.close()


def test_open_precompile_all_covers_drain_buckets():
    g = _graph()
    s = StreamSession(g, chunk_in=256, ring_capacity=17 * 256).open(
        precompile="all"
    )
    assert set(s._multi) == set(s._drain_buckets)
    take_warm = s._take._cache_size()
    s.push(np.ones(8 * 256, np.float32))  # drains through the 8-bucket
    assert s._take._cache_size() == take_warm
    s.close()


def test_chunk_cadence_pushes_bypass_staging():
    """A push of exactly chunk_in (or one drain bucket) with nothing pending
    must step directly — no staging write/take dispatches (the live path's
    latency floor is the runtime's fixed per-dispatch charge) — and still
    match offline exactly."""
    g = _graph()
    chunk = 512
    x = np.random.default_rng(3).standard_normal(8 * chunk).astype(np.float32)
    offline = np.asarray(g.compile()(jnp.asarray(x)))
    lat = g.stream_latency(chunk)

    s = StreamSession(g, chunk_in=chunk, ring_capacity=17 * chunk).open(
        precompile=False
    )
    calls = {"write": 0, "take": 0}
    orig_write, orig_take = s._write, s._take
    s._write = lambda *a: calls.__setitem__("write", calls["write"] + 1) or orig_write(*a)
    s._take = lambda *a: calls.__setitem__("take", calls["take"] + 1) or orig_take(*a)
    s.push(x[: 2 * chunk])  # bucket-2 fast path
    for i in range(2, 7):
        s.push(x[i * chunk : (i + 1) * chunk])  # chunk fast path
    s.push(x[7 * chunk :])
    assert calls == {"write": 0, "take": 0}, calls  # staging never dispatched
    s._write, s._take = orig_write, orig_take
    got = np.concatenate([r.data for r in s.poll_all()], axis=-1)
    m = min(got.shape[-1] - lat, offline.shape[-1])
    np.testing.assert_allclose(got[lat : lat + m], offline[:m], atol=2e-6)
    s.close()


def test_fast_path_mixes_with_ragged_pushes_exactly():
    """Interleaving cadence-aligned (fast-path) and ragged (staged) pushes
    must produce the same stream as offline — the fast path may only fire
    when the ring is empty."""
    g = _graph()
    chunk = 512
    x = np.random.default_rng(4).standard_normal(10 * chunk).astype(np.float32)
    offline = np.asarray(g.compile()(jnp.asarray(x)))
    lat = g.stream_latency(chunk)
    s = StreamSession(g, chunk_in=chunk).open()
    cuts = [0, 512, 812, 1024, 2048, 2948, 3072, 4096, 4596, 5120, len(x)]
    for a, b in zip(cuts, cuts[1:]):
        s.push(x[a:b])
    s.flush()
    got = np.concatenate([r.data for r in s.poll_all()], axis=-1)
    m = min(got.shape[-1] - lat, offline.shape[-1])
    np.testing.assert_allclose(got[lat : lat + m], offline[:m], atol=2e-6)
    s.close()


def test_open_precompile_false_defers_compiles():
    # lead_shape=(7,) makes every ring-program shape unique to this test:
    # the pjit cache is shared across jax.jit wrappers of the same function,
    # so counts are process-global and a colliding bucket shape compiled by
    # ANY earlier test would mask the lazy compile this asserts on
    g = _graph()
    s = StreamSession(g, chunk_in=384, lead_shape=(7,)).open(precompile=False)
    after_open = s._write._cache_size()
    # 500 samples is NOT cadence-aligned, so it must go through staging
    # (a 384-sample push would take the direct fast path instead)
    s.push(np.ones((7, 500), np.float32))  # still works, compiles lazily
    assert s._write._cache_size() > after_open
    s.close()
