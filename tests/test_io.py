import numpy as np
import pytest

from audioflow_tpu.errors import IOError_
from audioflow_tpu.io import BatchLoader, decode_batch, native, probe, read_wav, write_wav


def _tone(n=1600, sr=16000, f=440.0, amp=0.5, ch=1):
    t = np.arange(n) / sr
    x = amp * np.sin(2 * np.pi * f * t).astype(np.float32)
    if ch > 1:
        x = np.stack([x * (c + 1) / ch for c in range(ch)], axis=1)
    return x


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("ch", [1, 2])
def test_wav_round_trip(tmp_path, bits, ch):
    x = _tone(ch=ch)
    p = tmp_path / "t.wav"
    write_wav(p, x, 16000, bits=bits)
    y, rate = read_wav(p)
    assert rate == 16000
    assert y.shape == x.shape
    tol = 1.5 / 32767 if bits == 16 else 1e-7
    np.testing.assert_allclose(y, x, atol=tol)


def test_probe(tmp_path):
    p = tmp_path / "t.wav"
    write_wav(p, _tone(n=1234), 44100, bits=16)
    info = probe(p.read_bytes())
    assert info.sample_rate == 44100 and info.channels == 1
    assert info.n_frames == 1234 and info.bits == 16


def test_read_missing_file():
    with pytest.raises(IOError_):
        read_wav("/nonexistent/file.wav")


def test_read_garbage():
    with pytest.raises(IOError_):
        read_wav(b"this is not a wav file at all.........")


def test_24bit_decode(tmp_path):
    """Hand-build a 24-bit PCM file; check sign extension."""
    import struct

    vals = np.array([0, 8388607, -8388608, 4194304], dtype=np.int64)
    payload = b"".join(struct.pack("<i", int(v) << 8)[1:4] for v in vals)
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 16000 * 3, 3, 24)
    hdr += b"data" + struct.pack("<I", len(payload))
    y, rate = read_wav(hdr + payload)
    np.testing.assert_allclose(y, vals / 8388608.0, atol=1e-7)


def test_decode_batch_with_bad_lane(tmp_path):
    good = tmp_path / "good.wav"
    write_wav(good, _tone(800), 16000)
    batch = decode_batch([good, b"garbage", good], use_native=False)
    assert list(batch.valid) == [True, False, True]
    assert batch.lengths[1] == 0
    assert batch.samples[1].sum() == 0
    assert batch.samples.shape[1] % 128 == 0
    assert batch.audio_seconds == pytest.approx(0.1, abs=1e-6)


@pytest.mark.skipif(not native.available(), reason="native decoder not built")
def test_native_matches_numpy(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i, (ch, bits, n) in enumerate([(1, 16, 777), (2, 16, 1500), (1, 32, 640)]):
        x = (rng.uniform(-0.9, 0.9, (n, ch)).astype(np.float32)) if ch > 1 else rng.uniform(
            -0.9, 0.9, n
        ).astype(np.float32)
        p = tmp_path / f"f{i}.wav"
        write_wav(p, x, 16000, bits=bits)
        paths.append(p)
    a = decode_batch(paths, use_native=True)
    b = decode_batch(paths, use_native=False)
    assert a.samples.shape == b.samples.shape
    np.testing.assert_allclose(a.samples, b.samples, atol=2e-7)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_array_equal(a.rates, b.rates)


@pytest.mark.skipif(not native.available(), reason="native decoder not built")
def test_native_bad_lane_isolated():
    out, frames, rates = native.decode_batch_mono([b"nope", b""], stride=256)
    assert frames[0] == -1 and frames[1] == -1
    assert out.sum() == 0


def test_batch_loader_prefetch(tmp_path):
    paths = []
    for i in range(7):
        p = tmp_path / f"{i}.wav"
        write_wav(p, _tone(n=320 + i * 16), 16000)
        paths.append(p)
    loader = BatchLoader(paths, batch_size=3, use_native=False)
    batches = list(loader)
    assert len(batches) == 3 == len(loader)
    assert [b.samples.shape[0] for b in batches] == [3, 3, 1]
    assert all(b.valid.all() for b in batches)


def test_batch_loader_bad_batch_size():
    with pytest.raises(IOError_):
        BatchLoader([], 0)


@pytest.mark.parametrize("use_native", [False, True])
def test_batch_loader_staging_ring(tmp_path, use_native):
    """Fixed-stride loaders decode into reused warm buffers; results are
    identical to the unpooled path, including pad-tail zeroing after a
    longer batch wrote the same slot (the slot must be re-zeroed per use)."""
    if use_native and not native.available():
        pytest.skip("native decoder not built")
    paths = []
    for i in range(12):  # > ring depth (prefetch+3 = 5) so slots recycle
        p = tmp_path / f"{i}.wav"
        write_wav(p, _tone(n=512 - i * 16, f=200.0 + 10 * i), 16000)
        paths.append(p)
    pooled = BatchLoader(paths, batch_size=2, stride=512, use_native=use_native)
    plain = [
        decode_batch(paths[i : i + 2], stride=512, use_native=use_native)
        for i in range(0, 12, 2)
    ]
    # consume streamingly: batch.samples is only valid until the ring slot
    # recycles (prefetch+3 batches later) — the runner's usage pattern
    n = 0
    for g, w in zip(pooled, plain):
        np.testing.assert_array_equal(g.samples, w.samples)
        np.testing.assert_array_equal(g.lengths, w.lengths)
        assert g.valid.all()
        # pad tail beyond the file's length is zero even on a recycled slot
        for row, ln in enumerate(g.lengths):
            assert np.all(g.samples[row, int(ln):] == 0.0)
        n += 1
    assert n == len(plain)


def test_probe_truncated_inside_fmt_raises_typed():
    """Regression: struct.error must surface as IOError_ (lane isolation)."""
    import struct as _s

    buf = b"RIFF" + _s.pack("<I", 100) + b"WAVE" + b"fmt " + _s.pack("<I", 16) + b"\x01\x00"
    with pytest.raises(IOError_):
        probe(buf)
    # and through decode_batch: the lane is masked, not fatal
    batch = decode_batch([buf], use_native=False)
    assert not batch.valid[0]


def _float16_wav(n=64):
    """fmt=FLOAT with bits=16 — malformed: IEEE-float WAV is 32/64-bit only."""
    import struct as _s

    payload = b"\x00\x01" * n
    hdr = b"RIFF" + _s.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + _s.pack("<IHHIIHH", 16, 3, 1, 16000, 16000 * 2, 2, 16)
    hdr += b"data" + _s.pack("<I", len(payload))
    return hdr + payload


def test_float16_wav_rejected_typed():
    """Regression: fmt=FLOAT/bits=16 must raise IOError_, not a
    raw ValueError from np.frombuffer that escapes the lane-isolation guard."""
    buf = _float16_wav()
    with pytest.raises(IOError_):
        probe(buf)
    with pytest.raises(IOError_):
        read_wav(buf)
    # through decode_batch: lane is masked, batch survives
    batch = decode_batch([buf], use_native=False)
    assert not batch.valid[0]


@pytest.mark.skipif(not native.available(), reason="native decoder not built")
def test_float16_wav_native_agrees():
    """The C++ probe must reject the same bytes the numpy oracle rejects —
    previously it silently decoded them via the integer-PCM branch."""
    out, frames, rates = native.decode_batch_mono([_float16_wav()], stride=128)
    assert frames[0] == -1 and rates[0] == 0
    assert out.sum() == 0


def test_batch_loader_propagates_producer_errors(tmp_path):
    """Regression: a crashing decode must raise, not silently end the run."""

    class Boom:
        def __fspath__(self):
            raise MemoryError("decode blew up")

    loader = BatchLoader([Boom()], batch_size=1, use_native=False)
    with pytest.raises(MemoryError):
        list(loader)


def _g711_wav(fmt_tag: int, codes: bytes, rate: int = 8000, ch: int = 1) -> bytes:
    import struct as _s

    hdr = b"RIFF" + _s.pack("<I", 36 + len(codes)) + b"WAVE"
    hdr += b"fmt " + _s.pack("<IHHIIHH", 16, fmt_tag, ch, rate, rate * ch, ch, 8)
    hdr += b"data" + _s.pack("<I", len(codes))
    return hdr + codes


def test_g711_anchor_values():
    """Published ITU G.711 anchors: mu-law 0x00 -> -32124, 0xFF -> 0 (+0),
    0x7F -> -0; A-law 0x55 -> -8, 0xD5 -> +8, 0x2A -> -32256 sign side max."""
    from audioflow_tpu.io.wav import _ALAW_TABLE, _MULAW_TABLE

    mu = _MULAW_TABLE * 32768.0
    al = _ALAW_TABLE * 32768.0
    assert mu[0x00] == -32124 and mu[0x80] == 32124
    assert mu[0xFF] == 0 and mu[0x7F] == 0
    assert al[0x55] == -8 and al[0xD5] == 8
    assert al[0x2A] == -32256 and al[0xAA] == 32256
    # decode maps are monotone within each sign half's code ordering
    assert (np.diff(np.sort(mu)) >= 0).all() and len(np.unique(mu)) == 255  # +0/-0 collide


def test_g711_roundtrip_quantization_bound(rng):
    """Nearest-code encoding (the table argmin, a valid G.711 encoder) must
    round-trip any int16 within half the largest segment step."""
    from audioflow_tpu.io.wav import _ALAW_TABLE, _MULAW_TABLE

    s = rng.integers(-32768, 32768, 400).astype(np.float32) / 32768.0
    for tbl, step in ((_MULAW_TABLE, 1024), (_ALAW_TABLE, 1024)):
        codes = np.abs(tbl[None, :] - s[:, None]).argmin(axis=1)
        err = np.abs(tbl[codes] - s) * 32768.0
        assert err.max() <= step / 2 + 1e-3, err.max()


def test_g711_wav_decode_mono_and_stereo():
    from audioflow_tpu.io.wav import _MULAW_TABLE

    codes = bytes(range(256))
    data, rate = read_wav(_g711_wav(7, codes))
    assert rate == 8000
    np.testing.assert_array_equal(data, _MULAW_TABLE[np.frombuffer(codes, np.uint8)])
    # stereo interleave -> [n, 2]
    data2, _ = read_wav(_g711_wav(6, codes, ch=2))
    assert data2.shape == (128, 2)


def test_g711_bad_bits_rejected():
    import struct as _s

    buf = b"RIFF" + _s.pack("<I", 36 + 4) + b"WAVE"
    buf += b"fmt " + _s.pack("<IHHIIHH", 16, 7, 1, 8000, 16000, 2, 16)
    buf += b"data" + _s.pack("<I", 4) + b"\x00" * 4
    with pytest.raises(IOError_):
        probe(buf)


@pytest.mark.skipif(not native.available(), reason="native decoder not built")
def test_g711_native_matches_numpy():
    """C++ G.711 tables must be bit-identical to the numpy oracle's, through
    the full decode path (incl. stereo channel averaging)."""
    codes = bytes(range(256)) * 2
    for tag in (6, 7):
        for ch in (1, 2):
            buf = _g711_wav(tag, codes, ch=ch)
            want, _ = read_wav(buf)
            if want.ndim == 2:
                want = want.mean(axis=1)
            out, frames, rates = native.decode_batch_mono([buf], stride=len(want))
            assert frames[0] == len(want) and rates[0] == 8000
            np.testing.assert_array_equal(out[0, : len(want)], want.astype(np.float32))
    # G.711 at 16 bits must be rejected by the native probe too
    import struct as _s

    bad = b"RIFF" + _s.pack("<I", 40) + b"WAVE"
    bad += b"fmt " + _s.pack("<IHHIIHH", 16, 6, 1, 8000, 16000, 2, 16)
    bad += b"data" + _s.pack("<I", 4) + b"\x00" * 4
    _, frames, _ = native.decode_batch_mono([bad], stride=64)
    assert frames[0] == -1


def test_aiff_round_trip_and_dispatch(tmp_path, rng):
    """AIFF PCM16 write/read round trip; read_audio dispatches on FORM."""
    from audioflow_tpu.io import read_aiff, read_audio, write_aiff

    x = (0.5 * np.sin(2 * np.pi * 440 * np.arange(8000) / 16000)).astype(np.float32)
    p = tmp_path / "t.aiff"
    write_aiff(p, x, 16000)
    y, rate = read_aiff(p)
    assert rate == 16000
    np.testing.assert_allclose(y, np.trunc(np.clip(x, -1, 1) * 32767) / 32768.0, atol=1e-7)
    y2, rate2 = read_audio(p)
    np.testing.assert_array_equal(y2, y)
    # stereo
    st = np.stack([x[:100], -x[:100]], axis=1)
    write_aiff(tmp_path / "s.aiff", st, 44100)
    ys, rs = read_audio(tmp_path / "s.aiff")
    assert rs == 44100 and ys.shape == (100, 2)


def test_aiff_extended_float_rates():
    """The 80-bit extended sample rate survives odd rates exactly."""
    from audioflow_tpu.io.aiff import _read_extended, _write_extended

    for rate in (8000.0, 11025.0, 22050.0, 44100.0, 48000.0, 96000.0, 192000.0):
        assert _read_extended(_write_extended(rate)) == rate


def test_aifc_variants(rng):
    """AIFF-C: 'sowt' little-endian 16 and 'fl32' float payloads."""
    import struct as _s

    from audioflow_tpu.io.aiff import _write_extended, read_aiff

    x = (rng.standard_normal(64) * 0.4).astype(np.float32)

    def aifc(comp, payload, bits):
        comm = _s.pack(">hIh", 1, 64, bits) + _write_extended(16000.0) + comp + b"\x00\x00"
        ssnd = _s.pack(">II", 0, 0) + payload
        body = b"AIFC"
        body += b"COMM" + _s.pack(">I", len(comm)) + comm
        body += b"SSND" + _s.pack(">I", len(ssnd)) + ssnd
        return b"FORM" + _s.pack(">I", len(body)) + body

    q = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    y, r = read_aiff(aifc(b"sowt", q.astype("<i2").tobytes(), 16))
    np.testing.assert_allclose(y, q / 32768.0, atol=1e-7)
    y2, _ = read_aiff(aifc(b"fl32", x.astype(">f4").tobytes(), 32))
    np.testing.assert_allclose(y2, x, atol=1e-7)
    # unknown compression is a typed error
    with pytest.raises(IOError_):
        read_aiff(aifc(b"ulaw", q.astype(">i2").tobytes(), 16))


def test_aiff_signed_8bit_and_24bit(rng):
    import struct as _s

    from audioflow_tpu.io.aiff import _write_extended, read_aiff

    def aiff(payload, bits, n):
        comm = _s.pack(">hIh", 1, n, bits) + _write_extended(8000.0)
        ssnd = _s.pack(">II", 0, 0) + payload
        body = b"AIFF"
        body += b"COMM" + _s.pack(">I", len(comm)) + comm
        body += b"SSND" + _s.pack(">I", len(ssnd)) + ssnd
        return b"FORM" + _s.pack(">I", len(body)) + body

    codes = np.arange(-128, 128, dtype=np.int8)
    y, _ = read_aiff(aiff(codes.tobytes(), 8, 256))
    np.testing.assert_allclose(y, codes / 128.0, atol=1e-7)  # signed, not offset
    v = np.array([-8388608, -1, 0, 1, 8388607], dtype=np.int32)
    raw = bytes()
    for s32 in v:
        raw += int(s32 & 0xFFFFFF).to_bytes(3, "big")
    y24, _ = read_aiff(aiff(raw, 24, 5))
    np.testing.assert_allclose(y24, v / 8388608.0, atol=1e-7)


def test_aiff_garbage_and_truncated():
    from audioflow_tpu.io.aiff import probe as aprobe

    with pytest.raises(IOError_):
        aprobe(b"FORMxxxxWAVE")
    with pytest.raises(IOError_):
        aprobe(b"RIFF1234WAVE")
    # decode_batch lane isolation for broken AIFFs
    from audioflow_tpu.io import decode_batch

    batch = decode_batch([b"FORM\x00\x00\x00\x04AIFF"], use_native=False)
    assert not batch.valid[0]


@pytest.mark.skipif(not native.available(), reason="native decoder not built")
def test_aiff_native_matches_numpy(tmp_path, rng):
    """C++ AIFF decode must match the numpy oracle bit-for-bit across PCM16
    files and the AIFC variants, and reject what the oracle rejects."""
    import struct as _s

    from audioflow_tpu.io import read_audio, write_aiff
    from audioflow_tpu.io.aiff import _write_extended

    x = (rng.standard_normal((300, 2)) * 0.4).astype(np.float32)
    p = tmp_path / "n.aiff"
    write_aiff(p, x, 22050)
    want, _ = read_audio(p)
    want_mono = want.mean(axis=1).astype(np.float32)
    buf = p.read_bytes()
    out, frames, rates = native.decode_batch_mono([buf], stride=400)
    assert frames[0] == 300 and rates[0] == 22050
    np.testing.assert_allclose(out[0, :300], want_mono, atol=1e-7)

    def aifc(comp, payload, bits, n):
        comm = _s.pack(">hIh", 1, n, bits) + _write_extended(16000.0) + comp + b"\x00\x00"
        ssnd = _s.pack(">II", 0, 0) + payload
        body = b"AIFC"
        body += b"COMM" + _s.pack(">I", len(comm)) + comm
        body += b"SSND" + _s.pack(">I", len(ssnd)) + ssnd
        return b"FORM" + _s.pack(">I", len(body)) + body

    mono = x[:64, 0]
    q = (np.clip(mono, -1, 1) * 32767).astype(np.int16)
    for comp, payload, bits in [
        (b"sowt", q.astype("<i2").tobytes(), 16),
        (b"fl32", mono.astype(">f4").tobytes(), 32),
        (b"NONE", q.astype(">i2").tobytes(), 16),
    ]:
        b = aifc(comp, payload, bits, 64)
        want, _ = read_audio(b)
        out, frames, rates = native.decode_batch_mono([b], stride=64)
        assert frames[0] == 64 and rates[0] == 16000, comp
        np.testing.assert_array_equal(out[0], want.astype(np.float32))
    # unsupported compression rejected by both
    bad = aifc(b"ulaw", q.astype(">i2").tobytes(), 16, 64)
    with pytest.raises(IOError_):
        read_audio(bad)
    _, frames, _ = native.decode_batch_mono([bad], stride=64)
    assert frames[0] == -1


def test_probe_fuzz_random_bytes_raise_typed_only(rng):
    """Decoder contract (SURVEY §5.3): arbitrary garbage — random bytes,
    truncations of valid files, bit-flipped headers — must raise IOError_
    (or decode), never a raw struct/ValueError/IndexError that would break
    per-lane fault isolation."""
    from audioflow_tpu.io import probe_audio, read_audio, write_aiff

    seeds = []
    # random garbage, some with valid magics
    for n in (0, 3, 12, 40, 200):
        seeds.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    for magic in (b"RIFF", b"FORM", b"fLaC"):
        for n in (4, 8, 16, 64):
            seeds.append(magic + rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    # valid files, truncated at every interesting boundary + bit-flipped
    x = (0.3 * np.sin(2 * np.pi * 440 * np.arange(400) / 16000)).astype(np.float32)
    write_wav("/tmp/fuzz.wav", x, 16000)
    import pathlib

    wav_bytes = pathlib.Path("/tmp/fuzz.wav").read_bytes()
    write_aiff("/tmp/fuzz.aiff", x, 16000)
    aiff_bytes = pathlib.Path("/tmp/fuzz.aiff").read_bytes()
    from audioflow_tpu.io import write_flac

    write_flac("/tmp/fuzz.flac", x, 16000)
    flac_bytes = pathlib.Path("/tmp/fuzz.flac").read_bytes()
    for valid in (wav_bytes, aiff_bytes, flac_bytes):
        for cut in (5, 11, 13, 21, 45, len(valid) // 2, len(valid) - 3):
            seeds.append(valid[: max(0, cut)])
        for flip in range(4, min(len(valid), 64), 7):
            b = bytearray(valid)
            b[flip] ^= 0xFF
            seeds.append(bytes(b))
    decoded = failed = 0
    for buf in seeds:
        for fn in (probe_audio, read_audio):
            try:
                fn(buf)
                decoded += 1
            except IOError_:
                failed += 1
            # anything else propagates and fails the test
    assert failed > 20  # the fuzz actually exercised the error paths
