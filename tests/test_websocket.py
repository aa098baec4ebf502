"""WebSocket client tests against an in-process loopback server — the fake
ASR backend the reference never had (SURVEY §4: no network tests hit a live
server)."""

import base64
import hashlib
import json
import socket
import struct
import threading

import numpy as np
import pytest

from audioflow_tpu.errors import ErrorCode, IOError_
from audioflow_tpu.sinks.websocket import (
    ConnectionState,
    Opcode,
    WebSocketClient,
    WebSocketConfig,
)

_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


class FakeWsServer(threading.Thread):
    """Single-connection RFC6455 server: handshake, echo-with-prefix, ping."""

    def __init__(self, reject_401=False, require_key=None):
        super().__init__(daemon=True)
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.reject_401 = reject_401
        self.require_key = require_key
        self.request_line = ""
        self.headers = {}
        self.received: list = []

    def run(self):
        conn, _ = self.sock.accept()
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += conn.recv(4096)
        head = buf.split(b"\r\n\r\n", 1)[0].decode()
        lines = head.split("\r\n")
        self.request_line = lines[0]
        self.headers = {
            k.strip().lower(): v.strip()
            for k, _, v in (ln.partition(":") for ln in lines[1:])
        }
        if self.reject_401 or (
            self.require_key and f"xi_api_key={self.require_key}" not in self.request_line
        ):
            conn.sendall(b"HTTP/1.1 401 Unauthorized\r\n\r\n")
            conn.close()
            return
        key = self.headers["sec-websocket-key"]
        accept = base64.b64encode(hashlib.sha1((key + _MAGIC).encode()).digest()).decode()
        conn.sendall(
            (
                "HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: {accept}\r\n\r\n"
            ).encode()
        )
        # send a ping first (client must answer transparently)
        conn.sendall(bytes([0x80 | 0x9, 2]) + b"hi")
        # then echo each text frame back prefixed with "ack:"
        for _ in range(10):
            hdr = self._read_exact(conn, 2)
            if not hdr:
                break
            b0, b1 = hdr
            op = b0 & 0xF
            n = b1 & 0x7F
            if n == 126:
                (n,) = struct.unpack(">H", self._read_exact(conn, 2))
            elif n == 127:
                (n,) = struct.unpack(">Q", self._read_exact(conn, 8))
            mask = self._read_exact(conn, 4) if b1 & 0x80 else b""
            payload = self._read_exact(conn, n)
            if mask:
                payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
            if op == 0x8:
                break
            if op == 0xA:  # pong
                self.received.append(("pong", payload))
                continue
            self.received.append(("text" if op == 0x1 else "bin", payload))
            reply = b"ack:" + payload
            conn.sendall(bytes([0x80 | op]) + self._len_hdr(len(reply)) + reply)
        conn.close()

    @staticmethod
    def _len_hdr(n):
        if n < 126:
            return bytes([n])
        return bytes([126]) + struct.pack(">H", n)

    @staticmethod
    def _read_exact(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return buf
            buf += chunk
        return buf


def _client(port, **kw):
    return WebSocketClient(
        WebSocketConfig(url=f"ws://127.0.0.1:{port}/v1/scribe", connect_timeout_s=5.0, **kw)
    )


def test_handshake_auth_and_echo():
    srv = FakeWsServer(require_key="sk-test")
    srv.start()
    c = _client(srv.port, api_key="sk-test", origin="https://example.org")
    c.connect()
    assert c.state is ConnectionState.CONNECTED
    c.send_text("hello")
    msg = c.receive(timeout=5.0)
    assert msg.opcode is Opcode.TEXT and msg.text == "ack:hello"
    c.close()
    assert c.state is ConnectionState.DISCONNECTED
    srv.join(timeout=3)  # let the server drain the pong + close frames
    # query-param auth + Origin header parity (websocket.rs:156-162)
    assert "xi_api_key=sk-test" in srv.request_line
    assert srv.headers["origin"] == "https://example.org"
    # the server's ping was answered with a pong transparently
    assert ("pong", b"hi") in srv.received


def test_401_authentication_failed():
    srv = FakeWsServer(reject_401=True)
    srv.start()
    c = _client(srv.port)
    with pytest.raises(IOError_) as ei:
        c.connect()
    assert ei.value.code is ErrorCode.AUTHENTICATION_FAILED
    assert c.state is ConnectionState.FAILED


def test_send_audio_wire_shape():
    srv = FakeWsServer()
    srv.start()
    c = _client(srv.port)
    c.connect()
    c.send_audio(np.array([0.5, -1.5], np.float32))
    echo = c.receive(timeout=5.0)
    obj = json.loads(echo.text[4:])
    assert obj["message_type"] == "input_audio_chunk"
    raw = base64.standard_b64decode(obj["audio_base_64"])
    assert raw == np.array([16383, -32767], "<i2").tobytes()
    c.send_init_config("scribe_v1", "en")
    cfg = json.loads(c.receive(timeout=5.0).text[4:])
    assert cfg["encoding"] == "pcm_16000" and cfg["message_type"] == "configure"
    c.close()


def test_connect_refused_then_retry_succeeds():
    """The reconnect loop the reference never implemented (SURVEY §5.3)."""
    srv = FakeWsServer()
    port = srv.port

    # start the server only after a short delay; first attempts fail
    def delayed():
        import time

        time.sleep(0.35)
        srv.start()

    threading.Thread(target=delayed, daemon=True).start()
    c = WebSocketClient(
        WebSocketConfig(
            url=f"ws://127.0.0.1:{port}/", connect_timeout_s=2.0,
            reconnect_delay_ms=200, max_reconnect_attempts=5,
        )
    )
    c.connect_with_retry()
    assert c.state is ConnectionState.CONNECTED
    c.close()


def test_retry_gives_up():
    c = WebSocketClient(
        WebSocketConfig(
            url="ws://127.0.0.1:9/", connect_timeout_s=0.3,
            reconnect_delay_ms=10, max_reconnect_attempts=2,
        )
    )
    with pytest.raises(IOError_):
        c.connect_with_retry()
    assert c.state is ConnectionState.FAILED


def test_retry_zero_attempts_falls_back_to_single_connect():
    """Regression: max_reconnect_attempts=0 used to raise a bare
    AssertionError from an empty loop; now it degenerates to one connect()."""
    c = WebSocketClient(
        WebSocketConfig(
            url="ws://127.0.0.1:9/", connect_timeout_s=0.3,
            reconnect_delay_ms=10, max_reconnect_attempts=0,
        )
    )
    with pytest.raises(IOError_):
        c.connect_with_retry()


def test_send_without_connect_raises():
    c = WebSocketClient()
    with pytest.raises(IOError_):
        c.send_text("nope")


class FakeScribeServer(FakeWsServer):
    """Replies like the ASR service: session_started, then a partial and a
    committed transcript after the first audio chunk."""

    def run(self):
        import base64 as b64, hashlib as hl

        conn, _ = self.sock.accept()
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += conn.recv(4096)
        head = buf.split(b"\r\n\r\n", 1)[0].decode()
        lines = head.split("\r\n")
        self.request_line = lines[0]
        self.headers = {
            k.strip().lower(): v.strip() for k, _, v in (ln.partition(":") for ln in lines[1:])
        }
        key = self.headers["sec-websocket-key"]
        accept = b64.b64encode(hl.sha1((key + _MAGIC).encode()).digest()).decode()
        conn.sendall(
            (
                "HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                f"Connection: Upgrade\r\nSec-WebSocket-Accept: {accept}\r\n\r\n"
            ).encode()
        )

        def send_text(obj):
            payload = json.dumps(obj).encode()
            conn.sendall(bytes([0x81]) + self._len_hdr(len(payload)) + payload)

        send_text({"message_type": "session_started", "session_id": "fake-1"})
        got_audio = 0
        for _ in range(200):
            hdr = self._read_exact(conn, 2)
            if len(hdr) < 2:
                break
            b0, b1 = hdr
            op = b0 & 0xF
            n = b1 & 0x7F
            if n == 126:
                (n,) = struct.unpack(">H", self._read_exact(conn, 2))
            mask = self._read_exact(conn, 4) if b1 & 0x80 else b""
            payload = self._read_exact(conn, n)
            if mask:
                payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
            if op == 0x8:
                break
            try:
                obj = json.loads(payload)
            except Exception:
                continue
            self.received.append((obj.get("message_type"), len(payload)))
            if obj.get("message_type") == "input_audio_chunk":
                got_audio += 1
                if got_audio == 1:
                    send_text({"message_type": "partial_transcript", "text": "turn on"})
                elif got_audio == 3:
                    send_text(
                        {
                            "message_type": "committed_transcript",
                            "text": "【SPEECH_CHANGE】turn on the lights【SILENCE】",
                            "confidence": 0.95,
                        }
                    )
        conn.close()


def test_cli_egress_end_to_end(tmp_path, capsys, monkeypatch):
    """commands.rs connect_scribe/send_audio/receive_transcription parity,
    end to end over a real socket."""
    import numpy as np

    from audioflow_tpu.cli import main as cli_main
    from audioflow_tpu.io import write_wav

    rate = 16000
    t = np.arange(rate) / rate
    wav = tmp_path / "say.wav"
    write_wav(wav, (0.4 * np.sin(2 * np.pi * 300 * t)).astype(np.float32), rate)
    srv = FakeScribeServer(require_key=None)
    srv.start()
    rc = cli_main(
        ["egress", "-i", str(wav), "--url", f"ws://127.0.0.1:{srv.port}/v1/scribe",
         "--api-key", "sk-cli", "--receive-timeout", "3.0"]
    )
    assert rc == 0
    out_lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    finals = [o for o in out_lines if o.get("is_final")]
    assert finals and finals[0]["text"] == "turn on the lights"  # markers stripped
    summary = out_lines[-1]
    assert summary["chunks_sent"] == 5 and summary["results"] >= 2
    srv.join(3)
    assert ("configure", srv.received[0][1]) == srv.received[0] or srv.received[0][0] == "configure"


def test_cli_key_roundtrip(tmp_path, capsys):
    from audioflow_tpu.cli import main as cli_main

    f = str(tmp_path / "sec.json")
    assert cli_main(["key", "set", "elevenlabs", "sk-42", "--file", f]) == 0
    capsys.readouterr()
    assert cli_main(["key", "get", "elevenlabs", "--file", f]) == 0
    assert capsys.readouterr().out.strip() == "sk-42"
    assert cli_main(["key", "delete", "elevenlabs", "--file", f]) == 0
