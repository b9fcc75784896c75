"""The port's WebSocket transport (``tiny_audio_tpu_torch/utils/websocket.py``).

The frame codec at every length class, fragmentation, the close handshake
with its code, the refusals (an unmasked client frame, a message over
``MAX_SIZE``, text that is not UTF-8), ping -> pong, sends from two threads
never interleaving, and ``shutdown()`` ending ``serve_forever`` with a
session open.  Interoperation: the port's server driven by
``websockets.sync.client`` and by ``websocket-client``, and the port's client
against a ``websockets.sync.server``.
"""

import base64
import json
import os
import socket
import struct
import threading
import time

import pytest

from tiny_audio_tpu_torch.utils import websocket as ws_mod
from tiny_audio_tpu_torch.utils.websocket import (
    ConnectionClosed,
    ConnectionClosedError,
    ConnectionClosedOK,
    ProtocolError,
    accept_key,
    connect,
    encode_frame,
    parse_frame,
    serve,
)

MASK = b"\x37\xfa\x21\x3d"


def test_accept_key_rfc_example():
    # RFC 6455 section 1.3
    assert accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def test_rfc_masked_hello():
    # RFC 6455 section 5.7: a single-frame masked text message "Hello"
    frame = encode_frame(ws_mod.OP_TEXT, b"Hello", mask=MASK)
    assert frame == bytes.fromhex("818537fa213d7f9f4d5158")
    (fin, op, payload, masked), used = parse_frame(frame)
    assert (fin, op, payload, masked, used) == (True, ws_mod.OP_TEXT, b"Hello", True, 11)


@pytest.mark.parametrize("n,head", [(0, 2), (125, 2), (126, 4), (65535, 4), (65536, 10),
                                    (70000, 10)])
@pytest.mark.parametrize("mask", [None, MASK])
def test_codec_length_classes(n, head, mask):
    payload = os.urandom(n)
    frame = encode_frame(ws_mod.OP_BINARY, payload, mask=mask)
    assert len(frame) == head + (4 if mask else 0) + n
    (fin, op, got, masked), used = parse_frame(frame)
    assert got == payload and used == len(frame) and masked == (mask is not None)
    # every strict prefix is incomplete, not an error
    for cut in sorted({0, 1, head - 1, head, len(frame) - 1}):
        if 0 <= cut < len(frame):
            assert parse_frame(frame[:cut]) is None


def test_codec_refusals():
    with pytest.raises(ProtocolError) as e:
        parse_frame(b"\xc1\x00")  # RSV1 without an extension
    assert e.value.code == 1002
    with pytest.raises(ProtocolError):
        parse_frame(b"\x83\x00")  # opcode 3 is reserved
    with pytest.raises(ProtocolError):
        parse_frame(b"\x09\x00")  # a fragmented ping
    with pytest.raises(ProtocolError):
        parse_frame(encode_frame(ws_mod.OP_PING, b"x" * 126))
    with pytest.raises(ProtocolError) as e:
        parse_frame(encode_frame(ws_mod.OP_BINARY, b"x" * 11), max_size=10)
    assert e.value.code == 1009
    with pytest.raises(ProtocolError):
        parse_frame(b"\x82\x7f" + struct.pack("!Q", 1 << 63))


@pytest.fixture()
def echo_server():
    """The port's server echoing every message; "path" answers the request
    target, "headers" the request headers as JSON."""
    def handler(ws):
        for msg in ws:
            if msg == "path":
                ws.send(ws.request.path)
            elif msg == "headers":
                ws.send(json.dumps(ws.request.headers))
            elif msg == "close4000":
                ws.close(4000, "asked")
                return
            else:
                ws.send(msg)

    server = serve(handler, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.shutdown()
    thread.join(5)


def _port(server):
    return server.socket.getsockname()[1]


class RawClient:
    """A client speaking frames by hand, to send what no library sends."""

    def __init__(self, port, path="/"):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET {path} HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                           f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                           "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            head += self.sock.recv(1)
        assert head.startswith(b"HTTP/1.1 101") and accept_key(key).encode() in head
        self.buf = bytearray()

    def send(self, frame: bytes):
        self.sock.sendall(frame)

    def frame(self):
        while True:
            parsed = parse_frame(self.buf)
            if parsed is not None:
                frame, used = parsed
                del self.buf[:used]
                return frame
            data = self.sock.recv(65536)
            if not data:
                return None
            self.buf += data


def test_fragmented_message_and_ping_pong(echo_server):
    raw = RawClient(_port(echo_server))
    raw.send(encode_frame(ws_mod.OP_TEXT, b"hel", fin=False, mask=MASK))
    raw.send(encode_frame(ws_mod.OP_PING, b"beat", mask=MASK))  # between fragments
    raw.send(encode_frame(ws_mod.OP_CONT, b"lo ", fin=False, mask=MASK))
    raw.send(encode_frame(ws_mod.OP_CONT, "wörld".encode(), mask=MASK))
    assert raw.frame() == (True, ws_mod.OP_PONG, b"beat", False)
    assert raw.frame() == (True, ws_mod.OP_TEXT, "hello wörld".encode(), False)
    raw.send(encode_frame(ws_mod.OP_CLOSE, struct.pack("!H", 1000) + b"bye", mask=MASK))
    fin, op, payload, _ = raw.frame()
    assert op == ws_mod.OP_CLOSE and struct.unpack("!H", payload[:2])[0] == 1000
    assert raw.frame() is None  # the server ends the TCP connection


@pytest.mark.parametrize("frame,code", [
    (encode_frame(ws_mod.OP_TEXT, b"unmasked"), 1002),
    (encode_frame(ws_mod.OP_BINARY, b"x" * (ws_mod.MAX_SIZE + 1), mask=MASK), 1009),
    (encode_frame(ws_mod.OP_TEXT, b"\xff\xfe", mask=MASK), 1007),
    (encode_frame(ws_mod.OP_CONT, b"x", mask=MASK), 1002),
])
def test_server_refuses_with_close_code(echo_server, frame, code):
    raw = RawClient(_port(echo_server))
    raw.send(frame)
    fin, op, payload, masked = raw.frame()
    assert op == ws_mod.OP_CLOSE and not masked
    assert struct.unpack("!H", payload[:2])[0] == code
    assert raw.frame() is None


def test_fragments_over_max_size_refused(echo_server):
    raw = RawClient(_port(echo_server))
    part = b"x" * (ws_mod.MAX_SIZE // 2)
    raw.send(encode_frame(ws_mod.OP_BINARY, part, fin=False, mask=MASK))
    raw.send(encode_frame(ws_mod.OP_CONT, part + b"y", mask=MASK))
    fin, op, payload, _ = raw.frame()
    assert op == ws_mod.OP_CLOSE and struct.unpack("!H", payload[:2])[0] == 1009


def test_port_client_round_trip_and_close_code(echo_server):
    port = _port(echo_server)
    with connect(f"ws://127.0.0.1:{port}/ws?sample_rate=8000",
                 additional_headers={"Authorization": "key"}) as ws:
        for msg in ("text", b"\x00\x01", "é" * 40000, os.urandom(70000)):
            ws.send(msg)
            assert ws.recv(timeout=5) == msg
        ws.send("path")
        assert ws.recv(timeout=5) == "/ws?sample_rate=8000"
        ws.send("headers")
        assert json.loads(ws.recv(timeout=5))["authorization"] == "key"
        with pytest.raises(TimeoutError):
            ws.recv(timeout=0.05)
        ws.send("close4000")
        with pytest.raises(ConnectionClosedError) as e:
            ws.recv(timeout=5)
        assert (e.value.code, e.value.reason) == (4000, "asked")
        with pytest.raises(ConnectionClosed):
            ws.send("after close")


def test_client_iteration_ends_on_normal_close(echo_server):
    def server_side(ws):
        ws.send("one")
        ws.send(b"two")

    server = serve(server_side, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        with connect(f"ws://127.0.0.1:{_port(server)}/") as ws:
            assert list(ws) == ["one", b"two"]
            assert ws.close_code == 1000
    finally:
        server.shutdown()


def test_concurrent_sends_never_interleave(echo_server):
    got = []

    def handler(ws):
        for msg in ws:
            got.append(msg)
            if len(got) == 400:
                ws.send("done")

    server = serve(handler, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        with connect(f"ws://127.0.0.1:{_port(server)}/") as ws:
            def blast(tag):
                for i in range(200):
                    ws.send(bytes([tag]) * (1000 + 37 * i))  # 16-bit lengths, many frames

            threads = [threading.Thread(target=blast, args=(t,)) for t in (1, 2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert ws.recv(timeout=10) == "done"
    finally:
        server.shutdown()
    assert len(got) == 400
    for msg in got:  # each message whole: one tag byte throughout
        assert len(set(msg)) == 1
    for tag in (1, 2):
        assert sorted(len(m) for m in got if m[0] == tag) == [1000 + 37 * i for i in range(200)]


def test_shutdown_ends_serve_forever_with_a_session_open():
    entered = threading.Event()

    def handler(ws):
        entered.set()
        for _ in ws:
            pass

    server = serve(handler, "127.0.0.1", 0)
    port = _port(server)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    ws = connect(f"ws://127.0.0.1:{port}/")
    assert entered.wait(5)
    t0 = time.monotonic()
    server.shutdown()
    thread.join(5)
    assert not thread.is_alive() and time.monotonic() - t0 < 5
    with pytest.raises(ConnectionClosedOK) as e:
        ws.recv(timeout=5)
    assert e.value.code == 1001
    ws.close()
    with pytest.raises(OSError):  # the listening socket is gone
        socket.create_connection(("127.0.0.1", port), timeout=1)


def test_shutdown_before_serve_forever_returns():
    server = serve(lambda ws: None, "127.0.0.1", 0)
    server.shutdown()
    server.serve_forever()  # returns at once: the server is closed


class _ClosedSocket:
    """A peer that hangs up before its handshake."""

    def settimeout(self, t):
        pass

    def recv(self, n):
        return b""


def test_bad_handshakes_are_refused(echo_server):
    port = _port(echo_server)
    key = base64.b64encode(os.urandom(16))
    for request, status in ((b"GET / HTTP/1.1\r\nHost: x\r\n\r\n", b"400"),
                            (b"GET / HTTP/1.1\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                             b"Sec-WebSocket-Key: " + key +
                             b"\r\nSec-WebSocket-Version: 8\r\n\r\n", b"426")):
        with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
            s.sendall(request)
            assert s.recv(100).split(b" ")[1] == status
    with pytest.raises(ws_mod.InvalidHandshake):
        ws_mod._server_handshake(_ClosedSocket())


# ------------------------------------------------------------ the libraries


def test_websockets_client_drives_port_server(echo_server):
    sync_client = pytest.importorskip("websockets.sync.client")
    port = _port(echo_server)
    with sync_client.connect(f"ws://127.0.0.1:{port}/ws?a=1", ping_interval=None,
                             max_size=None) as ws:
        for msg in ("hi", b"\x00\xff", "x" * 200, os.urandom(70000)):
            ws.send(msg)
            assert ws.recv(timeout=5) == msg
        ws.send(["frag", "mented ", "text"])  # websockets sends a list as fragments
        assert ws.recv(timeout=5) == "fragmented text"
        ws.send("path")
        assert ws.recv(timeout=5) == "/ws?a=1"
        assert ws.ping(b"abc").wait(5)
        ws.send("close4000")
        with pytest.raises(Exception) as e:
            ws.recv(timeout=5)
        assert getattr(e.value, "rcvd", None) is not None and e.value.rcvd.code == 4000


def test_websocket_client_drives_port_server(echo_server):
    websocket = pytest.importorskip("websocket")
    port = _port(echo_server)
    conn = websocket.create_connection(f"ws://127.0.0.1:{port}/ws",
                                       header={"Authorization": "k"}, timeout=5)
    try:
        conn.send_binary(b"abc")
        assert conn.recv() == b"abc"
        conn.send("text")
        assert conn.recv() == "text"
        conn.send_binary(os.urandom(70000))
        assert len(conn.recv()) == 70000
        conn.ping("p")
        conn.send("headers")
        assert json.loads(conn.recv())["authorization"] == "k"
        conn.settimeout(0.05)
        with pytest.raises(websocket.WebSocketTimeoutException):
            conn.recv()
    finally:
        conn.close()


def test_port_client_against_websockets_server():
    sync_server = pytest.importorskip("websockets.sync.server")
    seen = {}

    def handler(ws):
        seen["path"] = ws.request.path
        seen["auth"] = ws.request.headers.get("Authorization")
        for msg in ws:
            if msg == "ping me":
                ws.ping(b"srv")
            ws.send(msg)
        seen["closed"] = True

    server = sync_server.serve(handler, "127.0.0.1", 0, ping_interval=None, max_size=None)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        port = server.socket.getsockname()[1]
        with connect(f"ws://127.0.0.1:{port}/v3/ws?sample_rate=16000",
                     additional_headers={"Authorization": "token"}) as ws:
            for msg in ("a", b"b" * 100000, "c" * 300, b""):
                ws.send(msg)
                assert ws.recv(timeout=5) == msg
            ws.send("ping me")  # the server's ping is answered on the way
            assert ws.recv(timeout=5) == "ping me"
        deadline = time.monotonic() + 5
        while "closed" not in seen and time.monotonic() < deadline:
            time.sleep(0.01)
        assert seen == {"path": "/v3/ws?sample_rate=16000", "auth": "token", "closed": True}
    finally:
        server.shutdown()


def test_port_client_sees_websockets_server_close_code():
    sync_server = pytest.importorskip("websockets.sync.server")

    def handler(ws):
        ws.recv()
        ws.close(4001, "bye")

    server = sync_server.serve(handler, "127.0.0.1", 0, ping_interval=None)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        with connect(f"ws://127.0.0.1:{server.socket.getsockname()[1]}/") as ws:
            ws.send("x")
            with pytest.raises(ConnectionClosedError) as e:
                ws.recv(timeout=5)
            assert (e.value.code, e.value.reason) == (4001, "bye")
    finally:
        server.shutdown()
