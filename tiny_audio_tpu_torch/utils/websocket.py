"""A synchronous WebSocket (RFC 6455) server and client on the standard library.

The realtime server and the eval harness's streaming clients speak WebSocket;
the JAX package reaches it through ``websockets.sync`` and ``websocket-client``.
The port carries its own transport instead, built on ``socket``, ``hashlib``
and ``base64`` (``ssl`` only for a client's ``wss://`` URL), and offers the
subset of ``websockets.sync`` that those callers use:

- :func:`serve` ``(handler, host, port)`` -> :class:`Server` with
  ``serve_forever()``, ``shutdown()`` and ``.socket``; ``handler(ws)`` runs on
  a thread of its own per connection;
- a :class:`Connection` iterates over messages (``str`` for text frames,
  ``bytes`` for binary ones), ``send(str | bytes)``, ``recv(timeout=...)``
  (``TimeoutError`` when nothing complete arrived in time), ``close()``,
  ``request.path`` (the request target with its query string) and
  ``request.headers``;
- :func:`connect` ``(url, additional_headers=None)`` -> a client
  :class:`Connection`, usable as a context manager.

The protocol as it is kept here: the ``Sec-WebSocket-Accept`` handshake (no
extension and no subprotocol is accepted); client frames masked, and a server
refuses an unmasked one (close 1002); payload lengths of 7, 16 and 64 bits;
fragmented messages reassembled from continuation frames; a ping answered
by a pong with its payload; the close handshake with a status code and
reason; a message larger than ``MAX_SIZE`` refused (close 1009); text that
is not UTF-8 refused (close 1007).  Sends take a lock per connection, so
frames sent from several threads never interleave.  Neither side sends a
keepalive ping of its own.  :meth:`Server.shutdown` stops the accept loop
and closes every live connection with 1001.

A refused connection (1002, 1007, 1009) fails as RFC 6455 section 7.1.7 and
``websockets`` fail it: the close frame goes out, a server then half-closes
its side so that the peer reads EOF right after the frame, and no further
frame is parsed.  ``recv`` raises :class:`ConnectionClosedError` at once;
``close()`` (which the server calls when the handler returns) discards what
the peer still sends, up to its EOF or ``CLOSE_TIMEOUT``, and only then
releases the socket.  A socket closed over unread bytes would answer the
peer's next segments with a TCP reset, and a peer still sending would see
its send fail instead of the close code.  A handler that raises closes with
1011 the same way, through ``close()``.
"""

from __future__ import annotations

import base64
import hashlib
import logging
import os
import selectors
import socket
import struct
import threading
import time
from typing import Callable, Iterator, Optional, Union
from urllib.parse import urlparse

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA
_DATA_OPS = (OP_CONT, OP_TEXT, OP_BINARY)
_CONTROL_OPS = (OP_CLOSE, OP_PING, OP_PONG)

#: the largest message accepted, as ``websockets``' default ``max_size``
MAX_SIZE = 2**20
#: seconds a closing side waits for the peer's close frame
CLOSE_TIMEOUT = 10.0
#: the largest HTTP head of a handshake
MAX_HEAD = 64 * 1024
#: the longest single wait of a reader before it looks at the closed flag
POLL_S = 0.25

CLOSE_NORMAL, CLOSE_GOING_AWAY, CLOSE_PROTOCOL_ERROR = 1000, 1001, 1002
CLOSE_NO_STATUS, CLOSE_ABNORMAL, CLOSE_INVALID_DATA = 1005, 1006, 1007
CLOSE_TOO_BIG, CLOSE_INTERNAL_ERROR = 1009, 1011


class ConnectionClosed(Exception):
    """The connection is closed: ``code`` and ``reason`` are the close frame's
    (1006 when the TCP connection ended without one)."""

    def __init__(self, code: int = CLOSE_ABNORMAL, reason: str = ""):
        super().__init__(f"connection closed: {code} {reason}".rstrip())
        self.code = code
        self.reason = reason


class ConnectionClosedOK(ConnectionClosed):
    """Closed with 1000, 1001 or no status: iteration over messages ends."""


class ConnectionClosedError(ConnectionClosed):
    """Closed with an error code, or without a close handshake."""


class InvalidHandshake(Exception):
    """The HTTP upgrade was refused or malformed."""


class ProtocolError(Exception):
    """A frame broke RFC 6455; ``code`` is the close status it earns."""

    def __init__(self, code: int, reason: str):
        super().__init__(reason)
        self.code = code
        self.reason = reason


def _closed(code: int, reason: str = "") -> ConnectionClosed:
    ok = code in (CLOSE_NORMAL, CLOSE_GOING_AWAY, CLOSE_NO_STATUS)
    return (ConnectionClosedOK if ok else ConnectionClosedError)(code, reason)


def accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a ``Sec-WebSocket-Key``."""
    digest = hashlib.sha1((key + GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


# --------------------------------------------------------------- frame codec


def _apply_mask(payload: bytes, mask: bytes) -> bytes:
    """XOR ``payload`` with the repeated 4-byte ``mask`` (its own inverse)."""
    if not payload:
        return b""
    n = len(payload)
    key = int.from_bytes((mask * (n // 4 + 1))[:n], "little")
    return (int.from_bytes(payload, "little") ^ key).to_bytes(n, "little")


def encode_frame(opcode: int, payload: bytes = b"", fin: bool = True,
                 mask: Optional[bytes] = None) -> bytes:
    """One frame: ``mask`` (4 bytes) for a client's frame, None for a
    server's.  The length takes 7, 16 or 64 bits as the payload needs."""
    payload = bytes(payload)
    head = bytearray([(0x80 if fin else 0) | opcode])
    bit = 0x80 if mask is not None else 0
    n = len(payload)
    if n < 126:
        head.append(bit | n)
    elif n < 1 << 16:
        head.append(bit | 126)
        head += struct.pack("!H", n)
    else:
        head.append(bit | 127)
        head += struct.pack("!Q", n)
    if mask is None:
        return bytes(head) + payload
    return bytes(head) + mask + _apply_mask(payload, mask)


def parse_frame(buf: Union[bytes, bytearray], max_size: Optional[int] = None):
    """The first frame of ``buf`` as ``((fin, opcode, payload, masked),
    consumed)``, or None while it is incomplete.  Raises
    :class:`ProtocolError` on reserved bits, an unknown opcode, a control
    frame that is fragmented or longer than 125 bytes, a 64-bit length with
    its top bit set, or a payload over ``max_size`` (checked on the header,
    before the payload is read)."""
    if len(buf) < 2:
        return None
    b0, b1 = buf[0], buf[1]
    fin, opcode = bool(b0 & 0x80), b0 & 0x0F
    if b0 & 0x70:
        raise ProtocolError(CLOSE_PROTOCOL_ERROR, "reserved bits set")
    if opcode not in _DATA_OPS + _CONTROL_OPS:
        raise ProtocolError(CLOSE_PROTOCOL_ERROR, f"unknown opcode {opcode}")
    masked, n = bool(b1 & 0x80), b1 & 0x7F
    pos = 2
    if n == 126:
        if len(buf) < 4:
            return None
        (n,) = struct.unpack_from("!H", buf, 2)
        pos = 4
    elif n == 127:
        if len(buf) < 10:
            return None
        (n,) = struct.unpack_from("!Q", buf, 2)
        if n >> 63:
            raise ProtocolError(CLOSE_PROTOCOL_ERROR, "64-bit length with its top bit set")
        pos = 10
    if opcode in _CONTROL_OPS and (n > 125 or not fin):
        raise ProtocolError(CLOSE_PROTOCOL_ERROR, "bad control frame")
    if max_size is not None and opcode in _DATA_OPS and n > max_size:
        raise ProtocolError(CLOSE_TOO_BIG, f"message over {max_size} bytes")
    if masked:
        if len(buf) < pos + 4:
            return None
        mask = bytes(buf[pos:pos + 4])
        pos += 4
    if len(buf) < pos + n:
        return None
    payload = bytes(buf[pos:pos + n])
    if masked:
        payload = _apply_mask(payload, mask)
    return (fin, opcode, payload, masked), pos + n


def close_payload(code: int, reason: str = "") -> bytes:
    if code == CLOSE_NO_STATUS:
        return b""
    return struct.pack("!H", code) + reason.encode("utf-8")[:123]


# ------------------------------------------------------------------ handshake


class Request:
    """The opening handshake's request: ``path`` (the request target, query
    string included) and ``headers`` (lower-case names)."""

    def __init__(self, path: str, headers: dict):
        self.path = path
        self.headers = headers


def _read_head(sock: socket.socket, deadline: Optional[float]) -> tuple[bytes, bytes]:
    """The HTTP head up to its blank line, and the bytes read past it."""
    buf = bytearray()
    while b"\r\n\r\n" not in buf:
        if len(buf) > MAX_HEAD:
            raise InvalidHandshake("handshake head too large")
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise InvalidHandshake("handshake timed out")
            sock.settimeout(remaining)
        try:
            data = sock.recv(4096)
        except socket.timeout:
            raise InvalidHandshake("handshake timed out") from None
        if not data:
            raise InvalidHandshake("connection closed during the handshake")
        buf += data
    sock.settimeout(None)
    head, _, rest = bytes(buf).partition(b"\r\n\r\n")
    return head, rest


def _parse_headers(lines: list) -> dict:
    headers: dict = {}
    for line in lines:
        name, sep, value = line.partition(":")
        if not sep:
            raise InvalidHandshake(f"malformed header line {line!r}")
        name = name.strip().lower()
        value = value.strip()
        headers[name] = f"{headers[name]}, {value}" if name in headers else value
    return headers


def _tokens(value: str) -> set:
    return {t.strip().lower() for t in value.split(",")}


def _server_handshake(sock: socket.socket) -> tuple[Request, bytes]:
    head, rest = _read_head(sock, time.monotonic() + CLOSE_TIMEOUT)
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, target, version = lines[0].split(" ")
    except ValueError:
        raise InvalidHandshake(f"malformed request line {lines[0]!r}") from None
    headers = _parse_headers(lines[1:])
    key = headers.get("sec-websocket-key", "")
    try:
        key_ok = len(base64.b64decode(key, validate=True)) == 16
    except ValueError:
        key_ok = False
    problem = None
    if method != "GET" or not version.startswith("HTTP/1.1"):
        problem = "expected GET ... HTTP/1.1"
    elif "websocket" not in _tokens(headers.get("upgrade", "")):
        problem = "missing Upgrade: websocket"
    elif "upgrade" not in _tokens(headers.get("connection", "")):
        problem = "missing Connection: Upgrade"
    elif not key_ok:
        problem = "missing or malformed Sec-WebSocket-Key"
    elif headers.get("sec-websocket-version") != "13":
        problem = "unsupported Sec-WebSocket-Version"
    if problem is not None:
        body = problem.encode()
        status = "426 Upgrade Required" if "Version" in problem else "400 Bad Request"
        sock.sendall(f"HTTP/1.1 {status}\r\nSec-WebSocket-Version: 13\r\n"
                     f"Content-Type: text/plain\r\nContent-Length: {len(body)}\r\n"
                     f"Connection: close\r\n\r\n".encode() + body)
        raise InvalidHandshake(problem)
    sock.sendall(("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                  "Connection: Upgrade\r\n"
                  f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n").encode())
    return Request(target, headers), rest


# ----------------------------------------------------------------- connection


class Connection:
    """One open WebSocket, either side.  ``send`` may be called from any
    thread; one thread at a time receives."""

    def __init__(self, sock: socket.socket, client: bool, request: Optional[Request] = None,
                 buffered: bytes = b""):
        self.socket = sock
        self.client = client
        self.request = request
        self._buf = bytearray(buffered)
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._selector = selectors.DefaultSelector()
        self._selector.register(sock, selectors.EVENT_READ)
        self._frag_op: Optional[int] = None
        self._frag: list = []
        self._frag_size = 0
        self._close_sent = False
        self._failed = False  # refused: no frame is parsed any more
        self._closed = threading.Event()  # the close handshake ended or the TCP link did
        self.close_code: Optional[int] = None
        self.close_reason = ""
        self._released = False

    # ------------------------------------------------------------------ send

    def send(self, message: Union[str, bytes, bytearray, memoryview]) -> None:
        """A text frame for ``str``, a binary frame for bytes-like."""
        if isinstance(message, str):
            self._send_frame(OP_TEXT, message.encode("utf-8"))
        elif isinstance(message, (bytes, bytearray, memoryview)):
            self._send_frame(OP_BINARY, bytes(message))
        else:
            raise TypeError(f"cannot send {type(message).__name__}")

    def _send_frame(self, opcode: int, payload: bytes) -> None:
        frame = encode_frame(opcode, payload, mask=os.urandom(4) if self.client else None)
        with self._send_lock:
            if self._close_sent or self._closed.is_set():
                raise _closed(self.close_code or CLOSE_ABNORMAL, self.close_reason)
            if opcode == OP_CLOSE:
                self._close_sent = True
            try:
                self.socket.sendall(frame)
            except OSError as e:
                self._lost()
                raise ConnectionClosedError(CLOSE_ABNORMAL, str(e)) from None

    # --------------------------------------------------------------- receive

    def recv(self, timeout: Optional[float] = None) -> Union[str, bytes]:
        """The next whole message.  Pings are answered and pongs dropped on
        the way; a close frame is answered and raises
        :class:`ConnectionClosed`.  ``TimeoutError`` after ``timeout``
        seconds without a whole message (a partial one stays buffered)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._recv_lock:
            while True:
                if self._closed.is_set() or self._failed:
                    raise _closed(self.close_code or CLOSE_ABNORMAL, self.close_reason)
                try:
                    message = self._on_frame(*self._next_frame(deadline))
                except ProtocolError as e:
                    self._fail(e.code, e.reason)
                    raise ConnectionClosedError(e.code, e.reason) from None
                if message is not None:
                    return message

    def __iter__(self) -> Iterator[Union[str, bytes]]:
        """Messages until a normal close; an error close raises."""
        while True:
            try:
                yield self.recv()
            except ConnectionClosedOK:
                return

    def _next_frame(self, deadline: Optional[float]):
        while True:
            parsed = parse_frame(self._buf, MAX_SIZE)
            if parsed is not None:
                frame, used = parsed
                del self._buf[:used]
                return frame
            self._fill(deadline)

    def _fill(self, deadline: Optional[float]) -> None:
        """Read what the socket has into the buffer, waiting at most until
        ``deadline``."""
        data = b""
        if not self._closed.is_set():
            pending = getattr(self.socket, "pending", None)  # an ssl socket's decrypted bytes
            ready = bool(pending and pending())
            while not ready and not self._closed.is_set():
                wait = None if deadline is None else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    raise TimeoutError("no whole message before the timeout")
                # waits are sliced: a release by another thread that lands
                # just before this thread blocks still ends the wait
                try:
                    ready = bool(self._selector.select(min(wait or POLL_S, POLL_S)))
                except (OSError, ValueError, AttributeError, TypeError):
                    ready = True  # released under us: the read below ends it
            try:
                data = self.socket.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                data = b""
        if not data:
            self._lost()
            raise _closed(self.close_code or CLOSE_ABNORMAL, self.close_reason)
        self._buf += data

    def _on_frame(self, fin: bool, opcode: int, payload: bytes, masked: bool):
        if masked == self.client:
            raise ProtocolError(CLOSE_PROTOCOL_ERROR,
                                "masked frame from the server" if self.client
                                else "unmasked frame from the client")
        if opcode == OP_PING:
            try:
                self._send_frame(OP_PONG, payload)
            except ConnectionClosed:
                pass
            return None
        if opcode == OP_PONG:
            return None
        if opcode == OP_CLOSE:
            self._on_close(payload)
        if opcode == OP_CONT:
            if self._frag_op is None:
                raise ProtocolError(CLOSE_PROTOCOL_ERROR, "continuation without a start")
        elif self._frag_op is not None:
            raise ProtocolError(CLOSE_PROTOCOL_ERROR, "new message inside a fragmented one")
        else:
            self._frag_op = opcode
        self._frag_size += len(payload)
        if self._frag_size > MAX_SIZE:
            raise ProtocolError(CLOSE_TOO_BIG, f"message over {MAX_SIZE} bytes")
        self._frag.append(payload)
        if not fin:
            return None
        data, op = b"".join(self._frag), self._frag_op
        self._frag, self._frag_op, self._frag_size = [], None, 0
        if op == OP_BINARY:
            return data
        try:
            return data.decode("utf-8")
        except UnicodeDecodeError:
            raise ProtocolError(CLOSE_INVALID_DATA, "text frame is not UTF-8") from None

    def _on_close(self, payload: bytes) -> None:
        if len(payload) == 1:
            raise ProtocolError(CLOSE_PROTOCOL_ERROR, "one-byte close payload")
        code, reason = CLOSE_NO_STATUS, ""
        if len(payload) >= 2:
            (code,) = struct.unpack("!H", payload[:2])
            try:
                reason = payload[2:].decode("utf-8")
            except UnicodeDecodeError:
                raise ProtocolError(CLOSE_INVALID_DATA, "close reason is not UTF-8") from None
        if self.close_code is None:
            self.close_code, self.close_reason = code, reason
        try:  # answer with the same code unless this side closed first
            self._send_frame(OP_CLOSE, close_payload(code, reason))
        except ConnectionClosed:
            pass
        self._closed.set()
        if not self.client:  # the server ends the TCP connection
            self._release()
        raise _closed(self.close_code, self.close_reason)

    # ----------------------------------------------------------------- close

    def close(self, code: int = CLOSE_NORMAL, reason: str = "") -> None:
        """Start the close handshake (if neither side has), wait up to
        ``CLOSE_TIMEOUT`` for the peer's close frame (once the connection
        failed: for the peer's EOF, discarding its bytes), then end the TCP
        connection."""
        with self._state_lock:
            if self.close_code is None:
                self.close_code, self.close_reason = code, reason
        try:
            self._send_frame(OP_CLOSE, close_payload(code, reason))
        except ConnectionClosed:
            pass
        if not self._closed.is_set():
            if self._recv_lock.acquire(timeout=CLOSE_TIMEOUT):
                try:  # nobody else is reading: drain up to the peer's close frame
                    deadline = time.monotonic() + CLOSE_TIMEOUT
                    while not self._closed.is_set():
                        if self._failed:  # parse nothing: discard up to the peer's EOF
                            self._buf.clear()
                            self._fill(deadline)
                            continue
                        try:
                            frame = self._next_frame(deadline)
                        except ProtocolError as e:
                            self._fail(e.code, e.reason)
                            continue
                        if frame[1] == OP_CLOSE:
                            self._closed.set()
                except (ConnectionClosed, TimeoutError):
                    pass
                finally:
                    self._recv_lock.release()
            else:  # a reader holds the socket; it sees the close frame
                self._closed.wait(CLOSE_TIMEOUT)
        self._release()

    def abort(self, code: int = CLOSE_GOING_AWAY, reason: str = "") -> None:
        """Close without waiting: send the close frame if the send lock is
        free at once, then end the TCP connection (a blocked reader or
        sender on this connection raises :class:`ConnectionClosed`)."""
        with self._state_lock:
            if self.close_code is None:
                self.close_code, self.close_reason = code, reason
        if self._send_lock.acquire(blocking=False):
            try:
                if not self._close_sent and not self._closed.is_set():
                    self._close_sent = True
                    self.socket.settimeout(0.5)
                    self.socket.sendall(encode_frame(
                        OP_CLOSE, close_payload(code, reason),
                        mask=os.urandom(4) if self.client else None))
            except OSError:
                pass
            finally:
                self._send_lock.release()
        self._release()

    def _fail(self, code: int, reason: str) -> None:
        """A protocol fault: send the close frame with ``code`` and parse
        nothing more.  A server half-closes (a client waits for the server
        to end the TCP connection); the socket stays open until
        :meth:`close` has discarded what the peer still sends."""
        with self._state_lock:
            if self.close_code is None:
                self.close_code, self.close_reason = code, reason
            self._failed = True
        try:
            self._send_frame(OP_CLOSE, close_payload(code, reason))
        except ConnectionClosed:
            pass
        if not self.client:
            with self._send_lock:  # after any frame still being sent
                try:
                    self.socket.shutdown(socket.SHUT_WR)
                except OSError:
                    pass

    def _lost(self) -> None:
        with self._state_lock:
            if self.close_code is None:
                self.close_code = CLOSE_ABNORMAL
        self._release()

    def _release(self) -> None:
        with self._state_lock:
            self._closed.set()
            if self._released:
                return
            self._released = True
        try:
            self.socket.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.socket.close()
        self._selector.close()

    def __enter__(self) -> "Connection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --------------------------------------------------------------------- server


class Server:
    """Accept loop over a listening socket; one thread per connection runs
    the handshake, then ``handler(connection)``, then closes it."""

    def __init__(self, handler: Callable[[Connection], None], host: str, port: int):
        self.handler = handler
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        self.socket = socket.socket(family, socket.SOCK_STREAM)
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.socket.bind((host, port))
        self.socket.listen(128)
        self._wake_r, self._wake_w = socket.socketpair()
        self._closing = False
        self._stopped = threading.Event()
        self._serving = False
        self._lock = threading.Lock()
        self._live: set = set()
        self._threads: set = set()

    def serve_forever(self) -> None:
        with self._lock:
            if self._closing:
                return
            self._serving = True
        sel = selectors.DefaultSelector()
        sel.register(self.socket, selectors.EVENT_READ)
        sel.register(self._wake_r, selectors.EVENT_READ)
        try:
            while not self._closing:
                for key, _ in sel.select():
                    if key.fileobj is self._wake_r or self._closing:
                        return
                    try:
                        sock, _ = self.socket.accept()
                    except OSError:
                        continue
                    thread = threading.Thread(target=self._connection, args=(sock,), daemon=True)
                    with self._lock:
                        self._threads.add(thread)
                    thread.start()
        finally:
            sel.close()
            self._stopped.set()

    def _connection(self, sock: socket.socket) -> None:
        ws = None
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            request, rest = _server_handshake(sock)
            ws = Connection(sock, client=False, request=request, buffered=rest)
            with self._lock:
                if self._closing:
                    ws.abort()
                    return
                self._live.add(ws)
            code, reason = CLOSE_NORMAL, ""
            try:
                self.handler(ws)
            except ConnectionClosed:
                pass
            except Exception:
                logging.getLogger(__name__).exception("connection handler failed")
                code, reason = CLOSE_INTERNAL_ERROR, "handler error"
            ws.close(code, reason)
        except (InvalidHandshake, OSError):
            sock.close()
        finally:
            with self._lock:
                self._live.discard(ws)
                self._threads.discard(threading.current_thread())

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop accepting, close live connections with 1001, and wait up to
        ``timeout`` seconds for their handlers."""
        with self._lock:
            self._closing = True
            serving = self._serving
            live = list(self._live)
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass
        if serving:
            self._stopped.wait(timeout)
        for ws in live:
            ws.abort(CLOSE_GOING_AWAY, "server shutting down")
        deadline = time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads)
        for thread in threads:
            if thread is not threading.current_thread():
                thread.join(max(0.0, deadline - time.monotonic()))
        for s in (self.socket, self._wake_r, self._wake_w):
            s.close()


def serve(handler: Callable[[Connection], None], host: str, port: int) -> Server:
    """A :class:`Server` bound to ``(host, port)`` (port 0: any free port,
    read back from ``server.socket``); call ``serve_forever()`` to accept."""
    return Server(handler, host, port)


# --------------------------------------------------------------------- client


def connect(url: str, additional_headers: Optional[dict] = None,
            open_timeout: float = 10.0) -> Connection:
    """Open a client connection to a ``ws://`` (or ``wss://``) URL."""
    parts = urlparse(url)
    if parts.scheme not in ("ws", "wss"):
        raise ValueError(f"not a WebSocket URL: {url!r}")
    host = parts.hostname or "localhost"
    port = parts.port or (443 if parts.scheme == "wss" else 80)
    target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
    sock = socket.create_connection((host, port), timeout=open_timeout)
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if parts.scheme == "wss":
            import ssl

            sock = ssl.create_default_context().wrap_socket(sock, server_hostname=host)
        key = base64.b64encode(os.urandom(16)).decode("ascii")
        host_header = host if parts.port is None else f"{host}:{port}"
        lines = [f"GET {target} HTTP/1.1", f"Host: {host_header}", "Upgrade: websocket",
                 "Connection: Upgrade", f"Sec-WebSocket-Key: {key}",
                 "Sec-WebSocket-Version: 13"]
        lines += [f"{k}: {v}" for k, v in (additional_headers or {}).items()]
        sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
        head, rest = _read_head(sock, time.monotonic() + open_timeout)
        status, *header_lines = head.decode("latin-1").split("\r\n")
        fields = status.split(" ", 2)
        if len(fields) < 2 or fields[1] != "101":
            raise InvalidHandshake(f"server refused the upgrade: {status!r}")
        headers = _parse_headers(header_lines)
        if headers.get("sec-websocket-accept") != accept_key(key):
            raise InvalidHandshake("wrong Sec-WebSocket-Accept")
        if "websocket" not in _tokens(headers.get("upgrade", "")):
            raise InvalidHandshake("missing Upgrade: websocket")
        sock.settimeout(None)
    except BaseException:
        sock.close()
        raise
    return Connection(sock, client=True, request=Request(target, {}), buffered=rest)
