"""A WebSocket server (RFC 6455) on ``asyncio`` streams, stdlib only.

The JAX server takes its websocket from the ``websockets`` package; the port
needs none. This module offers the small surface that
``AppServer.websocket_handler`` uses: ``async for`` over a connection's
messages, and ``send``. It handles:

- the opening handshake (``Sec-WebSocket-Accept`` from the client's key);
- unfragmented text frames both ways, the client's masked;
- the 7-, 16- and 64-bit payload length forms;
- ping (answered with a pong carrying its payload), pong, and close (echoed).

It negotiates no extension and no subprotocol: a request for either is
answered without them, as RFC 6455 §4.2.2 lets a server do. Anything else
from the client (a fragment, an unmasked frame, a reserved bit or opcode, a
control frame over 125 bytes, a binary message) is answered with a close
frame carrying a protocol error and ends the connection.
"""
from __future__ import annotations

import asyncio
import base64
import hashlib
import struct
from typing import Awaitable, Callable, Optional, Union

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"  # RFC 6455 §1.3
OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x1, 0x2, 0x8, 0x9, 0xA
CLOSE_NORMAL, CLOSE_PROTOCOL_ERROR, CLOSE_UNSUPPORTED = 1000, 1002, 1003
CLOSE_INVALID_DATA, CLOSE_TOO_BIG = 1007, 1009
MAX_MESSAGE = 64 * 2 ** 20


def accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for the client's ``Sec-WebSocket-Key``."""
    return base64.b64encode(hashlib.sha1((key + GUID).encode("ascii")).digest()).decode()


def frame(opcode: int, payload: bytes) -> bytes:
    """One final, unmasked (server) frame: FIN, ``opcode``, the shortest
    length form, the payload."""
    n = len(payload)
    if n < 126:
        head = bytes([0x80 | opcode, n])
    elif n < 2 ** 16:
        head = bytes([0x80 | opcode, 126]) + struct.pack("!H", n)
    else:
        head = bytes([0x80 | opcode, 127]) + struct.pack("!Q", n)
    return head + payload


def apply_mask(data: bytes, mask: bytes) -> bytes:
    n = len(data)
    if not n:
        return data
    key = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "big") ^ int.from_bytes(key, "big")).to_bytes(n, "big")


class ConnectionClosed(Exception):
    """The connection is closed; ``code`` is the close code sent or received."""

    def __init__(self, code: int, reason: str = ""):
        super().__init__(f"websocket closed: {code} {reason}".strip())
        self.code = code
        self.reason = reason


class WebSocket:
    """One server-side connection after its handshake."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.close_code: Optional[int] = None

    async def send(self, message: Union[str, bytes]) -> None:
        """Send ``message`` (str, or bytes of UTF-8 text) as one text frame."""
        if self.close_code is not None:
            raise ConnectionClosed(self.close_code)
        data = message.encode("utf-8") if isinstance(message, str) else bytes(message)
        # one write a frame: frames from concurrent senders never interleave
        self.writer.write(frame(OP_TEXT, data))
        await self.writer.drain()

    async def close(self, code: int = CLOSE_NORMAL, reason: str = "") -> None:
        if self.close_code is None:
            self.close_code = code
            try:
                self.writer.write(frame(OP_CLOSE, struct.pack("!H", code)
                                        + reason.encode("utf-8")[:123]))
                await self.writer.drain()
            except (ConnectionError, RuntimeError):
                pass
        self.writer.close()

    async def _fail(self, code: int, reason: str):
        await self.close(code, reason)
        raise ConnectionClosed(code, reason)

    async def recv(self) -> str:
        """The next text message; answers pings; raises ``ConnectionClosed``
        at a close frame, at the end of the stream, or after closing the
        connection on a protocol error."""
        while True:
            try:
                b0, b1 = await self.reader.readexactly(2)
                fin, rsv, opcode = b0 & 0x80, b0 & 0x70, b0 & 0x0F
                masked, n = b1 & 0x80, b1 & 0x7F
                if n == 126:
                    (n,) = struct.unpack("!H", await self.reader.readexactly(2))
                elif n == 127:
                    (n,) = struct.unpack("!Q", await self.reader.readexactly(8))
                if rsv:
                    await self._fail(CLOSE_PROTOCOL_ERROR, "reserved bits set")
                if not masked:
                    await self._fail(CLOSE_PROTOCOL_ERROR, "client frames must be masked")
                if opcode >= 0x8 and (not fin or n > 125):
                    await self._fail(CLOSE_PROTOCOL_ERROR, "bad control frame")
                if n > MAX_MESSAGE:
                    await self._fail(CLOSE_TOO_BIG, "message too big")
                mask = await self.reader.readexactly(4)
                payload = apply_mask(await self.reader.readexactly(n), mask)
            except (asyncio.IncompleteReadError, ConnectionError):
                self.close_code = self.close_code or 1006
                self.writer.close()
                raise ConnectionClosed(1006, "connection lost") from None
            if opcode == OP_PING:
                self.writer.write(frame(OP_PONG, payload))
                await self.writer.drain()
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else CLOSE_NORMAL
                await self.close(code if len(payload) >= 2 else CLOSE_NORMAL)
                raise ConnectionClosed(code, payload[2:].decode("utf-8", "replace"))
            if opcode == OP_BINARY:
                await self._fail(CLOSE_UNSUPPORTED, "binary messages are not supported")
            if opcode != OP_TEXT or not fin:
                await self._fail(CLOSE_PROTOCOL_ERROR, "fragmented or unknown frame")
            try:
                return payload.decode("utf-8")
            except UnicodeDecodeError:
                await self._fail(CLOSE_INVALID_DATA, "text is not UTF-8")

    def __aiter__(self):
        return self

    async def __anext__(self) -> str:
        try:
            return await self.recv()
        except ConnectionClosed:
            raise StopAsyncIteration from None


async def _handshake(reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> bool:
    """Read the client's upgrade request and answer it; False after refusing
    it with an HTTP error."""
    try:
        raw = await reader.readuntil(b"\r\n\r\n")
    except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, ConnectionError):
        return False
    lines = raw.decode("latin-1").split("\r\n")
    parts = lines[0].split()
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    key = headers.get("sec-websocket-key", "")
    try:
        key_ok = len(base64.b64decode(key, validate=True)) == 16
    except ValueError:
        key_ok = False
    ok = (len(parts) == 3 and parts[0] == "GET" and parts[2] == "HTTP/1.1"
          and headers.get("upgrade", "").lower() == "websocket"
          and "upgrade" in [t.strip().lower() for t in headers.get("connection", "").split(",")]
          and key_ok)
    if not ok or headers.get("sec-websocket-version") != "13":
        status = "400 Bad Request" if not ok else "426 Upgrade Required"
        writer.write(f"HTTP/1.1 {status}\r\nSec-WebSocket-Version: 13\r\n"
                     "Content-Length: 0\r\nConnection: close\r\n\r\n".encode())
        await writer.drain()
        writer.close()
        return False
    writer.write(("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                  "Connection: Upgrade\r\n"
                  f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n").encode())
    await writer.drain()
    return True


async def serve(handler: Callable[[WebSocket], Awaitable[None]], host: str,
                port: int) -> asyncio.AbstractServer:
    """Listen on ``host:port``; each connection's ``handler(ws)`` runs after
    its handshake, and the connection is closed when it returns."""

    async def on_connection(reader, writer):
        if not await _handshake(reader, writer):
            return
        ws = WebSocket(reader, writer)
        try:
            await handler(ws)
        except ConnectionClosed:
            pass
        finally:
            if ws.close_code is None:
                await ws.close()

    return await asyncio.start_server(on_connection, host, port)
