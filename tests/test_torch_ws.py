"""The port's stdlib websocket server (``xva_trainer_tpu_torch/app/ws.py``),
driven over real localhost sockets by ``chip_smoke.WsClient`` (the client
the card's smoke run uses) and, where it is installed, by the
``websockets`` package's client."""
import asyncio
import json
import logging
import struct
import threading

import pytest

from chip_smoke import WsClient
from xva_trainer_tpu_torch.app import ws
from xva_trainer_tpu_torch.app.server import AppServer


class Served:
    """``ws.serve(handler)`` on its own event loop in a thread, on a free port."""

    def __init__(self, handler):
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        async def main():
            self.server = await ws.serve(handler, "localhost", 0)
            self.port = self.server.sockets[0].getsockname()[1]
            started.set()
            await self.server.serve_forever()

        self.thread = threading.Thread(target=lambda: self._run(main()), daemon=True)
        self.thread.start()
        assert started.wait(10)

    def _run(self, coro):
        try:
            self.loop.run_until_complete(coro)
        except asyncio.CancelledError:
            pass

    def close(self):
        self.loop.call_soon_threadsafe(self.server.close)
        self.thread.join(10)


async def echo(conn):
    async for msg in conn:
        await conn.send(msg)


@pytest.fixture
def echo_server():
    s = Served(echo)
    yield s
    s.close()


def test_accept_key_rfc6455_example():
    # RFC 6455 §1.3's worked example
    assert ws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


@pytest.mark.parametrize("size", [125, 126, 70_000])
def test_text_both_ways(echo_server, size):
    """The 7-, 16- and 64-bit length forms, client to server and back."""
    c = WsClient(echo_server.port, timeout=10)
    text = "é" + ("abcdefgh" * size)[:size - 2]  # size bytes of UTF-8
    assert len(text.encode("utf-8")) == size
    c.send(text)
    op, payload = c.recv_frame()
    assert op == 0x1 and payload.decode("utf-8") == text
    # the server's frame uses the shortest length form
    assert len(ws.frame(ws.OP_TEXT, payload)) - len(payload) == {125: 2, 126: 4, 70_000: 10}[size]
    c.close()


def test_ping_pong_and_close(echo_server):
    c = WsClient(echo_server.port, timeout=10)
    c.send_frame(0x9, b"are you there")
    assert c.recv_frame() == (0xA, b"are you there")
    c.send_frame(0x8, struct.pack("!H", 1000) + b"bye")
    op, payload = c.recv_frame()
    assert op == 0x8 and struct.unpack("!H", payload[:2])[0] == 1000
    c.sock.close()


@pytest.mark.parametrize("case", ["unmasked", "fragmented", "binary", "reserved_bit"])
def test_protocol_errors_close_the_connection(echo_server, case):
    c = WsClient(echo_server.port, timeout=10)
    if case == "unmasked":
        c.send_frame(0x1, b"hello", masked=False)
    elif case == "fragmented":
        c.send_frame(0x1, b"hel", fin=False)
    elif case == "binary":
        c.send_frame(0x2, b"\x00\x01")
    else:
        c.send_frame(0x40 | 0x1, b"hello")
    op, payload = c.recv_frame()
    want = ws.CLOSE_UNSUPPORTED if case == "binary" else ws.CLOSE_PROTOCOL_ERROR
    assert op == 0x8 and struct.unpack("!H", payload[:2])[0] == want
    assert c.sock.recv(1) == b""  # and the server hung up
    c.sock.close()


def test_bad_handshake_refused(echo_server):
    import socket

    s = socket.create_connection(("localhost", echo_server.port), timeout=10)
    s.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
    assert s.recv(64).startswith(b"HTTP/1.1 400")
    s.close()


def _quiet():
    lg = logging.getLogger("test_torch_ws")
    lg.addHandler(logging.NullHandler())
    lg.propagate = False
    return lg


@pytest.fixture
def app_server():
    app = AppServer(logger=_quiet())
    s = Served(app.websocket_handler)
    yield s
    s.close()


MESSAGES = [
    ({"model": "print_and_return", "task": "", "data": "echo"}, "echo"),
    ({"model": "", "task": "bogus", "data": {}},
     json.dumps({"key": "tasks_error", "data": "unknown task bogus"})),
]


def test_handle_message_round_trip(app_server):
    c = WsClient(app_server.port, timeout=10)
    for msg, reply in MESSAGES:
        c.send(json.dumps(msg))
        assert c.recv() == reply
    c.close()


def test_round_trip_with_websockets_client(app_server):
    websockets = pytest.importorskip("websockets")

    async def go():
        async with websockets.connect(f"ws://localhost:{app_server.port}") as conn:
            out = []
            for msg, _ in MESSAGES:
                await conn.send(json.dumps(msg))
                out.append(await conn.recv())
            await conn.ping()
            return out

    assert asyncio.run(go()) == [reply for _, reply in MESSAGES]
