"""The port's websocket routes (RFC 6455 on http/server.py, App.websocket,
websocket.py) held against the JAX App's (aiohttp), and the frame layer
on raw sockets.

Mirrors tests/test_http_server.py's websocket cases (:261 round trip,
:453 edge cases) on both Apps; the port's example's ``/ws/generate``
against the JAX example's on the same weights (``params_from_jax``), frame
for frame; and, with a stdlib socket client, what the frame layer does
with an unmasked frame (1002), a ping (pong), a fragmented message
(reassembled), a message over 4 MiB (1009), text that is not UTF-8 (1007)
and a close (its code echoed). Tolerances: exact.
"""

import asyncio
import base64
import importlib.util
import json
import os
import socket
import struct

import jax
import numpy as np
import pytest

from tests.test_http_server import AppHarness, _free_port

torch = pytest.importorskip("torch")

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _apps(config=None):
    """A JAX App and a port App on mock containers with the same config."""
    from gofr_tpu import app as jax_app
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import new_mock_container

    out = []
    for app_cls, conf_cls, cont in ((jax_app.App, JaxConfig, jax_container),
                                    (App, DictConfig, new_mock_container)):
        conf = {"HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port()),
                **(config or {})}
        out.append(app_cls(config=conf_cls(conf), container=cont(conf)))
    return out


def _echo(ctx):
    raw = ctx.bind(str)
    if raw == "boom":
        raise RuntimeError("handler exploded")
    if raw == "types":
        assert isinstance(ctx.bind(bytes), bytes)
        try:
            ctx.bind(dict)
            return {"bound": True}
        except Exception:  # noqa: BLE001 - each package's BindError
            return {"bound": False}
    return {"echo": raw}


async def _aiohttp_talk(base, app, loop, messages):
    import aiohttp

    out = []
    async with aiohttp.ClientSession() as session:
        async with session.ws_connect(f"{base}/ws") as ws:
            for m in messages:
                if isinstance(m, bytes):
                    await ws.send_bytes(m)
                else:
                    await ws.send_str(m)
                out.append(await ws.receive_json(timeout=5))
            out.append(("hub", len(app.ws_hub)))
            fut = asyncio.run_coroutine_threadsafe(app.ws_hub.broadcast({"push": 1}), loop)
            await asyncio.get_running_loop().run_in_executor(None, fut.result, 5)
            out.append(await ws.receive_json(timeout=5))
    return out


@pytest.mark.quick
def test_round_trip_edge_cases_and_hub_equal_the_jax_app():
    """Echo, a binary frame, a non-JSON message (bind(str/bytes) works,
    bind(dict) fails cleanly), a handler error answered in band with the
    connection alive, the hub's live count and a server push; the hub is
    empty after the close. The same replies from both Apps."""
    got = []
    messages = [json.dumps({"msg": "ping"}), b"bin", "types", "boom", "after-boom",
                "x" * 70000]
    for app in _apps():
        app.websocket("/ws", _echo)
        with AppHarness(app) as h:
            got.append(asyncio.run(_aiohttp_talk(h.base, app, h._loop, messages)))
        assert len(app.ws_hub) == 0
    assert got[0] == got[1]
    assert got[1][3] == {"error": {"message": "handler error"}}
    assert got[1][4] == {"echo": "after-boom"} and got[1][6] == ("hub", 1)
    assert got[1][-1] == {"push": 1}


@pytest.mark.quick
def test_a_plain_get_on_a_websocket_route_is_the_404_envelope():
    import httpx

    got = []
    for app in _apps():
        app.websocket("/ws", _echo)
        with AppHarness(app) as h:
            r = httpx.get(f"{h.base}/ws")
            got.append((r.status_code, r.json()))
    assert got[0] == got[1] == (404, {"error": {"message": "route not registered"}})


# -- raw RFC 6455 ------------------------------------------------------------------


class RawWS:
    """A stdlib client: the upgrade, masked frames out, frames in."""

    def __init__(self, port: int, path: str = "/ws"):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET {path} HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                           f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                           "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            head += self.sock.recv(1)
        self.status = int(head.split(b" ")[1])
        self.headers = {k.strip().lower(): v.strip() for k, _, v in
                        (ln.decode().partition(":") for ln in head.split(b"\r\n")[1:] if ln)}
        self.key = key

    def send(self, opcode: int, payload: bytes, *, fin: bool = True, masked: bool = True) -> None:
        from gofr_tpu_torch.http.server import ws_frame

        self.sock.sendall(ws_frame(opcode, payload, fin=fin,
                                   mask=os.urandom(4) if masked else None))

    def _exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("closed")
            buf += chunk
        return buf

    def recv(self) -> tuple[int, bytes]:
        b0, b1 = self._exact(2)
        n = b1 & 0x7F
        if n == 126:
            n = struct.unpack("!H", self._exact(2))[0]
        elif n == 127:
            n = struct.unpack("!Q", self._exact(8))[0]
        assert not b1 & 0x80, "server frames are unmasked"
        return b0 & 0x0F, self._exact(n)

    def close_code(self) -> int:
        op, payload = self.recv()
        assert op == 0x8
        return struct.unpack("!H", payload[:2])[0]

    def eof(self) -> bool:
        try:
            return self.sock.recv(1) == b""
        except OSError:
            return True


@pytest.fixture(scope="module")
def raw_app():
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import new_mock_container

    conf = {"HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port())}
    app = App(config=DictConfig(conf), container=new_mock_container(conf))
    app.websocket("/ws", lambda ctx: {"n": len(ctx.bind(bytes))})
    with AppHarness(app):
        yield app


@pytest.mark.quick
def test_upgrade_answers_101_with_the_accept_key(raw_app):
    from gofr_tpu_torch.http.server import ws_accept_key

    ws = RawWS(raw_app.http_port)
    assert ws.status == 101 and ws.headers["upgrade"] == "websocket"
    assert ws.headers["sec-websocket-accept"] == ws_accept_key(ws.key)
    # RFC 6455 section 1.3's worked example
    assert ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    ws.send(0x8, struct.pack("!H", 1000))
    assert ws.close_code() == 1000


@pytest.mark.quick
@pytest.mark.parametrize("case", ["unmasked", "ping", "fragments", "oversize", "bad_utf8",
                                  "close_code", "stray_continuation", "lengths"])
def test_frame_layer(raw_app, case):
    ws = RawWS(raw_app.http_port)
    assert ws.status == 101
    if case == "unmasked":
        ws.send(0x1, b"hi", masked=False)
        assert ws.close_code() == 1002 and ws.eof()
    elif case == "ping":
        ws.send(0x9, b"are you there")
        assert ws.recv() == (0xA, b"are you there")
        ws.send(0x1, b"abc")
        assert json.loads(ws.recv()[1]) == {"n": 3}
    elif case == "fragments":
        ws.send(0x1, b"ab", fin=False)
        ws.send(0x9, b"p")  # a control frame between fragments
        ws.send(0x0, b"cd", fin=False)
        ws.send(0x0, b"e")
        assert ws.recv() == (0xA, b"p")
        assert json.loads(ws.recv()[1]) == {"n": 5}
    elif case == "oversize":
        # the length alone closes it: the frame's header, then nothing
        ws.sock.sendall(bytes([0x82, 0x80 | 127]) + struct.pack("!Q", 4 * 1024 * 1024 + 1)
                        + os.urandom(4))
        assert ws.close_code() == 1009 and ws.eof()
        # and fragments that add up past it
        ws = RawWS(ws.sock.getpeername()[1])
        ws.send(0x2, b"\0" * (3 * 1024 * 1024), fin=False)
        ws.sock.sendall(bytes([0x80, 0x80 | 127]) + struct.pack("!Q", 1024 * 1024 + 1)
                        + os.urandom(4))
        assert ws.close_code() == 1009 and ws.eof()
    elif case == "bad_utf8":
        ws.send(0x1, b"\xff\xfe")
        assert ws.close_code() == 1007
    elif case == "close_code":
        ws.send(0x8, struct.pack("!H", 4001) + b"bye")
        assert ws.close_code() == 4001 and ws.eof()
    elif case == "stray_continuation":
        ws.send(0x0, b"x")
        assert ws.close_code() == 1002
    elif case == "lengths":
        for n in (125, 126, 65535, 65536, 300000):
            ws.send(0x2, b"\1" * n)
            assert json.loads(ws.recv()[1]) == {"n": n}


# -- /ws/generate, the two examples on the same weights -------------------------------


def _load(name: str):
    path = os.path.join(EXAMPLES, name, "main.py")
    spec = importlib.util.spec_from_file_location(f"example_ws_{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


async def _ws_generate(base: str, bodies: list, close_after: int | None = None) -> list:
    import aiohttp

    out = []
    async with aiohttp.ClientSession() as session:
        async with session.ws_connect(f"{base}/ws/generate") as ws:
            for body in bodies:
                frames = []
                await ws.send_str(json.dumps(body))
                while True:
                    frame = await ws.receive_json(timeout=300)
                    frames.append(frame)
                    if isinstance(frame, dict) and frame.get("done"):
                        break
                out.append(frames)
    return out


@pytest.mark.quick
def test_ws_generate_frames_equal_the_jax_example():
    """Two prompts on one connection and a bad request (no prompt: the
    in-band error): the same frames, one per token then ``{"done":
    true}``, from the JAX example and the port's on the JAX weights."""
    import httpx

    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu_torch.config import DictConfig

    def ports():
        return {"HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port())}

    japp = _load("serving-llm").build_app(JaxConfig(ports()))
    params = jax.tree.map(np.asarray, japp.container.engines["lm"].params)
    papp = _load("serving-llm-torch").build_app(DictConfig(ports()), params=params, device="cpu")
    bodies = [{"prompt": [1, 2, 3], "max_new_tokens": 6},
              {"prompt": "hello ws", "max_new_tokens": 5}]
    got = []
    for app in (japp, papp):
        with AppHarness(app) as h:
            frames = asyncio.run(_ws_generate(h.base, bodies))
            bad = asyncio.run(_aiohttp_bad(h.base))
            texts = [httpx.post(f"{h.base}/generate", json=b, timeout=300).json()["data"]["text"]
                     for b in bodies]
        got.append((frames, bad, texts))
    assert got[0] == got[1]
    frames, bad, texts = got[1]
    # one frame per decoded piece (the byte tokenizer holds a byte back
    # until it completes a character), then the terminal frame
    for f, text, body in zip(frames, texts, bodies):
        assert f[-1] == {"done": True} and 1 <= len(f) - 1 <= body["max_new_tokens"]
        assert all(isinstance(t, str) for t in f[:-1]) and "".join(f[:-1]) == text
    assert bad == {"error": {"message": "handler error"}}


async def _aiohttp_bad(base: str):
    import aiohttp

    async with aiohttp.ClientSession() as session:
        async with session.ws_connect(f"{base}/ws/generate") as ws:
            await ws.send_str(json.dumps({"max_new_tokens": 2}))
            return await ws.receive_json(timeout=60)


@pytest.mark.quick
def test_a_client_that_leaves_mid_stream_cancels_its_request():
    """The client closes its socket after the first token frame: the
    engine request ends cancelled and its slot is freed."""
    import time

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.http.streaming import StreamingResponse

    conf = {"HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port())}
    app = App(config=DictConfig(conf), container=new_mock_container(conf))
    eng = build_engine("tiny", device="cpu", slots=2, max_len=512, page_size=8)
    app.serve_model("lm", engine=eng)
    reqs = []

    def gen(ctx):
        it = ctx.generate("lm", ctx.bind(dict)["prompt"], max_new_tokens=400, stream=True)
        reqs.append(ctx._engine_requests[-1])
        return StreamingResponse(it)

    app.websocket("/ws", gen)
    with AppHarness(app):
        ws = RawWS(app.http_port)
        ws.send(0x1, json.dumps({"prompt": [1, 2, 3]}).encode())
        assert ws.recv()[0] == 0x1
        ws.sock.close()
        from gofr_tpu_torch.gpu.engine import RequestCancelled

        with pytest.raises(RequestCancelled):
            reqs[0].result(timeout=60)
        assert reqs[0].cancelled
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and any(s is not None for s in eng.slots):
            time.sleep(0.05)
        assert all(s is None for s in eng.slots)
