"""Asyncio HTTP/1.1 server with routing, SSE, and WebSocket support (port
of the JAX package's api/http.py).

The reference rides FastAPI/uvicorn (super_rag/app.py); here the serving
runtime is part of the framework, standard library only: a small
asyncio server implementing what the API layer actually needs — path
routing with params, JSON bodies, multipart/form-data uploads, byte-range
responses, server-sent events, and RFC 6455 WebSockets.  No third-party
dependencies.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import logging
import re
import struct
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Awaitable, Callable, Iterator, Optional
from urllib.parse import parse_qs, unquote, urlsplit

logger = logging.getLogger(__name__)

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 512 * 1024 * 1024
WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

STATUS_TEXT = {
    200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
    206: "Partial Content",
    301: "Moved Permanently", 302: "Found", 304: "Not Modified",
    400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
    413: "Payload Too Large", 422: "Unprocessable Entity",
    429: "Too Many Requests", 500: "Internal Server Error",
    501: "Not Implemented",
}


class HttpError(Exception):
    def __init__(self, status: int, message: str = "", code: str = ""):
        super().__init__(message or STATUS_TEXT.get(status, str(status)))
        self.status = status
        self.message = message or STATUS_TEXT.get(status, str(status))
        self.code = code or str(status)


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, str]
    headers: dict[str, str]
    body: bytes
    path_params: dict[str, str] = field(default_factory=dict)
    state: dict[str, Any] = field(default_factory=dict)
    # populated by the server for websocket routes
    _reader: Optional[asyncio.StreamReader] = None
    _writer: Optional[asyncio.StreamWriter] = None

    def json(self) -> Any:
        if not self.body:
            return {}
        try:
            return json.loads(self.body)
        except json.JSONDecodeError as e:
            raise HttpError(400, f"invalid JSON body: {e}") from e

    def cookie(self, name: str) -> Optional[str]:
        raw = self.headers.get("cookie", "")
        for part in raw.split(";"):
            k, _, v = part.strip().partition("=")
            if k == name:
                return unquote(v)
        return None

    def multipart(self) -> list[dict]:
        """Parse multipart/form-data into
        [{name, filename?, content_type?, data: bytes}]."""
        ctype = self.headers.get("content-type", "")
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m:
            raise HttpError(400, "missing multipart boundary")
        boundary = b"--" + m.group(1).encode()
        parts = []
        for raw in self.body.split(boundary)[1:-1]:
            raw = raw.strip(b"\r\n")
            if not raw or raw == b"--":
                continue
            head, _, data = raw.partition(b"\r\n\r\n")
            headers: dict[str, str] = {}
            for line in head.decode("utf-8", "replace").split("\r\n"):
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
            disp = headers.get("content-disposition", "")
            name_m = re.search(r'name="([^"]*)"', disp)
            file_m = re.search(r'filename="([^"]*)"', disp)
            parts.append(
                {
                    "name": name_m.group(1) if name_m else "",
                    "filename": file_m.group(1) if file_m else None,
                    "content_type": headers.get("content-type"),
                    "data": data,
                }
            )
        return parts


@dataclass
class Response:
    status: int = 200
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    # streaming: sync/async iterator of bytes chunks (chunked encoding)
    stream: Optional[AsyncIterator[bytes] | Iterator[bytes]] = None

    @classmethod
    def json(cls, data: Any, status: int = 200,
             headers: Optional[dict] = None) -> "Response":
        return cls(
            status=status,
            headers={"Content-Type": "application/json", **(headers or {})},
            body=json.dumps(data, default=str).encode(),
        )

    @classmethod
    def text(cls, text: str, status: int = 200) -> "Response":
        return cls(status=status,
                   headers={"Content-Type": "text/plain; charset=utf-8"},
                   body=text.encode())

    @classmethod
    def no_content(cls) -> "Response":
        return cls(status=204)

    @classmethod
    def error(cls, status: int, message: str, code: str = "") -> "Response":
        return cls.json(
            {"error": {"code": code or str(status), "message": message}},
            status=status,
        )

    @classmethod
    def sse(cls, events: AsyncIterator[dict] | Iterator[dict]) -> "Response":
        """Server-sent events from an iterator of {event?, data} dicts."""

        async def gen():
            if hasattr(events, "__aiter__"):
                async for e in events:  # type: ignore[union-attr]
                    yield _sse_frame(e)
            else:
                for e in events:  # type: ignore[union-attr]
                    yield _sse_frame(e)

        return cls(
            status=200,
            headers={"Content-Type": "text/event-stream",
                     "Cache-Control": "no-cache"},
            stream=gen(),
        )


def _sse_frame(e: dict) -> bytes:
    out = ""
    if "event" in e:
        out += f"event: {e['event']}\n"
    data = e.get("data", "")
    if not isinstance(data, str):
        data = json.dumps(data, default=str)
    for line in data.split("\n"):
        out += f"data: {line}\n"
    return (out + "\n").encode()


Handler = Callable[[Request], Awaitable[Response]]
Middleware = Callable[[Request, Handler], Awaitable[Response]]

_PARAM_RE = re.compile(r"\{(\w+)(:path)?\}")


class Router:
    def __init__(self):
        self.routes: list[tuple[str, re.Pattern, Handler, bool]] = []
        self.middlewares: list[Middleware] = []

    def add(self, method: str, pattern: str, handler: Handler,
            websocket: bool = False) -> None:
        # {name} matches one segment; {name:path} greedily matches across
        # slashes (model names like "org/model" — reference api/llm.py:148)
        regex = re.compile(
            "^"
            + _PARAM_RE.sub(
                lambda m: f"(?P<{m.group(1)}>{'.+' if m.group(2) else '[^/]+'})",
                pattern,
            )
            + "$"
        )
        self.routes.append((method.upper(), regex, handler, websocket))

    def get(self, pattern):
        return lambda h: (self.add("GET", pattern, h), h)[1]

    def post(self, pattern):
        return lambda h: (self.add("POST", pattern, h), h)[1]

    def put(self, pattern):
        return lambda h: (self.add("PUT", pattern, h), h)[1]

    def patch(self, pattern):
        return lambda h: (self.add("PATCH", pattern, h), h)[1]

    def delete(self, pattern):
        return lambda h: (self.add("DELETE", pattern, h), h)[1]

    def websocket(self, pattern):
        return lambda h: (self.add("GET", pattern, h, websocket=True), h)[1]

    def use(self, mw: Middleware) -> None:
        self.middlewares.append(mw)

    def match(self, method: str, path: str):
        allowed = set()
        best = None  # most-specific match: fewest path params wins, so
        # literal segments ("/collections/shared-with-me") are never
        # shadowed by parameterized siblings ("/collections/{cid}")
        for m, regex, handler, ws in self.routes:
            mo = regex.match(path)
            if mo:
                if m == method.upper():
                    cand = (len(mo.groupdict()), handler, mo.groupdict(), ws)
                    if best is None or cand[0] < best[0]:
                        best = cand
                else:
                    allowed.add(m)
        if best is not None:
            return best[1], best[2], best[3]
        if allowed:
            raise HttpError(405, f"method {method} not allowed")
        return None, {}, False


class WebSocket:
    """Server-side RFC 6455 connection (text + binary, ping/pong, close)."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.closed = False

    async def send_text(self, text: str) -> None:
        await self._send_frame(0x1, text.encode())

    async def send_json(self, data: Any) -> None:
        await self.send_text(json.dumps(data, default=str))

    async def send_bytes(self, data: bytes) -> None:
        await self._send_frame(0x2, data)

    async def close(self, code: int = 1000) -> None:
        if not self.closed:
            try:
                await self._send_frame(0x8, struct.pack("!H", code))
            except (ConnectionError, RuntimeError):
                pass
            self.closed = True

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        header = bytes([0x80 | opcode])
        n = len(payload)
        if n < 126:
            header += bytes([n])
        elif n < 1 << 16:
            header += bytes([126]) + struct.pack("!H", n)
        else:
            header += bytes([127]) + struct.pack("!Q", n)
        self.writer.write(header + payload)
        await self.writer.drain()

    async def receive(self) -> Optional[dict]:
        """Next message: {type: 'text'|'bytes', data}; None on close."""
        buffer = b""
        opcode0 = None
        while True:
            try:
                head = await self.reader.readexactly(2)
            except (asyncio.IncompleteReadError, ConnectionError):
                self.closed = True
                return None
            fin = head[0] & 0x80
            opcode = head[0] & 0x0F
            masked = head[1] & 0x80
            n = head[1] & 0x7F
            if n == 126:
                n = struct.unpack("!H", await self.reader.readexactly(2))[0]
            elif n == 127:
                n = struct.unpack("!Q", await self.reader.readexactly(8))[0]
            mask = await self.reader.readexactly(4) if masked else b"\0" * 4
            payload = await self.reader.readexactly(n)
            if masked:
                payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
            if opcode == 0x8:  # close
                await self.close()
                return None
            if opcode == 0x9:  # ping -> pong
                await self._send_frame(0xA, payload)
                continue
            if opcode == 0xA:  # pong
                continue
            buffer += payload
            if opcode in (0x1, 0x2):
                opcode0 = opcode
            if fin:
                kind = "text" if opcode0 == 0x1 else "bytes"
                return {
                    "type": kind,
                    "data": buffer.decode() if kind == "text" else buffer,
                }

    async def receive_json(self) -> Optional[Any]:
        msg = await self.receive()
        if msg is None or msg["type"] != "text":
            return None
        return json.loads(msg["data"])


class HttpServer:
    def __init__(self, router: Router):
        self.router = router
        self._server: Optional[asyncio.base_events.Server] = None

    async def start(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, host, port
        )

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    # -- connection handling ---------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                keep_alive = (
                    req.headers.get("connection", "keep-alive").lower()
                    != "close"
                )
                req._reader, req._writer = reader, writer
                upgraded = await self._dispatch(req, writer)
                if upgraded:
                    return  # websocket took over; its handler closed it
                if not keep_alive:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception:  # noqa: BLE001
            logger.exception("connection handler error")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass

    async def _read_request(
        self, reader: asyncio.StreamReader
    ) -> Optional[Request]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        if len(head) > MAX_HEADER_BYTES:
            raise HttpError(431, "headers too large")
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError:
            return None
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        url = urlsplit(target)
        query = {k: v[0] for k, v in parse_qs(url.query).items()}
        length = int(headers.get("content-length", "0") or 0)
        if length > MAX_BODY_BYTES:
            raise HttpError(413, "body too large")
        body = await reader.readexactly(length) if length else b""
        return Request(
            method=method.upper(), path=unquote(url.path), query=query,
            headers=headers, body=body,
        )

    async def _dispatch(self, req: Request,
                        writer: asyncio.StreamWriter) -> bool:
        """Returns True if the connection was upgraded (websocket)."""
        try:
            handler, params, is_ws = self.router.match(req.method, req.path)
            if handler is None:
                resp = Response.error(404, f"no route for {req.path}")
                await self._write_response(writer, resp, req)
                return False
            req.path_params = params
            if is_ws and req.headers.get("upgrade", "").lower() == "websocket":
                await self._upgrade_websocket(req, writer)
                ws = WebSocket(req._reader, writer)
                composed = self._compose_ws(handler)
                await composed(req, ws)
                await ws.close()
                return True

            composed: Handler = handler
            for mw in reversed(self.router.middlewares):
                composed = self._wrap(mw, composed)
            resp = await composed(req)
        except HttpError as e:
            resp = Response.error(e.status, e.message, e.code)
        except Exception as e:  # noqa: BLE001
            logger.exception("handler error for %s %s", req.method, req.path)
            resp = Response.error(500, f"internal error: {e}")
        if not isinstance(resp, Response):
            # a handler returned a raw value; degrade to 500 rather than
            # crashing the connection loop (which drops keep-alive peers)
            logger.error("handler for %s %s returned %r, not Response",
                         req.method, req.path, type(resp))
            resp = Response.error(500, "handler returned non-Response")
        await self._write_response(writer, resp, req)
        return False

    def _compose_ws(self, handler):
        async def run(req: Request, ws: WebSocket):
            try:
                await handler(req, ws)
            except (ConnectionError, asyncio.IncompleteReadError):
                pass
            except Exception:  # noqa: BLE001
                logger.exception("websocket handler error")

        return run

    @staticmethod
    def _wrap(mw: Middleware, nxt: Handler) -> Handler:
        async def wrapped(req: Request) -> Response:
            return await mw(req, nxt)

        return wrapped

    async def _upgrade_websocket(self, req: Request,
                                 writer: asyncio.StreamWriter) -> None:
        key = req.headers.get("sec-websocket-key", "")
        if not key:
            raise HttpError(400, "missing Sec-WebSocket-Key")
        accept = base64.b64encode(
            hashlib.sha1((key + WS_GUID).encode()).digest()
        ).decode()
        writer.write(
            (
                "HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: {accept}\r\n\r\n"
            ).encode()
        )
        await writer.drain()

    async def _write_response(self, writer: asyncio.StreamWriter,
                              resp: Response, req: Request) -> None:
        head = f"HTTP/1.1 {resp.status} {STATUS_TEXT.get(resp.status, '')}\r\n"
        headers = dict(resp.headers)
        if resp.stream is not None:
            headers["Transfer-Encoding"] = "chunked"
            headers.setdefault("Connection", "keep-alive")
        else:
            headers["Content-Length"] = str(len(resp.body))
        for k, v in headers.items():
            # CR/LF in a header name or value would split the response
            # (header injection via user-controlled values, e.g. document
            # names surfaced as X-Document-Name). Strip unconditionally.
            k = str(k).replace("\r", "").replace("\n", "")
            v = str(v).replace("\r", " ").replace("\n", " ")
            head += f"{k}: {v}\r\n"
        writer.write((head + "\r\n").encode())
        if req.method == "HEAD":
            await writer.drain()
            return
        if resp.stream is None:
            writer.write(resp.body)
            await writer.drain()
            return
        try:
            if hasattr(resp.stream, "__aiter__"):
                async for chunk in resp.stream:  # type: ignore[union-attr]
                    writer.write(
                        f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n"
                    )
                    await writer.drain()
            else:
                for chunk in resp.stream:  # type: ignore[union-attr]
                    writer.write(
                        f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n"
                    )
                    await writer.drain()
        finally:
            writer.write(b"0\r\n\r\n")
            await writer.drain()
