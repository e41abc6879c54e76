"""The port's copy of ``fav_tpu/serving/httpws.py``.

Minimal asyncio HTTP/1.1 + WebSocket (RFC 6455) runtime — stdlib only.

The reference serves via FastAPI/uvicorn (reference main.py:34,369-371);
this image ships neither, so the runtime is built directly on
``asyncio.start_server``. Scope: exactly what the app needs —

* GET routing + static file mounts (reference main.py:41-45,50-65),
* POST with multipart/form-data parsing for video upload (main.py:77-94),
* WebSocket upgrade, text frames, ping/pong, close handshake, fragmented
  and masked client frames (the browser always masks),
* per-connection tasks with clean cancellation on disconnect
  (main.py:306-317).

No TLS (terminate upstream), no HTTP/2, no compression extensions.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import mimetypes
import os
import re
import struct
from dataclasses import dataclass, field
from typing import Awaitable, Callable

__all__ = ["Request", "Response", "WebSocket", "HttpServer", "WebSocketClosed"]

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
_MAX_HEADER = 64 * 1024
_MAX_BODY = 200 * 1024 * 1024  # uploads are videos (main.py:77-94)
# Slowloris guards: fixed budget for headers; body budget grows with declared
# size (>=1 MB/s effective floor) so big uploads on slow links still fit.
_HEADER_TIMEOUT = 60.0
_BODY_TIMEOUT_BASE = 30.0


class WebSocketClosed(Exception):
    """Peer closed (or transport dropped). Mirrors WebSocketDisconnect."""


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, str]
    headers: dict[str, str]
    body: bytes = b""

    def multipart(self) -> list[dict]:
        """Parse multipart/form-data into [{name, filename, content_type, data}]."""
        ctype = self.headers.get("content-type", "")
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m:
            return []
        boundary = b"--" + m.group(1).encode()
        parts = []
        for chunk in self.body.split(boundary)[1:-1]:
            chunk = chunk.strip(b"\r\n")
            if chunk in (b"", b"--"):
                continue
            head, _, data = chunk.partition(b"\r\n\r\n")
            headers = {}
            for line in head.decode("latin-1").split("\r\n"):
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
            disp = headers.get("content-disposition", "")
            name = re.search(r'name="([^"]*)"', disp)
            fname = re.search(r'filename="([^"]*)"', disp)
            parts.append(
                {
                    "name": name.group(1) if name else "",
                    "filename": fname.group(1) if fname else None,
                    "content_type": headers.get("content-type", ""),
                    "data": data,
                }
            )
        return parts


@dataclass
class Response:
    status: int = 200
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    _REASONS = {
        200: "OK", 204: "No Content", 301: "Moved Permanently", 400: "Bad Request",
        403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
        413: "Payload Too Large", 500: "Internal Server Error",
    }

    @classmethod
    def json(cls, obj, status: int = 200) -> "Response":
        return cls(status, {"Content-Type": "application/json"}, json.dumps(obj).encode())

    @classmethod
    def text(cls, s: str, status: int = 200, content_type: str = "text/plain") -> "Response":
        return cls(status, {"Content-Type": content_type}, s.encode())

    @classmethod
    def html(cls, s: str, status: int = 200) -> "Response":
        return cls.text(s, status, "text/html; charset=utf-8")

    def encode(self) -> bytes:
        reason = self._REASONS.get(self.status, "Unknown")
        headers = {"Content-Length": str(len(self.body)), "Connection": "keep-alive", **self.headers}
        head = f"HTTP/1.1 {self.status} {reason}\r\n"
        head += "".join(f"{k}: {v}\r\n" for k, v in headers.items())
        return head.encode() + b"\r\n" + self.body


class WebSocket:
    """Server-side WebSocket with the send_json/receive_text surface the app
    (and the reference's handlers, main.py:105-317) expect."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._reader = reader
        self._writer = writer
        self._send_lock = asyncio.Lock()
        self.closed = False

    # ── receive ──
    async def receive_text(self) -> str:
        opcode, payload = await self._read_message()
        if opcode == 0x1:
            return payload.decode()
        if opcode == 0x2:
            return payload.decode("latin-1")
        raise WebSocketClosed

    async def receive_json(self):
        return json.loads(await self.receive_text())

    async def _read_message(self) -> tuple[int, bytes]:
        """Read one complete (possibly fragmented) message; answer pings."""
        message_opcode = None
        buffer = b""
        while True:
            fin, opcode, payload = await self._read_frame()
            if opcode == 0x8:  # close
                await self._send_close_echo(payload)
                raise WebSocketClosed
            if opcode == 0x9:  # ping -> pong
                await self._send_frame(0xA, payload)
                continue
            if opcode == 0xA:  # unsolicited pong
                continue
            if opcode in (0x1, 0x2):
                message_opcode = opcode
                buffer = payload
            elif opcode == 0x0 and message_opcode is not None:  # continuation
                buffer += payload
            else:
                raise WebSocketClosed
            if fin:
                return message_opcode, buffer

    async def _read_frame(self) -> tuple[bool, int, bytes]:
        try:
            head = await self._reader.readexactly(2)
            fin = bool(head[0] & 0x80)
            opcode = head[0] & 0x0F
            masked = bool(head[1] & 0x80)
            length = head[1] & 0x7F
            if length == 126:
                length = struct.unpack(">H", await self._reader.readexactly(2))[0]
            elif length == 127:
                length = struct.unpack(">Q", await self._reader.readexactly(8))[0]
            if length > _MAX_BODY:
                raise WebSocketClosed
            mask = await self._reader.readexactly(4) if masked else None
            payload = await self._reader.readexactly(length) if length else b""
            if mask:
                payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
            return fin, opcode, payload
        except (asyncio.IncompleteReadError, ConnectionError):
            self.closed = True
            raise WebSocketClosed from None

    # ── send ──
    async def send_text(self, text: str) -> None:
        await self._send_frame(0x1, text.encode())

    async def send_json(self, obj) -> None:
        await self._send_frame(0x1, json.dumps(obj).encode())

    async def send_bytes(self, data: bytes) -> None:
        await self._send_frame(0x2, data)

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        if self.closed:
            raise WebSocketClosed
        header = bytes([0x80 | opcode])
        n = len(payload)
        if n < 126:
            header += bytes([n])
        elif n < 1 << 16:
            header += bytes([126]) + struct.pack(">H", n)
        else:
            header += bytes([127]) + struct.pack(">Q", n)
        async with self._send_lock:
            try:
                self._writer.write(header + payload)
                await self._writer.drain()
            except ConnectionError:
                self.closed = True
                raise WebSocketClosed from None

    async def _send_close_echo(self, payload: bytes) -> None:
        if not self.closed:
            self.closed = True
            try:
                await self._send_close_frame(payload[:2])
            except WebSocketClosed:
                pass

    async def _send_close_frame(self, payload: bytes = b"") -> None:
        header = bytes([0x88, len(payload)])
        async with self._send_lock:
            try:
                self._writer.write(header + payload)
                await self._writer.drain()
            except ConnectionError:
                pass

    async def close(self, code: int = 1000) -> None:
        if not self.closed:
            self.closed = True
            await self._send_close_frame(struct.pack(">H", code))


WsHandler = Callable[[Request, WebSocket], Awaitable[None]]
HttpHandler = Callable[[Request], Awaitable[Response]]


class HttpServer:
    """Route table + asyncio server. Mirrors the surface the app needs from
    FastAPI: route(method, path), ws(path), static mounts, serve()."""

    def __init__(self) -> None:
        self._routes: dict[tuple[str, str], HttpHandler] = {}
        self._ws_routes: dict[str, WsHandler] = {}
        self._static: list[tuple[str, str]] = []  # (url_prefix, directory)
        self._server: asyncio.base_events.Server | None = None

    def route(self, method: str, path: str, handler: HttpHandler) -> None:
        self._routes[(method.upper(), path)] = handler

    def ws(self, path: str, handler: WsHandler) -> None:
        self._ws_routes[path] = handler

    def mount_static(self, url_prefix: str, directory: str) -> None:
        self._static.append((url_prefix.rstrip("/") + "/", directory))

    # ── serving ──
    async def serve(
        self, host: str, port: int, reuse_port: bool = False
    ) -> asyncio.base_events.Server:
        """``reuse_port=True`` binds with SO_REUSEPORT so N worker processes
        can share the port (the kernel load-balances accepted connections) —
        the scale-out mode behind ``FAV_SERVER_WORKERS`` (serving/app.py)."""
        kwargs = {"reuse_port": True} if reuse_port else {}
        self._server = await asyncio.start_server(
            self._handle_conn, host, port, **kwargs
        )
        return self._server

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                request = await self._read_request(reader)
                if request is None:
                    break
                if request.headers.get("upgrade", "").lower() == "websocket":
                    await self._handle_ws(request, reader, writer)
                    break  # ws owns the connection until close
                response = await self._dispatch(request)
                writer.write(response.encode())
                await writer.drain()
                if request.headers.get("connection", "").lower() == "close":
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader: asyncio.StreamReader) -> Request | None:
        try:
            # idle/slow-header timeout: a client trickling bytes must not pin
            # a connection slot forever (keep-alive reuse within 60 s is fine)
            raw = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout=_HEADER_TIMEOUT)
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, asyncio.TimeoutError):
            return None
        if len(raw) > _MAX_HEADER:
            return None
        lines = raw.decode("latin-1").split("\r\n")
        try:
            method, target, _ = lines[0].split(" ", 2)
        except ValueError:
            return None
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
        path, _, qs = target.partition("?")
        query = {}
        for pair in qs.split("&"):
            if "=" in pair:
                k, _, v = pair.partition("=")
                query[k] = v
        body = b""
        try:
            length = int(headers.get("content-length", 0))
        except ValueError:
            return None
        if length:
            if length > _MAX_BODY:
                return None
            try:
                # Slowloris guard, body edition: a trickled body can't pin a
                # connection slot (see _BODY_TIMEOUT_BASE above).
                body = await asyncio.wait_for(
                    reader.readexactly(length), timeout=_BODY_TIMEOUT_BASE + length / 1e6
                )
            except (asyncio.IncompleteReadError, asyncio.TimeoutError):
                return None
        return Request(method.upper(), path, query, headers, body)

    async def _dispatch(self, request: Request) -> Response:
        handler = self._routes.get((request.method, request.path))
        if handler is not None:
            try:
                return await handler(request)
            except Exception as e:  # route errors must not kill the connection
                return Response.json({"error": f"{type(e).__name__}: {e}"}, 500)
        for prefix, directory in self._static:
            if request.path.startswith(prefix) and request.method == "GET":
                return self._serve_static(request.path, prefix, directory)
        if any(p == request.path for (_m, p) in self._routes):
            return Response.json({"error": "method not allowed"}, 405)
        return Response.json({"error": "not found"}, 404)

    def _serve_static(self, path: str, prefix: str, directory: str) -> Response:
        rel = path[len(prefix):]
        full = os.path.realpath(os.path.join(directory, rel))
        if not full.startswith(os.path.realpath(directory) + os.sep):
            return Response.json({"error": "forbidden"}, 403)
        if not os.path.isfile(full):
            return Response.json({"error": "not found"}, 404)
        ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
        with open(full, "rb") as f:
            return Response(200, {"Content-Type": ctype, "Cache-Control": "max-age=60"}, f.read())

    async def _handle_ws(self, request: Request, reader, writer) -> None:
        handler = self._ws_routes.get(request.path)
        key = request.headers.get("sec-websocket-key")
        if handler is None or key is None:
            writer.write(Response.json({"error": "no such websocket"}, 404).encode())
            await writer.drain()
            return
        accept = base64.b64encode(hashlib.sha1((key + _WS_GUID).encode()).digest()).decode()
        writer.write(
            (
                "HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: {accept}\r\n\r\n"
            ).encode()
        )
        await writer.drain()
        ws = WebSocket(reader, writer)
        try:
            await handler(request, ws)
        except WebSocketClosed:
            pass
        finally:
            await ws.close()
