"""HTTP microservice base on the standard library.

The counterpart of the JAX package's `service/base.py` (reference:
webapp/webapps/gradio_webapp.py), with the same wire protocol on
`http.server.ThreadingHTTPServer` instead of aiohttp, so a client of
either package talks to a service of either:

  POST {netpath}/{name}  a JSON body -> 200 {"ok": true, "data": ...}, or
                         500 {"ok": false, "error", "traceback"} when the
                         handler raises;
  GET  {netpath}/health  -> {"ok": true, "data": {"status", "service"}};
  GET  {netpath}/        -> `index_html`, where the service has one.

ndarray fields travel as {"__ndarray__": base64, "dtype", "shape"}, byte
strings as {"__file__": base64}. Handlers run one at a time behind one
lock (model state is single-stream, like Gradio's queue, reference:
gradio_webapp.py:22), each on a thread of the server with the torch state
(grad mode, CUDA device and stream) of the thread that started serving,
so a request computes what the same call made in that thread computes.
"""

from __future__ import annotations

import base64
import contextlib
import http
import http.server
import json
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

# the largest request body a service reads (aiohttp's client_max_size in
# the JAX package)
MAX_BODY_BYTES = 1 << 30


def encode_payload(obj: Any) -> Any:
    """Recursively encode numpy arrays and byte strings for JSON
    transport. A tensor raises: handlers move results to the host
    themselves (`.cpu().numpy()`), so nothing crosses the wire from the
    card unnoticed."""
    if isinstance(obj, torch.Tensor):
        raise TypeError("encode_payload takes numpy arrays, not tensors: "
                        "move the tensor to the host first")
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": base64.b64encode(
            np.ascontiguousarray(obj).tobytes()).decode(),
            "dtype": str(obj.dtype), "shape": list(obj.shape)}
    if isinstance(obj, (bytes, bytearray)):
        return {"__file__": base64.b64encode(bytes(obj)).decode()}
    if isinstance(obj, dict):
        return {k: encode_payload(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode_payload(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def decode_payload(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            raw = base64.b64decode(obj["__ndarray__"])
            return np.frombuffer(raw, dtype=np.dtype(obj["dtype"])).reshape(
                obj["shape"]).copy()
        if "__file__" in obj:
            return base64.b64decode(obj["__file__"])
        return {k: decode_payload(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_payload(v) for v in obj]
    return obj


class Webapp:
    """Base microservice: named endpoints served over HTTP.

    Subclasses register handlers with `self.route(name, fn)`; handlers take
    a decoded dict and return an encodable dict. A port of 0 binds a free
    one; `self.port` holds the bound port once serving starts.
    `last_request` holds the route, the body sizes and the handler's
    seconds of the latest POST that succeeded.
    """

    def __init__(self, netpath: str = "", port: int = 8888):
        self.netpath = netpath.rstrip("/")
        self.port = port
        self._routes: Dict[str, Callable] = {}
        self._lock = threading.Lock()
        self._server: Optional[http.server.ThreadingHTTPServer] = None
        self._torch_state = None
        self.last_request: Optional[dict] = None
        self.route("health", lambda req: {"status": "ok",
                                          "service": type(self).__name__})

    def route(self, name: str, fn: Callable[[dict], dict]) -> None:
        self._routes[name] = fn

    @contextlib.contextmanager
    def _serving_thread(self):
        """The torch state of the thread that started serving: grad mode
        and, with CUDA initialized, its current device and stream."""
        grad, device, stream = self._torch_state
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.set_grad_enabled(grad))
            if device is not None:
                stack.enter_context(torch.cuda.device(device))
                stack.enter_context(torch.cuda.stream(stream))
            yield

    def _call(self, name: str, body: bytes) -> tuple:
        """(status, JSON reply, the handler's seconds) of POST `name` with
        `body`."""
        try:
            payload = decode_payload(json.loads(body) if body else {})
            with self._lock, self._serving_thread():
                start = time.perf_counter()
                result = self._routes[name](payload)
                seconds = time.perf_counter() - start
            reply = json.dumps(encode_payload({"ok": True, "data": result}))
            return 200, reply, seconds
        except Exception as exc:  # noqa: BLE001 -- the reply carries it
            # mirror to the server log: the JSON body reaches the client,
            # but operators read the process output
            print(f"[{type(self).__name__}] handler error: {exc}",
                  file=sys.stderr, flush=True)
            traceback.print_exc()
            return 500, json.dumps(
                {"ok": False, "error": str(exc),
                 "traceback": traceback.format_exc()}), None

    def _get(self, path: str) -> Optional[tuple]:
        """(status, content type, body) of GET `path`; None if no GET
        route serves it."""
        if path == f"{self.netpath}/health":
            return 200, "application/json", json.dumps({"ok": True, "data": {
                "status": "ok", "service": type(self).__name__}})
        index = getattr(self, "index_html", None)
        if index and (path == f"{self.netpath}/"
                      or (self.netpath and path == self.netpath)):
            return 200, "text/html", index
        return None

    def _make_server(self, host: str) -> http.server.ThreadingHTTPServer:
        app = self
        posts = {f"{self.netpath}/{name}": name for name in self._routes}

        class Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self, status: int, ctype: str, text: str) -> None:
                data = text.encode()
                self.send_response(status)
                self.send_header("Content-Type", f"{ctype}; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _fail(self, status: int) -> None:
                self._reply(status, "text/plain",
                            f"{status}: {http.HTTPStatus(status).phrase}")

            def do_POST(self):  # noqa: N802 -- http.server's name
                path = self.path.split("?", 1)[0]
                if path not in posts:
                    status = 405 if app._get(path) else 404
                    self._fail(status)
                    return
                length = int(self.headers.get("Content-Length") or 0)
                if length > MAX_BODY_BYTES:
                    self._fail(413)
                    return
                body = self.rfile.read(length)
                status, reply, handler_s = app._call(posts[path], body)
                if status == 200:
                    # recorded before the reply leaves, so a client that
                    # has the reply finds its record
                    app.last_request = {
                        "route": posts[path], "request_bytes": len(body),
                        "response_bytes": len(reply),
                        "handler_seconds": handler_s}
                self._reply(status, "application/json", reply)

            def do_GET(self):  # noqa: N802
                path = self.path.split("?", 1)[0]
                got = app._get(path)
                if got is None:
                    self._fail(405 if path in posts else 404)
                    return
                self._reply(*got)

            def log_message(self, *args):
                pass  # no access log, as the JAX services keep none

        server = http.server.ThreadingHTTPServer((host, self.port), Handler)
        self.port = server.server_address[1]
        grad = torch.is_grad_enabled()
        if torch.cuda.is_initialized():
            self._torch_state = (grad, torch.cuda.current_device(),
                                 torch.cuda.current_stream())
        else:
            self._torch_state = (grad, None, None)
        self._server = server
        return server

    def run(self) -> None:
        """Serve forever on every interface (blocking)."""
        with self._make_server("") as server:
            server.serve_forever()

    def start_background(self) -> threading.Thread:
        """Serve on 127.0.0.1 from a daemon thread; returns the thread.
        The port is bound before this returns."""
        server = self._make_server("127.0.0.1")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return thread

    def shutdown(self) -> None:
        """Stop serving and close the socket."""
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
