"""Minimal HTTP serving layer over the batching front end (the port's copy
of ``make_handler`` and ``RetrievalServer``,
lightningdot_tpu/serving_http.py:29-114).

Production shape for the reference's interactive demo
(demo/image_retriever.ipynb -> dvl/utils.retrieve_query): a stdlib threaded
HTTP server whose request threads block on
:class:`~lightningdot_tpu_torch.serving_frontend.BatchingFrontend` futures,
so concurrent clients coalesce into batched device calls.

Endpoints:
  GET /search?q=<text>&top=<k>   -> {"query": ..., "results": [[id, score]]}
  GET /healthz                   -> {"ok": true, "corpus": N}

No framework dependencies: ``http.server.ThreadingHTTPServer`` is enough
for the I/O-bound request side (threads wait on futures; the device work
is serialized by the front end's dispatch thread).
"""
from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from lightningdot_tpu_torch.serving_frontend import BatchingFrontend


def make_handler(frontend: BatchingFrontend, default_top: int = 100):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            url = urlparse(self.path)
            if url.path == "/healthz":
                self._reply(200, {"ok": True,
                                  "corpus": frontend.retriever.corpus_size})
                return
            if url.path != "/search":
                self._reply(404, {"error": "unknown path"})
                return
            q = parse_qs(url.query)
            text = (q.get("q") or [""])[0]
            if not text:
                self._reply(400, {"error": "missing q parameter"})
                return
            try:
                top = int((q.get("top") or [str(default_top)])[0])
            except ValueError:
                self._reply(400, {"error": "top must be an integer"})
                return
            if not 1 <= top <= frontend.max_top:
                # a client-controlled k never reaches the device call
                self._reply(400, {"error": f"top must be in "
                                           f"[1, {frontend.max_top}]"})
                return
            try:
                results = frontend.retrieve(text, top=top)
            except Exception as e:  # surfaced, not swallowed
                self._reply(500, {"error": repr(e)})
                return
            # non-finite scores become JSON null (bare NaN/Infinity tokens
            # from json.dumps are invalid per RFC 8259; the native ldserve
            # frontend emits null for the same case)
            self._reply(200, {"query": text,
                              "results": [
                                  [i, s if math.isfinite(s) else None]
                                  for i, s in results]})

    return Handler


class RetrievalServer:
    """Own a ThreadingHTTPServer bound to (host, port); serve in a thread."""

    def __init__(self, frontend: BatchingFrontend, host: str = "127.0.0.1",
                 port: int = 0, default_top: int = 100):
        self.frontend = frontend
        self.httpd = ThreadingHTTPServer(
            (host, port), make_handler(frontend, default_top))
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "RetrievalServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="ldot-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join()
        self.frontend.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
