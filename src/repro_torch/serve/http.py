"""HTTP front-end for the serving gateway (DESIGN.md §Serving gateway).

A copy of ``repro/serve/http.py``, which needs no JAX: importing it would run the JAX
package's ``__init__``, so the port keeps its own.

Stdlib only: a ``ThreadingHTTPServer`` whose handler threads do nothing
but ``Gateway.submit`` and block on the request's subscriber queue;
one background DRIVER thread owns the engine and calls ``Gateway.pump``
in a loop — the single-driver contract of ``RolloutEngine`` maps onto
exactly this split (handlers never touch the engine).

Endpoints:

  * ``POST /v1/completions`` — body ``{"prompt": str, "session": str?,
    "priority": int?, "deadline_ms": float?}``.  The response streams
    newline-delimited JSON (chunked transfer): one ``{"token": id,
    "text": str}`` object per generated token, then a final
    ``{"done": true, ...}`` summary;
  * ``GET /stats`` — gateway + engine counters as JSON;
  * ``GET /metrics`` — Prometheus text exposition (DESIGN.md §Metrics
    registry): TTFT/ITL/queue-wait histograms plus every gateway and
    engine counter under stable ``repro_*`` names;
  * ``GET /healthz`` — liveness probe.

Wall-clock mode: the server installs a monotonic millisecond clock on
the gateway, so ``deadline_ms`` / ``--sla-ms`` are real milliseconds
(the offline benchmark keeps the deterministic step clock instead).
"""
from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.data import tokenizer
from repro_torch.serve.gateway import Gateway


def _wall_ms() -> float:
    return time.monotonic() * 1000.0


class GatewayServer:
    """Owns the HTTP server + the driver thread around one Gateway.

    The driver thread becomes the engine's only driver
    (``RolloutEngine._assert_single_driver``): a caller that drove the
    engine before, on its own thread (a warm-up), calls
    ``engine.release_driver()`` before ``start()``.  The driver thread
    runs on its device's default CUDA stream."""

    def __init__(self, gateway: Gateway, host: str = "127.0.0.1",
                 port: int = 8000, default_sla_ms: float = 0.0):
        self.gateway = gateway
        gateway._clock_fn = _wall_ms       # deadlines in milliseconds
        self.default_sla_ms = default_sla_ms
        self._stop = threading.Event()
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._driver: Optional[threading.Thread] = None
        self._http_thread: Optional[threading.Thread] = None

    def _drive(self) -> None:
        while not self._stop.is_set():
            if self.gateway.has_work():
                self.gateway.pump()
            else:
                time.sleep(0.002)
        self.gateway.engine.release_driver()

    def start(self) -> None:
        self._driver = threading.Thread(target=self._drive,
                                        name="gateway-driver", daemon=True)
        self._driver.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="gateway-http", daemon=True)
        self._http_thread.start()

    def serve_forever(self) -> None:
        self.start()
        try:
            while True:
                time.sleep(1.0)
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        if self._driver is not None:
            self._driver.join(timeout=10.0)


def _make_handler(server: "GatewayServer"):
    gw = server.gateway

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # quiet by default
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                self._json(200, gw.stats())
            elif self.path == "/metrics":
                body = gw.prometheus_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/v1/completions":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                prompt = body["prompt"]
            except (ValueError, KeyError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            toks = (list(prompt) if isinstance(prompt, list)
                    else tokenizer.encode(str(prompt), bos=True))
            sla = body.get("deadline_ms", server.default_sla_ms) or None
            rid = gw.submit(toks, session=body.get("session"),
                            priority=int(body.get("priority", 1)),
                            sla=sla)
            events = gw.events(rid)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            while True:
                try:
                    kind, val = events.get(timeout=120.0)
                except queue.Empty:
                    self._chunk({"error": "timeout", "rid": rid})
                    break
                if kind == "tok":
                    self._chunk({"token": val,
                                 "text": tokenizer.decode([val])})
                else:
                    self._chunk({"done": True, **val})
                    gw.release(rid)
                    break
            self.wfile.write(b"0\r\n\r\n")

        def _chunk(self, obj) -> None:
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

    return Handler
