"""Opt-in HTTP request front (``SERVE_PORT``) for the serving worker (a
copy of the JAX package's ``serving/frontend.py``).

A telemetry scrape endpoint answers "how is this process doing"; THIS
server answers actual requests — the two
are deliberately separate ports with separate contracts: telemetry is
read-only and must never block, while ``POST /generate`` holds the
connection open until the request completes (or is rejected by the SLO
admission / the draining worker).

- ``POST /generate`` — body ``{"tokens": [ints], "max_new": n}``;
  response ``{"id", "tokens", "outcome", "latency_ms"}`` with HTTP 200
  for ok, 429 for an SLO rejection (back off and retry), 503 while
  draining (retry against the next placement), 400 for a malformed,
  out-of-vocab, or can-never-finish (prompt + max_new over the cache)
  request (the ModeRefusal text passes through — the client learns
  WHY, not just that);
- ``GET /stats`` — the batcher's live stats dict (same payload the
  drive mode writes at exit).

Loopback by default, daemon threads, failure-is-refusal semantics —
the telemetry server's stance, because a request front that can kill the
worker it fronts is a self-DoS.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal


def serve_port_default() -> int:
    """``SERVE_PORT``: request-front port for serving/serve_lm.py
    (0/unset = in-process only, no HTTP front)."""
    try:
        return int(os.environ.get("SERVE_PORT", ""))
    except ValueError:
        return 0


def _log(msg: str) -> None:
    print(f"serve.frontend: {msg}", file=sys.stderr, flush=True)


class _Handler(BaseHTTPRequestHandler):
    queue = None                # class-bound by RequestFront.start
    batcher = None

    def log_message(self, format, *args):  # noqa: A002 (stdlib casing)
        pass

    def _send(self, code: int, payload: dict) -> None:
        body = json.dumps(payload, sort_keys=True).encode() + b"\n"
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib casing)
        try:
            if self.path == "/stats":
                self._send(200, self.batcher.stats())
            else:
                self._send(404, {"error": f"unknown path {self.path}",
                                 "paths": ["/generate (POST)", "/stats"]})
        except BrokenPipeError:
            pass
        except Exception as e:
            try:
                self._send(500, {"error": repr(e)})
            except Exception:
                pass

    def do_POST(self):  # noqa: N802 (stdlib casing)
        try:
            if self.path != "/generate":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            n = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
                tokens = body["tokens"]
                max_new = int(body.get("max_new", 16))
            except (json.JSONDecodeError, KeyError, TypeError,
                    ValueError) as e:
                self._send(400, {"error": f"bad request body: {e!r}; "
                                          f"expected {{'tokens': [ints],"
                                          f" 'max_new': n}}"})
                return
            try:
                req = self.queue.submit(tokens, max_new)
            except ModeRefusal as e:
                self._send(400, {"error": str(e), "outcome":
                                 "oov_refused"})
                return
            except ValueError as e:
                self._send(400, {"error": str(e)})
                return
            req.done.wait()
            code = {"ok": 200, "slo_rejected": 429,
                    "drained": 503, "refused": 400}.get(req.outcome, 500)
            payload = {
                "id": req.rid, "outcome": req.outcome,
                "tokens": req.tokens if req.outcome == "ok" else [],
                "latency_ms": round((req.latency_s or 0.0) * 1000.0, 3)}
            if req.error:
                payload["error"] = req.error
            self._send(code, payload)
        except BrokenPipeError:
            pass        # client hung up mid-wait: its problem
        except Exception as e:
            try:
                self._send(500, {"error": repr(e)})
            except Exception:
                pass


class RequestFront:
    """The serving thread wrapper (a daemon ``ThreadingHTTPServer``;
    ``port=0`` never binds — callers gate on :func:`serve_port_default`
    or an explicit flag)."""

    def __init__(self, queue, batcher, port: int,
                 host: str = "127.0.0.1"):
        self._queue = queue
        self._batcher = batcher
        self._host = host
        self._port = int(port)
        self._httpd: ThreadingHTTPServer | None = None

    @property
    def port(self) -> int:
        return (self._httpd.server_address[1] if self._httpd is not None
                else self._port)

    def start(self) -> "RequestFront | None":
        handler = type("_BoundHandler", (_Handler,),
                       {"queue": self._queue, "batcher": self._batcher})
        try:
            self._httpd = ThreadingHTTPServer((self._host, self._port),
                                              handler)
        except (OSError, OverflowError) as e:
            _log(f"could not bind {self._host}:{self._port} ({e}) — "
                 f"serving in-process only")
            return None
        self._httpd.daemon_threads = True
        threading.Thread(target=self._httpd.serve_forever,
                         kwargs={"poll_interval": 0.5},
                         name="serve-front", daemon=True).start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
