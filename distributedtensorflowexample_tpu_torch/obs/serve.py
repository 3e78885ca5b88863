"""Live telemetry over HTTP — scrape a RUNNING process, not its corpse
(a copy of the JAX package's stdlib-only ``obs/serve.py``).

Every obs surface before round 12 was file-shaped: flights land on
death, the Prometheus textfile lands after a task, health.json lands at
hook cadence.  Files are the right postmortem transport, but the north
star "serving heavy traffic" needs the live shape too: a scraper (or an
operator with curl) asking a training process how it is doing RIGHT NOW.
This module is that surface — an opt-in (``OBS_HTTP_PORT``) background
``http.server`` thread per process, read-only, loopback by default:

- ``GET /metrics``  — the registry as Prometheus text (the same bytes
  ``obs/export.py`` writes to the textfile collector, so the two
  transports can never disagree on a value's spelling);
- ``GET /health``   — the §16 ``health.json`` contract: the registered
  in-process source (``training/hooks.AnomalyHook`` registers its
  ``RunHealth.payload``) or, failing that, the ``OBS_HEALTH`` file;
- ``GET /flight``   — the installed flight recorder's payload, built
  on demand (a postmortem for a process that has not died yet);
- ``GET /ledger/tail?n=50`` — the last rows of the ``OBS_LEDGER`` run
  ledger, parsed (torn lines skipped, like every ledger reader).

The server is a daemon thread: it dies with the process and never
blocks exit.  Failures are silent-by-contract (a port collision or a
handler exception must not kill the run it observes) — ``maybe_start``
logs the refusal to stderr and returns None.  The fleet supervisor
prefers this surface for its monitor pass (HTTP scrape of each rank's
``/health``, falling back to the file) and exports a per-rank port when
launched with ``--http``.

Stdlib-only (http.server, json, threading) like the rest of ``obs/``.
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import os

from distributedtensorflowexample_tpu_torch.obs import metrics as _metrics

# The in-process health source (AnomalyHook registers its RunHealth
# payload callable here): live detector state beats a file that is only
# as fresh as the last hook boundary.
_health_source = None


def set_health_source(fn) -> None:
    """Register ``fn() -> dict`` as this process's live health payload
    (last registration wins — one AnomalyHook per run by construction)."""
    global _health_source
    _health_source = fn


class _Handler(BaseHTTPRequestHandler):
    # Tests and drills hit this from the same box; per-request stderr
    # lines would interleave with the training logs they scrape around.
    def log_message(self, format, *args):  # noqa: A002 (stdlib signature)
        pass

    def _send(self, code: int, body: bytes,
              ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload) -> None:
        self._send(code, json.dumps(
            _metrics.json_safe(payload), sort_keys=True,
            allow_nan=False, default=str).encode() + b"\n")

    def do_GET(self):  # noqa: N802 (stdlib casing)
        try:
            url = urlparse(self.path)
            if url.path == "/metrics":
                from distributedtensorflowexample_tpu_torch.obs import (
                    export as _export)
                self._send(200, _export.prometheus_text().encode(),
                           ctype="text/plain; version=0.0.4")
            elif url.path == "/health":
                self._health()
            elif url.path == "/flight":
                self._flight()
            elif url.path in ("/ledger/tail", "/ledger"):
                self._ledger_tail(url)
            else:
                self._send_json(404, {"error": f"unknown path {url.path}",
                                      "paths": ["/metrics", "/health",
                                                "/flight", "/ledger/tail"]})
        except BrokenPipeError:
            pass        # scraper hung up mid-response: its problem
        except Exception as e:
            try:
                self._send_json(500, {"error": repr(e)})
            except Exception:
                pass    # telemetry must never kill the run it observes

    def _health(self) -> None:
        if _health_source is not None:
            self._send_json(200, _health_source())
            return
        # File fallback: a process without an AnomalyHook (bench) may
        # still have a health file some other writer maintains.
        path = os.environ.get("OBS_HEALTH", "")
        if path:
            from distributedtensorflowexample_tpu_torch.obs import (
                anomaly as _anomaly)
            payload = _anomaly.read_health(path)
            if payload is not None:
                self._send_json(200, payload)
                return
        self._send_json(503, {"error": "no health source in this process "
                                       "(no AnomalyHook registered, no "
                                       "readable OBS_HEALTH file)"})

    def _flight(self) -> None:
        from distributedtensorflowexample_tpu_torch.obs import (
            recorder as _recorder)
        rec = _recorder.get()
        if rec is None:
            self._send_json(503, {"error": "no flight recorder installed "
                                           "(supervised runs and "
                                           "OBS_FLIGHT=1 arm one)"})
            return
        self._send_json(200, rec.payload("http"))

    def _ledger_tail(self, url) -> None:
        from distributedtensorflowexample_tpu_torch.obs import ledger as _ledger
        path = _ledger.ledger_path()
        if not path or not os.path.exists(path):
            self._send_json(503, {"error": "no run ledger in this process "
                                           "(OBS_LEDGER unset or file "
                                           "missing)"})
            return
        try:
            n = int(parse_qs(url.query).get("n", ["50"])[0])
        except ValueError:
            n = 50
        # Bounded tail read: this handler runs inside the observed
        # process — a poll must not bill it a full-file re-parse.
        rows, torn = _ledger.tail_rows(path, n)
        self._send_json(200, {"path": path, "torn": torn, "rows": rows})


class ObsServer:
    """The serving thread; ``port=0`` binds an ephemeral port (the
    bound one is on ``.port`` after :meth:`start`)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._host = host
        self._port = int(port)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return (self._httpd.server_address[1] if self._httpd is not None
                else self._port)

    def start(self) -> "ObsServer":
        self._httpd = ThreadingHTTPServer((self._host, self._port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.5},
            name="obs-serve", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


_GLOBAL: ObsServer | None = None


def get() -> ObsServer | None:
    return _GLOBAL


def maybe_start() -> ObsServer | None:
    """Start the per-process scrape endpoint iff ``OBS_HTTP_PORT`` is a
    positive port (the fleet supervisor exports one per rank under
    ``--http``; an operator exports one by hand) — THE one arming
    predicate, consulted next to ``recorder.maybe_install`` in every
    entrypoint.  Idempotent; refusals (bad value, port taken) go to
    stderr and return None: a scrape endpoint must never be the reason
    a run dies."""
    global _GLOBAL
    if _GLOBAL is not None:
        return _GLOBAL
    raw = os.environ.get("OBS_HTTP_PORT", "")
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        print(f"obs.serve: OBS_HTTP_PORT={raw!r} is not a port — not "
              f"serving", file=sys.stderr, flush=True)
        return None
    if port <= 0:
        return None
    if port > 65535:
        # Out-of-range before bind: socket raises OverflowError there,
        # which is NOT an OSError — uncaught it would break the
        # never-kill-the-run contract on an operator typo.
        print(f"obs.serve: OBS_HTTP_PORT={port} is out of range — not "
              f"serving", file=sys.stderr, flush=True)
        return None
    try:
        _GLOBAL = ObsServer(port).start()
    except (OSError, OverflowError) as e:
        print(f"obs.serve: could not bind 127.0.0.1:{port} ({e}) — not "
              f"serving", file=sys.stderr, flush=True)
        _GLOBAL = None
        return None
    return _GLOBAL
