"""Live HTTP endpoint for a MetricsRegistry, plus the job and trace
surfaces.

Counterpart of ``pumiumtally_tpu/obs/exporter.py``: the registry's
Prometheus text over plain HTTP (stdlib ``http.server`` on a daemon
thread, which dies with the process). Endpoints:

  * ``/metrics`` (and ``/``): the registry's Prometheus text,
    content-type ``text/plain; version=0.0.4``;
  * ``/healthz``: ``ok``;
  * ``/buildz``: one JSON object naming the serving process: the
    package, its version, ``tuning.db.environment()`` (backend, the
    card's name, the cards visible), torch, CUDA and nvcc's versions,
    the pid, and every mounted endpoint;
  * the owner's extra endpoints: the scheduler mounts ``/jobs`` (the
    live job table) and ``/trace`` (the tracer's ring as Chrome-trace
    JSON). An endpoint callable that declares a positional parameter
    named ``query`` receives the parsed query string (``/jobs?limit=50``);
    one that returns a ``str`` is served as Prometheus text.

An unknown path answers 404 with a body naming the valid endpoints; an
endpoint that raises answers 500 and the server keeps serving.

``PumiTally`` and ``TallyScheduler`` start one when ``PUMI_TPU_PROM_PORT``
is set; port 0 binds an ephemeral port (``exporter.port`` reports it). A
port that cannot be bound logs one warning and the run continues.
"""
from __future__ import annotations

import inspect
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from ..utils.log import log_info, log_warn

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

ENV_PORT = "PUMI_TPU_PROM_PORT"


def _accepts_query(fn) -> bool:
    """True when an endpoint callable OPTS IN to the parsed query
    dict by declaring a positional parameter literally named
    ``query`` (decided by signature, not by trial call — a TypeError
    from inside the endpoint must surface as a 500, not be mistaken
    for an arity probe).  The name requirement is the contract: an
    endpoint with an unrelated optional positional (``chrome``'s
    ``records=None``) must NOT be handed the query dict."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):  # pragma: no cover - builtins
        return False
    for p in sig.parameters.values():
        if p.name == "query" and p.kind in (
            inspect.Parameter.POSITIONAL_ONLY,
            inspect.Parameter.POSITIONAL_OR_KEYWORD,
        ):
            return True
    return False


def build_info() -> dict:
    """The /buildz payload: the package, its version and the environment
    (a half-initialized process still answers, naming what failed)."""
    import torch

    info = {
        "package": "pumiumtally_tpu_torch",
        "version": None,
        "backend": None,
        "device": None,
        "n_devices": None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": None,
        "pid": os.getpid(),
    }
    try:
        from importlib.metadata import version

        info["version"] = version("pumiumtally-tpu")
    except Exception:  # pragma: no cover - metadata is environmental
        pass
    try:
        from ..tuning.db import environment

        info.update(environment())
    except Exception as e:  # pragma: no cover - a broken CUDA runtime
        info["error"] = f"{type(e).__name__}: {e}"[:200]
    from ..ops._build import nvcc_version

    info["nvcc"] = nvcc_version()
    return info


class MetricsExporter:
    """One HTTP server serving one registry's Prometheus text plus the
    optional extra JSON endpoints the owner registers."""

    def __init__(self, registry, port: int, host: str = "127.0.0.1",
                 endpoints: dict | None = None):
        self.registry = registry
        # path -> callable returning a JSON-able object (served as
        # application/json) or a str (served as Prometheus text); one
        # declaring a ``query`` parameter receives the parsed query
        # string as {key: last value} (e.g. /jobs?limit=50).
        self.endpoints = dict(endpoints or {})
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                path, _, rawq = self.path.partition("?")
                try:
                    if path in ("/", "/metrics"):
                        body = (
                            exporter.registry.render_prometheus().encode()
                        )
                        ctype = PROM_CONTENT_TYPE
                    elif path == "/healthz":
                        body, ctype = b"ok\n", "text/plain"
                    elif path == "/buildz":
                        # The build payload names every mounted route,
                        # so one probe finds the whole scrape surface.
                        info = dict(
                            build_info(),
                            endpoints=(
                                ["/metrics", "/healthz", "/buildz"]
                                + sorted(exporter.endpoints)
                            ),
                        )
                        body = (
                            json.dumps(info, sort_keys=True) + "\n"
                        ).encode()
                        ctype = "application/json"
                    elif path in exporter.endpoints:
                        query = {
                            k: v[-1]
                            for k, v in parse_qs(rawq).items()
                        }
                        result = exporter._call(path, query)
                        if isinstance(result, str):
                            body = result.encode()
                            ctype = PROM_CONTENT_TYPE
                        else:
                            body = (
                                json.dumps(result, default=str) + "\n"
                            ).encode()
                            ctype = "application/json"
                    else:
                        known = ", ".join(
                            ["/metrics", "/healthz", "/buildz"]
                            + sorted(exporter.endpoints)
                        )
                        body = (
                            f"unknown path {path!r}; valid endpoints: "
                            f"{known}\n"
                        ).encode()
                        self.send_response(404)
                        self.send_header("Content-Type", "text/plain")
                        self.send_header(
                            "Content-Length", str(len(body))
                        )
                        self.end_headers()
                        self.wfile.write(body)
                        return
                except Exception as e:
                    # An endpoint callable must never kill the scrape
                    # thread — report the failure as the response.
                    body = (
                        f"endpoint {path!r} failed: "
                        f"{type(e).__name__}: {e}\n"
                    ).encode()
                    self.send_response(500)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not log events
                pass

        self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        self._server.daemon_threads = True
        # stop() races between an owner's close() and the GC finalizer
        # thread: exactly one caller runs the shutdown.
        self._stop_lock = threading.Lock()
        self._stopped = False  # guarded by: self._stop_lock
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="pumi-metrics-exporter",
            daemon=True,
        )
        self._thread.start()

    def _call(self, path: str, query: dict):
        """Invoke one mounted endpoint, passing the parsed query dict
        to callables declaring a positional parameter (``/jobs`` takes
        ``?limit=``) and nothing to the zero-arg ones."""
        fn = self.endpoints[path]
        if _accepts_query(fn):
            return fn(query)
        return fn()

    @property
    def port(self) -> int:
        """The bound port (resolves port 0 to the ephemeral choice)."""
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}/metrics"

    def stop(self) -> None:
        """Shut the server down and release the socket (idempotent —
        called from facade close() AND the facade's GC finalizer)."""
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


def maybe_start_exporter(registry, port=None, endpoints=None):
    """Start an exporter when configured, else None.

    ``port`` defaults to the ``PUMI_TPU_PROM_PORT`` env var (unset →
    no exporter, zero cost).  Bind failures warn and return None."""
    if port is None:
        spec = os.environ.get(ENV_PORT, "").strip()
        if not spec:
            return None
        try:
            port = int(spec)
        except ValueError:
            log_warn(
                f"{ENV_PORT}={spec!r} is not a port number; "
                "metrics endpoint disabled"
            )
            return None
    try:
        exp = MetricsExporter(registry, port, endpoints=endpoints)
    except OSError as e:
        log_warn(
            f"metrics endpoint could not bind port {port} ({e}); "
            "continuing without it"
        )
        return None
    log_info(f"metrics endpoint serving at {exp.url}")
    return exp
