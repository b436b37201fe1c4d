"""Network ingress for the serving fleet: idempotent HTTP job intake.

Counterpart of ``pumiumtally_tpu/serving/gateway.py``, with the same
routes, status codes and payloads. ``TallyGateway`` puts a stdlib
``ThreadingHTTPServer`` (daemon threads, as ``obs/exporter.py``) in front
of a ``FleetRouter``:

  * ``POST /submit``: the body is the ``serving/journal.py`` request wire
    format (``request_to_json``: origins, n_moves, weights, groups,
    source, job_id; float64 payloads survive bitwise through json's
    repr) with an optional ``idempotency_key``. The key is journaled in
    FLEET.json before the job is accepted on any member
    (``FleetRouter.submit``), so a client that times out and retries
    gets the same job id back and never starts a second run. An
    optional ``traceparent`` header (W3C ``00-<32 hex>-<16 hex>-<2
    hex>``, or a bare 16-32 hex trace id) makes the job join the
    caller's trace; a malformed one is a 400. Answers ``{"job": id,
    "trace_id": ...}`` (a dedup answers the original submission's
    trace).
  * ``GET /status/<job>``: state, outcome, moves, member, trace id.
  * ``GET /result/<job>``: the finished flux, bitwise: dtype, shape and
    base64 of the raw little-endian buffer. 409 while the job has no
    result.
  * ``GET /progress/<job>?since=N&timeout=S``: the job's flight records
    as JSONL, one line a record, polled from the fleet's recorder until
    the job ends (or ``timeout`` seconds pass), each row carrying the
    job's ``trace_id``; HTTP/1.0 connection-close framing, so the closed
    socket ends the stream.
  * ``POST /cancel``: body ``{"job": id}``; answers ``{"job": id,
    "cancelled": bool}`` (false: it had already ended).
  * ``GET /healthz``: liveness.

A job id in a path or body is checked with the journal's
``check_job_id`` before any file name could be made from it (a 400);
malformed JSON and failed validation are 400s with the reason; unknown
jobs are 404s; an unknown path answers 404 with the routes.

Every connection has a read and write deadline (``request_timeout_s``,
the handler's socket timeout), so a client that stalls times its socket
out instead of holding a handler thread. When every healthy member is at
its queue bound (``FleetRouter.backpressured``), ``POST /submit``
answers 503 with ``Retry-After`` and ``retry_after_s`` /
``retry_jitter_s`` in the body, before anything is journaled: a refused
request burns no idempotency key.

Handler threads launch no CUDA work: a submission only enqueues, and a
finished job's flux is a host array already.
"""
from __future__ import annotations

import base64
import json
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils.log import log_info
from .journal import check_job_id, request_from_json

#: Routes the 404 body teaches (the gateway's whole surface).
ROUTES = (
    "POST /submit", "POST /cancel", "GET /status/<job>",
    "GET /result/<job>", "GET /progress/<job>", "GET /healthz",
)

# W3C trace-context header (version-traceid-parentid-flags), or the
# bare trace id our own SpanTracer mints (16 hex) / other tracers'
# 32-hex ids.  The trace id is all the fleet keeps — span parentage
# inside the job is ours, the caller only needs the join key.
_W3C_TRACEPARENT = re.compile(
    r"00-([0-9a-f]{32})-[0-9a-f]{16}-[0-9a-f]{2}"
)
_BARE_TRACE_ID = re.compile(r"[0-9a-f]{16,32}")


def parse_traceparent(header: str | None) -> str | None:
    """The caller's trace id from a ``traceparent`` header, or None
    when the header is absent/blank (the job mints its own trace).
    Raises ValueError on a malformed non-empty header."""
    if header is None or not header.strip():
        return None
    text = header.strip().lower()
    m = _W3C_TRACEPARENT.fullmatch(text)
    if m is not None:
        return m.group(1)
    if _BARE_TRACE_ID.fullmatch(text):
        return text
    raise ValueError(
        f"traceparent {header!r} is neither W3C "
        "00-<32 hex>-<16 hex>-<2 hex> nor a bare 16-32 hex trace id"
    )


class TallyGateway:
    """One HTTP ingress bound to one ``FleetRouter`` (module docstring
    API). Handler threads and the router's scheduling loop serialize on
    the router's lock; the gateway holds no job state of its own."""

    def __init__(self, router, port: int = 0, host: str = "127.0.0.1",
                 *, request_timeout_s: float = 30.0,
                 retry_after_s: float = 1.0):
        if float(request_timeout_s) <= 0:
            raise ValueError(
                f"request_timeout_s must be > 0: {request_timeout_s}"
            )
        if float(retry_after_s) <= 0:
            raise ValueError(
                f"retry_after_s must be > 0: {retry_after_s}"
            )
        self.router = router
        self.request_timeout_s = float(request_timeout_s)
        self.retry_after_s = float(retry_after_s)
        gateway = self

        class _Handler(BaseHTTPRequestHandler):
            # socketserver's setup() applies this as the connection's
            # settimeout — one deadline covering every blocking read
            # AND write on the socket (module docstring).
            timeout = self.request_timeout_s

            def do_POST(self):  # noqa: N802 — http.server API
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/submit":
                        self._answer(gateway._submit(
                            self._body(),
                            traceparent=self.headers.get("traceparent"),
                        ))
                    elif path == "/cancel":
                        self._answer(gateway._cancel(self._body()))
                    else:
                        self._unknown(path)
                except OSError:
                    # Stalled or vanished client (socket timeout,
                    # reset): drop the connection; there is nobody
                    # left to answer, and the handler thread must not
                    # wedge (TimeoutError is an OSError here).
                    self.close_connection = True

            def do_GET(self):  # noqa: N802 — http.server API
                try:
                    path, _, query = self.path.partition("?")
                    if path == "/healthz":
                        self._answer((200, {"ok": True}))
                    elif path.startswith("/status/"):
                        self._answer(
                            gateway._status(path[len("/status/"):])
                        )
                    elif path.startswith("/result/"):
                        self._answer(
                            gateway._result(path[len("/result/"):])
                        )
                    elif path.startswith("/progress/"):
                        self._stream(path[len("/progress/"):], query)
                    else:
                        self._unknown(path)
                except OSError:
                    self.close_connection = True

            # -- plumbing ---------------------------------------- #
            def _body(self) -> bytes:
                length = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(length)

            def _answer(self, status_payload) -> None:
                status, payload, *rest = status_payload
                headers = rest[0] if rest else {}
                body = (
                    json.dumps(payload, sort_keys=True) + "\n"
                ).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for name, value in headers.items():
                    self.send_header(name, str(value))
                self.end_headers()
                self.wfile.write(body)

            def _unknown(self, path: str) -> None:
                self._answer((404, {
                    "error": f"unknown path {path!r}",
                    "routes": list(ROUTES),
                }))

            def _stream(self, job_id: str, query: str) -> None:
                """JSONL progress stream (module docstring framing:
                HTTP/1.0 connection-close, so no Content-Length and
                the socket end IS the end of stream)."""
                params = dict(
                    kv.split("=", 1)
                    for kv in query.split("&") if "=" in kv
                )
                try:
                    check_job_id(job_id)
                except ValueError as e:
                    self._answer((400, {"error": str(e)}))
                    return
                try:
                    since = int(params.get("since", -1))
                    timeout = float(params.get("timeout", 30.0))
                except ValueError as e:
                    self._answer((400, {"error": f"bad query: {e}"}))
                    return
                try:
                    records, terminal = gateway.router.progress(
                        job_id, since
                    )
                except KeyError:
                    self._answer(
                        (404, {"error": f"unknown job {job_id!r}"})
                    )
                    return
                try:
                    trace_id = gateway.router.job(job_id).trace_id
                except KeyError:  # pragma: no cover - races a drop
                    trace_id = None
                self.send_response(200)
                self.send_header(
                    "Content-Type", "application/jsonl"
                )
                self.end_headers()
                deadline = time.monotonic() + timeout
                while True:
                    for rec in records:
                        row = dict(rec)
                        row.setdefault("trace_id", trace_id)
                        self.wfile.write(
                            (json.dumps(row, sort_keys=True,
                                        default=str) + "\n").encode()
                        )
                        since = max(since, rec.get("seq", since))
                    self.wfile.flush()
                    if terminal or time.monotonic() > deadline:
                        return
                    time.sleep(0.05)
                    try:
                        records, terminal = gateway.router.progress(
                            job_id, since
                        )
                    except KeyError:  # pragma: no cover - races a drop
                        return

            def log_message(self, *args):  # requests are not log events
                pass

        self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        self._server.daemon_threads = True
        # stop() may race between teardown paths; the flag flip is
        # atomic so that exactly one caller shuts the server down.
        self._stop_lock = threading.Lock()
        self._stopped = False  # guarded by: self._stop_lock
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="pumi-tally-gateway",
            daemon=True,
        )
        self._thread.start()
        log_info(f"tally gateway serving at {self.url}")

    # ------------------------------------------------------------------ #
    # Route handlers (return (status, json-able payload))
    # ------------------------------------------------------------------ #
    def _submit(self, body: bytes, traceparent: str | None = None):
        try:
            caller_trace = parse_traceparent(traceparent)
        except ValueError as e:
            return 400, {"error": str(e)}
        try:
            payload = json.loads(body.decode() or "null")
        except ValueError as e:
            return 400, {"error": f"body is not JSON: {e}"}
        if not isinstance(payload, dict):
            return 400, {"error": "body must be a JSON object"}
        key = payload.pop("idempotency_key", None)
        if key is not None and not isinstance(key, str):
            return 400, {"error": "idempotency_key must be a string"}
        # Path-unsafe ids are refused BEFORE request_from_json could
        # hand them anywhere a filesystem name is formed.
        job_id = payload.get("job_id")
        if job_id is not None:
            try:
                check_job_id(str(job_id))
            except ValueError as e:
                return 400, {"error": str(e)}
        try:
            request = request_from_json(payload)
        except (KeyError, TypeError, ValueError) as e:
            return 400, {
                "error": f"bad request: {type(e).__name__}: {e}"
            }
        # The caller's traceparent wins only when the wire request did
        # not already carry a trace id (a retried submit round-trips
        # the original identity through the body).
        if caller_trace is not None and request.trace_id is None:
            request.trace_id = caller_trace
        # Backpressure answers BEFORE router.submit journals anything:
        # a 503'd request must not burn an idempotency key on a job no
        # member would admit (module docstring).
        if self.router.backpressured():
            return self._too_busy(
                "fleet backpressured: every healthy member is at "
                "its admission bound"
            )
        try:
            accepted = self.router.submit(
                request, idempotency_key=key
            )
        except ValueError as e:
            return 400, {"error": str(e)}
        except RuntimeError as e:
            # No alive member to place on (mid-eviction trough): the
            # request is retryable, not wrong.
            return self._too_busy(str(e))
        try:
            trace_id = self.router.job(accepted).trace_id
        except KeyError:  # pragma: no cover - races an instant drop
            trace_id = caller_trace
        return 200, {"job": accepted, "trace_id": trace_id}

    def _too_busy(self, reason: str):
        """503 + Retry-After + jittered-backoff guidance (module
        docstring): the client sleeps ``retry_after_s + uniform(0,
        retry_jitter_s)`` then retries with the SAME idempotency
        key."""
        return 503, {
            "error": reason,
            "retry_after_s": self.retry_after_s,
            "retry_jitter_s": self.retry_after_s / 2.0,
            "guidance": (
                "sleep retry_after_s + uniform(0, retry_jitter_s), "
                "then retry the same request with the same "
                "idempotency_key"
            ),
        }, {"Retry-After": int(math.ceil(self.retry_after_s))}

    def _cancel(self, body: bytes):
        try:
            payload = json.loads(body.decode() or "null")
        except ValueError as e:
            return 400, {"error": f"body is not JSON: {e}"}
        if not isinstance(payload, dict) or "job" not in payload:
            return 400, {"error": 'body must be {"job": <id>}'}
        job_id = str(payload["job"])
        try:
            check_job_id(job_id)
        except ValueError as e:
            return 400, {"error": str(e)}
        try:
            cancelled = self.router.cancel(job_id)
        except KeyError:
            return 404, {"error": f"unknown job {job_id!r}"}
        return 200, {"job": job_id, "cancelled": cancelled}

    def _status(self, job_id: str):
        try:
            check_job_id(job_id)
        except ValueError as e:
            return 400, {"error": str(e)}
        try:
            job = self.router.job(job_id)
        except KeyError:
            return 404, {"error": f"unknown job {job_id!r}"}
        return 200, {
            "job": job.id,
            "state": job.state,
            "outcome": job.outcome,
            "error": job.error,
            "moves_done": job.moves_done,
            "n_moves": int(job.request.n_moves),
            "member": self.router.member_of(job_id),
            "preemptions": job.preemptions,
            "retries": job.retries,
            "trace_id": job.trace_id,
            "device_seconds": job.device_seconds,
        }

    def _result(self, job_id: str):
        try:
            check_job_id(job_id)
        except ValueError as e:
            return 400, {"error": str(e)}
        try:
            # A finished job's flux is the host copy its scheduler took
            # when the job ended (``job.result = job.tally.raw_flux
            # .copy()``): this thread touches no CUDA state.
            flux = self.router.result(job_id)
        except KeyError:
            return 404, {"error": f"unknown job {job_id!r}"}
        except RuntimeError as e:
            return 409, {"error": str(e)}
        arr = np.ascontiguousarray(flux)
        le = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        return 200, {
            "job": job_id,
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
            "data_b64": base64.b64encode(le.tobytes()).decode(),
        }

    # ------------------------------------------------------------------ #
    @property
    def port(self) -> int:
        """The bound port (resolves port 0 to the ephemeral choice)."""
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self) -> None:
        """Shut the ingress down and release the socket (idempotent —
        teardown paths and finalizers both call it)."""
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


def decode_result(payload: dict):
    """Reverse of ``GET /result``'s encoding: the client's helper for
    bitwise comparisons."""
    raw = base64.b64decode(payload["data_b64"])
    arr = np.frombuffer(
        raw, dtype=np.dtype(payload["dtype"]).newbyteorder("<")
    )
    return (
        arr.astype(np.dtype(payload["dtype"]), copy=False)
        .reshape(payload["shape"])
    )
