"""HTTP/JSON wire protocol over the `ServingEngine` (stdlib only).

The paper's engine is a *service*: clients reach it over a REST
surface.  This module is that surface for the reproduction — a
dependency-free, threaded ``http.server`` front door that maps the
library's exceptions onto a structured error contract and the
executor's partition-incremental results onto chunked NDJSON streams.

Endpoints (all JSON):

  * ``GET  /v1/healthz``         — liveness probe
  * ``GET  /v1/report``          — the live `ServingReport`
  * ``GET  /v1/metrics``         — the engine's metrics registry in
    Prometheus text exposition format (the one non-JSON endpoint)
  * ``GET  /v1/trace/<query_id>`` — the span tree of a recent query
    (bounded ring; 404 once evicted or for an unknown id)
  * ``GET  /v1/semantic-model``  — the attached `SemanticModel` (404
    when the server has none)
  * ``POST /v1/query``           — ``{"sql": ..., "stream": bool}``;
    buffered JSON result, or NDJSON lines (``schema`` / ``row`` /
    ``summary`` / ``error`` kinds) streamed as partitions complete
  * ``POST /v1/nl2sql``          — ``{"question": ..., "execute":
    bool}``; compiles via the `NL2SQLOperator` validation loop

Authentication is per-tenant bearer tokens: ``HttpConfig.tokens`` maps
token → tenant name, and the resolved tenant is the one whose
`TenantPolicy` admits (and is billed for) the query.  With no tokens
configured the server is open and the tenant comes from the request
body (``"tenant"``, default ``"default"``).

The error contract (rendered in docs/http-api.md, which
``tests/test_docs.py`` holds to the JAX package's `ERROR_CONTRACT`;
``tests/test_torch_serve.py`` holds this one equal to it): every failure is
``{"error": {"code", "message", ...}}`` with the HTTP status
determined by the mapped exception — `ParseError` → 400 with character
position and caret, `AdmissionError` → 429, a token-bucket rejection →
429 with ``Retry-After``, `RequestFailed` → 503.
"""
from __future__ import annotations

import dataclasses
import http.client
import json
import math
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cost import UnknownTableError
from repro_torch.core.serving import AdmissionError, ServingEngine
from repro_torch.core.sqlparse import ParseError
from repro_torch.inference.pipeline import RequestFailed
from repro_torch.serve.semantic_model import (NL2SQLError, NL2SQLOperator,
                                              SemanticModel,
                                              SemanticValidationError)
from repro_torch.tables.table import Table

# code -> (HTTP status, meaning); docs/http-api.md renders this table,
# and it must equal the JAX package's key for key
ERROR_CONTRACT: Dict[str, Tuple[int, str]] = {
    "unauthorized": (401, "missing or unknown bearer token"),
    "not_found": (404, "unknown endpoint"),
    "bad_request": (400, "malformed JSON body or missing field"),
    "invalid_sql": (400, "SQL failed to parse or validate; the body "
                         "carries pos, token and a caret snippet"),
    "unknown_table": (400, "query references a table the catalog does "
                           "not have"),
    "nl2sql_rejected": (422, "no compilation attempt survived the "
                             "parse/optimize/semantic validation loop"),
    "throttled": (429, "tenant token bucket is empty; Retry-After "
                       "gives seconds until a token refills"),
    "budget_exhausted": (429, "tenant credit budget exhausted, or the "
                              "tenant is paused"),
    "backend_unavailable": (503, "an inference request exhausted its "
                                 "retries"),
    "shutting_down": (503, "the server (or its engine) is closed"),
    "timeout": (504, "query did not finish within the configured "
                     "timeout"),
    "internal": (500, "unexpected server error"),
}


class HttpError(Exception):
    """A failure with a wire representation (status + code + body)."""

    def __init__(self, code: str, message: str, *,
                 retry_after_s: Optional[float] = None,
                 extra: Optional[Dict[str, Any]] = None):
        if code not in ERROR_CONTRACT:
            raise ValueError(f"unknown error code {code!r}")
        self.status = ERROR_CONTRACT[code][0]
        self.code = code
        self.message = message
        self.retry_after_s = retry_after_s
        self.extra = extra or {}
        super().__init__(f"{self.status} {code}: {message}")

    def body(self) -> Dict[str, Any]:
        err: Dict[str, Any] = {"code": self.code, "message": self.message}
        err.update(self.extra)
        return {"error": err}


def error_for(exc: Exception, *,
              default_retry_s: float = 1.0) -> HttpError:
    """Map a library exception onto the wire error contract."""
    if isinstance(exc, HttpError):
        return exc
    if isinstance(exc, ParseError):
        return HttpError("invalid_sql", exc.message, extra={
            "pos": exc.pos, "token": exc.token, "caret": exc.caret()})
    if isinstance(exc, NL2SQLError):
        return HttpError("nl2sql_rejected", str(exc),
                         extra={"rejected_sql": exc.last_sql})
    if isinstance(exc, SemanticValidationError):
        return HttpError("invalid_sql", str(exc))
    if isinstance(exc, AdmissionError):
        return HttpError("budget_exhausted", str(exc),
                         retry_after_s=default_retry_s)
    if isinstance(exc, RequestFailed):
        return HttpError("backend_unavailable", str(exc),
                         retry_after_s=default_retry_s)
    if isinstance(exc, UnknownTableError):
        # only the catalog's own miss is client error; a bare KeyError
        # from anywhere else is a server bug and falls through to 500
        return HttpError("unknown_table", str(exc))
    if isinstance(exc, TimeoutError):
        return HttpError("timeout", str(exc))
    if isinstance(exc, RuntimeError) and "closed" in str(exc):
        return HttpError("shutting_down", str(exc))
    return HttpError("internal", f"{type(exc).__name__}: {exc}")


# ---------------------------------------------------------------------------
# JSON rendering
# ---------------------------------------------------------------------------


def _py(v: Any) -> Any:
    """A JSON-safe Python value for one table cell.  A ``torch.Tensor``
    is refused with `TypeError` (a 500 on the wire): a tensor in a result
    table is a fault of the engine, and ``str`` would send it as the
    text ``"tensor(...)"`` with a 200."""
    if isinstance(v, torch.Tensor):
        raise TypeError(f"a torch.Tensor ({tuple(v.shape)}, {v.dtype}, "
                        f"{v.device}) reached a result table")
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (np.bool_, bool)):
        return bool(v)
    if isinstance(v, np.ndarray):
        return [_py(x) for x in v]
    if isinstance(v, (int, float, str)) or v is None:
        return v
    return str(v)


def table_rows(table: Table) -> Tuple[List[str], List[List[Any]]]:
    """``(column names, row-major JSON-safe values)`` for a result."""
    cols = list(table.column_names)
    rows = [[_py(table.column(c)[i]) for c in cols]
            for i in range(table.num_rows)]
    return cols, rows


def _dumps(obj: Any) -> bytes:
    return json.dumps(obj, default=_py).encode("utf-8")


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HttpConfig:
    """Wire-level policy for an `AisqlHttpServer`."""
    host: str = "127.0.0.1"
    port: int = 0               # 0 = ephemeral (read server.port after start)
    # bearer token -> tenant name; empty = open server (tenant from the
    # request body, default "default")
    tokens: Dict[str, str] = dataclasses.field(default_factory=dict)
    # shed load instead of queueing when the tenant's token bucket is
    # empty: 429 + Retry-After, the wire-correct overload behaviour
    throttle: bool = True
    # Retry-After for 429/503 responses without a better number
    default_retry_after_s: float = 1.0
    # server-side cap on one query's wall time
    request_timeout_s: float = 120.0


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    app: "AisqlHttpServer"


class AisqlHttpServer:
    """The HTTP front door: wraps a `ServingEngine` (and optionally an
    `NL2SQLOperator`) behind the endpoints above.  Usable as a context
    manager; ``stop()`` shuts the listener down and leaves the engine
    to its owner (`ServingEngine.close` is idempotent, so closing both
    in either order is safe)."""

    def __init__(self, engine: ServingEngine, *,
                 nl2sql: Optional[NL2SQLOperator] = None,
                 semantic_model: Optional[SemanticModel] = None,
                 cfg: Optional[HttpConfig] = None):
        self.engine = engine
        self.cfg = cfg or HttpConfig()
        self.nl2sql = nl2sql
        self.semantic_model = semantic_model or (
            nl2sql.model if nl2sql is not None else None)
        # the operator's client is not a per-session object; serialize
        self._nl_lock = threading.Lock()
        self._httpd = _Server((self.cfg.host, self.cfg.port), _Handler)
        self._httpd.app = self
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "AisqlHttpServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="aisql-http", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=10.0)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "AisqlHttpServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request-level logic (called from handler threads) -------------
    def resolve_tenant(self, auth_header: Optional[str],
                       body: Dict[str, Any]) -> str:
        if self.cfg.tokens:
            token = None
            if auth_header and auth_header.startswith("Bearer "):
                token = auth_header[len("Bearer "):].strip()
            tenant = self.cfg.tokens.get(token) if token else None
            if tenant is None:
                raise HttpError("unauthorized",
                                "missing or unknown bearer token")
            return tenant
        return str(body.get("tenant", "default"))

    def check_throttle(self, tenant: str) -> None:
        """Load shedding: when the tenant's bucket is empty, answer 429
        + Retry-After instead of queueing (the library path would
        requeue the ticket until a token refills)."""
        if not self.cfg.throttle:
            return
        meter = self.engine.tenant(tenant)
        ok, shortfall = meter.bucket.peek()
        if not ok and meter.bucket.rate > 0.0:
            raise HttpError(
                "throttled",
                f"tenant {tenant!r} is over its query rate "
                f"({meter.bucket.rate:.4g}/s)",
                retry_after_s=shortfall)


# ---------------------------------------------------------------------------
# the request handler
# ---------------------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # keep-alive + small JSON responses interact badly with Nagle /
    # delayed-ACK (a flat ~40ms stall per request on loopback)
    disable_nagle_algorithm = True
    server: _Server

    # silence the default stderr request log
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    @property
    def app(self) -> AisqlHttpServer:
        return self.server.app

    # -- plumbing ------------------------------------------------------
    def _send_json(self, status: int, obj: Any,
                   headers: Optional[Dict[str, str]] = None) -> None:
        data = _dumps(obj)
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _send_text(self, status: int, text: str,
                   content_type: str) -> None:
        data = text.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_error_obj(self, err: HttpError) -> None:
        headers = {}
        if err.retry_after_s is not None:
            headers["Retry-After"] = str(
                max(int(math.ceil(err.retry_after_s)), 1))
        self._send_json(err.status, err.body(), headers)

    def _body(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        if not raw:
            return {}
        try:
            body = json.loads(raw)
        except ValueError:
            raise HttpError("bad_request", "request body is not JSON")
        if not isinstance(body, dict):
            raise HttpError("bad_request",
                            "request body must be a JSON object")
        return body

    # -- chunked NDJSON ------------------------------------------------
    def _begin_stream(self) -> None:
        # past this point the status line is on the wire: failures must
        # become a terminal {"kind": "error"} chunk, never a second
        # send_response (see do_POST)
        self._streaming = True
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def _chunk(self, obj: Any) -> None:
        data = _dumps(obj) + b"\n"
        self.wfile.write(f"{len(data):X}\r\n".encode("ascii")
                         + data + b"\r\n")
        self.wfile.flush()

    def _end_stream(self) -> None:
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    # -- routing -------------------------------------------------------
    def do_GET(self) -> None:  # noqa: N802
        try:
            if self.path == "/v1/healthz":
                self._send_json(200, {"status": "ok"})
            elif self.path == "/v1/report":
                report = self.app.engine.report()
                self._send_json(200, dataclasses.asdict(report))
            elif self.path == "/v1/metrics":
                text = self.app.engine.obs.registry.render_prometheus()
                self._send_text(200, text,
                                "text/plain; version=0.0.4; charset=utf-8")
            elif self.path.startswith("/v1/trace/"):
                qid = self.path[len("/v1/trace/"):]
                tree = self.app.engine.obs.ring.get(qid)
                if tree is None:
                    raise HttpError(
                        "not_found",
                        f"no trace for query {qid!r} (never traced, "
                        f"or evicted from the ring)")
                self._send_json(200, {"query_id": qid, "trace": tree})
            elif self.path == "/v1/semantic-model":
                model = self.app.semantic_model
                if model is None:
                    raise HttpError("not_found",
                                    "no semantic model attached")
                self._send_json(200, model.to_dict())
            else:
                raise HttpError("not_found",
                                f"unknown endpoint {self.path!r}")
        except Exception as e:
            self._send_error_obj(error_for(
                e, default_retry_s=self.app.cfg.default_retry_after_s))

    def do_POST(self) -> None:  # noqa: N802
        self._streaming = False
        try:
            body = self._body()
            tenant = self.app.resolve_tenant(
                self.headers.get("Authorization"), body)
            if self.path == "/v1/query":
                self._handle_query(tenant, body)
            elif self.path == "/v1/nl2sql":
                self._handle_nl2sql(tenant, body)
            else:
                raise HttpError("not_found",
                                f"unknown endpoint {self.path!r}")
        except Exception as e:
            err = error_for(
                e, default_retry_s=self.app.cfg.default_retry_after_s)
            if not self._streaming:
                self._send_error_obj(err)
                return
            # the chunked response already started: a second status line
            # would corrupt the keep-alive framing, so finish the body
            # with a terminal error event instead — and if even that
            # write fails, drop the connection
            try:
                self._chunk({"kind": "error", **err.body()["error"]})
                self._end_stream()
            except Exception:
                self.close_connection = True

    # -- endpoints -----------------------------------------------------
    def _handle_query(self, tenant: str, body: Dict[str, Any]) -> None:
        sql = body.get("sql")
        if not isinstance(sql, str) or not sql.strip():
            raise HttpError("bad_request", 'missing "sql" string field')
        self.app.check_throttle(tenant)
        if body.get("stream"):
            self._stream_query(tenant, sql)
        else:
            self._buffered_query(tenant, sql)

    def _buffered_query(self, tenant: str, sql: str) -> None:
        app = self.app
        ticket = app.engine.submit(tenant, sql)
        table = ticket.result(timeout=app.cfg.request_timeout_s)
        cols, rows = table_rows(table)
        payload: Dict[str, Any] = {
            "columns": cols, "rows": rows, "row_count": len(rows),
            "tenant": tenant, "query_id": ticket.query_id,
        }
        if ticket.report is not None:
            payload["stats"] = {
                "wall_s": ticket.wall_s,
                "queue_wait_s": ticket.queue_wait_s,
                "ai_calls": ticket.report.ai_calls,
                "ai_credits": ticket.report.ai_credits,
            }
        self._send_json(200, payload)

    def _stream_query(self, tenant: str, sql: str) -> None:
        """NDJSON streaming: the first failure (parse error, admission,
        backend) surfaces as a proper HTTP status — the stream only
        starts once the first batch exists; failures after that become
        a terminal ``{"kind": "error"}`` line."""
        app = self.app
        ticket = app.engine.submit(tenant, sql, stream=True)
        gen = ticket.batches(timeout=app.cfg.request_timeout_s)
        try:
            first = next(gen, None)
        except Exception:
            # error before any batch: the ticket is done; re-raise the
            # query's error for the normal status mapping
            raise
        if first is None:
            # no batches at all: either an empty result or nothing
            # streamed — fall back to the final table (also surfaces
            # errors with a proper status)
            table = ticket.result(timeout=app.cfg.request_timeout_s)
            cols, rows = table_rows(table)
            self._begin_stream()
            self._chunk({"kind": "schema", "columns": cols,
                         "tenant": tenant})
            for row in rows:
                self._chunk({"kind": "row", "values": row})
            self._emit_summary(ticket, len(rows))
            self._end_stream()
            return
        cols, rows = table_rows(first)
        self._begin_stream()
        self._chunk({"kind": "schema", "columns": cols, "tenant": tenant})
        count = 0
        for row in rows:
            self._chunk({"kind": "row", "values": row})
            count += 1
        # failures from here on (batch iteration, chunk writes, the
        # summary) propagate to do_POST, which sees the started stream
        # and emits a terminal {"kind": "error"} chunk
        for batch in gen:
            _, rows = table_rows(batch)
            for row in rows:
                self._chunk({"kind": "row", "values": row})
                count += 1
        self._emit_summary(ticket, count)
        self._end_stream()

    def _emit_summary(self, ticket, count: int) -> None:
        summary: Dict[str, Any] = {"kind": "summary", "row_count": count,
                                   "wall_s": ticket.wall_s,
                                   "query_id": ticket.query_id}
        if ticket.report is not None:
            summary["ai_calls"] = ticket.report.ai_calls
            summary["ai_credits"] = ticket.report.ai_credits
        self._chunk(summary)

    def _handle_nl2sql(self, tenant: str, body: Dict[str, Any]) -> None:
        app = self.app
        if app.nl2sql is None:
            raise HttpError("not_found", "no NL2SQL operator attached")
        question = body.get("question")
        if not isinstance(question, str) or not question.strip():
            raise HttpError("bad_request",
                            'missing "question" string field')
        with app._nl_lock:
            sql = app.nl2sql.compile(question)
        if not body.get("execute"):
            self._send_json(200, {"sql": sql, "tenant": tenant})
            return
        app.check_throttle(tenant)
        ticket = app.engine.submit(tenant, sql)
        table = ticket.result(timeout=app.cfg.request_timeout_s)
        cols, rows = table_rows(table)
        self._send_json(200, {
            "sql": sql, "columns": cols, "rows": rows,
            "row_count": len(rows), "tenant": tenant})


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class HttpStatusError(RuntimeError):
    """A non-2xx response the client did not retry away."""

    def __init__(self, status: int, body: Dict[str, Any]):
        self.status = status
        self.body = body
        err = body.get("error", {}) if isinstance(body, dict) else {}
        self.code = err.get("code", "unknown")
        super().__init__(f"HTTP {status} {self.code}: "
                         f"{err.get('message', body)}")


class AisqlHttpClient:
    """Minimal stdlib client for the server above.

    One `http.client.HTTPConnection` per client instance (use one
    client per thread).  429 responses are retried up to
    ``max_retries`` times honouring ``Retry-After``; connection
    failures are retried for GETs only (the server may already have
    executed a POST whose response was lost); everything else non-2xx
    raises `HttpStatusError`."""

    def __init__(self, host: str, port: int, *,
                 token: Optional[str] = None, tenant: Optional[str] = None,
                 timeout: float = 60.0, max_retries: int = 4,
                 max_retry_wait_s: float = 2.0):
        self.host, self.port = host, port
        self.token = token
        self.tenant = tenant
        self.timeout = timeout
        self.max_retries = max_retries
        self.max_retry_wait_s = max_retry_wait_s
        self.throttled_retries = 0      # 429s absorbed by waiting
        self._conn: Optional[http.client.HTTPConnection] = None

    # -- plumbing ------------------------------------------------------
    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
            conn.connect()
            # mirror the server's TCP_NODELAY: without it each pipelined
            # request eats a Nagle/delayed-ACK round trip
            conn.sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conn = conn
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self) -> "AisqlHttpClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _headers(self) -> Dict[str, str]:
        h = {"Content-Type": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    def _request(self, method: str, path: str,
                 body: Optional[Dict[str, Any]] = None):
        """One exchange with bounded 429 retries; returns the open
        response (2xx) for the caller to consume fully."""
        payload = dict(body or {})
        if self.tenant is not None and "tenant" not in payload:
            payload["tenant"] = self.tenant
        data = json.dumps(payload).encode() if method == "POST" else None
        for attempt in range(self.max_retries + 1):
            conn = self._connection()
            try:
                conn.request(method, path, body=data,
                             headers=self._headers())
                resp = conn.getresponse()
            except (ConnectionError, http.client.HTTPException, OSError):
                self.close()
                # only GETs are safe to resend: a POST the server may
                # already have executed (response lost on the wire)
                # would double-run the query and double-bill the tenant
                if method != "GET" or attempt >= self.max_retries:
                    raise
                continue
            if resp.status == 429 and attempt < self.max_retries:
                retry_after = float(resp.getheader("Retry-After") or 1.0)
                resp.read()             # drain; keep the connection
                self.throttled_retries += 1
                time.sleep(min(retry_after, self.max_retry_wait_s))
                continue
            if resp.status >= 300:
                raw = resp.read()
                try:
                    parsed = json.loads(raw)
                except ValueError:
                    parsed = {"error": {"message": raw.decode("utf-8",
                                                              "replace")}}
                raise HttpStatusError(resp.status, parsed)
            return resp
        raise HttpStatusError(429, {"error": {
            "code": "throttled",
            "message": f"still throttled after {self.max_retries} "
                       f"retries"}})

    # -- endpoints -----------------------------------------------------
    def healthz(self) -> Dict[str, Any]:
        return json.loads(self._request("GET", "/v1/healthz").read())

    def report(self) -> Dict[str, Any]:
        return json.loads(self._request("GET", "/v1/report").read())

    def metrics(self) -> str:
        """The raw Prometheus text exposition (parse it with
        ``repro_torch.obs.parse_prometheus_text``)."""
        return self._request("GET", "/v1/metrics").read().decode("utf-8")

    def trace(self, query_id: str) -> Dict[str, Any]:
        """``{"query_id", "trace"}`` for a recent query (404 →
        `HttpStatusError` once the ring evicted it)."""
        return json.loads(
            self._request("GET", f"/v1/trace/{query_id}").read())

    def semantic_model(self) -> Dict[str, Any]:
        return json.loads(
            self._request("GET", "/v1/semantic-model").read())

    def query(self, sql: str) -> Dict[str, Any]:
        resp = self._request("POST", "/v1/query", {"sql": sql})
        return json.loads(resp.read())

    def query_stream(self, sql: str) -> Iterator[Dict[str, Any]]:
        """Yield parsed NDJSON events (``schema``/``row``/``summary``);
        a terminal ``error`` event raises `HttpStatusError`."""
        resp = self._request("POST", "/v1/query",
                             {"sql": sql, "stream": True})
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line:
                continue
            event = json.loads(line)
            if event.get("kind") == "error":
                resp.read()
                raise HttpStatusError(
                    ERROR_CONTRACT.get(event.get("code", "internal"),
                                       (500, ""))[0],
                    {"error": event})
            yield event

    def nl2sql(self, question: str, *,
               execute: bool = False) -> Dict[str, Any]:
        resp = self._request("POST", "/v1/nl2sql",
                             {"question": question, "execute": execute})
        return json.loads(resp.read())
