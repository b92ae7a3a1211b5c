"""How the gateway reaches a worker over HTTP (the port's copy of
``HttpWorkerClient`` and ``parse_worker_url`` from
``tpu_engine/serving/clients.py``): a persistent-connection pool to one
worker with the reference's 5 s timeout (``gen_timeout_s`` for /generate,
/score and streams, clamped to a request's remaining budget).

Errors are classified for the gateway: a 4xx is ``ValueError`` (the
request's fault), a 503 whose body's ``kind`` is ``overloaded`` or
``deadline_exceeded`` is ``Overloaded`` or ``DeadlineExceeded`` (a shed:
the lane is healthy), and anything else (a refused connection, a timeout,
a 500, another 503) is ``WorkerError`` (a lane fault: the breaker counts
it). A socket timeout under a deadline-clamped read is
``DeadlineExceeded`` marked ``lane_suspect``. The health prober's reads
(``probe_health``) take a connection of their own, never a pool slot.
"""

from __future__ import annotations

import http.client
import json
import queue
import socket
from typing import Optional, Tuple

from tpu_engine_torch.utils.deadline import DeadlineExceeded, Overloaded


class WorkerError(Exception):
    """Dispatch failure: connection error, timeout, non-200, device error."""


def parse_worker_url(url: str, default_port: int = 8080) -> Tuple[str, int]:
    """'host', 'host:port' or 'http://host:port' -> (host, port)."""
    u = url.strip()
    if "://" in u:
        u = u.split("://", 1)[1]
    u = u.split("/", 1)[0]
    if ":" in u:
        host, port_s = u.rsplit(":", 1)
        return host, int(port_s)
    return u, default_port


class HttpWorkerClient:
    """Thread-safe persistent-connection pool to one worker; ``url`` is
    ``"host:port"``, the lane's name on the gateway's ring."""

    def __init__(self, url: str, timeout_s: float = 5.0,
                 default_port: int = 8080, pool_size: int = 64,
                 gen_timeout_s: float = 120.0):
        self.host, self.port = parse_worker_url(url, default_port)
        self.url = f"{self.host}:{self.port}"
        self._timeout = timeout_s
        self._gen_timeout = max(gen_timeout_s, timeout_s)
        self._pool: "queue.LifoQueue[Optional[http.client.HTTPConnection]]" \
            = queue.LifoQueue()
        for _ in range(pool_size):
            self._pool.put(None)  # connected at first use

    def _acquire(self) -> http.client.HTTPConnection:
        try:
            conn = self._pool.get(timeout=self._timeout)
        except queue.Empty:
            raise WorkerError(f"connection pool to {self.url} exhausted")
        if conn is None:
            try:
                conn = http.client.HTTPConnection(self.host, self.port,
                                                  timeout=self._timeout)
                conn.connect()
                conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                     1)
            except Exception as exc:
                self._pool.put(None)  # the slot goes back either way
                raise WorkerError(f"worker {self.url}: {exc}") from exc
        return conn

    def _release(self, conn: Optional[http.client.HTTPConnection]) -> None:
        self._pool.put(conn)

    def _read_timeout(self, body, timeout_s: float) -> Tuple[float, bool]:
        """(socket timeout, whether the request's deadline set it): never
        hold the socket much past the remaining budget (+250 ms, so the
        worker's own 503 can arrive and be classified)."""
        if isinstance(body, dict) and body.get("deadline_ms") is not None:
            budget = max(0.05, float(body["deadline_ms"]) / 1000.0 + 0.25)
            if budget < timeout_s:
                return budget, True
        return timeout_s, False

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 timeout_s: Optional[float] = None) -> dict:
        out = self._request_raw(method, path, body, timeout_s)
        try:
            return json.loads(out)
        except Exception as exc:
            raise WorkerError(
                f"worker {self.url}: bad response body: {exc}") from exc

    def _request_raw(self, method: str, path: str,
                     body: Optional[dict] = None,
                     timeout_s: Optional[float] = None) -> bytes:
        conn = self._acquire()
        deadline_clamped = False
        try:
            t, deadline_clamped = self._read_timeout(
                body, timeout_s if timeout_s is not None else self._timeout)
            conn.timeout = t
            if conn.sock is not None:
                conn.sock.settimeout(t)
            payload = json.dumps(body).encode() if body is not None else None
            headers = {"Content-Type": "application/json"} if payload else {}
            conn.request(method, path, body=payload, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        except Exception as exc:
            conn.close()
            self._release(None)
            raise self._transport_error(exc, deadline_clamped) from exc
        if resp.status != 200:
            raise self._classify_error_response(conn, resp.status, data)
        self._release(conn)
        return data

    def _transport_error(self, exc: BaseException,
                         deadline_clamped: bool) -> Exception:
        """A timeout under a deadline-clamped read: the client's budget
        ran out (DeadlineExceeded, no failover) while the lane held the
        request (``lane_suspect``: the breaker still counts it). Anything
        else: a lane fault."""
        if deadline_clamped and isinstance(exc, (socket.timeout,
                                                 TimeoutError)):
            shed = DeadlineExceeded(
                f"worker {self.url}: deadline expired awaiting response")
            shed.lane_suspect = True
            return shed
        return WorkerError(f"worker {self.url}: {exc}")

    def _classify_error_response(self, conn, status: int,
                                 data: bytes) -> Exception:
        """A non-200 response -> the exception to raise; the connection
        goes back to the pool where the response was read whole (4xx, a
        classified 503) and is closed otherwise."""
        if 400 <= status < 500:
            detail = ""
            try:
                detail = json.loads(data).get("error", "")
            except Exception:
                pass
            self._release(conn)
            return ValueError(
                f"worker {self.url} rejected request ({status}): {detail}")
        if status == 503:
            kind = None
            try:
                kind = json.loads(data).get("kind")
            except Exception:
                pass
            if kind in ("overloaded", "deadline_exceeded"):
                self._release(conn)
                exc_cls = (Overloaded if kind == "overloaded"
                           else DeadlineExceeded)
                return exc_cls(f"worker {self.url} shed request ({kind})")
        conn.close()
        self._release(None)
        return WorkerError(f"worker {self.url} returned {status}")

    def infer(self, payload: dict) -> dict:
        return self._request("POST", "/infer", payload)

    def infer_raw(self, payload: dict) -> bytes:
        """The response's bytes, relayed unparsed."""
        return self._request_raw("POST", "/infer", payload)

    def generate(self, payload: dict) -> dict:
        return self._request("POST", "/generate", payload,
                             timeout_s=self._gen_timeout)

    def score(self, payload: dict) -> dict:
        return self._request("POST", "/score", payload,
                             timeout_s=self._gen_timeout)

    def generate_stream(self, payload: dict):
        """POST /generate/stream and yield each SSE frame as it arrives.
        Admission failures (connect error, 4xx, shed 503) raise here,
        before the iterator is returned. Mid-stream, a transport failure
        raises ``WorkerError`` from the iterator and a premature end of
        the body ends it without a ``done`` event. The connection rejoins
        the pool only after a body read cleanly to its end; a truncated
        or abandoned stream closes it."""
        conn = self._acquire()
        deadline_clamped = False
        try:
            t, deadline_clamped = self._read_timeout(payload,
                                                     self._gen_timeout)
            conn.timeout = t
            if conn.sock is not None:
                conn.sock.settimeout(t)
            conn.request("POST", "/generate/stream",
                         body=json.dumps(payload).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
        except Exception as exc:
            conn.close()
            self._release(None)
            raise self._transport_error(exc, deadline_clamped) from exc
        if resp.status != 200:
            try:
                data = resp.read()
            except Exception:
                conn.close()
                self._release(None)
                raise WorkerError(
                    f"worker {self.url} returned {resp.status} "
                    f"(error body unreadable)")
            raise self._classify_error_response(conn, resp.status, data)

        def frames():
            clean = False
            try:
                buf = b""
                while True:
                    line = resp.readline()  # chunked decoding underneath
                    if not line:
                        break
                    buf += line
                    if buf.endswith(b"\n\n"):
                        yield buf
                        buf = b""
                # A partial frame left over: the body was cut mid-event;
                # it is dropped and the connection is not reused.
                clean = not buf
            except Exception as exc:
                raise self._transport_error(exc, deadline_clamped) from exc
            finally:
                if clean:
                    self._release(conn)
                else:
                    conn.close()
                    self._release(None)
        return frames()

    def drain(self) -> dict:
        return self._request("POST", "/admin/drain", {"action": "drain"})

    def undrain(self) -> dict:
        return self._request("POST", "/admin/drain", {"action": "undrain"})

    def set_role(self, role: str) -> dict:
        """POST /admin/role: flip the lane's serving role."""
        return self._request("POST", "/admin/role", {"role": role})

    def migrate(self, payload: dict,
                timeout_s: Optional[float] = None) -> dict:
        """POST /admin/migrate: export one live stream's row. The export
        waits for a tick boundary and its chain can be large, so the
        socket timeout is the caller's budget (the generation timeout
        when none is given); the worker's own wait is half a second
        less."""
        if timeout_s is not None:
            payload = {**payload, "timeout_s": max(0.5, timeout_s - 0.5)}
        return self._request("POST", "/admin/migrate", payload,
                             timeout_s=(timeout_s if timeout_s is not None
                                        else self._gen_timeout))

    def export_prefix(self, payload: dict,
                      timeout_s: Optional[float] = None) -> dict:
        """POST /admin/export_prefix: a peer lane's radix chain of a token
        prefix, within ``timeout_s`` (the fetch budget)."""
        return self._request("POST", "/admin/export_prefix", payload,
                             timeout_s=timeout_s)

    def health(self) -> dict:
        return self._request("GET", "/health")

    def trace_spans(self) -> list:
        """The lane's spans, rebuilt from GET /trace/export: each Chrome
        ``X`` event back to the recorder's schema (op, start, duration and
        the tree ids in ``args``), what the gateway's stitch needs."""
        data = self._request("GET", "/trace/export")
        spans = []
        for ev in data.get("traceEvents") or []:
            if ev.get("ph") != "X":
                continue
            args = ev.get("args") or {}
            if args.get("evicted_parent"):
                continue  # synthetic; the stitch makes its own
            span = {
                "request_id": args.get("request_id"),
                "op": ev.get("name"),
                "node": self.url,
                "duration_us": int(ev.get("dur", 0)),
                "start_ts": float(ev.get("ts", 0)) / 1e6,
                "ts": (float(ev.get("ts", 0)) + ev.get("dur", 0)) / 1e6,
            }
            for k in ("trace_id", "span_id", "parent_id", "cached",
                      "batch_size"):
                if k in args:
                    span[k] = args[k]
            extra = {k: v for k, v in args.items()
                     if k not in span and k != "request_id"}
            if extra:
                span["attrs"] = extra
            spans.append(span)
        return spans

    def flight_dump(self, reason: str) -> dict:
        """Dump the lane's flight recorder now."""
        return self._request("POST", "/admin/timeline", {"dump": reason})

    def probe_health(self, timeout_s: float = 5.0) -> dict:
        """/health on a dedicated short-lived connection, outside the data
        pool: a lane whose pooled connections are all held by streams is
        busy, not dead, and the health prober must not read a starved
        pool as a failed probe."""
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout_s)
        try:
            conn.request("GET", "/health")
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise WorkerError(
                    f"worker {self.url} /health returned {resp.status}")
            return json.loads(data)
        except WorkerError:
            raise
        except Exception as exc:
            raise WorkerError(f"worker {self.url}: {exc}") from exc
        finally:
            conn.close()
