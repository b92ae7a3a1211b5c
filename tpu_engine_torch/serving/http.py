"""Minimal threaded JSON-over-HTTP server for the port's serving
endpoints: the port's own copy of ``JsonHttpServer`` and ``sse_event``
from ``tpu_engine/serving/http.py`` (stdlib only).

Handlers return ``(status, payload)``; a payload of bytes is sent as it
is (the /infer response, already serialized), one that is an iterator of
byte chunks as a chunked Server-Sent-Events stream, each chunk written and
flushed as it arrives, and the iterator closed when the response ends
(a client that went away included). A ``ShedError`` (an expired
deadline, an overloaded or draining lane) maps to 503 with ``Retry-After``
and ``{"error", "kind"}``; KeyError, ValueError and TypeError map to 400,
NotImplementedError and every other exception to 500, with
``{"error": ...}`` bodies.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from tpu_engine_torch.utils.deadline import ShedError

Handler = Callable[[Optional[dict]], Tuple[int, dict]]


class _TrackingServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that can sever live keep-alive connections.

    `shutdown()` only stops the accept loop; handler threads blocked on the
    next keep-alive request would keep serving pooled client connections
    after "stop". Tracking the sockets lets stop() half-close them so those
    threads see EOF and exit.
    """

    # socketserver's default listen backlog is 5; benchmark clients open a
    # fresh connection per request at 50+ threads, so SYNs get dropped and
    # retransmitted (1 s tail spikes) without a real backlog.
    request_queue_size = 1024

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._conns = set()
        self._conns_lock = threading.Lock()
        # Requests currently INSIDE a handler (excludes idle keep-alive
        # connections): the graceful-drain wait in JsonHttpServer.stop.
        self.active_requests = 0
        self.active_lock = threading.Lock()
        # Set by stop(): handlers finish their current request, then close
        # the connection — live keep-alive pools converge to zero instead
        # of feeding new requests forever and defeating the drain wait.
        self.draining = False

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close_open_connections(self):
        with self._conns_lock:
            conns = list(self._conns)
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def sse_event(payload: dict) -> bytes:
    """One Server-Sent-Events frame. The single definition of the SSE wire
    format — worker streams, cross-host degraded streams, and any future
    framing change (event:/id: lines) all go through here."""
    return b"data: " + json.dumps(payload).encode() + b"\n\n"


class JsonHttpServer:
    def __init__(self, port: int, host: str = "0.0.0.0"):
        self._routes: Dict[Tuple[str, str], Handler] = {}
        # (method, prefix) -> handler(body, suffix), tried only when the
        # exact table misses.
        self._prefix_routes: Dict[Tuple[str, str], Callable] = {}
        self.host = host
        self.port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def route(self, method: str, path: str, handler: Handler) -> None:
        self._routes[(method.upper(), path)] = handler

    def route_prefix(self, method: str, prefix: str, handler) -> None:
        """A parameterized route: a path that starts with ``prefix`` (and
        misses the exact table) calls ``handler(body, suffix)``, the
        suffix being the rest of the path."""
        self._prefix_routes[(method.upper(), prefix)] = handler

    # -- lifecycle ------------------------------------------------------------

    def _make_handler(self):
        routes = self._routes
        # Longest prefix first.
        prefix_routes = sorted(self._prefix_routes.items(),
                               key=lambda kv: -len(kv[0][1]))

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # On the handler (StreamRequestHandler), not the server: without
            # TCP_NODELAY the two-write response (headers, body) stalls ~40 ms
            # behind Nagle + the peer's delayed ACK on keep-alive connections.
            disable_nagle_algorithm = True

            def log_message(self, *args):  # silence per-request stderr noise
                pass

            def _respond(self, status: int, payload,
                         content_type: str = "application/json",
                         extra_headers: Optional[Dict[str, str]] = None) -> None:
                # Handlers may return pre-serialized bytes (hot /infer
                # path), a dict, or an ITERATOR of byte chunks (streaming
                # SSE, e.g. /generate/stream) sent with chunked
                # transfer-encoding.
                if (not isinstance(payload, (bytes, bytearray, dict, list,
                                             str, int, float, bool,
                                             type(None)))
                        and hasattr(payload, "__iter__")):
                    self._respond_stream(status, payload)
                    return
                body = (payload if isinstance(payload, (bytes, bytearray))
                        else json.dumps(payload).encode())
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _respond_stream(self, status: int, chunks) -> None:
                """HTTP/1.1 chunked transfer of an event-chunk iterator;
                each chunk flushes immediately (SSE consumers read
                incrementally). An iterator error after the headers are out
                cannot become a 500 — the connection closes WITHOUT the
                terminal 0-chunk so clients see the truncation
                (IncompleteRead) instead of a well-formed-but-short
                stream. The iterator is closed however the response
                ends, so an abandoned stream's resources go at once."""
                try:
                    self._send_stream(status, chunks)
                finally:
                    close = getattr(chunks, "close", None)
                    if close is not None:
                        close()

            def _send_stream(self, status: int, chunks) -> None:
                self.send_response(status)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for chunk in chunks:
                        if not chunk:
                            continue
                        self.wfile.write(b"%x\r\n" % len(chunk))
                        self.wfile.write(chunk)
                        self.wfile.write(b"\r\n")
                        self.wfile.flush()
                except Exception:
                    # Never re-raise into _dispatch (a second response would
                    # corrupt the chunked framing); drop the connection so
                    # the truncation is detectable.
                    self.close_connection = True
                    return
                try:
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except OSError:
                    pass  # client went away mid-stream

            def _dispatch(self, method: str) -> None:
                path = self.path.split("?", 1)[0]
                handler = routes.get((method, path))
                if handler is None:
                    for (pm, prefix), ph in prefix_routes:
                        if pm == method and path.startswith(prefix):
                            suffix = path[len(prefix):]
                            handler = (lambda body, _h=ph, _s=suffix:
                                       _h(body, _s))
                            break
                if handler is None:
                    self._respond(404, {"error": f"no route {method} {self.path}"})
                    return
                with self.server.active_lock:
                    self.server.active_requests += 1
                try:
                    body = None
                    if method == "POST":
                        length = int(self.headers.get("Content-Length", 0))
                        raw = self.rfile.read(length) if length else b"{}"
                        body = json.loads(raw)
                    result = handler(body)
                    # (status, payload) or (status, payload, content_type)
                    # — e.g. /metrics returns Prometheus text exposition.
                    if len(result) == 3:
                        self._respond(result[0], result[1],
                                      content_type=result[2])
                    else:
                        self._respond(result[0], result[1])
                except ShedError as exc:
                    # A refusal by policy (an expired deadline): 503 and
                    # Retry-After so clients back off, and a "kind" so
                    # upstream hops classify it without string matching.
                    try:
                        self._respond(
                            503, {"error": str(exc), "kind": exc.kind},
                            extra_headers={"Retry-After": str(max(
                                1, int(exc.retry_after_s + 0.999)))})
                    except Exception:
                        pass
                except (KeyError, ValueError, TypeError) as exc:
                    # Malformed/unsupported request → 400 so gateways can
                    # tell client errors from worker failures (the reference
                    # returns 500 for everything, worker_node.cpp:180-186,
                    # which lets bad clients trip breakers fleet-wide).
                    try:
                        self._respond(400, {"error": str(exc)})
                    except Exception:
                        pass
                except Exception as exc:  # runtime/device failure → 500
                    try:
                        self._respond(500, {"error": str(exc)})
                    except Exception:
                        pass
                finally:
                    with self.server.active_lock:
                        self.server.active_requests -= 1
                    if getattr(self.server, "draining", False):
                        self.close_connection = True

            def do_POST(self):
                self._dispatch("POST")

            def do_GET(self):
                self._dispatch("GET")

        return _Handler

    def start(self, background: bool = True) -> None:
        self._server = _TrackingServer((self.host, self.port), self._make_handler())
        self._server.daemon_threads = True
        if self.port == 0:
            self.port = self._server.server_address[1]
        if background:
            self._thread = threading.Thread(
                target=self._server.serve_forever, name=f"http-{self.port}", daemon=True
            )
            self._thread.start()
        else:
            self._server.serve_forever()

    def stop(self, drain_s: float = 10.0) -> None:
        """Stop accepting, then DRAIN: wait up to `drain_s` for requests
        already inside handlers to write their responses before severing
        the remaining (idle keep-alive) connections — a SIGTERM must not
        reset a client mid-/generate."""
        if self._server is not None:
            self._server.draining = True  # keep-alives close after reply
            self._server.shutdown()  # accept loop stops; handlers keep going
            deadline = time.monotonic() + drain_s
            while time.monotonic() < deadline:
                with self._server.active_lock:
                    if self._server.active_requests == 0:
                        break
                time.sleep(0.05)
            self._server.close_open_connections()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
