"""Per-worker telemetry HTTP endpoint: /metrics, /trace, /audit, /steptrace,
/decisions, /resources, /memory and /host/telemetry.

Port of `kungfu_tpu/telemetry/http.py` (parity: the reference peer's
port+10000 monitoring server, srcs/go/monitor/server.go, extended to the
whole telemetry subsystem):

- ``/metrics``  Prometheus text exposition of the process registry
  (plus attached renderers, e.g. the net monitor's windowed rates);
- ``/trace``    Chrome-trace JSON of the span ring;
- ``/audit``    the resize/strategy audit log as JSON; ``?since=<seq>``
  ships only records created or annotated past that cursor;
- ``/steptrace`` the step plane's ring of per-step timelines
  (:mod:`~kungfu_tpu_torch.telemetry.steptrace`); ``?since=<seq>`` ships
  only timelines flushed past that cursor;
- ``/decisions`` the decision ledger's document
  (:mod:`~kungfu_tpu_torch.telemetry.decisions`), with the same
  ``?since=`` cursor over its records;
- ``/resources`` the resource plane's per-bucket CPU accounting and
  optional profiler aggregation
  (:mod:`~kungfu_tpu_torch.telemetry.resource`), with perf-clock anchors;
- ``/memory`` the memory plane's per-bucket byte accounting and headroom
  forecast (:mod:`~kungfu_tpu_torch.telemetry.memory`), same anchors;
- ``/host/telemetry`` the host sub-aggregator's digest when this worker
  is its host's elected head at scale, ``{"enabled": false}`` otherwise
  (:func:`~kungfu_tpu_torch.telemetry.cluster.host_digest_doc`).

Any other path is a 404. A query string never selects the route; a view that raises is a 500. Every 200 carries
this process's perf clock and wall clock as headers, for offline trace
merges.

``stop()`` both shuts the serve loop down AND closes the listening
socket, so a stopped peer never leaks its telemetry port.
"""

from __future__ import annotations

import inspect
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qsl, urlsplit

from kungfu_tpu_torch.telemetry import audit, metrics, tracing

# every response carries this process's monotonic clock (perf_counter
# microseconds — the span tracer's timebase) so a scraper can estimate
# the clock offset from its request round trip and merge traces from
# many workers onto one timeline
CLOCK_HEADER = "X-KF-Perf-Now-Us"
WALL_HEADER = "X-KF-Wall-Time-S"


def _since(query: Dict[str, str]) -> Optional[int]:
    """The delta-scrape cursor of a route's query; a malformed value
    reads as 'no cursor' (the full document), never a 500."""
    raw = query.get("since")
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def _steptrace_doc(since: Optional[int] = None) -> dict:
    # lazy: most processes serving /metrics never record a step, and the
    # store's knobs resolve at first use, not at server construction
    from kungfu_tpu_torch.telemetry import steptrace

    return steptrace.get_store().export(since=since)


def _host_doc() -> dict:
    # lazy: only a worker elected host sub-aggregator serves a real
    # digest; everyone else answers {"enabled": false}
    from kungfu_tpu_torch.telemetry import cluster

    return cluster.host_digest_doc()


def _decisions_doc(since: Optional[int] = None) -> dict:
    # lazy: the ledger's knobs resolve at first use, not at server
    # construction
    from kungfu_tpu_torch.telemetry import decisions

    return decisions.get_ledger().export(since=since)


def _resources_doc() -> dict:
    # lazy: the plane's knobs resolve at first use
    from kungfu_tpu_torch.telemetry import resource

    return resource.get_plane().export()


def _memory_doc() -> dict:
    # lazy: the plane's knobs resolve at first use
    from kungfu_tpu_torch.telemetry import memory

    return memory.get_plane().export()


def _adapt_route(fn: Callable) -> Callable[[Dict[str, str]], "tuple[str, str]"]:
    """Make a route callable accept the parsed query dict: routes taking
    one positional parameter get it, zero-argument callables are
    wrapped."""
    try:
        params = [
            p for p in inspect.signature(fn).parameters.values()
            if p.default is inspect.Parameter.empty
            and p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                           inspect.Parameter.POSITIONAL_OR_KEYWORD)
        ]
        takes_query = len(params) >= 1
    except (TypeError, ValueError):
        takes_query = False
    if takes_query:
        return fn
    return lambda query, _fn=fn: _fn()


class TelemetryServer:
    def __init__(
        self,
        port: int,
        host: str = "0.0.0.0",
        registry: Optional[metrics.Registry] = None,
        extra_routes: Optional[Dict[str, Callable[[], "tuple[str, str]"]]] = None,
    ):
        reg = registry or metrics.get_registry()

        def _metrics_page() -> "tuple[str, str]":
            # self-health gauges (RSS/fds/threads/uptime) are sampled on
            # demand: every scrape refreshes them
            metrics.update_process_health(reg)
            return reg.render(), "text/plain; version=0.0.4"

        routes: Dict[str, Callable] = {
            "/metrics": _metrics_page,
            "/trace": lambda: (tracing.chrome_trace_json(), "application/json"),
            "/audit": lambda q: (json.dumps(audit.to_json(since=_since(q))),
                                 "application/json"),
            "/steptrace": lambda q: (json.dumps(_steptrace_doc(_since(q))),
                                     "application/json"),
            "/decisions": lambda q: (json.dumps(_decisions_doc(_since(q))),
                                     "application/json"),
            "/resources": lambda: (json.dumps(_resources_doc()), "application/json"),
            "/memory": lambda: (json.dumps(_memory_doc()), "application/json"),
            "/host/telemetry": lambda: (json.dumps(_host_doc()), "application/json"),
        }
        if extra_routes:
            routes.update(extra_routes)
        routes = {path: _adapt_route(fn) for path, fn in routes.items()}

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(inner):
                # query/fragment never select the route: a scraper's
                # cache-buster (/metrics?t=...) must hit /metrics
                split = urlsplit(inner.path)
                path = split.path.rstrip("/")
                route = routes.get(path or "/metrics")
                if route is None:
                    inner.send_response(404)
                    inner.end_headers()
                    return
                try:
                    body_s, ctype = route(dict(parse_qsl(split.query)))
                except Exception as e:  # noqa: BLE001 - a broken view is a 500, not a crash
                    inner.send_response(500)
                    inner.end_headers()
                    inner.wfile.write(str(e).encode())
                    return
                body = body_s.encode()
                inner.send_response(200)
                inner.send_header("Content-Type", ctype)
                inner.send_header("Content-Length", str(len(body)))
                inner.send_header(CLOCK_HEADER, repr(time.perf_counter() * 1e6))
                inner.send_header(WALL_HEADER, repr(time.time()))
                inner.end_headers()
                inner.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._stopped = threading.Event()
        self._started = False

    def start(self) -> None:
        self._started = True
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        if self._started:
            # shutdown() handshakes with serve_forever; calling it on a
            # never-started server blocks forever
            self.httpd.shutdown()
        self.httpd.server_close()  # release the port NOW, not at GC
