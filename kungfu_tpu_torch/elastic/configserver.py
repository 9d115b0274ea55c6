"""HTTP config server: the desired-membership oracle for elastic training.

Port of `kungfu_tpu/elastic/configserver.py`: the same routes, bodies
and status codes, so either package's workers and runners use either's
server. Capability parity: srcs/go/kungfu/elastic/configserver/configserver.go —
GET returns the current Cluster JSON, PUT installs a validated new cluster
(version++), POST resets, DELETE clears, /stop shuts down. Also embeddable
in kfrun (-builtin-config-port; parity: builtin-config-server.go).
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from kungfu_tpu_torch.plan.cluster import Cluster, ClusterError


class ConfigState:
    def __init__(self, initial: Optional[Cluster] = None):
        self._lock = threading.Lock()
        self._cluster = initial
        self._version = 0

    def get(self):
        with self._lock:
            return self._cluster, self._version

    def put(self, cluster: Cluster) -> int:
        cluster.validate()
        with self._lock:
            self._cluster = cluster
            self._version += 1
            return self._version

    def reset(self, cluster: Optional[Cluster]) -> None:
        with self._lock:
            self._cluster = cluster
            self._version = 0


class _Handler(BaseHTTPRequestHandler):
    state: ConfigState = None  # set by serve()
    stop_event: threading.Event = None

    def log_message(self, *args):  # quiet
        pass

    def _reply(self, code: int, body: bytes = b"", ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.rstrip("/") == "/stop":
            self._reply(200, b"{}")
            self.stop_event.set()
            return
        cluster, version = self.state.get()
        if cluster is None:
            self._reply(404, b'{"error": "no config"}')
            return
        body = json.dumps({**cluster.to_json(), "Version": version}).encode()
        self._reply(200, body)

    def do_PUT(self):
        n = int(self.headers.get("Content-Length", 0))
        try:
            cluster = Cluster.loads(self.rfile.read(n).decode())
            version = self.state.put(cluster)
        except (ValueError, ClusterError, json.JSONDecodeError) as e:
            self._reply(400, json.dumps({"error": str(e)}).encode())
            return
        self._reply(200, json.dumps({"Version": version}).encode())

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n).decode()
        cluster = Cluster.loads(body) if body.strip() else None
        self.state.reset(cluster)
        self._reply(200, b"{}")

    def do_DELETE(self):
        self.state.reset(None)
        self._reply(200, b"{}")


class ConfigServer:
    """Embeddable threaded config server."""

    def __init__(self, port: int, initial: Optional[Cluster] = None, host: str = "0.0.0.0"):
        self.state = ConfigState(initial)
        self.stop_event = threading.Event()
        handler = type("Handler", (_Handler,), {"state": self.state, "stop_event": self.stop_event})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        threading.Thread(target=self._watch_stop, daemon=True).start()

    def _watch_stop(self) -> None:
        # this daemon thread waits on the stop signal itself; stop() sets
        # it, and process exit reaps the thread
        self.stop_event.wait()
        self.httpd.shutdown()

    def stop(self) -> None:
        self.stop_event.set()
        self.httpd.shutdown()


def main(argv=None) -> None:
    p = argparse.ArgumentParser("kf-config-server")
    p.add_argument("-port", type=int, default=9100)
    p.add_argument("-init", type=str, default="", help="initial cluster JSON file")
    args = p.parse_args(argv)
    initial = None
    if args.init:
        with open(args.init) as f:
            initial = Cluster.loads(f.read())
    srv = ConfigServer(args.port, initial)
    srv.start()
    from kungfu_tpu_torch.telemetry import log

    log.echo(f"config server on :{srv.port}")
    # serving forever is the program; Ctrl-C interrupts the wait
    srv.stop_event.wait()


if __name__ == "__main__":
    main()
