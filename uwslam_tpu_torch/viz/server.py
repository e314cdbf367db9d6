"""A live trajectory view over HTTP, in place of uw-slam's Rviz stream
(which blocks the pipeline until a subscriber connects,
src/Visualizer.cpp:376-384).

Counterpart of `uwslam_tpu.viz.server`. The standard library's
`http.server` runs on a daemon thread: tracking never waits for it, and any
browser is the viewer.

    server = VizServer(port=8090)        # port=0: an ephemeral port, see .port
    server.update(est_positions, gt_positions)
    # browse http://127.0.0.1:8090 (it refreshes itself); /state.json for data
    server.close()
"""
from __future__ import annotations

import http.server
import json
import threading

import numpy as np

from .export import trajectory_svg

_PAGE = """<!doctype html>
<title>uwslam-tpu live</title>
<meta http-equiv="refresh" content="1">
<body style="font-family:sans-serif">
<h3>uwslam-tpu live trajectory</h3>
<div>{status}</div>
{svg}
</body>"""


class VizServer:
    """Daemon-thread HTTP server of the current trajectory overlay."""

    def __init__(self, port: int = 8090, host: str = "127.0.0.1"):
        self._lock = threading.Lock()
        self._est = None
        self._gt = None
        self._frames = 0
        viz = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):   # no request log on stderr
                pass

            def do_GET(self):
                if self.path == "/state.json":
                    body, ctype = viz._state_json().encode(), "application/json"
                else:
                    body, ctype = viz._page().encode(), "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def update(self, est_positions: np.ndarray, gt_positions: np.ndarray | None = None):
        """Replace the positions shown (copies of the (N, 3) arrays)."""
        with self._lock:
            self._est = np.asarray(est_positions).copy()
            self._gt = None if gt_positions is None else np.asarray(gt_positions).copy()
            self._frames = len(self._est)

    def _page(self) -> str:
        with self._lock:
            if self._est is None or len(self._est) < 2:
                return _PAGE.format(status="waiting for poses…", svg="")
            return _PAGE.format(status=f"{self._frames} poses",
                                svg=trajectory_svg(self._est, self._gt))

    def _state_json(self) -> str:
        with self._lock:
            return json.dumps({
                "frames": self._frames,
                "est": None if self._est is None else self._est.tolist(),
                "gt": None if self._gt is None else self._gt.tolist(),
            })

    def close(self):
        """Stop serving, close the socket and join the thread."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()
