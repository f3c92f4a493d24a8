"""Minimal JSON inference server over a BatchedPredictor (stdlib only).

Counterpart of ``qkan_implementation_tpu.serving.server``, unchanged in
behaviour: the same endpoints and status codes.

Endpoints:
  POST /predict   {"inputs": [[...], ...]} -> {"outputs": [[...], ...]}
  GET  /healthz   -> {"status": "ok", ...stats}

A deliberately small surface: one predictor, one thread pool via
ThreadingHTTPServer, JSON I/O -- enough to put a structure-optimized KAN
behind a socket for evaluation traffic.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from qkan_implementation_tpu_torch.serving.predictor import BatchedPredictor


def make_server(predictor: BatchedPredictor, host: str = "127.0.0.1", port: int = 0):
    """Build (but do not start) the HTTP server; returns the server object
    (its .server_address carries the bound port when port=0)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", **predictor.stats()})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                inputs = payload.get("inputs")
                if inputs is None:
                    self._send(400, {"error": "missing 'inputs'"})
                    return
                outputs = predictor.predict(np.asarray(inputs, dtype=np.float64))
                if not np.all(np.isfinite(outputs)):
                    # 'NaN'/'Infinity' tokens are not valid JSON; a model
                    # producing them is a server-side fault, not a 200
                    self._send(
                        500, {"error": "model produced non-finite outputs"}
                    )
                    return
                self._send(200, {"outputs": outputs.tolist()})
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 -- runtime faults (CUDA
                # errors, OOM) must still produce an HTTP response; the
                # default handler would close the socket with no status
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def serve(
    predictor: BatchedPredictor,
    host: str = "127.0.0.1",
    port: int = 8000,
    background: bool = False,
):
    """Start serving.  ``background=True`` runs in a daemon thread and
    returns (server, thread); otherwise blocks."""
    server = make_server(predictor, host, port)
    if background:
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server, thread
    server.serve_forever()
