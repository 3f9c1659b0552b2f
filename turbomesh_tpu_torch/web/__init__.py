"""Browser front-end service of the PyTorch/CUDA port.

Reference parity: the WASM bindings (src/wasm/lib.zig:57-125) let a
browser run the full pipeline and read block points zero-copy from wasm
linear memory through the TypeScript SDK (web/sdk.ts:46-158). A
Python/PyTorch framework cannot ship as a wasm module, so the browser
entry point is a local HTTP service with the same API surface:

    POST /run               body = run-config JSON  -> {"blocks": n, "log": [...]}
    POST /free                                      -> frees the held mesh
    GET  /blocks                                    -> {"count": n}
    GET  /block/<i>/size                            -> {"i": ni, "j": nj}
    GET  /block/<i>/points  packed f64 [x0,y0,x1,y1,...] (exactly the
                            layout wasm/lib.zig:117-124 exposes)

`web/sdk.ts` at the repo root is the TypeScript client with the same
method names as the reference SDK (load/run/free/blocksCount/blockSize/
blockPointsView/blockPointsCopy); `web/index.html` is a canvas wireframe
viewer built on it. Start with ``turbomesh-serve-torch`` (or
``python -m turbomesh_tpu_torch.web``); ``--device {cuda,cpu}`` picks the
torch device of the device and sharded solvers (default cuda, which
raises without a card).

Counterpart of turbomesh_tpu/web/__init__.py.
"""

from __future__ import annotations

import io
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["MeshService", "serve", "main"]


class MeshService:
    """The wasm-module equivalent: holds one mesh (mesh_global,
    wasm/lib.zig:33) and runs the full pipeline from a config JSON
    (wasm/lib.zig:77-95); ``device`` is the torch device of the device
    and sharded solvers."""

    def __init__(self, device="cuda"):
        self.device = device
        self._mesh = None
        self._lock = threading.Lock()

    def run(self, config: dict | str, base_dir: str | None = None) -> dict:
        from .. import input as input_mod
        from ..smoothing.smooth import smooth_mesh

        if isinstance(config, str):
            config = json.loads(config)

        log_lines: list[str] = []
        handler = logging.Handler()
        handler.emit = lambda rec: log_lines.append(handler.format(rec))
        root = logging.getLogger("turbomesh")
        root.addHandler(handler)
        prev_level = root.level
        # wasm logFn parity (wasm/lib.zig:6-30): the browser client sees
        # the pipeline's info-level log lines (residuals etc.)
        root.setLevel(logging.INFO)
        try:
            inp = input_mod.load(config, base_dir=base_dir or ".")
            mesh = inp.template.run(inp.geometry)
            if inp.smoothing.iterations:
                smooth_mesh(
                    mesh,
                    iterations=inp.smoothing.iterations,
                    solver=inp.smoothing.solver,
                    wall_control_function=inp.smoothing.wall_control_function,
                    device=self.device,
                )
        finally:
            root.removeHandler(handler)
            root.setLevel(prev_level)
        with self._lock:
            self._mesh = mesh
        return {"blocks": len(mesh.blocks), "points": mesh.num_points,
                "log": log_lines}

    def free(self):
        with self._lock:
            self._mesh = None

    def _snapshot(self):
        """Mesh reference under the lock — a /free racing a concurrent GET
        must yield a clean LookupError, not an AttributeError mid-read."""
        with self._lock:
            m = self._mesh
        if m is None:
            raise LookupError("no mesh loaded (POST /run first)")
        return m

    def blocks_count(self) -> int:
        with self._lock:
            m = self._mesh
        return 0 if m is None else len(m.blocks)

    def block_size(self, idx: int) -> tuple[int, int]:
        ni, nj = self._snapshot().blocks[idx].size
        return int(ni), int(nj)

    def block_points_bytes(self, idx: int) -> bytes:
        """Packed little-endian f64 x0,y0,x1,y1,... in the block's
        j-fastest point order (wasm/lib.zig:117-124 layout)."""
        import numpy as np

        pts = np.ascontiguousarray(self._snapshot().blocks[idx].points,
                                   dtype="<f8")
        return pts.tobytes()


def _make_handler(service: MeshService, base_dir: str | None):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Headers", "Content-Type")
            self.send_header("Access-Control-Allow-Methods",
                             "GET, POST, OPTIONS")
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, obj):
            self._send(code, json.dumps(obj).encode())

        def do_OPTIONS(self):  # CORS preflight
            self._send(204, b"")

        def do_GET(self):
            parts = [p for p in self.path.split("?")[0].split("/") if p]
            try:
                if parts == ["blocks"]:
                    return self._json(200, {"count": service.blocks_count()})
                if len(parts) == 3 and parts[0] == "block":
                    idx = int(parts[1])
                    if parts[2] == "size":
                        ni, nj = service.block_size(idx)
                        return self._json(200, {"i": ni, "j": nj})
                    if parts[2] == "points":
                        return self._send(200, service.block_points_bytes(idx),
                                          "application/octet-stream")
                if parts == [] or parts == ["index.html"]:
                    import pathlib

                    # repo checkout layout first; pip installs (which only
                    # package turbomesh_tpu*) fall back to the serving CWD
                    roots = (pathlib.Path(__file__).parents[2] / "web",
                             pathlib.Path(base_dir or ".") / "web",
                             pathlib.Path.cwd() / "web")
                    for root in roots:
                        f = root / "index.html"
                        if f.exists():
                            return self._send(200, f.read_bytes(),
                                              "text/html; charset=utf-8")
                    return self._json(404, {
                        "error": "no web/index.html found next to the "
                                 "package or under the serving directory; "
                                 "the JSON/binary API endpoints work without it"})
                return self._json(404, {"error": f"unknown path {self.path}"})
            except LookupError as exc:  # freed/missing mesh or bad index
                return self._json(404, {"error": str(exc)})
            except Exception as exc:  # noqa: BLE001 — surfaced to the client
                return self._json(500, {"error": str(exc)})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b""
            try:
                if self.path == "/run":
                    out = service.run(body.decode("utf-8"), base_dir=base_dir)
                    return self._json(200, out)
                if self.path == "/free":
                    service.free()
                    return self._json(200, {"ok": True})
                return self._json(404, {"error": f"unknown path {self.path}"})
            except Exception as exc:  # noqa: BLE001
                return self._json(500, {"error": str(exc)})

        def log_message(self, fmt, *args):
            logging.getLogger("turbomesh.web").debug(fmt, *args)

    return Handler


def serve(port: int = 8732, base_dir: str | None = None,
          service: MeshService | None = None,
          device="cuda") -> ThreadingHTTPServer:
    """Start the service (non-blocking); returns the server object.
    ``device``: torch device of the device solver (default cuda; raises
    when no CUDA device is present)."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available "
                           "(use device='cpu')")
    service = service or MeshService(device=device)
    httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                _make_handler(service, base_dir))
    httpd.service = service
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="turbomesh-serve-torch",
        description="turbomesh browser service (WASM-front-end equivalent)")
    p.add_argument("--port", type=int, default=8732)
    p.add_argument("--base-dir", default=".",
                   help="directory CSV profile paths resolve against")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of the device solver (default cuda)")
    args = p.parse_args(argv)
    httpd = serve(port=args.port, base_dir=args.base_dir, device=args.device)
    print(f"turbomesh service on http://127.0.0.1:{args.port} "
          f"(POST /run, GET /blocks, /block/<i>/points)")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()
    return 0


if __name__ == "__main__":  # python -m turbomesh_tpu_torch.web
    raise SystemExit(main())
