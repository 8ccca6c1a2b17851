"""Render server of the port: ``GET /healthz`` and ``POST /render``.

    python -m raymarching_tpu_torch.serve [--port 8000] [--device cuda]
                                          [--backend cuda|multi|ref]

``POST /render`` takes the scene text as its body and the query parameters
and limits of ``raymarching_tpu.serve``: width, height, ssaa, iterations,
gamma, shadows=0|1, format=png|ppm.  The extensions that are not ported yet
(soft_shadow_k, ao, reflect and its bounces, aperture and its focus)
answer 501 when set; ``bounces`` and ``focus`` are clamped as the JAX
server clamps them first, so an out-of-range value gets the same answer.
``serve_raygen`` is accepted and ignored (the port generates rays outside
the kernel), which the ``X-Serve-Raygen: ignored`` reply header says.
Normals are FD, as the JAX server pins them.  ``POST /aovs`` answers 501:
the planes are ``api.render_aovs``, and what is left is the route that
packs them into the JAX server's ZIP of PNG and .npy members (ROADMAP
Queue 1 item 9); ``/animate`` answers 501 (item 12).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .config import RenderConfig
from .io.image import to_uint8
from .io.png import encode_png
from .scene.compile import compile_scene
from .scene.parser import parse_scene

from .api import render_tables, resolve_backend, resolve_device

# Limits of raymarching_tpu.serve: no request may ask for an arbitrarily
# large frame or march.
MAX_WIDTH = 4096
MAX_HEIGHT = 4096
MAX_SSAA = 4
MAX_ITERATIONS = 10_000
MAX_BODY_BYTES = 1 << 20
# The JAX server's routes that the port does not have yet: the ROADMAP item
# each waits for.
UNPORTED_ROUTES = {
    "/aovs": "the route's ZIP of the api.render_aovs planes (ROADMAP "
             "Queue 1 item 9)",
    "/animate": "animated renders (ROADMAP Queue 1 item 12)",
}
# Query parameters of features that are not ported yet, and their items.
UNPORTED_PARAMS = {
    "bounces": "mirror bounces (ROADMAP Queue 1 item 9)",
    "focus": "depth of field (ROADMAP Queue 1 item 9)",
}


def make_handler(device, backend: str = "cuda"):
    """Request handler class rendering on ``device`` through ``backend``
    (default the fused path: K1 on a CUDA device, its plain twin on the
    CPU)."""
    device = resolve_device(device)
    backend = resolve_backend(backend)
    # one render at a time on the device; the HTTP threads queue here
    render_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        server_version = "raymarching_tpu_torch"

        def log_message(self, fmt, *args):
            print("[serve]", fmt % args, file=sys.stderr)

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_bytes(self, body: bytes, ctype: str, headers=()):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urllib.parse.urlparse(self.path).path == "/healthz":
                self._json(200, {"status": "ok", "device": str(device),
                                 "backend": backend})
            else:
                self._json(404, {"error": "unknown path"})

        def _render(self, q):
            length = int(self.headers.get("Content-Length", 0))
            if length > MAX_BODY_BYTES:
                self._json(413, {"error": "scene body too large "
                                          f"(max {MAX_BODY_BYTES} B)"})
                return
            text = self.rfile.read(length).decode()
            limits = [("width", int(q.get("width", 512)), 1, MAX_WIDTH),
                      ("height", int(q.get("height", 384)), 1, MAX_HEIGHT),
                      ("ssaa", int(q.get("ssaa", 1)), 1, MAX_SSAA),
                      ("iterations", int(q.get("iterations", 1000)), 1,
                       MAX_ITERATIONS)]
            for name, val, lo, hi in limits:
                if not lo <= val <= hi:
                    self._json(422, {"error": f"{name}={val} out of "
                                              f"range [{lo}, {hi}]"})
                    return
            cfg = RenderConfig(
                width=limits[0][1], height=limits[1][1], ssaa=limits[2][1],
                iterations=limits[3][1], gamma=float(q.get("gamma", 1.0)),
                shadows=q.get("shadows", "1") != "0",
                soft_shadow_k=max(0.0, float(q.get("soft_shadow_k", 0.0))),
                ao_strength=max(0.0, float(q.get("ao", 0.0))),
                reflect_strength=min(max(0.0, float(q.get("reflect", 0.0))),
                                     0.99),
                reflect_bounces=min(max(int(q.get("bounces", 1)), 1), 3),
                aperture=min(max(0.0, float(q.get("aperture", 0.0))), 10.0),
                focus_dist=min(max(float(q.get("focus", 6.0)), 1e-3), 1e4),
                normal_mode="fd")
            for name, what in UNPORTED_PARAMS.items():
                if name in q:
                    raise NotImplementedError(
                        f"not ported yet: {name}={q[name]}: {what}")
            plan, tables = compile_scene(parse_scene(text))
            with render_lock:
                img = render_tables(plan, tables, cfg, backend=backend,
                                    device=device)
                img = img.cpu().numpy()
            data = to_uint8(img, cfg.gamma)
            headers = ([("X-Serve-Raygen", "ignored")]
                       if "serve_raygen" in q else [])
            if q.get("format", "png") == "ppm":
                h, w, _ = data.shape
                body = b"P6\n%d %d\n255\n" % (w, h) + data.tobytes()
                self._send_bytes(body, "image/x-portable-pixmap", headers)
            else:
                self._send_bytes(encode_png(data), "image/png", headers)

        def do_POST(self):
            url = urllib.parse.urlparse(self.path)
            if url.path in UNPORTED_ROUTES:
                self._json(501, {"error": "not ported yet: POST "
                                 f"{url.path}, {UNPORTED_ROUTES[url.path]}"})
                return
            if url.path != "/render":
                self._json(404, {"error": "unknown path"})
                return
            try:
                self._render(dict(urllib.parse.parse_qsl(url.query)))
            except NotImplementedError as e:
                self._json(501, {"error": str(e)})
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_server(host: str, port: int, device,
                backend: str = "cuda") -> ThreadingHTTPServer:
    """A server bound to (host, port); port 0 picks a free one."""
    return ThreadingHTTPServer((host, port), make_handler(device, backend))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raymarching_tpu_torch.serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="cuda",
                    help="cuda (fused kernel), multi (multi-kernel) or ref")
    args = ap.parse_args(argv)
    server = make_server(args.host, args.port, args.device, args.backend)
    print(f"raymarching_tpu_torch serving on http://{args.host}:"
          f"{server.server_address[1]} (device={args.device}, backend={args.backend})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
