"""Render server of the port: ``GET /healthz``, ``POST /render`` and
``POST /aovs``.

    python -m raymarching_tpu_torch.serve [--port 8000] [--device cuda]
                                          [--backend cuda|multi|ref]

``POST /render`` takes the scene text as its body and the query parameters
and limits of ``raymarching_tpu.serve``: width, height, ssaa, iterations,
gamma, shadows=0|1, soft_shadow_k and ao (the shading extensions, clamped
non-negative; 0 is off), reflect (mirror strength, clamped to [0, 0.99])
and bounces (clamped to 1-3), aperture (thin-lens radius, clamped to
[0, 10]) and focus (clamped to [1e-3, 1e4]), serve_raygen=0|1 (default 1:
K1 computes the primary directions from the ray index,
``api.render_tables``' serving path; 0, and any aperture, take the camera
pass), format=png|ppm.  Normals are FD, as the JAX server pins them.
``POST /aovs`` takes the same parameters and answers the JAX server's ZIP
of ``api.render_aovs``' planes: color.png, normal.png, hit.png, depth.npy,
objid.npy, shadow.npy (pinhole, as JAX's).  ``/animate`` answers 501
(ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import urllib.parse
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .config import RenderConfig
from .io.image import to_uint8
from .io.png import encode_png
from .scene.compile import compile_scene
from .scene.parser import parse_scene

from .api import (render_aovs, render_tables, resolve_backend,
                  resolve_device)

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
    "/animate": "animated renders (ROADMAP Queue 1 item 12)",
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

        def _send_bytes(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urllib.parse.urlparse(self.path).path == "/healthz":
                self._json(200, {"status": "ok", "device": str(device),
                                 "backend": backend})
            else:
                self._json(404, {"error": "unknown path"})

        def _read_request(self, q):
            """The request's (cfg, plan, tables), or None when a 4xx has
            been sent."""
            length = int(self.headers.get("Content-Length", 0))
            if length > MAX_BODY_BYTES:
                self._json(413, {"error": "scene body too large "
                                          f"(max {MAX_BODY_BYTES} B)"})
                return None
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
                    return None
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
                serve_raygen=q.get("serve_raygen", "1") != "0",
                normal_mode="fd")
            plan, tables = compile_scene(parse_scene(text))
            return cfg, plan, tables

        def _render(self, q):
            parsed = self._read_request(q)
            if parsed is None:
                return
            cfg, plan, tables = parsed
            with render_lock:
                img = render_tables(plan, tables, cfg, backend=backend,
                                    device=device)
                img = img.cpu().numpy()
            data = to_uint8(img, cfg.gamma)
            if q.get("format", "png") == "ppm":
                h, w, _ = data.shape
                body = b"P6\n%d %d\n255\n" % (w, h) + data.tobytes()
                self._send_bytes(body, "image/x-portable-pixmap")
            else:
                self._send_bytes(encode_png(data), "image/png")

        def _aovs(self, q):
            parsed = self._read_request(q)
            if parsed is None:
                return
            cfg, plan, tables = parsed
            with render_lock:
                aovs = {k: v.cpu().numpy() for k, v in render_aovs(
                    plan, tables, cfg, device=device).items()}
            normal8 = np.clip((aovs["normal"] * 0.5 + 0.5) * 255.0 + 0.5,
                              0, 255).astype(np.uint8)
            hit8 = np.repeat(np.clip(aovs["hit"] * 255.0 + 0.5, 0, 255)
                             .astype(np.uint8)[..., None], 3, axis=-1)
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
                zf.writestr("color.png", encode_png(to_uint8(aovs["color"],
                                                             cfg.gamma)))
                zf.writestr("normal.png", encode_png(normal8))
                zf.writestr("hit.png", encode_png(hit8))
                for name, dtype in (("depth", np.float32),
                                    ("objid", np.int32),
                                    ("shadow", np.float32)):
                    b = io.BytesIO()
                    np.save(b, aovs[name].astype(dtype))
                    zf.writestr(name + ".npy", b.getvalue())
            self._send_bytes(buf.getvalue(), "application/zip")

        def do_POST(self):
            url = urllib.parse.urlparse(self.path)
            if url.path in UNPORTED_ROUTES:
                self._json(501, {"error": "not ported yet: POST "
                                 f"{url.path}, {UNPORTED_ROUTES[url.path]}"})
                return
            routes = {"/render": self._render, "/aovs": self._aovs}
            if url.path not in routes:
                self._json(404, {"error": "unknown path"})
                return
            try:
                routes[url.path](dict(urllib.parse.parse_qsl(url.query)))
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
