"""Render server of the port: ``GET /healthz``, ``POST /render``,
``POST /aovs`` and ``POST /animate``.

    python -m raymarching_tpu_torch.serve [--port 8000] [--device cuda]
                                          [--backend cuda|multi|ref|torch]

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
objid.npy, shadow.npy (pinhole, as JAX's).  ``POST /animate`` takes the
same parameters and answers a turntable orbit of the scene
(``api.turntable_frames``: FRAME_BATCH poses a ``render_frames`` call on
the fused backend, one K1 launch a batch): format=zip (the default) a ZIP
of frame_000.png ...; format=gif a looping GIF; frames (default 24, at
most MAX_FRAMES), orbit (degrees swept, default 360), center=x,y,z
(default the primitives' mean), delay_cs (the GIF's frame delay,
clamped to 1-1000).  Frames times rays above MAX_ANIMATE_SAMPLES, and for
a GIF frames times pixels above MAX_GIF_PIXELS (the encoder is pure
Python, about a million pixels a second), answer 422.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import sys
import threading
import urllib.parse
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .config import RenderConfig
from .io.gif import encode_gif
from .io.image import to_uint8
from .io.png import encode_png
from .scene.compile import compile_scene
from .scene.parser import parse_scene

from .api import (render_aovs, render_tables, resolve_backend,
                  resolve_device, turntable_frames)

# Limits of raymarching_tpu.serve: no request may ask for an arbitrarily
# large frame or march.
MAX_WIDTH = 4096
MAX_HEIGHT = 4096
MAX_SSAA = 4
MAX_ITERATIONS = 10_000
MAX_FRAMES = 600
MAX_ANIMATE_SAMPLES = 1 << 28     # rays of all an animation's frames
MAX_GIF_PIXELS = 1 << 24          # pixels of all a GIF's frames
MAX_BODY_BYTES = 1 << 20
FRAME_BATCH = 8                   # poses a render_frames call on /animate


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
            """The request's (cfg, plan, tables, frames), or None when a
            4xx has been sent."""
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
                       MAX_ITERATIONS),
                      ("frames", int(q.get("frames", 24)), 1, MAX_FRAMES)]
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
            return cfg, plan, tables, limits[4][1]

        def _render(self, q):
            parsed = self._read_request(q)
            if parsed is None:
                return
            cfg, plan, tables, _ = parsed
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
            cfg, plan, tables, _ = parsed
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

        def _animate(self, q):
            parsed = self._read_request(q)
            if parsed is None:
                return
            cfg, plan, tables, frames = parsed
            total = frames * cfg.rays_per_image
            if total > MAX_ANIMATE_SAMPLES:
                self._json(422, {"error": f"frames x rays = {total} over "
                                          f"cap {MAX_ANIMATE_SAMPLES}"})
                return
            gif = q.get("format", "zip").lower() == "gif"
            px = frames * cfg.width * cfg.height
            if gif and px > MAX_GIF_PIXELS:
                self._json(422, {"error": f"frames x pixels = {px} over "
                                          f"GIF encode cap {MAX_GIF_PIXELS}"
                                          "; use format=zip"})
                return
            orbit = math.radians(float(q.get("orbit", 360.0)))
            center = None
            if "center" in q:
                center = np.array([float(v) for v in q["center"].split(",")],
                                  np.float32)
                if center.shape != (3,):
                    raise ValueError("center must be x,y,z")
            with render_lock:
                images = [to_uint8(img, cfg.gamma) for img in
                          turntable_frames(plan, tables, cfg, frames,
                                           orbit=orbit, center=center,
                                           backend=backend,
                                           batch=FRAME_BATCH, device=device)]
            if gif:
                delay = max(1, min(int(q.get("delay_cs", 4)), 1000))
                self._send_bytes(encode_gif(images, delay_cs=delay),
                                 "image/gif")
                return
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
                for i, data in enumerate(images):
                    zf.writestr(f"frame_{i:03d}.png", encode_png(data))
            self._send_bytes(buf.getvalue(), "application/zip")

        def do_POST(self):
            url = urllib.parse.urlparse(self.path)
            routes = {"/render": self._render, "/aovs": self._aovs,
                      "/animate": self._animate}
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
                    help="cuda (fused kernel), multi (multi-kernel), ref "
                         "(plain oracle) or torch (plain, implicit-function "
                         "march)")
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
