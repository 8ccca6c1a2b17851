"""Image output: linear float image -> gamma-corrected 8-bit file.

Mirrors the reference's save path (LiteImage::SaveImage with gamma,
main.cpp:53; stb jpg quality 100, main.cpp:80): clamp to [0, 1], apply
1/gamma, quantize to uint8 (round-half-away like the reference's
``uint8(v * 255 + 0.5)`` convention), append alpha=1 for RGBA outputs.

PNGs go through the native host runtime's writer when its library is
built and loaded (``raymarching_tpu_torch.native``), else through the pure
Python encoder (``io.png``); both write the same pixels.  JPEGs always
take ``io.jpeg``.

The port's own copy of ``raymarching_tpu.io.image`` (same names, same behaviour; a test
holds the two equal), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

from . import png as _png


def to_uint8(img: np.ndarray, gamma: float = 1.0) -> np.ndarray:
    """[H, W, 3] float linear -> [H, W, 3] uint8 with gamma correction."""
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    if gamma != 1.0:
        img = img ** (1.0 / gamma)
    return (img * 255.0 + 0.5).astype(np.uint8)


#: stb-parity JPEG quality (constants.h:30)
JPEG_QUALITY = 100


def write_pfm(path: str, img: np.ndarray) -> None:
    """Write [H, W, 3] (color ``PF``) or [H, W] (grayscale ``Pf``) float32
    radiance as a Portable Float Map — the dependency-free HDR output the
    8-bit formats cannot carry (the renderer's native output is linear
    float; the reference quantizes straight to uint8, main.cpp:53).

    PFM convention: rows stored bottom-to-top; a negative scale marks
    little-endian float32 payload."""
    a = np.asarray(img, "<f4")
    if a.ndim == 3 and a.shape[2] == 3:
        magic = b"PF"
    elif a.ndim == 2:
        magic = b"Pf"
    else:
        raise ValueError(f"expected [H, W, 3] or [H, W] floats, got {a.shape}")
    h, w = a.shape[:2]
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n-1.0\n" % (w, h))
        f.write(np.ascontiguousarray(a[::-1]).tobytes())


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file -> [H, W, 3] or [H, W] float32 (top-to-bottom)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"PF", b"Pf"):
            raise ValueError(f"not a PFM file: magic {magic!r}")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline())
        dtype = "<f4" if scale < 0 else ">f4"
        c = 3 if magic == b"PF" else 1
        data = np.frombuffer(f.read(w * h * c * 4), dtype=dtype)
    shape = (h, w, 3) if c == 3 else (h, w)
    out = data.reshape(shape)[::-1].astype(np.float32)
    if abs(scale) not in (0.0, 1.0):
        out = out * abs(scale)
    return out


def save_image(path: str, img: np.ndarray, gamma: float = 1.0) -> None:
    """Save a linear float image to PNG / PPM / JPEG / PFM (by extension).

    All formats are dependency-free: JPEG (the reference's GPU output
    format, main.cpp:80, stb quality 100) uses the clean-room baseline
    encoder in io.jpeg; ``.pfm`` keeps full float32 radiance (gamma still
    applies if non-1, but no clamp/quantization)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        data = np.asarray(img, np.float32)
        if gamma != 1.0:
            data = np.maximum(data, 0.0) ** (1.0 / gamma)
        write_pfm(path, data)
        return
    data = to_uint8(img, gamma)
    if ext == ".ppm":
        _png.write_ppm(path, data)
        return
    if ext in (".jpg", ".jpeg"):
        from .jpeg import write_jpeg

        write_jpeg(path, data[..., :3], JPEG_QUALITY)
        return
    if ext not in (".png", ""):
        raise ValueError(f"unsupported image format: {ext} "
                         "(png, ppm, jpg, pfm are supported)")
    from ..native import native_write_png

    if native_write_png(path, data):
        return
    _png.write_png(path, data)
