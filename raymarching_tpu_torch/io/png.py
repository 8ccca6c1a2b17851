"""Minimal dependency-free PNG codec (and PPM, for debugging).

Replaces the reference's vendored stb_image_write / LiteImage SaveImage
(main.cpp:53, main.cpp:80) with a clean-room encoder: 8-bit RGB/RGBA,
zlib-deflated scanlines, filter type 0.  A faster zlib-backed C++ writer
lives in native/ (io.image picks it when built).

Also provides a decoder (:func:`decode_png`: 8-bit RGB/RGBA,
non-interlaced, all five scanline filters) so the framework can READ
images dependency-free — used to load optimization targets and to
pixel-validate our renders against the reference's own committed
``out_cpu.png`` artifact (written at main.cpp:53).

The port's own copy of ``raymarching_tpu.io.png`` (same names, same behaviour; a test
holds the two equal), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, compress_level: int = 6) -> bytes:
    """img: [H, W, 3|4] uint8 -> PNG bytes."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected [H, W, 3|4] uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w, c = img.shape
    color_type = 2 if c == 3 else 6
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # filter byte 0 per scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    idat = zlib.compress(raw.tobytes(), compress_level)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, compress_level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, compress_level))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3|4] uint8.

    Supports the subset every artifact in scope uses (and that our encoder
    and the reference's LiteImage/stb writers emit): 8-bit depth, color
    types 2 (RGB) / 6 (RGBA), no interlacing, filters 0-4.
    """
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat = 8, []
    w = h = channels = None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if depth != 8 or ctype not in (2, 6) or interlace:
                raise ValueError(
                    f"unsupported PNG (depth={depth}, color type={ctype}, "
                    f"interlace={interlace}); only 8-bit RGB/RGBA supported")
            channels = 3 if ctype == 2 else 4
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if w is None or not idat:
        raise ValueError("truncated PNG (missing IHDR or IDAT)")
    raw = zlib.decompress(b"".join(idat))
    stride = w * channels
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG data length mismatch")
    bpp = channels
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint16)
    for y in range(h):
        off = y * (stride + 1)
        ftype = raw[off]
        line = np.frombuffer(raw, np.uint8, stride, off + 1).astype(np.uint16)
        if ftype == 0:
            cur = line
        elif ftype == 2:                      # Up
            cur = (line + prev) & 0xFF
        else:
            # Sub/Average/Paeth depend on the previous pixel in the same
            # row -> sequential over pixels, vectorized over channels.
            cur = np.zeros(stride, np.uint16)
            for x in range(0, stride, bpp):
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.uint16)
                b = prev[x:x + bpp]
                if ftype == 1:                # Sub
                    pred = a
                elif ftype == 3:              # Average
                    pred = (a + b) >> 1
                elif ftype == 4:              # Paeth
                    c = (prev[x - bpp:x] if x
                         else np.zeros(bpp, np.uint16)).astype(np.int32)
                    ai, bi = a.astype(np.int32), b.astype(np.int32)
                    p = ai + bi - c
                    pa, pb, pc = abs(p - ai), abs(p - bi), abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), ai,
                                    np.where(pb <= pc, bi, c)).astype(
                                        np.uint16)
                else:
                    raise ValueError(f"bad PNG filter type {ftype}")
                cur[x:x + bpp] = (line[x:x + bpp] + pred) & 0xFF
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, channels)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_ppm(path: str, img: np.ndarray) -> None:
    """img: [H, W, 3] uint8 -> binary PPM."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img[..., :3].tobytes())
