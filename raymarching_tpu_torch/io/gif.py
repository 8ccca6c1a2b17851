"""Minimal dependency-free animated GIF encoder (GIF89a).

The port's own copy of ``raymarching_tpu.io.gif`` (same bytes for the
same frames; tests/test_torch_animate.py holds the two equal): with the
PNG and JPEG encoders it completes the dependency-free output family, and
it gives the server's ``/animate`` and the CLI's ``--animate`` a looping
animation no external tool has to assemble.  Pure Python: about a million
pixels a second, so the server caps the pixels of a GIF response.

Design choices, smallest-correct versions:
  * one GLOBAL palette for the whole animation, built by a uniform
    6x7x6 RGB cube (252 colors) — renders here are smooth-shaded scenes
    with few hues, where the cube is visually fine and avoids a
    median-cut pass over every frame;
  * true LZW compression (variable-width codes, dictionary reset at 4096
    entries) — the spec's required codec, not the "emit clear codes
    constantly" uncompressed trick, so files stay small;
  * frames are full replacements (no delta encoding): renderer output is
    camera motion where most pixels change anyway.
"""

from __future__ import annotations

import struct
from typing import Iterable, Sequence

import numpy as np

# Uniform color cube: 6 levels R, 7 G (eyes weight green), 6 B = 252.
_LEVELS = (6, 7, 6)


def _palette() -> np.ndarray:
    """[256, 3] uint8 global color table (252 cube entries + 4 padding)."""
    lr, lg, lb = _LEVELS
    r = np.linspace(0, 255, lr).round().astype(np.uint8)
    g = np.linspace(0, 255, lg).round().astype(np.uint8)
    b = np.linspace(0, 255, lb).round().astype(np.uint8)
    cube = np.stack(np.meshgrid(r, g, b, indexing="ij"), axis=-1)
    pal = np.zeros((256, 3), np.uint8)
    pal[:lr * lg * lb] = cube.reshape(-1, 3)
    return pal


def _quantize(frame: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 -> [H, W] palette indices into _palette()."""
    lr, lg, lb = _LEVELS
    q = frame.astype(np.float32) / 255.0
    ir = np.clip((q[..., 0] * (lr - 1)).round(), 0, lr - 1)
    ig = np.clip((q[..., 1] * (lg - 1)).round(), 0, lg - 1)
    ib = np.clip((q[..., 2] * (lb - 1)).round(), 0, lb - 1)
    return ((ir * lg + ig) * lb + ib).astype(np.uint8)


def _lzw(indices: np.ndarray, min_code_size: int) -> bytes:
    """GIF-flavoured LZW: emits clear code first, variable code width,
    dict reset when full (4096).  indices: flat uint8 array."""
    clear = 1 << min_code_size
    end = clear + 1

    out = bytearray()
    bitbuf = 0
    nbits = 0

    def emit(code: int, width: int):
        nonlocal bitbuf, nbits
        bitbuf |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(bitbuf & 0xFF)
            bitbuf >>= 8
            nbits -= 8

    def fresh():
        return {(i,): i for i in range(clear)}

    table = fresh()
    next_code = end + 1
    width = min_code_size + 1
    emit(clear, width)
    seq = ()
    for sym in map(int, indices):
        cand = seq + (sym,)
        if cand in table:
            seq = cand
            continue
        emit(table[seq], width)
        table[cand] = next_code
        next_code += 1
        if next_code - 1 == (1 << width) and width < 12:
            width += 1
        if next_code >= 4096:
            emit(clear, width)
            table = fresh()
            next_code = end + 1
            width = min_code_size + 1
        seq = (sym,)
    if seq:
        emit(table[seq], width)
    emit(end, width)
    if nbits:
        out.append(bitbuf & 0xFF)
    return bytes(out)


def _blocks(data: bytes) -> bytes:
    """Split into <=255-byte sub-blocks with a zero terminator."""
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def encode_gif(frames: Sequence[np.ndarray] | Iterable[np.ndarray], *,
               delay_cs: int = 4, loop: bool = True) -> bytes:
    """frames: iterable of [H, W, 3] uint8 (same shape) -> animated GIF.

    delay_cs: inter-frame delay in centiseconds (4 = 25 fps).
    loop: repeat forever (Netscape extension)."""
    frames = list(frames)
    if not frames:
        raise ValueError("need at least one frame")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.shape[:2] != (h, w) or f.shape[-1] < 3:
            raise ValueError("all frames must be [H, W, 3] of one size")
    if not 0 <= int(delay_cs) <= 0xFFFF:
        raise ValueError(f"delay_cs must be in [0, 65535], got {delay_cs}")

    out = bytearray()
    out += b"GIF89a"
    # logical screen: global color table, 8 bits/channel, 256 entries
    out += struct.pack("<HHBBB", w, h, 0xF7, 0, 0)
    out += _palette().tobytes()
    if loop and len(frames) > 1:
        out += b"\x21\xFF\x0BNETSCAPE2.0" + _blocks(b"\x01\x00\x00")
    for f in frames:
        if len(frames) > 1:
            # graphic control: no disposal tricks, just the delay
            out += b"\x21\xF9" + _blocks(
                struct.pack("<BHB", 0, delay_cs, 0))
        out += b"\x2C" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        idx = _quantize(np.ascontiguousarray(f[..., :3]))
        out.append(8)                       # LZW min code size
        out += _blocks(_lzw(idx.reshape(-1), 8))
    out += b"\x3B"
    return bytes(out)
