"""Minimal dependency-free baseline JPEG encoder.

The reference's GPU output is written by stb_image_write's JPEG encoder at
quality 100 (main.cpp:80, constants.h:30).  This is the clean-room
equivalent: baseline sequential DCT, JFIF, 4:4:4 (no chroma subsampling —
matching stb, which never subsamples), standard Annex-K quantization
tables scaled by libjpeg's quality curve, standard Huffman tables.
NumPy-vectorized DCT/quantization; the entropy coder is a plain Python
loop over blocks (encoding a 1024x768 frame takes a few seconds — fine
for an output writer).

Only an encoder: the framework reads PNG (io.png.decode_png); JPEG input
is out of scope (the reference never reads images at all).

The port's own copy of ``raymarching_tpu.io.jpeg`` (same names, same behaviour; a test
holds the two equal), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import struct

import numpy as np

# Annex K (libjpeg) base tables, natural (row-major) order.
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int32)
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], np.int32)

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

# Standard Huffman tables (JPEG Annex K.3): (bits-counts, values).
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
            list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = (
    [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
    [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
     0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
     0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
     0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
     0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
     0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
     0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
     0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
     0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
     0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
     0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
     0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
     0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
     0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_AC_CHROMA = (
    [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
    [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
     0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
     0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
     0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
     0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
     0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
     0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
     0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
     0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
     0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
     0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
     0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
     0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
     0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
     0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def _huff_codes(bits, values):
    """(code, length) per symbol from a (counts-per-length, values) spec."""
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


_DC_L_CODES = _huff_codes(*_DC_LUMA)
_DC_C_CODES = _huff_codes(*_DC_CHROMA)
_AC_L_CODES = _huff_codes(*_AC_LUMA)
_AC_C_CODES = _huff_codes(*_AC_CHROMA)


def _scale_table(base, quality):
    quality = max(1, min(100, int(quality)))
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    t = (base * scale + 50) // 100
    return np.clip(t, 1, 255).astype(np.int32)


_DCT = np.zeros((8, 8), np.float64)
for _k in range(8):
    for _n in range(8):
        c = np.sqrt(0.125) if _k == 0 else 0.5
        _DCT[_k, _n] = c * np.cos((2 * _n + 1) * _k * np.pi / 16.0)


def _blocks(channel):
    """[H, W] -> [n_blocks, 8, 8] (edge-replicated to multiples of 8)."""
    h, w = channel.shape
    ph, pw = (-h) % 8, (-w) % 8
    c = np.pad(channel, ((0, ph), (0, pw)), mode="edge")
    H, W = c.shape
    return (c.reshape(H // 8, 8, W // 8, 8)
            .transpose(0, 2, 1, 3).reshape(-1, 8, 8))


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, code, length):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            self.nbits -= 8
            byte = (self.acc >> self.nbits) & 0xFF
            self.buf.append(byte)
            if byte == 0xFF:           # byte stuffing
                self.buf.append(0x00)

    def flush(self):
        if self.nbits:
            self.write(0x7F, 8 - self.nbits)   # pad with 1s


def _magnitude(v):
    """JPEG category + offset-coded value bits."""
    if v == 0:
        return 0, 0
    a = abs(v)
    size = a.bit_length()
    bits = v if v > 0 else v + (1 << size) - 1
    return size, bits


def _encode_channel(writer, blocks, dc_codes, ac_codes, pred):
    """Entropy-code quantized zigzag blocks [N, 64]; returns new DC pred."""
    for blk in blocks:
        dc = int(blk[0])
        diff = dc - pred
        pred = dc
        size, bits = _magnitude(diff)
        code, length = dc_codes[size]
        writer.write(code, length)
        if size:
            writer.write(bits, size)

        run = 0
        last_nz = np.nonzero(blk[1:])[0]
        end = (last_nz[-1] + 2) if last_nz.size else 1
        for k in range(1, end):
            v = int(blk[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                code, length = ac_codes[0xF0]      # ZRL
                writer.write(code, length)
                run -= 16
            size, bits = _magnitude(v)
            code, length = ac_codes[(run << 4) | size]
            writer.write(code, length)
            writer.write(bits, size)
            run = 0
        if end < 64:
            code, length = ac_codes[0x00]          # EOB
            writer.write(code, length)
    return pred


def encode_jpeg(img: np.ndarray, quality: int = 100) -> bytes:
    """img: [H, W, 3] uint8 RGB -> baseline JFIF bytes."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rgb = img.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b

    ql = _scale_table(_Q_LUMA, quality).reshape(8, 8)
    qc = _scale_table(_Q_CHROMA, quality).reshape(8, 8)

    def quantize(channel, q):
        blk = _blocks(channel)                       # [N, 8, 8]
        coef = np.einsum("ij,njk,lk->nil", _DCT, blk, _DCT)
        quant = np.round(coef / q).astype(np.int32)
        return quant.reshape(-1, 64)[:, _ZIGZAG]     # [N, 64] zigzag

    qy, qcb, qcr = quantize(y, ql), quantize(cb, qc), quantize(cr, qc)

    out = bytearray()

    def marker(tag, payload=b""):
        out.extend(struct.pack(">HH", tag, len(payload) + 2))
        out.extend(payload)

    out.extend(b"\xFF\xD8")                           # SOI
    marker(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    # DQT: table 0 luma, table 1 chroma (zigzag order)
    marker(0xFFDB, bytes([0]) + bytes(ql.reshape(64)[_ZIGZAG].tolist())
           + bytes([1]) + bytes(qc.reshape(64)[_ZIGZAG].tolist()))
    # SOF0: 8-bit, 3 components, 1x1 sampling (4:4:4), Q-tables 0/1/1
    marker(0xFFC0, struct.pack(">BHHB", 8, h, w, 3)
           + bytes([1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1]))
    # DHT x4
    for cls, tid, (bits, values) in ((0, 0, _DC_LUMA), (1, 0, _AC_LUMA),
                                     (0, 1, _DC_CHROMA), (1, 1, _AC_CHROMA)):
        marker(0xFFC4, bytes([(cls << 4) | tid]) + bytes(bits)
               + bytes(values))
    # SOS
    marker(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))

    # Interleaved MCUs (1x1 sampling: one block per component per MCU).
    writer = _BitWriter()
    preds = [0, 0, 0]
    chans = (qy, qcb, qcr)
    dc_tabs = (_DC_L_CODES, _DC_C_CODES, _DC_C_CODES)
    ac_tabs = (_AC_L_CODES, _AC_C_CODES, _AC_C_CODES)
    n_blocks = qy.shape[0]
    for i in range(n_blocks):
        for c in range(3):
            preds[c] = _encode_channel(writer, chans[c][i:i + 1],
                                       dc_tabs[c], ac_tabs[c], preds[c])
    writer.flush()
    out.extend(writer.buf)
    out.extend(b"\xFF\xD9")                           # EOI
    return bytes(out)


def write_jpeg(path: str, img: np.ndarray, quality: int = 100) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality))
