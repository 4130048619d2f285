"""8-bit RGB PNG encode/decode with the standard library (zlib, struct).

The serving response carries base64 PNGs; the card's machine has no PIL,
so the port writes them itself. `decode_png` reads back what `encode_png`
writes, and the 8-bit non-interlaced files of every colour type (grey,
RGB, palette, grey + alpha, RGBA) with any of the five scanline filters,
as RGB: alpha is dropped and grey repeated, as PIL's `convert("RGB")` does.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(img: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> PNG bytes (filter 0 on every row)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"want an RGB image, got {c} channels")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


# Colour type -> samples a pixel (0 grey, 2 RGB, 3 palette index, 4 grey + alpha, 6 RGBA).
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines of `raw` with their filters undone: [h, stride] uint8."""
    rows = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # sub: a running sum along each byte of the pixel, mod 256
            cur = line.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                pred = (a + b) // 2 if ftype == 3 else _paeth(a, b, c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit, non-interlaced) -> [H, W, 3] uint8."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header, palette = 8, b"", None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat += body
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        raise ValueError(f"only 8-bit non-interlaced PNGs are decoded (depth {depth}, "
                         f"colour type {color}, interlace {interlace})")
    ch = _CHANNELS[color]
    px = _unfilter(zlib.decompress(idat), h, w * ch, ch).reshape(h, w, ch)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[px[..., 0]]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])
