"""Minimal PNG codec on numpy + zlib.

Covers what the renderer writes and what its procedural scenes embed:
8-bit gray, RGB and RGBA images, non-interlaced, with any of the five
scanline filter types (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth). Other
PNG flavours (palette, 16-bit, interlaced) raise `UnsupportedPNG`, which
callers may answer with a fuller decoder.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type <-> channels, for the 8-bit types this codec handles
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


class UnsupportedPNG(ValueError):
    """A valid PNG this codec does not decode (palette, 16-bit, ...)."""


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(raw: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """Apply one filter type to every scanline of raw [H, stride] bytes."""
    x = raw.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    up_left = np.zeros_like(x)
    up_left[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: np.zeros_like(x), 1: left, 2: up,
            3: (left + up) // 2, 4: _paeth(left, up, up_left)}[filter_type]
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(image: np.ndarray, filter_type: int = 0) -> bytes:
    """PNG bytes of a uint8 [H, W] (gray) or [H, W, C] image, C in 1/3/4."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG encoder takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"PNG encoder takes 1, 3 or 4 channels, got {c}")
    if filter_type not in range(5):
        raise ValueError(f"PNG filter type must be 0-4, got {filter_type}")
    rows = _filter_rows(img.reshape(h, w * c), c, filter_type)
    body = np.concatenate(
        [np.full((h, 1), filter_type, np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(body.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter(body: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(body[y, 0])
        line = body[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per channel along the row
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth depend on the decoded left
            cur = line.copy()
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prev[i - bpp]) if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"corrupt PNG: filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """uint8 [H, W, C] image from PNG bytes (C = 1 gray, 3 RGB, 4 RGBA)."""
    if not data.startswith(SIGNATURE):
        raise UnsupportedPNG("not a PNG file")
    pos = len(SIGNATURE)
    header = None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("corrupt PNG: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _CHANNELS or interlace:
        raise UnsupportedPNG(
            f"PNG with bit depth {depth}, colour type {color_type}, "
            f"interlace {interlace}: only 8-bit gray/RGB/RGBA, "
            "non-interlaced, is decoded natively")
    c = _CHANNELS[color_type]
    stride = w * c
    body = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    body = body[:h * (stride + 1)].reshape(h, stride + 1)
    return _unfilter(body, h, stride, c).reshape(h, w, c)


def write_png(path: str | Path, image: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(image))
