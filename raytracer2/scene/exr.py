"""Minimal OpenEXR 2.0 scanline reader + procedural sky generator.

The reference loads an equirectangular EXR skybox via the `image` crate
(src/main.rs:63, 145: image::open("src/models/skybox2.exr") -> RGBA32F
upload). No EXR library ships in this environment, so this is a ground-up
reader for the common scanline formats: NONE, RLE, ZIPS, ZIP and PIZ
compression (PIZ via scene/piz.py — wavelet + Huffman, the most common
wild-skybox format; B44/DWA are not supported — convert offline),
HALF/FLOAT/UINT channels.

Returns [H, W, 3] float32 linear RGB.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_MAGIC = 20000630
_PIXEL_TYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
# none, rle, zips, zip, piz -> scanlines per block
_COMPRESSION_SCANLINES = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32}


def _read_null_str(buf: bytes, off: int) -> tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin-1"), end + 1


def _parse_header(buf: bytes, off: int) -> tuple[dict, int]:
    attrs = {}
    while True:
        if buf[off] == 0:
            off += 1
            break
        name, off = _read_null_str(buf, off)
        atype, off = _read_null_str(buf, off)
        size = struct.unpack_from("<I", buf, off)[0]
        off += 4
        attrs[name] = (atype, buf[off:off + size])
        off += size
    return attrs, off


def _reconstruct_zip(data: bytes) -> bytes:
    """Invert EXR's zip byte reordering: delta-decode then merge halves."""
    d = np.frombuffer(data, np.uint8).astype(np.int64)
    n = d.shape[0]
    t = (np.cumsum(d) - 128 * np.arange(n)) % 256
    t = t.astype(np.uint8)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def _decode_rle(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data) and len(out) < expected:
        count = struct.unpack_from("b", data, i)[0]
        i += 1
        if count < 0:
            out += data[i:i - count]
            i += -count
        else:
            out += data[i:i + 1] * (count + 1)
            i += 1
    # RLE output uses the same predictor+interleave as zip
    return _reconstruct_zip(bytes(out))


def load_exr(path: str | Path) -> np.ndarray:
    """Read an EXR file -> [H, W, 3] float32 RGB."""
    buf = Path(path).read_bytes()
    magic, version = struct.unpack_from("<iI", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise ValueError("tiled EXR not supported (use scanline)")

    attrs, off = _parse_header(buf, 8)

    # channels
    chan_buf = attrs["channels"][1]
    channels = []  # (name, dtype) sorted as stored (alphabetical)
    coff = 0
    while chan_buf[coff] != 0:
        cname, coff = _read_null_str(chan_buf, coff)
        ptype, _flags, _xs, _ys = struct.unpack_from("<iiii", chan_buf, coff)
        coff += 16
        channels.append((cname, _PIXEL_TYPES[ptype]))

    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    width = x1 - x0 + 1
    height = y1 - y0 + 1
    compression = attrs["compression"][1][0]
    if compression not in _COMPRESSION_SCANLINES:
        raise ValueError(f"unsupported EXR compression {compression} "
                         "(only none/rle/zips/zip/piz)")
    lines_per_block = _COMPRESSION_SCANLINES[compression]

    n_blocks = (height + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, off)

    planes = {name: np.zeros((height, width), np.float32)
              for name, _ in channels}
    bytes_per_line = sum(np.dtype(d).itemsize for _, d in channels) * width

    for block_off in offsets:
        y, size = struct.unpack_from("<ii", buf, block_off)
        raw = buf[block_off + 8: block_off + 8 + size]
        n_lines = min(lines_per_block, y1 - y + 1)
        expected = bytes_per_line * n_lines
        if compression == 0 or size >= expected:
            # writers store a block RAW when compression didn't shrink it
            # (OpenEXR readers detect this by size)
            data = raw
        elif compression == 1:
            data = _decode_rle(raw, expected)
        elif compression == 4:
            from raytracer2.scene.piz import piz_uncompress

            data = piz_uncompress(raw, channels, width, n_lines)
        else:
            data = _reconstruct_zip(zlib.decompress(raw))
        pos = 0
        for line in range(n_lines):
            yy = y - y0 + line
            for cname, cdtype in channels:
                nbytes = np.dtype(cdtype).itemsize * width
                vals = np.frombuffer(data, cdtype, width, pos)
                planes[cname][yy] = vals.astype(np.float32)
                pos += nbytes

    def plane(name):
        if name in planes:
            return planes[name]
        return np.zeros((height, width), np.float32)

    return np.stack([plane("R"), plane("G"), plane("B")], axis=-1)


def write_exr(path: str | Path, rgb: np.ndarray,
              compression: str = "none",
              dtype: str = "float32") -> None:
    """Write [H, W, 3] as a scanline EXR (test fixture generator and
    interchange output). compression: "none" or "piz"; dtype: "float32"
    (FLOAT channels) or "float16" (HALF)."""
    np_dtype = np.float16 if dtype == "float16" else np.float32
    ptype = 1 if dtype == "float16" else 2
    comp_id = {"none": 0, "piz": 4}[compression]
    rgb = np.asarray(rgb, np_dtype)
    h, w, _ = rgb.shape

    def attr(name: str, atype: str, data: bytes) -> bytes:
        return (name.encode() + b"\x00" + atype.encode() + b"\x00"
                + struct.pack("<I", len(data)) + data)

    chan = b""
    for cname in (b"B", b"G", b"R"):  # alphabetical storage order
        chan += cname + b"\x00" + struct.pack("<iiii", ptype, 0, 1, 1)
    chan += b"\x00"

    dw = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b""
    header += attr("channels", "chlist", chan)
    header += attr("compression", "compression", bytes([comp_id]))
    header += attr("dataWindow", "box2i", dw)
    header += attr("displayWindow", "box2i", dw)
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    lines_per_block = _COMPRESSION_SCANLINES[comp_id]
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    channels = [("B", np_dtype), ("G", np_dtype), ("R", np_dtype)]

    blocks = []
    for b in range(n_blocks):
        y = b * lines_per_block
        n_lines = min(lines_per_block, h - y)
        scan = bytearray()
        for line in range(n_lines):
            scan += rgb[y + line, :, 2].tobytes()  # B
            scan += rgb[y + line, :, 1].tobytes()  # G
            scan += rgb[y + line, :, 0].tobytes()  # R
        scan = bytes(scan)
        if comp_id == 4:
            from raytracer2.scene.piz import piz_compress

            packed = piz_compress(scan, channels, w, n_lines)
            # store raw when compression didn't shrink the block (the
            # reader detects this by size, like OpenEXR)
            if len(packed) >= len(scan):
                packed = scan
        else:
            packed = scan
        blocks.append((y, packed))

    preamble = struct.pack("<iI", _MAGIC, 2) + header
    data_start = len(preamble) + 8 * n_blocks

    out = bytearray(preamble)
    off = data_start
    for y, packed in blocks:
        out += struct.pack("<Q", off)
        off += 8 + len(packed)
    for y, packed in blocks:
        out += struct.pack("<ii", y, len(packed))
        out += packed
    Path(path).write_bytes(bytes(out))


def procedural_sky(height: int = 256, sun_dir=(0.3, 0.8, 0.5),
                   sun_intensity: float = 50.0,
                   horizon=(0.6, 0.7, 0.9), zenith=(0.2, 0.35, 0.7)
                   ) -> np.ndarray:
    """Equirect gradient sky + gaussian sun disk, [H, 2H, 3] float32.
    Stand-in for the reference's skybox2.exr asset."""
    width = height * 2
    v, u = np.meshgrid(
        (np.arange(height) + 0.5) / height,
        (np.arange(width) + 0.5) / width, indexing="ij")
    elevation = (0.5 - v) * np.pi
    azimuth = (u + 0.25) * 2 * np.pi
    ce = np.cos(elevation)
    dirs = np.stack([np.cos(azimuth) * ce, np.sin(elevation),
                     np.sin(azimuth) * ce], axis=-1)
    sun = np.asarray(sun_dir, np.float32)
    sun = sun / np.linalg.norm(sun)
    cos_sun = np.clip(dirs @ sun, -1, 1)
    t = np.clip(dirs[..., 1] * 0.5 + 0.5, 0, 1)[..., None]
    sky = (1 - t) * np.asarray(horizon, np.float32) + t * np.asarray(
        zenith, np.float32)
    sun_disk = np.exp((cos_sun - 1.0) * 4000.0)[..., None] * sun_intensity
    return (sky + sun_disk).astype(np.float32)
