"""PIZ (wavelet + Huffman) codec for the EXR reader.

PIZ is the single most common compression for wild EXR skyboxes; the
reference decodes any common EXR via the `image` crate
(/root/reference/src/main.rs:63,145). This is a ground-up port of the
OpenEXR PIZ pipeline (ImfPizCompressor / ImfHuf / ImfWav semantics):

decode: huffman -> per-channel 2D wavelet inverse -> reverse-LUT
encode: bitmap/forward-LUT -> per-channel 2D wavelet -> huffman

The wavelet stages are numpy-vectorized (whole scale-grids at once); the
Huffman symbol loops are plain Python — fine for the startup-time,
load-once skybox path this feeds (a 2k x 1k HALF sky decodes in tens of
seconds; convert offline if that matters).

The encoder exists primarily to generate test fixtures and interchange
output (tests/test_exr.py round-trips HALF and FLOAT channels, odd sizes
and multi-block images); it emits spec-conformant streams (canonical
codes, zero-run table packing, run-length codes) that any OpenEXR reader
accepts.
"""

from __future__ import annotations

import heapq
import struct

import numpy as np

BITMAP_SIZE = 8192  # 65536 / 8
HUF_ENCSIZE = 65537  # 2^16 + 1 (the run-length code can be symbol 65536)
HUF_DECBITS = 14
HUF_DECSIZE = 1 << HUF_DECBITS
HUF_DECMASK = HUF_DECSIZE - 1
SHORT_ZEROCODE_RUN = 59
LONG_ZEROCODE_RUN = 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN  # 6


# ---------------------------------------------------------------------------
# Bitmap / LUT (ImfPizCompressor bitmapFromData / forward/reverseLut)
# ---------------------------------------------------------------------------

def _bitmap_from_data(data: np.ndarray) -> np.ndarray:
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    vals = np.unique(data)
    np.bitwise_or.at(bitmap, vals >> 3, (1 << (vals & 7)).astype(np.uint8))
    bitmap[0] &= 0xFE  # zero is implicitly present, never stored
    return bitmap


def _forward_lut_from_bitmap(bitmap: np.ndarray) -> tuple[np.ndarray, int]:
    bits = np.unpackbits(bitmap, bitorder="little")  # [65536]
    present = bits.astype(bool)
    present[0] = True
    lut = np.cumsum(present).astype(np.uint16) - 1
    lut[~present] = 0
    max_value = int(present.sum()) - 1
    return lut, max_value


def _reverse_lut_from_bitmap(bitmap: np.ndarray) -> tuple[np.ndarray, int]:
    bits = np.unpackbits(bitmap, bitorder="little")
    present = bits.astype(bool)
    present[0] = True
    vals = np.nonzero(present)[0].astype(np.uint16)
    lut = np.zeros(HUF_ENCSIZE - 1, np.uint16)
    lut[:vals.shape[0]] = vals
    return lut, vals.shape[0] - 1


# ---------------------------------------------------------------------------
# 2D wavelet (ImfWav.cpp wav2Encode / wav2Decode), numpy-vectorized
# ---------------------------------------------------------------------------

_NBITS = 16
_A_OFFSET = 1 << (_NBITS - 1)
_MOD_MASK = (1 << _NBITS) - 1


def _wenc14(a, b):
    a_s = a.view(np.int16).astype(np.int32)
    b_s = b.view(np.int16).astype(np.int32)
    m = (a_s + b_s) >> 1
    d = a_s - b_s
    return (m.astype(np.int16).view(np.uint16),
            d.astype(np.int16).view(np.uint16))


def _wdec14(l, h):
    ls = l.view(np.int16).astype(np.int32)
    hs = h.view(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai
    b = ai - hs
    return (a.astype(np.int16).view(np.uint16),
            b.astype(np.int16).view(np.uint16))


def _wenc16(a, b):
    ao = (a.astype(np.int32) + _A_OFFSET) & _MOD_MASK
    bi = b.astype(np.int32)
    m = (ao + bi) >> 1
    d = ao - bi
    m = np.where(d < 0, (m + _A_OFFSET) & _MOD_MASK, m)
    d &= _MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav_grid(nx, ox, ny, oy, p, p2):
    """Flat indices of the 2x2 block corners at scale (p, p2)."""
    if ny - p2 >= 0:
        ys = np.arange(0, ny - p2 + 1, p2)
    else:
        ys = np.zeros(0, np.int64)
    if nx - p2 >= 0:
        xs = np.arange(0, nx - p2 + 1, p2)
    else:
        xs = np.zeros(0, np.int64)
    base = (ys[:, None] * oy + xs[None, :] * ox).reshape(-1)
    y_end = ys.shape[0] * p2  # first row past the loop
    x_end = xs.shape[0] * p2  # first column past the loop
    return base, ys, xs, y_end, x_end


def _wav2_xform(buf: np.ndarray, nx, ox, ny, oy, mx, encode: bool):
    """In-place 2D wavelet on the u16 view `buf` (flat), geometry in u16
    units exactly as ImfWav (nx columns stride ox, ny rows stride oy)."""
    w14 = mx < (1 << 14)
    enc2 = _wenc14 if w14 else _wenc16
    dec2 = _wdec14 if w14 else _wdec16
    n = min(nx, ny)

    scales = []
    p = 1
    p2 = 2
    while p2 <= n:
        scales.append((p, p2))
        p = p2
        p2 <<= 1
    if not encode:
        scales = scales[::-1]

    for p, p2 in scales:
        base, ys, xs, y_end, x_end = _wav_grid(nx, ox, ny, oy, p, p2)
        ox1 = ox * p
        oy1 = oy * p
        if base.size:
            i_px = base
            i_p01 = base + ox1
            i_p10 = base + oy1
            i_p11 = base + oy1 + ox1
            v00, v01 = buf[i_px], buf[i_p01]
            v10, v11 = buf[i_p10], buf[i_p11]
            if encode:
                i00, i01 = enc2(v00, v01)
                i10, i11 = enc2(v10, v11)
                o00, o10 = enc2(i00, i10)
                o01, o11 = enc2(i01, i11)
            else:
                i00, i10 = dec2(v00, v10)
                i01, i11 = dec2(v01, v11)
                o00, o01 = dec2(i00, i01)
                o10, o11 = dec2(i10, i11)
            buf[i_px], buf[i_p01] = o00, o01
            buf[i_p10], buf[i_p11] = o10, o11
        if nx & p and ys.size:
            # odd last column: vertical 1D pairs
            i_px = ys * oy + x_end * ox
            i_p10 = i_px + oy1
            f = enc2 if encode else dec2
            buf[i_px], buf[i_p10] = f(buf[i_px], buf[i_p10])
        if ny & p and xs.size:
            # odd last row: horizontal 1D pairs
            i_px = y_end * oy + xs * ox
            i_p01 = i_px + ox1
            f = enc2 if encode else dec2
            buf[i_px], buf[i_p01] = f(buf[i_px], buf[i_p01])


# ---------------------------------------------------------------------------
# Huffman (ImfHuf.cpp semantics)
# ---------------------------------------------------------------------------

def _huf_code_lengths(freq: np.ndarray) -> np.ndarray:
    """Code length per symbol via a plain Huffman heap (max depth is
    Fibonacci-bounded far below the format's 58-bit cap for any real
    input size)."""
    lengths = np.zeros(HUF_ENCSIZE, np.int32)
    nz = np.nonzero(freq)[0]
    if nz.size == 0:
        return lengths
    if nz.size == 1:
        lengths[nz[0]] = 1
        return lengths
    heap = [(int(freq[s]), int(s), [int(s)]) for s in nz]
    heapq.heapify(heap)
    tiebreak = HUF_ENCSIZE
    while len(heap) > 1:
        fa, _, syms_a = heapq.heappop(heap)
        fb, _, syms_b = heapq.heappop(heap)
        for s in syms_a:
            lengths[s] += 1
        for s in syms_b:
            lengths[s] += 1
        heapq.heappush(heap, (fa + fb, tiebreak, syms_a + syms_b))
        tiebreak += 1
    return lengths


def _huf_canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """hufCanonicalCodeTable: code = length | canonical_code << 6."""
    n = np.bincount(lengths, minlength=59).astype(np.int64)
    c = 0
    base = np.zeros(59, np.int64)
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        base[i] = c
        c = nc
    hcode = np.zeros(HUF_ENCSIZE, np.int64)
    for s in np.nonzero(lengths)[0]:
        li = lengths[s]
        hcode[s] = li | (base[li] << 6)
        base[li] += 1
    return hcode


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.c = 0
        self.lc = 0

    def write(self, nbits: int, val: int):
        self.c = (self.c << nbits) | val
        self.lc += nbits
        while self.lc >= 8:
            self.lc -= 8
            self.out.append((self.c >> self.lc) & 0xFF)

    def flush(self):
        if self.lc:
            self.out.append((self.c << (8 - self.lc)) & 0xFF)
            self.lc = 0


def _huf_pack_enc_table(hcode: np.ndarray, im: int, iM: int) -> bytes:
    """6-bit lengths with short/long zero runs (hufPackEncTable)."""
    w = _BitWriter()
    i = im
    lens = (hcode & 63).astype(np.int64)
    while i <= iM:
        li = int(lens[i])
        if li == 0:
            run = 1
            while i + run <= iM and lens[i + run] == 0:
                run += 1
            while run >= SHORTEST_LONG_RUN:
                chunk = min(run, 255 + SHORTEST_LONG_RUN)
                w.write(6, LONG_ZEROCODE_RUN)
                w.write(8, chunk - SHORTEST_LONG_RUN)
                run -= chunk
                i += chunk
            if run >= 2:
                w.write(6, SHORT_ZEROCODE_RUN + run - 2)
                i += run
                run = 0
            elif run == 1:
                w.write(6, 0)
                i += 1
        else:
            w.write(6, li)
            i += 1
    w.flush()
    return bytes(w.out)


def _huf_unpack_enc_table(data: bytes, pos: int, im: int, iM: int
                          ) -> tuple[np.ndarray, int]:
    """hufUnpackEncTable: 6-bit lengths + zero runs -> canonical codes.
    Returns (hcode, new byte position)."""
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    c = 0
    lc = 0
    i = im
    while i <= iM:
        while lc < 6:
            c = (c << 8) | data[pos]
            pos += 1
            lc += 8
        lc -= 6
        li = (c >> lc) & 63
        if li == LONG_ZEROCODE_RUN:
            while lc < 8:
                c = (c << 8) | data[pos]
                pos += 1
                lc += 8
            lc -= 8
            zerun = ((c >> lc) & 0xFF) + SHORTEST_LONG_RUN
            if i + zerun > iM + 1:
                raise ValueError("PIZ: bad zero run in code table")
            i += zerun
        elif li >= SHORT_ZEROCODE_RUN:
            zerun = li - SHORT_ZEROCODE_RUN + 2
            if i + zerun > iM + 1:
                raise ValueError("PIZ: bad zero run in code table")
            i += zerun
        else:
            lengths[i] = li
            i += 1
    return _huf_canonical_codes(lengths), pos


def _huf_build_dec_table(hcode: np.ndarray, im: int, iM: int):
    """14-bit fast table (len, symbol) + long-code candidate lists."""
    fast_len = np.zeros(HUF_DECSIZE, np.int32)
    fast_sym = np.zeros(HUF_DECSIZE, np.int32)
    longs: dict[int, list[tuple[int, int, int]]] = {}
    for s in range(im, iM + 1):
        code = int(hcode[s]) >> 6
        li = int(hcode[s]) & 63
        if li == 0:
            continue
        if li > HUF_DECBITS:
            idx = code >> (li - HUF_DECBITS)
            longs.setdefault(idx, []).append((code, li, s))
        else:
            idx = code << (HUF_DECBITS - li)
            span = 1 << (HUF_DECBITS - li)
            fast_len[idx:idx + span] = li
            fast_sym[idx:idx + span] = s
    return fast_len, fast_sym, longs


def _huf_encode(hcode: np.ndarray, data: np.ndarray, rlc: int
                ) -> tuple[bytes, int]:
    """hufEncode with run-length codes. Returns (bytes, nBits)."""
    codes = (hcode >> 6).astype(object)
    lens = (hcode & 63).astype(np.int64)
    w = _BitWriter()
    nbits = 0
    n = data.shape[0]
    i = 0
    rlc_code, rlc_len = int(codes[rlc]), int(lens[rlc])
    while i < n:
        s = int(data[i])
        run = 1
        while i + run < n and int(data[i + run]) == s and run < 256:
            run += 1
        li = int(lens[s])
        w.write(li, int(codes[s]))
        nbits += li
        # runs: cheaper as rlc + count when they beat repeated codes
        # (hufEncode's sendCode heuristic)
        if run > 1 and rlc_len + 8 < li * (run - 1):
            w.write(rlc_len, rlc_code)
            w.write(8, run - 1)
            nbits += rlc_len + 8
        else:
            for _ in range(run - 1):
                w.write(li, int(codes[s]))
                nbits += li
        i += run
    w.flush()
    return bytes(w.out), nbits


def _huf_decode(data: bytes, pos: int, nbits: int, rlc: int, n_out: int,
                fast_len, fast_sym, longs) -> np.ndarray:
    """hufDecode: table-driven MSB-first decode with run-length codes."""
    out = np.zeros(n_out, np.uint16)
    oi = 0
    c = 0
    lc = 0
    ie = pos + ((nbits + 7) >> 3)
    fl = fast_len
    fs = fast_sym

    def emit(sym):
        nonlocal oi, c, lc, pos
        if sym == rlc:
            if lc < 8:
                c = (c << 8) | data[pos]
                pos += 1
                lc += 8
            lc -= 8
            cs = (c >> lc) & 0xFF
            if oi == 0 or oi + cs > n_out:
                raise ValueError("PIZ: bad run-length")
            out[oi:oi + cs] = out[oi - 1]
            oi += cs
        else:
            if oi >= n_out:
                raise ValueError("PIZ: too much data")
            out[oi] = sym
            oi += 1

    while pos < ie:
        c = (c << 8) | data[pos]
        pos += 1
        lc += 8
        while lc >= HUF_DECBITS:
            idx = (c >> (lc - HUF_DECBITS)) & HUF_DECMASK
            li = int(fl[idx])
            if li:
                lc -= li
                emit(int(fs[idx]))
            else:
                for code, cl, sym in longs.get(idx, ()):
                    while lc < cl and pos < ie:
                        c = (c << 8) | data[pos]
                        pos += 1
                        lc += 8
                    if lc >= cl and ((c >> (lc - cl))
                                     & ((1 << cl) - 1)) == code:
                        lc -= cl
                        emit(sym)
                        break
                else:
                    raise ValueError("PIZ: invalid huffman code")
    i = (8 - nbits) & 7
    c >>= i
    lc -= i
    while lc > 0:
        idx = ((c << (HUF_DECBITS - lc)) & HUF_DECMASK)
        li = int(fl[idx])
        if li and li <= lc:
            lc -= li
            emit(int(fs[idx]))
        else:
            break
    if oi != n_out:
        raise ValueError(f"PIZ: expected {n_out} symbols, got {oi}")
    return out


def huf_compress(data: np.ndarray) -> bytes:
    """hufCompress: header + packed table + bit stream."""
    freq = np.bincount(data.astype(np.int64), minlength=HUF_ENCSIZE)
    nz = np.nonzero(freq)[0]
    im = int(nz[0]) if nz.size else 0
    rlc = (int(nz[-1]) + 1) if nz.size else 1
    freq[rlc] = 1  # the run-length code is one past the max data symbol
    iM = rlc
    hcode = _huf_canonical_codes(_huf_code_lengths(freq))
    table = _huf_pack_enc_table(hcode, im, iM)
    stream, nbits = _huf_encode(hcode, data, rlc)
    head = struct.pack("<IIIII", im, iM, len(table), nbits, 0)
    return head + table + stream


def huf_uncompress(data: bytes, n_out: int) -> np.ndarray:
    im, iM, _table_len, nbits, _ = struct.unpack_from("<IIIII", data, 0)
    if iM >= HUF_ENCSIZE:
        raise ValueError("PIZ: corrupt huffman header")
    hcode, pos = _huf_unpack_enc_table(data, 20, im, iM)
    fast_len, fast_sym, longs = _huf_build_dec_table(hcode, im, iM)
    return _huf_decode(data, pos, nbits, iM, n_out, fast_len, fast_sym,
                       longs)


# ---------------------------------------------------------------------------
# PIZ block codec (ImfPizCompressor compress/uncompress)
# ---------------------------------------------------------------------------

def _channel_geometry(channels, width: int, n_lines: int):
    """Per-channel (nx, ny, size-in-u16s) + start offsets in the block's
    u16 buffer (channel-major planes)."""
    geo = []
    start = 0
    for _name, dt in channels:
        size = np.dtype(dt).itemsize // 2
        count = width * n_lines * size
        geo.append((width, n_lines, size, start))
        start += count
    return geo, start


def piz_uncompress(raw: bytes, channels, width: int, n_lines: int) -> bytes:
    """Decode one PIZ block -> scanline-interleaved bytes (the NONE
    layout: per scanline, each channel's width*size u16s, LE)."""
    pos = 0
    min_nz, max_nz = struct.unpack_from("<HH", raw, pos)
    pos += 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        nbytes = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(raw, np.uint8, nbytes, pos)
        pos += nbytes
    lut, max_value = _reverse_lut_from_bitmap(bitmap)

    (length,) = struct.unpack_from("<i", raw, pos)
    pos += 4
    geo, total = _channel_geometry(channels, width, n_lines)
    buf = huf_uncompress(raw[pos:pos + length], total)

    # ImfPizCompressor: one transform per u16 slice j with ox=size
    for nx, ny, size, start in geo:
        for j in range(size):
            view = buf[start + j:start + nx * ny * size]
            _wav2_xform(view, nx, size, ny, nx * size, max_value,
                        encode=False)

    buf = lut[buf]

    # channel-major planes -> scanline-interleaved
    out = bytearray()
    cursors = [start for _, _, _, start in geo]
    for _line in range(n_lines):
        for ci, (nx, _ny, size, _start) in enumerate(geo):
            cnt = nx * size
            out += buf[cursors[ci]:cursors[ci] + cnt].astype("<u2").tobytes()
            cursors[ci] += cnt
    return bytes(out)


def piz_compress(scanline_bytes: bytes, channels, width: int,
                 n_lines: int) -> bytes:
    """Encode scanline-interleaved bytes (NONE layout) -> one PIZ block."""
    geo, total = _channel_geometry(channels, width, n_lines)
    flat = np.frombuffer(scanline_bytes, "<u2").astype(np.uint16)
    buf = np.zeros(total, np.uint16)
    # interleaved scanlines -> channel-major planes
    cursors = [start for _, _, _, start in geo]
    pos = 0
    for _line in range(n_lines):
        for ci, (nx, _ny, size, _start) in enumerate(geo):
            cnt = nx * size
            buf[cursors[ci]:cursors[ci] + cnt] = flat[pos:pos + cnt]
            cursors[ci] += cnt
            pos += cnt

    bitmap = _bitmap_from_data(buf)
    lut, max_value = _forward_lut_from_bitmap(bitmap)
    buf = lut[buf]

    for nx, ny, size, start in geo:
        for j in range(size):
            view = buf[start + j:start + nx * ny * size]
            _wav2_xform(view, nx, size, ny, nx * size, max_value,
                        encode=True)

    nz = np.nonzero(bitmap)[0]
    if nz.size:
        min_nz, max_nz = int(nz[0]), int(nz[-1])
        bm_bytes = bitmap[min_nz:max_nz + 1].tobytes()
    else:
        min_nz, max_nz = BITMAP_SIZE - 1, 0
        bm_bytes = b""
    huf = huf_compress(buf)
    return (struct.pack("<HH", min_nz, max_nz) + bm_bytes
            + struct.pack("<i", len(huf)) + huf)
