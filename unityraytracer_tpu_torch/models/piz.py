"""PIZ (wavelet + Huffman) codec for OpenEXR chunks.

PIZ is the most common compression for downloadable 4K EXR HDRIs — the
format family the reference's skybox set uses (`Assets/Skyboxes/*`, SURVEY
§2.3). This implements the PIZ chunk pipeline from the OpenEXR reference
implementation's documented algorithms (ImfPizCompressor / ImfWav / ImfHuf):

decode:  Huffman -> per-channel 2D Haar-style wavelet inverse -> LUT
encode:  bitmap/LUT -> per-channel wavelet forward -> Huffman

All stages are numpy-vectorized except the Huffman symbol loops. The
decode loop runs in the native host library (``native.huf_decode``,
``csrc/piz.cpp``) where it builds, and in Python otherwise (slow on a 4K
map); the encode loop is Python.

Wire-format details implemented here (needed to read real files):
* chunk = u16 minNonZero, u16 maxNonZero, bitmap bytes in that range,
  i32 huffman length, huffman blob.
* huffman blob = i32 im, i32 iM, i32 tableLength, i32 nBits, i32 reserved,
  packed code-length table (6-bit lengths, zero-run escapes 59..63),
  MSB-first bit stream. Symbol iM doubles as the run-length escape
  (next 8 bits = repeat count of the previous symbol).
* canonical codes: lengths 1..58; first code per length built longest-first
  via nc = (c + count[l]) >> 1; codes assigned in symbol order.
* wavelet: 14-bit exact transform when the LUT has < 2^14 entries, else the
  mod-2^16 variant; per level, horizontal then vertical pair encoding with
  odd-row/column 1D remainders.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

HUF_ENCSIZE = 65537
_BITMAP_SIZE = 8192
_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN   # 6
_LONGEST_LONG_RUN = 255 + _SHORTEST_LONG_RUN                         # 261

_A_OFFSET = 1 << 15
_MOD_MASK = (1 << 16) - 1


# ---------------------------------------------------------------------------
# Wavelet (ImfWav analog), vectorized per level
# ---------------------------------------------------------------------------

def _wenc14(a, b):
    a_ = a.astype(np.int16).astype(np.int32)
    b_ = b.astype(np.int16).astype(np.int32)
    m = (a_ + b_) >> 1
    d = a_ - b_
    return m.astype(np.uint16), d.astype(np.uint16)


def _wdec14(l, h):
    l_ = l.astype(np.int16).astype(np.int32)
    h_ = h.astype(np.int16).astype(np.int32)
    ai = l_ + (h_ & 1) + (h_ >> 1)
    return ai.astype(np.uint16), (ai - h_).astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int32) + _A_OFFSET) & _MOD_MASK
    b_ = b.astype(np.int32)
    m = (ao + b_) >> 1
    d = ao - b_
    m = np.where(d < 0, (m + _A_OFFSET) & _MOD_MASK, m)
    return m.astype(np.uint16), (d & _MOD_MASK).astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav_levels(nx: int, ny: int):
    """Levels (p, p2) in ENCODE order."""
    n = min(nx, ny)
    out = []
    p, p2 = 1, 2
    while p2 <= n:
        out.append((p, p2))
        p, p2 = p2, p2 * 2
    return out


def _wav2_level(a: np.ndarray, p: int, p2: int, enc, decode: bool) -> None:
    """One wavelet level over 2D uint16 view ``a``, in place."""
    ny, nx = a.shape
    ys = np.arange(0, ny - p2 + 1, p2) if ny >= p2 else np.arange(0)
    xs = np.arange(0, nx - p2 + 1, p2) if nx >= p2 else np.arange(0)
    if len(ys) and len(xs):
        A = a[np.ix_(ys, xs)]
        B = a[np.ix_(ys, xs + p)]
        C = a[np.ix_(ys + p, xs)]
        D = a[np.ix_(ys + p, xs + p)]
        if decode:
            i00, i10 = enc(A, C)
            i01, i11 = enc(B, D)
            A2, B2 = enc(i00, i01)
            C2, D2 = enc(i10, i11)
        else:
            i00, i01 = enc(A, B)
            i10, i11 = enc(C, D)
            A2, C2 = enc(i00, i10)
            B2, D2 = enc(i01, i11)
        a[np.ix_(ys, xs)] = A2
        a[np.ix_(ys, xs + p)] = B2
        a[np.ix_(ys + p, xs)] = C2
        a[np.ix_(ys + p, xs + p)] = D2
    if (nx & p) and len(ys):
        x_odd = p2 * len(xs)
        A2, C2 = enc(a[ys, x_odd], a[ys + p, x_odd])
        a[ys, x_odd] = A2
        a[ys + p, x_odd] = C2
    if (ny & p) and len(xs):
        y_odd = p2 * len(ys)
        A2, B2 = enc(a[y_odd, xs], a[y_odd, xs + p])
        a[y_odd, xs] = A2
        a[y_odd, xs + p] = B2


def wav2_encode(a: np.ndarray, max_value: int) -> None:
    enc = _wenc14 if max_value < (1 << 14) else _wenc16
    for p, p2 in _wav_levels(a.shape[1], a.shape[0]):
        _wav2_level(a, p, p2, enc, decode=False)


def wav2_decode(a: np.ndarray, max_value: int) -> None:
    dec = _wdec14 if max_value < (1 << 14) else _wdec16
    for p, p2 in reversed(_wav_levels(a.shape[1], a.shape[0])):
        _wav2_level(a, p, p2, dec, decode=True)


# ---------------------------------------------------------------------------
# Huffman (ImfHuf analog)
# ---------------------------------------------------------------------------

class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.c = 0
        self.lc = 0

    def write(self, nbits: int, val: int) -> None:
        self.c = (self.c << nbits) | (val & ((1 << nbits) - 1))
        self.lc += nbits
        while self.lc >= 8:
            self.lc -= 8
            self.buf.append((self.c >> self.lc) & 0xFF)
            self.c &= (1 << self.lc) - 1

    def flush(self) -> None:
        if self.lc:
            self.buf.append((self.c << (8 - self.lc)) & 0xFF)
            self.c = 0
            self.lc = 0


class _BitReader:
    """MSB-first reader; ``pos`` counts whole bytes consumed."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.c = 0
        self.lc = 0

    def read(self, nbits: int) -> int:
        while self.lc < nbits:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= nbits
        v = (self.c >> self.lc) & ((1 << nbits) - 1)
        self.c &= (1 << self.lc) - 1
        return v


def _huf_code_lengths(freq: np.ndarray) -> np.ndarray:
    """Huffman code lengths (int8 per symbol) from frequencies."""
    import heapq

    syms = np.nonzero(freq)[0]
    lengths = np.zeros(HUF_ENCSIZE, np.int32)
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths
    heap = [(int(freq[s]), int(s), (int(s),)) for s in syms]
    heapq.heapify(heap)
    while len(heap) > 1:
        f1, _, g1 = heapq.heappop(heap)
        f2, t2, g2 = heapq.heappop(heap)
        for s in g1 + g2:
            lengths[s] += 1
        heapq.heappush(heap, (f1 + f2, t2, g1 + g2))
    assert lengths.max() <= 58, "huffman length cap exceeded"
    return lengths


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical code values (per OpenEXR: longest length gets code 0...)."""
    counts = np.bincount(lengths, minlength=59)
    first = np.zeros(59, np.int64)
    c = 0
    for l in range(58, 0, -1):
        first[l] = c
        c = (c + int(counts[l])) >> 1
    codes = np.zeros(HUF_ENCSIZE, np.int64)
    next_code = first.copy()
    for sym in np.nonzero(lengths)[0]:
        l = int(lengths[sym])
        codes[sym] = next_code[l]
        next_code[l] += 1
    return codes


def _pack_enc_table(bw: _BitWriter, lengths: np.ndarray, im: int,
                    iM: int) -> None:
    i = im
    while i <= iM:
        l = int(lengths[i])
        if l == 0:
            zerun = 1
            while i < iM and zerun < _LONGEST_LONG_RUN \
                    and lengths[i + 1] == 0:
                i += 1
                zerun += 1
            if zerun >= 2:
                if zerun >= _SHORTEST_LONG_RUN:
                    bw.write(6, _LONG_ZEROCODE_RUN)
                    bw.write(8, zerun - _SHORTEST_LONG_RUN)
                else:
                    bw.write(6, _SHORT_ZEROCODE_RUN + zerun - 2)
                i += 1
                continue
        bw.write(6, l)
        i += 1


def _unpack_enc_table(br: _BitReader, im: int, iM: int) -> np.ndarray:
    lengths = np.zeros(HUF_ENCSIZE, np.int32)
    i = im
    while i <= iM:
        l = br.read(6)
        if l == _LONG_ZEROCODE_RUN:
            zerun = br.read(8) + _SHORTEST_LONG_RUN
            i += zerun
        elif l >= _SHORT_ZEROCODE_RUN:
            i += l - _SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = l
            i += 1
    return lengths


def huf_compress(raw: np.ndarray) -> bytes:
    """Huffman-compress a uint16 symbol array (OpenEXR hufCompress layout)."""
    raw = np.ascontiguousarray(raw, np.uint16)
    assert len(raw) > 0
    freq = np.bincount(raw, minlength=HUF_ENCSIZE).astype(np.int64)
    rlc = int(raw.max()) + 1
    freq[rlc] = 1     # pseudo-symbol: run-length escape (HUF_ENCSIZE = 65537)
    lengths = _huf_code_lengths(freq)
    codes = _canonical_codes(lengths)
    nz = np.nonzero(lengths)[0]
    im, iM = int(nz[0]), int(nz[-1])

    bw = _BitWriter()
    _pack_enc_table(bw, lengths, im, iM)
    bw.flush()
    table = bytes(bw.buf)

    # Run-segment the data (runs capped at 256 = 1 literal + 255 repeats).
    bounds = np.nonzero(np.diff(raw))[0] + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(raw)]])
    bw = _BitWriter()
    l_rlc = int(lengths[rlc])
    c_rlc = int(codes[rlc])
    for s0, e0 in zip(starts, ends):
        sym = int(raw[s0])
        l_s, c_s = int(lengths[sym]), int(codes[sym])
        n = int(e0 - s0)
        while n > 0:
            run = min(n, 256)
            cs = run - 1
            if l_s + l_rlc + 8 < l_s * run:
                bw.write(l_s, c_s)
                bw.write(l_rlc, c_rlc)
                bw.write(8, cs)
            else:
                for _ in range(run):
                    bw.write(l_s, c_s)
            n -= run
    n_bits = len(bw.buf) * 8 + bw.lc
    bw.flush()
    data = bytes(bw.buf)

    head = struct.pack("<iiiii", im, iM, len(table), n_bits, 0)
    return head + table + data


def _huf_decode_py(data: bytes, pos: int, n_bits: int, lengths: np.ndarray,
                   codes: np.ndarray, rlc: int, n_out: int) -> np.ndarray:
    """Pure-Python canonical decode (fallback; fine for tests)."""
    counts = np.bincount(lengths, minlength=59)
    first = np.zeros(59, np.int64)
    c = 0
    for l in range(58, 0, -1):
        first[l] = c
        c = (c + int(counts[l])) >> 1
    by_len: List[np.ndarray] = [np.zeros(0, np.int64)] * 59
    for l in range(1, 59):
        if counts[l]:
            by_len[l] = np.nonzero(lengths == l)[0]

    out = np.empty(n_out, np.uint16)
    n = 0
    bitpos = 0
    code = 0
    length = 0
    data_l = data

    def getbit(i):
        return (data_l[pos + (i >> 3)] >> (7 - (i & 7))) & 1

    while n < n_out and bitpos < n_bits:
        code = (code << 1) | getbit(bitpos)
        bitpos += 1
        length += 1
        if length > 58:
            raise ValueError("corrupt huffman stream")
        k = code - int(first[length])
        if 0 <= k < counts[length]:
            sym = int(by_len[length][k])
            if sym == rlc:
                if bitpos + 8 > n_bits:
                    raise ValueError("truncated run length")
                cs = 0
                for _ in range(8):
                    cs = (cs << 1) | getbit(bitpos)
                    bitpos += 1
                if n == 0:
                    raise ValueError("run with no previous symbol")
                out[n:n + cs] = out[n - 1]
                n += cs
            else:
                out[n] = sym
                n += 1
            code = 0
            length = 0
    if n != n_out:
        raise ValueError(f"huffman stream ended early ({n}/{n_out})")
    return out


def huf_decompress(blob: bytes, n_out: int) -> np.ndarray:
    """Inverse of :func:`huf_compress` -> uint16 array of ``n_out``."""
    im, iM, _table_len, n_bits, _ = struct.unpack_from("<iiiii", blob, 0)
    if not (0 <= im < HUF_ENCSIZE and 0 <= iM < HUF_ENCSIZE):
        raise ValueError("corrupt huffman header")
    br = _BitReader(blob, 20)
    lengths = _unpack_enc_table(br, im, iM)
    pos = br.pos       # data bits start at the next unread byte
    if n_bits > (len(blob) - pos) * 8:
        raise ValueError("truncated huffman data")

    from .. import native
    got = native.huf_decode(blob, pos, n_bits, lengths, iM, n_out)
    if got is not None:
        return got
    codes = _canonical_codes(lengths)
    return _huf_decode_py(blob, pos, n_bits, lengths, codes, iM, n_out)


# ---------------------------------------------------------------------------
# Bitmap / LUT (ImfPizCompressor analog)
# ---------------------------------------------------------------------------

def _bitmap_from_data(raw: np.ndarray) -> np.ndarray:
    present = np.zeros(65536, bool)
    present[raw] = True
    present[0] = False          # zero is implicit, never stored
    return np.packbits(present, bitorder="little")


def _forward_lut(bitmap: np.ndarray) -> Tuple[np.ndarray, int]:
    bits = np.unpackbits(bitmap, bitorder="little").astype(bool)
    bits[0] = True              # zero always present
    lut = np.cumsum(bits).astype(np.uint16) - 1
    lut[~bits] = 0
    return lut, int(bits.sum()) - 1


def _reverse_lut(bitmap: np.ndarray) -> Tuple[np.ndarray, int]:
    bits = np.unpackbits(bitmap, bitorder="little").astype(bool)
    bits[0] = True
    idx = np.nonzero(bits)[0]
    lut = np.zeros(65536, np.uint16)
    lut[:len(idx)] = idx
    return lut, len(idx) - 1


# ---------------------------------------------------------------------------
# PIZ chunk pipeline
# ---------------------------------------------------------------------------

def piz_decompress(payload: bytes, chan_sizes: Sequence[int], nx: int,
                   ny: int) -> bytes:
    """Decode one PIZ chunk into raw scanline-interleaved channel bytes.

    ``chan_sizes``: per channel (file order), pixel size in uint16 units
    (1 = HALF, 2 = FLOAT/UINT). ``ny`` = scanlines in this chunk.
    """
    min_nz, max_nz = struct.unpack_from("<HH", payload, 0)
    pos = 4
    bitmap = np.zeros(_BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        if max_nz >= _BITMAP_SIZE:
            raise ValueError("corrupt PIZ bitmap range")
        nb = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(payload, np.uint8, nb, pos)
        pos += nb
    lut, max_value = _reverse_lut(bitmap)
    (length,) = struct.unpack_from("<i", payload, pos)
    pos += 4

    total = nx * ny * int(sum(chan_sizes))
    tmp = huf_decompress(payload[pos:pos + length], total)

    off = 0
    for sz in chan_sizes:
        cnt = nx * ny * sz
        view = tmp[off:off + cnt].reshape(ny, nx, sz)
        for j in range(sz):
            wav2_decode(view[:, :, j], max_value)
        off += cnt
    tmp = lut[tmp]

    out = np.empty((ny, nx * int(sum(chan_sizes))), np.uint16)
    col = 0
    off = 0
    for sz in chan_sizes:
        cnt = nx * ny * sz
        out[:, col:col + nx * sz] = tmp[off:off + cnt].reshape(ny, nx * sz)
        col += nx * sz
        off += cnt
    return out.astype("<u2").tobytes()


def piz_compress(raw: bytes, chan_sizes: Sequence[int], nx: int,
                 ny: int) -> bytes:
    """Encode raw scanline-interleaved channel bytes as one PIZ chunk."""
    width = nx * int(sum(chan_sizes))
    data = np.frombuffer(raw, "<u2").reshape(ny, width).astype(np.uint16)

    # De-interleave scanlines into channel-contiguous layout.
    tmp = np.empty(ny * width, np.uint16)
    col = 0
    off = 0
    for sz in chan_sizes:
        cnt = nx * ny * sz
        tmp[off:off + cnt] = data[:, col:col + nx * sz].reshape(-1)
        col += nx * sz
        off += cnt

    bitmap = _bitmap_from_data(tmp)
    lut, max_value = _forward_lut(bitmap)
    tmp = lut[tmp]
    off = 0
    for sz in chan_sizes:
        cnt = nx * ny * sz
        view = tmp[off:off + cnt].reshape(ny, nx, sz)
        for j in range(sz):
            wav2_encode(view[:, :, j], max_value)
        off += cnt
    blob = huf_compress(tmp)

    nz = np.nonzero(bitmap)[0]
    if len(nz):
        min_nz, max_nz = int(nz[0]), int(nz[-1])
        head = struct.pack("<HH", min_nz, max_nz) \
            + bitmap[min_nz:max_nz + 1].tobytes()
    else:
        head = struct.pack("<HH", _BITMAP_SIZE - 1, 0)   # empty range
    return head + struct.pack("<i", len(blob)) + blob
