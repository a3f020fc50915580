"""OpenEXR B44 / B44A codec (HALF channels in fixed-rate 4x4 blocks).

Implements the B44 block format from the OpenEXR specification: each 4x4
block of HALF pixels packs to 14 bytes — a base value, a shift, and 15
6-bit biased running differences over a monotonic remap of the half bit
patterns — giving fixed-rate ~2.3x compression designed for random access
playback. B44A additionally packs all-flat blocks to 3 bytes (marker byte
``0xfc``). Non-HALF channels are stored uncompressed, per the spec.

Properties (all spec behavior, covered by tests):
  * blocks whose remapped range needs no shift decode EXACTLY;
  * flat blocks are exact (3-byte form under B44A);
  * infinities and NaNs are flushed to zero by the ENCODER;
  * decode of any valid stream is deterministic and exact w.r.t. the file.

Used by models/exr.py for ``compression`` ids 6 (B44) and 7 (B44A);
completes the reference's skybox format coverage (`Assets/Skyboxes/` is
"16 4K HDR/EXR maps", SURVEY §2.3).

The rounding used when shifting differences is round-half-to-even; any
self-consistent rounding yields a valid stream (the format stores the
rounded values), so files written here decode bit-identically here and in
libopenexr.
"""

from __future__ import annotations

import numpy as np

_BIAS = 0x20


def _to_monotonic(s: np.ndarray) -> np.ndarray:
    """Half bit patterns -> order-preserving uint16 space (negatives
    complemented, positives offset past them); inf/NaN flush to 0x8000
    (decodes as zero) — the encoder-side lossy rule of the format."""
    s = s.astype(np.uint32)
    t = np.where(s & 0x8000, (~s) & 0xFFFF, s | 0x8000)
    return np.where((s & 0x7C00) == 0x7C00, 0x8000, t).astype(np.uint32)


def _from_monotonic(t: np.ndarray) -> np.ndarray:
    t = t.astype(np.uint32) & 0xFFFF
    return np.where(t & 0x8000, t & 0x7FFF, (~t) & 0xFFFF).astype(np.uint16)


def _shift_round(x: np.ndarray, shift: int) -> np.ndarray:
    """round(x / 2**shift) with ties to even (x >= 0 int array)."""
    if shift == 0:
        return x
    q = x >> shift
    r2 = (x - (q << shift)) << 1          # 2 * remainder
    half = 1 << shift
    up = (r2 > half) | ((r2 == half) & ((q & 1) == 1))
    return q + up.astype(x.dtype)


# The 15 running differences chain the 4x4 block (row-major s[y*4+x]) as:
# down the first column, then along each row — (a, b) meaning r = d[a]-d[b].
_CHAIN = [(0, 4), (4, 8), (8, 12),
          (0, 1), (4, 5), (8, 9), (12, 13),
          (1, 2), (5, 6), (9, 10), (13, 14),
          (2, 3), (6, 7), (10, 11), (14, 15)]


def _pack_blocks(s16: np.ndarray, flat3: bool) -> "tuple[np.ndarray, np.ndarray]":
    """Pack (nb, 16) half bit patterns -> ((nb, 14) bytes, (nb,) is3 mask).

    Vectorized over blocks: the per-block shift search runs as ~17 masked
    numpy sweeps instead of a python loop per block.
    """
    nb = s16.shape[0]
    t = _to_monotonic(s16).astype(np.int64)            # (nb, 16)
    t_max = t.max(axis=1, keepdims=True)

    d = np.zeros_like(t)
    r = np.zeros((nb, 15), np.int64)
    shift = np.zeros((nb,), np.int64)
    pending = np.ones((nb,), bool)
    for sh in range(17):
        if not pending.any():
            break
        d_try = _shift_round(t_max - t, sh)
        r_try = np.stack([d_try[:, a] - d_try[:, b] + _BIAS
                          for a, b in _CHAIN], axis=1)
        ok = (r_try.min(axis=1) >= 0) & (r_try.max(axis=1) <= 0x3F)
        take = pending & ok
        d[take] = d_try[take]
        r[take] = r_try[take]
        shift[take] = sh
        pending &= ~ok
    assert not pending.any(), "B44 shift search failed (16-bit range!)"

    # exactMax: re-anchor the base so the block's max decodes exactly.
    t0 = t_max[:, 0] - (d[:, 0] << shift)

    b = np.zeros((nb, 14), np.int64)
    b[:, 0] = (t0 >> 8) & 0xFF
    b[:, 1] = t0 & 0xFF
    b[:, 2] = (shift << 2) | (r[:, 0] >> 4)
    b[:, 3] = (r[:, 0] << 4) | (r[:, 1] >> 2)
    b[:, 4] = (r[:, 1] << 6) | r[:, 2]
    b[:, 5] = (r[:, 3] << 2) | (r[:, 4] >> 4)
    b[:, 6] = (r[:, 4] << 4) | (r[:, 5] >> 2)
    b[:, 7] = (r[:, 5] << 6) | r[:, 6]
    b[:, 8] = (r[:, 7] << 2) | (r[:, 8] >> 4)
    b[:, 9] = (r[:, 8] << 4) | (r[:, 9] >> 2)
    b[:, 10] = (r[:, 9] << 6) | r[:, 10]
    b[:, 11] = (r[:, 11] << 2) | (r[:, 12] >> 4)
    b[:, 12] = (r[:, 12] << 4) | (r[:, 13] >> 2)
    b[:, 13] = (r[:, 13] << 6) | r[:, 14]
    b &= 0xFF

    is3 = np.zeros((nb,), bool)
    if flat3:
        is3 = (r == _BIAS).all(axis=1)       # flat block: every diff zero
    return b.astype(np.uint8), is3


def _unpack14(b: np.ndarray) -> np.ndarray:
    """(nb, 14) bytes -> (nb, 16) half bit patterns (row-major blocks)."""
    b = b.astype(np.int64)
    shift = b[:, 2] >> 2
    bias = _BIAS << shift
    r = np.zeros((b.shape[0], 15), np.int64)
    r[:, 0] = ((b[:, 2] << 4) | (b[:, 3] >> 4)) & 0x3F
    r[:, 1] = ((b[:, 3] << 2) | (b[:, 4] >> 6)) & 0x3F
    r[:, 2] = b[:, 4] & 0x3F
    r[:, 3] = (b[:, 5] >> 2) & 0x3F
    r[:, 4] = ((b[:, 5] << 4) | (b[:, 6] >> 4)) & 0x3F
    r[:, 5] = ((b[:, 6] << 2) | (b[:, 7] >> 6)) & 0x3F
    r[:, 6] = b[:, 7] & 0x3F
    r[:, 7] = (b[:, 8] >> 2) & 0x3F
    r[:, 8] = ((b[:, 8] << 4) | (b[:, 9] >> 4)) & 0x3F
    r[:, 9] = ((b[:, 9] << 2) | (b[:, 10] >> 6)) & 0x3F
    r[:, 10] = b[:, 10] & 0x3F
    r[:, 11] = (b[:, 11] >> 2) & 0x3F
    r[:, 12] = ((b[:, 11] << 4) | (b[:, 12] >> 4)) & 0x3F
    r[:, 13] = ((b[:, 12] << 2) | (b[:, 13] >> 6)) & 0x3F
    r[:, 14] = b[:, 13] & 0x3F

    t = np.zeros((b.shape[0], 16), np.int64)
    t[:, 0] = (b[:, 0] << 8) | b[:, 1]
    for k, (a, c) in enumerate(_CHAIN):
        t[:, c] = t[:, a] + (r[:, k] << shift) - bias
    return _from_monotonic(t)


def _block_layout(W: int, n_lines: int) -> "tuple[int, int]":
    return (n_lines + 3) // 4, (W + 3) // 4


def b44_compress(raw: bytes, chans, W: int, n_lines: int,
                 flat3: bool) -> bytes:
    """Compress one chunk. ``raw`` is scanline-interleaved channel rows in
    file (channel-list) order; HALF channels pack to 4x4 blocks (edge
    blocks replicate the last row/column, per spec), others copy raw."""
    ny, nx = _block_layout(W, n_lines)
    out = bytearray()
    for ci, (_cname, dt) in enumerate(chans):
        row_stride = sum(d.itemsize for _, d in chans) * W
        coff = sum(d.itemsize for _, d in chans[:ci]) * W
        if dt.itemsize != 2:
            for li in range(n_lines):
                o = li * row_stride + coff
                out += raw[o:o + W * dt.itemsize]
            continue
        rows = np.stack([np.frombuffer(raw, "<u2", W,
                                       li * row_stride + coff)
                         for li in range(n_lines)])
        padded = np.pad(rows, ((0, ny * 4 - n_lines), (0, nx * 4 - W)),
                        mode="edge")
        blocks = (padded.reshape(ny, 4, nx, 4).transpose(0, 2, 1, 3)
                  .reshape(ny * nx, 16))
        b14, is3 = _pack_blocks(blocks, flat3)
        if not is3.any():
            out += b14.tobytes()
        else:
            for i in range(ny * nx):
                if is3[i]:
                    out += bytes([int(b14[i, 0]), int(b14[i, 1]), 0xFC])
                else:
                    out += b14[i].tobytes()
    return bytes(out)


def b44_decompress(payload: bytes, chans, W: int, n_lines: int,
                   fixed14: bool = False) -> bytes:
    """Decompress one chunk back to scanline-interleaved channel rows.
    ``fixed14`` (B44, id 6): every block is 14 bytes — skips the
    sequential size scan that B44A's variable 3/14-byte blocks need."""
    ny, nx = _block_layout(W, n_lines)
    buf = np.frombuffer(payload, np.uint8)
    pos = 0
    planes = {}
    for cname, dt in chans:
        if dt.itemsize != 2:
            n = n_lines * W * dt.itemsize
            planes[cname] = buf[pos:pos + n].reshape(n_lines,
                                                     W * dt.itemsize)
            pos += n
            continue
        nb = ny * nx
        if fixed14:
            offs = pos + 14 * np.arange(nb, dtype=np.int64)
            sizes = np.full(nb, 14, np.int64)
            pos += 14 * nb
        else:
            # Block sizes: 14 bytes, or 3 when byte[2] == 0xfc (B44A flat).
            offs = np.empty(nb, np.int64)
            sizes = np.empty(nb, np.int64)
            p = pos
            for i in range(nb):
                offs[i] = p
                sizes[i] = 3 if buf[p + 2] == 0xFC else 14
                p += sizes[i]
            pos = p
        b14 = np.zeros((nb, 14), np.uint8)
        full = sizes == 14
        if full.any():
            b14[full] = buf[offs[full][:, None]
                            + np.arange(14)[None, :]]
        blocks = _unpack14(b14)
        if (~full).any():
            f = ~full
            base = ((buf[offs[f]].astype(np.uint32) << 8)
                    | buf[offs[f] + 1])
            blocks[f] = _from_monotonic(base)[:, None]
        padded = (blocks.reshape(ny, nx, 4, 4).transpose(0, 2, 1, 3)
                  .reshape(ny * 4, nx * 4))
        planes[cname] = padded[:n_lines, :W]
    out = bytearray()
    for li in range(n_lines):
        for cname, dt in chans:
            row = planes[cname][li]
            out += (row.astype("<u2").tobytes() if dt.itemsize == 2
                    else row.tobytes())
    return bytes(out)
