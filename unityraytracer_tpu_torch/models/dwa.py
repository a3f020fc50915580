"""DWAA/DWAB EXR codec (DreamWorks lossy DCT) — clean-room implementation.

Closes the last compression gap in the skybox loader (reference behavior:
the Unity importer accepts any OpenEXR compression for the Assets/Skyboxes
maps, RayTraceMaster.cs:761-792). Every format fact below was established
EMPIRICALLY against libOpenEXR (crafted-file probes through the
authoritative decoder + dissection of authoritative encoder output — see
tests/test_exr_oracle.py, which cross-validates both directions whenever
the system library is present):

Chunk layout (scanline block = 32 rows DWAA / 256 rows DWAB; EXR's
standard raw-fallback applies — a chunk at least as big as its raw data is
stored uncompressed and handled by the caller):

  11 x uint64: version(2), unknownUncompressedSize, unknownCompressedSize,
               acCompressedSize, dcCompressedSize, rleCompressedSize,
               rleUncompressedSize, rleRawSize, totalAcUncompressedCount,
               totalDcUncompressedCount, acCompression (0 = the PIZ
               Huffman coder [models/piz.py], 1 = deflate)
  channel rules: uint16 total size, then per rule: name NUL, one byte
               (cscSlot+1)<<4 | scheme<<2 (scheme 1 = lossy DCT,
               2 = RLE), one byte pixel-type code (1 = HALF)
  blobs, in order: unknown (zlib), AC (Huffman/deflate), DC (zlib over the
               EXR ZIP byte-deinterleave+delta filter), RLE (zlib over the
               EXR byte-RLE packer, NO predictor).

Lossy-DCT channels (probe-verified):
  * Channels named R,G,B with cscSlot 1,2,3 form a color set: encode is
    per-channel half -> toNonlinear -> float32 -> BT.709 forward CSC
    (R,G,B slots then carry Y, BY, RY) -> 8x8 DCT; decode mirrors it with
    csc709Inverse and the toLinear lookup on the final half bits.
  * toLinear (extracted by sweeping every half DC value through the real
    decoder; float32 formula reproduces all 63,488 reachable table entries
    bit-exactly): |x| <= 1 -> |x|^2.2, else exp(2.2(|x|-1)), sign
    preserved, non-finite and -0.0 inputs -> +0.0.
  * DC coefficients: one half per 8x8 block, CHANNEL-major within a set
    (all Y blocks row-major, then BY, then RY), delta+interleave filtered
    with the ZIP filter, zlib'd.
  * AC coefficients: BLOCK-major (per block: Y tokens, BY tokens, RY
    tokens), each block-channel a token stream in standard JPEG zigzag
    order starting at position 1: a plain half value fills the current
    position; 0xff00 zero-fills the rest of the block; 0xffNN (N > 0)
    skips N zero positions.
  * IDCT is the standard orthonormal 8x8 (DC gain 1/8, probe-verified).
RLE channels (e.g. "A"): per channel, the block's values split into
  per-byte planes (all low bytes, then all high bytes), EXR byte-RLE
  packed, concatenated, zlib'd.  Unknown channels (no matching rule):
  planar raw data per channel, zlib'd.

Lossy parity bar: our decoder matches libOpenEXR's output on its own
files to <= 1 half-ulp (the only looseness is float op order inside the
IDCT/CSC pipeline; the nonlinear LUTs and integer plumbing are exact).
Our encoder quantizes nothing (coefficients kept exactly as halfs), so it
trades file size for maximum fidelity — spec-valid, real-decoder-readable.
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

_EOB = 0xFF00


# ---------------------------------------------------------------------------
# Nonlinear transfer LUTs (see module docstring for provenance).

def _build_luts():
    i = np.arange(65536, dtype=np.uint16)
    v = i.view(np.float16).astype(np.float32)
    a = np.abs(v)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        lin = np.where(a <= 1.0, np.power(a, np.float32(2.2)),
                       np.exp(np.float32(2.2) * (a - 1.0), dtype=np.float32))
        lin = np.copysign(lin, v)
        to_linear = lin.astype(np.float16).view(np.uint16).copy()
        nl = np.where(a <= 1.0, np.power(a, np.float32(1.0 / 2.2)),
                      1.0 + np.log(a, dtype=np.float32) / np.float32(2.2))
        nl = np.copysign(nl, v)
        to_nonlinear = nl.astype(np.float16).view(np.uint16).copy()
    bad = ~np.isfinite(v) | (i == 0x8000)
    to_linear[bad] = 0
    to_nonlinear[bad] = 0
    return to_linear, to_nonlinear


_TO_LINEAR, _TO_NONLINEAR = _build_luts()


# ---------------------------------------------------------------------------
# Zigzag + DCT.

def _zigzag():
    """Standard JPEG order: zig index -> flat row-major (8*r + c) index."""
    out = []
    for d in range(15):
        rows = range(max(0, d - 7), min(d, 7) + 1)
        if d % 2 == 0:                        # even diagonals start bottom
            rows = reversed(rows)
        out.extend(8 * r + (d - r) for r in rows)
    return np.asarray(out, np.int64)


_ZIG = _zigzag()
assert _ZIG[0] == 0 and _ZIG[1] == 1 and _ZIG[2] == 8 and _ZIG[5] == 2 \
    and _ZIG[6] == 3 and _ZIG[14] == 4 and _ZIG[27] == 6 and _ZIG[28] == 7

_IDCT_M = np.asarray(
    [[(np.sqrt(0.125) if u == 0 else 0.5)
      * np.cos((2 * y + 1) * u * np.pi / 16.0)
      for u in range(8)] for y in range(8)], np.float32)


def _idct8x8(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) float32 coefficient blocks -> pixels (orthonormal)."""
    return np.einsum("yu,nuv,xv->nyx", _IDCT_M, blocks, _IDCT_M,
                     dtype=np.float32).astype(np.float32)


def _dct8x8(blocks: np.ndarray) -> np.ndarray:
    return np.einsum("yu,nyx,xv->nuv", _IDCT_M, blocks, _IDCT_M,
                     dtype=np.float32).astype(np.float32)


# ---------------------------------------------------------------------------
# BT.709 color-space conversion (coefficients probe-verified to half
# precision against the authoritative encoder/decoder).

def _csc_forward(r, g, b):
    y = (np.float32(0.2126) * r + np.float32(0.7152) * g
         + np.float32(0.0722) * b)
    by = (np.float32(-0.1146) * r + np.float32(-0.3854) * g
          + np.float32(0.5) * b)
    ry = (np.float32(0.5) * r + np.float32(-0.4542) * g
          + np.float32(-0.0458) * b)
    return y, by, ry


def _csc_inverse(y, by, ry):
    r = y + np.float32(1.5747) * ry
    g = y - np.float32(0.1873) * by - np.float32(0.4682) * ry
    b = y + np.float32(1.8556) * by
    return r, g, b


# ---------------------------------------------------------------------------
# EXR byte-RLE (PackBits flavor shared with the RLE compression type, but
# WITHOUT the ZIP predictor — DWA applies it to raw byte planes).

def _packbits(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out.append(run - 1)
            out.append(data[i])
            i += run
        else:
            lit = i
            while i < n and i - lit < 127 \
                    and not (i + 2 < n and data[i] == data[i + 1]
                             and data[i] == data[i + 2]):
                i += 1
            out.append(256 - (i - lit))
            out += data[lit:i]
    return bytes(out)


def _unpackbits(src: bytes, out_len: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < out_len:
        c = src[i]
        i += 1
        if c > 127:
            cnt = 256 - c
            out += src[i:i + cnt]
            i += cnt
        else:
            out += src[i:i + 1] * (c + 1)
            i += 1
    return bytes(out)


def _planes_split(raw: np.ndarray) -> bytes:
    """uint8 view (N, itemsize) -> plane-concatenated bytes."""
    return b"".join(raw[:, k].tobytes() for k in range(raw.shape[1]))


def _planes_join(data: bytes, count: int, itemsize: int) -> bytes:
    arr = np.frombuffer(data, np.uint8).reshape(itemsize, count)
    return np.ascontiguousarray(arr.T).tobytes()


# ---------------------------------------------------------------------------
# Channel classification.

_SCHEME_UNKNOWN, _SCHEME_DCT, _SCHEME_RLE = 0, 1, 2


def _pixel_type(dt: np.dtype) -> int:
    """EXR pixel type enum: UINT = 0, HALF = 1, FLOAT = 2."""
    if dt.kind == "u":
        return 0
    return 1 if dt.itemsize == 2 else 2


def _parse_rules(blob: bytes):
    rules = []
    p = 0
    while p < len(blob):
        e = blob.index(b"\x00", p)
        name = blob[p:e].decode("latin-1")
        val, ptype = blob[e + 1], blob[e + 2]
        rules.append((name, (val >> 2) & 3, (val >> 4) & 0xF, ptype))
        p = e + 3
    return rules


def _classify(chans, rules):
    """Per channel: (scheme, csc_slot). Rule names match the channel name
    or its suffix after the last '.' (layered channels), same pixel type."""
    out = []
    for name, dt in chans:
        suffix = name.rsplit(".", 1)[-1]
        ptype = _pixel_type(dt)
        hit = (_SCHEME_UNKNOWN, 0)
        for rname, scheme, csc, rtype in rules:
            if rtype == ptype and (name == rname or suffix == rname):
                hit = (scheme, csc)
                break
        out.append(hit)
    return out


def _dct_groups(chans, cls):
    """Group DCT channels into CSC triples (csc slots 1,2,3 sharing a layer
    prefix) and solo channels, ordered by first-member file position.
    Returns [(kind, [channel indices in slot order])]."""
    triples = {}
    groups = []
    for i, ((name, _), (scheme, csc)) in enumerate(zip(chans, cls)):
        if scheme != _SCHEME_DCT:
            continue
        if csc in (1, 2, 3):
            prefix = name.rsplit(".", 1)[0] if "." in name else ""
            slots = triples.setdefault(prefix, [None, None, None])
            slots[csc - 1] = i
        else:
            groups.append(("solo", [i]))
    for prefix, slots in triples.items():
        if all(s is not None for s in slots):
            groups.append(("csc", slots))
        else:
            groups.extend(("solo", [s]) for s in slots if s is not None)
    groups.sort(key=lambda g: min(g[1]))
    return groups


# ---------------------------------------------------------------------------
# Decode.

def dwa_decompress(payload: bytes, chans, w: int, n_lines: int) -> bytes:
    """One DWA chunk -> raw scanline-interleaved channel bytes."""
    from .piz import huf_decompress

    (_ver, unk_unc, unk_comp, ac_comp, dc_comp, rle_comp, rle_unc,
     rle_raw, ac_cnt, dc_cnt, ac_compression) = struct.unpack_from(
         "<11Q", payload, 0)
    p = 88
    rule_size = struct.unpack_from("<H", payload, p)[0]
    rules = _parse_rules(payload[p + 2:p + rule_size])
    p += rule_size
    unk = payload[p:p + unk_comp]
    p += unk_comp
    ac_blob = payload[p:p + ac_comp]
    p += ac_comp
    dc_blob = payload[p:p + dc_comp]
    p += dc_comp
    rle_blob = payload[p:p + rle_comp]

    if ac_cnt:
        if ac_compression == 0:
            toks = np.asarray(huf_decompress(ac_blob, int(ac_cnt)),
                              np.uint16)
        else:
            toks = np.frombuffer(zlib.decompress(ac_blob), "<u2",
                                 count=int(ac_cnt))
    else:
        toks = np.zeros(0, np.uint16)
    if dc_cnt:
        from .exr import _unpredict_deinterleave
        dcs = np.frombuffer(
            _unpredict_deinterleave(zlib.decompress(dc_blob)), "<u2",
            count=int(dc_cnt))
    else:
        dcs = np.zeros(0, np.uint16)
    rle_bytes = _unpackbits(zlib.decompress(rle_blob), int(rle_raw)) \
        if rle_comp else b""
    unk_bytes = zlib.decompress(unk) if unk_comp else b""

    cls = _classify(chans, rules)
    bx, by = (w + 7) // 8, (n_lines + 7) // 8
    nblocks = bx * by

    planes = {}
    dc_pos = 0
    cursor = 0
    for kind, idxs in _dct_groups(chans, cls):
        ncomp = len(idxs)
        zig = np.zeros((nblocks, ncomp, 64), np.uint16)
        for k in range(ncomp):                        # DC: channel-major
            zig[:, k, 0] = dcs[dc_pos:dc_pos + nblocks]
            dc_pos += nblocks
        for b in range(nblocks):                      # AC: block-major
            for k in range(ncomp):
                cursor = _un_rle_ac(toks, cursor, zig[b, k])
        coef = np.zeros((nblocks * ncomp, 64), np.float32)
        coef[:, _ZIG] = zig.reshape(-1, 64).view(np.float16).astype(
            np.float32)
        pix = _idct8x8(coef.reshape(-1, 8, 8)).reshape(nblocks, ncomp, 8, 8)
        comps = [pix[:, k] for k in range(ncomp)]
        if kind == "csc":
            comps = list(_csc_inverse(*comps))
        for k, ci in enumerate(idxs):
            blk = comps[k].reshape(by, bx, 8, 8)
            img = blk.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
            half_bits = img[:n_lines, :w].astype(np.float16).view(np.uint16)
            out_half = _TO_LINEAR[half_bits]
            name, dt = chans[ci]
            if dt.itemsize == 2:
                planes[name] = out_half.view("<u2")
            else:                    # float DCT channel: widen after LUT
                planes[name] = out_half.view(np.float16).astype(
                    "<f4").view("<u4")

    rle_pos = 0
    unk_pos = 0
    for (name, dt), (scheme, _csc) in zip(chans, cls):
        if name in planes:
            continue
        count = n_lines * w
        size = dt.itemsize
        if scheme == _SCHEME_RLE:
            seg = rle_bytes[rle_pos:rle_pos + count * size]
            rle_pos += count * size
            vals = np.frombuffer(_planes_join(seg, count, size), np.uint8)
            planes[name] = vals.view(f"<u{size}").reshape(n_lines, w)
        else:
            seg = unk_bytes[unk_pos:unk_pos + count * size]
            unk_pos += count * size
            planes[name] = np.frombuffer(seg, f"<u{size}").reshape(
                n_lines, w)

    out = bytearray()
    for li in range(n_lines):
        for name, dt in chans:
            out += np.ascontiguousarray(
                planes[name].reshape(n_lines, w)[li]).tobytes()
    return bytes(out)


def _un_rle_ac(toks: np.ndarray, cursor: int, zig: np.ndarray) -> int:
    """Consume one block-channel's AC token stream into zig[1:64]."""
    pos = 1
    n = len(toks)
    while pos < 64 and cursor < n:
        t = int(toks[cursor])
        cursor += 1
        if t == _EOB:
            break
        if (t >> 8) == 0xFF:
            pos += t & 0xFF
        else:
            zig[pos] = t
            pos += 1
    return cursor


# ---------------------------------------------------------------------------
# Encode.

def dwa_compress(raw: bytes, chans, w: int, n_lines: int,
                 dwab: bool = False) -> bytes:
    """Raw scanline-interleaved channel bytes -> one DWA chunk payload.

    R,G,B half channels become the lossy-DCT color set; every other half
    channel goes through the lossless RLE scheme; non-half channels land in
    the unknown blob (zlib, planar). No coefficient quantization — encode
    error is the half rounding + nonlinear curve alone.
    """
    from .piz import huf_compress
    from .exr import _interleave_predict

    # De-interleave raw scanlines into per-channel planes.
    planes = {}
    pos = 0
    for li in range(n_lines):
        for name, dt in chans:
            arr = planes.setdefault(
                name, np.zeros((n_lines, w), f"<u{dt.itemsize}"))
            arr[li] = np.frombuffer(raw, f"<u{dt.itemsize}", count=w,
                                    offset=pos)
            pos += w * dt.itemsize

    names = {n for n, _ in chans}
    half = {n for n, dt in chans if dt.itemsize == 2}
    csc_set = [n for n in ("R", "G", "B") if n in half]
    use_csc = len(csc_set) == 3

    rules = b""
    dct_names: List[str] = csc_set if use_csc else []
    for k, n in enumerate(dct_names):
        rules += n.encode() + b"\x00" + bytes([((k + 1) << 4) | 4, 1])
    rle_names = [n for n, dt in chans
                 if dt.itemsize == 2 and n not in dct_names]
    for n in rle_names:
        rules += n.encode() + b"\x00" + bytes([8, 1])
    unk_names = [n for n, dt in chans
                 if n not in dct_names and n not in rle_names]
    rules = struct.pack("<H", len(rules) + 2) + rules

    bx, by = (w + 7) // 8, (n_lines + 7) // 8
    nblocks = bx * by

    ac_tokens: List[int] = []
    dc_vals: List[int] = []
    if dct_names:
        comps = []
        for n in dct_names:
            nl = _TO_NONLINEAR[planes[n].reshape(-1)].view(
                np.float16).astype(np.float32).reshape(n_lines, w)
            # Edge-replicate to the 8x8 block grid (keeps the DCT smooth).
            img = np.pad(nl, ((0, by * 8 - n_lines), (0, bx * 8 - w)),
                         mode="edge")
            comps.append(img)
        if use_csc:
            comps = list(_csc_forward(*comps))
        blocks = [c.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
                  .reshape(nblocks, 8, 8) for c in comps]
        coef = [_dct8x8(b).reshape(nblocks, 64)[:, _ZIG].astype(np.float16)
                .view(np.uint16) for b in blocks]
        for c in coef:                                 # DC channel-major
            dc_vals.extend(int(v) for v in c[:, 0])
        for b in range(nblocks):                       # AC block-major
            for c in coef:
                _rle_ac(c[b], ac_tokens)

    rle_stream = b""
    for n in rle_names:
        vals = planes[n].reshape(-1, 1).view(np.uint8)
        rle_stream += _planes_split(vals.reshape(-1, 2))
    unk_stream = b"".join(planes[n].tobytes() for n in unk_names)

    ac_blob = huf_compress(np.asarray(ac_tokens, np.uint16)) \
        if ac_tokens else b""
    dc_blob = zlib.compress(_interleave_predict(
        np.asarray(dc_vals, "<u2").tobytes())) if dc_vals else b""
    rle_packed = _packbits(rle_stream)
    rle_blob = zlib.compress(rle_packed) if rle_stream else b""
    unk_blob = zlib.compress(unk_stream) if unk_stream else b""

    head = struct.pack(
        "<11Q", 2, len(unk_stream), len(unk_blob), len(ac_blob),
        len(dc_blob), len(rle_blob), len(rle_packed), len(rle_stream),
        len(ac_tokens), len(dc_vals), 0)
    return head + rules + unk_blob + ac_blob + dc_blob + rle_blob


def _rle_ac(zig_row: np.ndarray, out: List[int]) -> None:
    """Emit one block-channel's AC tokens (positions 1..63)."""
    nz = np.nonzero(zig_row[1:])[0] + 1
    pos = 1
    for i in nz:
        gap = int(i) - pos
        while gap > 0:
            step = min(gap, 0xFF)
            out.append(0xFF00 | step)
            gap -= step
        out.append(int(zig_row[i]))
        pos = int(i) + 1
    if pos < 64:
        out.append(_EOB)
