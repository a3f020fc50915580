"""Minimal OpenEXR (v2) reader and writer (numpy + zlib).

The port's copy of the JAX package's ``models/exr.py``: scanline and tiled
files (ONE_LEVEL / MIPMAP / RIPMAP on read, the full-resolution level
returned; ONE_LEVEL / MIPMAP on write), single- and multi-part, HALF /
FLOAT / UINT channels, with the compressions this module codes itself:
NONE, RLE, ZIPS, ZIP and PXR24 (byte-planed deltas + deflate; lossless for
HALF and UINT, FLOAT rounded to 24 bits by the writer as the spec says).
Its writers give byte for byte the files the JAX package's writers give for
the same arrays and arguments.

PIZ, B44 / B44A and DWAA / DWAB live in their own codec modules in the JAX
package (``piz.py``, ``b44.py``, ``dwa.py``), which the port does not have
yet (ROADMAP queue 1, item 2): reading or writing them raises
``NotImplementedError``, never another compression in their place.

Implemented from the OpenEXR file-layout specification. ``save_aovs``
(``render.PreviewExportMixin``) writes its multi-part AOV file with
``write_exr_multipart``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 20000630
_COMPRESSION_NONE = 0
_COMPRESSION_RLE = 1
_COMPRESSION_ZIPS = 2   # 1 scanline per chunk
_COMPRESSION_ZIP = 3    # 16 scanlines per chunk
_COMPRESSION_PIZ = 4
_COMPRESSION_PXR24 = 5
_COMPRESSION_B44 = 6
_COMPRESSION_B44A = 7
_COMPRESSION_DWAA = 8
_COMPRESSION_DWAB = 9
_COMPRESSIONS = {"none": _COMPRESSION_NONE, "rle": _COMPRESSION_RLE,
                 "zips": _COMPRESSION_ZIPS, "zip": _COMPRESSION_ZIP,
                 "piz": _COMPRESSION_PIZ, "pxr24": _COMPRESSION_PXR24,
                 "b44": _COMPRESSION_B44, "b44a": _COMPRESSION_B44A,
                 "dwaa": _COMPRESSION_DWAA, "dwab": _COMPRESSION_DWAB}
_LINES_PER_CHUNK = {_COMPRESSION_NONE: 1, _COMPRESSION_RLE: 1,
                    _COMPRESSION_ZIPS: 1, _COMPRESSION_ZIP: 16,
                    _COMPRESSION_PIZ: 32, _COMPRESSION_PXR24: 16,
                    _COMPRESSION_B44: 32, _COMPRESSION_B44A: 32,
                    _COMPRESSION_DWAA: 32, _COMPRESSION_DWAB: 256}
# The codecs of the JAX package's own modules, not ported yet.
_UNPORTED = {_COMPRESSION_PIZ: ("PIZ", "piz.py"),
             _COMPRESSION_B44: ("B44", "b44.py"),
             _COMPRESSION_B44A: ("B44A", "b44.py"),
             _COMPRESSION_DWAA: ("DWAA", "dwa.py"),
             _COMPRESSION_DWAB: ("DWAB", "dwa.py")}
_PIXEL_DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_PIXEL_TYPES = {np.dtype("<u4"): 0, np.dtype("<f2"): 1, np.dtype("<f4"): 2}


def _unported(comp: int) -> NotImplementedError:
    name, module = _UNPORTED[comp]
    return NotImplementedError(
        f"EXR {name} compression needs the codec module models/{module}, "
        "which the port does not have yet (ROADMAP queue 1, item 2); use "
        "none, rle, zips, zip or pxr24")


def _read_cstr(data: bytes, pos: int) -> Tuple[bytes, int]:
    end = data.index(b"\x00", pos)
    return data[pos:end], end + 1


def _unpredict_deinterleave(raw: bytes) -> bytes:
    """Undo EXR's ZIP post-deflate filter: delta-decode, then restore the
    even/odd byte split (spec: 'reorder the pixel data' + 'predictor')."""
    d = np.frombuffer(raw, np.uint8).astype(np.int64)
    # Delta decode: first byte verbatim, then out[i] = out[i-1] + d[i] - 128.
    arr = (d[0] + np.concatenate([[0], np.cumsum(d[1:] - 128)])
           ).astype(np.uint8)
    out = np.empty_like(arr)
    half = (len(arr) + 1) // 2
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out.tobytes()


def _interleave_predict(raw: bytes) -> bytes:
    """EXR ZIP pre-deflate filter (inverse of :func:`_unpredict_deinterleave`)."""
    arr = np.frombuffer(raw, np.uint8)
    half = (len(arr) + 1) // 2
    inter = np.empty_like(arr)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    d = inter.astype(np.int32)
    out = np.empty_like(d)
    out[0] = d[0]
    out[1:] = d[1:] - d[:-1] + 128
    return (out & 0xFF).astype(np.uint8).tobytes()


def _rle_decompress(payload: bytes) -> bytes:
    """EXR byte RLE: signed count < 0 -> -count literal bytes, else count+1
    copies of the next byte; then the same post-filters as ZIP."""
    out = bytearray()
    i = 0
    n = len(payload)
    while i < n:
        c = payload[i]
        i += 1
        if c > 127:                       # signed char < 0: literal run
            cnt = 256 - c
            out += payload[i:i + cnt]
            i += cnt
        else:
            out += payload[i:i + 1] * (c + 1)
            i += 1
    return _unpredict_deinterleave(bytes(out))


def _rle_compress(raw: bytes) -> bytes:
    data = _interleave_predict(raw)
    out = bytearray()
    i = 0
    n = len(data)
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


def _float_to_float24(u: np.ndarray) -> np.ndarray:
    """Round f32 bit patterns to PXR24's 24-bit float (sign, 8-bit exponent,
    15-bit significand), matching OpenEXR's ``floatToFloat24``: round the
    significand to nearest (ties away), truncate instead on exponent
    overflow, preserve inf/NaN (a NaN whose top 15 significand bits vanish
    keeps one bit so it doesn't become an infinity)."""
    u = u.astype(np.uint32)
    s = u & np.uint32(0x80000000)
    e = u & np.uint32(0x7F800000)
    m = u & np.uint32(0x007FFFFF)
    i = ((e | m) + (m & np.uint32(0x80))) >> np.uint32(8)
    i = np.where(i >= 0x7F8000, (e | m) >> np.uint32(8), i)
    mn = m >> np.uint32(8)
    special = np.where(m != 0, (e >> np.uint32(8)) | mn
                       | (mn == 0).astype(np.uint32), e >> np.uint32(8))
    i = np.where(e == 0x7F800000, special, i)
    return (s >> np.uint32(8)) | i


def _pxr24_decompress(payload: bytes, chans, W: int, n_lines: int) -> bytes:
    """PXR24 chunk decode: deflate, then per scanline x channel undo the
    byte-plane split (high byte first) and the horizontal delta (running sum
    from 0, modulo the channel's bit width). FLOAT channels store the top 24
    bits of the f32 pattern; the dropped low byte is returned as zero."""
    tmp = zlib.decompress(payload)
    out = []
    pos = 0
    for _li in range(n_lines):
        for _cname, dt in chans:
            nb = 3 if dt == np.dtype("<f4") else dt.itemsize
            p = np.frombuffer(tmp, np.uint8, nb * W, pos) \
                .reshape(nb, W).astype(np.uint64)
            pos += nb * W
            diff = np.zeros(W, np.uint64)
            for b in range(nb):
                diff = (diff << np.uint64(8)) | p[b]
            pix = np.cumsum(diff) & np.uint64((1 << (8 * nb)) - 1)
            if dt == np.dtype("<f4"):
                out.append((pix.astype(np.uint32) << np.uint32(8))
                           .astype("<u4").tobytes())
            elif dt.itemsize == 2:
                out.append(pix.astype("<u2").tobytes())
            else:
                out.append(pix.astype("<u4").tobytes())
    return b"".join(out)


def _pxr24_compress(raw: bytes, chans, W: int, n_lines: int) -> bytes:
    """PXR24 chunk encode (inverse of :func:`_pxr24_decompress`); lossy only
    for FLOAT channels (rounded to 24-bit via :func:`_float_to_float24`)."""
    tmp = []
    pos = 0
    for _li in range(n_lines):
        for _cname, dt in chans:
            vals = np.frombuffer(raw, dt, count=W, offset=pos)
            pos += W * dt.itemsize
            if dt == np.dtype("<f4"):
                pix, nb = _float_to_float24(vals.view("<u4")), 3
            elif dt.itemsize == 2:
                pix, nb = vals.view("<u2").astype(np.uint32), 2
            else:
                pix, nb = vals.view("<u4"), 4
            pix = pix.astype(np.uint64)
            diff = (pix - np.concatenate([[np.uint64(0)], pix[:-1]])) \
                & np.uint64((1 << (8 * nb)) - 1)
            for b in range(nb - 1, -1, -1):
                tmp.append(((diff >> np.uint64(8 * b)) & np.uint64(0xFF))
                           .astype(np.uint8).tobytes())
    return zlib.compress(b"".join(tmp))


def _decode_chunk(comp: int, payload: bytes, chans, w: int,
                  n_lines: int) -> bytes:
    """Decompress one chunk (scanline block or tile) of ``n_lines`` rows of
    ``w`` pixels to raw scanline-interleaved channel rows."""
    if comp in (_COMPRESSION_ZIPS, _COMPRESSION_ZIP):
        return _unpredict_deinterleave(zlib.decompress(payload))
    if comp == _COMPRESSION_RLE:
        return _rle_decompress(payload)
    if comp == _COMPRESSION_PXR24:
        return _pxr24_decompress(payload, chans, w, n_lines)
    if comp in _UNPORTED:
        raise _unported(comp)
    return payload                                     # NONE


def _fill_lines(planes, chans, payload: bytes, row0: int, col0: int,
                w: int, n_lines: int) -> None:
    lpos = 0
    for li in range(n_lines):
        for cname, dt in chans:
            vals = np.frombuffer(payload, dt, count=w, offset=lpos)
            planes[cname][row0 + li, col0:col0 + w] = vals.astype(np.float32)
            lpos += w * dt.itemsize


def _level_size(n: int, level: int, round_up: bool) -> int:
    d = 1 << level
    return max(1, (n + d - 1) // d if round_up else n // d)


def _n_levels(w: int, h: int, level_mode: int, round_up: bool) -> tuple:
    """Level grid (nx, ny) for ONE_LEVEL (0) / MIPMAP (1) / RIPMAP (2)."""
    def levels(n):
        lv = 1
        while _level_size(n, lv - 1, round_up) > 1:
            lv += 1
        return lv
    if level_mode == 0:
        return 1, 1
    if level_mode == 1:
        lv = levels(max(w, h))
        return lv, lv
    return levels(w), levels(h)


def _tile_level_table(W, H, xs, ys, level_mode, round_up):
    """[(lx, ly, lw, lh, ntx, nty), ...] in file (offset-table) order."""
    nx, ny = _n_levels(W, H, level_mode, round_up)
    if level_mode == 1:                                # mipmap: lx == ly
        pairs = [(lv, lv) for lv in range(nx)]
    elif level_mode == 2:                              # ripmap: y-major
        pairs = [(lx, ly) for ly in range(ny) for lx in range(nx)]
    else:
        pairs = [(0, 0)]
    out = []
    for lx, ly in pairs:
        lw = _level_size(W, lx, round_up)
        lh = _level_size(H, ly, round_up)
        out.append((lx, ly, lw, lh,
                    (lw + xs - 1) // xs, (lh + ys - 1) // ys))
    return out


def _read_header(data: bytes, pos: int):
    """Parse one attribute block (terminated by an empty name)."""
    attrs: Dict[str, Tuple[bytes, bytes]] = {}
    while True:
        name, pos = _read_cstr(data, pos)
        if name == b"":
            break
        atype, pos = _read_cstr(data, pos)
        size = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        attrs[name.decode()] = (atype, data[pos:pos + size])
        pos += size
    return attrs, pos


def _validated_comp(attrs) -> int:
    comp = attrs["compression"][1][0]
    if comp not in _LINES_PER_CHUNK:
        raise ValueError(f"unsupported EXR compression {comp}; re-export "
                         "with ZIP (every HDRI tool can)")
    return comp


def _parse_channels(attrs) -> List[Tuple[str, np.dtype]]:
    """Channel list: sorted by name in the file; each scanline stores
    channels in that order."""
    chans: List[Tuple[str, np.dtype]] = []
    cdata = attrs["channels"][1]
    cpos = 0
    while cdata[cpos] != 0:
        cname, cpos = _read_cstr(cdata, cpos)
        ptype, _plin, _xs, _ys = struct.unpack_from("<iiii", cdata, cpos)
        cpos += 16
        chans.append((cname.decode(), _PIXEL_DTYPES[ptype]))
    chans.sort(key=lambda c: c[0])
    return chans


def _part_chunk_count(attrs) -> int:
    """Chunk count for a header: the required chunkCount attribute in
    multi-part files, else derived from compression/tiling + dataWindow."""
    if "chunkCount" in attrs:
        return struct.unpack("<i", attrs["chunkCount"][1][:4])[0]
    xmin, ymin, xmax, ymax = struct.unpack("<iiii", attrs["dataWindow"][1])
    W, H = xmax - xmin + 1, ymax - ymin + 1
    if "tiles" in attrs:
        xs, ys, mode = struct.unpack("<IIB", attrs["tiles"][1])
        table = _tile_level_table(W, H, xs, ys, mode & 0xF, bool(mode >> 4))
        return sum(ntx * nty for _, _, _, _, ntx, nty in table)
    lines_per = _LINES_PER_CHUNK[_validated_comp(attrs)]
    return (H + lines_per - 1) // lines_per


def _decode_part(data: bytes, attrs, offsets, tiled: bool,
                 hdr_bytes: int) -> np.ndarray:
    """Decode one image part from its chunk offsets. ``hdr_bytes`` is the
    per-chunk prefix before the standard chunk fields (4 in multi-part
    files: the part-number int; 0 otherwise)."""
    comp = _validated_comp(attrs)
    xmin, ymin, xmax, ymax = struct.unpack("<iiii", attrs["dataWindow"][1])
    W, H = xmax - xmin + 1, ymax - ymin + 1
    chans = _parse_channels(attrs)
    planes = {name: np.zeros((H, W), np.float32) for name, _ in chans}
    bpp = sum(dt.itemsize for _, dt in chans)

    if tiled:
        # tiledesc: xSize, ySize (u32) + mode byte (level mode | rounding<<4).
        xs, ys, _mode = struct.unpack("<IIB", attrs["tiles"][1])
        for off in offsets:
            off += hdr_bytes
            dx, dy, lx, ly, size = struct.unpack_from("<iiiii", data, off)
            if lx or ly:                # mip/rip levels beyond full-res
                continue
            payload = data[off + 20:off + 20 + size]
            tw = min(xs, W - dx * xs)
            th = min(ys, H - dy * ys)
            if size < th * tw * bpp:    # stored raw only if not smaller
                payload = _decode_chunk(comp, payload, chans, tw, th)
            _fill_lines(planes, chans, payload, dy * ys, dx * xs, tw, th)
    else:
        lines_per = _LINES_PER_CHUNK[comp]
        for off in offsets:
            off += hdr_bytes
            y, size = struct.unpack_from("<ii", data, off)
            payload = data[off + 8:off + 8 + size]
            row0 = y - ymin
            n_lines = min(lines_per, H - row0)
            if size < n_lines * bpp * W:      # stored only if smaller
                payload = _decode_chunk(comp, payload, chans, W, n_lines)
            _fill_lines(planes, chans, payload, row0, 0, W, n_lines)

    order = [n for n in ("R", "G", "B", "A") if n in planes]
    order += [n for n, _ in chans if n not in order]
    return np.stack([planes[n] for n in order], axis=-1)


def load_exr(path: str, part=0) -> np.ndarray:
    """Read an EXR image into (H, W, C) float32 — scanline or tiled
    (ONE_LEVEL / MIPMAP / RIPMAP, returning the full-resolution level),
    single- or multi-part (``part`` selects by index or part name;
    deep-data parts are rejected).

    Channels are returned in R, G, B(, A) order when those names exist,
    otherwise in alphabetical (file) order. PIZ, B44(A) and DWAA/DWAB
    chunks raise ``NotImplementedError`` (their codecs are not ported).
    """
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    multi = bool(version & 0x1000)
    if (version & 0x800) and not multi:
        raise ValueError("deep-data EXR not supported")

    pos = 8
    headers = []
    if multi:
        while data[pos] != 0:       # header sequence + extra terminator
            attrs, pos = _read_header(data, pos)
            headers.append(attrs)
        pos += 1
    else:
        attrs, pos = _read_header(data, pos)
        headers.append(attrs)

    if isinstance(part, str):
        names = [a.get("name", (b"", b""))[1].split(b"\x00")[0].decode()
                 for a in headers]
        if part not in names:
            raise ValueError(f"no part named {part!r}; parts: {names}")
        sel = names.index(part)
    else:
        sel = part
    attrs = headers[sel]
    ptype = attrs.get("type", (b"", b"scanlineimage"))[1].split(b"\x00")[0]
    if ptype not in (b"scanlineimage", b"tiledimage"):
        raise ValueError(f"EXR part type {ptype.decode()!r} not supported")

    # Offset tables follow the header block, one per part, in order.
    tables = []
    for a in headers:
        n = _part_chunk_count(a)
        tables.append(struct.unpack_from(f"<{n}q", data, pos))
        pos += 8 * n

    tiled = (ptype == b"tiledimage") if multi else bool(version & 0x200)
    return _decode_part(data, attrs, tables[sel], tiled,
                        hdr_bytes=4 if multi else 0)


def _encode_chunk(comp: int, block: np.ndarray, order, names, dt) -> bytes:
    """Encode one (n_lines, w, C) block to a chunk payload (raw fallback
    per spec: keep the uncompressed bytes when compression doesn't win)."""
    n_lines, w = block.shape[:2]
    raw = b"".join(np.ascontiguousarray(block[li, :, i].astype(dt)).tobytes()
                   for li in range(n_lines) for i in order)
    if comp in (_COMPRESSION_ZIPS, _COMPRESSION_ZIP):
        packed = zlib.compress(_interleave_predict(raw))
    elif comp == _COMPRESSION_RLE:
        packed = _rle_compress(raw)
    elif comp == _COMPRESSION_PXR24:
        packed = _pxr24_compress(raw, [(names[i], dt) for i in order],
                                 w, n_lines)
    else:                   # NONE (the writers refuse the unported codecs)
        packed = raw
    return raw if len(packed) >= len(raw) else packed


def _attr(name: str, atype: str, payload: bytes) -> bytes:
    return (name.encode() + b"\x00" + atype.encode() + b"\x00"
            + struct.pack("<i", len(payload)) + payload)


def _image_layout(img: np.ndarray, compression: str, dtype: str):
    """(H, W, C) view, channel names RGBA by position, the file's channel
    order (sorted by name), pixel dtype and compression code."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    C = 1 if img.ndim == 2 else img.shape[2]
    names = ["R", "G", "B", "A"][:C]
    dt = np.dtype("<f2") if dtype == "half" else np.dtype("<f4")
    comp = _COMPRESSIONS[compression]
    if comp in _UNPORTED:
        raise _unported(comp)
    return (img.reshape(H, W, C), names,
            sorted(range(C), key=lambda i: names[i]), dt, comp)


def _header_attrs(img, names, order, dt, comp, part_attrs=b"",
                  tail_attrs=b"") -> bytes:
    """One header's attributes in the writers' order, with its terminator:
    ``part_attrs`` (multi-part name/type/chunkCount) after lineOrder,
    ``tail_attrs`` (tiles) at the end."""
    H, W = img.shape[:2]
    chl = b"".join(names[i].encode() + b"\x00"
                   + struct.pack("<iiii", _PIXEL_TYPES[dt], 0, 1, 1)
                   for i in order) + b"\x00"
    box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    return (_attr("channels", "chlist", chl)
            + _attr("compression", "compression", bytes([comp]))
            + _attr("dataWindow", "box2i", box)
            + _attr("displayWindow", "box2i", box)
            + _attr("lineOrder", "lineOrder", b"\x00")
            + part_attrs
            + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
            + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
            + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
            + tail_attrs
            + b"\x00")


def _scanline_chunks(img, names, order, dt, comp):
    """[(first row, payload), ...] of a scanline part."""
    H = img.shape[0]
    lines_per = _LINES_PER_CHUNK[comp]
    return [(row0, _encode_chunk(comp, img[row0:row0 + lines_per], order,
                                 names, dt))
            for row0 in range(0, H, lines_per)]


def _write(path: str, header: bytes, chunks) -> str:
    """Header, offset table, then the chunks (each ``(prefix, payload)``:
    the chunk's coordinate ints, then its size and bytes)."""
    n_chunks = len(chunks)
    pos = len(header) + 8 * n_chunks
    offsets, body = [], []
    for prefix, packed in chunks:
        offsets.append(pos)
        rec = prefix + struct.pack("<i", len(packed)) + packed
        body.append(rec)
        pos += len(rec)
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{n_chunks}q", *offsets))
        f.write(b"".join(body))
    return path


def write_exr(path: str, img: np.ndarray, compression: str = "zip",
              dtype: str = "half") -> str:
    """Write (H, W, C<=4) float data as a scanline EXR (channel names RGBA
    by position)."""
    img, names, order, dt, comp = _image_layout(img, compression, dtype)
    header = struct.pack("<ii", _MAGIC, 2) + _header_attrs(img, names, order,
                                                           dt, comp)
    chunks = [(struct.pack("<i", row0), packed) for row0, packed in
              _scanline_chunks(img, names, order, dt, comp)]
    return _write(path, header, chunks)


def write_exr_multipart(path: str, parts, compression: str = "zip",
                        dtype: str = "half") -> str:
    """Write a multi-part scanline EXR (version flag 0x1000): ``parts`` is
    ``[(name, (H, W, C) array), ...]``. Each part gets the required name /
    type / chunkCount attributes; chunks carry the part-number prefix.
    The multi-layer export compositors read (``save_aovs``)."""
    headers, chunks = b"", []
    for pi, (pname, img) in enumerate(parts):
        img, names, order, dt, comp = _image_layout(img, compression, dtype)
        part = _scanline_chunks(img, names, order, dt, comp)
        headers += _header_attrs(
            img, names, order, dt, comp,
            part_attrs=(_attr("name", "string", pname.encode())
                        + _attr("type", "string", b"scanlineimage")
                        + _attr("chunkCount", "int",
                                struct.pack("<i", len(part)))))
        chunks += [(struct.pack("<ii", pi, row0), packed)
                   for row0, packed in part]
    header = struct.pack("<ii", _MAGIC, 2 | 0x1000) + headers + b"\x00"
    return _write(path, header, chunks)


def write_exr_tiled(path: str, img: np.ndarray, tile=(64, 64),
                    compression: str = "zip", dtype: str = "half",
                    level_mode: str = "one") -> str:
    """Write a single-part TILED EXR (version flag 0x200) — ONE_LEVEL or
    MIPMAP (round-down levels, nearest-sample reductions; loaders read
    level 0)."""
    img, names, order, dt, comp = _image_layout(img, compression, dtype)
    H, W = img.shape[:2]
    xs, ys = tile
    lmode = {"one": 0, "mip": 1}[level_mode]
    header = struct.pack("<ii", _MAGIC, 2 | 0x200) + _header_attrs(
        img, names, order, dt, comp,
        tail_attrs=_attr("tiles", "tiledesc",
                         struct.pack("<IIB", xs, ys, lmode)))
    chunks = []
    for lx, ly, lw, lh, ntx, nty in _tile_level_table(W, H, xs, ys, lmode,
                                                      round_up=False):
        lvl = img[::1 << ly, ::1 << lx][:lh, :lw]  # nearest-sample reduction
        for ty in range(nty):
            for tx in range(ntx):
                block = lvl[ty * ys:(ty + 1) * ys, tx * xs:(tx + 1) * xs]
                chunks.append((struct.pack("<iiii", tx, ty, lx, ly),
                               _encode_chunk(comp, block, order, names, dt)))
    return _write(path, header, chunks)
