"""Environment maps: Radiance .hdr (RGBE) loader + procedural skies.

The reference ships 16 4K equirect HDRIs imported by Unity
(`Assets/Skyboxes/*`, import settings in the .meta files); the binaries are
stripped from the mirror, so parity here means (a) being able to load the
same .hdr files, and (b) procedural substitutes for tests/benchmarks that
exercise the same sampling path (equirect mapping, compute:424-426).

Array convention throughout the framework: (H, W, 3) float32 linear radiance,
row 0 = +y pole (top of the panorama).

Host numpy: the HDR loader and the procedural skies of the JAX package's
``models/skybox.py``, unchanged. Its EXR loader and RGBE writer wait for the
codec port.
"""

from __future__ import annotations

import numpy as np


def load_hdr(path: str) -> np.ndarray:
    """Read a Radiance RGBE (.hdr) file into (H, W, 3) float32 linear.

    Supports the common ``32-bit_rle_rgbe`` format with new-style scanline
    RLE, flat (uncompressed) scanlines, and legacy old-style RLE
    ((1,1,1,n) repeat markers); -Y H +X W orientation.
    """
    with open(path, "rb") as f:
        data = f.read()

    # Header ends at the first blank line; next line is the resolution.
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].decode("ascii").split()
    pos = eol + 1
    if len(res) != 4 or res[0] != "-Y" or res[2] != "+X":
        raise ValueError(f"unsupported HDR orientation {res}")
    H, W = int(res[1]), int(res[3])

    rgbe = np.empty((H, W, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    bp = 0
    for row in range(H):
        if W < 8 or W > 0x7FFF or not (buf[bp] == 2 and buf[bp + 1] == 2):
            # Flat or OLD-style RLE scanline: records are pixels, except
            # (1, 1, 1, n) which repeats the previous pixel n << rshift
            # times (rshift grows by 8 per consecutive marker — Radiance
            # color.c oldreadcolrs). A pure-flat row (no markers in the
            # next W records) takes the vectorized copy.
            chunk = buf[bp:bp + W * 4]
            if chunk.size == W * 4:
                recs = chunk.reshape(W, 4)
                if not ((recs[:, 0] == 1) & (recs[:, 1] == 1)
                        & (recs[:, 2] == 1)).any():
                    rgbe[row] = recs
                    bp += W * 4
                    continue
            x = 0
            rshift = 0
            while x < W:
                r_, g_, b_, e_ = buf[bp:bp + 4]
                bp += 4
                if r_ == 1 and g_ == 1 and b_ == 1:
                    count = int(e_) << rshift
                    if x == 0:
                        raise ValueError(
                            "old-RLE repeat with no previous pixel")
                    rgbe[row, x:x + count] = rgbe[row, x - 1]
                    x += count
                    rshift += 8
                else:
                    rgbe[row, x] = (r_, g_, b_, e_)
                    x += 1
                    rshift = 0
            continue
        if ((int(buf[bp + 2]) << 8) | int(buf[bp + 3])) != W:
            raise ValueError("scanline width mismatch")
        bp += 4
        for ch in range(4):
            x = 0
            while x < W:
                count = int(buf[bp]); bp += 1
                if count > 128:  # run
                    rgbe[row, x:x + count - 128, ch] = buf[bp]
                    bp += 1
                    x += count - 128
                else:  # literal
                    rgbe[row, x:x + count, ch] = buf[bp:bp + count]
                    bp += count
                    x += count
    return rgbe_to_float(rgbe)


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32 linear."""
    rgbe = np.asarray(rgbe, np.uint8)
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def gradient_sky(height: int = 256, width: int = 512,
                 zenith=(0.45, 0.65, 1.0), horizon=(0.9, 0.9, 0.85),
                 ground=(0.25, 0.22, 0.2)) -> np.ndarray:
    """Smooth zenith-horizon-nadir gradient sky."""
    el = np.linspace(0, np.pi, height)[:, None]  # 0 = +y pole
    up = np.cos(el)
    sky_t = np.clip(up, 0, 1) ** 0.7
    gnd_t = np.clip(-up, 0, 1) ** 0.7
    c = (sky_t[..., None] * np.asarray(zenith)
         + (1 - sky_t - gnd_t)[..., None] * np.asarray(horizon)
         + gnd_t[..., None] * np.asarray(ground))
    return np.broadcast_to(c, (height, width, 3)).astype(np.float32).copy()


def sun_sky(height: int = 256, width: int = 512, sun_dir=(0.35, 0.55, 0.75),
            sun_intensity: float = 50.0, sun_sharpness: float = 1500.0,
            **gradient_kw) -> np.ndarray:
    """Gradient sky plus a bright sun disk — the test/bench stand-in for the
    reference's CloudedSunGlow4k HDRI (strong directional key light)."""
    base = gradient_sky(height, width, **gradient_kw)
    sd = np.asarray(sun_dir, np.float64)
    sd = sd / np.linalg.norm(sd)
    rows = (np.arange(height) + 0.5) / height
    cols = (np.arange(width) + 0.5) / width
    theta = rows * np.pi               # row01 = acos(y)/pi
    phi = -cols * 2 * np.pi            # col01 = (-atan2(x,-z)/2pi) mod 1
    y = np.cos(theta)[:, None]
    sin_t = np.sin(theta)[:, None]
    x = sin_t * np.sin(phi)[None, :]
    z = -sin_t * np.cos(phi)[None, :]
    cosang = np.clip(x * sd[0] + y * sd[1] + z * sd[2], -1, 1)
    disk = np.exp(sun_sharpness * (cosang - 1.0))
    return (base + sun_intensity * disk[..., None]).astype(np.float32)
