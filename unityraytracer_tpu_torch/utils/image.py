"""Image IO and metrics: tonemap, PNG writer (stdlib-only), RMSE.

The reference's export path is Unity's ScreenCapture on F12
(`RayTraceMaster.cs:761-763`) writing display-ready PNGs; here ``write_png``
serves the same role for converged linear images, and ``rmse`` implements the
fidelity metric from BASELINE.json (per-pixel RMSE vs reference renders).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    """Standard sRGB OETF on linear [0, inf) radiance (clipped to [0,1])."""
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    lo = img * 12.92
    hi = 1.055 * np.power(np.maximum(img, 1e-8), 1.0 / 2.4) - 0.055
    return np.where(img <= 0.0031308, lo, hi)


def tonemap_aces(img: np.ndarray) -> np.ndarray:
    """ACES filmic approximation (Narkowicz) for HDR display."""
    x = np.asarray(img, np.float32)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return np.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def to_uint8(img: np.ndarray, srgb: bool = True) -> np.ndarray:
    """(H, W, 3) linear float -> uint8 display pixels."""
    img = linear_to_srgb(img) if srgb else np.clip(img, 0, 1)
    return (img * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray, srgb: bool = True) -> str:
    """Write (H, W, 3) float (linear) or uint8 image as RGB8 PNG (stdlib only)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr, srgb=srgb)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    h, w = arr.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
    return path


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Per-pixel root-mean-square error between two images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.sqrt(np.mean((a - b) ** 2)))


def ulp_distance(a, b) -> int:
    """Largest distance in units in the last place between two float32
    tensors of one shape (0 where the bits agree)."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())
