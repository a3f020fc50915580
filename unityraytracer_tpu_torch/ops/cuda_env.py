"""Sky-tap kernel wrappers and their plain versions.

The counterpart of the JAX package's ``ops/pallas_env.py``. The TPU fetches
texels with one-hot matrix products because it gathers serially; here the
kernels of ``csrc/env_kernel.cu`` are plain gathers plus the RGBE decode:

* ``env_lookup`` reads the packed (H*W,) words (the counterpart of
  ``_env_kernel8``, impls ``"int8x8"`` and ``"bf16x8"``);
* ``env_lookup_planes`` reads the (H, 4W) byte-plane table (the counterpart
  of ``_env_kernel``, impl ``"bf16"``).

Each launches its kernel for CUDA tensors and runs its plain version (an
indexed read plus the decode) for CPU tensors; all four are bit-identical.
The texel pick stays in torch (``pick_texel``), as it stays in XLA in the
JAX package, so a last-ulp difference in ``atan2`` between devices cannot
move the texel between a kernel and its plain version. The kernels serve
every map size.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch

from .. import _build
from .shade import _decode_rgbe, pick_texel, rgbe_scale, rgbe_words
from .vec import Vec3

# Fetch implementation of ``sample_skybox_tap``, named as in the JAX
# package's ENV_IMPL. There "int8x8" and "bf16x8" differ only in the MXU
# number type of their one-hot dots; both read the packed words here.
# "bf16" reads the byte-plane table. Read at each call.
ENV_IMPL = "int8x8"

# Byte-plane tables, built once per packed plane (so once per scene and
# device): id(packed) -> (weak reference to packed, table). Keyed by id
# because a tensor's == is elementwise, which rules out WeakKeyDictionary.
_PLANES = {}


def env_lookup_plain(packed, yn, xn, W: int) -> Vec3:
    """Decode texel (yn, xn) of the packed (H*W,) RGBE plane."""
    return _decode_rgbe(rgbe_words(packed)[yn.long() * W + xn.long()])


def _check_texels(table, yn, xn, dtype, shape, name):
    if table.dtype != dtype or not table.is_contiguous() \
            or table.shape != shape:
        raise ValueError(f"{name} takes a contiguous {dtype} table of shape "
                         f"{shape}, got {table.dtype} {tuple(table.shape)}")
    for a in (yn, xn):
        if a.device != table.device or a.dtype != torch.int32 \
                or a.dim() != 1 or not a.is_contiguous():
            raise ValueError(f"{name} takes contiguous 1-D int32 texel "
                             "coordinates on the table's device")
    if xn.shape[0] != yn.shape[0]:
        raise ValueError(f"yn has {yn.shape[0]} entries, xn {xn.shape[0]}")


def env_lookup(packed, yn, xn, W: int) -> Vec3:
    """Decoded RGBE texels: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``packed``: (H*W,) int32 bit patterns of the
    packed words; ``yn``/``xn``: (N,) int32 texel coordinates."""
    if packed.device.type == "cpu":
        return env_lookup_plain(packed, yn, xn, W)
    if packed.device.type != "cuda":
        raise ValueError(f"no env kernel for device {packed.device}")
    _check_texels(packed, yn, xn, torch.int32, (packed.shape[0],),
                  "env_lookup")
    n = yn.shape[0]
    out = torch.empty((3, n), dtype=torch.float32, device=packed.device)
    code = _build.lib().urt_env_lookup(
        packed.data_ptr(), rgbe_scale(packed.device).data_ptr(), yn.data_ptr(), xn.data_ptr(), W,
        out.data_ptr(), n, _build.stream_ptr(packed.device))
    _build.LAUNCHES["env"] += 1
    _build.check(code, "env")
    return out[0], out[1], out[2]


def byte_planes(packed, H: int, W: int) -> torch.Tensor:
    """(H, 4W) uint8 table of the packed words' bytes: planes r, g, b, e
    side by side (``pallas_env.py:_byte_planes``; the JAX package holds the
    same bytes in bf16, which stores 0-255 exactly)."""
    w = rgbe_words(packed).reshape(H, W)
    return torch.cat([(w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF, w >> 24],
                     dim=1).to(torch.uint8)


def _planes_of(packed, H: int, W: int) -> torch.Tensor:
    key = id(packed)
    ref, tab = _PLANES.get(key, (None, None))
    if ref is None or ref() is not packed or tab.shape != (H, 4 * W):
        tab = byte_planes(packed, H, W)
        _PLANES[key] = (weakref.ref(packed, lambda _: _PLANES.pop(key, None)),
                        tab)
    return tab


def env_lookup_planes_plain(planes, yn, xn, W: int) -> Vec3:
    """Decode texel (yn, xn) of the (H, 4W) byte-plane table."""
    y, x = yn.long(), xn.long()
    r, g, b, e = (planes[y, p * W + x] for p in range(4))
    scale = rgbe_scale(planes.device)[e.long()]
    return (r.to(torch.float32) * scale, g.to(torch.float32) * scale,
            b.to(torch.float32) * scale)


def env_lookup_planes(planes, yn, xn, W: int) -> Vec3:
    """``env_lookup`` from the byte-plane table: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. ``planes``: (H, 4W) uint8
    from ``byte_planes``; ``yn``/``xn``: (N,) int32 texel coordinates."""
    if planes.device.type == "cpu":
        return env_lookup_planes_plain(planes, yn, xn, W)
    if planes.device.type != "cuda":
        raise ValueError(f"no env kernel for device {planes.device}")
    _check_texels(planes, yn, xn, torch.uint8, (planes.shape[0], 4 * W),
                  "env_lookup_planes")
    n = yn.shape[0]
    out = torch.empty((3, n), dtype=torch.float32, device=planes.device)
    code = _build.lib().urt_env_lookup_planes(
        planes.data_ptr(), rgbe_scale(planes.device).data_ptr(),
        yn.data_ptr(), xn.data_ptr(), W, out.data_ptr(), n,
        _build.stream_ptr(planes.device))
    _build.LAUNCHES["env_planes"] += 1
    _build.check(code, "env_planes")
    return out[0], out[1], out[2]


def sample_skybox_tap(skybox_hw, packed, rd: Vec3, u1, u2,
                      impl: Optional[str] = None) -> Vec3:
    """One stochastic RGBE sky tap per ray — the same texel choice and
    values as ``shade.sample_skybox_rgbe(u1=, u2=)`` for every ``impl``
    (default ``ENV_IMPL``): ``"int8x8"``/``"bf16x8"`` through
    ``env_lookup``, ``"bf16"`` through ``env_lookup_planes``. Another name
    raises ``ValueError`` (the JAX package would fall back to bf16)."""
    impl = impl or ENV_IMPL
    if impl not in ("int8x8", "bf16x8", "bf16"):
        raise ValueError(f"unknown env impl {impl!r}")
    H, W = skybox_hw
    yn, xn = pick_texel(skybox_hw, rd, u1, u2)
    yn, xn = yn.contiguous(), xn.contiguous()
    if impl == "bf16":
        return env_lookup_planes(_planes_of(packed, H, W), yn, xn, W)
    return env_lookup(packed, yn, xn, W)
