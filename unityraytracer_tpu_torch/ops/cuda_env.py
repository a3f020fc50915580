"""The sky tap: its kernel's wrapper and the plain versions.

The counterpart of the JAX package's ``ops/pallas_env.py`` together with
what XLA runs around it in ``render.py``. ``sky_tap`` is the whole
once-per-frame sky resolve: each ray's two sky draws, the stochastic texel
pick, the RGBE fetch and decode, and the compose radiance + sky_e * sky.
For CUDA tensors it is one launch of ``csrc/env_kernel.cu:urt_sky_tap``; for
CPU tensors it runs ``sky_tap_plain``; the two are bit-identical. The fetch
reads either

* the packed (H*W,) words (the counterpart of ``_env_kernel8``, impls
  ``"int8x8"`` and ``"bf16x8"``), or
* the (H, 4W) byte-plane table (the counterpart of ``_env_kernel``, impl
  ``"bf16"``).

The plain pieces stay functions of their own: ``env_lookup_plain`` and
``env_lookup_planes_plain`` fetch and decode given texels, and
``sample_skybox_tap`` picks, fetches and decodes for given uniforms. They
serve every map size.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch

from .. import _build, rng
from .shade import _decode_rgbe, pick_texel, rgbe_scale, rgbe_words
from .vec import Vec3

# Fetch implementation of the sky tap, named as in the JAX package's
# ENV_IMPL. There "int8x8" and "bf16x8" differ only in the MXU number type
# of their one-hot dots; both read the packed words here. "bf16" reads the
# byte-plane table. Read at each call.
ENV_IMPL = "int8x8"
IMPLS = ("int8x8", "bf16x8", "bf16")

# Byte-plane tables, built once per packed plane (so once per scene and
# device): id(packed) -> (weak reference to packed, table). Keyed by id
# because a tensor's == is elementwise, which rules out WeakKeyDictionary.
_PLANES = {}


def _impl(impl: Optional[str]) -> str:
    impl = impl or ENV_IMPL
    if impl not in IMPLS:
        raise ValueError(f"unknown env impl {impl!r}")
    return impl


def env_lookup_plain(packed, yn, xn, W: int) -> Vec3:
    """Decode texel (yn, xn) of the packed (H*W,) RGBE plane."""
    return _decode_rgbe(rgbe_words(packed)[yn.long() * W + xn.long()])


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


def sample_skybox_tap(skybox_hw, packed, rd: Vec3, u1, u2,
                      impl: Optional[str] = None) -> Vec3:
    """One stochastic RGBE sky tap per ray for given uniforms, in plain
    torch — the same texel choice and values as
    ``shade.sample_skybox_rgbe(u1=, u2=)`` for every ``impl`` (default
    ``ENV_IMPL``): ``"int8x8"``/``"bf16x8"`` fetch from the packed words,
    ``"bf16"`` from the byte-plane table. Another name raises
    ``ValueError`` (the JAX package would fall back to bf16)."""
    impl = _impl(impl)
    H, W = skybox_hw
    yn, xn = pick_texel(skybox_hw, rd, u1, u2)
    if impl == "bf16":
        return env_lookup_planes_plain(_planes_of(packed, H, W), yn, xn, W)
    return env_lookup_plain(packed, yn, xn, W)


def sky_counters(n: int, ray_index=None, lattice=None,
                 device=None) -> torch.Tensor:
    """(n,) int64 counter of each ray's sky draws: ``ray_index``
    when given, else the ray's own index, or with ``lattice=(h, W, spp)``
    (rays in pixel order at a size that tiles into 8x16 blocks) the ray's
    block slot, as ``render._draw_fn``'s ``to_pixel_order`` assigns it."""
    if ray_index is not None:
        return ray_index.to(torch.int64)
    c = torch.arange(n, dtype=torch.int64, device=device)
    if lattice is None:
        return c
    h, W, spp = lattice
    return (c.reshape(spp, h // 8, W // 16, 8, 16).permute(0, 1, 3, 2, 4)
            .reshape(n))


def sky_tap_plain(skybox_hw, packed, radiance: Vec3, sky_e: Vec3,
                  sky_d: Vec3, keys, ray_index=None, lattice=None,
                  impl: Optional[str] = None) -> Vec3:
    """Plain version of ``sky_tap``: the int64 draws of
    ``rng.uniform_at_plain`` (threefry or rbg, by the keys) at
    ``sky_counters``, ``sample_skybox_tap``
    and the compose, into the radiance rows in place."""
    c = sky_counters(sky_d[0].shape[0], ray_index, lattice, sky_d[0].device)
    u1, u2 = (rng.uniform_at_plain(k, c) for k in keys)
    tap = sample_skybox_tap(skybox_hw, packed, sky_d, u1, u2, impl)
    for r, e, t in zip(radiance, sky_e, tap):
        r.add_(e * t)
    return radiance


def _check_rows(rows, device) -> int:
    n = rows[0].shape[0] if rows[0].dim() == 1 else -1
    for r in rows:
        if r.device != device or r.dtype != torch.float32 or r.dim() != 1 \
                or not r.is_contiguous() or r.shape[0] != n:
            raise ValueError("sky_tap takes contiguous (n,) float32 rows on "
                             f"the sky's device {device}")
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays exceed the sky-tap kernel's 32-bit "
                         "indexing")
    return n


def sky_tap(skybox_hw, packed, radiance: Vec3, sky_e: Vec3, sky_d: Vec3,
            keys, ray_index=None, lattice=None,
            impl: Optional[str] = None) -> Vec3:
    """Compose one stochastic RGBE sky tap per ray into the radiance:
    ``radiance[k] += sky_e[k] * tap[k]`` in place, the tap taken along
    ``sky_d``; returns the radiance rows.

    Ray i's draws u1, u2 are the uniforms of ``keys[0]`` and ``keys[1]``
    (two threefry keys or two rbg keys) at its counter
    (``sky_counters``): i, ``ray_index[i]`` ((n,) int64), or its block slot
    in the ``lattice=(h, W, spp)``.
    ``packed``: the (H*W,) int32 RGBE plane; ``impl`` (default ``ENV_IMPL``)
    picks the fetch. For CUDA tensors one launch of the sky-tap kernel, with
    the keys passed by value; for CPU tensors ``sky_tap_plain``."""
    impl = _impl(impl)
    dev = packed.device
    if dev.type == "cpu":
        return sky_tap_plain(skybox_hw, packed, radiance, sky_e, sky_d, keys,
                             ray_index, lattice, impl)
    if dev.type != "cuda":
        raise ValueError(f"no sky-tap kernel for device {dev}")
    H, W = skybox_hw
    n = _check_rows((*radiance, *sky_e, *sky_d), dev)
    if packed.dtype != torch.int32 or not packed.is_contiguous() \
            or packed.shape != (H * W,):
        raise ValueError(f"sky_tap takes a contiguous ({H * W},) int32 "
                         f"plane, got {packed.dtype} {tuple(packed.shape)}")
    if ray_index is not None and (
            ray_index.device != dev or ray_index.dtype != torch.int64
            or ray_index.shape != (n,) or not ray_index.is_contiguous()):
        raise ValueError(f"ray_index must be a contiguous ({n},) int64 "
                         f"tensor on {dev}")
    lat_h = lat_w = 0
    if ray_index is None and lattice is not None:
        lat_h, lat_w, spp = lattice
        if lat_h % 8 or lat_w % 16 or spp * lat_h * lat_w != n:
            raise ValueError(f"lattice {lattice} does not tile {n} rays "
                             "into 8x16 blocks")
    planes = impl == "bf16"
    table = _planes_of(packed, H, W) if planes else packed
    (w1, rbg1), (w2, rbg2) = (rng.kernel_words(k) for k in keys)
    if rbg1 != rbg2:
        raise ValueError("the sky tap's two keys are of two rng impls")
    # Threefry's two keys are words 0-1 and 2-3; rbg's 0-3 and 4-7.
    k = (*w1, *w2) if rbg1 else (*w1[:2], *w2[:2], 0, 0, 0, 0)
    with _build.on_card(table.device):
        code = _build.lib().urt_sky_tap(
            *(r.data_ptr() for r in (*radiance, *sky_e, *sky_d)),
            table.data_ptr(), int(planes), rgbe_scale(dev).data_ptr(), H, W,
            *k, rbg1, ray_index.data_ptr() if ray_index is not None else None,
            lat_h, lat_w, n, _build.stream_ptr(table.device))
    name = ("env_planes" if planes else "env") + ("_rbg" if rbg1 else "")
    _build.count(name, table.device)
    _build.check(code, name)
    return radiance
