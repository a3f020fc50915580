"""Sky-tap kernel wrapper and its plain version.

The counterpart of the JAX package's ``ops/pallas_env.py``. The TPU fetches
texels with one-hot matrix products because it gathers serially; here
``env_lookup`` launches ``csrc/env_kernel.cu``, a plain gather plus the RGBE
decode, for CUDA tensors, and runs the plain version (an indexed read plus
``_decode_rgbe``) for CPU tensors. The two are bit-identical. The texel
pick stays in torch (``pick_texel``), as it stays in XLA in the JAX
package, so a last-ulp difference in ``atan2`` between devices cannot move
the texel between the kernel and its plain version. The kernel serves every
map size.
"""

from __future__ import annotations

import torch

from .. import _build
from .shade import _decode_rgbe, pick_texel, rgbe_scale, rgbe_words
from .vec import Vec3


def env_lookup_plain(packed, yn, xn, W: int) -> Vec3:
    """Decode texel (yn, xn) of the packed (H*W,) RGBE plane."""
    return _decode_rgbe(rgbe_words(packed)[yn.long() * W + xn.long()])


def env_lookup(packed, yn, xn, W: int) -> Vec3:
    """Decoded RGBE texels: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``packed``: (H*W,) int32 bit patterns of the
    packed words; ``yn``/``xn``: (N,) int32 texel coordinates."""
    if packed.device.type == "cpu":
        return env_lookup_plain(packed, yn, xn, W)
    if packed.device.type != "cuda":
        raise ValueError(f"no env kernel for device {packed.device}")
    n = yn.shape[0]
    for a in (packed, yn, xn):
        if a.device != packed.device or a.dtype != torch.int32 \
                or a.dim() != 1 or not a.is_contiguous():
            raise ValueError("env_lookup takes contiguous 1-D int32 tensors "
                             "on one device")
    if xn.shape[0] != n:
        raise ValueError(f"yn has {n} entries, xn {xn.shape[0]}")
    out = torch.empty((3, n), dtype=torch.float32, device=packed.device)
    code = _build.lib().urt_env_lookup(
        packed.data_ptr(), rgbe_scale(packed.device).data_ptr(), yn.data_ptr(), xn.data_ptr(), W,
        out.data_ptr(), n, _build.stream_ptr(packed.device))
    _build.LAUNCHES["env"] += 1
    _build.check(code, "env")
    return out[0], out[1], out[2]


def sample_skybox_tap(skybox_hw, packed, rd: Vec3, u1, u2) -> Vec3:
    """One stochastic RGBE sky tap per ray through ``env_lookup`` — the same
    texel choice and values as ``shade.sample_skybox_rgbe(u1=, u2=)``."""
    yn, xn = pick_texel(skybox_hw, rd, u1, u2)
    return env_lookup(packed, yn.contiguous(), xn.contiguous(), skybox_hw[1])
