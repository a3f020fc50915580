"""Shading: roulette BRDF bounce + equirect skybox (plain torch).

The port of the JAX package's ``ops/shade.py``, op for op, on component-SoA
Vec3 tuples of (N,) tensors:

  contribution = energy_before * (emission | skybox)
  energy_after = energy_before * lobe_weight          (0 on miss/terminate)

All roulette branches are computed for every lane and selected with
``where``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import vec
from .vec import Vec3
from .sampling import PI, sample_hemisphere, sample_hemisphere_ct

MISS_T = 1e30  # distances >= this are misses


@dataclasses.dataclass
class Hit:
    """Per-ray hit record, component-SoA. ``prim`` (optional) is the
    winning primitive: triangle index in accel order, ``T`` for the ground,
    ``T + 1 + s`` for sphere s, -1 for a miss."""

    t: torch.Tensor
    position: Vec3
    normal: Vec3
    albedo: Vec3
    specular: Vec3
    emission: Vec3
    smoothness: torch.Tensor
    prim: torch.Tensor = None


def _fmod1(x):
    """``jnp.mod(x, 1.0)``: fmod, shifted into [0, 1) for negative x."""
    r = torch.fmod(x, 1.0)
    return torch.where(r < 0, r + 1.0, r)


def sample_skybox(skybox, rd: Vec3) -> Vec3:
    """Bilinear equirect environment lookup: row01 = acos(y)/pi,
    col01 = (-atan2(x, -z)/(2*pi)) mod 1; clamp v, wrap u."""
    H, W = skybox.shape[0], skybox.shape[1]
    y = torch.clamp(rd[1], -1.0, 1.0)
    row01 = torch.arccos(y) / PI
    col01 = _fmod1(-torch.atan2(rd[0], -rd[2]) / (2.0 * PI))

    fy = row01 * H - 0.5
    fx = col01 * W - 0.5
    y0f = torch.floor(fy)
    x0f = torch.floor(fx)
    wy = fy - y0f
    wx = fx - x0f
    y0 = torch.clamp(y0f.to(torch.int32), 0, H - 1)
    y1 = torch.clamp(y0f.to(torch.int32) + 1, 0, H - 1)
    x0 = torch.remainder(x0f.to(torch.int32), W)
    x1 = torch.remainder(x0f.to(torch.int32) + 1, W)

    i00 = (y0 * W + x0).long()
    i01 = (y0 * W + x1).long()
    i10 = (y1 * W + x0).long()
    i11 = (y1 * W + x1).long()
    out = []
    for ch in range(3):
        plane = skybox[:, :, ch].reshape(-1)
        top = plane[i00] * (1 - wx) + plane[i01] * wx
        bot = plane[i10] * (1 - wx) + plane[i11] * wx
        out.append(top * (1 - wy) + bot * wy)
    return tuple(out)


def pack_rgbe_np(skybox) -> np.ndarray:
    """(H, W, 3) float -> (H*W,) uint32 shared-exponent RGBE texels, baked
    once at scene build (the JAX package's ``pack_rgbe_np``)."""
    skybox = np.asarray(skybox, np.float32)
    m = skybox.max(axis=-1)
    exp = np.ceil(np.log2(np.maximum(m, 1e-30))).astype(np.int32) + 1
    scale = np.exp2(8.0 - exp.astype(np.float32))
    rgb = np.clip(skybox * scale[..., None], 0, 255).astype(np.uint32)
    e = np.where(m > 1e-30, exp + 128, 0).astype(np.uint32)
    word = ((e << 24) | (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2])
    return word.reshape(-1)


def _rgbe_scale_table() -> np.ndarray:
    """Decode scale 2^(e-136) for every exponent byte, as the JAX package's
    ``jnp.exp2(e - 136.0)`` evaluates on XLA:CPU: exp of the float32 product
    x * float32(ln 2), rounded to float32, with subnormal results flushed to
    zero; e == 0 decodes to 0. Tabulating the 256 values makes the port's
    decode (plain and CUDA) bit-identical to the JAX package's."""
    x = np.arange(256, dtype=np.float32) - np.float32(136.0)
    p = (x * np.float32(np.log(2.0))).astype(np.float32)
    s64 = np.exp(p.astype(np.float64))
    s = np.where(s64 < np.finfo(np.float32).tiny, 0.0, s64).astype(np.float32)
    s[0] = 0.0
    return s


RGBE_SCALE = _rgbe_scale_table()


@functools.lru_cache(maxsize=None)
def rgbe_scale(device: torch.device) -> torch.Tensor:
    """``RGBE_SCALE`` on ``device``, uploaded once per device (an upload
    waits for the device, so none happens per frame)."""
    return torch.as_tensor(RGBE_SCALE, device=device)


def rgbe_words(packed) -> torch.Tensor:
    """Packed plane (int32 bit patterns or int64 words) -> int64 words."""
    return packed.to(torch.int64) & 0xFFFFFFFF


def _decode_rgbe(word) -> Vec3:
    """int64 RGBE words -> Vec3 radiance: byte * 2^(e-136), 0 when e == 0."""
    scale = rgbe_scale(word.device)[word >> 24]
    return (((word >> 16) & 0xFF).to(torch.float32) * scale,
            ((word >> 8) & 0xFF).to(torch.float32) * scale,
            (word & 0xFF).to(torch.float32) * scale)


def _equirect_coords(skybox_hw, rd: Vec3):
    H, W = skybox_hw
    y = torch.clamp(rd[1], -1.0, 1.0)
    row01 = torch.arccos(y) / PI
    col01 = _fmod1(-torch.atan2(rd[0], -rd[2]) / (2.0 * PI))
    fy = row01 * H - 0.5
    fx = col01 * W - 0.5
    y0f = torch.floor(fy)
    x0f = torch.floor(fx)
    y0 = torch.clamp(y0f.to(torch.int32), 0, H - 1)
    y1 = torch.clamp(y0f.to(torch.int32) + 1, 0, H - 1)
    x0 = torch.remainder(x0f.to(torch.int32), W)
    x1 = torch.remainder(x0f.to(torch.int32) + 1, W)
    return (y0, y1, x0, x1, fy - y0f, fx - x0f)


def pick_texel(skybox_hw, rd: Vec3, u1, u2):
    """Stochastic single tap: each bilinear corner with probability equal to
    its weight. Returns (yn, xn) int32."""
    y0, y1, x0, x1, wy, wx = _equirect_coords(skybox_hw, rd)
    return torch.where(u1 < wy, y1, y0), torch.where(u2 < wx, x1, x0)


def sample_skybox_rgbe(skybox, rd: Vec3, u1, u2, packed=None) -> Vec3:
    """One stochastic tap of the packed RGBE plane per ray: each bilinear
    corner with probability equal to its weight (u1, u2 per-ray uniforms),
    so the accumulated image converges to the bilinear lookup. ``packed``:
    the baked (H*W,) plane; packed from ``skybox`` when None."""
    H, W = skybox.shape[0], skybox.shape[1]
    if packed is None:
        packed = torch.as_tensor(pack_rgbe_np(skybox.cpu().numpy())
                                 .view(np.int32), device=skybox.device)
    yn, xn = pick_texel((H, W), rd, u1, u2)
    return _decode_rgbe(rgbe_words(packed)[(yn * W + xn).long()])


def shade(ro: Vec3, rd: Vec3, energy: Vec3, hit: Hit, uniforms, trig=None):
    """One bounce of the reference BRDF (environment handled by the caller).

    ``uniforms``: (roulette, u1, u2) U[0,1) tensors. ``trig``: optional
    (log2_u1, cos_phi, sin_phi) precomputed from u1/u2 (the megakernel's
    form: alpha through exp2, cos(theta) = exp2(log2_u1 / (alpha + 1))).

    Returns (new_ro, new_rd, new_energy, radiance, missed).
    """
    u_roulette, u1, u2 = uniforms
    missed = hit.t >= MISS_T
    n = hit.normal

    albedo = tuple(torch.minimum(1.0 - s, a)
                   for s, a in zip(hit.specular, hit.albedo))
    spec_chance = (hit.specular[0] + hit.specular[1] + hit.specular[2]) / 3.0
    diff_chance = (albedo[0] + albedo[1] + albedo[2]) / 3.0
    total = spec_chance + diff_chance
    safe_total = torch.where(total > 0, total, 1.0)
    spec_chance = spec_chance / safe_total
    diff_chance = diff_chance / safe_total

    is_spec = (total > 0) & (u_roulette < spec_chance)
    is_diff = (total > 0) & ~is_spec & (diff_chance > 0)

    refl = vec.reflect(rd, n)
    axis = vec.where(is_spec, refl, n)
    if trig is None:
        alpha = torch.pow(1000.0, hit.smoothness * hit.smoothness)
        new_dir = sample_hemisphere(u1, u2, axis,
                                    torch.where(is_spec, alpha, 1.0))
    else:
        log2_u1, cos_phi, sin_phi = trig
        s2 = hit.smoothness * hit.smoothness
        alpha = torch.exp2(s2 * float(np.float32(np.log2(1000.0))))
        cos_t = torch.exp2(log2_u1 / torch.where(is_spec, alpha + 1.0, 2.0))
        new_dir = sample_hemisphere_ct(cos_t, cos_phi, sin_phi, axis)
    f = (alpha + 2.0) / (alpha + 1.0)
    w_spec_s = vec.sdot(n, new_dir, f) / torch.clamp_min(spec_chance, 1e-8)
    w_spec = vec.scale(hit.specular, w_spec_s)
    w_diff = vec.scale(albedo, 1.0 / torch.clamp_min(diff_chance, 1e-8))

    zero = vec.splat((0., 0., 0.), u1)
    lobe_w = vec.where(is_spec, w_spec, vec.where(is_diff, w_diff, zero))
    new_ro = vec.add(hit.position, vec.scale(n, 0.001))

    radiance = vec.where(missed, zero, vec.mul(energy, hit.emission))
    new_energy = vec.where(missed, zero, vec.mul(energy, lobe_w))
    new_ro = vec.where(missed, ro, new_ro)
    new_rd = vec.where(missed, rd, new_dir)
    return new_ro, new_rd, new_energy, radiance, missed
