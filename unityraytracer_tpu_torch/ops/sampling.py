"""Monte-Carlo sampling: tangent frames, power-cosine hemisphere, lens disk.

Op for op the JAX package's ``ops/sampling.py``: the same uniforms map to
the same directions (to float rounding of the transcendental functions).
Directions are component-SoA Vec3 tuples (see ops/vec.py).
"""

from __future__ import annotations

import torch

from .vec import Vec3

PI = 3.14159265


def uniform_from_bits(bits):
    """Random bits (uint32 values in any integer tensor, or their int32 bit
    patterns) -> float32 uniforms in [0, 1): the top 24 bits, so the float
    is exact."""
    top = (bits.to(torch.int64) & 0xFFFFFFFF) >> 8
    return top.to(torch.float32) * (1.0 / (1 << 24))


def tangent_frame(n: Vec3):
    """Orthonormal (tangent, binormal) for unit normals — the branchless
    Frisvad/Pixar construction of the JAX package."""
    s = torch.where(n[2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[2])
    b = n[0] * n[1] * a
    tangent = (1.0 + s * n[0] * n[0] * a, s * b, -s * n[0])
    binormal = (b, s + n[1] * n[1] * a, -n[1])
    return tangent, binormal


def sample_hemisphere_ct(cos_t, cos_phi, sin_phi, axis: Vec3) -> Vec3:
    """Hemisphere sample from precomputed cos(theta) and phi trig."""
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    tangent, binormal = tangent_frame(axis)
    ca, sa = cos_phi * sin_t, sin_phi * sin_t
    return (tangent[0] * ca + binormal[0] * sa + axis[0] * cos_t,
            tangent[1] * ca + binormal[1] * sa + axis[1] * cos_t,
            tangent[2] * ca + binormal[2] * sa + axis[2] * cos_t)


def sample_hemisphere(u1, u2, axis: Vec3, alpha) -> Vec3:
    """Power-cosine hemisphere sample about ``axis``:
    cos(theta) = u1^(1/(alpha+1))."""
    cos_t = torch.pow(torch.clamp_min(u1, 1e-12), 1.0 / (alpha + 1.0))
    phi = 2.0 * PI * u2
    return sample_hemisphere_ct(cos_t, torch.cos(phi), torch.sin(phi), axis)


def sample_unit_disk(u1, u2):
    """Polar disk sample for thin-lens DoF: returns (dx, dy) components."""
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    return r * torch.cos(phi), r * torch.sin(phi)
