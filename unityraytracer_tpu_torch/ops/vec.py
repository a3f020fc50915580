"""Component-SoA 3-vector math: a Vec3 is a tuple of three (N,) tensors.

The JAX package keeps ray state component-SoA to dodge padded TPU layouts;
the port keeps the same form so every function maps one to one onto its
JAX counterpart, and the CUDA kernels take the components as (3, N) rows.

All functions broadcast over any common shape; "scalars" may be Python
floats or 0-d tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

Vec3 = Tuple  # (x, y, z) of same-shape tensors


def splat(v, like) -> Vec3:
    """Constant 3-vector broadcast to the shape of ``like`` (a tensor)."""
    return tuple(torch.full_like(like, c) for c in v)


def add(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(a: Vec3, s) -> Vec3:
    return (a[0] * s, a[1] * s, a[2] * s)


def dot(a: Vec3, b: Vec3):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def normalize(a: Vec3, eps: float = 1e-20) -> Vec3:
    inv = 1.0 / torch.sqrt(torch.clamp_min(dot(a, a), eps))
    return scale(a, inv)


def where(cond, a: Vec3, b: Vec3) -> Vec3:
    """Per-component select with a (N,) boolean."""
    return (torch.where(cond, a[0], b[0]),
            torch.where(cond, a[1], b[1]),
            torch.where(cond, a[2], b[2]))


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """Mirror direction d about unit normal n (HLSL reflect)."""
    k = 2.0 * dot(d, n)
    return (d[0] - k * n[0], d[1] - k * n[1], d[2] - k * n[2])


def sdot(x: Vec3, y: Vec3, f=1.0):
    """Scaled saturated dot (reference sdot, RayTraceShader.compute:84)."""
    return torch.clamp(dot(x, y) * f, 0.0, 1.0)


def gather_rows(table, idx) -> Vec3:
    """Per-component gather from a (T, 3) table -> Vec3 of (N,)."""
    return (table[:, 0][idx], table[:, 1][idx], table[:, 2][idx])


def stack(v: Vec3) -> torch.Tensor:
    """Vec3 -> contiguous (3, N) rows, the layout the CUDA kernels read."""
    return torch.stack(v, dim=0).contiguous()
