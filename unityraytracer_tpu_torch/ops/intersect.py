"""Vectorized intersection primitives (plain torch).

The port of the JAX package's ``ops/intersect.py``: rays are component-SoA
(Vec3 tuples of (R,) tensors) broadcast against (P,) primitive arrays,
returning (R, P) (or (R,)) results that the caller reduces. The CUDA
closest-hit function (``csrc/closest_hit.cuh``) does the same arithmetic in
the same order, one ray and one primitive at a time.
"""

from __future__ import annotations

import torch

from ..utils.math3d import EPSILON, INF
from .vec import Vec3


def intersect_ground(ro: Vec3, rd: Vec3):
    """Infinite plane y=0. Returns t: (R,), INF on miss."""
    dy = rd[1]
    safe_dy = torch.where(torch.abs(dy) < 1e-20, 1e-20, dy)
    t = -ro[1] / safe_dy
    return torch.where(t > 0, t, INF)


def intersect_spheres(ro: Vec3, rd: Vec3, center, radius):
    """Batched ray-sphere. center: (S, 3), radius: (S,). Returns t: (R, S),
    INF where no positive hit."""
    cx, cy, cz = center[:, 0], center[:, 1], center[:, 2]
    ocx = ro[0][:, None] - cx[None, :]
    ocy = ro[1][:, None] - cy[None, :]
    ocz = ro[2][:, None] - cz[None, :]
    p1 = -(rd[0][:, None] * ocx + rd[1][:, None] * ocy + rd[2][:, None] * ocz)
    p2sqr = p1 * p1 - (ocx * ocx + ocy * ocy + ocz * ocz) \
        + (radius * radius)[None, :]
    p2 = torch.sqrt(torch.clamp_min(p2sqr, 0.0))
    t_near = p1 - p2
    t = torch.where(t_near > 0, t_near, p1 + p2)
    return torch.where((p2sqr >= 0) & (t > 0), t, INF)


def intersect_triangles(ro: Vec3, rd: Vec3, v0, v1, v2):
    """Batched Moller-Trumbore with backface culling (det >= EPSILON).

    v0/v1/v2: (T, 3) world-space. Returns t, u, v: (R, T); t = INF on miss.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    rdx, rdy, rdz = (c[:, None] for c in rd)
    rox, roy, roz = (c[:, None] for c in ro)
    e1x, e1y, e1z = e1[:, 0][None], e1[:, 1][None], e1[:, 2][None]
    e2x, e2y, e2z = e2[:, 0][None], e2[:, 1][None], e2[:, 2][None]
    v0x, v0y, v0z = v0[:, 0][None], v0[:, 1][None], v0[:, 2][None]
    px = rdy * e2z - rdz * e2y
    py = rdz * e2x - rdx * e2z
    pz = rdx * e2y - rdy * e2x
    det = e1x * px + e1y * py + e1z * pz
    front = det >= EPSILON
    inv_det = 1.0 / torch.where(front, det, 1.0)
    del det
    tx = rox - v0x
    ty = roy - v0y
    tz = roz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    del px, py, pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    del tx, ty, tz
    v = (rdx * qx + rdy * qy + rdz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = front & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0)
    return torch.where(valid, t, INF), u, v


def intersect_aabb(ro: Vec3, inv_rd: Vec3, vmin, vmax):
    """Batched slab test (correct version of IntersectBVHNode, compute:271-291).

    Unlike the reference we cull against positive t (the reference returns hits
    behind the ray; SURVEY.md defect list says implement the correct test).

    Args:
      ro, inv_rd: Vec3 of (R,) (inv_rd = safe reciprocal directions).
      vmin, vmax: (B, 3).
    Returns:
      (hit, t_enter): ((R, B) bool, (R, B) float32 entry distance >= 0).
    """
    shape = (ro[0].shape[0], vmin.shape[0])
    t_min = torch.full(shape, -INF, device=vmin.device)
    t_max = torch.full(shape, INF, device=vmin.device)
    for a in range(3):
        t1 = (vmin[:, a][None, :] - ro[a][:, None]) * inv_rd[a][:, None]
        t2 = (vmax[:, a][None, :] - ro[a][:, None]) * inv_rd[a][:, None]
        t_min = torch.maximum(t_min, torch.minimum(t1, t2))
        t_max = torch.minimum(t_max, torch.maximum(t1, t2))
    hit = (t_max >= t_min) & (t_max > 0)
    return hit, torch.clamp_min(t_min, 0.0)


def safe_inv_dir(rd: Vec3) -> Vec3:
    """Reciprocal direction guarded against division by zero (the reference
    adds EPSILON to the raw direction, compute:282-283; we clamp magnitude)."""
    return tuple(
        1.0 / torch.where(torch.abs(d) < 1e-12,
                          torch.where(d < 0, -1e-12, 1e-12), d)
        for d in rd)
