"""Small vector/matrix helpers and constants shared across the port.

The vector helpers (``dot`` to ``transform_dirs``) are torch functions on
``(..., 3)`` float tensors, shape-polymorphic over leading batch dims, as
the JAX package's are on arrays; the component-SoA ray math lives in
``ops/vec.py``. The matrix builders (``normal_matrix``, ``quat_to_matrix``,
the TRS builders) are host-side numpy, as in the JAX package. Conventions
follow the reference's Unity scenes: left-handed world, +y up, camera looks
down +forward.
"""

from __future__ import annotations

import numpy as np
import torch

INF = float(np.finfo(np.float32).max)   # the JAX package's INF: f32 max
EPSILON = 1e-8  # reference EPSILON, RayTraceShader.compute:13


def dot(a, b):
    return (a * b).sum(dim=-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def norm(a):
    return torch.sqrt(torch.clamp_min(dot(a, a), 0.0))


def normalize(a, eps: float = 1e-20):
    return a / torch.sqrt(torch.clamp_min(dot(a, a), eps))[..., None]


def sdot(x, y, f=1.0):
    """Scaled, saturated dot product (reference ``sdot``,
    RayTraceShader.compute:84)."""
    return torch.clamp(dot(x, y) * f, 0.0, 1.0)


def reflect(d, n):
    """Mirror direction ``d`` about unit normal ``n`` (HLSL ``reflect``)."""
    return d - 2.0 * dot(d, n)[..., None] * n


def _linear(mat4, like):
    return torch.as_tensor(np.asarray(mat4, np.float32)[:3],
                           dtype=like.dtype, device=like.device)


def transform_points(mat4, pts):
    """Apply a (4, 4) affine matrix (numpy or tensor) to (..., 3) points."""
    m = _linear(mat4, pts)
    return pts @ m[:, :3].T + m[:, 3]


def transform_dirs(mat4, dirs):
    """Apply the linear part of a (4, 4) matrix to (..., 3) directions."""
    return dirs @ _linear(mat4, dirs)[:, :3].T


def normal_matrix(mat4: np.ndarray) -> np.ndarray:
    """Inverse-transpose of the linear part, for transforming normals."""
    lin = np.asarray(mat4, dtype=np.float64)[:3, :3]
    return np.linalg.inv(lin).T.astype(np.float32)


def quat_to_matrix(q) -> np.ndarray:
    """Unity quaternion (x, y, z, w) -> 3x3 rotation matrix (numpy)."""
    x, y, z, w = [float(v) for v in q]
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def trs_from_quat(translation=(0, 0, 0), quaternion=(0, 0, 0, 1),
                  scale=(1, 1, 1)) -> np.ndarray:
    """Unity-style TRS local-to-world from a quaternion rotation."""
    sx, sy, sz = (scale, scale, scale) if np.isscalar(scale) else scale
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = quat_to_matrix(quaternion) @ np.diag([sx, sy, sz])
    m[:3, 3] = translation
    return m.astype(np.float32)


def trs_matrix(translation=(0, 0, 0), rotation_deg=(0, 0, 0),
               scale=(1, 1, 1)) -> np.ndarray:
    """Unity-style TRS local-to-world matrix (numpy, host-side).

    Rotation is Unity euler order: Z then X then Y (extrinsic), angles in
    degrees, left-handed axes.
    """
    tx, ty, tz = translation
    sx, sy, sz = (scale, scale, scale) if np.isscalar(scale) else scale
    rx, ry, rz = [np.deg2rad(a) for a in rotation_deg]

    cz, sz_ = np.cos(rz), np.sin(rz)
    cx, sx_ = np.cos(rx), np.sin(rx)
    cy, sy_ = np.cos(ry), np.sin(ry)
    # Unity: R = Ry @ Rx @ Rz (applied to column vectors), left-handed.
    Rz = np.array([[cz, -sz_, 0], [sz_, cz, 0], [0, 0, 1]])
    Rx = np.array([[1, 0, 0], [0, cx, -sx_], [0, sx_, cx]])
    Ry = np.array([[cy, 0, sy_], [0, 1, 0], [-sy_, 0, cy]])
    R = Ry @ Rx @ Rz

    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = R @ np.diag([sx, sy, sz])
    m[:3, 3] = (tx, ty, tz)
    return m.astype(np.float32)
