"""Camera model and primary-ray generation (PyTorch port).

The port of the JAX package's ``camera.py``: a cam-to-world rigid transform
plus the field-of-view tangent, extended with a thin lens. The camera holds
float32 numpy values (host state, like the scene builders); ray generation
moves them to the rays' device as float32 scalars, so every product rounds
as it does in the JAX package.

Conventions match the Unity scenes: left-handed, +y up, camera forward +z.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops import vec


@dataclasses.dataclass
class Camera:
    """Pinhole/thin-lens camera.

    Attributes:
      cam_to_world: (4,4) float32 rigid transform; rotation columns are
        (right, up, forward).
      tan_half_fov: tan(vertical_fov / 2).
      aspect: width / height.
      aperture: lens radius; 0 disables depth of field.
      focus_dist: focal plane distance along forward.
    """

    cam_to_world: np.ndarray
    tan_half_fov: np.float32
    aspect: np.float32
    aperture: np.float32
    focus_dist: np.float32

    @staticmethod
    def create(position=(0.0, 0.0, 0.0), look_at=None, forward=None,
               up=(0.0, 1.0, 0.0), fov_y_deg: float = 60.0, aspect: float = 1.0,
               aperture: float = 0.0, focus_dist: float = 1.0,
               cam_to_world=None) -> "Camera":
        """Provide look_at/forward or a full matrix."""
        if cam_to_world is None:
            pos = np.asarray(position, np.float64)
            if forward is None:
                tgt = np.asarray(
                    look_at if look_at is not None else pos + np.array([0, 0, 1.0]),
                    np.float64)
                fwd = tgt - pos
            else:
                fwd = np.asarray(forward, np.float64)
            fwd = fwd / np.linalg.norm(fwd)
            upv = np.asarray(up, np.float64)
            right = np.cross(upv, fwd)        # left-handed: right = up x fwd
            right = right / np.linalg.norm(right)
            upv = np.cross(fwd, right)
            m = np.eye(4, dtype=np.float64)
            m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, upv, fwd, pos
            cam_to_world = m
        return Camera(
            cam_to_world=np.asarray(cam_to_world, np.float32),
            tan_half_fov=np.float32(np.tan(np.deg2rad(fov_y_deg) / 2.0)),
            aspect=np.float32(aspect),
            aperture=np.float32(aperture),
            focus_dist=np.float32(focus_dist),
        )

    @property
    def position(self):
        return self.cam_to_world[:3, 3]


def camera_from_numpy(d) -> Camera:
    """Camera from the JAX Camera's leaves as numpy arrays (a mapping with
    keys cam_to_world, tan_half_fov, aspect, aperture, focus_dist)."""
    return Camera(cam_to_world=np.asarray(d["cam_to_world"], np.float32),
                  **{k: np.float32(d[k]) for k in
                     ("tan_half_fov", "aspect", "aperture", "focus_dist")})


def camera_rays_soa(camera: Camera, u, v, lens_u=None, lens_v=None):
    """World-space rays for NDC coordinates, component-SoA.

    Args:
      camera: Camera.
      u, v: (N,) float32 NDC coords in [-1, 1] (x right, y up), jittered by
        the caller.
      lens_u, lens_v: optional (N,) unit-disk samples for thin-lens DoF.

    Returns:
      (origin, direction): two 3-tuples of (N,) tensors, unit directions.
    """
    def f32(x):
        # A float32 0-d tensor on the host: it rounds as the JAX package's
        # float32 scalars do, and enters device ops as an argument, never
        # as an upload that would wait for the device.
        return torch.tensor(np.float32(x))

    m = [[f32(camera.cam_to_world[r, c]) for c in range(4)] for r in range(4)]
    thf = f32(camera.tan_half_fov)
    dx = u * (thf * f32(camera.aspect))
    dy = v * thf
    d = (m[0][0] * dx + m[0][1] * dy + m[0][2],
         m[1][0] * dx + m[1][1] * dy + m[1][2],
         m[2][0] * dx + m[2][1] * dy + m[2][2])
    d = vec.normalize(d)
    o = tuple(torch.full_like(d[0], float(m[k][3])) for k in range(3))

    if lens_u is not None:
        # Thin lens: offset the origin on the lens disk, refocus on the plane
        # perpendicular to forward at depth focus_dist.
        fwd = (m[0][2], m[1][2], m[2][2])
        cos_fwd = vec.dot(d, fwd)
        focus_t = f32(camera.focus_dist) / torch.clamp_min(cos_fwd, 1e-6)
        focal = vec.add(o, vec.scale(d, focus_t))
        lu = lens_u * f32(camera.aperture)
        lv = lens_v * f32(camera.aperture)
        o = (o[0] + m[0][0] * lu + m[0][1] * lv,
             o[1] + m[1][0] * lu + m[1][1] * lv,
             o[2] + m[2][0] * lu + m[2][1] * lv)
        d = vec.normalize(vec.sub(focal, o))
    return o, d
