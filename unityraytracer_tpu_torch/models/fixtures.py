"""Reference scene fixtures: Scene1 and SampleScene rebuilt from their Unity
YAML data, plus the procedural benchmark scene.

The same objects, transforms, materials and random draws as the JAX
package's ``models/fixtures.py``, so every builder array is equal to its
counterpart's. Skyboxes default to the procedural ``sun_sky``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..camera import Camera
from ..scene import Material, Scene, SceneBuilder
from ..utils.math3d import quat_to_matrix, trs_from_quat, trs_matrix
from . import primitives as P
from .skybox import sun_sky

_DEF = Material()  # RayTraceObject.cs:12-15 defaults

# (name, kind, pos, quat, scale, material) from Scene1.unity.
_SCENE1_OBJECTS = [
    ("Sphere", "sphere", (-3.3, 0.5, -7.24), None, 1.0, _DEF),
    ("Sphere (1)", "sphere", (5.69, 1.0, -2.54), None, 2.0,
     Material(smoothness=0.1)),
    ("Sphere (2)", "sphere", (-0.909, 1.442, -5.19), None, 0.5, _DEF),
    ("Sphere (4)", "sphere", (-1.18, 1.381, -8.26), None, 0.25, _DEF),
    ("Sphere (5)", "sphere", (-0.8, 0.375, -5.37), None, 0.75,
     Material(emission=(0.5283019, 0.0, 0.20791267))),
    ("Sphere (6)", "sphere", (3.49, 0.375, -2.3), None, 0.75, _DEF),
    ("Sphere (7)", "sphere", (5.43, 0.25, -4.7), None, 0.5, _DEF),
    ("Sphere (8)", "sphere", (4.99, 0.375, -6.03), None, 0.75, _DEF),
    ("Quad", "quad", (-8.12, 3.0, 3.94), (0.0, -0.44048756, 0.0, 0.8977587),
     (9.03, 7.09, 1.0),
     Material(albedo=(0.509434, 0.1321645, 0.26990482),
              specular=(0.9433962, 0.78764683, 0.85985345), smoothness=1.0)),
    ("Quad (1)", "quad", (10.47, 3.0, 5.57), (0.0, 0.44048762, 0.0, 0.8977587),
     (9.03, 7.09, 1.0),
     Material(albedo=(1.0, 0.8726415, 0.9190743),
              specular=(0.9433962, 0.78764683, 0.85985345), smoothness=1.0)),
    ("Cylinder", "cylinder", (-3.7, 2.63, -5.57),
     (-0.19411941, 0.34372243, -0.45757997, 0.7967391), (2.0, 1.0, 2.0),
     Material(albedo=(0.07613921, 0.5566038, 0.09271942),
              specular=(0.95880055, 1.0, 0.6084906), smoothness=0.8)),
    ("Capsule", "capsule", (4.56, 2.47, -5.89),
     (0.27786314, -0.08116225, -0.09726531, 0.9522312), (1.0, 1.0, 1.0),
     _DEF),
    ("Cube", "cube", (-1.65, 1.38, -8.68),
     (0.01028319, 0.072073095, 0.140872, 0.98734736), (0.2, 0.2, 0.2),
     Material(albedo=(0.08001069, 0.5849056, 0.083621256),
              specular=(0.23584908, 0.159355, 0.10346209), smoothness=0.9)),
    ("Cube (1)", "cube", (1.33, 1.95, -5.01),
     (-0.5461449, 0.25328946, 0.067721464, 0.795603), (1.12, 2.06, 1.38),
     Material(albedo=(1.0, 0.5330188, 0.5330188), specular=(1.0, 1.0, 1.0),
              smoothness=1.0)),
]

# SampleScene.unity (older serialization: default materials everywhere).
_SAMPLE_OBJECTS = [
    ("Sphere", "sphere", (-83.6, 16.4, 99.3), None, 15.0, _DEF),
    ("Sphere (1)", "sphere", (-66.05, 10.0, 3.2), None, 20.0, _DEF),
    ("Sphere (2)", "sphere", (38.9, 21.3, 3.2), None, 20.0, _DEF),
    ("Cube", "cube", (10.2, 7.5, -19.2), (0.0, -0.1252467, 0.0, 0.99212563),
     (15.0, 15.0, 15.0), _DEF),
    ("Cylinder", "cylinder", (-2.6, 15.9, -10.1),
     (-0.24023405, -0.18736596, 0.17699963, 0.93587005), (20.0, 5.0, 20.0),
     _DEF),
]

_MESH_GEN = {
    "quad": P.quad,
    "cube": P.cube,
    "cylinder": P.cylinder,
    "capsule": P.capsule,
    "sphere_mesh": P.uv_sphere,
}


def _build(objects, skybox) -> Scene:
    b = SceneBuilder()
    for name, kind, pos, quat, scale, mat in objects:
        if kind == "sphere":
            s = scale if np.isscalar(scale) else max(scale)
            # radius = collider.radius(0.5) * max(lossyScale)
            b.add_sphere(pos, 0.5 * s, mat)
        else:
            v, f, n = _MESH_GEN[kind]()
            tf = trs_from_quat(pos, quat or (0, 0, 0, 1),
                               scale if not np.isscalar(scale) else (scale,) * 3)
            b.add_mesh(v, f, transform=tf, material=mat, normals=n)
    b.set_skybox(skybox if skybox is not None else sun_sky())
    return b.build()


def scene1(skybox: Optional[np.ndarray] = None) -> Scene:
    """Main demo scene: 8 spheres + 6 meshes incl. one emissive sphere and two
    mirror quads (Scene1.unity)."""
    return _build(_SCENE1_OBJECTS, skybox)


def scene1_camera(aspect: float) -> Camera:
    # Main Camera: pos (0,1,-10), identity rotation, FOV 81.
    return Camera.create(position=(0, 1, -10), forward=(0, 0, 1),
                         fov_y_deg=81.0, aspect=aspect)


def sample_scene(skybox: Optional[np.ndarray] = None) -> Scene:
    """Quality demo: 3 big spheres + cube + cylinder, default materials
    (SampleScene.unity)."""
    return _build(_SAMPLE_OBJECTS, skybox)


def sample_scene_camera(aspect: float) -> Camera:
    # pos (0,30,-80), x-tilt quaternion (0.08715578,0,0,0.9961947), FOV 60.
    fwd = quat_to_matrix((0.08715578, 0, 0, 0.9961947)) @ np.array([0, 0, 1.0])
    return Camera.create(position=(0, 30, -80), forward=fwd, fov_y_deg=60.0,
                         aspect=aspect)


def bench_scene(n_tris: int = 100_000, seed: int = 0,
                skybox: Optional[np.ndarray] = None) -> Scene:
    """Procedural >=n_tris benchmark scene: a field of icospheres with mixed
    materials over the ground plane."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    v, f, n = P.icosphere(3)  # 1280 tris each
    per = len(f)
    count = max((n_tris + per - 1) // per, 1)
    side = int(np.ceil(np.sqrt(count)))
    i = 0
    for gx in range(side):
        for gz in range(side):
            if i >= count:
                break
            pos = (gx * 2.4 - side * 1.2 + rng.uniform(-0.4, 0.4),
                   0.9 + rng.uniform(0, 1.5),
                   gz * 2.4 - side * 1.2 + rng.uniform(-0.4, 0.4))
            r = rng.uniform(0.5, 1.0)
            emissive = rng.uniform() < 0.04
            mat = Material(
                albedo=tuple(rng.uniform(0.1, 0.9, 3)),
                specular=tuple(rng.uniform(0, 0.6, 3) * (rng.uniform() < 0.4)),
                emission=(tuple(rng.uniform(2, 6, 3)) if emissive else (0, 0, 0)),
                smoothness=float(rng.uniform(0.1, 1.0)),
            )
            b.add_mesh(v, f, transform=trs_matrix(pos, (0, 0, 0), r * 2),
                       material=mat, normals=n)
            i += 1
    b.set_skybox(skybox if skybox is not None else sun_sky())
    return b.build()


def bench_camera(aspect: float) -> Camera:
    """The camera ``bench.py`` renders the bench scene with."""
    return Camera.create(position=(0.0, 14.0, -42.0), look_at=(0.0, 2.0, 0.0),
                         fov_y_deg=60.0, aspect=aspect)
