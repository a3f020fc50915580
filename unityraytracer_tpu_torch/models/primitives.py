"""Procedural primitive meshes (Unity built-in mesh analogs).

The reference scenes use Unity's built-in Quad, Cube, Cylinder, Capsule and
Sphere meshes (`Assets/Scenes/Scene1.unity`: 6 mesh objects; SURVEY.md 2.3).
These generators reproduce those shapes (unit-scaled like Unity's: quad 1x1,
cube 1x1x1, sphere diameter 1, cylinder height 2 radius 0.5, capsule height 2
radius 0.5) in object space, winding chosen so outward faces survive the
backface cull (det >= EPS for front faces, RayTraceShader.compute:211).

All return ``(vertices (V,3) f32, indices (F,3) i32, normals (V,3) f32)``.
"""

from __future__ import annotations

import numpy as np


def _pack(verts, faces, normals):
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
            np.asarray(normals, np.float32))


def _fix_winding(verts, faces, normals):
    """Flip faces whose geometric normal opposes the average vertex normal.

    Guarantees front faces have cross(e1, e2) aligned with the outward vertex
    normals, which in a left-handed world with MT97's det>=0 cull means the
    outside is visible.
    """
    v = verts[faces]
    gn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    an = normals[faces].mean(axis=1)
    flip = np.sum(gn * an, axis=1) < 0
    faces = faces.copy()
    faces[flip] = faces[flip][:, ::-1]
    return faces


def quad():
    """Unity Quad: 1x1 in the XY plane, facing -z (visible from -z side)."""
    verts = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0],
                      [-0.5, 0.5, 0], [0.5, 0.5, 0]], np.float32)
    normals = np.tile(np.array([[0, 0, -1]], np.float32), (4, 1))
    faces = np.array([[0, 2, 1], [2, 3, 1]], np.int32)
    faces = _fix_winding(verts, faces, normals)
    return _pack(verts, faces, normals)


def cube():
    """Unity Cube: axis-aligned unit cube, flat per-face normals."""
    verts, normals, faces = [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3)
            n[axis] = sign
            u = np.zeros(3)
            u[(axis + 1) % 3] = 1.0
            v = np.cross(n, u)
            base = len(verts)
            for du, dv in ((-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5)):
                verts.append(n * 0.5 + u * du + v * dv)
                normals.append(n)
            faces.append([base, base + 1, base + 2])
            faces.append([base, base + 2, base + 3])
    verts = np.asarray(verts, np.float32)
    normals = np.asarray(normals, np.float32)
    faces = _fix_winding(verts, np.asarray(faces, np.int32), normals)
    return _pack(verts, faces, normals)


def uv_sphere(rings: int = 16, segments: int = 24, radius: float = 0.5):
    """Latitude/longitude sphere (Unity's built-in Sphere is 0.5 radius)."""
    verts, normals = [], []
    for r in range(rings + 1):
        theta = np.pi * r / rings
        for s in range(segments + 1):
            phi = 2 * np.pi * s / segments
            n = np.array([np.sin(theta) * np.cos(phi), np.cos(theta),
                          np.sin(theta) * np.sin(phi)])
            verts.append(n * radius)
            normals.append(n)
    faces = []
    stride = segments + 1
    for r in range(rings):
        for s in range(segments):
            a = r * stride + s
            b = a + stride
            if r != 0:
                faces.append([a, b, a + 1])
            if r != rings - 1:
                faces.append([a + 1, b, b + 1])
    verts = np.asarray(verts, np.float32)
    normals = np.asarray(normals, np.float32)
    faces = _fix_winding(verts, np.asarray(faces, np.int32), normals)
    return _pack(verts, faces, normals)


def icosphere(subdivisions: int = 2, radius: float = 0.5):
    """Geodesic sphere by icosahedron subdivision (uniform triangle areas —
    the preferred bench geometry: tri count = 20 * 4^subdivisions)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ]
    verts = list(verts)
    for _ in range(subdivisions):
        cache = {}
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                m /= np.linalg.norm(m)
                verts.append(m)
                cache[key] = len(verts) - 1
            return cache[key]

        for f in faces:
            a, b, c = f
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = new_faces
    verts = np.asarray(verts, np.float64)
    normals = verts.copy()
    verts = verts * radius
    faces = _fix_winding(verts.astype(np.float32), np.asarray(faces, np.int32),
                         normals.astype(np.float32))
    return _pack(verts, faces, normals)


def cylinder(segments: int = 24, radius: float = 0.5, height: float = 2.0):
    """Unity Cylinder: radius 0.5, height 2, y axis, capped."""
    hh = height / 2.0
    verts, normals, faces = [], [], []
    # Side wall (smooth normals).
    for s in range(segments + 1):
        phi = 2 * np.pi * s / segments
        n = np.array([np.cos(phi), 0.0, np.sin(phi)])
        verts += [n * radius + [0, -hh, 0], n * radius + [0, hh, 0]]
        normals += [n, n]
    for s in range(segments):
        a = 2 * s
        faces += [[a, a + 1, a + 2], [a + 1, a + 3, a + 2]]
    # Caps (flat normals, fan).
    for sign in (-1.0, 1.0):
        n = np.array([0.0, sign, 0.0])
        center = len(verts)
        verts.append(np.array([0.0, sign * hh, 0.0]))
        normals.append(n)
        ring0 = len(verts)
        for s in range(segments + 1):
            phi = 2 * np.pi * s / segments
            verts.append(np.array([np.cos(phi) * radius, sign * hh,
                                   np.sin(phi) * radius]))
            normals.append(n)
        for s in range(segments):
            faces.append([center, ring0 + s, ring0 + s + 1])
    verts = np.asarray(verts, np.float32)
    normals = np.asarray(normals, np.float32)
    faces = _fix_winding(verts, np.asarray(faces, np.int32), normals)
    return _pack(verts, faces, normals)


def capsule(segments: int = 24, rings: int = 8, radius: float = 0.5,
            height: float = 2.0):
    """Unity Capsule: total height 2, radius 0.5 (cylinder + hemisphere ends)."""
    cyl_h = max(height - 2 * radius, 0.0)
    hh = cyl_h / 2.0
    verts, normals = [], []
    rows = []
    # Top hemisphere (pole down to equator), shifted +hh.
    for r in range(rings + 1):
        theta = (np.pi / 2) * r / rings
        row = []
        for s in range(segments + 1):
            phi = 2 * np.pi * s / segments
            n = np.array([np.sin(theta) * np.cos(phi), np.cos(theta),
                          np.sin(theta) * np.sin(phi)])
            row.append(len(verts))
            verts.append(n * radius + [0, hh, 0])
            normals.append(n)
        rows.append(row)
    # Bottom hemisphere (equator to pole), shifted -hh.
    for r in range(rings + 1):
        theta = (np.pi / 2) + (np.pi / 2) * r / rings
        row = []
        for s in range(segments + 1):
            phi = 2 * np.pi * s / segments
            n = np.array([np.sin(theta) * np.cos(phi), np.cos(theta),
                          np.sin(theta) * np.sin(phi)])
            row.append(len(verts))
            verts.append(n * radius + [0, -hh, 0])
            normals.append(n)
        rows.append(row)
    faces = []
    for r in range(len(rows) - 1):
        for s in range(segments):
            a, b = rows[r][s], rows[r][s + 1]
            c, d = rows[r + 1][s], rows[r + 1][s + 1]
            faces += [[a, b, c], [b, d, c]]
    verts = np.asarray(verts, np.float32)
    normals = np.asarray(normals, np.float32)
    faces = _fix_winding(verts, np.asarray(faces, np.int32), normals)
    return _pack(verts, faces, normals)


def plane(size: float = 10.0, divisions: int = 1):
    """Unity Plane: 10x10 in XZ facing +y."""
    n_side = divisions + 1
    xs = np.linspace(-size / 2, size / 2, n_side)
    zs = np.linspace(-size / 2, size / 2, n_side)
    gx, gz = np.meshgrid(xs, zs, indexing="xy")
    verts = np.stack([gx.ravel(), np.zeros(gx.size), gz.ravel()], axis=1)
    normals = np.tile(np.array([[0, 1, 0]], np.float32), (len(verts), 1))
    faces = []
    for r in range(divisions):
        for c in range(divisions):
            a = r * n_side + c
            b = a + 1
            d = a + n_side
            e = d + 1
            faces += [[a, b, d], [b, e, d]]
    verts = np.asarray(verts, np.float32)
    faces = _fix_winding(verts, np.asarray(faces, np.int32), normals)
    return _pack(verts, faces, normals)
