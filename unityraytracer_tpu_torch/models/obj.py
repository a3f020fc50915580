"""Wavefront OBJ mesh loader (positions, normals, triangulated faces).

The reference gets meshes from Unity's asset pipeline (built-in primitives in
the demo scenes; SURVEY.md 2.3). A standalone framework needs its own mesh
ingestion: this loader handles the common OBJ subset — v/vn/f records,
polygon faces (fan-triangulated), and the f v//vn and f v/vt/vn index forms —
and returns arrays ready for ``SceneBuilder.add_mesh``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_obj(path_or_lines) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Parse an OBJ file.

    Args:
      path_or_lines: filesystem path, or an iterable of lines (for tests).

    Returns:
      (vertices (V,3) f32, faces (F,3) i32, normals (V,3) f32 or None).
      Normals are returned only if every face supplies vn indices; they are
      re-indexed onto positions (last-writer-wins per position, which matches
      smooth-shaded exports; faceted exports should recompute).
    """
    if isinstance(path_or_lines, str):
        with open(path_or_lines, "r") as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)

    positions = []
    normals_raw = []
    face_pos = []
    face_nrm = []
    any_missing_nrm = False

    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            positions.append([float(x) for x in parts[1:4]])
        elif tag == "vn":
            normals_raw.append([float(x) for x in parts[1:4]])
        elif tag == "f":
            corners = []
            for token in parts[1:]:
                fields = token.split("/")
                vi = int(fields[0])
                ni = None
                if len(fields) == 3 and fields[2]:
                    ni = int(fields[2])
                corners.append((vi, ni))
            # Fan triangulation for polygons.
            for k in range(1, len(corners) - 1):
                tri = (corners[0], corners[k], corners[k + 1])
                face_pos.append([c[0] for c in tri])
                face_nrm.append([c[1] for c in tri])
                if any(c[1] is None for c in tri):
                    any_missing_nrm = True

    V = len(positions)
    verts = np.asarray(positions, np.float32)

    def resolve(idx, count):
        # OBJ indices are 1-based; negative counts from the end.
        return idx - 1 if idx > 0 else count + idx

    faces = np.asarray([[resolve(i, V) for i in f] for f in face_pos], np.int32)

    normals = None
    if normals_raw and not any_missing_nrm and len(face_nrm):
        nr = np.asarray(normals_raw, np.float32)
        normals = np.zeros((V, 3), np.float32)
        for f_p, f_n in zip(faces, face_nrm):
            for vi, ni in zip(f_p, f_n):
                normals[vi] = nr[resolve(ni, len(nr))]
        lens = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = np.where(lens > 1e-12, normals / np.maximum(lens, 1e-12),
                           np.array([0, 1, 0], np.float32))
    return verts, faces, normals


def load_mtl(path_or_lines) -> dict:
    """Parse a Wavefront .mtl library into {name: Material}.

    Mapping onto the reference's RayTraceParams (RayTraceMaster.cs:48-53):
    Kd -> albedo, Ks -> specular, Ke -> emission, and Ns (Phong shininess,
    0..1000) inverted through the reference's lobe model alpha = 1000^(s^2)
    (RayTraceShader.compute:401) -> smoothness = sqrt(log_1000(Ns)).
    """
    from ..scene import Material

    if isinstance(path_or_lines, str):
        with open(path_or_lines, "r") as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)

    mats = {}
    cur = None

    def f3(parts):
        return tuple(float(x) for x in parts[:3])

    for line in lines:
        parts = line.strip().split()
        if not parts or parts[0].startswith("#"):
            continue
        tag = parts[0]
        if tag == "newmtl":
            cur = dict(albedo=(0.8, 0.8, 0.8), specular=(0.0, 0.0, 0.0),
                       emission=(0.0, 0.0, 0.0), smoothness=0.0)
            mats[parts[1]] = cur
        elif cur is None:
            continue
        elif tag == "Kd":
            cur["albedo"] = f3(parts[1:])
        elif tag == "Ks":
            cur["specular"] = f3(parts[1:])
        elif tag == "Ke":
            cur["emission"] = f3(parts[1:])
        elif tag == "Ns":
            ns = max(float(parts[1]), 1.0)
            cur["smoothness"] = float(
                np.clip(np.sqrt(np.log(ns) / np.log(1000.0)), 0.0, 1.0))
    return {name: Material(**kw) for name, kw in mats.items()}


def load_obj_with_materials(path_or_lines, mtl_loader=None):
    """Parse an OBJ with mtllib/usemtl records.

    Returns (vertices, faces, normals, face_material_ids, materials):
    ``face_material_ids`` is (F,) int32 into ``materials`` (a list of
    Material; index 0 is the default for faces before any usemtl).
    ``mtl_loader`` overrides .mtl resolution (for tests); default resolves
    mtllib paths relative to the OBJ file.
    """
    import os

    from ..scene import Material

    if isinstance(path_or_lines, str):
        base = os.path.dirname(os.path.abspath(path_or_lines))
        with open(path_or_lines, "r") as f:
            lines = f.readlines()
    else:
        base = "."
        lines = list(path_or_lines)

    if mtl_loader is None:
        def mtl_loader(name):
            p = os.path.join(base, name)
            return load_mtl(p) if os.path.exists(p) else {}

    mat_table = {None: 0}
    materials = [Material()]
    lib = {}
    cur_id = 0
    face_mat = []
    body = []
    for line in lines:
        parts = line.strip().split()
        if not parts:
            body.append(line)
            continue
        if parts[0] == "mtllib":
            lib.update(mtl_loader(" ".join(parts[1:])))
        elif parts[0] == "usemtl":
            name = parts[1] if len(parts) > 1 else None
            if name not in mat_table:
                mat_table[name] = len(materials)
                materials.append(lib.get(name, Material()))
            cur_id = mat_table[name]
        elif parts[0] == "f":
            n_corners = len(parts) - 1
            face_mat.extend([cur_id] * max(n_corners - 2, 0))  # fan tris
            body.append(line)
        else:
            body.append(line)

    verts, faces, normals = load_obj(body)
    return (verts, faces, normals,
            np.asarray(face_mat, np.int32), materials)


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray,
             normals: Optional[np.ndarray] = None) -> str:
    """Write a minimal OBJ (debug/export utility)."""
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if normals is not None:
            for n in np.asarray(normals):
                f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        for face in np.asarray(faces):
            if normals is not None:
                f.write("f " + " ".join(f"{i+1}//{i+1}" for i in face) + "\n")
            else:
                f.write("f " + " ".join(str(i + 1) for i in face) + "\n")
    return path
