"""Scene model: SoA dataclasses + a host-side builder.

The port of the JAX package's ``scene.py``. The builder and every array it
makes are numpy, exactly as in the JAX package (geometry pre-transformed to
world space, the RGBE sky baked once); the dataclasses replace flax pytrees.
``Scene.to(device)`` uploads every leaf as a torch tensor — the packed RGBE
plane travels as int32 bit patterns, since torch's uint32 support is thin.
``scene_from_numpy`` rebuilds a Scene from the JAX Scene's leaves.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .utils.math3d import normal_matrix

# RayTraceObject.cs:12-15 defaults.
DEFAULT_ALBEDO = (0.0, 0.4, 1.0)
DEFAULT_SPECULAR = (0.7, 0.0, 1.0)
DEFAULT_EMISSION = (0.0, 0.0, 0.0)
DEFAULT_SMOOTHNESS = 0.69

# Hard-coded ground material, RayTraceShader.compute:167-170.
GROUND_ALBEDO = (0.5, 0.3, 0.15)
GROUND_SPECULAR = (0.0, 0.0, 0.0)
GROUND_SMOOTHNESS = 0.3
GROUND_EMISSION = (0.0, 0.0, 0.0)


def _to_tensor(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device).contiguous()
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def tree_map(fn, obj):
    """Apply ``fn`` to every array leaf of a (nested) dataclass; None stays."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return fn(obj)


def tree_to(obj, device):
    """Upload every leaf of a dataclass tree to ``device`` as tensors."""
    return tree_map(lambda a: _to_tensor(a, device), obj)


class Replaceable:
    """``replace(**kw)``, the copy with fields changed that the JAX
    package's ``flax.struct.dataclass`` types carry; mixed into the port's
    dataclasses of the same names."""

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass
class Material:
    """Host-side material description (RayTraceParams analog)."""

    albedo: Sequence[float] = DEFAULT_ALBEDO
    specular: Sequence[float] = DEFAULT_SPECULAR
    emission: Sequence[float] = DEFAULT_EMISSION
    smoothness: float = DEFAULT_SMOOTHNESS


GROUND_MATERIAL = Material(GROUND_ALBEDO, GROUND_SPECULAR, GROUND_EMISSION,
                           GROUND_SMOOTHNESS)


@dataclasses.dataclass
class Materials(Replaceable):
    """SoA material table."""

    albedo: object      # (M, 3)
    specular: object    # (M, 3)
    emission: object    # (M, 3)
    smoothness: object  # (M,)

    @property
    def count(self) -> int:
        return self.albedo.shape[0]

    def take(self, idx):
        """Gather per-ray material params by index array."""
        return (self.albedo[idx], self.specular[idx], self.emission[idx],
                self.smoothness[idx])

    @staticmethod
    def from_list(mats: Sequence[Material]) -> "Materials":
        if not mats:
            mats = [Material()]
        return Materials(
            albedo=np.asarray([m.albedo for m in mats], np.float32),
            specular=np.asarray([m.specular for m in mats], np.float32),
            emission=np.asarray([m.emission for m in mats], np.float32),
            smoothness=np.asarray([m.smoothness for m in mats], np.float32),
        )


@dataclasses.dataclass
class Spheres(Replaceable):
    """SoA sphere set."""

    center: object       # (S, 3)
    radius: object       # (S,)
    material_id: object  # (S,) int32 into scene materials

    @property
    def count(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass
class Triangles(Replaceable):
    """World-space SoA triangle soup with smooth vertex normals."""

    v0: object           # (T, 3)
    v1: object
    v2: object
    n0: object           # (T, 3) unit vertex normals (world space)
    n1: object
    n2: object
    material_id: object  # (T,) int32

    @property
    def count(self) -> int:
        return self.v0.shape[0]


@dataclasses.dataclass
class Scene(Replaceable):
    """Complete render-ready scene (numpy leaves after build, torch tensors
    after ``to``)."""

    spheres: Spheres
    triangles: Triangles
    materials: Materials
    ground_enabled: object      # () float32 0/1 mask (built-in plane y=0)
    ground_material_id: object  # () int32
    skybox: object              # (Hs, Ws, 3) float32 equirect, row 0 = +y
    skybox_rgbe: object = None  # (Hs*Ws,) packed RGBE words

    @property
    def num_spheres(self) -> int:
        return self.spheres.count

    @property
    def num_triangles(self) -> int:
        return self.triangles.count

    def to(self, device) -> "Scene":
        """Every leaf as a torch tensor on ``device``."""
        return tree_to(self, device)


_SCENE_KEYS = (
    [f"spheres.{k}" for k in ("center", "radius", "material_id")]
    + [f"triangles.{k}" for k in ("v0", "v1", "v2", "n0", "n1", "n2",
                                  "material_id")]
    + [f"materials.{k}" for k in ("albedo", "specular", "emission",
                                  "smoothness")]
    + ["ground_enabled", "ground_material_id", "skybox", "skybox_rgbe"])


def scene_to_numpy(scene: Scene) -> dict:
    """Flat ``{"spheres.center": array, ...}`` dict of a scene's leaves."""
    out = {}
    for k in _SCENE_KEYS:
        obj = scene
        for part in k.split("."):
            obj = getattr(obj, part)
        if isinstance(obj, torch.Tensor):
            obj = obj.cpu().numpy()
        if obj is not None:
            out[k] = np.asarray(obj)
    return out


def scene_from_numpy(d) -> Scene:
    """Build a Scene from numpy leaves keyed as ``scene_to_numpy`` writes
    them (the JAX Scene's field paths). ``skybox_rgbe`` may be absent, and
    is re-baked from ``skybox`` then."""
    g = {k: np.asarray(d[k]) for k in _SCENE_KEYS if k in d}
    f32 = lambda k: g[k].astype(np.float32)  # noqa: E731
    i32 = lambda k: g[k].astype(np.int32)    # noqa: E731
    from .ops.shade import pack_rgbe_np
    rgbe = g.get("skybox_rgbe")
    return Scene(
        spheres=Spheres(center=f32("spheres.center"),
                        radius=f32("spheres.radius"),
                        material_id=i32("spheres.material_id")),
        triangles=Triangles(**{k: f32(f"triangles.{k}")
                               for k in ("v0", "v1", "v2", "n0", "n1", "n2")},
                            material_id=i32("triangles.material_id")),
        materials=Materials(**{k: f32(f"materials.{k}")
                               for k in ("albedo", "specular", "emission",
                                         "smoothness")}),
        ground_enabled=np.float32(g["ground_enabled"]),
        ground_material_id=np.int32(g["ground_material_id"]),
        skybox=f32("skybox"),
        skybox_rgbe=(rgbe.astype(np.uint32) if rgbe is not None
                     else pack_rgbe_np(f32("skybox"))),
    )


def compute_smooth_normals(vertices: np.ndarray, indices: np.ndarray,
                           weld_decimals: int = 5) -> np.ndarray:
    """Area-weighted smooth vertex normals with positional welding."""
    vertices = np.asarray(vertices, np.float64)
    indices = np.asarray(indices, np.int64).reshape(-1, 3)
    key = np.round(vertices, weld_decimals)
    _, weld_ids = np.unique(key, axis=0, return_inverse=True)
    weld_ids = weld_ids.reshape(-1)

    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    face_n = np.cross(vertices[i1] - vertices[i0], vertices[i2] - vertices[i0])
    acc = np.zeros((weld_ids.max() + 1 if len(weld_ids) else 1, 3), np.float64)
    for col in (i0, i1, i2):
        np.add.at(acc, weld_ids[col], face_n)
    n = acc[weld_ids]
    lens = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(lens > 1e-20, n / np.maximum(lens, 1e-20),
                 np.array([0.0, 1.0, 0.0]))
    return n.astype(np.float32)


class SceneBuilder:
    """Host-side scene registry: add objects, then ``build()`` flattens them
    into a Scene of numpy arrays, equal to the JAX package's builder's."""

    def __init__(self):
        self._sphere_centers: List = []
        self._sphere_radii: List = []
        self._sphere_mats: List[int] = []
        self._tri_v: List[np.ndarray] = []
        self._tri_n: List[np.ndarray] = []
        self._tri_mat_ids: List[np.ndarray] = []
        self._materials: List[Material] = []
        self._sphere_removed = set()
        self._mesh_removed = set()
        self._ground = True
        self._skybox: Optional[np.ndarray] = None
        self.last_handle = None
        self.dirty = True

    def _add_material(self, mat: Optional[Material]) -> int:
        self._materials.append(mat or Material())
        return len(self._materials) - 1

    def add_sphere(self, center, radius: float,
                   material: Optional[Material] = None) -> "SceneBuilder":
        mid = self._add_material(material)
        self._sphere_centers.append(np.asarray(center, np.float32))
        self._sphere_radii.append(np.float32(radius))
        self._sphere_mats.append(mid)
        self.last_handle = ("sphere", len(self._sphere_centers) - 1)
        self.dirty = True
        return self

    def add_mesh(self, vertices, indices, transform: Optional[np.ndarray] = None,
                 material: Optional[Material] = None,
                 normals: Optional[np.ndarray] = None) -> "SceneBuilder":
        """Register a triangle mesh: (V, 3) object-space vertices, (F, 3)
        indices, optional (4, 4) local-to-world TRS and (V, 3) normals."""
        vertices = np.asarray(vertices, np.float32)
        indices = np.asarray(indices, np.int64).reshape(-1, 3)
        if normals is None:
            normals = compute_smooth_normals(vertices, indices)
        else:
            normals = np.asarray(normals, np.float32)

        if transform is not None:
            transform = np.asarray(transform, np.float64)
            vertices = (vertices @ transform[:3, :3].T
                        + transform[:3, 3]).astype(np.float32)
            nmat = normal_matrix(transform)
            normals = normals @ nmat.T
            lens = np.linalg.norm(normals, axis=1, keepdims=True)
            normals = (normals / np.maximum(lens, 1e-20)).astype(np.float32)

        mid = self._add_material(material)
        tri_v = vertices[indices]
        tri_n = normals[indices]
        # A mirroring transform flips winding so the backface cull still
        # accepts front faces.
        if transform is not None and np.linalg.det(np.asarray(transform)[:3, :3]) < 0:
            tri_v = tri_v[:, ::-1, :]
            tri_n = tri_n[:, ::-1, :]
        self._tri_v.append(tri_v)
        self._tri_n.append(tri_n)
        self._tri_mat_ids.append(np.full((len(indices),), mid, np.int32))
        self.last_handle = ("mesh", len(self._tri_v) - 1)
        self.dirty = True
        return self

    def add_obj(self, path, transform: Optional[np.ndarray] = None,
                material: Optional[Material] = None) -> "SceneBuilder":
        """Register a Wavefront OBJ, honoring its .mtl materials.

        Faces are grouped by usemtl material and each group is registered as
        its own mesh (the framework is one-material-per-mesh, matching the
        reference's per-object material, RayTraceMaster.cs:86). ``material``
        overrides everything when given (and for faces with no usemtl).
        Returns self; ``last_handle`` is the LAST group's handle.
        """
        from .models.obj import load_obj_with_materials

        verts, faces, normals, face_mat, mats = load_obj_with_materials(path)
        used = np.unique(face_mat) if len(face_mat) else np.array([0])
        for mid in used:
            group = faces[face_mat == mid] if len(face_mat) else faces
            if not len(group):
                continue
            mat = material if material is not None else mats[mid]
            self.add_mesh(verts, group, transform=transform, material=mat,
                          normals=normals)
        return self

    def remove(self, handle) -> "SceneBuilder":
        """Unregister an object by the handle add_sphere/add_mesh set."""
        kind, idx = handle
        (self._sphere_removed if kind == "sphere"
         else self._mesh_removed).add(idx)
        self.dirty = True
        return self

    def set_ground(self, enabled: bool = True) -> "SceneBuilder":
        self._ground = enabled
        self.dirty = True
        return self

    def set_skybox(self, equirect: np.ndarray) -> "SceneBuilder":
        """Set the environment map: (H, W, 3) float, row 0 = +y pole."""
        self._skybox = np.asarray(equirect, np.float32)
        self.dirty = True
        return self

    def build(self, pad_triangles_to: Optional[int] = None) -> Scene:
        """Flatten registrations into a static-shape Scene (numpy leaves)."""
        mats = list(self._materials)
        ground_mid = len(mats)
        mats.append(GROUND_MATERIAL)
        materials = Materials.from_list(mats)

        keep_s = [i for i in range(len(self._sphere_centers))
                  if i not in self._sphere_removed]
        if keep_s:
            spheres = Spheres(
                center=np.stack([self._sphere_centers[i] for i in keep_s]
                                ).astype(np.float32),
                radius=np.stack([self._sphere_radii[i] for i in keep_s]
                                ).astype(np.float32),
                material_id=np.asarray([self._sphere_mats[i] for i in keep_s],
                                       np.int32))
        else:
            spheres = Spheres(center=np.zeros((0, 3), np.float32),
                              radius=np.zeros((0,), np.float32),
                              material_id=np.zeros((0,), np.int32))

        keep_m = [i for i in range(len(self._tri_v))
                  if i not in self._mesh_removed]
        if keep_m:
            tv = np.concatenate([self._tri_v[i] for i in keep_m], axis=0)
            tn = np.concatenate([self._tri_n[i] for i in keep_m], axis=0)
            tm = np.concatenate([self._tri_mat_ids[i] for i in keep_m], axis=0)
        else:
            tv = np.zeros((0, 3, 3), np.float32)
            tn = np.zeros((0, 3, 3), np.float32)
            tm = np.zeros((0,), np.int32)

        n_tris = len(tv)
        target = pad_triangles_to if pad_triangles_to is not None else n_tris
        if target < n_tris:
            raise ValueError(f"pad_triangles_to={target} < triangle count {n_tris}")
        if target > n_tris:
            # Degenerate (zero-area) padding: MT97 det == 0 -> guaranteed miss.
            pad = target - n_tris
            tv = np.concatenate([tv, np.zeros((pad, 3, 3), np.float32)], axis=0)
            tn = np.concatenate([tn, np.tile(np.array([[0, 1, 0]], np.float32),
                                             (pad * 3, 1)).reshape(pad, 3, 3)],
                                axis=0)
            tm = np.concatenate([tm, np.zeros((pad,), np.int32)], axis=0)

        triangles = Triangles(
            v0=np.ascontiguousarray(tv[:, 0]), v1=np.ascontiguousarray(tv[:, 1]),
            v2=np.ascontiguousarray(tv[:, 2]),
            n0=np.ascontiguousarray(tn[:, 0]), n1=np.ascontiguousarray(tn[:, 1]),
            n2=np.ascontiguousarray(tn[:, 2]),
            material_id=np.asarray(tm, np.int32))

        skybox = (np.zeros((2, 4, 3), np.float32) if self._skybox is None
                  else np.asarray(self._skybox, np.float32))

        from .ops.shade import pack_rgbe_np

        self.dirty = False
        return Scene(
            spheres=spheres,
            triangles=triangles,
            materials=materials,
            ground_enabled=np.float32(1.0 if self._ground else 0.0),
            ground_material_id=np.int32(ground_mid),
            skybox=skybox,
            skybox_rgbe=pack_rgbe_np(skybox),
        )
