"""The port's importers against the JAX package's: OBJ/MTL
(``models/obj.py``, ``SceneBuilder.add_obj``), Radiance HDR and the loader
by extension (``models/skybox.py``), and Unity ``.unity`` scenes
(``models/unity_scene.py``, with its own YAML subset parser held to
``yaml.safe_load``).

The importers are host numpy in both packages, so arrays are held equal
exactly and written files byte for byte; the Unity camera and floats to
1e-6."""

import dataclasses

import numpy as np
import pytest

from test_torch_scene import _assert_same, jax_scene_numpy
from unityraytracer_tpu.models import obj as jobj
from unityraytracer_tpu.models import primitives as JP
from unityraytracer_tpu.models import skybox as jsky
from unityraytracer_tpu.models import unity_scene as junity
from unityraytracer_tpu.scene import SceneBuilder as JSceneBuilder
from unityraytracer_tpu_torch import SceneBuilder, scene_to_numpy
from unityraytracer_tpu_torch.models import obj as tobj
from unityraytracer_tpu_torch.models import skybox as tsky
from unityraytracer_tpu_torch.models import unity_scene as tunity

# ---------------------------------------------------------------------------
# OBJ / MTL

OBJ_CASES = {
    "polygon_fan_and_forms": [
        "v 0 0 0", "v 1 0 0", "v 1 1 0", "v 0 1 0",
        "f 1 2 3 4",           # quad -> 2 tris
        "f 1/1 2/2 3/3",       # v/vt form
        "f -4 -3 -2",          # negative indices
    ],
    "normals_all_forms": [
        "# comment", "",
        "v 0 0 0", "v 1 0 0", "v 1 1 0", "v 0 1 0", "v 0.5 0.5 1",
        "vn 0 0 1", "vn 0 1 0", "vn 3 0 0",
        "f 1//1 2//1 3//1 4//1",
        "f 1/7/2 2/8/2 5/9/3",
        "f -1//-1 -2//-2 -3//-3",
    ],
    "pentagon": ["v 0 0 0", "v 2 0 0", "v 3 1 0", "v 1 2 0", "v -1 1 0",
                 "f 1 2 3 4 5"],
}
OBJ_MTL = [
    "mtllib x.mtl",
    "v 0 0 0", "v 1 0 0", "v 1 1 0", "v 0 1 0",
    "f 1 2 3",                 # before any usemtl: material 0
    "usemtl a", "f 1 2 3",
    "usemtl b", "f 1 3 4", "f 1 2 3 4",
    "usemtl a", "f 2 3 4",
    "usemtl nowhere", "f 1 2 4",
]
MTL = ["newmtl red", "Kd 0.8 0.1 0.1", "Ks 0.2 0.2 0.2", "Ke 1.0 2.0 3.0",
       "Ns 1000", "# c", "newmtl dull", "Kd 0.3 0.3 0.3", "Ns 1",
       "newmtl mid", "Ns 31.62", "Ka 1 1 1"]


def _same_arrays(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", sorted(OBJ_CASES))
def test_load_obj_equals_jax(name):
    got, want = tobj.load_obj(OBJ_CASES[name]), jobj.load_obj(OBJ_CASES[name])
    _same_arrays(got, want)
    if name == "polygon_fan_and_forms":
        v, f, n = got
        assert len(v) == 4 and len(f) == 4 and n is None
        assert f.min() >= 0 and f.max() <= 3


def test_load_mtl_equals_jax():
    got, want = tobj.load_mtl(MTL), jobj.load_mtl(MTL)
    assert list(got) == list(want) == ["red", "dull", "mid"]
    for k in want:
        assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k])
    # Ns=1000 -> alpha=1000 -> smoothness 1; Ns=1 -> smoothness 0.
    assert abs(got["red"].smoothness - 1.0) < 1e-6
    assert got["dull"].smoothness == 0.0


def test_load_obj_with_materials_equals_jax():
    from unityraytracer_tpu.scene import Material as JMaterial
    from unityraytracer_tpu_torch import Material

    def lib(cls):
        return {"a": cls(albedo=(1, 0, 0)), "b": cls(albedo=(0, 1, 0))}

    got = tobj.load_obj_with_materials(OBJ_MTL,
                                       mtl_loader=lambda n: lib(Material))
    want = jobj.load_obj_with_materials(OBJ_MTL,
                                        mtl_loader=lambda n: lib(JMaterial))
    _same_arrays(got[:4], want[:4])
    np.testing.assert_array_equal(got[3], [0, 1, 2, 2, 2, 1, 3])
    assert [dataclasses.asdict(m) for m in got[4]] \
        == [dataclasses.asdict(m) for m in want[4]]


@pytest.mark.parametrize("with_normals", [False, True])
def test_save_obj_writes_the_same_bytes(tmp_path, with_normals):
    v, f, n = JP.icosphere(1)
    n = n if with_normals else None
    a = jobj.save_obj(str(tmp_path / "jax.obj"), v, f, n)
    b = tobj.save_obj(str(tmp_path / "port.obj"), v, f, n)
    assert open(a, "rb").read() == open(b, "rb").read()
    _same_arrays(tobj.load_obj(b), jobj.load_obj(a))
    v2, f2, n2 = tobj.load_obj(b)
    np.testing.assert_allclose(v, v2, atol=1e-5)
    np.testing.assert_array_equal(f, f2)
    if with_normals:
        np.testing.assert_allclose(n, n2, atol=1e-5)


def _obj_files(tmp_path):
    (tmp_path / "cube.mtl").write_text(
        "newmtl glow\nKd 0.1 0.2 0.3\nKe 4 5 6\nNs 31.62\n"
        "newmtl matte\nKd 0.5 0.5 0.5\n")
    p = tmp_path / "tri.obj"
    p.write_text(
        "mtllib cube.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nv 1 1 1\n"
        "usemtl glow\nf 1 2 3\n"
        "usemtl missing\nf 1 3 4\n"
        "usemtl matte\nf 2 3 5 4\n")
    return str(p)


@pytest.mark.parametrize("mode", ["mtl", "override", "mirrored"])
def test_add_obj_scene_equals_jax(tmp_path, mode):
    from unityraytracer_tpu.scene import Material as JMaterial
    from unityraytracer_tpu_torch import Material

    path = _obj_files(tmp_path)
    tr = None
    if mode == "mirrored":                 # negative determinant flips winding
        tr = np.diag([-2.0, 1.0, 1.0, 1.0]).astype(np.float32)
        tr[:3, 3] = (1, 2, 3)
    scenes = []
    for Builder, Mat in ((SceneBuilder, Material), (JSceneBuilder, JMaterial)):
        b = Builder()
        mat = Mat(albedo=(0.9, 0.8, 0.7)) if mode == "override" else None
        assert b.add_obj(path, transform=tr, material=mat) is b
        b.set_skybox(np.ones((2, 4, 3), np.float32))
        scenes.append(b.build())
    _assert_same(scene_to_numpy(scenes[0]), jax_scene_numpy(scenes[1]))
    scene = scenes[0]
    assert scene.num_triangles == 4
    if mode == "mtl":
        emis = scene.materials.emission[scene.triangles.material_id]
        assert (np.isclose(emis, (4, 5, 6)).all(axis=1)).sum() == 1


# ---------------------------------------------------------------------------
# Radiance HDR and the loader by extension

def _hdr_images():
    rng = np.random.default_rng(3)
    img = rng.gamma(0.7, 2.0, (12, 20, 3)).astype(np.float32)
    img[0, 0] = 0.0                                   # exponent byte 0
    img[1, 1] = (1000.0, 500.0, 30.0)
    img[2, 2] = (1e-35, 0.0, 0.0)                     # under the 1e-32 floor
    img[3, 3] = (-1.0, 0.5, 0.25)                     # negatives clamp to 0
    return [img, jsky.sun_sky(32, 64), np.zeros((2, 4, 3), np.float32)]


@pytest.mark.parametrize("i", range(3))
def test_float_to_rgbe_and_save_hdr_bytes_equal_jax(tmp_path, i):
    img = _hdr_images()[i]
    rgbe = tsky.float_to_rgbe(img)
    assert rgbe.dtype == np.uint8
    np.testing.assert_array_equal(rgbe, jsky.float_to_rgbe(img))
    a = jsky.save_hdr(str(tmp_path / "jax.hdr"), img)
    b = tsky.save_hdr(str(tmp_path / "port.hdr"), img)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(tsky.load_hdr(b), jsky.load_hdr(a))


def test_hdr_roundtrip_and_rgbe_range(tmp_path):
    img = tsky.sun_sky(32, 64).astype(np.float32)
    back = tsky.load_hdr(tsky.save_hdr(str(tmp_path / "sky.hdr"), img))
    rel = np.abs(back - img) / np.maximum(img, 1e-3)
    assert back.shape == img.shape
    assert np.median(rel) < 0.01 and rel.max() < 0.05
    vals = np.array([[[0, 0, 0], [1000.0, 500.0, 30.0]]], np.float32)
    back = tsky.rgbe_to_float(tsky.float_to_rgbe(vals))
    np.testing.assert_allclose(back[0, 0], 0.0)
    np.testing.assert_allclose(back[0, 1], vals[0, 1], rtol=0.02, atol=4.0)


def _write_hdr(path, H, W, body: bytes):
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {H} +X {W}\n".encode())
        f.write(body)
    return str(path)


def _rle_files(tmp_path):
    """The new-style, old-style and chained-marker RLE files of the JAX
    tests, as (path, image) pairs."""
    out = []
    H, W = 2, 16                                     # new-style scanline RLE
    img = np.zeros((H, W, 3), np.float32)
    img[0, :, 0] = 1.0
    img[1, :, 1] = np.linspace(0.1, 1.0, W)
    rgbe = jsky.float_to_rgbe(img)
    body = b""
    for row in range(H):
        body += bytes([2, 2, (W >> 8) & 0xFF, W & 0xFF])
        for ch in range(4):
            col = rgbe[row, :, ch]
            body += (bytes([128 + W, int(col[0])]) if np.all(col == col[0])
                     else bytes([W]) + bytes(col.tolist()))
    out.append((_write_hdr(tmp_path / "rle.hdr", H, W, body), img))

    H, W = 2, 4                                      # old-style (1,1,1,n)
    img = np.zeros((H, W, 3), np.float32)
    img[0, :] = [2.0, 0.5, 0.25]
    img[1, :] = [[1, 0, 0], [1, 0, 0], [0, 1, 0], [0, 1, 0]]
    rgbe = jsky.float_to_rgbe(img)
    body = (bytes(rgbe[0, 0].tolist()) + bytes([1, 1, 1, 3])
            + bytes(rgbe[1, 0].tolist()) + bytes([1, 1, 1, 1])
            + bytes(rgbe[1, 2].tolist()) + bytes([1, 1, 1, 1]))
    out.append((_write_hdr(tmp_path / "old.hdr", H, W, body), img))

    W2 = 512                                         # chained markers
    img2 = np.broadcast_to(np.float32([0.5, 1.0, 2.0]), (1, W2, 3)).copy()
    px = bytes(jsky.float_to_rgbe(img2)[0, 0].tolist())
    body = px + bytes([1, 1, 1, 255]) + bytes([1, 1, 1, 1])
    out.append((_write_hdr(tmp_path / "chain.hdr", 1, W2, body), img2))
    return out


@pytest.mark.parametrize("i", range(3))
def test_hdr_rle_files_load_equal_to_jax(tmp_path, i):
    path, img = _rle_files(tmp_path)[i]
    got = tsky.load_hdr(path)
    np.testing.assert_array_equal(got, jsky.load_hdr(path))
    assert got.shape == img.shape
    assert (np.abs(got - img) / np.maximum(img, 1e-2)).max() < 0.05


def test_hdr_errors_match_jax(tmp_path):
    bad = tmp_path / "bad.hdr"
    bad.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    flipped = _write_hdr(tmp_path / "flip.hdr", 1, 1, b"\x01\x02\x03\x80")
    data = open(flipped, "rb").read().replace(b"-Y 1 +X 1", b"+Y 1 +X 1")
    open(flipped, "wb").write(data)
    for mod in (tsky, jsky):
        with pytest.raises(ValueError, match="not a Radiance"):
            mod.load_hdr(str(bad))
        with pytest.raises(ValueError, match="orientation"):
            mod.load_hdr(flipped)


@pytest.mark.parametrize("comp", ["zip", "piz"])
def test_load_environment_by_extension(tmp_path, comp):
    from unityraytracer_tpu.models.exr import write_exr

    rng = np.random.default_rng(0)
    img = rng.gamma(0.8, 1.5, (16, 32, 3)).astype(np.float32)
    p_exr = write_exr(str(tmp_path / "env.EXR"), img, compression=comp,
                      dtype="float")
    np.testing.assert_array_equal(tsky.load_environment(p_exr), img)
    np.testing.assert_array_equal(tsky.load_environment(p_exr),
                                  jsky.load_environment(p_exr))
    p_hdr = tsky.save_hdr(str(tmp_path / "env.hdr"), img)
    out = tsky.load_environment(p_hdr)
    np.testing.assert_array_equal(out, jsky.load_environment(p_hdr))
    # RGBE shares one exponent per texel: the step is max_channel/128.
    assert (np.abs(out - img) <= img.max(-1, keepdims=True) / 128.0
            + 1e-4).all()
    for mod in (tsky, jsky):
        with pytest.raises(ValueError,
                           match="unsupported environment format: sky.png"):
            mod.load_environment("sky.png")


# ---------------------------------------------------------------------------
# Unity scenes. The synthetic scenes of tests/test_unity_scene.py, as text.

OBJ_GUID, MASTER_GUID = (junity.RAYTRACE_OBJECT_GUID,
                         junity.RAYTRACE_MASTER_GUID)
HEAD = "%YAML 1.1\n%TAG !u! tag:unity3d.com,2011:\n"


def _doc(cls, fid, body):
    return f"--- !u!{cls} &{fid}\n{body}"


def _go(fid, name, active=1):
    return _doc(1, fid, f"GameObject:\n  m_Name: {name}\n"
                        f"  m_IsActive: {active}\n")


def _tf(fid, go, pos, scale=(1, 1, 1), quat=(0, 0, 0, 1), father=0):
    return _doc(4, fid, (
        "Transform:\n"
        f"  m_GameObject: {{fileID: {go}}}\n"
        f"  m_LocalRotation: {{x: {quat[0]}, y: {quat[1]}, z: {quat[2]},"
        f" w: {quat[3]}}}\n"
        f"  m_LocalPosition: {{x: {pos[0]}, y: {pos[1]}, z: {pos[2]}}}\n"
        f"  m_LocalScale: {{x: {scale[0]}, y: {scale[1]}, z: {scale[2]}}}\n"
        f"  m_Father: {{fileID: {father}}}\n"))


def _rto(fid, go, enabled=1, albedo=(0.2, 0.4, 0.8), smooth=0.5):
    return _doc(114, fid, (
        "MonoBehaviour:\n"
        f"  m_GameObject: {{fileID: {go}}}\n"
        f"  m_Enabled: {enabled}\n"
        f"  m_Script: {{fileID: 11500000, guid: {OBJ_GUID},"
        " type: 3}\n"
        f"  albedoColor: {{r: {albedo[0]}, g: {albedo[1]}, b: {albedo[2]},"
        " a: 1}\n"
        f"  smoothness: {smooth}\n"))


def _collider(fid, go, radius=0.5):
    return _doc(135, fid, (
        "SphereCollider:\n"
        f"  m_GameObject: {{fileID: {go}}}\n"
        "  m_Enabled: 1\n"
        f"  m_Radius: {radius}\n"
        "  m_Center: {x: 0, y: 0, z: 0}\n"))


def _meshfilter(fid, go, mesh_id, guid="0000000000000000e000000000000000",
                kind=0):
    return _doc(33, fid, (
        "MeshFilter:\n"
        f"  m_GameObject: {{fileID: {go}}}\n"
        f"  m_Mesh: {{fileID: {mesh_id}, guid: {guid}, type: {kind}}}\n"))


def _camera(fid, go, fov=70):
    return _doc(20, fid, ("Camera:\n"
                          f"  m_GameObject: {{fileID: {go}}}\n"
                          f"  field of view: {fov}\n"))


def _master(fid, go, bounces=3, rays=2):
    return _doc(114, fid, (
        "MonoBehaviour:\n"
        f"  m_GameObject: {{fileID: {go}}}\n"
        "  m_Enabled: 1\n"
        f"  m_Script: {{fileID: 11500000, guid: {MASTER_GUID},"
        " type: 3}\n"
        f"  numBounces: {bounces}\n"
        f"  numRays: {rays}\n"))


CORE_SCENE = HEAD + "".join([
    # sphere: scaled parent -> lossyScale applies to collider radius
    _go(100, "Parent"), _tf(101, 100, (1, 0, 0), scale=(2, 2, 2)),
    _go(110, "Ball"), _tf(111, 110, (0, 1, 0), father=101),
    _rto(112, 110, albedo=(1, 0, 0)), _collider(113, 110, radius=0.5),
    # cube mesh, rotated about y
    _go(120, "Box"),
    _tf(121, 120, (3, 1, 0), quat=(0, 0.38268343, 0, 0.92387953)),
    _rto(122, 120), _meshfilter(123, 120, 10202),
    # disabled component: excluded by default
    _go(130, "Off"), _tf(131, 130, (9, 9, 9)),
    _rto(132, 130, enabled=0), _collider(133, 130),
    # inactive GameObject: always excluded
    _go(140, "Hidden", active=0), _tf(141, 140, (8, 8, 8)),
    _rto(142, 140), _collider(143, 140),
    # non-builtin mesh: skipped with a warning
    _go(150, "Custom"), _tf(151, 150, (0, 0, 5)),
    _rto(152, 150), _meshfilter(153, 150, 4300000),
    # a quad, mirrored
    _go(170, "Mirror"), _tf(171, 170, (0, 2, 4), scale=(-3, 2, 1)),
    _rto(172, 170, albedo=(0.9, 0.9, 0.9), smooth=0.95),
    _meshfilter(173, 170, 10210),
    # camera + master
    _go(160, "Main Camera"),
    _tf(161, 160, (0, 2, -9), quat=(0.08715578, 0, 0, 0.9961947)),
    _camera(162, 160, fov=70), _master(163, 160),
])

MESH_GUID = "ab12cd34ef56ab12cd34ef56ab12cd34"
GUID_SCENE = HEAD + "".join([
    _go(100, "Wedge"), _tf(101, 100, (2, 1, 0)), _rto(102, 100),
    _meshfilter(103, 100, 4300000, guid=MESH_GUID, kind=3),
    # unresolvable guid: warn-and-skip
    _go(110, "Ghost"), _tf(111, 110, (0, 0, 9)), _rto(112, 110),
    _meshfilter(113, 110, 4300000, guid="f" * 32, kind=3),
])

# What the Unity editor itself writes: unindented lists, wrapped flow
# mappings, empty values, quoted names, nested blocks, `stripped` headers.
EDITOR_DOCS = HEAD + """--- !u!29 &1
OcclusionCullingSettings:
  m_ObjectHideFlags: 0
  serializedVersion: 2
  m_OcclusionBakeSettings:
    smallestOccluder: 5
    smallestHole: 0.25
    backfaceThreshold: 100
  m_SceneGUID: 00000000000000000000000000000000
  m_OcclusionCullingData: {fileID: 0}
--- !u!104 &2
RenderSettings:
  m_Fog: 0
  m_FogColor: {r: 0.5, g: 0.5, b: 0.5, a: 1}
  m_FogDensity: 0.01
  m_SkyboxMaterial: {fileID: 10304, guid: 0000000000000000f000000000000000, type: 0}
  m_IndirectSpecularColor: {r: 0.44657898, g: 0.4964133, b: 0.5748178, a: 1}
  m_UseRadianceAmbientProbe: 0
--- !u!1 &963194225
GameObject:
  m_ObjectHideFlags: 0
  m_CorrespondingSourceObject: {fileID: 0}
  serializedVersion: 6
  m_Component:
  - component: {fileID: 963194228}
  - component: {fileID: 963194227}
  - component: {fileID: 963194226}
  m_Layer: 0
  m_Name: 'Main Camera: "A"'
  m_TagString: MainCamera
  m_Icon: {fileID: 0}
  m_StaticEditorFlags: 0
  m_IsActive: 1
--- !u!20 &963194227
Camera:
  m_GameObject: {fileID: 963194225}
  m_Enabled: 1
  serializedVersion: 2
  m_ClearFlags: 1
  m_BackGroundColor: {r: 0.19215687, g: 0.3019608, b: 0.4745098, a: 0}
  m_NormalizedViewPortRect:
    serializedVersion: 2
    x: 0
    y: 0
    width: 1
    height: 1
  near clip plane: 0.3
  far clip plane: 1000
  field of view: 81
  orthographic: 0
  m_CullingMask:
    serializedVersion: 2
    m_Bits: 4294967295
  m_TargetTexture: {fileID: 0}
  m_HDR: 1
  m_StereoSeparation: 0.022
--- !u!4 &963194228
Transform:
  m_GameObject: {fileID: 963194225}
  m_LocalRotation: {x: -0, y: 0, z: 0, w: 1}
  m_LocalPosition: {x: 0, y: 1, z: -10}
  m_LocalScale: {x: 1, y: 1, z: 1}
  m_ConstrainProportionsScale: 0
  m_Children: []
  m_Father: {fileID: 0}
  m_RootOrder: 0
  m_LocalEulerAnglesHint: {x: 0, y: 0, z: 0}
--- !u!114 &963194226
MonoBehaviour:
  m_GameObject: {fileID: 963194225}
  m_Enabled: 1
  m_EditorHideFlags: 0
  m_Script: {fileID: 11500000, guid: b2e91413b60a86f49ac7969f1637f0cd,
    type: 3}
  m_Name:
  m_EditorClassIdentifier:
  RayTraceShader: {fileID: 7200000, guid: 4f6b5ea2e6ad5f44c8e9cbbcbe4e0d2f,
    type: 3}
  SkyboxTexture: {fileID: 2800000, guid: 5b0c8a2c8d2f9ae4a8bb8f2c2bd2e9a1, type: 3}
  numBounces: 2
  numRays: 1
  tolerance: 1e-05
  epsilon: 5.9604645e-08
  label: "tab\\there"
--- !u!1001 &1443541955
PrefabInstance:
  m_ObjectHideFlags: 0
  serializedVersion: 2
  m_Modification:
    m_TransformParent: {fileID: 0}
    m_Modifications:
    - target: {fileID: 100000, guid: 7a1c5c0b3a7e4f04b8a5b0e2d6f8c9aa, type: 3}
      propertyPath: m_Name
      value: Pillar (1)
      objectReference: {fileID: 0}
    - target: {fileID: 400000, guid: 7a1c5c0b3a7e4f04b8a5b0e2d6f8c9aa, type: 3}
      propertyPath: m_LocalPosition.x
      value: -3.5
      objectReference: {fileID: 0}
    m_RemovedComponents: []
  m_SourcePrefab: {fileID: 100100000, guid: 7a1c5c0b3a7e4f04b8a5b0e2d6f8c9aa, type: 3}
--- !u!4 &77 stripped
Transform:
  m_CorrespondingSourceObject: {fileID: 400000, guid: 7a1c5c0b3a7e4f04b8a5b0e2d6f8c9aa,
    type: 3}
  m_PrefabInstance: {fileID: 1443541955}
--- !u!157 &3
LightmapSettings:
  m_LightmapEditorSettings:
    m_Resolution: 2
    m_PVRFilteringMode: 1
  m_LightingSettings: {fileID: 0}
  m_Octal: 0123
  m_Hex: 0x1F
  m_Flags: [1, 2.5, three, {a: 1}]
  m_Bools: [yes, No, TRUE, off]
  m_Nothing: ~
"""

UNITY_TEXTS = {"core": CORE_SCENE, "guid": GUID_SCENE, "editor": EDITOR_DOCS}


def _write_scene(tmp_path, text, name="scene.unity"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("name", sorted(UNITY_TEXTS))
def test_yaml_subset_equals_safe_load(name):
    """The port parses Unity's YAML itself (PyYAML need not be where torch
    is): document by document its result equals ``yaml.safe_load``'s, types
    included, and the document table equals the JAX importer's."""
    yaml = pytest.importorskip("yaml")
    text = UNITY_TEXTS[name]
    heads = list(tunity._DOC_RE.finditer(text))
    assert heads
    for k, m in enumerate(heads):
        end = heads[k + 1].start() if k + 1 < len(heads) else len(text)
        body = text[m.end():end]
        got, want = tunity._yaml_subset(body), yaml.safe_load(body)
        assert got == want
        assert repr(got) == repr(want)          # 1 is not 1.0 is not True
    assert tunity._parse_docs(text) == junity._parse_docs(text)


def test_yaml_subset_scalars_and_rejections():
    yaml = pytest.importorskip("yaml")
    for s in ["1", "-7", "+3", "0", "007", "0x1f", "0b101", "1_000", "1:30",
              "1.5", "-0.25", ".5", "5.", "1e-05", "1.0e-05", "1.5E+3",
              ".inf", "-.INF", "1:30.5", "yes", "Off", "null", "~", "NULL",
              "0000000000000000e000000000000000", "12345678901234567890",
              "a b c", "1.2.3", "0o17", "08", "'007'", '"x: y"',
              "{}", "[]", "{a: {b: [1, {c: d}]}, e: 'f, g'}"]:
        body = f"K:\n  v: {s}\n  w: [{s}]\n"
        got, want = tunity._yaml_subset(body), yaml.safe_load(body)
        assert got == want and repr(got) == repr(want), s
    assert np.isnan(tunity._yaml_subset("v: .nan")["v"])
    # Outside the subset: the document is skipped, as the JAX importer
    # skips a document its YAML loader rejects.
    for body in ["K:\n  v: |\n    block\n", "K:\n  v: &a 1\n",
                 "K:\n\tv: 1\n", "K:\n  v: {a: 1\n"]:
        with pytest.raises(tunity._YamlError):
            tunity._yaml_subset(body)
        assert tunity._parse_docs("--- !u!1 &5\n" + body) == {}


def _same_import(path, **kw):
    ts, tc, tst = tunity.load_unity_scene(path, **kw)
    js, jc, jst = junity.load_unity_scene(path, **kw)
    got, want = scene_to_numpy(ts), jax_scene_numpy(js)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if np.issubdtype(want[k].dtype, np.integer):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=k)
    for f in dataclasses.fields(tc):
        np.testing.assert_allclose(np.asarray(getattr(tc, f.name)),
                                   np.asarray(getattr(jc, f.name)),
                                   rtol=0, atol=1e-6, err_msg=f.name)
    assert tst == jst
    return ts, tc, tst


def test_unity_core_scene_equals_jax(tmp_path):
    p = _write_scene(tmp_path, CORE_SCENE)
    scene, cam, st = _same_import(p, aspect=1.0)
    assert scene.num_spheres == 1
    # parent scale 2: world pos = (1,0,0) + 2*(0,1,0); radius 0.5 * 2.
    np.testing.assert_allclose(scene.spheres.center[0], [1.0, 2.0, 0.0],
                               atol=1e-6)
    assert float(scene.spheres.radius[0]) == pytest.approx(1.0)
    assert scene.num_triangles == 12 + 2        # cube + quad, custom skipped
    assert st == {"numBounces": 3, "numRays": 2, "skybox_guid": None}
    np.testing.assert_allclose(cam.position, [0, 2, -9], atol=1e-6)
    # include_disabled pulls the disabled sphere back in (never the
    # inactive GameObject); a given skybox and detail replace the defaults.
    scene2, _, _ = _same_import(p, aspect=16 / 9, include_disabled=True,
                                skybox=np.full((4, 8, 3), 0.5, np.float32))
    assert scene2.num_spheres == 2 and scene2.skybox.shape == (4, 8, 3)


def test_unity_editor_scene_equals_jax(tmp_path):
    p = _write_scene(tmp_path, EDITOR_DOCS)
    scene, cam, st = _same_import(p)
    assert st == {"numBounces": 2, "numRays": 1,
                  "skybox_guid": "5b0c8a2c8d2f9ae4a8bb8f2c2bd2e9a1"}
    assert scene.num_spheres == 0 and scene.num_triangles == 0
    np.testing.assert_allclose(cam.position, [0, 1, -10], atol=1e-6)
    assert float(cam.tan_half_fov) == pytest.approx(np.tan(np.deg2rad(40.5)))


def test_unity_mesh_guid_resolution(tmp_path):
    """A non-builtin mesh resolves through the project's ``.meta`` guid
    index to its OBJ; the import equals ``add_obj`` on the same file and
    the JAX importer's scene."""
    assets = tmp_path / "Assets"
    (assets / "Meshes").mkdir(parents=True)
    (assets / "Scenes").mkdir()
    obj_path = assets / "Meshes" / "wedge.obj"
    obj_path.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
                        "f 1 2 3\nf 1 3 4\n")
    (assets / "Meshes" / "wedge.obj.meta").write_text(
        f"fileFormatVersion: 2\nguid: {MESH_GUID}\n"
        "ModelImporter:\n  serializedVersion: 21300\n")
    (assets / "Meshes" / "tex.png.meta").write_text(
        "fileFormatVersion: 2\nguid: " + "c" * 32 + "\n")
    p = _write_scene(assets / "Scenes", GUID_SCENE)
    scene, _, st = _same_import(p, aspect=1.0)
    assert scene.num_triangles == 2             # wedge loaded, ghost skipped
    assert st == {}
    assert tunity._project_root(p) == str(tmp_path)
    assert tunity._guid_index(str(tmp_path)) == junity._guid_index(
        str(tmp_path))

    b = SceneBuilder()
    tr = np.eye(4, dtype=np.float32)
    tr[:3, 3] = (2, 1, 0)
    b.add_obj(str(obj_path), transform=tr)
    ref = b.build()
    np.testing.assert_allclose(scene.triangles.v0, ref.triangles.v0,
                               atol=1e-6)
    np.testing.assert_allclose(scene.triangles.v2, ref.triangles.v2,
                               atol=1e-6)


def test_unity_import_logs_skipped_meshes(tmp_path):
    from unityraytracer_tpu_torch.utils import logging as tlog

    p = _write_scene(tmp_path, CORE_SCENE)
    log = tlog.configure("unity", directory=str(tmp_path / "Debug"),
                         level=tlog.WARNING)
    try:
        tunity.load_unity_scene(p)
    finally:
        tlog.configure(level=tlog.NONE)
    text = open(log.path).read()
    assert "'Custom'" in text and "unresolvable mesh" in text
