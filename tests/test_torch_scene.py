"""Host-side builders of the port against the JAX package: the fixture
scenes, the RGBE bake and the LBVH must produce EQUAL arrays (the same numpy
code on the same inputs), and the numpy round trips must be lossless."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from unityraytracer_tpu.models import fixtures as jfix
from unityraytracer_tpu.ops import bvh as jbvh
from unityraytracer_tpu_torch import scene_from_numpy, scene_to_numpy
from unityraytracer_tpu_torch.camera import camera_from_numpy
from unityraytracer_tpu_torch.models import fixtures as tfix
from unityraytracer_tpu_torch.ops import bvh as tbvh

_LEAVES = {
    "spheres": ("center", "radius", "material_id"),
    "triangles": ("v0", "v1", "v2", "n0", "n1", "n2", "material_id"),
    "materials": ("albedo", "specular", "emission", "smoothness"),
}

BUILDERS = {
    "scene1": lambda m: m.scene1(),
    "sample_scene": lambda m: m.sample_scene(),
    "bench_scene_2000": lambda m: m.bench_scene(n_tris=2000),
}


def jax_scene_numpy(s) -> dict:
    """The JAX Scene's leaves as a flat numpy dict (scene_from_numpy's
    input format)."""
    d = {f"{g}.{k}": np.asarray(getattr(getattr(s, g), k))
         for g, ks in _LEAVES.items() for k in ks}
    for k in ("ground_enabled", "ground_material_id", "skybox", "skybox_rgbe"):
        d[k] = np.asarray(getattr(s, k))
    return d


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_fixture_arrays_equal_jax(name):
    js = BUILDERS[name](jfix)
    ts = BUILDERS[name](tfix)
    _assert_same(scene_to_numpy(ts), jax_scene_numpy(js))


def test_skybox_rgbe_equal_jax():
    from unityraytracer_tpu.ops.shade import pack_rgbe_np as jpack
    from unityraytracer_tpu_torch.models.skybox import gradient_sky, sun_sky
    from unityraytracer_tpu_torch.ops.shade import pack_rgbe_np as tpack
    for sky in (sun_sky(), gradient_sky(32, 64),
                np.zeros((4, 8, 3), np.float32)):
        np.testing.assert_array_equal(tpack(sky), jpack(sky))


@pytest.mark.parametrize("name,cluster_size", [("bench_scene_2000", 64),
                                               ("scene1", 32)])
def test_cluster_accel_equal_jax_and_valid(name, cluster_size):
    js = BUILDERS[name](jfix)
    ts = BUILDERS[name](tfix)
    ja = jbvh.build_cluster_accel(js.triangles, cluster_size=cluster_size,
                                  use_native=False)
    ta = tbvh.build_cluster_accel(ts.triangles, cluster_size=cluster_size)
    for f in ("cluster_vmin", "cluster_vmax", "node_vmin", "node_vmax",
              "node_left", "node_right"):
        np.testing.assert_array_equal(getattr(ta, f), np.asarray(getattr(ja, f)),
                                      err_msg=f)
    for k in _LEAVES["triangles"]:
        np.testing.assert_array_equal(getattr(ta.triangles, k),
                                      np.asarray(getattr(ja.triangles, k)))
    tbvh.validate_accel(ta, ts.triangles)
    assert ta.num_clusters * cluster_size == ta.triangles.count


def test_cluster_accel_single_and_empty():
    from unityraytracer_tpu_torch.scene import SceneBuilder
    from unityraytracer_tpu_torch.models import primitives as P
    b = SceneBuilder()
    v, f, n = P.cube()
    b.add_mesh(v, f, normals=n)
    single = tbvh.build_cluster_accel(b.build().triangles, cluster_size=64)
    assert single.num_clusters == 1 and single.node_left.tolist() == [-1]
    tbvh.validate_accel(single, b.build().triangles)
    empty = tbvh.build_cluster_accel(SceneBuilder().build().triangles)
    assert empty.num_clusters == 1 and empty.triangles.count == 64


def test_scene_from_numpy_round_trips():
    js = jfix.scene1()
    d = jax_scene_numpy(js)
    ts = scene_from_numpy(d)
    _assert_same(scene_to_numpy(ts), d)
    # Through torch tensors and back; the RGBE plane rides as int32 bits.
    dev = ts.to("cpu")
    assert dev.skybox_rgbe.dtype == torch.int32
    back = scene_to_numpy(dev)
    back["skybox_rgbe"] = back["skybox_rgbe"].view(np.uint32)
    _assert_same(back, d)
    # Missing RGBE plane is re-baked to the same words.
    d2 = dict(d)
    del d2["skybox_rgbe"]
    np.testing.assert_array_equal(scene_from_numpy(d2).skybox_rgbe,
                                  d["skybox_rgbe"])


def test_camera_from_numpy_matches_create():
    jc = jfix.scene1_camera(aspect=4 / 3)
    d = {f.name: np.asarray(getattr(jc, f.name))
         for f in dataclasses.fields(jc)}
    tc = camera_from_numpy(d)
    ref = tfix.scene1_camera(aspect=4 / 3)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(np.asarray(getattr(tc, f.name)),
                                      np.asarray(getattr(ref, f.name)))


def test_package_imports_no_jax():
    # The port must run where JAX is absent: importing it and its modules
    # loads neither jax nor the JAX package.
    code = ("import sys; import unityraytracer_tpu_torch as p; "
            "import unityraytracer_tpu_torch.ops.cuda_path, "
            "unityraytracer_tpu_torch.ops.cuda_env, "
            "unityraytracer_tpu_torch.models.fixtures; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('flax') or m.split('.')[0] == 'unityraytracer_tpu']; "
            "assert not bad, bad")
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
    # Nor does any source of the package name JAX or the JAX package.
    bad = re.compile(r"import jax|from jax|unityraytracer_tpu\b")
    for src in (root / "unityraytracer_tpu_torch").rglob("*"):
        if src.suffix in (".py", ".cu", ".cuh"):
            assert not bad.search(src.read_text()), src
