"""Parity repairs against the JAX package, on the same numpy inputs:

* ``ops/shade.sample_skybox_rgbe`` with the JAX signature ``(skybox, rd,
  bilinear=True, u1=None, u2=None, packed=None)``: the stochastic tap and
  the nearest texel bit for bit. The bilinear blend is bit for bit on the
  same texel coordinates; on the port's own coordinates it carries the
  ulps by which torch's and XLA:CPU's acos and atan2 move the weights wy
  and wx (tests/test_torch_ops.py), so the whole lookup is held to the
  module tolerance of 1e-5 relative (atol 1e-6) there.
* ``Materials.take``: the same four gathers.
* ``ops/cuda_trace.make_pallas_tracer(scene, accel, cfg, interpret)`` with
  ``sort`` keyword-only, and ``render.render_sample_mega(..., interpret=)``:
  both take the JAX arguments in the JAX places and give the hits and the
  image they give without them.
* ``.replace(**updates)`` on every type that is a ``flax.struct.dataclass``
  in the JAX package: the same new objects, the originals unchanged.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unityraytracer_tpu import Camera as JCamera
from unityraytracer_tpu import Material as JMaterial
from unityraytracer_tpu import RenderConfig as JConfig
from unityraytracer_tpu import SceneBuilder as JBuilder
from unityraytracer_tpu.models import primitives as JP
from unityraytracer_tpu.ops import bvh as jbvh
from unityraytracer_tpu.ops import shade as jsh
from unityraytracer_tpu.ops.pallas_trace import make_pallas_tracer as jax_mpt
from unityraytracer_tpu.ops.pallas_trace import prepare_pallas_accel
from unityraytracer_tpu.render import RenderState as JRenderState
from unityraytracer_tpu.render import render_sample_mega as jax_mega
from unityraytracer_tpu.scene import Materials as JMaterials
from unityraytracer_tpu_torch import Camera, Material, RenderConfig, rng
from unityraytracer_tpu_torch import SceneBuilder
from unityraytracer_tpu_torch.models import primitives as P
from unityraytracer_tpu_torch.models.skybox import sun_sky
from unityraytracer_tpu_torch.ops import bvh as tbvh
from unityraytracer_tpu_torch.ops import shade as tsh
from unityraytracer_tpu_torch.ops.cuda_trace import make_pallas_tracer
from unityraytracer_tpu_torch.render import RenderState, render_sample_mega
from unityraytracer_tpu_torch.scene import Materials
from unityraytracer_tpu_torch.utils.image import rmse
from unityraytracer_tpu_torch.utils.math3d import trs_matrix
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _unit_dirs(seed, n=256):
    d = np.random.default_rng(seed).normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return (tuple(jnp.asarray(c) for c in d),
            tuple(torch.from_numpy(c.copy()) for c in d))


def _np3(v3):
    return np.stack([np.asarray(c) for c in v3])


# --- F1: sample_skybox_rgbe -------------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_skybox_rgbe_lookups_match_jax(seed, packed, monkeypatch):
    """The three lookups of sun_sky(32, 64) on 256 unit directions, as
    tests/test_shade.py:121-131 makes them."""
    sky = sun_sky(32, 64)
    plane = tsh.pack_rgbe_np(sky)
    jpk = jnp.asarray(plane) if packed else None
    tpk = torch.from_numpy(plane.view(np.int32)) if packed else None
    jsky, tsky = jnp.asarray(sky), torch.from_numpy(sky)
    jd, td = _unit_dirs(seed)
    u = np.random.default_rng(seed + 10).uniform(size=(2, 256))
    u = u.astype(np.float32)
    ju1, ju2 = (jnp.asarray(c) for c in u)
    tu1, tu2 = (torch.from_numpy(c.copy()) for c in u)

    # The stochastic tap, and the nearest texel: bit for bit.
    j = jsh.sample_skybox_rgbe(jsky, jd, u1=ju1, u2=ju2, packed=jpk)
    t = tsh.sample_skybox_rgbe(tsky, td, u1=tu1, u2=tu2, packed=tpk)
    np.testing.assert_array_equal(_np3(t), _np3(j))
    j = jsh.sample_skybox_rgbe(jsky, jd, False, packed=jpk)
    t = tsh.sample_skybox_rgbe(tsky, td, False, packed=tpk)
    np.testing.assert_array_equal(_np3(t), _np3(j))

    # The bilinear lookup (the default), within the module tolerance, and
    # within 2% of the float sky as the JAX test holds it.
    j = _np3(jsh.sample_skybox_rgbe(jsky, jd, packed=jpk))
    t = _np3(tsh.sample_skybox_rgbe(tsky, td, packed=tpk))
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    exact = _np3(tsh.sample_skybox(tsky, td))
    assert (np.abs(t - exact) / np.maximum(np.abs(exact), 1e-2)).max() < 0.02

    # Its blend on the JAX texel coordinates: bit for bit.
    jc = tuple(torch.from_numpy(np.asarray(c).copy())
               for c in jsh._equirect_coords((32, 64), jd))
    monkeypatch.setattr(tsh, "_equirect_coords", lambda hw, rd: jc)
    t = _np3(tsh.sample_skybox_rgbe(tsky, td, packed=tpk))
    np.testing.assert_array_equal(t, j)


# --- F2: Materials.take -----------------------------------------------------

def test_materials_take_matches_jax():
    g = np.random.default_rng(3)
    leaves = dict(albedo=g.uniform(size=(7, 3)), specular=g.uniform(
        size=(7, 3)), emission=g.uniform(size=(7, 3)) * 4,
        smoothness=g.uniform(size=7))
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    idx = g.integers(0, 7, 300).astype(np.int32)
    want = JMaterials(**{k: jnp.asarray(v) for k, v in leaves.items()}).take(
        jnp.asarray(idx))
    for mats, ix in ((Materials(**{k: torch.from_numpy(v) for k, v in
                                   leaves.items()}), torch.from_numpy(idx)),
                     (Materials(**leaves), idx)):
        got = mats.take(ix)
        assert len(got) == 4
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- F3: make_pallas_tracer and render_sample_mega take the JAX arguments ---

def _scene(Builder, Mat, prim):
    b = Builder()
    v, f, _ = prim.icosphere(2)
    b.add_mesh(v, f, transform=trs_matrix((0, 1, 0), (0, 30, 0), 2.0),
               material=Mat(albedo=(0.8, 0.3, 0.2), specular=(0.05,) * 3))
    v2, f2, _ = prim.cube()
    b.add_mesh(v2, f2, transform=trs_matrix((2.5, 0.5, 0.5), (0, 20, 0)))
    b.add_sphere((-2.5, 0.7, 0), 0.7)
    b.set_skybox(sun_sky(16, 32))
    return b.build()


@pytest.fixture(scope="module")
def scenes():
    js = _scene(JBuilder, JMaterial, JP)
    ts = _scene(SceneBuilder, Material, P)
    return (js, jbvh.build_cluster_accel(js.triangles, 64, use_native=False),
            ts.to("cpu"), tbvh.build_cluster_accel(ts.triangles, 64,
                                                   use_native=False))


def test_make_pallas_tracer_takes_the_jax_arguments(scenes):
    js, jacc, ts, tacc = scenes
    g = np.random.default_rng(5)
    ro = (g.uniform(-3, 3, (3, 384)) + np.array([[0], [2], [-6]]))
    rd = g.normal(size=(3, 384))
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    ro, rd = ro.astype(np.float32), rd.astype(np.float32)
    tro = tuple(torch.from_numpy(c.copy()) for c in ro)
    trd = tuple(torch.from_numpy(c.copy()) for c in rd)
    jh = jax_mpt(js, jacc, JConfig(tracer="pallas"), interpret=True)(
        tuple(jnp.asarray(c) for c in ro), tuple(jnp.asarray(c) for c in rd))
    cfg = RenderConfig(tracer="pallas")
    th = make_pallas_tracer(ts, tacc, cfg, True)(tro, trd)
    # The JAX call's shape binds the same hits as the port's own.
    base = make_pallas_tracer(ts, tacc)(tro, trd)
    for f in dataclasses.fields(base):
        a, b = getattr(th, f.name), getattr(base, f.name)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    # Against the JAX kernel in interpret mode (its Plücker test against the
    # port's MT97: t to 1e-5 relative, the same winner's material).
    jt, tt = np.asarray(jh.t), th.t.numpy()
    hit = jt < 1e30
    np.testing.assert_array_equal(tt < 1e30, hit)
    assert 0.2 < hit.mean() < 0.95
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-5)
    for k in range(3):
        np.testing.assert_array_equal(th.albedo[k].numpy()[hit],
                                      np.asarray(jh.albedo[k])[hit])
        np.testing.assert_allclose(th.normal[k].numpy()[hit],
                                   np.asarray(jh.normal[k])[hit], atol=1e-5)
    # sort is keyword-only: a fifth positional argument is refused.
    with pytest.raises(TypeError):
        make_pallas_tracer(ts, tacc, cfg, None, False)


def test_render_sample_mega_takes_interpret(scenes):
    js, jacc, ts, tacc = scenes
    kw = dict(position=(0, 2.0, -7.0), look_at=(0, 1.0, 0), fov_y_deg=55.0,
              aspect=2.0)
    jcfg = JConfig(width=32, height=16, spp=1, bounces=2, tracer="pallas")
    cfg = RenderConfig(width=32, height=16, spp=1, bounces=2,
                       tracer="pallas")
    pa = prepare_pallas_accel(jacc, js.materials, scene=js)
    j = np.asarray(jax_mega(js, pa, JCamera.create(**kw), jax.random.key(9),
                            jcfg, interpret=True))
    cam = Camera.create(**kw)
    t = render_sample_mega(ts, tacc, cam, rng.key(9), cfg, interpret=True)
    t0 = render_sample_mega(ts, tacc, cam, rng.key(9), cfg)
    np.testing.assert_array_equal(t.numpy(), t0.numpy())
    assert np.isfinite(t.numpy()).all() and t.numpy().max() > 0.05
    assert rmse(t.numpy(), j) < 1e-3


# --- F4: .replace on the flax.struct types ----------------------------------

def _cases():
    g = np.random.default_rng(8)
    f32 = lambda *s: g.uniform(size=s).astype(np.float32)  # noqa: E731
    cam = dict(position=(1.0, 2.0, -5.0), look_at=(0, 1, 0), fov_y_deg=50.0,
               aspect=1.5)
    js = _scene(JBuilder, JMaterial, JP)
    ts = _scene(SceneBuilder, Material, P)
    jacc = jbvh.build_cluster_accel(js.triangles, 64, use_native=False)
    tacc = tbvh.build_cluster_accel(ts.triangles, 64, use_native=False)
    hit_f = dict(t=f32(5), position=tuple(f32(5) for _ in range(3)),
                 normal=tuple(f32(5) for _ in range(3)),
                 albedo=tuple(f32(5) for _ in range(3)),
                 specular=tuple(f32(5) for _ in range(3)),
                 emission=tuple(f32(5) for _ in range(3)),
                 smoothness=f32(5))
    # (name, jax object, port object, field, new value)
    return [
        ("Camera", JCamera.create(**cam), Camera.create(**cam), "aperture",
         np.float32(0.25)),
        ("Scene", js, ts, "ground_enabled", np.float32(0.0)),
        ("Triangles", js.triangles, ts.triangles, "material_id",
         np.zeros(js.num_triangles, np.int32)),
        ("Spheres", js.spheres, ts.spheres, "radius", np.float32([2.0])),
        ("Materials", js.materials, ts.materials, "smoothness",
         f32(js.materials.count)),
        ("ClusterAccel", jacc, tacc, "node_left",
         np.arange(len(jacc.node_left), dtype=np.int32)),
        ("Hit", jsh.Hit(**hit_f), tsh.Hit(**hit_f), "t", f32(5)),
        ("RenderState", JRenderState(accum=jnp.zeros((2, 3, 3)),
                                     n_samples=jnp.int32(4)),
         RenderState(accum=torch.zeros((2, 3, 3)), n_samples=4),
         "n_samples", 5),
    ]


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_replace_matches_jax(case):
    _, jobj, tobj, field, new = case
    jnew, tnew = jobj.replace(**{field: new}), tobj.replace(**{field: new})
    assert type(tnew) is type(tobj) and tnew is not tobj
    np.testing.assert_array_equal(np.asarray(getattr(tnew, field)),
                                  np.asarray(getattr(jnew, field)))
    # Every other field is the one it was, on both sides.
    for f in dataclasses.fields(tobj):
        if f.name != field:
            assert getattr(tnew, f.name) is getattr(tobj, f.name)
    for f in dataclasses.fields(jobj):
        if f.name != field:
            a, b = getattr(jnew, f.name), getattr(tobj, f.name)
            if isinstance(a, (jnp.ndarray, np.ndarray)) \
                    and isinstance(b, (np.ndarray, torch.Tensor)):
                np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert not np.array_equal(np.asarray(getattr(tobj, field)),
                              np.asarray(new))
    with pytest.raises(TypeError):
        tobj.replace(no_such_field=1)
