"""The ray coherence sort of the port (``ops/cuda_trace.py``: ``ray_bin_ids``,
``bin_destinations``, ``scene_bbox``, the sorted plain traces) against the
JAX package's (``pallas_trace._ray_bin_ids``, ``_bin_destinations``,
``PallasAccel.bbox``, ``render.render_sample``'s per-bounce predicate).

Bins, destinations and bounds are integers or exact floats, so they must be
equal. The sort only reorders rays whose hits do not depend on their
order, so every CPU path must give the same bits with the sort on and off.
The sorted 32x32 render is held to the brute tracer at RMSE < 1e-4, as
``tests/test_pallas.py:252-263`` holds the JAX one."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from unityraytracer_tpu import Camera as JCamera
from unityraytracer_tpu import Material as JMaterial
from unityraytracer_tpu import RenderConfig as JConfig
from unityraytracer_tpu import SceneBuilder as JBuilder
from unityraytracer_tpu.models import fixtures as jfix
from unityraytracer_tpu.models import primitives as JP
from unityraytracer_tpu.ops import pallas_trace as pt
from unityraytracer_tpu.ops.trace import make_brute_tracer as jax_brute
from unityraytracer_tpu.render import render_sample as jax_render_sample
from unityraytracer_tpu.utils.math3d import trs_matrix
from unityraytracer_tpu_torch import (Camera, Material, RenderConfig,
                                      SceneBuilder, rng)
from unityraytracer_tpu_torch.models import fixtures
from unityraytracer_tpu_torch.models import primitives as P
from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
from unityraytracer_tpu_torch.ops.cuda_path import path_trace
from unityraytracer_tpu_torch.ops.cuda_trace import (DEAD_BIN, SORT_WINDOW,
                                                     KernelScene, bin_center,
                                                     bin_destinations,
                                                     ray_bin_ids, scene_bbox,
                                                     trace_hits)
from unityraytracer_tpu_torch.ops.trace import make_brute_tracer
from unityraytracer_tpu_torch.parallel.scene_shard import (
    shard_kernel_scenes, shard_scene_pallas_accels)
from unityraytracer_tpu_torch.render import get_tracer, render_sample
from unityraytracer_tpu_torch.utils.image import rmse
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _scene(B, M, prims):
    """tests/test_pallas.py's scene: an icosphere, a cube, a sphere."""
    b = B()
    v, f, n = prims.icosphere(2)
    b.add_mesh(v, f, transform=trs_matrix((0, 1, 0), (0, 30, 0), 2.0),
               material=M(albedo=(0.8, 0.3, 0.2), specular=(0.05,) * 3))
    v2, f2, _ = prims.cube()
    b.add_mesh(v2, f2, transform=trs_matrix((2.5, 0.5, 0.5), (0, 20, 0)))
    b.add_sphere((-2.5, 0.7, 0), 0.7)
    b.set_skybox(np.ones((4, 8, 3), np.float32) * 0.6)
    return b.build()


def _spheres_only(B, M):
    b = B()
    b.add_sphere((0, 1, 0), 1.0, M(albedo=(0.5, 0.5, 0.5)))
    b.set_skybox(np.ones((4, 8, 3), np.float32) * 0.5)
    return b.build()


def _f32_bbox(*v):
    return tuple(float(np.float32(x)) for x in v)


BBOXES = {
    "scene1": scene_bbox(fixtures.scene1().triangles),
    "empty scene": (0.0, 0.0, 0.0, 1.0, 1.0, 1.0),
    # Midpoints that need a float32 rounding: 0.1f + 0.7f and -3.3f + 2.9f
    # are not float32 values halved.
    "odd": _f32_bbox(0.1, -3.3, 1e-3, 0.7, 2.9, 5.5),
}


def _rays(n, bbox, seed):
    """Seeded rays with signed zeros in the directions, origins exactly at
    the centre, at its float32 neighbours and at both float32 neighbours of
    the exact midpoint, and a third of them dead."""
    g = np.random.default_rng(seed)
    lo, hi = np.array(bbox[:3]), np.array(bbox[3:])
    ro = (lo + (hi - lo) * g.uniform(-0.2, 1.2, (n, 3))).astype(np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    rd[g.uniform(size=(n, 3)) < 0.15] = 0.0
    rd[g.uniform(size=(n, 3)) < 0.15] = -0.0
    c32 = np.array(bin_center(bbox), np.float32)
    mid = 0.5 * (lo + hi)
    at = [c32, np.nextafter(c32, np.float32(np.inf)),
          np.nextafter(c32, np.float32(-np.inf)),
          np.nextafter(mid.astype(np.float32), np.float32(np.inf)),
          np.nextafter(mid.astype(np.float32), np.float32(-np.inf))]
    for k, v in enumerate(at):
        for a in range(3):
            ro[7 * k + a::97, a] = v[a]
    alive = g.uniform(size=n) > 0.33
    return ro, rd, alive


@pytest.mark.parametrize("name", sorted(BBOXES))
def test_ray_bin_ids_match_jax(name):
    bbox = BBOXES[name]
    ro, rd, alive = _rays(4096, bbox, seed=len(name))
    want = np.asarray(pt._ray_bin_ids(
        *(jnp.asarray(ro[None, :, a]) for a in range(3)),
        *(jnp.asarray(rd[None, :, a]) for a in range(3)),
        jnp.asarray(np.where(alive, 1.0, 0.0).astype(np.float32)[None]),
        bbox))[0]
    got = ray_bin_ids(tuple(torch.from_numpy(ro[:, a].copy())
                            for a in range(3)),
                      tuple(torch.from_numpy(rd[:, a].copy())
                            for a in range(3)),
                      torch.from_numpy(alive), bin_center(bbox))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want[~alive])) == {DEAD_BIN}
    assert want[alive].max() < 64


def _jax_destinations(bins):
    """``_bin_destinations`` of one 1024-ray step, inside a one-block
    Pallas kernel in interpret mode (its lane rolls need a kernel)."""
    def kernel(b_ref, o_ref):
        o_ref[...] = pt._bin_destinations(b_ref[...])

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((1, 1024), jnp.int32),
        interpret=True)(jnp.asarray(bins[None])))[0]


def _stable_slots(bins):
    slot = np.empty(len(bins), np.int64)
    slot[np.argsort(bins, kind="stable")] = np.arange(len(bins))
    return slot


def test_bin_destinations_match_jax():
    g = np.random.default_rng(3)
    bins = g.integers(0, 64, 1024).astype(np.int32)
    bins[g.uniform(size=1024) < 0.4] = DEAD_BIN
    got = bin_destinations(torch.from_numpy(bins), 1024).numpy()
    np.testing.assert_array_equal(got, _jax_destinations(bins))
    np.testing.assert_array_equal(got, _stable_slots(bins))


@pytest.mark.parametrize("n, window", [(1000, 256), (777, 128), (2048, 512),
                                       (5, 256)])
def test_bin_destinations_are_each_windows_stable_sort(n, window):
    g = np.random.default_rng(n)
    bins = g.integers(0, 72, n).astype(np.int32)
    got = bin_destinations(torch.from_numpy(bins), window).numpy()
    for w0 in range(0, n, window):
        np.testing.assert_array_equal(got[w0:w0 + window],
                                      _stable_slots(bins[w0:w0 + window]))


@pytest.mark.parametrize("kind", ["mesh", "spheres only"])
def test_kernel_scene_bbox_matches_pallas_accel(kind):
    if kind == "mesh":
        js, ts = _scene(JBuilder, JMaterial, JP), _scene(SceneBuilder,
                                                         Material, P)
    else:
        js, ts = _spheres_only(JBuilder, JMaterial), _spheres_only(
            SceneBuilder, Material)
    want = pt.prepare_pallas_accel(js.triangles, js.materials, scene=js).bbox
    ks = KernelScene.create(ts, build_cluster_accel(ts.triangles, 64))
    assert ks.bbox == want
    # The centre is the JAX kernel's 0.5 * (lo + hi) as a float32 value.
    assert ks.bin_center == tuple(
        float(jnp.float32(0.5 * (want[a] + want[a + 3]))) for a in range(3))
    args = ks.args
    assert (args.bin_cx, args.bin_cy, args.bin_cz) == ks.bin_center


def test_scene_shards_carry_the_global_bbox():
    js, ts = jfix.scene1(), fixtures.scene1()
    want = pt.prepare_pallas_accel_sharded(js.triangles, js.materials,
                                           max_shard_tris=200).stacked.bbox
    cfg = RenderConfig(tracer="pallas")
    shards = shard_kernel_scenes(ts, shard_scene_pallas_accels(ts, cfg, 4),
                                 ["cpu"] * 4)
    assert len(shards) == 4
    assert all(ks.bbox == tuple(want) for ks in shards)
    assert scene_bbox(shards[1].accel.triangles) != tuple(want)


class _Spy:
    def __init__(self, base):
        self.base, self.calls = base, []

    def __call__(self, ro, rd, alive=None, bin_rays=False):
        self.calls.append(bin_rays)
        return self.base(ro, rd)


@pytest.mark.parametrize("window", [(1, 2), (None, None), (1, None), (0, 7),
                                   (3, 3)])
def test_render_sample_sort_predicate_matches_jax(window):
    kw = dict(width=8, height=4, spp=1, bounces=8, tracer="brute",
              ray_bin_bounces=window)
    js = jax.tree_util.tree_map(jnp.asarray, jfix.scene1())
    ts = fixtures.scene1().to("cpu")
    cam_kw = dict(position=(0, 1.5, -6), look_at=(0, 1, 0), fov_y_deg=60,
                  aspect=2.0)
    jspy = _Spy(jax_brute(js))
    jax.eval_shape(lambda k: jax_render_sample(
        js, jspy, JCamera.create(**cam_kw), k, JConfig(**kw)),
        jax.random.key(0))
    tspy = _Spy(make_brute_tracer(ts))
    render_sample(ts, tspy, Camera.create(**cam_kw), rng.key(0),
                  RenderConfig(**kw))
    assert tspy.calls == jspy.calls
    assert len(tspy.calls) == 8
    lo, hi = window
    assert tspy.calls == [lo is not None and hi is not None and lo <= b <= hi
                          for b in range(8)]


@pytest.fixture(scope="module")
def kscene():
    ts = _scene(SceneBuilder, Material, P)
    return KernelScene.create(ts, build_cluster_accel(ts.triangles, 64))


def _bits(x):
    return torch.as_tensor(x).contiguous().view(torch.int32)


def _trace_inputs(n, seed):
    g = np.random.default_rng(seed)
    ro = g.uniform(-4, 4, (3, n)).astype(np.float32) \
        + np.array([[0], [2], [-6]], np.float32)
    rd = g.normal(size=(3, n)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    return (tuple(torch.from_numpy(c) for c in ro),
            tuple(torch.from_numpy(c) for c in rd),
            torch.from_numpy(g.uniform(size=n) > 0.3))


@pytest.mark.parametrize("n", [1000, 3 * SORT_WINDOW, 5])
def test_plain_trace_bit_equal_sorted(kscene, n):
    ro, rd, alive = _trace_inputs(n, seed=n)
    h0 = trace_hits(kscene, ro, rd, alive)
    order = torch.full((n,), -1, dtype=torch.int32)
    h1 = trace_hits(kscene, ro, rd, alive, bin_rays=True, order=order)
    for f in ("t", "position", "normal", "albedo", "specular", "emission",
              "smoothness"):
        a, b = getattr(h0, f), getattr(h1, f)
        a = torch.stack(a) if isinstance(a, tuple) else a
        b = torch.stack(b) if isinstance(b, tuple) else b
        assert torch.equal(_bits(a), _bits(b)), f
    assert torch.equal(h0.prim, h1.prim)
    for w0 in range(0, n, SORT_WINDOW):
        np.testing.assert_array_equal(
            order[w0:w0 + SORT_WINDOW].numpy(),
            _stable_slots(ray_bin_ids(ro, rd, alive, kscene.bin_center)
                          [w0:w0 + SORT_WINDOW].numpy()))


def _path_inputs(n, nb, seed):
    ro, rd, _ = _trace_inputs(n, seed)
    g = np.random.default_rng(seed + 1)
    u = g.uniform(size=(nb, 3, n)).astype(np.float32)
    two_pi = np.float32(2.0 * 3.14159265)
    uni = np.stack([u[:, 0], np.log2(np.maximum(u[:, 1], np.float32(1e-12))),
                    np.cos(two_pi * u[:, 2]), np.sin(two_pi * u[:, 2]),
                    g.uniform(size=(nb, n)).astype(np.float32)], axis=1)
    return ro, rd, torch.from_numpy(uni.astype(np.float32))


@pytest.mark.parametrize("b0, nb, window", [(0, 4, (1, 2)), (1, 3, (1, 2)),
                                            (2, 2, (0, 7)), (0, 3, (0, 0))])
def test_plain_path_bit_equal_sorted(kscene, b0, nb, window):
    ro, rd, uni = _path_inputs(700, nb, seed=b0 + 10 * nb)
    alive0 = torch.from_numpy(np.random.default_rng(nb).uniform(size=700)
                              > 0.2).float()
    energy0 = tuple(torch.full((700,), 0.5 + 0.1 * k) for k in range(3))
    outs = [path_trace(kscene, ro, rd, uni,
                       RenderConfig(bounces=6, ray_bin_bounces=w), b0=b0,
                       nb=nb, alive0=alive0, energy0=energy0,
                       emit_state=True)
            for w in (window, (None, None))]
    for a, b in zip(outs[0][:3], outs[1][:3]):
        assert torch.equal(_bits(torch.stack(a)), _bits(torch.stack(b)))
    assert torch.equal(_bits(outs[0][3]), _bits(outs[1][3]))


def test_render_with_sort_matches_brute():
    cfg = RenderConfig(width=32, height=32, spp=1, bounces=3, tracer="pallas",
                       ray_bin_bounces=(1, 2))
    cam = Camera.create(position=(0, 1.5, -6), look_at=(0, 1, 0),
                        fov_y_deg=60, aspect=1.0)
    scene = _scene(SceneBuilder, Material, P).to("cpu")
    tracer = get_tracer(scene, cfg)
    img_p = render_sample(scene, tracer, cam, rng.key(3), cfg).numpy()
    cfg_b = cfg.replace(tracer="brute", ray_chunk=2048)
    img_b = render_sample(scene, get_tracer(scene, cfg_b), cam, rng.key(3),
                          cfg_b).numpy()
    assert rmse(img_p, img_b) < 1e-4
    img_u = render_sample(scene, tracer, cam, rng.key(3),
                          cfg.replace(ray_bin_bounces=(None, None))).numpy()
    assert (img_p.view(np.int32) == img_u.view(np.int32)).all()
