"""The "bvh" and "cluster" tracers (``ops/traverse.py``) against the JAX
package's, on the CPU, where the port runs the JAX package's two
strategies (the per-ray stack traversal and the sorted cluster sweep).

Same scene, accel and rays (made with numpy from a seed) on both sides.
Bars: where a triangle wins, t within 1e-5 relative and the attribute rows
within 1e-4 (XLA and torch round the normal's blend and normalisation a
few ulp apart), and the hit masks equal, except on near-tie and grazing
rays (a different triangle at an equal t, a ray that starts within 1e-6
of a surface or skims an edge: counted, at most 0.5% of the rays); ground and
sphere winners, from the dense candidates the brute tracer shares, t
within 1e-4 relative (the packages round the sphere quadratic apart);
every winner the port's strategy finds
is the exhaustive test's (``closest_hit_plain`` over the same accel) apart
from near ties at t within 1e-5; the push is the JAX one-hot push bit for
bit; renders of one seed within RMSE 1e-5 of the JAX renders (the
tracers' hits agree, and only the transcendental functions' rounding
separates the frames, as for the brute tracer)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unityraytracer_tpu import RenderConfig as JConfig
from unityraytracer_tpu import Renderer as JRenderer
from unityraytracer_tpu.models import fixtures as jfix
from unityraytracer_tpu.ops import traverse as jtrav
from unityraytracer_tpu.ops.bvh import build_cluster_accel as jbuild
from unityraytracer_tpu_torch import RenderConfig, Renderer
from unityraytracer_tpu_torch.models import fixtures as tfix
from unityraytracer_tpu_torch.ops import traverse
from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
from unityraytracer_tpu_torch.ops.cuda_trace import (KernelScene,
                                                     closest_hit_plain)
from unityraytracer_tpu_torch.ops.shade import MISS_T
from unityraytracer_tpu_torch.render import render_aovs
from unityraytracer_tpu_torch.utils.image import rmse
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


N_RAYS = 3000
TIE_FRACTION = 0.005


def _scenes(name):
    if name == "scene1":
        return jfix.scene1(), tfix.scene1()
    return jfix.bench_scene(n_tris=2000), tfix.bench_scene(n_tris=2000)


def _rays(scene, seed):
    """Rays from above toward random triangles' centroids, and rays leaving
    points just above random triangles' centroids upward."""
    g = np.random.default_rng(seed)
    tr = scene.triangles
    cen = (np.asarray(tr.v0) + np.asarray(tr.v1) + np.asarray(tr.v2)) / 3
    n = N_RAYS // 2
    hit_at = cen[g.integers(0, len(cen), n)] + g.normal(0, 0.05, (n, 3))
    ro = np.concatenate([hit_at + g.uniform(-6, 6, (n, 3)) + (0, 10, 0),
                         cen[g.integers(0, len(cen), N_RAYS - n)]
                         + (0, 0.05, 0)])
    up = g.normal(size=(N_RAYS - n, 3))
    up[:, 1] = np.abs(up[:, 1])
    rd = np.concatenate([hit_at - ro[:n], up])
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.T.astype(np.float32), rd.T.astype(np.float32)


def _rows(hit):
    return np.stack([np.asarray(c) for c in (
        *hit.normal, *hit.albedo, *hit.specular, *hit.emission,
        hit.smoothness)])


@pytest.mark.parametrize("scene_name", ["scene1", "bench"])
@pytest.mark.parametrize("tracer", ["bvh", "cluster"])
def test_tracer_matches_jax(tracer, scene_name):
    jscene, tscene = _scenes(scene_name)
    cfg = RenderConfig(tracer=tracer, cluster_size=16, ray_chunk=1024)
    jcfg = JConfig(tracer=tracer, cluster_size=16, ray_chunk=1024)
    accel = build_cluster_accel(tscene.triangles, cluster_size=16)
    scene = tscene.to("cpu")
    ro, rd = _rays(jscene, 7)
    t_ro, t_rd = tuple(map(torch.from_numpy, ro)), tuple(map(torch.from_numpy,
                                                            rd))
    hp = traverse.make_accel_tracer(scene, accel, cfg)(t_ro, t_rd)
    hj = jtrav.make_accel_tracer(
        jscene, jbuild(jscene.triangles, cluster_size=16, use_native=False),
        jcfg)(tuple(map(jnp.asarray, ro)), tuple(map(jnp.asarray, rd)))

    tp, tj = hp.t.numpy(), np.asarray(hj.t)
    hit_p, hit_j = tp < MISS_T, tj < MISS_T
    both = hit_p & hit_j
    tri = both & (hp.prim.numpy() < accel.triangles.count)
    assert tri.sum() > N_RAYS // 3
    rel = np.abs(tp - tj) / np.where(both, tj, 1.0)
    err = np.abs(_rows(hp) - _rows(hj)).max(axis=0)
    differ = (hit_p != hit_j) | (tri & ((rel > 1e-5) | (err > 1e-4)))
    assert differ.sum() <= TIE_FRACTION * N_RAYS, differ.sum()
    # Ground and sphere winners come from the dense candidates both tracers
    # share with the brute tracer, whose sphere t the packages round apart
    # by up to ~3e-5 relative (the quadratic's cancellation).
    assert rel[both & ~tri].max(initial=0) <= 1e-4
    # Winners against the exhaustive test over the same accel.
    hb = closest_hit_plain(KernelScene.create(scene, accel), t_ro, t_rd)
    flips = (hp.prim != hb.prim).numpy()
    tb = hb.t.numpy()
    assert (np.abs(tp - tb) <= 1e-5 * np.abs(tb))[flips].all()
    assert flips.sum() <= TIE_FRACTION * N_RAYS, flips.sum()


def test_masked_push_matches_jax():
    g = np.random.default_rng(3)
    R = 500
    stack = g.integers(0, 99, (R, traverse.STACK_DEPTH)).astype(np.int32)
    sp = g.integers(0, traverse.STACK_DEPTH + 3, R).astype(np.int32)
    value = g.integers(0, 99, R).astype(np.int32)
    mask = g.random(R) < 0.6
    got = traverse._masked_push(torch.tensor(stack), torch.from_numpy(sp),
                                torch.from_numpy(value),
                                torch.from_numpy(mask))
    want = jtrav._masked_push(jnp.asarray(stack), jnp.asarray(sp),
                              jnp.asarray(value), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert traverse.STACK_DEPTH == jtrav.STACK_DEPTH


@pytest.mark.parametrize("tracer", ["bvh", "cluster"])
def test_render_matches_jax_same_seed(tracer):
    kw = dict(width=32, height=24, spp=1, bounces=2, tracer=tracer,
              cluster_size=16, ray_chunk=1024, wavefront=True)
    cam = (jfix.scene1_camera(aspect=32 / 24), tfix.scene1_camera(32 / 24))
    j = JRenderer(jfix.scene1(), cam[0], JConfig(**kw), seed=5).step(2)
    t = Renderer(tfix.scene1(), cam[1], RenderConfig(**kw), seed=5,
                 device="cpu").step(2)
    assert rmse(t.image, j.image) <= 1e-5


@pytest.mark.parametrize("tracer", ["bvh", "cluster"])
def test_accel_tracers_equal_the_kernel_route(tracer):
    """On the CPU the strategies and the closest-hit kernel's plain version
    give the same frame and AOVs at one seed (the card runs the kernel for
    both names)."""
    kw = dict(width=32, height=16, spp=1, bounces=3, cluster_size=16,
              ray_chunk=1024, megakernel=False)
    scene, cam = tfix.scene1(), tfix.scene1_camera(2.0)
    a = Renderer(scene, cam, RenderConfig(tracer=tracer, **kw), seed=2,
                 device="cpu").step(2)
    b = Renderer(scene, cam, RenderConfig(tracer="pallas", **kw), seed=2,
                 device="cpu").step(2)
    assert rmse(a.image, b.image) <= 1e-6
    ga = render_aovs(a.scene, a.config, cam, a.accel)
    gb = render_aovs(b.scene, b.config, cam, b.accel)
    assert torch.equal(ga["hit"], gb["hit"])
    torch.testing.assert_close(ga["depth"], gb["depth"], rtol=1e-5, atol=0)
