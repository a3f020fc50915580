"""Closest hit: the port's trace_brute and the plain version of the
closest-hit kernel (exhaustive MT97 over the accel's triangles) against the
JAX package's trace_brute on bench_scene(n_tris=2000) rays.

Hit/miss and winners must be identical; t agrees to 1e-5 relative (the MT97
arithmetic is the same IEEE sequence on both sides, so t is in practice
bit-equal; sphere t and normals pass through sqrt, which torch rounds
differently from XLA:CPU by an ulp)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unityraytracer_tpu.models import fixtures as jfix
from unityraytracer_tpu.ops.trace import trace_brute as jax_trace_brute
from unityraytracer_tpu_torch.models import fixtures as tfix
from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
from unityraytracer_tpu_torch.ops.cuda_trace import (KernelScene,
                                                     closest_hit_plain,
                                                     make_pallas_tracer,
                                                     trace_hits)
from unityraytracer_tpu_torch.ops.trace import trace_brute


@pytest.fixture(scope="module")
def setup():
    js = jfix.bench_scene(n_tris=2000)
    ts = tfix.bench_scene(n_tris=2000)
    rng = np.random.default_rng(11)
    # Camera rays over the field plus rays from random points in all
    # directions (hits from inside spheres, grazing rays, sky).
    cam = tfix.bench_camera(aspect=64 / 48)
    u = rng.uniform(-1, 1, 3072).astype(np.float32)
    v = rng.uniform(-1, 1, 3072).astype(np.float32)
    from unityraytracer_tpu_torch.camera import camera_rays_soa
    co, cd = camera_rays_soa(cam, torch.from_numpy(u), torch.from_numpy(v))
    ro = rng.uniform(-4, 4, (3, 1024)).astype(np.float32)
    ro[1] = np.abs(ro[1]) + 0.5
    rd = rng.normal(size=(3, 1024)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    ro = np.concatenate([np.stack([c.numpy() for c in co]), ro], axis=1)
    rd = np.concatenate([np.stack([c.numpy() for c in cd]), rd], axis=1)
    jh = jax_trace_brute(js, tuple(jnp.asarray(c) for c in ro),
                         tuple(jnp.asarray(c) for c in rd))
    tro = tuple(torch.from_numpy(c.copy()) for c in ro)
    trd = tuple(torch.from_numpy(c.copy()) for c in rd)
    return js, ts, jh, tro, trd


def _check_against_jax(jh, th):
    jt = np.asarray(jh.t)
    tt = th.t.numpy()
    jhit = jt < 1e30
    np.testing.assert_array_equal(tt < 1e30, jhit)
    assert jhit.mean() > 0.3 and (~jhit).mean() > 0.05
    np.testing.assert_allclose(tt[jhit], jt[jhit], rtol=1e-5)
    # Same winner: same material and (to rounding) the same shading normal.
    for k in range(3):
        np.testing.assert_array_equal(th.albedo[k].numpy()[jhit],
                                      np.asarray(jh.albedo[k])[jhit])
        np.testing.assert_array_equal(th.emission[k].numpy()[jhit],
                                      np.asarray(jh.emission[k])[jhit])
        np.testing.assert_allclose(th.normal[k].numpy()[jhit],
                                   np.asarray(jh.normal[k])[jhit],
                                   rtol=1e-5, atol=1e-6)


def test_trace_brute_matches_jax(setup):
    js, ts, jh, tro, trd = setup
    th = trace_brute(ts.to("cpu"), tro, trd)
    _check_against_jax(jh, th)
    # Small chunks give the same records.
    th2 = trace_brute(ts.to("cpu"), tro, trd, chunk=333)
    np.testing.assert_array_equal(th2.t.numpy(), th.t.numpy())
    np.testing.assert_array_equal(th2.prim.numpy(), th.prim.numpy())


def test_closest_hit_plain_matches_jax(setup):
    js, ts, jh, tro, trd = setup
    accel = build_cluster_accel(ts.triangles, cluster_size=64)
    ks = KernelScene.create(ts, accel)
    th = closest_hit_plain(ks, tro, trd)
    _check_against_jax(jh, th)
    # Winners identical to the scene-order oracle: map accel triangle
    # indices back to scene indices through the vertex data.
    tb = trace_brute(ts.to("cpu"), tro, trd)
    key = lambda a, b, c: [x.tobytes() for x in np.concatenate(  # noqa: E731
        [np.asarray(a), np.asarray(b), np.asarray(c)], axis=1)]
    scene_idx = {k: i for i, k in enumerate(key(ts.triangles.v0,
                                                 ts.triangles.v1,
                                                 ts.triangles.v2))}
    a_keys = key(accel.triangles.v0, accel.triangles.v1, accel.triangles.v2)
    T_acc, T = accel.triangles.count, ts.num_triangles
    pa, pb = th.prim.numpy(), tb.prim.numpy()
    mapped = np.array([scene_idx[a_keys[p]] if 0 <= p < T_acc
                       else (-1 if p < 0 else p - T_acc + T) for p in pa])
    np.testing.assert_array_equal(mapped, pb)
    # Dead rays report a miss with zero attributes, as the kernel does.
    alive = torch.arange(len(tro[0])) % 3 != 0
    hd = trace_hits(ks, tro, trd, alive)
    assert (hd.t.numpy()[~alive.numpy()] > 1e30).all()
    assert (hd.albedo[0].numpy()[~alive.numpy()] == 0).all()
    np.testing.assert_array_equal(hd.t.numpy()[alive.numpy()],
                                  th.t.numpy()[alive.numpy()])
    # The per-bounce tracer of tracer="pallas" is the same function on CPU.
    hp = make_pallas_tracer(ts.to("cpu"), accel)(tro, trd)
    np.testing.assert_array_equal(hp.t.numpy(), th.t.numpy())
