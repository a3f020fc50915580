"""Path kernel: the port's plain version (ops/cuda_path.py) against the JAX
package's ops/pallas_path.path_trace, run in interpret mode, on the same
rays and the same uniform rows, 4 bounces with Russian roulette active, on a
small scene with spheres and triangles.

The JAX kernel tests triangles as Pluecker edges, the port as Moller-
Trumbore; the two may pick different winners on near-ties (ROADMAP.md,
"Not faults"), and the transcendental functions round differently. So the
gate is the radiance RMSE < 1e-3 (the repo's image bar); the sky records of
rays that miss at bounce 0 must agree ray for ray, and at most 0.5% of the
deeper sky records may differ (a near-tie flip changes a path's later
history)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unityraytracer_tpu import Material as JMaterial
from unityraytracer_tpu import RenderConfig as JConfig
from unityraytracer_tpu import SceneBuilder as JBuilder
from unityraytracer_tpu.models import primitives as JP
from unityraytracer_tpu.ops.bvh import build_cluster_accel as jax_accel
from unityraytracer_tpu.ops.pallas_path import path_trace as jax_path_trace
from unityraytracer_tpu.ops.pallas_trace import prepare_pallas_accel
from unityraytracer_tpu.utils.math3d import trs_matrix
from unityraytracer_tpu_torch import Material, RenderConfig, SceneBuilder
from unityraytracer_tpu_torch.models import primitives as P
from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
from unityraytracer_tpu_torch.ops.cuda_path import path_trace, path_trace_plain
from unityraytracer_tpu_torch.ops.cuda_trace import KernelScene
from unityraytracer_tpu_torch.utils.image import rmse


def _scene(B, M, prims):
    b = B()
    v, f, n = prims.icosphere(2)
    b.add_mesh(v, f, transform=trs_matrix((0, 1, 0), (0, 30, 0), 2.0),
               material=M(albedo=(0.8, 0.3, 0.2), specular=(0.05,) * 3,
                          smoothness=0.6))
    v2, f2, _ = prims.cube()
    b.add_mesh(v2, f2, transform=trs_matrix((2.5, 0.5, 0.5), (0, 20, 0)),
               material=M(albedo=(0.2, 0.7, 0.3), specular=(0.6,) * 3,
                          smoothness=0.9))
    b.add_sphere((-2.5, 0.7, 0), 0.7, M(emission=(2.0, 1.0, 0.5)))
    b.add_sphere((0.5, 0.4, -2.0), 0.4)
    b.set_skybox(np.ones((4, 8, 3), np.float32) * 0.6)
    return b.build()


@pytest.fixture(scope="module")
def inputs():
    n, nb = 1024, 4
    rng = np.random.default_rng(5)
    ro = rng.uniform(-4, 4, (3, n)).astype(np.float32) \
        + np.array([[0], [2.5], [-6]], np.float32)
    tgt = rng.uniform(-2, 2, (3, n)).astype(np.float32) \
        + np.array([[0], [1], [0]], np.float32)
    rd = tgt - ro
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    u = rng.uniform(size=(nb, 3, n)).astype(np.float32)
    two_pi = np.float32(2.0 * 3.14159265)
    uni = np.stack([u[:, 0], np.log2(np.maximum(u[:, 1], np.float32(1e-12))),
                    np.cos(two_pi * u[:, 2]), np.sin(two_pi * u[:, 2]),
                    rng.uniform(size=(nb, n)).astype(np.float32)], axis=1)
    uni[:2, 4] = 1.0   # RR rows are inactive before bounce 2
    return ro, rd, uni.astype(np.float32)


def test_path_plain_matches_pallas_interpret(inputs):
    ro, rd, uni = inputs
    cfg = RenderConfig(bounces=4, tracer="pallas")
    js = _scene(JBuilder, JMaterial, JP)
    pa = prepare_pallas_accel(jax_accel(js.triangles, cluster_size=64,
                                        use_native=False),
                              js.materials, scene=js)
    jrad, jse, jsd = jax_path_trace(pa, tuple(jnp.asarray(c) for c in ro),
                                    tuple(jnp.asarray(c) for c in rd),
                                    jnp.asarray(uni),
                                    JConfig(bounces=4, tracer="pallas"),
                                    interpret=True)
    ts = _scene(SceneBuilder, Material, P)
    ks = KernelScene.create(ts, build_cluster_accel(ts.triangles, 64))
    tro = tuple(torch.from_numpy(c.copy()) for c in ro)
    trd = tuple(torch.from_numpy(c.copy()) for c in rd)
    rad, se, sd = path_trace(ks, tro, trd, torch.from_numpy(uni), cfg)

    j = np.stack([np.asarray(c) for c in jrad], -1)
    t = np.stack([c.numpy() for c in rad], -1)
    assert np.isfinite(t).all() and t.max() > 0.1
    err = rmse(t, j)
    assert err < 1e-3, err
    jse_ = np.stack([np.asarray(c) for c in jse], -1)
    tse_ = np.stack([c.numpy() for c in se], -1)
    differ = np.abs(tse_ - jse_).max(-1) > 1e-4
    assert differ.mean() <= 0.005, np.flatnonzero(differ)
    # Sky records of rays that miss at bounce 0 are identical.
    first_miss = (jse_ == 1.0).all(-1)
    assert first_miss.mean() > 0.05
    np.testing.assert_array_equal(tse_[first_miss], jse_[first_miss])
    for k in range(3):
        np.testing.assert_array_equal(sd[k].numpy()[first_miss],
                                      np.asarray(jsd[k])[first_miss])


def test_path_plain_resume(inputs):
    # The resume inputs: rays dead on entry (alive0) give nothing, and a
    # start throughput (energy0) scales the radiance it carries.
    ro, rd, uni = inputs
    cfg = RenderConfig(bounces=4, tracer="pallas")
    ts = _scene(SceneBuilder, Material, P)
    ks = KernelScene.create(ts, build_cluster_accel(ts.triangles, 64))
    tro = tuple(torch.from_numpy(c.copy()) for c in ro)
    trd = tuple(torch.from_numpy(c.copy()) for c in rd)
    tu = torch.from_numpy(uni)
    full = path_trace_plain(ks, tro, trd, tu, cfg)
    assert np.isfinite(torch.stack(full[0]).numpy()).all()
    dead = torch.zeros(len(tro[0]))
    rad, se, sd = path_trace(ks, tro, trd, tu, cfg, alive0=dead)
    assert all((c == 0).all() for c in rad + se)
    half = tuple(torch.full_like(tro[0], 0.5) for _ in range(3))
    rad_h, _, _ = path_trace(ks, tro, trd, tu[:1], cfg, nb=1, energy0=half)
    rad_1, _, _ = path_trace(ks, tro, trd, tu[:1], cfg, nb=1)
    for k in range(3):
        np.testing.assert_allclose(rad_h[k].numpy(), 0.5 * rad_1[k].numpy(),
                                   rtol=1e-6)
