"""Ray/shading ops of the port against the JAX package, elementwise on random
inputs made with numpy.

Tolerances: floats agree to 1e-5 relative (atol 1e-6 for values near zero).
Both sides run float32, but the transcendental functions (acos, exp2, log2,
pow, sin, cos) and even sqrt round differently in torch and XLA:CPU by an
ulp or two; every other op is the same IEEE operation in the same order.
Integer texel coordinates and the RGBE decode must be exact. The bilinear
weights wy/wx are fractions of coordinates that reach H or W, so they are
held to 1e-5 of H or W (a few ulps of the coordinate)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unityraytracer_tpu import camera as jcam
from unityraytracer_tpu.ops import intersect as jint
from unityraytracer_tpu.ops import sampling as jsam
from unityraytracer_tpu.ops import shade as jsh
from unityraytracer_tpu_torch import camera as tcam
from unityraytracer_tpu_torch.models.skybox import sun_sky
from unityraytracer_tpu_torch.ops import intersect as tint
from unityraytracer_tpu_torch.ops import sampling as tsam
from unityraytracer_tpu_torch.ops import shade as tsh

RTOL, ATOL = 1e-5, 1e-6
N = 4096


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def pair(a):
    """One numpy float32 array as (jax array, torch tensor)."""
    a = np.ascontiguousarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def vec_pair(a):
    """(3, n) numpy -> (jax Vec3, torch Vec3)."""
    js, ts = zip(*(pair(c) for c in a))
    return tuple(js), tuple(ts)


def unit(rng, n):
    d = rng.normal(size=(3, n)).astype(np.float32)
    return d / np.linalg.norm(d, axis=0, keepdims=True)


def test_camera_rays_thin_lens():
    rng = np.random.default_rng(0)
    kw = dict(position=(0.3, 1.5, -6.0), look_at=(0, 1, 0), fov_y_deg=55.0,
              aspect=1.5, aperture=0.2, focus_dist=5.5)
    jc, tc = jcam.Camera.create(**kw), tcam.Camera.create(**kw)
    np.testing.assert_array_equal(np.asarray(jc.cam_to_world), tc.cam_to_world)
    (ju, tu), (jv, tv) = (pair(rng.uniform(-1, 1, N)) for _ in range(2))
    (jl1, tl1), (jl2, tl2) = (pair(rng.uniform(-0.7, 0.7, N)) for _ in range(2))
    jo, jd = jcam.camera_rays_soa(jc, ju, jv, jl1, jl2)
    to, td = tcam.camera_rays_soa(tc, tu, tv, tl1, tl2)
    for k in range(3):
        close(to[k], jo[k])
        close(td[k], jd[k])


def test_sampling_functions():
    rng = np.random.default_rng(1)
    jn, tn = vec_pair(unit(rng, N))
    for jt, tt in zip(jsam.tangent_frame(jn), tsam.tangent_frame(tn)):
        for k in range(3):
            close(tt[k], jt[k])
    (ju1, tu1), (ju2, tu2) = (pair(rng.uniform(size=N)) for _ in range(2))
    (ja, ta) = pair(rng.uniform(1, 900, N))
    jd = jsam.sample_hemisphere(ju1, ju2, jn, ja)
    td = tsam.sample_hemisphere(tu1, tu2, tn, ta)
    for k in range(3):
        close(td[k], jd[k], atol=1e-5)
    (jc, tc), (jp, tp), (js, ts) = (pair(rng.uniform(-1, 1, N))
                                    for _ in range(3))
    jd = jsam.sample_hemisphere_ct(jc, jp, js, jn)
    td = tsam.sample_hemisphere_ct(tc, tp, ts, tn)
    for k in range(3):
        close(td[k], jd[k], atol=1e-5)
    for jx, tx in zip(jsam.sample_unit_disk(ju1, ju2),
                      tsam.sample_unit_disk(tu1, tu2)):
        close(tx, jx)


def _rays(rng, n, spread=4.0):
    ro = rng.uniform(-spread, spread, (3, n)).astype(np.float32)
    ro[1] += 2.0
    return vec_pair(ro), vec_pair(unit(rng, n))


def _finite_mask(t):
    return np.asarray(t) < 1e30


def test_intersect_ground_and_spheres():
    rng = np.random.default_rng(2)
    (jro, tro), (jrd, trd) = _rays(rng, 2000)
    jt, tt = jint.intersect_ground(jro, jrd), tint.intersect_ground(tro, trd)
    np.testing.assert_array_equal(_finite_mask(tt), _finite_mask(jt))
    close(tt, jt)
    c = rng.uniform(-3, 3, (16, 3)).astype(np.float32)
    r = rng.uniform(0.2, 1.5, 16).astype(np.float32)
    jt = jint.intersect_spheres(jro, jrd, jnp.asarray(c), jnp.asarray(r))
    tt = tint.intersect_spheres(tro, trd, torch.from_numpy(c),
                                torch.from_numpy(r))
    np.testing.assert_array_equal(_finite_mask(tt), _finite_mask(jt))
    close(tt, jt)


def test_intersect_triangles():
    rng = np.random.default_rng(3)
    (jro, tro), (jrd, trd) = _rays(rng, 1500, spread=1.0)
    v0 = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    jr = jint.intersect_triangles(jro, jrd, *(jnp.asarray(v) for v in (v0, v1, v2)))
    tr = tint.intersect_triangles(tro, trd, *(torch.from_numpy(v) for v in (v0, v1, v2)))
    # MT97 is the same sequence of IEEE mul/add/div on both sides.
    for j, t in zip(jr, tr):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _random_hit(rng, n, lib):
    """Random hit records (a fifth are misses), as a JAX or a port Hit."""
    t = rng.uniform(0.5, 20, n).astype(np.float32)
    t[rng.uniform(size=n) < 0.2] = np.float32(np.finfo(np.float32).max)
    arrs = dict(
        position=rng.uniform(-5, 5, (3, n)), normal=unit(rng, n),
        albedo=rng.uniform(0, 1, (3, n)),
        specular=rng.uniform(0, 0.6, (3, n)) * (rng.uniform(size=n) < 0.5),
        emission=rng.uniform(0, 2, (3, n)) * (rng.uniform(size=n) < 0.1))
    smooth = rng.uniform(0, 1, n).astype(np.float32)
    if lib == "jax":
        return jsh.Hit(t=jnp.asarray(t), smoothness=jnp.asarray(smooth),
                       **{k: tuple(jnp.asarray(c.astype(np.float32)) for c in v)
                          for k, v in arrs.items()})
    return tsh.Hit(t=torch.from_numpy(t), smoothness=torch.from_numpy(smooth),
                   **{k: tuple(torch.from_numpy(c.astype(np.float32).copy())
                               for c in v) for k, v in arrs.items()})


@pytest.mark.parametrize("trig", [False, True])
def test_shade_matches_jax(trig):
    n = 3000
    jh = _random_hit(np.random.default_rng(4), n, "jax")
    th = _random_hit(np.random.default_rng(4), n, "torch")
    rng = np.random.default_rng(5)
    (jro, tro), (jrd, trd) = _rays(rng, n)
    je, te = vec_pair(rng.uniform(0, 1.5, (3, n)))
    us = [pair(rng.uniform(size=n)) for _ in range(3)]
    ju, tu = tuple(u[0] for u in us), tuple(u[1] for u in us)
    jtrig = ttrig = None
    if trig:
        u1, u2 = np.asarray(ju[1]), np.asarray(ju[2])
        rows = [np.log2(np.maximum(u1, np.float32(1e-12))),
                np.cos(np.float32(2 * 3.14159265) * u2),
                np.sin(np.float32(2 * 3.14159265) * u2)]
        jtrig, ttrig = zip(*(pair(r) for r in rows))
    jout = jsh.shade(jro, jrd, je, jh, ju, trig=jtrig)
    tout = tsh.shade(tro, trd, te, th, tu, trig=ttrig)
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))
    for jv, tv in zip(jout[:4], tout[:4]):
        for k in range(3):
            close(tv[k], jv[k], atol=1e-5)


def test_equirect_coords_and_rgbe_taps_exact():
    sky = sun_sky()
    H, W = sky.shape[:2]
    rng = np.random.default_rng(6)
    jd, td = vec_pair(unit(rng, N))
    jc = jsh._equirect_coords((H, W), jd)
    tc = tsh._equirect_coords((H, W), td)
    for j, t in zip(jc[:4], tc[:4]):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    close(tc[4], jc[4], rtol=0, atol=1e-5 * H)
    close(tc[5], jc[5], rtol=0, atol=1e-5 * W)

    packed = tsh.pack_rgbe_np(sky)
    jp = jnp.asarray(packed)
    tp = torch.from_numpy(packed.view(np.int32))
    # Decode of every word of the plane: exact.
    jdec = jsh._decode_rgbe(jp)
    tdec = tsh._decode_rgbe(tsh.rgbe_words(tp))
    for k in range(3):
        np.testing.assert_array_equal(tdec[k].numpy(), np.asarray(jdec[k]))
    (ju1, tu1), (ju2, tu2) = (pair(rng.uniform(size=N)) for _ in range(2))
    # The stochastic tap, with the baked plane and packing on the fly.
    for jpk, tpk in ((jp, tp), (None, None)):
        j = jsh.sample_skybox_rgbe(jnp.asarray(sky), jd, u1=ju1, u2=ju2,
                                   packed=jpk)
        t = tsh.sample_skybox_rgbe(torch.from_numpy(sky), td, tu1, tu2,
                                   packed=tpk)
        for k in range(3):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def test_sample_skybox_bilinear():
    # The float sky (sky_rgbe=False). Each output blends texels with the
    # weights wy/wx, which carry a few ulps of the texel coordinate (see the
    # module docstring), times texel differences up to the sun's 50: hence
    # 1e-4 relative and absolute.
    sky = sun_sky(32, 64)
    rng = np.random.default_rng(7)
    jd, td = vec_pair(unit(rng, N))
    j = jsh.sample_skybox(jnp.asarray(sky), jd)
    t = tsh.sample_skybox(torch.from_numpy(sky), td)
    for k in range(3):
        close(t[k], j[k], rtol=1e-4, atol=1e-4)
