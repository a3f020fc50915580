"""The rest of the port's camera module against the JAX package's
``camera.py``: ``orbit``, ``interpolate``, ``turntable`` (host numpy, through
``Camera.create``), ``camera_rays`` and ``pixel_uv`` (torch), on inputs made
from a seed, to 1e-6; and the behaviour cases of ``tests/test_camera.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unityraytracer_tpu import camera as jcam
from unityraytracer_tpu_torch import camera as tcam

TOL = dict(rtol=0, atol=1e-6)


def _same_camera(t, j):
    assert [f.name for f in dataclasses.fields(t)] \
        == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(t):
        a = np.asarray(getattr(t, f.name))
        assert a.dtype == np.float32, f.name        # host floats, no upload
        np.testing.assert_allclose(a, np.asarray(getattr(j, f.name)),
                                   err_msg=f.name, **TOL)


@pytest.mark.parametrize("seed", range(4))
def test_orbit_equals_jax(seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, 3)
    kw = dict(radius=float(rng.uniform(1, 20)),
              azimuth_deg=float(rng.uniform(-360, 360)),
              elevation_deg=float(rng.uniform(-80, 80)),
              fov_y_deg=float(rng.uniform(20, 100)), aspect=16 / 9,
              aperture=0.1 * seed, focus_dist=3.0 + seed)
    _same_camera(tcam.orbit(c, **kw), jcam.orbit(c, **kw))


@pytest.mark.parametrize("t", [0.0, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("pair", ["quarter_turn", "near_half_turn", "same"])
def test_interpolate_equals_jax(pair, t):
    az = {"quarter_turn": 90.0, "near_half_turn": 179.0, "same": 0.0}[pair]

    def ends(m):
        return (m.orbit((0, 0, 0), 4.0, 0.0, 10.0, fov_y_deg=50.0,
                        aperture=0.1, focus_dist=2.0),
                m.orbit((1, 2, 3), 6.0, az, -35.0, fov_y_deg=70.0,
                        aspect=2.0, aperture=0.3, focus_dist=9.0))

    _same_camera(tcam.interpolate(*ends(tcam), t),
                 jcam.interpolate(*ends(jcam), t))


def test_quaternion_helpers_equal_jax():
    rng = np.random.default_rng(5)
    for _ in range(16):                   # every branch of the trace test
        q = rng.normal(size=4)
        r = jcam._mat_from_quat(q)
        np.testing.assert_array_equal(tcam._mat_from_quat(q), r)
        np.testing.assert_array_equal(tcam._quat_from_mat(r),
                                      jcam._quat_from_mat(r))


def test_turntable_equals_jax_and_closes_loop():
    cams = tcam.turntable((0, 1, 0), 3.0, 8, elevation_deg=20.0, aspect=1.5)
    ref = jcam.turntable((0, 1, 0), 3.0, 8, elevation_deg=20.0, aspect=1.5)
    assert len(cams) == len(ref) == 8
    for t, j in zip(cams, ref):
        _same_camera(t, j)
    ps = np.stack([c.position for c in cams])
    np.testing.assert_allclose(np.linalg.norm(ps - [0, 1, 0], axis=1), 3.0,
                               atol=1e-5)
    assert np.unique(np.round(ps[:, 0], 4)).size > 4


@pytest.mark.parametrize("lens", [False, True])
def test_camera_rays_equal_jax(lens):
    rng = np.random.default_rng(7)
    uv = rng.uniform(-1, 1, (5, 40, 2)).astype(np.float32)
    luv = rng.uniform(-1, 1, (5, 40, 2)).astype(np.float32) if lens else None
    kw = dict(position=(1, 2, -3), look_at=(3, 1, 2), fov_y_deg=81,
              aspect=16 / 9, aperture=0.2 if lens else 0.0, focus_dist=5.0)
    o, d = tcam.camera_rays(tcam.Camera.create(**kw), torch.as_tensor(uv),
                            None if luv is None else torch.as_tensor(luv))
    jo, jd = jcam.camera_rays(jcam.Camera.create(**kw), jnp.asarray(uv),
                              None if luv is None else jnp.asarray(luv))
    assert o.shape == d.shape == (5, 40, 3) and d.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(np.linalg.norm(d.numpy(), axis=-1), 1.0,
                               atol=1e-5)


def test_pixel_uv_equals_jax_and_maps_corners():
    rng = np.random.default_rng(9)
    px = rng.integers(0, 37, (64,))
    py = rng.integers(0, 23, (64,))
    jit = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    got = tcam.pixel_uv(torch.as_tensor(px), torch.as_tensor(py),
                        torch.as_tensor(jit), 37, 23)
    want = jcam.pixel_uv(jnp.asarray(px), jnp.asarray(py), jnp.asarray(jit),
                         37, 23)
    assert got.shape == (64, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # Bottom-left pixel centre -> near (-1,-1); top-right -> near (1,1).
    uv = tcam.pixel_uv(torch.tensor([0, 15]), torch.tensor([0, 15]),
                       torch.full((2, 2), 0.5), 16, 16).numpy()
    np.testing.assert_allclose(uv[0], [-1 + 1 / 16, -1 + 1 / 16], atol=1e-6)
    np.testing.assert_allclose(uv[1], [1 - 1 / 16, 1 - 1 / 16], atol=1e-6)


def test_camera_rays_behaviour():
    """The cases of the JAX camera tests: centre ray, fov edge, the
    left-handed basis, the focal plane, an explicit matrix."""
    cam = tcam.Camera.create(position=(1, 2, 3), look_at=(1, 2, 10),
                             fov_y_deg=60)
    o, d = tcam.camera_rays(cam, torch.tensor([[0.0, 0.0]]))
    np.testing.assert_allclose(o.numpy()[0], [1, 2, 3], atol=1e-6)
    np.testing.assert_allclose(d.numpy()[0], [0, 0, 1], atol=1e-6)

    cam = tcam.Camera.create(look_at=(0, 0, 1), fov_y_deg=60.0)
    _, d = tcam.camera_rays(cam, torch.tensor([[0.0, 1.0]]))
    d = d.numpy()[0]
    assert np.isclose(np.rad2deg(np.arctan2(d[1], d[2])), 30.0, atol=1e-4)

    cam = tcam.Camera.create(look_at=(0, 0, 1), fov_y_deg=90)
    _, d = tcam.camera_rays(cam, torch.tensor([[1.0, 0.0]]))
    assert d.numpy()[0, 0] > 0.5

    cam = tcam.Camera.create(look_at=(0, 0, 1), fov_y_deg=60, aperture=0.2,
                             focus_dist=5.0)
    o, d = tcam.camera_rays(cam, torch.tensor([[0.3, -0.2], [0.3, -0.2]]),
                            torch.tensor([[0.9, 0.0], [-0.4, 0.7]]))
    o, d = o.numpy(), d.numpy()
    np.testing.assert_allclose(o[0] + d[0] * (5.0 / d[0, 2]),
                               o[1] + d[1] * (5.0 / d[1, 2]), atol=1e-4)

    cam1 = tcam.Camera.create(position=(0, 1, -10), look_at=(0, 1, 0),
                              fov_y_deg=81)
    cam2 = tcam.Camera.create(cam_to_world=cam1.cam_to_world, fov_y_deg=81)
    uv = torch.tensor([[0.25, -0.5]])
    np.testing.assert_allclose(tcam.camera_rays(cam1, uv)[1].numpy(),
                               tcam.camera_rays(cam2, uv)[1].numpy(),
                               atol=1e-6)


def test_orbit_and_interpolate_behaviour():
    c = (1.0, 2.0, 3.0)
    cam = tcam.orbit(c, radius=5.0, azimuth_deg=0.0, elevation_deg=0.0)
    np.testing.assert_allclose(cam.position, [1.0, 2.0, -2.0], atol=1e-5)
    np.testing.assert_allclose(cam.cam_to_world[:3, 2], [0, 0, 1], atol=1e-5)
    p2 = tcam.orbit(c, radius=5.0, azimuth_deg=45.0,
                    elevation_deg=30.0).position
    assert abs(np.linalg.norm(p2 - np.asarray(c)) - 5.0) < 1e-5
    assert p2[1] > 2.0

    a = tcam.orbit((0, 0, 0), 4.0, 0.0, 10.0, fov_y_deg=50.0)
    b = tcam.orbit((0, 0, 0), 4.0, 90.0, 10.0, fov_y_deg=70.0)
    for t, ref in ((0.0, a), (1.0, b)):
        np.testing.assert_allclose(tcam.interpolate(a, b, t).cam_to_world,
                                   ref.cam_to_world, atol=1e-5)
    mid = tcam.interpolate(a, b, 0.5)
    r = mid.cam_to_world[:3, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    assert abs(float(mid.tan_half_fov)
               - 0.5 * (np.tan(np.deg2rad(25)) + np.tan(np.deg2rad(35)))) \
        < 1e-5


def test_public_names_of_the_jax_package_are_exported():
    import unityraytracer_tpu as jpkg
    import unityraytracer_tpu_torch as tpkg

    for name in jpkg.__all__:
        assert hasattr(tpkg, name) and name in tpkg.__all__, name
    assert tpkg.__version__ == jpkg.__version__
    assert tpkg.camera_rays is tcam.camera_rays
    assert dataclasses.asdict(tpkg.GROUND_MATERIAL) \
        == dataclasses.asdict(jpkg.GROUND_MATERIAL)
