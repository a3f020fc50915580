"""The frame's camera rays: the plain version of the camera-ray kernel
against the JAX package's camera lines (``render_sample_mega``, built here
from its own ``jax.random`` calls, ``_draw_fn``, ``_ray_lattice``,
``sample_unit_disk`` and ``camera_rays_soa``), the kernel's per-ray twin
against the plain version, and the keys the kernels derive on the card.

Bars: the four draws are bit-exact against JAX, and so is the bounce key.
ro and rd agree with JAX to RAY_ULP ulp of each component's magnitude, and
to 1e-7 absolute at components near zero: u and v are IEEE divisions on
both sides, and the rest differ only where XLA:CPU's cos and sin differ
from torch's by an ulp. The twin (``torch_twins.camera_rays_twin``, fed
the ``CameraArgs`` the kernel is launched with) is bit-equal to the plain
version on the CPU in every layout; the prologues' keys are bit-equal to
``rng.split``/``fold_in``, ``rng.bounce_keys`` and JAX's."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twins import (bounce_prologue_keys, camera_prologue_keys,
                         camera_rays_twin)
from unityraytracer_tpu import camera as jcam
from unityraytracer_tpu import render as jrender
from unityraytracer_tpu.ops import sampling as jsam
from unityraytracer_tpu_torch import RenderConfig, _build, rng
from unityraytracer_tpu_torch import camera as tcam
from unityraytracer_tpu_torch.render import (_camera_rays, camera_args,
                                             camera_draws_plain,
                                             camera_rays_plain)

RAY_ULP = 4
# (width, height, rows, row0, spp, tracer, aperture): 8x16 block order;
# pixel order at a size that tiles (the bounce loop's draws at block
# slots); row-major at a size that does not tile; bands with row0 > 0;
# spp 3; the lens on and off.
CASES = {
    "blocked_lens": (32, 16, None, 0, 1, "pallas", 0.15),
    "blocked_pinhole": (32, 16, None, 0, 1, "pallas", 0.0),
    "pixel_order": (32, 16, None, 0, 2, "brute", 0.15),
    "non_tiling": (20, 12, None, 0, 1, "pallas", 0.15),
    "band_blocked": (32, 40, 16, 8, 1, "pallas", 0.15),
    "band_pixel_order": (48, 40, 16, 16, 1, "brute", 0.0),
    "spp3_blocked": (32, 16, None, 0, 3, "pallas", 0.15),
}


def _case(case):
    W, H, rows, row0, spp, tracer, ap = CASES[case]
    cfg = RenderConfig(width=W, height=H, spp=spp, bounces=2, tracer=tracer)
    h = H if rows is None else rows
    blocked = tracer == "pallas" and h % 8 == 0 and W % 16 == 0
    kw = dict(position=(0.3, 1.5, -6.0), look_at=(0.0, 1.0, 0.0),
              fov_y_deg=55.0, aspect=W / H, aperture=ap, focus_dist=5.5)
    return cfg, h, row0, blocked, kw


def _key(case):
    return rng.key(100 + list(CASES).index(case))


def _jax_camera(kw, key_data, cfg, h, row0, blocked):
    """The camera lines of the JAX package's render_sample_mega: (draws,
    ro, rd, k_bounce) as numpy arrays."""
    H, W, spp = cfg.height, cfg.width, cfg.spp
    N = spp * h * W
    key = jax.random.wrap_key_data(jnp.asarray(key_data, jnp.uint32))
    k_jit, k_lens, k_bounce = jax.random.split(key, 3)
    draw = jrender._draw_fn(h, W, spp, blocked)
    px, prow = jrender._ray_lattice(h, W, spp, blocked)
    py = (H - 1) - (row0 + prow)
    draws = [draw(jax.random.uniform(jax.random.fold_in(k, r), (N,)))
             for k in (k_jit, k_lens) for r in (0, 1)]
    jx, jy, lu1, lu2 = draws
    u = (px.astype(jnp.float32) + jx) / W * 2.0 - 1.0
    v = (py.astype(jnp.float32) + jy) / H * 2.0 - 1.0
    lens_u, lens_v = jsam.sample_unit_disk(lu1, lu2)
    ro, rd = jcam.camera_rays_soa(jcam.Camera.create(**kw), u, v, lens_u,
                                  lens_v)
    return ([np.asarray(a) for a in draws], np.stack(ro), np.stack(rd),
            np.asarray(jax.random.key_data(k_bounce)))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_camera_rays_match_jax(case):
    cfg, h, row0, blocked, kw = _case(case)
    key = _key(case)
    draws, jro, jrd, jk_bounce = _jax_camera(kw, key, cfg, h, row0, blocked)
    got = camera_draws_plain(key, h, cfg.width, cfg.spp, blocked, "cpu")
    for a, b in zip(got, draws):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    ro, rd, k_bounce = _camera_rays(tcam.Camera.create(**kw), key, cfg, h,
                                    cfg.width, cfg.spp, row0, blocked, "cpu")
    np.testing.assert_array_equal(k_bounce, jk_bounce)
    for got3, want in ((ro, jro), (rd, jrd)):
        got3 = torch.stack(got3).numpy()
        assert got3.shape == want.shape == (3, cfg.spp * h * cfg.width)
        err = np.abs(got3 - want)
        lim = np.maximum(RAY_ULP * np.spacing(np.abs(want)), 1e-7)
        assert (err <= lim).all(), float((err / lim).max())
    np.testing.assert_allclose(np.linalg.norm(torch.stack(rd).numpy(),
                                              axis=0), 1.0, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_twin_is_plain_camera_rays(case):
    cfg, h, row0, blocked, kw = _case(case)
    cam, key = tcam.Camera.create(**kw), _key(case)
    args = camera_args(cam, key, cfg, h, cfg.width, cfg.spp, row0, blocked)
    to, td = camera_rays_twin(args)
    po, pd = camera_rays_plain(cam, key, cfg, h, cfg.width, cfg.spp, row0,
                               blocked, "cpu")
    assert torch.equal(to.view(torch.int32), torch.stack(po).view(torch.int32))
    assert torch.equal(td.view(torch.int32), torch.stack(pd).view(torch.int32))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_prologue_keys_are_split_and_fold_in(seed):
    key = rng.fold_in(rng.key(seed), 3)
    k_jit, k_lens, k_bounce = rng.split(key, 3)
    want = np.array([rng.fold_in(k, r) for k in (k_jit, k_lens)
                     for r in (0, 1)])
    np.testing.assert_array_equal(camera_prologue_keys(key), want)
    jk = jax.random.wrap_key_data(jnp.asarray(key, jnp.uint32))
    jj, jl, _ = jax.random.split(jk, 3)
    np.testing.assert_array_equal(want, np.array([
        jax.random.key_data(jax.random.fold_in(k, r)) for k in (jj, jl)
        for r in (0, 1)]))
    # The uniform-row kernel's prologue, at the most bounces it holds.
    nb = _build.MAX_BOUNCES
    np.testing.assert_array_equal(bounce_prologue_keys(k_bounce, nb),
                                  rng.bounce_keys(k_bounce, nb))
    np.testing.assert_array_equal(
        bounce_prologue_keys(k_bounce, nb)[nb - 1, 3],
        np.asarray(jax.random.key_data(jax.random.fold_in(
            jax.random.fold_in(jax.random.split(jk, 3)[2], nb - 1), 3))))


def test_camera_args_hold_the_rounded_camera(monkeypatch):
    cfg, h, row0, blocked, kw = _case("band_blocked")
    cam, key = tcam.Camera.create(**kw), _key("band_blocked")
    calls, hash_ = [], rng.threefry2x32
    monkeypatch.setattr(rng, "threefry2x32",
                        lambda *a: calls.append(a) or hash_(*a))
    a = camera_args(cam, key, cfg, h, cfg.width, cfg.spp, row0, blocked)
    assert calls == []                     # the kernel derives the keys
    assert (a.k0, a.k1) == tuple(int(w) for w in key)
    assert (a.n, a.h, a.W, a.H, a.row0, a.blocked, a.pixel_order) == (
        512, 16, 32, 40, 8, 1, 0)
    f = np.float32
    np.testing.assert_array_equal(np.array(a.m, f),
                                  cam.cam_to_world[:3].reshape(12))
    assert f(a.thf_aspect) == f(cam.tan_half_fov) * f(cam.aspect)
    assert (f(a.thf), f(a.focus), f(a.aperture)) == (
        cam.tan_half_fov, cam.focus_dist, cam.aperture)
    pix = camera_args(cam, key, cfg.replace(tracer="brute"), h, cfg.width,
                      cfg.spp, row0, False)
    assert (pix.blocked, pix.pixel_order) == (0, 1)
    with pytest.raises(ValueError, match="32-bit"):
        camera_args(cam, key, cfg, 2 ** 16, 2 ** 15, 1, 0, True)


def test_camera_args_mirror_the_header():
    src = (_build.CSRC / "camera_kernel.cu").read_text()
    body = re.search(r"struct CameraArgs \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(unsigned int|int|float)\s+(\w+)(?:\[(\d+)\])?;",
                        body, re.M)
    ctypes_of = {"unsigned int": "c_uint", "int": "c_int", "float": "c_float"}
    got = _build.CameraArgs._fields_
    assert [name for _, name, _ in fields] == [name for name, _ in got]
    for (ty, _, length), (_, cty) in zip(fields, got):
        base = getattr(cty, "_type_", cty) if length else cty
        assert base.__name__ == ctypes_of[ty]
        assert int(length or 0) == getattr(cty, "_length_", 0)


def test_cpu_camera_rays_take_the_plain_version():
    cfg, h, row0, blocked, kw = _case("pixel_order")
    cam, key = tcam.Camera.create(**kw), _key("pixel_order")
    before = dict(_build.LAUNCHES)
    ro, rd, _ = _camera_rays(cam, key, cfg, h, cfg.width, cfg.spp, row0,
                             blocked, "cpu")
    po, pd = camera_rays_plain(cam, key, cfg, h, cfg.width, cfg.spp, row0,
                               blocked, "cpu")
    assert _build.LAUNCHES == before
    for a, b in zip(ro + rd, po + pd):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="camera-ray kernel"):
        _camera_rays(cam, key, cfg, h, cfg.width, cfg.spp, row0, blocked,
                     "meta")
