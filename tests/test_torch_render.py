"""The slice as a whole: the port's Renderer against the golden image and
against the JAX package at the same seed.

Bars: RMSE < 1e-3 against tests/golden_scene1.npz (the repo's golden gate)
for tracer="brute", "pallas" (path kernel) and "pallas" with
megakernel=False (closest-hit kernel); RMSE <= 1e-5 between the port's and
the JAX package's brute images of one seed — the random streams are
bit-identical (test_torch_rng.py), so only float rounding of the
transcendental functions separates them."""

import numpy as np
import jax
import pytest

from unityraytracer_tpu import Renderer as JRenderer
from unityraytracer_tpu import RenderConfig as JConfig
from unityraytracer_tpu.models import fixtures as jfix
from unityraytracer_tpu.render import get_tracer as jax_get_tracer
from unityraytracer_tpu.render import render_sample as jax_render_sample
from unityraytracer_tpu_torch import RenderConfig, Renderer, rng
from unityraytracer_tpu_torch.models import fixtures as tfix
from unityraytracer_tpu_torch.render import (get_tracer, render_frame,
                                             render_sample)
from unityraytracer_tpu_torch.utils.image import rmse

GOLDEN = dict(width=64, height=48, spp=2, bounces=3, tracer="brute",
              ray_chunk=6144)


@pytest.fixture(scope="module")
def golden():
    return np.load("tests/golden_scene1.npz")["image"].astype(np.float32)


@pytest.mark.parametrize("tracer,mega", [("brute", True), ("pallas", True),
                                         ("pallas", False)])
def test_golden_scene1(golden, tracer, mega):
    cfg = RenderConfig(**dict(GOLDEN, tracer=tracer, megakernel=mega))
    r = Renderer(tfix.scene1(), tfix.scene1_camera(aspect=64 / 48), cfg,
                 seed=123).step(8)
    assert r.sample_count == 8
    err = rmse(r.image, golden)
    assert err < 1e-3, (tracer, mega, err)


def test_brute_matches_jax_brute_same_seed():
    cfg = JConfig(**GOLDEN)
    j = JRenderer(jfix.scene1(), jfix.scene1_camera(aspect=64 / 48), cfg,
                  seed=123).step(8).image
    t = Renderer(tfix.scene1(), tfix.scene1_camera(aspect=64 / 48),
                 RenderConfig(**GOLDEN), seed=123).step(8).image
    err = rmse(t, j)
    assert err <= 1e-5, err


def test_alive_count_matches_jax():
    kw = dict(width=32, height=16, spp=1, bounces=5, tracer="brute",
              rr_group="step", wavefront=True)
    js, ts = jfix.scene1(), tfix.scene1().to("cpu")
    jcam, tcam = jfix.scene1_camera(2.0), tfix.scene1_camera(2.0)
    jimg, jn = jax.jit(lambda key: jax_render_sample(
        js, jax_get_tracer(js, JConfig(**kw)), jcam, key, JConfig(**kw),
        with_alive_count=True))(jax.random.key(4))
    cfg = RenderConfig(**kw)
    timg, tn = render_sample(ts, get_tracer(ts, cfg), tcam, rng.key(4), cfg,
                             with_alive_count=True)
    assert float(tn) == float(jn)
    assert rmse(timg.numpy(), np.asarray(jimg)) < 1e-5


def test_jax_checkpoint_resumes_in_port(tmp_path):
    kw = dict(width=32, height=24, spp=1, bounces=2, tracer="brute")
    scene_j, cam_j = jfix.scene1(), jfix.scene1_camera(32 / 24)
    jr = JRenderer(scene_j, cam_j, JConfig(**kw), seed=5).step(2)
    path = jr.save_state(str(tmp_path / "ckpt"))
    jr.step(1).step(1, fused=False)
    tr = Renderer(tfix.scene1(), tfix.scene1_camera(32 / 24),
                  RenderConfig(**kw), seed=0).load_state(path)
    assert tr.sample_count == 2
    tr.step(1).step(1, fused=False)
    assert tr.sample_count == jr.sample_count == 4
    np.testing.assert_array_equal(tr._key,
                                  np.asarray(jax.random.key_data(jr._key)))
    assert rmse(tr.image, jr.image) <= 1e-5
    # And back: the port's checkpoint format is the JAX package's.
    p2 = tr.save_state(str(tmp_path / "port"))
    jr2 = JRenderer(scene_j, cam_j, JConfig(**kw), seed=1).load_state(p2)
    assert jr2.sample_count == 4
    np.testing.assert_array_equal(jr2.image, tr.image)


@pytest.mark.parametrize("rr_group", ["ray", "step"])
def test_deep_bounce_paths_agree(rr_group):
    # The path kernel (plain on CPU), the bounce loop on the closest-hit
    # kernel and the brute oracle draw the same streams: images agree to
    # float noise with Russian roulette firing (bounces 2..4 of 6).
    cfg = RenderConfig(width=32, height=16, spp=1, bounces=6, tracer="brute",
                       rr_group=rr_group, wavefront=True)
    scene, cam = tfix.scene1().to("cpu"), tfix.scene1_camera(2.0)
    key = rng.key(77)
    brute = render_frame(scene, cfg, cam, key).numpy()
    mega = render_frame(scene, cfg.replace(tracer="pallas"), cam, key).numpy()
    loop = render_frame(scene, cfg.replace(tracer="pallas", megakernel=False,
                                           wavefront=False), cam, key).numpy()
    assert np.isfinite(mega).all() and mega.max() > 0.05
    assert rmse(mega, brute) < 1e-3
    assert rmse(loop, brute) < 1e-3


def test_renderer_lifecycle(tmp_path):
    cfg = RenderConfig(width=16, height=8, spp=1, bounces=2, tracer="pallas")
    r = Renderer(tfix.scene1(), tfix.scene1_camera(2.0), cfg, seed=3)
    r.step(2)
    assert r.sample_count == 2 and np.isfinite(r.image).all()
    assert r.stats["frames"] == 2 and r.stats["mrays_per_sec"] > 0
    r.set_camera(tfix.scene1_camera(2.0))
    assert r.sample_count == 0
    r.resize(32, 16)
    r.step(1, fused=False)
    assert r.image.shape == (16, 32, 3) and r.sample_count == 1
    r.set_scene(tfix.sample_scene())
    assert r.sample_count == 0
    out = r.step(1).save_screenshot(str(tmp_path / "shot.png"))
    assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    p = r.save_state(str(tmp_path / "s"))
    r2 = Renderer(tfix.sample_scene(), tfix.scene1_camera(2.0),
                  cfg.replace(width=32, height=16), seed=9).load_state(p)
    np.testing.assert_array_equal(r2.image, r.image)
    np.testing.assert_array_equal(r2._key, r._key)
    with pytest.raises(ValueError):   # 32x16 checkpoint, 16x8 config
        Renderer(tfix.scene1(), tfix.scene1_camera(2.0), cfg).load_state(p)


@pytest.mark.parametrize("kw,exc", [
    (dict(rng_impl="rbg"), ValueError),
    (dict(split_bounce=2), NotImplementedError),
    (dict(spp_chunk=1), NotImplementedError),
    (dict(dispatch_bands=2), NotImplementedError),
    (dict(rr_group="tile"), ValueError),
])
def test_config_rejects_unported_knobs(kw, exc):
    with pytest.raises(exc):
        RenderConfig(**kw)


def test_unported_tracers_raise():
    for name, exc in (("bvh", NotImplementedError),
                      ("cluster", NotImplementedError), ("nope", ValueError)):
        with pytest.raises(exc):
            RenderConfig(width=8, height=8, tracer=name)
