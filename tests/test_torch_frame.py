"""Frame composition: ``spp_chunk`` sub-frames in ``render_frame`` and
``dispatch_bands`` bands in ``Renderer.step``, in the port and against the
JAX package.

Bars: a chunked frame equals the spp-weighted sum of its sub-frames to
rtol 1e-4, atol 5e-5 (the JAX package's bar, tests/test_render.py:262:
the weights and the sum order are the only difference); a banded step
equals the manual composition of its bands under the key chain bit for bit
(the same code on the same device); port vs JAX with tracer="brute",
RMSE < 1e-5 (the port/JAX brute bar of tests/test_torch_render.py: the
streams are bit-identical, the transcendental functions round differently).
"""

import numpy as np
import jax
import pytest
import torch

from unityraytracer_tpu import RenderConfig as JConfig
from unityraytracer_tpu import Renderer as JRenderer
from unityraytracer_tpu.models import fixtures as jfix
from unityraytracer_tpu.render import render_frame as jax_render_frame
from unityraytracer_tpu_torch import RenderConfig, Renderer, rng
from unityraytracer_tpu_torch.models import fixtures as tfix
from unityraytracer_tpu_torch.render import (RenderState, progressive_step,
                                             render_frame)
from unityraytracer_tpu_torch.utils.image import rmse

CHUNKED = dict(width=16, height=16, spp=5, bounces=3, ray_chunk=1280,
               spp_chunk=2)
BANDED = dict(width=16, height=48, spp=1, bounces=2, dispatch_bands=5)


@pytest.mark.parametrize("tracer", ["brute", "pallas"])
def test_spp_chunk_is_the_weighted_sum_of_sub_frames(tracer):
    scene, cam = tfix.scene1().to("cpu"), tfix.scene1_camera(1.0)
    key = rng.key(5)
    cfg = RenderConfig(**dict(CHUNKED, tracer=tracer))
    img = render_frame(scene, cfg, cam, key).numpy()
    # Two full chunks of 2 spp at fold_in(key, 0..1), the remainder of 1 at
    # fold_in(key, 2).
    sub2 = cfg.replace(spp=2, spp_chunk=None)
    sub1 = cfg.replace(spp=1, spp_chunk=None)
    parts = [render_frame(scene, sub2, cam, rng.fold_in(key, i)).numpy()
             * (2 / 5) for i in range(2)]
    parts.append(render_frame(scene, sub1, cam, rng.fold_in(key, 2)).numpy()
                 * (1 / 5))
    assert np.isfinite(img).all() and img.max() > 0.05
    np.testing.assert_allclose(img, np.sum(parts, axis=0), rtol=1e-4,
                               atol=5e-5)


def test_spp_chunk_applies_only_above_spp():
    scene, cam = tfix.scene1().to("cpu"), tfix.scene1_camera(1.0)
    cfg = RenderConfig(**dict(CHUNKED, spp=2, tracer="brute"))
    a = render_frame(scene, cfg, cam, rng.key(6)).numpy()
    b = render_frame(scene, cfg.replace(spp_chunk=None), cam,
                     rng.key(6)).numpy()
    np.testing.assert_array_equal(a, b)


def test_spp_chunk_matches_jax_brute():
    kw = dict(CHUNKED, tracer="brute")
    jimg = np.asarray(jax_render_frame(jfix.scene1(), JConfig(**kw),
                                       jfix.scene1_camera(1.0),
                                       jax.random.key(5)))
    img = render_frame(tfix.scene1().to("cpu"), RenderConfig(**kw),
                       tfix.scene1_camera(1.0), rng.key(5)).numpy()
    assert rmse(img, jimg) < 1e-5


def _manual_bands(scene, cam, cfg, seed, n_frames):
    """The banded key chain written out: per frame split the key, fold in
    the sample index, then the band index; concatenate; running mean."""
    key = rng.key(seed)
    state = RenderState.create(cfg.width, cfg.height, device="cpu")
    bh = -(-cfg.height // cfg.dispatch_bands)
    for _ in range(n_frames):
        key, sub = rng.split(key)
        fkey = rng.fold_in(sub, state.n_samples)
        bands = [render_frame(scene, cfg, cam, rng.fold_in(fkey, bi),
                              row0=row0, rows=min(bh, cfg.height - row0))
                 for bi, row0 in enumerate(range(0, cfg.height, bh))]
        assert [b.shape[0] for b in bands] == [10, 10, 10, 10, 8]
        state = progressive_step(state, torch.cat(bands, dim=0))
    return state.accum.numpy()


@pytest.mark.parametrize("tracer", ["brute", "pallas"])
def test_banded_step_is_the_manual_composition(tracer):
    # 48 rows over 5 bands: four of 10 rows and a ragged last one of 8.
    cfg = RenderConfig(**dict(BANDED, tracer=tracer))
    scene, cam = tfix.scene1(), tfix.scene1_camera(16 / 48)
    r = Renderer(scene, cam, cfg, seed=3, device="cpu").step(2)
    want = _manual_bands(scene.to("cpu"), cam, cfg, 3, 2)
    assert r.sample_count == 2 and np.isfinite(r.image).all()
    np.testing.assert_array_equal(r.image, want)


def test_banded_step_takes_the_per_frame_chain():
    # Documented: fused has no effect on a banded step.
    cfg = RenderConfig(**dict(BANDED, tracer="brute"))
    scene, cam = tfix.scene1(), tfix.scene1_camera(16 / 48)
    a = Renderer(scene, cam, cfg, seed=4, device="cpu").step(2, fused=True)
    b = Renderer(scene, cam, cfg, seed=4, device="cpu").step(2, fused=False)
    np.testing.assert_array_equal(a.image, b.image)
    np.testing.assert_array_equal(a._key, b._key)


def test_banded_matches_jax_banded_brute():
    kw = dict(BANDED, tracer="brute")
    j = JRenderer(jfix.scene1(), jfix.scene1_camera(16 / 48), JConfig(**kw),
                  seed=3).step(2).image
    t = Renderer(tfix.scene1(), tfix.scene1_camera(16 / 48),
                 RenderConfig(**kw), seed=3, device="cpu").step(2).image
    assert rmse(t, j) < 1e-5


def test_bands_chosen_after_init_step():
    # The JAX package builds its band functions only at init, so a banded
    # config given later fails there (ROADMAP queue 3, R1). The port reads
    # the config at each step.
    cfg = RenderConfig(width=16, height=16, spp=1, bounces=2, tracer="brute")
    scene, cam = tfix.scene1(), tfix.scene1_camera(1.0)
    r = Renderer(scene, cam, cfg, seed=8, device="cpu").step(1)
    r.resize(16, 48)
    r.config = r.config.replace(dispatch_bands=5)
    r.step(2)
    assert r.sample_count == 2 and r.image.shape == (48, 16, 3)
    want = Renderer(scene, cam, r.config, seed=8, device="cpu")
    want._key = rng.split(rng.key(8))[0]     # the key after the first step
    np.testing.assert_array_equal(r.image, want.step(2).image)
