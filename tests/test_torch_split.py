"""Bounce split (``RenderConfig.split_bounce``): the port's split megakernel
frame against its own unsplit frame and against the JAX package's split
frame, at 64x48 x 5 bounces on scene1 with Russian roulette firing in the
deep segment.

Bars: split vs unsplit in the port, max |diff| <= 1e-5 — each ray computes
the same path from the same uniforms, and only the order of the radiance
additions changes (the JAX package asks the same, tests/test_pallas.py:704,
724); port split vs JAX split, RMSE < 1e-3 (the repo's image bar: the JAX
kernel tests triangles as Pluecker edges, the port as MT97)."""

import numpy as np
import jax
import pytest
import torch

from unityraytracer_tpu import RenderConfig as JConfig
from unityraytracer_tpu.models import fixtures as jfix
from unityraytracer_tpu.ops.bvh import build_cluster_accel as jax_accel
from unityraytracer_tpu.render import render_sample_mega as jax_mega
from unityraytracer_tpu_torch import RenderConfig, rng
from unityraytracer_tpu_torch.models import fixtures as tfix
from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
from unityraytracer_tpu_torch.ops.cuda_path import path_trace
from unityraytracer_tpu_torch.ops.cuda_trace import KernelScene
from unityraytracer_tpu_torch.render import (mega_inputs, render_frame,
                                             split_capacity)
from unityraytracer_tpu_torch.utils.image import rmse

W, H, SEED = 64, 48, 11
BASE = dict(width=W, height=H, spp=1, bounces=5, tracer="pallas")


@pytest.fixture(scope="module")
def port():
    scene = tfix.scene1().to("cpu")
    cam = tfix.scene1_camera(W / H)
    ks = KernelScene.create(scene, build_cluster_accel(scene.triangles, 64))
    cfg = RenderConfig(**BASE)
    unsplit = render_frame(scene, cfg, cam, rng.key(SEED), ks).numpy()
    return scene, cam, ks, cfg, unsplit


def _survivors(scene, cam, ks, cfg, sb):
    ro, rd, uni, *_ = mega_inputs(scene, cam, rng.key(SEED), cfg)
    *_, st = path_trace(ks, ro, rd, uni[:sb], cfg, nb=sb, emit_state=True)
    return int(st[9].sum()), ro[0].shape[0]


@pytest.mark.parametrize("sb,frac,overflows", [(2, 0.25, False),
                                               (1, 1e-9, True)])
def test_split_matches_unsplit(port, sb, frac, overflows):
    scene, cam, ks, cfg, unsplit = port
    split_cfg = cfg.replace(split_bounce=sb, split_frac=frac)
    alive, n = _survivors(scene, cam, ks, cfg, sb)
    C = split_capacity(n, frac)
    assert C < n and alive > 0
    assert (alive > C) == overflows, (alive, C)
    img = render_frame(scene, split_cfg, cam, rng.key(SEED), ks).numpy()
    assert np.isfinite(img).all() and img.max() > 0.05
    np.testing.assert_allclose(img, unsplit, rtol=0, atol=1e-5)


def test_split_capacity_rule():
    # C = min(max(B, ceil(N*frac/B)*B), ceil(N/B)*B) with B = 1024.
    assert split_capacity(3072, 0.25) == 1024
    assert split_capacity(3072, 1e-9) == 1024
    assert split_capacity(3072, 0.5) == 2048
    assert split_capacity(3072, 2.0) == 3072
    assert split_capacity(1920 * 1080, 0.125) == 260096
    assert split_capacity(100, 0.125) == 1024


@pytest.mark.parametrize("sb", [0, 5, None])
def test_split_outside_its_range_is_the_unsplit_frame(port, sb):
    # split_bounce applies only when 0 < sb < bounces.
    scene, cam, ks, cfg, unsplit = port
    img = render_frame(scene, cfg.replace(split_bounce=sb), cam,
                       rng.key(SEED), ks).numpy()
    np.testing.assert_array_equal(img, unsplit)


def test_split_matches_jax_split(port):
    scene, cam, ks, cfg, _ = port
    kw = dict(BASE, split_bounce=2, split_frac=0.25)
    js = jfix.scene1()
    jimg = np.asarray(jax_mega(js, jax_accel(js.triangles, cluster_size=64,
                                             use_native=False),
                               jfix.scene1_camera(W / H), jax.random.key(SEED),
                               JConfig(**kw)))
    img = render_frame(scene, RenderConfig(**kw), cam, rng.key(SEED),
                       ks).numpy()
    assert np.isfinite(img).all() and img.max() > 0.05
    assert rmse(img, jimg) < 1e-3
