"""The scale gates of ``examples/gate_scale_tiers.py`` (its ``smoke`` command,
``:119-126``) for the port, on the CPU: ``bench_scene(2_000)`` at 64x32,
``rng_impl="rbg"``, seed 7, the gate's camera and ``ray_chunk``.

* The port's ``"pallas"`` image (the path kernel's plain version) at 2
  bounces in 2 bands against the JAX package's ``tracer="cluster"`` image
  of the same banded key chain: RMSE < 1e-3, the repo's image bar
  (``bench.py:167``); torch and XLA:CPU round the transcendental functions
  by an ulp, so the two sit ~1e-6 apart (ROADMAP.md, "Not faults").
* The port's ``"pallas"``, ``"cluster"`` and ``"brute"`` images at 1
  bounce: bit-equal (one exact MT97 winner rule for all three).
* ``ShardedRenderer(mode="scene")`` on two and on four logical shards of
  one Morton order at 2 bounces: bit-equal, since a cross-shard tie goes to
  the lowest shard and every shard's hit carries the winner's bits. The
  JAX gate's other partition (``forced_partition_accel``) is a VMEM tier
  the port does not copy; the port's partitions are its scene shards.

``chip_smoke.py`` phase 12 runs the same gates on the card at 1M and 2M
triangles.
"""

import numpy as np
import pytest

from unityraytracer_tpu import Camera as JCamera
from unityraytracer_tpu import RenderConfig as JConfig
from unityraytracer_tpu import Renderer as JRenderer
from unityraytracer_tpu.models import fixtures as jfix
from unityraytracer_tpu_torch import Camera, RenderConfig, Renderer
from unityraytracer_tpu_torch.models import fixtures as tfix
from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
from unityraytracer_tpu_torch.parallel.sharding import ShardedRenderer
from unityraytracer_tpu_torch.utils.image import rmse
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H = 64, 32
CAM = dict(position=(0.0, 14.0, -42.0), look_at=(0.0, 2.0, 0.0),
           fov_y_deg=60.0, aspect=W / H)
SEED = 7


def base_cfg(Config, bounces, bands, tracer):
    """``gate_scale_tiers.base_cfg`` for either package's config."""
    return Config(width=W, height=H, spp=1, bounces=bounces, tracer=tracer,
                  ray_chunk=4096, wavefront=True, rr_group="step",
                  rng_impl="rbg", dispatch_bands=bands)


@pytest.fixture(scope="module")
def scene():
    ts = tfix.bench_scene(n_tris=2_000)
    return ts, build_cluster_accel(ts.triangles, cluster_size=64)


def render(scene, cfg, **kw):
    ts, accel = scene
    return Renderer(ts, Camera.create(**CAM), cfg, accel=accel, seed=SEED,
                    device="cpu", **kw).step(1).image


def test_pallas_matches_jax_cluster_at_two_bounces(scene):
    js = jfix.bench_scene(n_tris=2_000)
    want = JRenderer(js, JCamera.create(**CAM),
                     base_cfg(JConfig, 2, 2, "cluster"),
                     seed=SEED).step(1).image
    got = render(scene, base_cfg(RenderConfig, 2, 2, "pallas"))
    assert np.isfinite(got).all() and got.max() > 0.05
    err = rmse(got, np.asarray(want))
    assert err < 1e-3, err


def test_tracers_bit_equal_at_bounce_one(scene):
    imgs = {t: render(scene, base_cfg(RenderConfig, 1, 2, t))
            for t in ("pallas", "cluster", "brute")}
    assert imgs["brute"].max() > 0.05
    np.testing.assert_array_equal(imgs["pallas"], imgs["brute"])
    np.testing.assert_array_equal(imgs["cluster"], imgs["brute"])


def test_scene_partitions_bit_equal(scene):
    ts, _ = scene
    cfg = base_cfg(RenderConfig, 2, None, "pallas")
    imgs = [ShardedRenderer(ts, Camera.create(**CAM), cfg, mesh=["cpu"] * n,
                            seed=SEED, mode="scene").step(1).image
            for n in (2, 4)]
    assert np.isfinite(imgs[0]).all() and imgs[0].max() > 0.05
    np.testing.assert_array_equal(imgs[0], imgs[1])
