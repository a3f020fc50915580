"""The fused sky tap (``cuda_env.sky_tap``: draws, texel pick, fetch, decode
and compose in one call) on the CPU, where it runs its plain version.

Bar: bit-identical to the JAX package's ``render._env_tap`` followed by its
compose ``radiance + sky_e * sky`` (unityraytracer_tpu/render.py:531-532),
run as its tests run it on the CPU (the Pallas env kernels in interpret mode
where the map suits them, the gather otherwise), with the sky uniforms
drawn by ``jax.random.uniform`` from the same keys and assigned to rays as
the JAX package assigns them: by ray index, by ``_draw_fn``'s block slot, or
gathered by the split's ray index. Every impl fetches the same bytes and
decodes them through the same table, and the pick and compose are the same
float32 operations, so nothing may differ by a bit. The inputs include the
poles, directions beyond the clamp and the seam with x = +-0 and z > 0."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unityraytracer_tpu import RenderConfig as JConfig
from unityraytracer_tpu.ops import pallas_env as jax_pallas_env
from unityraytracer_tpu.ops import vec as jvec
from unityraytracer_tpu.render import _draw_fn as jax_draw_fn
from unityraytracer_tpu.render import _env_tap as jax_env_tap
from unityraytracer_tpu_torch import RenderConfig, rng
from unityraytracer_tpu_torch.models import fixtures as tfix
from unityraytracer_tpu_torch.models.skybox import gradient_sky, sun_sky
from unityraytracer_tpu_torch.ops import cuda_env
from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
from unityraytracer_tpu_torch.ops.cuda_trace import KernelScene
from unityraytracer_tpu_torch.ops.shade import pack_rgbe_np
from unityraytracer_tpu_torch.render import render_frame

# The frame the draws belong to: spp x h x W rays that tile into 8x16 blocks.
SPP, h, W = 2, 16, 32
N = SPP * h * W
BOUNCES = 5
# (x, y, z) directions at the edges of the pick: the poles (y = +-1, with
# signed zeros in x and z), beyond the clamp, the seam x = +-0 with z > 0,
# the opposite seam, and the axes.
EDGES = [(0.0, 1.0, 0.0), (-0.0, 1.0, -0.0), (0.0, -1.0, -0.0),
         (-0.0, -1.0, 0.0), (0.0, 1.0000001, 0.0), (0.0, -1.0000001, 0.0),
         (0.0, 0.3, 0.9), (-0.0, 0.3, 0.9), (0.0, 0.0, 1.0), (-0.0, 0.0, 1.0),
         (0.0, -0.6, 0.8), (-0.0, -0.6, 0.8), (0.0, 0.0, -1.0),
         (-0.0, 0.0, -1.0), (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0),
         (1e-30, 0.0, 1.0), (-1e-30, 0.0, 1.0)]
SKIES = {"sun_256x512": sun_sky, "gradient_16x40": lambda: gradient_sky(16, 40)}
MODES = ("identity", "block_slot", "ray_index")


def _inputs(seed, n):
    g = np.random.default_rng(seed)
    d = g.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d[:, :len(EDGES)] = np.array(EDGES, np.float32).T
    rad = g.uniform(size=(3, n)).astype(np.float32)
    sky_e = g.uniform(0.0, 2.0, size=(3, n)).astype(np.float32)
    sky_e[:, ::7] = 0.0
    return d, rad, sky_e


def _jax_draws(k_bounce, mode, idx):
    jk = jax.random.fold_in(jax.random.wrap_key_data(
        jnp.asarray(k_bounce, jnp.uint32)), BOUNCES)
    su = [jax.random.uniform(jax.random.fold_in(jk, i), (N,)) for i in (0, 1)]
    if mode == "block_slot":
        su = [jax_draw_fn(h, W, SPP, False)(u) for u in su]
    elif mode == "ray_index":
        su = [u[jnp.asarray(idx)] for u in su]
    return su


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sky_name", list(SKIES))
@pytest.mark.parametrize("impl", cuda_env.IMPLS)
def test_sky_tap_bit_identical_to_jax_env_tap(monkeypatch, impl, sky_name,
                                             mode):
    sky = SKIES[sky_name]()
    H, Ws = sky.shape[:2]
    packed = pack_rgbe_np(sky)
    idx = np.random.default_rng(5).integers(0, N, 700) \
        if mode == "ray_index" else None
    n = N if idx is None else idx.size
    d, rad, sky_e = _inputs(len(sky_name) + n, n)
    k_bounce = rng.split(rng.key(13), 3)[2]

    monkeypatch.setattr(jax_pallas_env, "ENV_IMPL", impl)
    su1, su2 = _jax_draws(k_bounce, mode, idx)
    scene = types.SimpleNamespace(skybox=jnp.asarray(sky),
                                  skybox_rgbe=jnp.asarray(packed))
    jd = tuple(jnp.asarray(c) for c in d)
    tap = jax_env_tap(scene, JConfig(sky_mxu=True), jd, su1, su2,
                      interpret=True)
    want = jvec.add(tuple(jnp.asarray(c) for c in rad),
                    jvec.mul(tuple(jnp.asarray(c) for c in sky_e), tap))

    ks = rng.fold_in(k_bounce, BOUNCES)
    keys = (rng.fold_in(ks, 0), rng.fold_in(ks, 1))
    t = lambda a: tuple(torch.from_numpy(c.copy()) for c in a)  # noqa: E731
    got = cuda_env.sky_tap(
        (H, Ws), torch.from_numpy(packed.view(np.int32).copy()), t(rad),
        t(sky_e), t(d), keys,
        ray_index=torch.from_numpy(idx) if idx is not None else None,
        lattice=(h, W, SPP) if mode == "block_slot" else None, impl=impl)
    for k in range(3):
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))


def test_sky_tap_writes_only_the_radiance():
    # The compose is in place: the radiance rows given are the rows
    # returned, and sky_e and sky_d are read only (the split's caller reads
    # its own sky records after the compact pass's tap).
    sky = sun_sky()
    packed = torch.from_numpy(pack_rgbe_np(sky).view(np.int32).copy())
    d, rad, sky_e = _inputs(3, 300)
    rad_t = tuple(torch.from_numpy(c.copy()) for c in rad)
    e_t = tuple(torch.from_numpy(c.copy()) for c in sky_e)
    d_t = tuple(torch.from_numpy(c.copy()) for c in d)
    keys = (rng.key(1), rng.key(2))
    out = cuda_env.sky_tap(sky.shape[:2], packed, rad_t, e_t, d_t, keys)
    assert all(o is r for o, r in zip(out, rad_t))
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(e_t, sky_e))
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(d_t, d))
    lit = sky_e > 0
    assert (np.stack([o.numpy() for o in out]) > rad)[lit].mean() > 0.9
    # Each ray's tap is the plain pick and fetch at its own draws.
    c = cuda_env.sky_counters(300)
    u1, u2 = (rng.uniform_at_plain(k, c) for k in keys)
    tap = cuda_env.sample_skybox_tap(sky.shape[:2], packed, d_t, u1, u2)
    for k in range(3):
        want = torch.from_numpy(rad[k]) + e_t[k] * tap[k]
        assert torch.equal(out[k], want)


def test_sky_counters_are_the_draw_assignment():
    # The block slot of a pixel-order ray is where _draw_fn's
    # to_pixel_order takes its draw from; a ray index is taken as given.
    c = cuda_env.sky_counters(N, lattice=(h, W, SPP)).numpy()
    want = np.asarray(jax_draw_fn(h, W, SPP, False)(jnp.arange(N)))
    np.testing.assert_array_equal(c, want)
    assert sorted(c.tolist()) == list(range(N))
    idx = torch.tensor([5, 0, 5, 1023], dtype=torch.int32)
    assert cuda_env.sky_counters(4, ray_index=idx).tolist() == [5, 0, 5, 1023]
    assert cuda_env.sky_counters(4).tolist() == [0, 1, 2, 3]


# Frames composed by the fused route (sky_mxu) and by the plain gather
# route (sky_mxu=False: the draws as tensors, sample_skybox_rgbe, the
# compose) are the same frame bit for bit: the megakernel path (counter =
# ray index), the split (compact slots draw at their ray's index) and the
# bounce loop of the brute tracer at a tiling size (block slots).
FRAMES = {
    "mega": dict(tracer="pallas"),
    "split": dict(tracer="pallas", split_bounce=2, split_frac=0.25),
    "bounce_loop_block_slots": dict(tracer="brute"),
    "bounce_loop_mega_off": dict(tracer="pallas", megakernel=False),
}


@pytest.mark.parametrize("impl", ["int8x8", "bf16"])
@pytest.mark.parametrize("frame", list(FRAMES))
def test_fused_frame_equals_plain_route(monkeypatch, frame, impl):
    scene = tfix.scene1().to("cpu")
    ks = KernelScene.create(scene, build_cluster_accel(scene.triangles, 64))
    cfg = RenderConfig(width=32, height=16, spp=2, bounces=4,
                       **FRAMES[frame])
    cam = tfix.scene1_camera(2.0)
    monkeypatch.setattr(cuda_env, "ENV_IMPL", impl)
    a = render_frame(scene, cfg, cam, rng.key(7), ks)
    b = render_frame(scene, cfg.replace(sky_mxu=False), cam, rng.key(7), ks)
    assert a.max() > 0
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
