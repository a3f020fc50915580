"""``rng_impl="rbg"`` in the port against the JAX package on the CPU.

Under "rbg" JAX derives keys with threefry on each half of a 4-word key and
draws bits with XLA's RngBitGenerator, which XLA:CPU computes as
Philox4x32-10 (``rng.py``). So on the CPU the port's rbg streams are the JAX
package's, and the bars are those of the threefry tests: keys, bits and
uniforms bit for bit (``test_torch_rng.py``); the camera, uniform-row and
sky draws bit for bit in the JAX package's ``_draw_fn`` order, with log2,
cos and sin of the rows within 2, 1 and 1 ulp (``test_torch_uniform.py``);
renders of one seed within RMSE 1e-5 of the JAX package's
(``test_torch_render.py``); sharded "rows" renders equal to the one-device
composition of their bands bit for bit (``test_torch_parallel.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unityraytracer_tpu import Renderer as JRenderer
from unityraytracer_tpu import RenderConfig as JConfig
from unityraytracer_tpu.models import fixtures as jfix
from unityraytracer_tpu.render import _draw_fn as jax_draw_fn
from unityraytracer_tpu.render import _rr_uniform as jax_rr_uniform
from unityraytracer_tpu_torch import Camera, RenderConfig, Renderer, rng
from unityraytracer_tpu_torch.__main__ import main
from unityraytracer_tpu_torch.models import fixtures as tfix
from unityraytracer_tpu_torch.ops import cuda_env
from unityraytracer_tpu_torch.parallel.sharding import (
    ShardedRenderer, create_sharded_state, gather_image, make_mesh,
    make_sharded_step)
from unityraytracer_tpu_torch.render import (_sky_keys, bounce_rows_plain,
                                             camera_draws_plain, render_frame)
from unityraytracer_tpu_torch.utils.image import rmse
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEEDS = [0, 1, 42, 2 ** 31 - 1, -7]
# Key data with unequal halves whose 128-bit counter carries out of word 0
# (w2 = 0xFFFFFFFE, w3 = 0xFFFFFFFF) at the third block.
CARRY = np.array([0x12345678, 0x9ABCDEF0, 0xFFFFFFFE, 0xFFFFFFFF],
                 np.uint32)


def _jkey(data):
    return jax.random.wrap_key_data(jnp.asarray(data, jnp.uint32),
                                    impl="rbg")


def _data(k):
    return np.asarray(jax.random.key_data(k))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_equal_jax(seed):
    jk, pk = jax.random.key(seed, impl="rbg"), rng.key(seed, "rbg")
    np.testing.assert_array_equal(pk, _data(jk))
    assert pk.shape == (4,) and pk.dtype == np.uint32
    for num in (1, 2, 3):
        np.testing.assert_array_equal(rng.split(pk, num),
                                      _data(jax.random.split(jk, num)))
    for d in (0, 7, 12345, 2 ** 31 - 1):
        np.testing.assert_array_equal(rng.fold_in(pk, d),
                                      _data(jax.random.fold_in(jk, d)))
    # Unequal halves: each half is hashed on its own.
    np.testing.assert_array_equal(rng.split(CARRY, 3),
                                  _data(jax.random.split(_jkey(CARRY), 3)))
    d = seed & 0xFFFFFFFF
    np.testing.assert_array_equal(
        rng.fold_in(CARRY, d), _data(jax.random.fold_in(_jkey(CARRY), d)))
    np.testing.assert_array_equal(rng.bounce_keys(CARRY, 2)[1, 3], _data(
        jax.random.fold_in(jax.random.fold_in(_jkey(CARRY), 1), 3)))


@pytest.mark.parametrize("shape", [(8,), (2, 5), (3, 7, 5), (2_073_600,)])
@pytest.mark.parametrize("which", ["seed", "carry"])
def test_uniform_equals_jax(shape, which):
    data = CARRY if which == "carry" else rng.key(5, "rbg")
    got = rng.uniform(data, shape)
    want = np.asarray(jax.random.uniform(_jkey(data), shape))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    bits = rng.random_bits(data, shape).numpy()
    np.testing.assert_array_equal(
        bits, np.asarray(jax.random.bits(_jkey(data), shape)).astype(np.int64))
    # Draws at given counters are the flat array's.
    n = int(np.prod(shape))
    c = torch.tensor(sorted({i for i in (0, 1, 3, 4, 9, n // 2, n - 1)
                             if i < n}), dtype=torch.int64)
    assert torch.equal(rng.uniform_at_plain(data, c), got.reshape(-1)[c])


def test_impl_names_and_key_lengths():
    for bad in ("philox4x32", "unsafe_rbg", "threefry"):
        with pytest.raises(ValueError, match="threefry2x32"):
            RenderConfig(rng_impl=bad)
        with pytest.raises(ValueError):
            rng.key(0, bad)
    with pytest.raises(ValueError):
        jax.random.key(0, impl="philox4x32")
    assert RenderConfig(rng_impl="rbg").rng_impl == "rbg"
    assert rng.impl_of(rng.key(3)) == "threefry2x32"
    assert rng.impl_of(rng.key(3, "rbg")) == "rbg"
    with pytest.raises(ValueError):
        rng.impl_of(np.zeros(3, np.uint32))
    assert rng.kernel_words(rng.key(3)) == ((0, 3, 0, 0), 0)
    assert rng.kernel_words(CARRY) == (tuple(int(w) for w in CARRY), 1)
    with pytest.raises(ValueError, match="rbg"):
        rng.wrap_key_data(rng.key(3), "rbg")
    with pytest.raises(ValueError, match="threefry2x32"):
        rng.wrap_key_data(CARRY, "threefry2x32")


# (width, height, rows, row0, spp, tracer, rr_group): 8x16 block order;
# pixel order at a size that tiles (the bounce loop's block slots); a size
# that does not tile; a band with row0 > 0; spp 3.
CASES = {
    "blocked_step": (32, 16, None, 0, 1, "pallas", "step"),
    "blocked_ray": (32, 16, None, 0, 1, "pallas", "ray"),
    "pixel_order": (32, 16, None, 0, 2, "brute", "ray"),
    "non_tiling": (20, 12, None, 0, 2, "pallas", "step"),
    "band_step": (32, 40, 16, 8, 1, "pallas", "step"),
    "band_ray": (32, 40, 16, 16, 1, "pallas", "ray"),
    "spp3_step_wide": (160, 16, None, 0, 3, "pallas", "step"),
}


def _case(case, bounces=5):
    W, H, rows, row0, spp, tracer, group = CASES[case]
    cfg = RenderConfig(width=W, height=H, spp=spp, bounces=bounces,
                       tracer=tracer, rr_group=group, rng_impl="rbg")
    h = H if rows is None else rows
    return cfg, h, row0, tracer == "pallas" and h % 8 == 0 and W % 16 == 0


def _to_blocks(h, W, spp, blocked):
    N = spp * h * W
    if not blocked:
        return lambda a: a
    return lambda a: (a.reshape(spp, h // 8, 8, W // 16, 16)
                      .transpose(0, 1, 3, 2, 4).reshape(N))


@pytest.mark.parametrize("case", list(CASES))
def test_camera_draws_equal_jax(case):
    cfg, h, _, blocked = _case(case)
    W, spp = cfg.width, cfg.spp
    key = rng.key(11 + len(case), "rbg")
    got = camera_draws_plain(key, h, W, spp, blocked, "cpu")
    # render_sample_mega's camera lines (render.py:459-469).
    k_jit, k_lens, _ = jax.random.split(_jkey(key), 3)
    draw = jax_draw_fn(h, W, spp, blocked)
    want = [draw(jax.random.uniform(jax.random.fold_in(k, r), (spp * h * W,)))
            for k in (k_jit, k_lens) for r in (0, 1)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


# The rows feed the path kernel, whose rays run in block order wherever the
# size tiles: no pixel-order case.
@pytest.mark.parametrize("case", [c for c in CASES if c != "pixel_order"])
def test_bounce_rows_equal_jax(case):
    cfg, h, row0, blocked = _case(case, bounces=6)
    W, spp = cfg.width, cfg.spp
    N = spp * h * W
    k_bounce = rng.split(rng.key(23, "rbg"), 3)[2]
    got = bounce_rows_plain(k_bounce, cfg, h, row0, blocked, "cpu").numpy()
    # render_sample_mega's bounce_rows (render.py:495-514).
    jcfg = JConfig(width=W, height=cfg.height, spp=spp, bounces=cfg.bounces,
                   rr_group=cfg.rr_group, rng_impl="rbg")
    draw = jax_draw_fn(h, W, spp, blocked)
    jkb = _jkey(k_bounce)
    for b in range(cfg.bounces):
        kb = jax.random.fold_in(jkb, b)
        u_r, u1, u2 = (np.asarray(draw(jax.random.uniform(
            jax.random.fold_in(kb, i), (N,)))) for i in range(3))
        np.testing.assert_array_equal(_bits(got[b, 0]), _bits(u_r))
        if 2 <= b < cfg.bounces - 1:
            u_rr = jax_rr_uniform(jax.random.fold_in(kb, 3), jcfg, spp, h, W,
                                  row0, _to_blocks(h, W, spp, blocked))
            np.testing.assert_array_equal(_bits(got[b, 4]), _bits(u_rr))
        else:
            assert (got[b, 4] == 1).all()
        two_pi = np.float32(2.0 * 3.14159265)
        log2_u1 = np.log2(np.maximum(u1, np.float32(1e-12)))
        for r, want, ulp in ((1, log2_u1, 2), (2, np.cos(two_pi * u2), 1),
                             (3, np.sin(two_pi * u2), 1)):
            spacing = np.spacing(np.maximum(np.abs(got[b, r]), np.abs(want)))
            assert (np.abs(got[b, r] - want) / spacing).max() <= ulp, (b, r)


@pytest.mark.parametrize("mode", ["identity", "block_slot", "ray_index"])
def test_sky_draws_equal_jax(mode):
    spp, h, W, bounces = 2, 16, 32, 5
    N = spp * h * W
    k_bounce = rng.split(rng.key(13, "rbg"), 3)[2]
    idx = np.random.default_rng(5).integers(0, N, 700) \
        if mode == "ray_index" else None
    keys = _sky_keys(RenderConfig(bounces=bounces, rng_impl="rbg"), k_bounce)
    c = cuda_env.sky_counters(
        N if idx is None else idx.size,
        torch.from_numpy(idx) if idx is not None else None,
        (h, W, spp) if mode == "block_slot" else None)
    got = [rng.uniform_at_plain(k, c).numpy() for k in keys]
    # render_sample_mega's sky draws (render.py:511-513), moved as the JAX
    # package moves them.
    ks = jax.random.fold_in(_jkey(k_bounce), bounces)
    want = [jax.random.uniform(jax.random.fold_in(ks, i), (N,))
            for i in (0, 1)]
    if mode == "block_slot":
        want = [jax_draw_fn(h, W, spp, False)(u) for u in want]
    elif mode == "ray_index":
        want = [u[jnp.asarray(idx)] for u in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))


RENDER = dict(width=32, height=16, spp=1, bounces=4, rr_group="step",
              wavefront=True, ray_chunk=4096, rng_impl="rbg")


@pytest.mark.parametrize("tracer", ["brute", "pallas"])
def test_renderer_matches_jax(tracer):
    cfg = dict(RENDER, tracer=tracer)
    j = JRenderer(jfix.scene1(), jfix.scene1_camera(2.0), JConfig(**cfg),
                  seed=3).step(2)
    t = Renderer(tfix.scene1(), tfix.scene1_camera(2.0), RenderConfig(**cfg),
                 seed=3, device="cpu").step(2)
    np.testing.assert_array_equal(t._key, _data(j._key))
    assert np.isfinite(t.image).all() and t.image.max() > 0.05
    assert rmse(t.image, j.image) <= 1e-5
    # The other impl draws other noise around the same estimate.
    tf = Renderer(tfix.scene1(), tfix.scene1_camera(2.0),
                  RenderConfig(**dict(cfg, rng_impl="threefry2x32")), seed=3,
                  device="cpu").step(2)
    assert rmse(tf.image, t.image) > 1e-3


def test_checkpoints_cross_packages(tmp_path):
    kw = dict(RENDER, width=16, height=8, bounces=2, tracer="brute")
    jr = JRenderer(jfix.scene1(), jfix.scene1_camera(2.0), JConfig(**kw),
                   seed=5).step(2)
    path = jr.save_state(str(tmp_path / "jax"))
    jr.step(1)
    tr = Renderer(tfix.scene1(), tfix.scene1_camera(2.0), RenderConfig(**kw),
                  seed=0, device="cpu").load_state(path)
    assert tr.sample_count == 2 and tr._key.shape == (4,)
    tr.step(1)
    np.testing.assert_array_equal(tr._key, _data(jr._key))
    assert rmse(tr.image, jr.image) <= 1e-5
    back = JRenderer(jfix.scene1(), jfix.scene1_camera(2.0), JConfig(**kw),
                     seed=1).load_state(tr.save_state(str(tmp_path / "port")))
    np.testing.assert_array_equal(_data(back._key), tr._key)
    # Key data of the other impl is refused, either way round.
    tf_cfg = RenderConfig(**dict(kw, rng_impl="threefry2x32"))
    tf = Renderer(tfix.scene1(), tfix.scene1_camera(2.0), tf_cfg,
                  device="cpu")
    with pytest.raises(ValueError, match="threefry2x32"):
        tf.load_state(path)
    with pytest.raises(ValueError, match="rbg"):
        tr.load_state(tf.save_state(str(tmp_path / "tf")))
    assert tr.sample_count == 3


def test_sharded_rows_equal_their_bands():
    cfg = RenderConfig(width=16, height=32, spp=1, bounces=3, tracer="pallas",
                       rng_impl="rbg")
    cam = Camera.create(position=(0, 10, -30), look_at=(0, 1, 0),
                        fov_y_deg=60, aspect=0.5)
    scene = tfix.bench_scene(n_tris=900)
    mesh = make_mesh(["cpu"] * 4)
    a = ShardedRenderer(scene, cam, cfg, mesh=mesh, seed=4, mode="rows")
    b = ShardedRenderer(scene, cam, cfg, mesh=mesh, seed=4, mode="rows")
    assert a._key.shape == (4,)
    np.testing.assert_array_equal(a.step(2).image, b.step(2).image)
    key = rng.key(7, "rbg")
    state = make_sharded_step(cfg, mesh, "rows")(
        create_sharded_state(cfg, mesh), a.scenes, a.camera, a.accel, key, 1)
    img, h = gather_image(state), cfg.height // 4
    frame_key = rng.fold_in(key, 0)
    for k in range(4):
        band = render_frame(a.scenes[k], cfg, a.camera,
                            rng.fold_in(frame_key, k), a.accel[k],
                            row0=k * h, rows=h).numpy()
        assert np.array_equal(img[k * h:(k + 1) * h], band)


def test_command_line_renders_rbg(tmp_path):
    out = {}
    for impl in ("rbg", "threefry2x32"):
        png = tmp_path / f"{impl}.png"
        assert main(["render", "--width", "32", "--height", "16", "--frames",
                     "2", "--bounces", "3", "--device", "cpu", "--rng", impl,
                     "-o", str(png)]) == 0
        out[impl] = png.read_bytes()
        assert out[impl][:8] == b"\x89PNG\r\n\x1a\n"
    assert out["rbg"] != out["threefry2x32"]
