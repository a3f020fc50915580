"""Scene and framebuffer sharding (``parallel/``) against the JAX package's,
on 8 logical CPU shards (``["cpu"] * 8``, the counterpart of the 8 virtual
XLA devices of ``tests/conftest.py``).

Bars: ``shard_scene_accels`` equal to the JAX function's arrays bit for
bit; ``allreduce_hit`` equal to the JAX combine on the same per-shard hits
(t bit for bit, the rows by value: the JAX psum turns a winning -0.0 into
+0.0, the port keeps it); ``ShardedRenderer`` in ``"scene"`` and
``"rows"`` within atol 2e-5, rtol 1e-4 of the JAX ``ShardedRenderer`` of
one seed (the JAX test's own tolerance between its sharded and one-device
renders); the port's ``"scene"`` and ``"rows_scene"`` renders equal to its
own ``Renderer`` and ``"rows"`` renders bit for bit (the combine keeps the
winner's bits, and on the CPU every shard's trace is the same plain
code); checkpoints that each package resumes from the other's file. One
JAX render per mode (module fixtures): ``shard_map`` compiles slowly on
the CPU."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unityraytracer_tpu import Camera as JCamera
from unityraytracer_tpu import RenderConfig as JConfig
from unityraytracer_tpu.models import fixtures as jfix
from unityraytracer_tpu.ops.shade import Hit as JHit
from unityraytracer_tpu.parallel import scene_shard as jshard
from unityraytracer_tpu.parallel.sharding import \
    ShardedRenderer as JShardedRenderer
from unityraytracer_tpu_torch import Camera, RenderConfig, Renderer, rng
from unityraytracer_tpu_torch.models import fixtures as tfix
from unityraytracer_tpu_torch.ops.shade import Hit
from unityraytracer_tpu_torch.parallel import scene_shard
from unityraytracer_tpu_torch.parallel.sharding import (
    ShardedRenderer, create_sharded_state, gather_image, make_mesh,
    make_mesh2, make_sharded_step)
from unityraytracer_tpu_torch.render import render_frame
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


MESH = ["cpu"] * 8
KW = dict(width=32, height=32, spp=1, bounces=2, tracer="cluster",
          cluster_size=16, ray_chunk=1024)
CAM = dict(position=(0, 10, -30), look_at=(0, 1, 0), fov_y_deg=60,
           aspect=1.0)
TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def scenes():
    return jfix.bench_scene(n_tris=900), tfix.bench_scene(n_tris=900)


@pytest.fixture(scope="module")
def jax_renders(scenes, tmp_path_factory):
    """The JAX ShardedRenderer of seed 4 in "scene" and "rows" mode on the
    8 CPU devices, 2 fused frames each, and their checkpoints."""
    out = {}
    for mode in ("scene", "rows"):
        r = JShardedRenderer(scenes[0], JCamera.create(**CAM), JConfig(**KW),
                             seed=4, mode=mode).step(2)
        path = r.save_state(str(tmp_path_factory.mktemp("jax") / mode))
        out[mode] = (r.image, path)
    return out


def _port(scenes, mode, mesh=MESH, seed=4, **kw):
    return ShardedRenderer(scenes[1], Camera.create(**CAM),
                           RenderConfig(**dict(KW, **kw)),
                           mesh=make_mesh2(2, 4, mesh) if mode == "rows_scene"
                           else make_mesh(mesh), seed=seed, mode=mode)


def test_shard_scene_accels_bit_equal_to_jax(scenes):
    for n in (8, 3):
        want = jshard.shard_scene_accels(scenes[0], JConfig(**KW), n)
        got = scene_shard.shard_scene_accels(scenes[1], RenderConfig(**KW), n)
        leaves = jax.tree_util.tree_leaves(want)
        names = ["triangles.v0", "triangles.v1", "triangles.v2",
                 "triangles.n0", "triangles.n1", "triangles.n2",
                 "triangles.material_id", "cluster_vmin", "cluster_vmax",
                 "node_vmin", "node_vmax", "node_left", "node_right"]
        assert len(leaves) == len(names)
        for name, w in zip(names, leaves):
            g = got
            for part in name.split("."):
                g = getattr(g, part)
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert g.tobytes() == np.asarray(w).tobytes(), name


def test_pallas_shards_pad_at_the_last_vertex(scenes):
    """The "pallas" split: chunks of ceil(T/n), the padding degenerate at
    the chunk's last real vertex, and together the scene's triangles."""
    scene, n = scenes[1], 3
    stacked = scene_shard.shard_scene_pallas_accels(
        scene, RenderConfig(**KW), n)
    T = scene.num_triangles
    per = -(-T // n)
    real = []
    for k in range(n):
        tr = scene_shard.local_accel(stacked, k).triangles
        v0, v1, v2 = tr.v0, tr.v1, tr.v2
        zero = (v0 == 0).all(1) & (v1 == 0).all(1) & (v2 == 0).all(1)
        degenerate = (v0 == v1).all(1) & (v1 == v2).all(1) & ~zero
        n_real = min(per, T - k * per)
        assert degenerate.sum() == per - n_real
        keep = ~zero & ~degenerate
        assert keep.sum() == n_real
        if per > n_real:
            anchor = v0[degenerate][0]
            assert np.all(v0[degenerate] == anchor)
            assert np.abs(anchor).max() < 1e6
        real.append(np.concatenate([v0[keep], v1[keep], v2[keep]], 1))
    want = np.concatenate([scene.triangles.v0, scene.triangles.v1,
                           scene.triangles.v2], 1)
    assert sorted(map(tuple, np.concatenate(real).tolist())) \
        == sorted(map(tuple, want.tolist()))


def _random_hits(n_dev, R, seed):
    g = np.random.default_rng(seed)
    t = g.choice([1.0, 2.0, 3.0], (n_dev, R)).astype(np.float32)
    t[:, :R // 4] = 3.0e38             # every shard misses
    rows = g.normal(size=(n_dev, 16, R)).astype(np.float32)
    rows[:, 4, R // 2:] = -0.0         # signed zeros in a normal row
    return t, rows


def test_allreduce_hit_matches_jax():
    n, R = 8, 4096
    t, rows = _random_hits(n, R, 1)
    hits = [Hit(t=torch.from_numpy(t[k]),
                position=tuple(torch.from_numpy(rows[k, i]) for i in (0, 1, 2)),
                normal=tuple(torch.from_numpy(rows[k, i]) for i in (3, 4, 5)),
                albedo=tuple(torch.from_numpy(rows[k, i]) for i in (6, 7, 8)),
                specular=tuple(torch.from_numpy(rows[k, i])
                               for i in (9, 10, 11)),
                emission=tuple(torch.from_numpy(rows[k, i])
                               for i in (12, 13, 14)),
                smoothness=torch.from_numpy(rows[k, 15])) for k in range(n)]
    got = scene_shard.allreduce_hit(hits)

    from jax.sharding import Mesh, PartitionSpec as P

    def local(t_, rows_):
        r = rows_[0]
        h = JHit(t=t_[0], position=(r[0], r[1], r[2]),
                 normal=(r[3], r[4], r[5]), albedo=(r[6], r[7], r[8]),
                 specular=(r[9], r[10], r[11]),
                 emission=(r[12], r[13], r[14]), smoothness=r[15])
        c = jshard.allreduce_hit(h, "d", n)
        return c.t[None], jnp.stack([*c.position, *c.normal, *c.albedo,
                                     *c.specular, *c.emission,
                                     c.smoothness])[None]

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("d",))
    jt, jrows = jax.shard_map(local, mesh=mesh, in_specs=(P("d"), P("d")),
                              out_specs=(P("d"), P("d")), check_vma=False)(
        jnp.asarray(t), jnp.asarray(rows))
    jt, jrows = np.asarray(jt)[0], np.asarray(jrows)[0]
    assert got.t.numpy().tobytes() == jt.tobytes()
    ours = np.stack([c.numpy() for c in (*got.position, *got.normal,
                                         *got.albedo, *got.specular,
                                         *got.emission, got.smoothness)])
    assert np.array_equal(ours, jrows)            # equal by value
    # The winner's -0.0 survives the gather; the JAX psum makes it +0.0.
    neg = np.signbit(ours[4]) & (ours[4] == 0)
    assert neg.any() and not np.signbit(jrows[4][neg]).any()
    # The winner is the lowest shard at the least t.
    win = np.argmax(t == t.min(0), axis=0)
    assert np.array_equal(ours, rows[win, :, np.arange(R)].T)


@pytest.mark.parametrize("mode", ["scene", "rows"])
def test_sharded_renderer_matches_jax(scenes, jax_renders, mode):
    r = _port(scenes, mode).step(2)
    assert r.sample_count == 2 and r.image.max() > 0.05
    np.testing.assert_allclose(r.image, jax_renders[mode][0], **TOL)


@pytest.mark.parametrize("mode,tracer", [("scene", "cluster"),
                                         ("scene", "bvh"),
                                         ("rows_scene", "cluster")])
def test_scene_modes_equal_their_unsharded_renders(scenes, mode, tracer):
    """"scene" equals the single-device Renderer, "rows_scene" on a 2x4
    mesh the 2-shard "rows" render, bit for bit."""
    r = _port(scenes, mode, tracer=tracer).step(2)
    if mode == "scene":
        want = Renderer(scenes[1], Camera.create(**CAM),
                        RenderConfig(**dict(KW, tracer=tracer)), seed=4,
                        device="cpu").step(2).image
    else:
        want = _port(scenes, "rows", mesh=["cpu"] * 2,
                     tracer=tracer).step(2).image
    assert np.array_equal(r.image, want)
    assert len(r.accel) == 8 and r.accel[0].accel.triangles.count \
        < scenes[1].num_triangles


def test_scene_mode_pallas_shards(scenes):
    """tracer="pallas" in "scene" mode: the last-vertex padding, the
    closest-hit kernel's route per shard (its plain version here), within
    the bar of the one-device bounce loop."""
    r = _port(scenes, "scene", tracer="pallas").step(2)
    want = Renderer(scenes[1], Camera.create(**CAM),
                    RenderConfig(**dict(KW, tracer="pallas",
                                        megakernel=False)),
                    seed=4, device="cpu").step(2).image
    np.testing.assert_allclose(r.image, want, atol=1e-6, rtol=0)


def test_rows_bands_equal_render_frame(scenes):
    """Band k of a "rows" frame is ``render_frame(row0=k*h, rows=h)`` at
    ``fold_in(fold_in(key, 0), k)``, with the path kernel's route."""
    cfg = RenderConfig(**dict(KW, tracer="pallas", width=16))
    mesh = make_mesh(MESH)
    r = ShardedRenderer(scenes[1], Camera.create(**CAM), cfg, mesh=mesh)
    key = rng.key(7)
    step = make_sharded_step(cfg, mesh, "rows")
    state = step(create_sharded_state(cfg, mesh), r.scenes, r.camera,
                 r.accel, key, 1)
    img = gather_image(state)
    h = cfg.height // 8
    frame_key = rng.fold_in(key, 0)
    for k in (0, 3, 7):
        band = render_frame(r.scenes[k], cfg, r.camera,
                            rng.fold_in(frame_key, k), r.accel[k],
                            row0=k * h, rows=h).numpy()
        assert np.array_equal(img[k * h:(k + 1) * h], band)


def test_spp_mode_is_the_mean_of_the_shards(scenes):
    r = _port(scenes, "spp", tracer="brute", seed=3).step(1, fused=False)
    key = rng.split(rng.key(3))[1]
    frame_key = rng.fold_in(key, 0)
    cfg = r.config
    frames = [render_frame(r.scenes[0], cfg, r.camera,
                           rng.fold_in(frame_key, k)).numpy()
              for k in range(8)]
    assert r.sample_count == 1 and np.isfinite(r.image).all()
    np.testing.assert_allclose(r.image, np.mean(frames, 0), **TOL)


def test_fused_and_unfused_key_chains(scenes):
    a = _port(scenes, "rows", seed=11).step(3, fused=True)
    c = _port(scenes, "rows", seed=11).step(3, fused=True)
    b = _port(scenes, "rows", seed=11)
    b.step(1, fused=False).step(1, fused=False).step(1, fused=False)
    assert a.sample_count == b.sample_count == 3
    assert np.array_equal(a.image, c.image)
    assert not np.array_equal(a.image, b.image)
    for s in (a, b):
        assert set(s.stats) >= {"frames", "seconds", "ms_per_frame",
                                "mrays_per_sec"}


def test_what_sharding_refuses(scenes):
    cam = Camera.create(**CAM)
    with pytest.raises(ValueError, match="scene sharding"):
        ShardedRenderer(scenes[1], cam, RenderConfig(**dict(KW,
                                                            tracer="brute")),
                        mesh=make_mesh(MESH), mode="scene")
    with pytest.raises(ValueError, match="Renderer.step"):
        ShardedRenderer(scenes[1], cam,
                        RenderConfig(**dict(KW, dispatch_bands=4)),
                        mesh=make_mesh(MESH))
    with pytest.raises(ValueError, match="not divisible"):
        create_sharded_state(RenderConfig(**dict(KW, height=30)),
                             make_mesh(MESH))
    with pytest.raises(ValueError, match="sharding mode"):
        make_sharded_step(RenderConfig(**KW), make_mesh(MESH), "tiles")
    with pytest.raises(ValueError, match="need 3 x 4"):
        make_mesh2(3, 4, MESH)
    # No devices given: every CUDA device, and never the CPU.
    if torch.cuda.is_available():
        assert len(make_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedRenderer(scenes[1], cam, RenderConfig(**KW))


def test_checkpoints_cross_packages(scenes, jax_renders, tmp_path):
    """The port resumes the JAX scene render's file (image and key), and
    the JAX renderer resumes the port's."""
    jimg, jpath = jax_renders["scene"]
    r = _port(scenes, "scene", seed=99).load_state(jpath)
    assert r.sample_count == 2 and np.array_equal(r.image, jimg)
    own = _port(scenes, "scene").step(2)
    assert np.array_equal(r._key, own._key)
    np.testing.assert_allclose(r.step(1).image, own.step(1).image, **TOL)

    p = own.save_state(str(tmp_path / "port"))
    assert os.path.basename(p) == "port.npz"
    j = JShardedRenderer(scenes[0], JCamera.create(**CAM), JConfig(**KW),
                         seed=99, mode="rows").load_state(p)
    assert j.sample_count == 3 and np.array_equal(j.image, own.image)
    assert np.array_equal(np.asarray(jax.random.key_data(j._key)), own._key)
    # And across meshes: a rows_scene renderer takes a scene checkpoint.
    back = _port(scenes, "rows_scene").load_state(p)
    assert np.array_equal(back.image, own.image)
    assert len(back.state.bands) == 2


def test_preview_surface_in_scene_mode(scenes, tmp_path):
    """AOVs through the host LBVH built once, the guided denoise, the PNG
    export and the device profile (host ops here) on a scene-sharded
    renderer."""
    r = _port(scenes, "scene").step(1)
    g = r.aovs()
    assert bool(g["hit"].any()) and r._aov_accel() is r._aov_accel()
    d = r.denoised_image(guided=True)
    assert d.shape == (32, 32, 3) and np.isfinite(d).all()
    assert os.path.getsize(r.save_screenshot(str(tmp_path / "s.png"))) > 100
    prof = r.profile(1)
    assert r.sample_count == 3 and r.stats["device"] is prof
