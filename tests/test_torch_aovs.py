"""The first-hit G-buffer, the preview and the AOV export of the port, on
the CPU, against the JAX package.

``render_aovs`` at 32x32 on fixtures.scene1 is held against the JAX
``render_aovs`` with tracer="brute" (the AOVs carry no random numbers, so
every tracer gives the same buffers) for the port's "pallas" route (the
closest-hit kernel's plain version here) and its "brute" route: hit masks
equal, albedo, normal and emission within 1e-5 (both run MT97 in float32
and the same smooth-normal blend), depth within rel 1e-4. ``save_aovs`` is
read back by the JAX package's ``load_exr``, part by part, equal to the
half-rounded buffers. ``watch`` writes its PNG and serves both URLs."""

import socket
import urllib.request

import numpy as np
import pytest
import torch

from unityraytracer_tpu import RenderConfig as JConfig
from unityraytracer_tpu.models import fixtures as jfix
from unityraytracer_tpu.models.exr import load_exr as jax_load_exr
from unityraytracer_tpu.render import render_aovs as jax_render_aovs
from unityraytracer_tpu_torch import RenderConfig, Renderer, _build
from unityraytracer_tpu_torch.models import fixtures as tfix
from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
from unityraytracer_tpu_torch.ops.cuda_trace import KernelScene, trace_hits
from unityraytracer_tpu_torch.ops.trace import trace_brute
from unityraytracer_tpu_torch.render import aov_buffers, render_aovs

SKY = np.ones((4, 8, 3), np.float32) * 0.6
KW = dict(width=32, height=32, spp=1, bounces=2, ray_chunk=1024)


@pytest.fixture(scope="module")
def jax_aovs():
    g = jax_render_aovs(jfix.scene1(skybox=SKY), JConfig(**KW, tracer="brute"),
                        jfix.scene1_camera(aspect=1.0))
    return {k: np.asarray(v) for k, v in g.items()}


def _renderer(tracer):
    return Renderer(tfix.scene1(skybox=SKY), tfix.scene1_camera(aspect=1.0),
                    RenderConfig(**KW, tracer=tracer), seed=0, device="cpu")


def _check_against(got, want):
    assert got["albedo"].shape == (32, 32, 3) and got["depth"].shape == (32, 32)
    assert got["hit"].dtype == np.bool_
    np.testing.assert_array_equal(got["hit"], want["hit"])
    assert want["hit"].any() and not want["hit"].all()
    for k in ("albedo", "normal", "emission"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-4, atol=0)
    hit = got["hit"]
    assert (got["depth"][~hit] == 0).all() and (got["depth"][hit] > 0).all()
    np.testing.assert_allclose(np.linalg.norm(got["normal"], axis=-1)[hit],
                               1.0, atol=1e-4)


@pytest.mark.parametrize("tracer", ["pallas", "brute"])
def test_render_aovs_match_jax(jax_aovs, tracer):
    r = _renderer(tracer)
    before = dict(_build.LAUNCHES)
    g = r.aovs()
    assert _build.LAUNCHES == before          # CPU tensors: plain versions
    assert all(v.device.type == "cpu" for v in g.values())
    _check_against({k: v.numpy() for k, v in g.items()}, jax_aovs)
    # The pure function on the renderer's own scene and accel.
    g2 = render_aovs(r.scene, r.config, r.camera, accel=r.accel)
    for k in g:
        assert torch.equal(g[k], g2[k])


def test_miss_dead_ray_and_ground_buffers_agree_with_brute():
    # A sky ray (the kernel writes t = INF, brute its own miss t), a ground
    # ray, a triangle ray, and a dead copy of the ground ray, which the
    # closest-hit route reports as a miss.
    scene = tfix.scene1(skybox=SKY)
    ks = KernelScene.create(scene, build_cluster_accel(scene.triangles, 64))
    ro = (torch.tensor([0.0, 0.0, 0.0, 0.0]), torch.tensor([1.0, 1.0, 2.0, 1.0]),
          torch.tensor([-10.0, -10.0, -10.0, -10.0]))
    tri = ks.accel.triangles
    c = (tri.v0[0] + tri.v1[0] + tri.v2[0]) / 3
    d = c - torch.tensor([ro[0][2], ro[1][2], ro[2][2]])
    d = d / d.norm()
    rd = (torch.tensor([0.0, 0.0, float(d[0]), 0.0]),
          torch.tensor([1.0, -1.0, float(d[1]), -1.0]),
          torch.tensor([0.0, 0.0, float(d[2]), 0.0]))
    alive = torch.tensor([True, True, True, False])
    k = aov_buffers(trace_hits(ks, ro, rd, alive), 1, 4)
    b = aov_buffers(trace_brute(ks.plain_scene, ro, rd), 1, 4)
    assert k["hit"].tolist() == [[False, True, True, False]]
    assert b["hit"].tolist() == [[False, True, True, True]]
    for name in ("albedo", "normal", "emission", "depth"):
        torch.testing.assert_close(k[name][:, :3], b[name][:, :3], rtol=1e-5,
                                   atol=1e-6)
        # The dead ray's buffers are the miss's: zeros.
        assert torch.equal(k[name][:, 3], k[name][:, 0])
        assert (k[name][:, 0] == 0).all()


def test_save_aovs_read_back_by_jax(tmp_path):
    r = _renderer("pallas").step(1)
    g = {k: v.numpy() for k, v in r.aovs().items()}
    path = r.save_aovs(str(tmp_path / "aovs.exr"))
    half = lambda a: a.astype(np.float16).astype(np.float32)  # noqa: E731
    want = {"beauty": r.image, "albedo": g["albedo"], "normal": g["normal"],
            "depth": g["depth"][..., None], "emission": g["emission"]}
    for i, (name, a) in enumerate(want.items()):
        by_name = jax_load_exr(path, part=name)
        np.testing.assert_array_equal(by_name, half(a))
        np.testing.assert_array_equal(jax_load_exr(path, part=i), by_name)
    tm = r.save_aovs(str(tmp_path / "tm.exr"), tonemapped_beauty=True)
    beauty = jax_load_exr(tm, part="beauty")
    assert beauty.max() <= 1.0 and np.isfinite(beauty).all()


def test_watch_writes_and_serves_the_preview(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    r = _renderer("pallas")
    ticks = []
    path = str(tmp_path / "preview.png")
    r.watch(path, every=1, frames=2, guided=True, http_port=port,
            on_update=lambda rr: ticks.append(dict(rr.stats["tick"])))
    try:
        assert r.sample_count == 2 and len(ticks) == 2
        assert set(ticks[0]) == {"step_ms", "denoise_ms", "png_ms"}
        png = open(path, "rb").read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/", timeout=10) as resp:
            assert resp.status == 200 and b"/preview.png" in resp.read()
        with urllib.request.urlopen(base + "/preview.png", timeout=10) as resp:
            assert resp.status == 200 and resp.read() == png
    finally:
        r._preview_server.shutdown()
        r._preview_server.server_close()
    assert not list(tmp_path.glob("tmp*.png"))        # atomic replace


def test_denoised_image_matches_plain_denoise_of_the_accumulator():
    from unityraytracer_tpu_torch.utils.denoise import atrous_denoise_plain
    r = _renderer("pallas").step(2)
    g = r.aovs()
    for guided in (False, True):
        got = r.denoised_image(iterations=2, sigma_color=0.2, guided=guided)
        kw = dict(albedo=g["albedo"], normal=g["normal"]) if guided else {}
        want = atrous_denoise_plain(r.state.accum, 2, 0.2, **kw).numpy()
        assert isinstance(got, np.ndarray) and got.shape == r.image.shape
        np.testing.assert_array_equal(got, want)
