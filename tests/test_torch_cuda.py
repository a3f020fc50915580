"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device (this file
imports no JAX, so it also runs on a machine without it):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: the env kernel is bit-identical; the closest-hit kernel runs the
plain version's MT97 in the same IEEE order (built with -fmad=false), so
winners agree except on exact-tie reorderings and t to 1e-5 relative; the
path kernel's shading uses the CUDA exp2f/sqrtf/division, which torch's CUDA
kernels share, so its nine output rows agree to 4 ulp, and to RMSE < 1e-3
(the repo's image bar)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from unityraytracer_tpu_torch import RenderConfig, Renderer, _build, rng
from unityraytracer_tpu_torch.models import fixtures
from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
from unityraytracer_tpu_torch.ops.cuda_env import env_lookup, env_lookup_plain
from unityraytracer_tpu_torch.ops.cuda_path import path_trace, path_trace_plain
from unityraytracer_tpu_torch.ops.cuda_trace import (KernelScene,
                                                     closest_hit_plain,
                                                     trace_hits)
from unityraytracer_tpu_torch.render import mega_inputs
from unityraytracer_tpu_torch.utils.image import rmse

pytestmark = pytest.mark.cuda

GOLDEN = Path(__file__).resolve().parent / "golden_scene1.npz"


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    _build.lib()
    return torch.device("cuda")


def _rays(dev, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    ro = torch.rand((3, n), generator=g, device=dev) * 8 - 4
    ro[1] = ro[1].abs() + 0.3
    ro[2] -= 6
    rd = torch.randn((3, n), generator=g, device=dev)
    rd = rd / rd.norm(dim=0, keepdim=True)
    return tuple(ro), tuple(rd)


def test_env_kernel_bit_identical(dev):
    scene = fixtures.bench_scene(2000).to(dev)
    H, W = scene.skybox.shape[:2]
    g = torch.Generator(device=dev).manual_seed(1)
    yn = torch.randint(0, H, (100_003,), generator=g, device=dev,
                       dtype=torch.int32)
    xn = torch.randint(0, W, (100_003,), generator=g, device=dev,
                       dtype=torch.int32)
    before = _build.LAUNCHES["env"]
    got = env_lookup(scene.skybox_rgbe, yn, xn, W)
    assert _build.LAUNCHES["env"] == before + 1
    want = env_lookup_plain(scene.skybox_rgbe, yn, xn, W)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("name", ["scene1", "bench_scene"])
def test_trace_kernel_matches_plain(dev, name):
    s = fixtures.scene1() if name == "scene1" else fixtures.bench_scene(2000)
    ks = KernelScene.create(s, build_cluster_accel(s.triangles, 64), dev)
    ro, rd = _rays(dev, 20_000, 2)
    alive = torch.arange(20_000, device=dev) % 7 != 0
    hk = trace_hits(ks, ro, rd, alive)
    hp = closest_hit_plain(ks, ro, rd, alive)
    _build.raise_on_overflow(dev)
    agree = (hk.prim == hp.prim).float().mean().item()
    assert agree >= 0.9999, agree
    both = (hk.prim == hp.prim) & (hk.t < 1e30)
    assert both.float().mean().item() > 0.2
    torch.testing.assert_close(hk.t[both], hp.t[both], rtol=1e-5, atol=0)
    for a, b in zip(hk.albedo + hk.emission, hp.albedo + hp.emission):
        assert torch.equal(a[both], b[both])
    for a, b in zip(hk.normal, hp.normal):
        torch.testing.assert_close(a[both], b[both], rtol=1e-5, atol=1e-6)
    assert (hk.t[~alive] > 1e30).all()


def test_path_kernel_matches_plain(dev):
    s = fixtures.scene1()
    scene = s.to(dev)
    ks = KernelScene.create(scene, build_cluster_accel(s.triangles, 64), dev)
    cfg = RenderConfig(width=64, height=48, bounces=4, tracer="pallas",
                       rr_group="step")
    ro, rd, uni, _, _, _ = mega_inputs(scene, fixtures.scene1_camera(4 / 3),
                                       rng.key(3), cfg)
    rk = path_trace(ks, ro, rd, uni, cfg)
    rp = path_trace_plain(ks, ro, rd, uni, cfg)
    _build.raise_on_overflow(dev)
    for a, b in zip(rk, rp):
        x = torch.stack(a, -1).cpu().numpy()
        y = torch.stack(b, -1).cpu().numpy()
        assert np.isfinite(x).all()
        assert rmse(x, y) < 1e-3
        assert (np.abs(x - y) <= 4 * np.spacing(np.abs(y))).all()


@pytest.mark.parametrize("tracer,mega", [("brute", True), ("pallas", True),
                                         ("pallas", False)])
def test_golden_scene1_on_cuda(dev, tracer, mega):
    golden = np.load(GOLDEN)["image"].astype(np.float32)
    cfg = RenderConfig(width=64, height=48, spp=2, bounces=3, tracer=tracer,
                       megakernel=mega, ray_chunk=6144)
    r = Renderer(fixtures.scene1(), fixtures.scene1_camera(64 / 48), cfg,
                 seed=123, device="cuda").step(8)
    assert rmse(r.image, golden) < 1e-3
