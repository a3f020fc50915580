"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device (this file
imports no JAX, so it also runs on a machine without it):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: the sky-tap kernel, in both fetch modes and all three counter
modes, and both threefry kernels are bit-identical to their plain versions
(the pick's acos and atan2 and the uniform rows' log2, cos and sin are the
CUDA math library's, as in torch's CUDA kernels, and the divisions are IEEE
divisions on both sides), and a frame composed by the sky-tap kernel equals
the frame composed by the plain gather route bit for bit; the closest-hit
kernel runs
the plain version's MT97 in the same IEEE order (built with -fmad=false), so
winners agree except on exact-tie reorderings and t to 1e-5 relative, and
its box and triangle test counts equal those of the per-ray traversal twin
(tests/torch_twins.py); the path kernel's shading uses the CUDA
exp2f/sqrtf/division, which torch's CUDA kernels share, so its nine output
rows and its 16 resume-state rows are bit-identical. The split
frame equals the unsplit one to 1e-5 (only the order of the radiance
additions differs); a chunked frame equals the spp-weighted sum of its
sub-frames to rtol 1e-4, atol 5e-5. The a-trous kernel runs its plain
version's float32 operations in the same order with IEEE rounding, and
both take exp from the CUDA math library, so it is held to ATROUS_ULP ulp
(0: bit for bit) at every level; the AOVs through the closest-hit kernel
equal their plain route's where both hit the same primitive."""

from pathlib import Path

import numpy as np
import pytest
import torch

from unityraytracer_tpu_torch import RenderConfig, Renderer, _build, rng
from unityraytracer_tpu_torch.models import fixtures
from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
from unityraytracer_tpu_torch.ops import cuda_env
from unityraytracer_tpu_torch.ops.cuda_env import sky_tap, sky_tap_plain
from unityraytracer_tpu_torch.ops.cuda_path import path_trace, path_trace_plain
from unityraytracer_tpu_torch.ops.cuda_trace import (KernelScene,
                                                     closest_hit_plain,
                                                     trace_hits)
from unityraytracer_tpu_torch.render import (aov_buffers, bounce_rows,
                                             bounce_rows_plain, mega_inputs,
                                             pixel_center_rays, render_aovs,
                                             render_frame, split_capacity)
from unityraytracer_tpu_torch.utils.denoise import (ATROUS_ULP,
                                                    atrous_denoise,
                                                    atrous_denoise_plain)
from unityraytracer_tpu_torch.utils.image import rmse, ulp_distance

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


# Directions at the edges of the texel pick: the poles with signed zeros,
# beyond the clamp, the seam x = +-0 with z > 0, the opposite seam.
EDGES = [(0.0, 1.0, 0.0), (-0.0, 1.0, -0.0), (0.0, -1.0, -0.0),
         (0.0, 1.0000001, 0.0), (0.0, -1.0000001, 0.0), (0.0, 0.3, 0.9),
         (-0.0, 0.3, 0.9), (0.0, 0.0, 1.0), (-0.0, 0.0, 1.0),
         (0.0, 0.0, -1.0), (-0.0, 0.0, -1.0), (1.0, 0.0, 0.0)]
# Counter modes of the sky draws: (ray_index, lattice) for 100,352 rays.
SKY_MODES = {"identity": (False, None), "ray_index": (True, None),
             "block_slot": (False, (56, 896, 2))}


def _sky_inputs(dev, seed, with_index):
    n = 2 * 56 * 896
    g = torch.Generator(device=dev).manual_seed(seed)
    d = torch.randn((3, n), generator=g, device=dev)
    d = d / d.norm(dim=0, keepdim=True)
    d[:, :len(EDGES)] = torch.tensor(EDGES, device=dev).T
    rad = torch.rand((3, n), generator=g, device=dev)
    sky_e = torch.rand((3, n), generator=g, device=dev) * 2
    idx = torch.randint(0, 4 * n, (n,), generator=g, device=dev) \
        if with_index else None
    return tuple(rad), tuple(sky_e), tuple(d), idx


def _sky_check(dev, impl, mode, seed):
    scene = fixtures.bench_scene(2000).to(dev)
    hw = scene.skybox.shape[:2]
    with_index, lattice = SKY_MODES[mode]
    rad, sky_e, sky_d, idx = _sky_inputs(dev, seed, with_index)
    keys = (rng.key(seed), rng.key(seed + 1))
    name = "env_planes" if impl == "bf16" else "env"
    before = _build.LAUNCHES[name]
    got = sky_tap(hw, scene.skybox_rgbe, tuple(r.clone() for r in rad), sky_e,
                  sky_d, keys, ray_index=idx, lattice=lattice, impl=impl)
    assert _build.LAUNCHES[name] == before + 1
    want = sky_tap_plain(hw, scene.skybox_rgbe, tuple(r.clone() for r in rad),
                         sky_e, sky_d, keys, ray_index=idx, lattice=lattice,
                         impl=impl)
    for a, b, r in zip(got, want, rad):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert (a != r).float().mean().item() > 0.9
    return got


@pytest.mark.parametrize("mode", list(SKY_MODES))
def test_env_kernel_bit_identical(dev, mode):
    _sky_check(dev, "int8x8", mode, 1)


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
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))


@pytest.mark.parametrize("tracer,mega", [("brute", True), ("pallas", True),
                                         ("pallas", False)])
def test_golden_scene1_on_cuda(dev, tracer, mega):
    golden = np.load(GOLDEN)["image"].astype(np.float32)
    cfg = RenderConfig(width=64, height=48, spp=2, bounces=3, tracer=tracer,
                       megakernel=mega, ray_chunk=6144)
    r = Renderer(fixtures.scene1(), fixtures.scene1_camera(64 / 48), cfg,
                 seed=123, device="cuda").step(8)
    assert rmse(r.image, golden) < 1e-3


@pytest.mark.parametrize("mode", list(SKY_MODES))
def test_env_planes_kernel_bit_identical(dev, mode):
    planes = _sky_check(dev, "bf16", mode, 4)
    words = _sky_check(dev, "int8x8", mode, 4)
    for a, b in zip(planes, words):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _scene1_rays(dev, cfg, seed):
    s = fixtures.scene1()
    scene = s.to(dev)
    ks = KernelScene.create(scene, build_cluster_accel(s.triangles, 64), dev)
    cam = fixtures.scene1_camera(cfg.width / cfg.height)
    return scene, ks, cam, mega_inputs(scene, cam, rng.key(seed), cfg)


@pytest.mark.parametrize("nb", [2, 4])
def test_path_state_rows_bit_identical(dev, nb):
    cfg = RenderConfig(width=64, height=48, bounces=4, tracer="pallas",
                       rr_group="step")
    _, ks, _, (ro, rd, uni, _, _, _) = _scene1_rays(dev, cfg, 5)
    *rk, sk = path_trace(ks, ro, rd, uni[:nb], cfg, nb=nb, emit_state=True)
    *rp, sp = path_trace_plain(ks, ro, rd, uni[:nb], cfg, nb=nb,
                               emit_state=True)
    _build.raise_on_overflow(dev)
    assert sk.shape == sp.shape == (16, ro[0].shape[0])
    assert torch.equal(sk.view(torch.int32), sp.view(torch.int32))
    dead = sk[9] == 0
    assert 0 < dead.float().mean().item() < 1
    assert (sk[6:9, dead] == 0).all() and (sk[10:16] == 0).all()
    # Resuming from the state gives the plain version's second segment.
    if nb == 2:
        rest = dict(b0=2, nb=2, energy0=tuple(sk[6:9]), alive0=sk[9],
                    emit_state=True)
        a = path_trace(ks, tuple(sk[0:3]), tuple(sk[3:6]), uni[2:], cfg,
                       **rest)
        b = path_trace_plain(ks, tuple(sk[0:3]), tuple(sk[3:6]), uni[2:],
                             cfg, **rest)
        for x, y in zip(a, b):
            x = torch.stack(x) if isinstance(x, tuple) else x
            y = torch.stack(y) if isinstance(y, tuple) else y
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("sb,frac,overflows", [(2, 0.25, False),
                                               (1, 1e-9, True)])
def test_split_matches_unsplit_on_cuda(dev, sb, frac, overflows):
    cfg = RenderConfig(width=64, height=48, bounces=5, tracer="pallas")
    scene, ks, cam, (ro, rd, uni, _, _, _) = _scene1_rays(dev, cfg, 11)
    *_, st = path_trace(ks, ro, rd, uni[:sb], cfg, nb=sb, emit_state=True)
    alive, C = int(st[9].sum()), split_capacity(ro[0].shape[0], frac)
    assert (alive > C) == overflows, (alive, C)
    a = render_frame(scene, cfg, cam, rng.key(11), ks)
    b = render_frame(scene, cfg.replace(split_bounce=sb, split_frac=frac),
                     cam, rng.key(11), ks)
    _build.raise_on_overflow(dev)
    assert torch.isfinite(b).all()
    torch.testing.assert_close(b, a, rtol=0, atol=1e-5)


def test_spp_chunk_composition_on_cuda(dev):
    cfg = RenderConfig(width=64, height=48, spp=5, bounces=3, tracer="pallas",
                       spp_chunk=2)
    scene, ks, cam, _ = _scene1_rays(dev, cfg.replace(spp=1), 0)
    key = rng.key(9)
    img = render_frame(scene, cfg, cam, key, ks)
    sub2, sub1 = cfg.replace(spp=2, spp_chunk=None), \
        cfg.replace(spp=1, spp_chunk=None)
    want = (render_frame(scene, sub2, cam, rng.fold_in(key, 0), ks) * 0.4
            + render_frame(scene, sub2, cam, rng.fold_in(key, 1), ks) * 0.4
            + render_frame(scene, sub1, cam, rng.fold_in(key, 2), ks) * 0.2)
    assert torch.isfinite(img).all() and img.max() > 0.05
    torch.testing.assert_close(img, want, rtol=1e-4, atol=5e-5)


def test_bf16_impl_frame_bit_identical(dev, monkeypatch):
    cfg = RenderConfig(width=64, height=48, bounces=3, tracer="pallas")
    scene, ks, cam, _ = _scene1_rays(dev, cfg, 0)
    a = render_frame(scene, cfg, cam, rng.key(2), ks)
    monkeypatch.setattr(cuda_env, "ENV_IMPL", "bf16")
    before = _build.LAUNCHES["env_planes"]
    b = render_frame(scene, cfg, cam, rng.key(2), ks)
    assert _build.LAUNCHES["env_planes"] == before + 1
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("frame", ["mega", "split", "brute_block_slots"])
def test_fused_sky_frame_equals_plain_route(dev, frame):
    # sky_mxu=False composes the same frame from drawn sky rows, the torch
    # pick and gather, and a torch compose; the sky-tap kernel must give
    # the same bits on each path that reaches it.
    kw = {"mega": dict(tracer="pallas"),
          "split": dict(tracer="pallas", split_bounce=2, split_frac=0.25),
          "brute_block_slots": dict(tracer="brute")}[frame]
    cfg = RenderConfig(width=64, height=48, spp=2, bounces=4, **kw)
    scene, ks, cam, _ = _scene1_rays(dev, cfg, 0)
    before = _build.LAUNCHES["env"]
    a = render_frame(scene, cfg, cam, rng.key(6), ks)
    launched = _build.LAUNCHES["env"] - before
    b = render_frame(scene, cfg.replace(sky_mxu=False), cam, rng.key(6), ks)
    assert launched == (3 if frame == "split" else 1)
    assert _build.LAUNCHES["env"] - before == launched
    assert torch.isfinite(a).all() and a.max() > 0
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("shape", [(1,), (1000,), (2_073_601,), (5, 135, 16)])
def test_uniform_kernel_bit_identical(dev, shape):
    key = rng.fold_in(rng.key(12), shape[0])
    before = _build.LAUNCHES["uniform"]
    got = rng.uniform(key, shape, device=dev)
    assert _build.LAUNCHES["uniform"] == before + 1
    want = rng.uniform_plain(key, shape, device=dev)
    assert got.shape == want.shape == shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# (width, height, rows, row0, spp, bounces, rr_group, russian_roulette)
ROWS = {
    "main_step": (64, 48, None, 0, 1, 8, "step", True),
    "unblocked_ray": (60, 44, None, 0, 2, 5, "ray", True),
    "band_step": (256, 64, 16, 40, 1, 6, "step", True),
    "spp5_ten_bounces": (64, 32, None, 0, 5, 10, "step", True),
    "rr_off": (32, 16, None, 0, 1, 4, "ray", False),
}


@pytest.mark.parametrize("case", list(ROWS))
def test_bounce_rows_kernel_bit_identical(dev, case):
    W, H, rows, row0, spp, nb, group, rr = ROWS[case]
    cfg = RenderConfig(width=W, height=H, spp=spp, bounces=nb,
                       tracer="pallas", rr_group=group, russian_roulette=rr)
    h = H if rows is None else rows
    blocked = h % 8 == 0 and W % 16 == 0
    k_bounce = rng.split(rng.key(31), 3)[2]
    before = _build.LAUNCHES["bounce_rows"]
    got = bounce_rows(k_bounce, cfg, h, row0, blocked, dev)
    assert _build.LAUNCHES["bounce_rows"] == before + 1
    want = bounce_rows_plain(k_bounce, cfg, h, row0, blocked, dev)
    assert got.shape == want.shape == (nb, 5, spp * h * W)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_trace_counts_match_the_twin(dev):
    from torch_twins import SceneTwin, closest_hit_twin
    s = fixtures.bench_scene(2000)
    ks = KernelScene.create(s, build_cluster_accel(s.triangles, 64), dev)
    ro, rd = _rays(dev, 3000, 5)
    counts = torch.empty((2, 3000), dtype=torch.int32, device=dev)
    hk = trace_hits(ks, ro, rd, counts=counts)
    _build.raise_on_overflow(dev)
    tw = SceneTwin(ks)
    o = torch.stack(ro, 1).cpu().numpy()
    d = torch.stack(rd, 1).cpu().numpy()
    c = counts.cpu().numpy()
    for i in range(0, 3000, 15):
        prim, _, nbox, ntri = closest_hit_twin(tw, o[i], d[i])
        assert (prim, nbox, ntri) == (int(hk.prim[i]), c[0, i], c[1, i]), i
    # One bounce of the path kernel makes the same tests; the counts output
    # changes none of its results.
    cfg = RenderConfig(bounces=1, tracer="pallas")
    uni = torch.full((1, 5, 3000), 0.5, device=dev)
    pc = torch.empty_like(counts)
    a = path_trace(ks, ro, rd, uni, cfg, counts=pc)
    b = path_trace(ks, ro, rd, uni, cfg)
    assert torch.equal(pc, counts)
    for x, y in zip(a, b):
        assert torch.equal(torch.stack(x), torch.stack(y))


@pytest.mark.parametrize("guides", [(), ("albedo",), ("albedo", "normal")])
def test_atrous_kernel_matches_plain(dev, guides):
    # A ragged 37x53 image over 5 levels: from level 3 on the dilated taps
    # reach past every edge, so the clamp is exercised on all sides.
    g = torch.Generator(device=dev).manual_seed(len(guides))
    img = torch.rand((37, 53, 3), generator=g, device=dev) ** 3 * 4
    img[:, 20:] += 0.5
    albedo = torch.rand((37, 53, 3), generator=g, device=dev)
    normal = torch.nn.functional.normalize(
        torch.randn((37, 53, 3), generator=g, device=dev), dim=-1)
    kw = {k: v for k, v in (("albedo", albedo), ("normal", normal))
          if k in guides}
    src = img.clone()
    for levels in (1, 5):
        before = _build.LAUNCHES["atrous"]
        got = atrous_denoise(img, levels, 0.3, **kw)
        assert _build.LAUNCHES["atrous"] == before + levels
        want = atrous_denoise_plain(img, levels, 0.3, **kw)
        torch.cuda.synchronize()
        assert got.shape == img.shape and torch.isfinite(got).all()
        assert ulp_distance(got, want) <= ATROUS_ULP
    assert torch.equal(img, src)                       # input untouched


def test_aovs_kernel_matches_plain_route(dev):
    s = fixtures.bench_scene(2000)
    cfg = RenderConfig(width=96, height=64, spp=1, bounces=2, tracer="pallas")
    cam = fixtures.bench_camera(96 / 64)
    r = Renderer(s, cam, cfg, seed=0, device="cuda")
    before = dict(_build.LAUNCHES)
    g = r.aovs()
    assert {k: _build.LAUNCHES[k] - before[k] for k in before
            if _build.LAUNCHES[k] != before[k]} == {"trace": 1}
    ro, rd = pixel_center_rays(cam, 64, 96, dev)
    alive = torch.ones(96 * 64, dtype=torch.bool, device=dev)
    hk = trace_hits(r.accel, ro, rd, alive)
    hp = closest_hit_plain(r.accel, ro, rd, alive)
    _build.raise_on_overflow(dev)
    gk, gp = aov_buffers(hk, 64, 96), aov_buffers(hp, 64, 96)
    for k in g:                                # the same rays, one kernel
        assert torch.equal(g[k], gk[k])
    assert 0.2 < g["hit"].float().mean().item() < 1.0
    same = (hk.prim == hp.prim).reshape(64, 96)
    assert same.float().mean().item() >= 0.9999
    assert torch.equal(gk["hit"][same], gp["hit"][same])
    for k in ("albedo", "emission"):
        assert torch.equal(gk[k][same], gp[k][same]), k
    torch.testing.assert_close(gk["normal"][same], gp["normal"][same],
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gk["depth"][same], gp["depth"][same],
                               rtol=1e-5, atol=0)
    # The brute route gives the same buffers (no random numbers).
    gb = render_aovs(r.scene, cfg.replace(tracer="brute"), cam)
    assert torch.equal(gb["hit"], g["hit"])
    torch.testing.assert_close(gb["depth"], g["depth"], rtol=1e-5, atol=0)


def test_save_aovs_roundtrip_on_card(dev, tmp_path):
    from unityraytracer_tpu_torch.models.exr import load_exr
    cfg = RenderConfig(width=64, height=48, spp=1, bounces=3, tracer="pallas")
    r = Renderer(fixtures.scene1(), fixtures.scene1_camera(64 / 48), cfg,
                 seed=1, device="cuda").step(2)
    g = {k: v.cpu().numpy() for k, v in r.aovs().items()}
    path = r.save_aovs(str(tmp_path / "aovs.exr"))
    half = lambda a: a.astype(np.float16).astype(np.float32)  # noqa: E731
    want = {"beauty": r.image, "albedo": g["albedo"], "normal": g["normal"],
            "depth": g["depth"][..., None], "emission": g["emission"]}
    for name, a in want.items():
        np.testing.assert_array_equal(load_exr(path, part=name), half(a))
    den = r.denoised_image(iterations=3, guided=True)
    assert den.shape == (48, 64, 3) and np.isfinite(den).all()
