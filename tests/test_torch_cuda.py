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
equal their plain route's where both hit the same primitive. The ray sort
(``ray_bin_bounces``, ``bin_rays``) reorders rays whose hits and shading do
not depend on their order, so every sorted kernel is bit-equal to its
unsorted launch, counts included, and the closest-hit kernel's trace order
is ``bin_destinations``'. Under ``rng_impl="rbg"`` every draw kernel's
rbg mode (Philox4x32-10) is bit-identical to its plain version, at sizes
with n % 4 != 0, with a key whose counter carries and with ray_index
counters.

The ``multicard`` tests skip unless torch sees two or more cards: the main
frame, the closest-hit kernel, the sky tap and ``urt_atrous`` on the last
card, launched while card 0 is current, equal card 0's bit for bit and
count their launches on their own card; ``ShardedRenderer`` in ``rows`` and
``scene`` over every card equals the same mesh of logical shards of card 0;
``allreduce_hit`` of shards on every card equals the logical combine."""

from pathlib import Path

import numpy as np
import pytest
import torch

from unityraytracer_tpu_torch import RenderConfig, Renderer, _build, render, rng
from unityraytracer_tpu_torch.camera import Camera
from unityraytracer_tpu_torch.models import fixtures
from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
from unityraytracer_tpu_torch.ops import cuda_env
from unityraytracer_tpu_torch.ops.cuda_env import sky_tap, sky_tap_plain
from unityraytracer_tpu_torch.ops.cuda_path import (path_trace,
                                                    path_trace_plain)
from unityraytracer_tpu_torch.ops.cuda_trace import (SORT_WINDOW, KernelScene,
                                                     bin_destinations,
                                                     closest_hit_plain,
                                                     ray_bin_ids, trace_hits)
from unityraytracer_tpu_torch.render import (_camera_rays, aov_buffers,
                                             bounce_rows, bounce_rows_plain,
                                             camera_rays_plain, mega_inputs,
                                             pixel_center_rays, render_aovs,
                                             render_frame, split_capacity)
from unityraytracer_tpu_torch.utils.denoise import (ATROUS_ULP,
                                                    atrous_denoise,
                                                    atrous_denoise_plain)
from unityraytracer_tpu_torch.utils.image import rmse, ulp_distance

pytestmark = pytest.mark.cuda

GOLDEN = Path(__file__).resolve().parent / "golden_scene1.npz"
# test_replace_and_skybox_lookups_on_card: the card's weights wy/wx against
# the CPU's in ulps of H or W, and its bilinear lookup's relative error (an
# H100 shows 1 ulp and 2.3e-5 on the test's 4096 directions).
SKY_W_ULP = 2
SKY_RTOL = 5e-5


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
    "max_bounces": (64, 16, None, 0, 1, 32, "step", True),
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


# (width, height, rows, row0, spp, tracer, aperture): block order, the lens
# on and off; pixel order at a size that tiles (the bounce loop); a size
# that does not tile; a band with row0 > 0; spp 3; the main path's 1080p.
CAMERA = {
    "blocked_lens": (64, 48, None, 0, 1, "pallas", 0.15),
    "blocked_pinhole": (64, 48, None, 0, 1, "pallas", 0.0),
    "pixel_order": (64, 48, None, 0, 2, "brute", 0.15),
    "non_tiling": (60, 44, None, 0, 1, "pallas", 0.15),
    "band": (256, 64, 16, 40, 1, "pallas", 0.15),
    "spp3": (64, 32, None, 0, 3, "pallas", 0.15),
    "main_1080p": (1920, 1080, None, 0, 1, "pallas", 0.0),
}


@pytest.mark.parametrize("case", list(CAMERA))
def test_camera_rays_kernel_bit_identical(dev, case):
    W, H, rows, row0, spp, tracer, ap = CAMERA[case]
    cfg = RenderConfig(width=W, height=H, spp=spp, tracer=tracer)
    h = H if rows is None else rows
    blocked = tracer == "pallas" and h % 8 == 0 and W % 16 == 0
    cam = Camera.create(position=(0.3, 1.5, -6.0), look_at=(0.0, 1.0, 0.0),
                        fov_y_deg=55.0, aspect=W / H, aperture=ap,
                        focus_dist=5.5)
    key = rng.key(40 + list(CAMERA).index(case))
    before = _build.LAUNCHES["camera"]
    ro, rd, k_bounce = _camera_rays(cam, key, cfg, h, W, spp, row0, blocked,
                                    dev)
    assert _build.LAUNCHES["camera"] == before + 1
    po, pd = camera_rays_plain(cam, key, cfg, h, W, spp, row0, blocked, dev)
    np.testing.assert_array_equal(k_bounce, rng.split(key, 3)[2])
    for a, b in zip(ro + rd, po + pd):
        assert a.shape == b.shape == (spp * h * W,) and a.is_contiguous()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _plain_camera_route(camera, key, cfg, h, W, spp, row0, blocked, device):
    ro, rd = camera_rays_plain(camera, key, cfg, h, W, spp, row0, blocked,
                               device)
    return ro, rd, rng.fold_in(key, 2)


@pytest.mark.parametrize("kw,per_frame", [
    ({}, 1), ({"dispatch_bands": 3}, 3), ({"spp": 5, "spp_chunk": 2}, 3)],
    ids=["main", "bands", "chunks"])
def test_frame_equals_plain_camera_route(dev, monkeypatch, kw, per_frame):
    cfg = RenderConfig(width=64, height=48, bounces=4, tracer="pallas",
                       rr_group="step", **kw)
    cam = fixtures.scene1_camera(64 / 48)
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    a = Renderer(fixtures.scene1(), cam, cfg, seed=4, device="cuda").step(2)
    la = dict(_build.LAUNCHES)
    calls = 2 * per_frame
    assert la["camera"] == calls and la["bounce_rows"] == calls
    assert la["path"] == calls and la["env"] == calls and la["uniform"] == 0
    monkeypatch.setattr(render, "_camera_rays", _plain_camera_route)
    b = Renderer(fixtures.scene1(), cam, cfg, seed=4, device="cuda").step(2)
    assert _build.LAUNCHES["camera"] == calls
    assert torch.isfinite(a.state.accum).all() and a.state.accum.max() > 0
    assert torch.equal(a.state.accum.view(torch.int32),
                       b.state.accum.view(torch.int32))


def test_step_hashes_seven_keys_on_the_host(dev, monkeypatch):
    # A main-path step(1): split (2 hashes), the frame key (1), k_bounce
    # (1) and the sky tap's keys (3); the camera and uniform-row kernels
    # derive the rest on the card.
    cfg = RenderConfig(width=64, height=48, bounces=8, tracer="pallas",
                       rr_group="step")
    r = Renderer(fixtures.bench_scene(2000), fixtures.bench_camera(64 / 48),
                 cfg, seed=0, device="cuda").step(1)
    calls, hash_ = [], rng.threefry2x32
    monkeypatch.setattr(rng, "threefry2x32",
                        lambda *a: calls.append(a) or hash_(*a))
    r.step(1)
    assert len(calls) == 7, len(calls)


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


def test_command_line_render_on_card_matches_cpu(dev, tmp_path, monkeypatch,
                                                 capsys):
    """``render`` with the default device (the card) against the same
    command with ``--device cpu``: the frames' bound, RMSE < 1e-3."""
    import unityraytracer_tpu_torch.__main__ as cli

    built, make = [], cli._make_renderer
    monkeypatch.setattr(cli, "_make_renderer",
                        lambda a: built.append(make(a)) or built[-1])
    argv = ["render", "--scene", "scene1", "--width", "64", "--height", "48",
            "--bounces", "3", "--frames", "4", "--seed", "3"]
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    assert cli.main(argv + ["-o", str(tmp_path / "card.png")]) == 0
    assert _build.LAUNCHES["path"] == 4 and _build.LAUNCHES["env"] == 4
    assert cli.main(argv + ["--device", "cpu", "-o",
                            str(tmp_path / "cpu.png")]) == 0
    card, cpu = built
    assert card.device.type == "cuda" and card.state.accum.is_cuda
    assert cpu.device.type == "cpu"
    assert rmse(card.image, cpu.image) < 1e-3
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and all(" samples, " in ln for ln in lines)
    a = np.frombuffer((tmp_path / "card.png").read_bytes(), np.uint8)
    assert a[:8].tobytes() == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("tracer", ["bvh", "cluster"])
def test_accel_tracers_launch_the_trace_kernel(dev, monkeypatch, tracer):
    """On the card "bvh" and "cluster" trace with the closest-hit kernel,
    once a bounce, and never run the JAX package's strategies; their frame
    is the megakernel=False frame of "pallas", bit for bit."""
    from unityraytracer_tpu_torch.ops import traverse

    def refuse(*a, **k):
        raise AssertionError("a traversal strategy ran on the card")

    monkeypatch.setattr(traverse, "_triangle_bvh_candidate", refuse)
    monkeypatch.setattr(traverse, "_triangle_cluster_candidate", refuse)
    kw = dict(width=64, height=32, spp=1, bounces=4, megakernel=False)
    scene, cam = fixtures.scene1(), fixtures.scene1_camera(2.0)
    r = Renderer(scene, cam, RenderConfig(tracer=tracer, **kw), seed=3,
                 device="cuda").step(1)
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    r.step(2)
    assert _build.LAUNCHES["trace"] == 2 * 4 and _build.LAUNCHES["path"] == 0
    p = Renderer(scene, cam, RenderConfig(tracer="pallas", **kw), seed=3,
                 device="cuda").step(1).step(2)
    assert torch.equal(r.state.accum, p.state.accum)


def test_scene_shard_combine_equals_a_single_trace(dev):
    """Four scene shards on the card, combined, against one trace of the
    whole scene: t bit for bit on every ray (each triangle's MT97 is the
    same arithmetic in any accel), the attributes where no exact tie
    crosses shards."""
    from unityraytracer_tpu_torch.parallel import scene_shard

    scene = fixtures.bench_scene(n_tris=20_000)
    cfg = RenderConfig(cluster_size=64, tracer="cluster")
    ks = KernelScene.create(scene.to(dev), build_cluster_accel(
        scene.triangles, 64), dev)
    shards = scene_shard.shard_kernel_scenes(
        scene, scene_shard.shard_scene_accels(scene, cfg, 4), [dev] * 4)
    ro, rd = _rays(dev, 200_000, 5)
    one = trace_hits(ks, ro, rd)
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    four = scene_shard.make_scene_sharded_tracer(shards, cfg)(ro, rd)
    _build.raise_on_overflow(dev)
    assert _build.LAUNCHES["trace"] == 4
    assert torch.equal(four.t.view(torch.int32), one.t.view(torch.int32))
    same = torch.stack([torch.stack(getattr(four, f)) == torch.stack(
        getattr(one, f)) for f in ("normal", "albedo", "emission")]).all(0) \
        .all(0)
    assert float(same.float().mean()) >= 0.9999


def test_native_library_builds_and_matches_numpy():
    """The native host library builds from the checkout on this machine
    (a host helper: it needs no card, only g++) and gives numpy's tree."""
    from unityraytracer_tpu_torch import native

    assert native.available(), native.BUILD_LOG
    tris = fixtures.bench_scene(n_tris=5000).triangles
    a = build_cluster_accel(tris, 64, use_native=True)
    b = build_cluster_accel(tris, 64, use_native=False)
    assert np.array_equal(a.node_left, b.node_left)
    assert np.array_equal(a.node_right, b.node_right)


def _bits(x):
    x = torch.stack(x) if isinstance(x, tuple) else x
    return x.contiguous().view(torch.int32)


def test_path_kernel_sorted_bit_equal(dev):
    cfg = RenderConfig(width=64, height=48, bounces=6, tracer="pallas",
                       rr_group="step")
    _, ks, _, (ro, rd, uni, _, _, _) = _scene1_rays(dev, cfg, 7)
    n = 3000     # not a multiple of the window
    ro, rd = tuple(c[:n] for c in ro), tuple(c[:n] for c in rd)
    uni = uni[:, :, :n].contiguous()
    *_, st = path_trace(ks, ro, rd, uni[:2], cfg, nb=2, emit_state=True)
    resume = dict(b0=2, nb=4, energy0=tuple(st[6:9]), alive0=st[9])
    cases = [((1, 2), ro, rd, uni, {}), ((0, 7), ro, rd, uni, {}),
             ((1, 2), ro, rd, uni[:2], dict(nb=2)),
             ((1, 2), tuple(st[0:3]), tuple(st[3:6]), uni[2:], resume),
             ((3, 4), tuple(st[0:3]), tuple(st[3:6]), uni[2:], resume)]
    for win, o, d, u, kw in cases:
        outs = []
        for w in (win, (None, None)):
            cnt = torch.empty((2, n), dtype=torch.int32, device=dev)
            outs.append(path_trace(ks, o, d, u,
                                   cfg.replace(ray_bin_bounces=w),
                                   emit_state=True, counts=cnt, **kw)
                        + (cnt,))
        _build.raise_on_overflow(dev)
        for a, b in zip(*outs):
            assert torch.equal(_bits(a), _bits(b)), (win, kw)


def test_sorted_launches_take_only_their_window(dev):
    # With no rays the entry points check their arguments and launch
    # nothing, so no pointer is read.
    lib = _build.lib()
    for w, want_ok in ((SORT_WINDOW, True), (256, False), (1024, False)):
        trace = lib.urt_trace_hits(None, *[None] * 7, 0, 1, w, None, None)
        path = lib.urt_path_trace(None, *[None] * 8, 0, 0, 1, 1, 0, 1, 2, w,
                                  None, None)
        assert (trace == 0, path == 0) == (want_ok, want_ok), (w, trace, path)


def test_trace_kernel_sorted_bit_equal(dev):
    s = fixtures.bench_scene(2000)
    ks = KernelScene.create(s, build_cluster_accel(s.triangles, 64), dev)
    n = 20_000
    ro, rd = _rays(dev, n, 4)
    alive = torch.arange(n, device=dev) % 5 != 0
    outs = []
    order = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for sort in (True, False):
        cnt = torch.empty((2, n), dtype=torch.int32, device=dev)
        h = trace_hits(ks, ro, rd, alive, counts=cnt, bin_rays=sort,
                       order=order if sort else None)
        outs.append([h.t, *h.normal, *h.albedo, *h.specular, *h.emission,
                     h.smoothness, *h.position, h.prim, cnt])
    _build.raise_on_overflow(dev)
    for a, b in zip(*outs):
        assert torch.equal(a.contiguous().view(torch.int32)
                           if a.dtype != torch.int64 else a,
                           b.contiguous().view(torch.int32)
                           if b.dtype != torch.int64 else b)
    want = bin_destinations(ray_bin_ids(ro, rd, alive, ks.bin_center))
    assert torch.equal(order, want)


@pytest.mark.parametrize("mega", [True, False])
def test_sorted_frame_matches_cpu_plain(dev, mega):
    cfg = RenderConfig(width=64, height=48, spp=2, bounces=4, tracer="pallas",
                       megakernel=mega, ray_bin_bounces=(1, 2))
    cam = fixtures.scene1_camera(64 / 48)

    def image(c, device):
        return Renderer(fixtures.scene1(), cam, c, seed=123,
                        device=device).step(2).image

    card = image(cfg, "cuda")
    assert rmse(card, image(cfg, "cpu")) < 1e-3
    unsorted = image(cfg.replace(ray_bin_bounces=(None, None)), "cuda")
    np.testing.assert_array_equal(card.view(np.uint32),
                                  unsorted.view(np.uint32))


# rng_impl="rbg": each kernel's rbg mode against its plain version (the int64
# Philox of rng.py), bit for bit. A key whose 128-bit counter carries out of
# word 0 at the third block, and sizes with n % 4 != 0.
CARRY_KEY = np.array([0x12345678, 0x9ABCDEF0, 0xFFFFFFFE, 0xFFFFFFFF],
                     np.uint32)


@pytest.mark.parametrize("shape", [(1,), (7,), (1001,), (2_073_601,),
                                   (5, 135, 16)])
@pytest.mark.parametrize("carry", [False, True], ids=["seed", "carry"])
def test_rbg_uniform_kernel_bit_identical(dev, shape, carry):
    key = CARRY_KEY if carry else rng.fold_in(rng.key(12, "rbg"), shape[0])
    before = dict(_build.LAUNCHES)
    got = rng.uniform(key, shape, device=dev)
    assert _build.LAUNCHES["uniform_rbg"] == before["uniform_rbg"] + 1
    assert _build.LAUNCHES["uniform"] == before["uniform"]
    want = rng.uniform_plain(key, shape, device=dev)
    assert got.shape == want.shape == shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ROWS plus sizes with n % 4 != 0: row-major, the roulette groups of
# rr_step and ray in rows whose width is not a multiple of 4.
RBG_ROWS = dict(ROWS, odd_step=(61, 43, None, 0, 1, 5, "step", True),
                odd_ray=(61, 43, None, 0, 3, 5, "ray", True))


@pytest.mark.parametrize("case", list(RBG_ROWS) + ["carry"])
def test_rbg_bounce_rows_kernel_bit_identical(dev, case):
    W, H, rows, row0, spp, nb, group, rr = RBG_ROWS.get(case,
                                                        ROWS["main_step"])
    cfg = RenderConfig(width=W, height=H, spp=spp, bounces=nb,
                       tracer="pallas", rr_group=group, russian_roulette=rr,
                       rng_impl="rbg")
    h = H if rows is None else rows
    blocked = h % 8 == 0 and W % 16 == 0
    k_bounce = CARRY_KEY if case == "carry" else \
        rng.split(rng.key(31, "rbg"), 3)[2]
    before = _build.LAUNCHES["bounce_rows_rbg"]
    got = bounce_rows(k_bounce, cfg, h, row0, blocked, dev)
    assert _build.LAUNCHES["bounce_rows_rbg"] == before + 1
    want = bounce_rows_plain(k_bounce, cfg, h, row0, blocked, dev)
    assert got.shape == want.shape == (nb, 5, spp * h * W)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


RBG_CAMERA = dict(CAMERA, odd=(61, 43, None, 0, 1, "pallas", 0.15),
                  odd_pixel_order=(61, 43, None, 0, 2, "brute", 0.15))


@pytest.mark.parametrize("case", list(RBG_CAMERA))
def test_rbg_camera_rays_kernel_bit_identical(dev, case):
    W, H, rows, row0, spp, tracer, ap = RBG_CAMERA[case]
    cfg = RenderConfig(width=W, height=H, spp=spp, tracer=tracer,
                       rng_impl="rbg")
    h = H if rows is None else rows
    blocked = tracer == "pallas" and h % 8 == 0 and W % 16 == 0
    cam = Camera.create(position=(0.3, 1.5, -6.0), look_at=(0.0, 1.0, 0.0),
                        fov_y_deg=55.0, aspect=W / H, aperture=ap,
                        focus_dist=5.5)
    key = rng.key(40 + list(RBG_CAMERA).index(case), "rbg")
    before = _build.LAUNCHES["camera_rbg"]
    ro, rd, k_bounce = _camera_rays(cam, key, cfg, h, W, spp, row0, blocked,
                                    dev)
    assert _build.LAUNCHES["camera_rbg"] == before + 1
    po, pd = camera_rays_plain(cam, key, cfg, h, W, spp, row0, blocked, dev)
    np.testing.assert_array_equal(k_bounce, rng.split(key, 3)[2])
    for a, b in zip(ro + rd, po + pd):
        assert a.shape == b.shape == (spp * h * W,) and a.is_contiguous()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("impl", ["int8x8", "bf16"])
@pytest.mark.parametrize("mode", list(SKY_MODES) + ["odd_n", "carry"])
def test_rbg_sky_tap_kernel_bit_identical(dev, impl, mode):
    scene = fixtures.bench_scene(2000).to(dev)
    hw = scene.skybox.shape[:2]
    with_index, lattice = SKY_MODES.get(mode, (False, None))
    rad, sky_e, sky_d, idx = _sky_inputs(dev, 5, with_index)
    if mode == "odd_n":     # n % 4 == 3 and rows that are not 16-byte aligned
        rad, sky_e, sky_d = (tuple(c[1:] for c in v)
                             for v in (rad, sky_e, sky_d))
    keys = (CARRY_KEY, rng.key(6, "rbg")) if mode == "carry" else \
        (rng.key(5, "rbg"), rng.key(6, "rbg"))
    name = "env_planes_rbg" if impl == "bf16" else "env_rbg"
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


def test_rbg_frame_on_card(dev, monkeypatch):
    # The main path under rbg: one launch a frame of the camera-ray,
    # uniform-row, path and sky-tap kernels, no urt_uniform; at most twice
    # threefry's seven host hashes a step (both halves); the image within
    # RMSE 1e-3 of the CPU's plain versions, as test_sorted_frame_... holds
    # threefry frames.
    cfg = RenderConfig(width=64, height=48, bounces=8, tracer="pallas",
                       rr_group="step", wavefront=True, rng_impl="rbg")
    scene, cam = fixtures.bench_scene(2000), fixtures.bench_camera(64 / 48)
    r = Renderer(scene, cam, cfg, seed=0, device="cuda").step(1)
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    calls, hash_ = [], rng.threefry2x32
    monkeypatch.setattr(rng, "threefry2x32",
                        lambda *a: calls.append(a) or hash_(*a))
    r.step(1)
    monkeypatch.undo()
    la = dict(_build.LAUNCHES)
    assert len(calls) == 14, len(calls)
    assert (la["camera_rbg"], la["bounce_rows_rbg"], la["path"],
            la["env_rbg"]) == (1, 1, 1, 1), la
    assert sum(la.values()) == 4, la      # no urt_uniform, no threefry mode
    cpu = Renderer(scene, cam, cfg, seed=0, device="cpu").step(1).step(1)
    assert r._key.shape == (4,) and np.array_equal(r._key, cpu._key)
    assert np.isfinite(r.image).all() and rmse(r.image, cpu.image) < 1e-3


def test_large_scene_frame_and_hits_equal_brute(dev):
    # A 400k-triangle scene (bench_scene's 401,920 triangles, the ladder's
    # third rung) at 192x96 x 2 bounces under the gate's camera: the path
    # kernel's rows with counts= equal its rows without, its counts lie
    # between one box test and the exhaustive test of every triangle a
    # bounce, and the camera rays' hit records (bounce 1) from the
    # closest-hit kernel equal trace_brute's bit for bit, winners included.
    s = fixtures.bench_scene(400_000)
    ks = KernelScene.create(s, build_cluster_accel(s.triangles, 64), dev)
    cfg = RenderConfig(width=192, height=96, bounces=2, tracer="pallas",
                       rr_group="step", wavefront=True, rng_impl="rbg")
    cam = Camera.create(position=(0.0, 14.0, -42.0), look_at=(0.0, 2.0, 0.0),
                        fov_y_deg=60.0, aspect=2.0)
    ro, rd, uni, _, _ = render._frame_inputs(ks.scene, cam,
                                             rng.key(7, "rbg"), cfg)
    n = ro[0].shape[0]
    cnt = torch.zeros((2, n), dtype=torch.int32, device=dev)
    with_c = path_trace(ks, ro, rd, uni, cfg, counts=cnt)
    without = path_trace(ks, ro, rd, uni, cfg)
    hk = trace_hits(ks, ro, rd)
    hp = closest_hit_plain(ks, ro, rd)
    _build.raise_on_overflow(dev)
    for a, b in zip(with_c, without):
        assert torch.equal(_bits(a), _bits(b))
    assert int(cnt[0].min()) >= 1
    assert int(cnt[1].max()) <= cfg.bounces * ks.accel.triangles.count
    assert 0 < float(cnt[1].float().mean()) < 1000
    rows = lambda h: torch.stack([h.t, *h.normal, *h.albedo, *h.specular,  # noqa: E731
                                  *h.emission, h.smoothness])
    assert torch.equal(_bits(rows(hk)), _bits(rows(hp)))
    assert torch.equal(hk.prim, hp.prim)
    assert 0.2 < float((hk.t < 1e30).float().mean()) < 1.0


def test_replace_and_skybox_lookups_on_card(dev, monkeypatch):
    # .replace keeps CUDA tensors where they are. sample_skybox_rgbe's three
    # lookups on CUDA tensors agree with the CPU's: the nearest and
    # stochastic taps bit for bit on all but 0.1% of rays, the bilinear blend
    # within SKY_RTOL. The only difference is in the texel coordinates:
    # torch's CUDA acos and atan2 are the CUDA math library's (2 and 3 ulp
    # at most) and round otherwise than the CPU's. So the texel indices
    # agree on all but 0.1% of rays, the weights wy/wx to SKY_W_ULP ulps of
    # H or W (the spacing of row01*H and col01*W at their largest), and the
    # lookups on the card's coordinates are the CPU's bit for bit (the same
    # decode table, the same IEEE products and sums, one torch op each).
    from unityraytracer_tpu_torch.models.skybox import sun_sky
    from unityraytracer_tpu_torch.ops import shade

    scene = fixtures.bench_scene(2000).to(dev)
    moved = scene.replace(ground_enabled=torch.zeros((), device=dev))
    assert moved.triangles is scene.triangles and moved is not scene
    assert float(scene.ground_enabled) == 1.0
    state = render.RenderState.create(8, 4, dev).replace(n_samples=3)
    assert state.accum.device.type == dev.type and state.n_samples == 3
    t = torch.ones(5, device=dev)
    hit = shade.Hit(t=t, position=(t,) * 3, normal=(t,) * 3,
                    albedo=(t,) * 3, specular=(t,) * 3, emission=(t,) * 3,
                    smoothness=t)
    assert hit.replace(t=t * 2).t.device.type == dev.type

    H, W = 32, 64
    sky = sun_sky(H, W)
    g = np.random.default_rng(0)
    d = g.normal(size=(3, 4096)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    u = g.uniform(size=(2, 4096)).astype(np.float32)
    plane = shade.pack_rgbe_np(sky).view(np.int32)

    def lookups(where):
        sk = torch.from_numpy(sky).to(where)
        rd = tuple(torch.from_numpy(c.copy()).to(where) for c in d)
        u1, u2 = (torch.from_numpy(c.copy()).to(where) for c in u)
        pk = torch.from_numpy(plane).to(where)
        return [torch.stack(shade.sample_skybox_rgbe(sk, rd, **kw)).cpu()
                for kw in (dict(u1=u1, u2=u2), dict(bilinear=False),
                           dict(packed=pk), {})]

    card, cpu = lookups(dev), lookups("cpu")
    for a, b in zip(card[:2], cpu[:2]):
        same = (a.view(torch.int32) == b.view(torch.int32)).all(dim=0)
        assert float(same.float().mean()) >= 0.999
    rel = max(float(((a - cpu[3]).abs() / cpu[3].abs()).max())
              for a in card[2:])
    print(f"bilinear lookup, card against CPU: max rel {rel:.3e}")
    assert rel <= SKY_RTOL

    rd_card = tuple(torch.from_numpy(c.copy()).to(dev) for c in d)
    c_card = [c.cpu() for c in shade._equirect_coords((H, W), rd_card)]
    c_cpu = shade._equirect_coords((H, W), tuple(torch.from_numpy(c.copy())
                                                 for c in d))
    for a, b in zip(c_card[:4], c_cpu[:4]):
        assert float((a == b).float().mean()) >= 0.999
    same = (c_card[0] == c_cpu[0]) & (c_card[2] == c_cpu[2])
    for a, b, size in zip(c_card[4:], c_cpu[4:], (H, W)):
        ulps = float((a - b)[same].abs().max()) / np.spacing(np.float32(size))
        print(f"weight over {size} texels, card against CPU: {ulps:.2f} ulp")
        assert ulps <= SKY_W_ULP
    monkeypatch.setattr(shade, "_equirect_coords", lambda hw, rd: c_card)
    for a, b in zip(card, lookups("cpu")):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# -- several cards (skip unless torch sees two or more) ----------------------

@pytest.fixture(scope="module")
def cards():
    """Card 0 and the last card, the latter never current by default."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs two or more CUDA devices (torch sees {n})")
    _build.lib()
    return torch.device("cuda", 0), torch.device("cuda", n - 1)


def _card_launches():
    return {k: {n: c for n, c in v.items() if c}
            for k, v in _build.CARD_LAUNCHES.items()}


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_multicard_frame_on_the_last_card(cards, impl):
    """A Renderer on the last card (card 0 current throughout): its frames
    launch the four kernels there alone and equal card 0's bit for bit."""
    first, last = cards
    scene = fixtures.bench_scene(20_000)
    accel = build_cluster_accel(scene.triangles, 64)
    cfg = RenderConfig(width=320, height=180, spp=1, bounces=4,
                       tracer="pallas", rng_impl=impl)
    cam = fixtures.bench_camera(320 / 180)
    imgs, la = {}, {}
    with torch.cuda.device(first):
        for d in (first, last):
            _build.CARD_LAUNCHES.clear()
            imgs[d] = Renderer(scene, cam, cfg, accel=accel, seed=2,
                               device=d).step(2).image
            la[d] = _card_launches()
    assert list(la[last]) == [last.index] and list(la[first]) == [first.index]
    assert la[last][last.index] == la[first][first.index]
    assert sum(la[last][last.index].values()) == 2 * 4
    assert np.array_equal(imgs[first], imgs[last]) and imgs[last].max() > 0


def test_multicard_kernels_on_the_last_card(cards):
    """The closest-hit kernel, the sky tap (both fetches) and urt_atrous on
    tensors of the last card, launched with card 0 current: bit-equal to
    the same launches on card 0, each counted on its own card."""
    first, last = cards
    s = fixtures.bench_scene(2000)
    on = {d: KernelScene.create(s.to(d), build_cluster_accel(s.triangles, 64),
                                d) for d in cards}
    ro, rd = _rays(first, 20_000, 4)
    alive = torch.arange(20_000, device=first) % 5 != 0
    rad, sky_e, sky_d, idx = _sky_inputs(first, 6, True)
    keys = (rng.key(6), rng.key(7))
    g = torch.Generator(device=first).manual_seed(9)
    img = torch.rand((37, 53, 3), generator=g, device=first) ** 3 * 4
    albedo = torch.rand((37, 53, 3), generator=g, device=first)
    out, la = {}, {}
    with torch.cuda.device(first):
        for d in cards:
            def to(v):          # a copy on every card: the tap writes rad
                return tuple(c.to(d, copy=True) for c in v)

            _build.CARD_LAUNCHES.clear()
            h = trace_hits(on[d], to(ro), to(rd), alive.to(d))
            taps = [sky_tap(s.skybox.shape[:2], on[d].scene.skybox_rgbe,
                            to(rad), to(sky_e), to(sky_d), keys,
                            ray_index=idx.to(d), impl=impl)
                    for impl in ("int8x8", "bf16")]
            den = atrous_denoise(img.to(d), 3, 0.3, albedo=albedo.to(d))
            torch.cuda.synchronize(d)
            _build.raise_on_overflow(d)
            la[d] = _card_launches()
            out[d] = [h.t, *h.normal, *h.albedo, *h.emission, h.smoothness,
                      h.prim, *taps[0], *taps[1], den]
    for d in cards:
        assert la[d] == {d.index: {"trace": 1, "env": 1, "env_planes": 1,
                                   "atrous": 3}}
    for a, b in zip(out[first], out[last]):
        assert b.device == last
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("mode", ["rows", "scene"])
def test_multicard_sharded_renderer_equals_logical_shards(cards, mode):
    """ShardedRenderer over every card against the same mesh of logical
    shards of card 0, bit for bit; every card launches."""
    from unityraytracer_tpu_torch.parallel.sharding import (ShardedRenderer,
                                                            make_mesh)

    n = torch.cuda.device_count()
    scene = fixtures.bench_scene(20_000)
    tracer = "pallas" if mode == "rows" else "cluster"
    cfg = RenderConfig(width=320, height=n * 40, spp=1, bounces=4,
                       tracer=tracer)
    cam = fixtures.bench_camera(320 / (n * 40))
    imgs, la = {}, {}
    for name, mesh in (("cards", make_mesh()), ("logical", [cards[0]] * n)):
        _build.CARD_LAUNCHES.clear()
        r = ShardedRenderer(scene, cam, cfg, mesh=mesh, seed=4, mode=mode)
        imgs[name] = r.step(2).image
        la[name] = _card_launches()
    assert sorted(la["cards"]) == list(range(n))
    assert list(la["logical"]) == [0]
    assert np.array_equal(imgs["cards"], imgs["logical"])
    assert imgs["cards"].max() > 0


def test_multicard_allreduce_hit_equals_the_logical_combine(cards):
    """allreduce_hit of scene shards on every card, onto card 0, against
    the same shards all on card 0: every row bit for bit."""
    from unityraytracer_tpu_torch.parallel import scene_shard

    n = torch.cuda.device_count()
    scene = fixtures.bench_scene(n_tris=20_000)
    cfg = RenderConfig(cluster_size=64, tracer="cluster")
    stacked = scene_shard.shard_scene_accels(scene, cfg, n)
    ro, rd = _rays(cards[0], 200_000, 8)
    combined = {}
    for name, mesh in (("cards", [torch.device("cuda", k) for k in range(n)]),
                       ("logical", [cards[0]] * n)):
        hits = []
        for ks in scene_shard.shard_kernel_scenes(scene, stacked, mesh):
            hits.append(trace_hits(ks, tuple(c.to(ks.device) for c in ro),
                                   tuple(c.to(ks.device) for c in rd)))
        h = scene_shard.allreduce_hit(hits, cards[0])
        combined[name] = [h.t, *h.position, *h.normal, *h.albedo,
                          *h.specular, *h.emission, h.smoothness]
    for a, b in zip(combined["cards"], combined["logical"]):
        assert a.device == cards[0]
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert (combined["cards"][0] < 1e30).float().mean().item() > 0.2
