#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the kernel build from ``unityraytracer_tpu_torch/csrc`` (nvcc, sm_90a);
3. each CUDA kernel against its plain PyTorch version on the same inputs:
   env bit-identical on 2,073,600 random texels of the bench sky; the
   closest hit on 192x96 camera rays plus one scattered bounce of
   bench_scene(100_000) (winners agree on >= 99.99% of rays, t to 1e-5
   relative); the path kernel at 192x96 x 4 bounces (all nine output rows
   within 4 ulp, radiance RMSE < 1e-3);
   the closest-hit and path kernels also at the main path's 1920x1080 x 8
   shape, held against their plain versions on a strided subset of rays;
4. the main path: ``Renderer(bench_scene(100_000), RenderConfig(1920, 1080,
   spp=1, bounces=8, tracer="pallas", wavefront=True, rr_group="step"),
   device="cuda")`` with bench.py's camera — a warm-up step, then timed
   steps whose launch counts must show the path and env kernels ran, with
   a finite image; then one frame through the bounce-loop entry point
   (megakernel=False), counted apart, which must launch the closest-hit
   kernel; the main path's layers timed alone, and its device busy share
   over a profiled window of three frames;
5. the oracle gate: the main path at 192x96 x 4 bounces against
   tracer="brute" at the same seed, RMSE < 1e-3.

The line before the last is a JSON object with each kernel's launches in
the main-path run (0 for the closest-hit kernel, which that path does not
use; its count from the megakernel=False frame stands under
``launches_megakernel_false``), its error against the plain version and
both times; the last line is ``{"ok": true, "device": {...}}``. Without a
CUDA device it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_TRIS = 100_000
MAIN = dict(width=1920, height=1080, spp=1, bounces=8, tracer="pallas",
            wavefront=True, rr_group="step")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters, warmup=1):
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from unityraytracer_tpu_torch import RenderConfig, Renderer, _build, rng
    from unityraytracer_tpu_torch.models import fixtures
    from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
    from unityraytracer_tpu_torch.ops.cuda_env import (env_lookup,
                                                       env_lookup_plain)
    from unityraytracer_tpu_torch.ops.cuda_path import (path_trace,
                                                        path_trace_plain)
    from unityraytracer_tpu_torch.ops.cuda_trace import (KernelScene,
                                                         closest_hit_plain,
                                                         trace_hits)
    from unityraytracer_tpu_torch.ops import vec
    from unityraytracer_tpu_torch.render import (_env_tap, mega_inputs,
                                                 progressive_step,
                                                 render_frame, render_sample)
    from unityraytracer_tpu_torch.ops.trace import make_brute_tracer
    from unityraytracer_tpu_torch.utils.image import rmse

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. The card.
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # 2. Build.
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    log(f"kernel build {build_s:.2f} s -> {_build.library_path().name}")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())

    # Scene, accel and cameras shared by every phase.
    scene_np = fixtures.bench_scene(n_tris=N_TRIS)
    t0 = time.perf_counter()
    accel_np = build_cluster_accel(scene_np.triangles, cluster_size=64)
    accel_s = time.perf_counter() - t0
    scene = scene_np.to(dev)
    ks = KernelScene.create(scene, accel_np, dev)
    log(f"bench_scene: {scene_np.num_triangles} triangles, "
        f"{accel_np.num_clusters} clusters, accel build {accel_s:.3f} s")
    kernels = {}

    def small_cfg(**kw):
        return RenderConfig(**dict(MAIN, width=192, height=96, bounces=4,
                                   **kw))

    cam_small = fixtures.bench_camera(aspect=2.0)
    cam_main = fixtures.bench_camera(aspect=MAIN["width"] / MAIN["height"])

    # 3a. Env kernel vs plain: bit-identical at the main path's ray count.
    H, W = scene_np.skybox.shape[:2]
    n_env = MAIN["width"] * MAIN["height"]
    g = torch.Generator(device=dev).manual_seed(0)
    yn = torch.randint(0, H, (n_env,), generator=g, device=dev,
                       dtype=torch.int32)
    xn = torch.randint(0, W, (n_env,), generator=g, device=dev,
                       dtype=torch.int32)
    got = env_lookup(scene.skybox_rgbe, yn, xn, W)
    want = env_lookup_plain(scene.skybox_rgbe, yn, xn, W)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError("env kernel differs from its plain version")
    kernels["env"] = dict(
        route="cuda", source="unityraytracer_tpu_torch/csrc/env_kernel.cu",
        replaces="unityraytracer_tpu/ops/pallas_env.py:88",
        max_abs_err=0.0, n=n_env,
        ms=cuda_ms(lambda: env_lookup(scene.skybox_rgbe, yn, xn, W), 20, 3),
        plain_ms=cuda_ms(lambda: env_lookup_plain(scene.skybox_rgbe, yn, xn,
                                                  W), 20, 3))
    log("env:", json.dumps(kernels["env"]))

    # 3b. Closest-hit kernel vs plain.
    def camera_rays(cam, width, height, seed):
        from unityraytracer_tpu_torch.camera import camera_rays_soa
        gen = torch.Generator(device=dev).manual_seed(seed)
        py, px = torch.meshgrid(torch.arange(height, device=dev),
                                torch.arange(width, device=dev),
                                indexing="ij")
        jx = torch.rand(px.shape, generator=gen, device=dev)
        jy = torch.rand(px.shape, generator=gen, device=dev)
        u = ((px + jx) / width * 2.0 - 1.0).reshape(-1)
        v = (((height - 1 - py) + jy) / height * 2.0 - 1.0).reshape(-1)
        return camera_rays_soa(cam, u.float(), v.float())

    def scatter(ro, rd, hit, seed):
        """One diffuse bounce from each hit: origin lifted along n,
        direction uniform on the normal's hemisphere (misses keep their ray)."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        d = torch.randn((3, ro[0].shape[0]), generator=gen, device=dev)
        d = d / d.norm(dim=0, keepdim=True)
        n = torch.stack(hit.normal)
        d = torch.where((d * n).sum(0) < 0, -d, d)
        ok = hit.t < 1e30
        o2 = tuple(torch.where(ok, hit.position[k] + hit.normal[k] * 1e-3,
                               ro[k]) for k in range(3))
        d2 = tuple(torch.where(ok, d[k], rd[k]) for k in range(3))
        return o2, d2

    def compare_hits(hk, hp, tag):
        agree = hk.prim == hp.prim
        frac = float(agree.float().mean())
        both = agree & (hk.t < 1e30)
        rel = ((hk.t - hp.t).abs() / hp.t.abs().clamp_min(1e-30))[both]
        max_rel = float(rel.max()) if rel.numel() else 0.0
        max_abs = float((hk.t - hp.t).abs()[both].max()) if rel.numel() else 0.0
        log(f"hits[{tag}]: {hk.t.shape[0]} rays, winners agree {frac:.6f}, "
            f"t max rel err {max_rel:.3e}, hit fraction "
            f"{float((hk.t < 1e30).float().mean()):.4f}")
        if frac < 0.9999 or max_rel > 1e-5:
            raise AssertionError(f"closest-hit kernel vs plain ({tag}): "
                                 f"agree {frac}, max rel {max_rel}")
        return max_abs

    ro0, rd0 = camera_rays(cam_small, 192, 96, 1)
    h0 = trace_hits(ks, ro0, rd0)
    ro1, rd1 = scatter(ro0, rd0, h0, 2)
    ro = tuple(torch.cat([a, b]) for a, b in zip(ro0, ro1))
    rd = tuple(torch.cat([a, b]) for a, b in zip(rd0, rd1))
    hk = trace_hits(ks, ro, rd)
    hp = closest_hit_plain(ks, ro, rd)
    _build.raise_on_overflow(dev)
    err_hits = compare_hits(hk, hp, "192x96+bounce")
    ms_small = cuda_ms(lambda: trace_hits(ks, ro, rd), 10, 2)
    plain_ms = cuda_ms(lambda: closest_hit_plain(ks, ro, rd), 2, 1)
    # The main path's shape: 1080p camera rays, a strided subset for plain.
    rom, rdm = camera_rays(cam_main, MAIN["width"], MAIN["height"], 3)
    hm = trace_hits(ks, rom, rdm)
    sub = torch.arange(0, rom[0].shape[0], 97, device=dev)
    pick = lambda v3: tuple(c[sub].contiguous() for c in v3)  # noqa: E731
    hps = closest_hit_plain(ks, pick(rom), pick(rdm))
    hks = type(hm)(t=hm.t[sub], position=pick(hm.position),
                   normal=pick(hm.normal), albedo=pick(hm.albedo),
                   specular=pick(hm.specular), emission=pick(hm.emission),
                   smoothness=hm.smoothness[sub], prim=hm.prim[sub])
    _build.raise_on_overflow(dev)
    err_hits = max(err_hits, compare_hits(hks, hps, "1080p subset"))
    kernels["trace"] = dict(
        route="cuda", source="unityraytracer_tpu_torch/csrc/trace_kernel.cu",
        replaces="unityraytracer_tpu/ops/pallas_trace.py:1109",
        max_abs_err=err_hits, n=ro[0].shape[0], ms=ms_small,
        plain_ms=plain_ms,
        ms_1080p=cuda_ms(lambda: trace_hits(ks, rom, rdm), 5, 1))
    log("trace:", json.dumps(kernels["trace"]))

    # 3c. Path kernel vs plain on the render's own rays and uniform rows:
    # all nine output rows (radiance, sky throughput, sky direction). Both
    # run the same MT97, winner rules and float32 shading (-fmad=false), so
    # every value must agree to 4 ulp; the radiance must also meet the
    # repo's image bar, RMSE < 1e-3.
    def path_check(cfg, cam, key, stride, tag):
        ro, rd, uni, _, _, _ = mega_inputs(scene, cam, key, cfg)
        rk = path_trace(ks, ro, rd, uni, cfg)
        idx = torch.arange(0, ro[0].shape[0], stride, device=dev)
        sel = lambda v3: tuple(c[idx].contiguous() for c in v3)  # noqa: E731
        uni_s = uni[:, :, idx].contiguous()
        rp = path_trace_plain(ks, sel(ro), sel(rd), uni_s, cfg)
        _build.raise_on_overflow(dev)
        a = torch.stack([c[idx] for v3 in rk for c in v3]).cpu().numpy()
        b = torch.stack([c for v3 in rp for c in v3]).cpu().numpy()
        diff = np.abs(a - b)
        ulps = float((diff / np.spacing(np.abs(b))).max())
        err = rmse(a[:3], b[:3])
        log(f"path[{tag}]: {ro[0].shape[0]} rays (plain on {idx.numel()}), "
            f"radiance RMSE {err:.3e}, max abs over 9 rows "
            f"{float(diff.max()):.3e}, max {ulps:.1f} ulp")
        if not (err < 1e-3 and ulps <= 4.0):
            raise AssertionError(f"path kernel vs plain ({tag}): RMSE {err}, "
                                 f"{ulps} ulp")
        return ro, rd, uni, uni_s, sel, float(diff.max())

    cfg_s = small_cfg()
    ro, rd, uni, _, _, err_path = path_check(cfg_s, cam_small, rng.key(7), 1,
                                             "192x96x4")
    ms_small = cuda_ms(lambda: path_trace(ks, ro, rd, uni, cfg_s), 10, 2)
    plain_ms = cuda_ms(lambda: path_trace_plain(ks, ro, rd, uni, cfg_s), 2, 1)
    cfg_m = RenderConfig(**MAIN)
    rom, rdm, unim, _, _, err_m = path_check(cfg_m, cam_main, rng.key(8), 97,
                                             "1080p x 8 subset")
    kernels["path"] = dict(
        route="cuda", source="unityraytracer_tpu_torch/csrc/path_kernel.cu",
        replaces="unityraytracer_tpu/ops/pallas_path.py:59",
        max_abs_err=max(err_path, err_m), n=ro[0].shape[0], ms=ms_small,
        plain_ms=plain_ms,
        ms_1080p=cuda_ms(lambda: path_trace(ks, rom, rdm, unim, cfg_m), 5, 1))
    log("path:", json.dumps(kernels["path"]))
    del rom, rdm, unim, hm

    # 4. The main path, through the public entry points.
    t0 = time.perf_counter()
    r = Renderer(scene_np, cam_main, cfg_m, seed=0, device="cuda")
    setup_s = time.perf_counter() - t0
    r.step(1)                                    # warm-up
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    frame_ms = []
    for _ in range(12):
        r.step(1)
        frame_ms.append(r.stats["ms_per_frame"])
    launches = dict(_build.LAUNCHES)
    img = r.image
    if not (np.isfinite(img).all() and img.max() > 0):
        raise AssertionError("main path produced a non-finite or black image")
    for k in ("path", "env"):
        if launches[k] < 1:
            raise AssertionError(f"kernel {k!r} never launched on the main "
                                 f"path: {launches}")
    for k in kernels:
        kernels[k]["launches"] = launches[k]
    med = float(np.median(frame_ms))
    mrays = cfg_m.num_rays * cfg_m.bounces / med / 1e3
    log(f"main path 1920x1080x8, 100k tris: {med:.2f} ms/frame median of "
        f"{len(frame_ms)} (min {min(frame_ms):.2f}, max {max(frame_ms):.2f}), "
        f"{mrays:.2f} Mrays/s dispatched; renderer setup {setup_s:.2f} s; "
        f"launches {launches}")

    # The bounce-loop entry point (megakernel=False) is not the main path;
    # it is what launches the closest-hit kernel, counted on its own.
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    loop = Renderer(scene_np, cam_main, cfg_m.replace(megakernel=False),
                    accel=r.accel, seed=0, device="cuda").step(1)
    loop_launches = dict(_build.LAUNCHES)
    if not (np.isfinite(loop.image).all() and loop_launches["trace"] >= 1):
        raise AssertionError(f"megakernel=False frame: non-finite image or "
                             f"no closest-hit launch: {loop_launches}")
    kernels["trace"]["launches_megakernel_false"] = loop_launches["trace"]
    log(f"megakernel=False frame {loop.stats['ms_per_frame']:.2f} ms; "
        f"launches {loop_launches}")

    # Where one main-path frame's time goes, layer by layer (CUDA events).
    fkey = rng.key(11)
    ro, rd, uni, su1, su2, from_blocks = mega_inputs(scene, cam_main, fkey,
                                                     cfg_m)
    rad, se, sd = path_trace(r.accel, ro, rd, uni, cfg_m)
    sky = _env_tap(scene, cfg_m, sd, su1, su2)

    def compose():
        img = torch.stack([from_blocks(c).mean(dim=0) for c in
                           vec.add(rad, vec.mul(se, sky))], dim=-1)
        return progressive_step(r.state, img)

    layers = {
        "rays_and_uniform_rows": cuda_ms(
            lambda: mega_inputs(scene, cam_main, fkey, cfg_m), 3),
        "one_threefry_uniform_2M": cuda_ms(
            lambda: rng.uniform(fkey, (cfg_m.num_rays,), device=dev), 5),
        "path_kernel": cuda_ms(lambda: path_trace(r.accel, ro, rd, uni, cfg_m),
                               5),
        "sky_tap": cuda_ms(lambda: _env_tap(scene, cfg_m, sd, su1, su2), 5),
        "compose_and_accumulate": cuda_ms(compose, 5),
    }
    log("layers (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in layers.items()))
    del ro, rd, uni, rad, se, sd, sky

    # Device busy share: wall time and device time of one window of three
    # main-path frames, both read under torch.profiler (whose own per-launch
    # cost slows the host a little, so the share errs low).
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.step(3)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in
                   prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for s, e in spans:                   # union of the device intervals
        if e > reach:
            busy_us += e - max(s, reach)
            reach = e
    log(f"profiled window: 3 frames, wall {wall_ms:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms over {len(spans)} device events, busy share "
        f"{busy_us / 1e3 / wall_ms:.4f}")

    # 5. Oracle gate at 192x96 x 4 bounces, and the alive fraction at 8.
    key = rng.key(42)
    fast = render_frame(scene, cfg_s, cam_small, key, ks).cpu().numpy()
    bcfg = cfg_s.replace(tracer="brute", ray_chunk=1024)
    oracle = render_frame(scene, bcfg, cam_small, key).cpu().numpy()
    oracle_rmse = rmse(fast, oracle)
    log(f"oracle gate: RMSE {oracle_rmse:.3e} (megakernel vs brute, "
        "192x96x4, same key)")
    if not (np.isfinite(fast).all() and oracle_rmse < 1e-3):
        raise AssertionError(f"oracle gate failed: RMSE {oracle_rmse}")
    acfg = bcfg.replace(bounces=MAIN["bounces"])
    _, alive = render_sample(scene, make_brute_tracer(scene, 1024), cam_small,
                             key, acfg, with_alive_count=True)
    alive_frac = float(alive) / (acfg.num_rays * acfg.bounces)
    log(f"alive fraction {alive_frac:.4f} -> effective "
        f"{mrays * alive_frac:.2f} Mrays/s")

    _build.raise_on_overflow(dev)
    log(card)
    keys = ("route", "source", "replaces", "launches",
            "launches_megakernel_false", "max_abs_err", "ms", "plain_ms")
    log(json.dumps({"kernels": [
        {"name": k, **{f: v[f] for f in keys if f in v}}
        for k, v in kernels.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
