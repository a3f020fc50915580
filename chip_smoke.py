#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the kernel build from ``unityraytracer_tpu_torch/csrc`` (nvcc, sm_90a);
3. each CUDA kernel against its plain PyTorch version on the same inputs:
   the sky-tap kernel (draws, texel pick, fetch, decode and compose in one
   launch) bit-identical in both fetch modes, on the main path's own
   1920x1080 x 8 path-kernel output and on 2,073,600 random directions
   with the pick's edge cases, with the draws at the ray index, at a
   ray_index row and at the block slots of a pixel-order lattice; the
   threefry kernels bit-identical to their plain versions (``urt_uniform``
   on 2,073,600 and 10,368,000 counters; ``urt_bounce_rows`` at the main
   path's 1920x1080 x 8 with ``rr_group="step"``, at the quality preset's
   chunk of spp 5 x 10 bounces and at a band with ``row0 > 0``); the
   closest hit on 192x96 camera rays plus one scattered bounce of
   bench_scene(100_000) (winners agree on >= 99.99% of rays, t to 1e-5
   relative); the path kernel at 192x96 x 4 bounces (all nine output rows
   bit-identical, radiance RMSE < 1e-3);
   the closest-hit and path kernels also at the main path's 1920x1080 x 8
   shape, held against their plain versions on a strided subset of rays,
   and their traversal counts (box and triangle tests per ray) there;
4. the main path: ``Renderer(bench_scene(100_000), RenderConfig(1920, 1080,
   spp=1, bounces=8, tracer="pallas", wavefront=True, rr_group="step"),
   device="cuda")`` with bench.py's camera — a warm-up step, then timed
   steps whose launch counts must show the path, sky-tap and threefry
   kernels ran (one sky-tap and four ``urt_uniform`` launches a frame), with
   a finite image; then one frame through the bounce-loop entry point
   (megakernel=False), counted apart, which must launch the closest-hit
   kernel; the main path's layers timed alone (camera rays, uniform rows,
   path kernel, sky tap with its compose, accumulation), and its device
   busy share and device launches per frame over a profiled window of
   three frames, printed beside the count before the fused sky tap;
5. the oracle gate: the main path at 192x96 x 4 bounces against
   tracer="brute" at the same seed, RMSE < 1e-3;
6. the other configurations of the megakernel frame, each driven through
   ``Renderer(..., device="cuda")`` with the launch counts set to 0 just
   before it and read just after:
   a. the quality preset: ``fixtures.sample_scene()`` at 1920x1080, spp 25,
      10 bounces, ``spp_chunk=5`` (5 path and 5 sky-tap launches a frame),
      a warm-up and two timed frames, peak device memory;
   b. the bounce split on the main path's cell (``split_bounce=2,
      split_frac=0.125``, three sky-tap launches a frame): one frame within
      1e-5 of the unsplit frame of the same key, then 15 ``step(1)`` frames
      of each in turns, the host waits of one split step, and the cost of
      its remainder pass;
   c. ``dispatch_bands=5`` on the same cell: one step bit-equal to the
      manual composition of its five bands under the key chain;
   d. ``cuda_env.ENV_IMPL = "bf16"``: one frame bit-equal to the default
      impl's, through one launch of the sky-tap kernel's byte-plane fetch;
   and two small checks: the split's overflow regime at 192x96 (survivors
   past the compact buffer) within 1e-5 of unsplit, and a chunked frame at
   192x96 (spp 5, ``spp_chunk=2``) against its spp-weighted sub-frames.

7. the preview path on the main path's cell (``Renderer(bench_scene(100_000),
   1920x1080, spp 1, 8 bounces, device="cuda")``), each sub-phase counted
   on its own:
   a. ``aovs()``: exactly one closest-hit launch on 2,073,600 pixel-centre
      rays, its buffers held against ``closest_hit_plain`` on a strided
      subset (hit masks and winners agree on >= 99.99% of rays, t to 1e-5
      relative, albedo and emission equal and normals to 1e-6 where both
      hit one primitive), and its time;
   b. the a-trous kernel (``urt_atrous``) against ``atrous_denoise_plain``
      on the renderer's accumulator after 4 frames, unguided and guided by
      the AOVs of (a), 3 and 5 levels: within ATROUS_ULP ulp, one launch a
      level; its time per level, the plain version's, and its bound, with
      expf counted by its SASS instructions;
   c. ``watch(every=4, frames=12, denoise=True, guided=True, http_port=)``:
      both URLs answered, the median tick split into step, denoise and PNG;
   d. ``save_aovs`` at 1080p, read back part by part with the port's
      ``load_exr``, equal to the half-rounded buffers, and its seconds;
   e. ``profile(3)``: its report, with the path, env and rng stages
      non-zero.

Phase 3 also holds the path kernel's 16 resume-state rows against the plain
version's (bit for bit, at 192x96 x 4 and on the 1080p x 8 subset with two
bounces).

The line before the last is a JSON object with each kernel's launches in
the run of the path that uses it (the main path for the path, sky-tap
("env") and threefry kernels; 0 for the closest-hit kernel, whose count
from the megakernel=False frame stands under
``launches_megakernel_false``; the bf16 frame for the sky tap's byte-plane
fetch, "env_planes"), the counts of every path under ``launches_by_path``,
its error against the plain version (the a-trous kernel also in ulp),
both times (``shape`` and
``plain_shape`` say at what size), ``bound_ms``, the least time the card
could take for the kernel's work at ``shape`` (the larger of its bytes over
3.35 TB/s and its operations over the peak rate of their type,
``bound_by`` naming which), and ``library_ms``, null: no single PyTorch
call computes any of these functions (none computes an edge-stopping
bilateral a-trous pass). A threefry draw and an expf are priced by their
SASS instructions: a kernel of one draw (or one expf) against a kernel of
one copy, built with the kernels' flags and read with cuobjdump (phase 2);
a draw's integer-ALU instructions at the ALU's rate, or all of them at the
SM's issue rate, whichever is slower. The closest-hit and a-trous kernels' ``launches``
are those of the preview run (7c). The last line is ``{"ok": true,
"device": {...}}``. Without a CUDA device it exits non-zero and prints no
result.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
N_TRIS = 100_000
MAIN = dict(width=1920, height=1080, spp=1, bounces=8, tracer="pallas",
            wavefront=True, rr_group="step")
# The reference's quality preset (SampleScene.unity:433-434: 10 bounces,
# 25 rays per pixel) at 1080p, in chunks of 5 samples as the JAX package
# renders it (README.md:217-223).
QUALITY = dict(width=1920, height=1080, spp=25, bounces=10, tracer="pallas",
               wavefront=True, rr_group="step", spp_chunk=5)
SPLIT = dict(split_bounce=2, split_frac=0.125)
# The threefry kernels' log2, cos and sin rows against torch's on the card,
# in ulp (0: bit for bit).
ROWS_ULP = 0.0

# Directions at the edges of the sky tap's texel pick: the poles with
# signed zeros, beyond the clamp, the seam x = +-0 with z > 0, the opposite
# seam, an axis.
SKY_EDGES = [(0.0, 1.0, 0.0), (-0.0, 1.0, -0.0), (0.0, -1.0, -0.0),
             (-0.0, -1.0, 0.0), (0.0, 1.0000001, 0.0), (0.0, -1.0000001, 0.0),
             (0.0, 0.3, 0.9), (-0.0, 0.3, 0.9), (0.0, 0.0, 1.0),
             (-0.0, 0.0, 1.0), (0.0, 0.0, -1.0), (-0.0, 0.0, -1.0),
             (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0)]
# Device launches a frame of the main path before the fused sky tap
# (PERF.md, the profiled window of the previous slice's runs).
LAUNCHES_BEFORE = 161.3

# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): memory, and
# float32 outside the tensor cores (132 SMs x 128 lanes x 2 x 1.98 GHz). The
# int32 rate is the integer ALU's 64 lanes an SM a clock: 132 SMs x 64 lanes
# x 1.98 GHz; an SM issues 128 instructions of any kind a clock, twice that.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_I32 = 132 * 64 * 1.98e9
# SASS opcodes that run on the integer ALU pipe alone (IMAD runs on the
# multiply-add pipe, uniform opcodes on the uniform pipe).
ALU_OPCODES = {"IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PRMT",
               "IMNMX", "IABS", "FLO", "POPC", "BREV"}
# Operations counted per unit of work: one slab test of closest_hit.cuh (6
# subtractions, 6 products, 12 min/max, the widening product) and one MT97
# test on precomputed edges (27 products and sums of the cross and dot
# products, the division, 6 comparisons). A threefry draw and an expf are
# counted by their SASS instructions (``sass_counts``).
FLOP_BOX = 25
FLOP_TRI = 49
# Float operations of one a-trous tap besides its expf: the color distance
# (3 subtractions, 3 products, 2 sums), its negation and weight (2), the
# tap weight and w (2), the three products and sums of acc and the sum of
# wsum (7): 8 + 2 + 2 + 7; each guide adds its distance (8), weight and
# subtraction (10).
FLOP_TAP = 19
FLOP_TAP_GUIDE = 10


def bound(nbytes, ops=0.0, rate=PEAK_F32):
    """(bound_ms, bound_by): the larger of the bytes' and the operations'
    least times."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def scene_bytes(ks) -> int:
    """Bytes of what the closest-hit function reads of a KernelScene: its
    traversal tables, normals and triangle materials, spheres and
    materials."""
    tr, s = ks.accel.triangles, ks.scene
    parts = [*ks.tables.values(), tr.n0, tr.n1, tr.n2, tr.material_id,
             s.spheres.center, s.spheres.radius, s.spheres.material_id,
             s.materials.albedo, s.materials.specular, s.materials.emission,
             s.materials.smoothness]
    return sum(p.numel() * p.element_size() for p in parts)


def sass_counts(pairs, flags) -> dict:
    """SASS instructions that ``body`` adds to ``base``, by opcode, for each
    ``name: (body, base)`` of ``pairs``: two kernels that write
    ``y[i] = body`` and ``y[i] = base`` for one thread's index ``i`` (keys
    ``k0``, ``k1`` by value, csrc/threefry.cuh included), all built at once
    with ``flags`` and read back with cuobjdump (NOPs not counted). The
    kernels are straight-line code, so a static count is what each thread
    runs."""
    from unityraytracer_tpu_torch import _build

    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    tmp = tempfile.mkdtemp(prefix="urt_sass_")
    try:
        procs = {}
        for name, bodies in pairs.items():
            for side, body in zip(("body", "base"), bodies):
                src = os.path.join(tmp, f"{name}_{side}.cu")
                with open(src, "w") as f:
                    f.write('#include "threefry.cuh"\n'
                            "__global__ void k(const float* x, float* y, "
                            "unsigned k0, unsigned k1) {\n"
                            "  const unsigned i = blockIdx.x * blockDim.x "
                            "+ threadIdx.x;\n"
                            f"  y[i] = {body};\n}}\n")
                procs[src] = subprocess.Popen(
                    [nvcc, *[f for f in flags if f not in ("-Xcompiler",
                                                           "-fPIC")],
                     f"-I{_build.CSRC}", "-cubin", "-o", src[:-3] + ".cubin",
                     src], stderr=subprocess.PIPE, text=True)
        for p in procs.values():
            if p.wait(timeout=300) != 0:
                raise RuntimeError(f"nvcc failed: {p.stderr.read()}")

        def opcodes(src):
            res = subprocess.run([cuobjdump, "-sass", src[:-3] + ".cubin"],
                                 capture_output=True, text=True, timeout=60,
                                 check=True)
            out = {}
            for ln in res.stdout.splitlines():
                if not (ln.strip().startswith("/*") and ";" in ln):
                    continue
                words = [w for w in ln.split("*/", 1)[1].split(";")[0].split()
                         if not w.startswith("@")]
                op = words[0].split(".")[0] if words else "NOP"
                if op != "NOP":
                    out[op] = out.get(op, 0) + 1
            return out

        result = {}
        for name in pairs:
            body = opcodes(os.path.join(tmp, f"{name}_body.cu"))
            base = opcodes(os.path.join(tmp, f"{name}_base.cu"))
            diff = {op: body.get(op, 0) - base.get(op, 0)
                    for op in sorted(set(body) | set(base))}
            result[name] = {op: v for op, v in diff.items() if v}
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def int_ops(counts) -> int:
    """Integer-ALU operations that bound the time of ``counts`` (SASS
    opcodes of one unit of work) at PEAK_I32: its ALU instructions, or half
    of all its instructions (an SM issues twice the ALU's lanes a clock),
    whichever is more."""
    alu = sum(v for op, v in counts.items() if op in ALU_OPCODES)
    return max(alu, -(-sum(counts.values()) // 2))


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
    from unityraytracer_tpu_torch.ops import cuda_env
    from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
    from unityraytracer_tpu_torch.ops.cuda_env import sky_tap, sky_tap_plain
    from unityraytracer_tpu_torch.ops.cuda_path import (path_trace,
                                                        path_trace_plain)
    from unityraytracer_tpu_torch.ops.cuda_trace import (KernelScene,
                                                         closest_hit_plain,
                                                         trace_hits)
    from unityraytracer_tpu_torch.render import (RenderState, _camera_rays,
                                                 _env_tap, _frame_inputs,
                                                 _sky_keys, bounce_rows,
                                                 bounce_rows_plain,
                                                 progressive_step,
                                                 render_frame, render_sample,
                                                 split_capacity)
    from unityraytracer_tpu_torch.ops.trace import make_brute_tracer
    from unityraytracer_tpu_torch.utils.image import rmse, ulp_distance

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
    # The instructions of one threefry draw and of one expf, as the kernels
    # are built: they price the bounds of the threefry and a-trous kernels.
    sass = sass_counts({"draw": ("urt_uniform_at(k0, k1, i)",
                                 "__uint_as_float(i)"),
                        "expf": ("expf(x[i])", "x[i]")}, _build.NVCC_FLAGS)
    draw_ops, n_exp = int_ops(sass["draw"]), sum(sass["expf"].values())
    log(f"SASS of one threefry draw {sass['draw']}: {draw_ops} int32 ops "
        f"for its bound; of one expf {sass['expf']}: {n_exp} instructions")

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

    # 3a. The sky-tap kernel vs its plain version, bit for bit, in both
    # fetch modes: on the main path's own (9, N) path-kernel output at
    # 1080p, and on random directions with the pick's edge cases in all
    # three counter modes. Each side composes into its own copy of the
    # radiance rows.
    def bits_equal(a, b):
        a = torch.as_tensor(a).float().contiguous()
        b = torch.as_tensor(b).float().contiguous()
        return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))

    hw = tuple(scene_np.skybox.shape[:2])
    packed = scene.skybox_rgbe
    n_env = MAIN["width"] * MAIN["height"]
    cfg_m = RenderConfig(**MAIN)
    ro, rd, uni, k_sky, _ = _frame_inputs(scene, cam_main, rng.key(8), cfg_m)
    main_rows = path_trace(ks, ro, rd, uni, cfg_m)
    _build.raise_on_overflow(dev)
    sky_keys = _sky_keys(cfg_m, k_sky)
    del ro, rd, uni
    g = torch.Generator(device=dev).manual_seed(0)
    d = torch.randn((3, n_env), generator=g, device=dev)
    d = d / d.norm(dim=0, keepdim=True)
    d[:, :len(SKY_EDGES)] = torch.tensor(SKY_EDGES, device=dev).T
    edge_rows = (tuple(torch.rand((3, n_env), generator=g, device=dev)),
                 tuple(torch.rand((3, n_env), generator=g, device=dev) * 2),
                 tuple(d))
    ray_index = torch.randint(0, 5 * n_env, (n_env,), generator=g,
                              device=dev)
    sky_cases = {
        "main path 1080p output": (main_rows, {}),
        "edge directions, counter i": (edge_rows, {}),
        "edge directions, ray_index": (edge_rows, {"ray_index": ray_index}),
        "edge directions, block slot": (
            edge_rows, {"lattice": (MAIN["height"], MAIN["width"], 1)}),
    }
    by_impl, sky_err = {}, {"int8x8": 0.0, "bf16": 0.0}
    for impl in ("int8x8", "bf16"):
        for tag, ((rad, se, sd), kw) in sky_cases.items():
            got = sky_tap(hw, packed, tuple(c.clone() for c in rad), se, sd,
                          sky_keys, impl=impl, **kw)
            want = sky_tap_plain(hw, packed, tuple(c.clone() for c in rad),
                                 se, sd, sky_keys, impl=impl, **kw)
            torch.cuda.synchronize()
            same = bits_equal(torch.stack(got), torch.stack(want))
            err = float((torch.stack(got) - torch.stack(want)).abs().max())
            sky_err[impl] = max(sky_err[impl], err)
            moved = float((torch.stack(got) != torch.stack(rad)).float()
                          .mean())
            log(f"sky tap [{impl}, {tag}]: {n_env} rays, bit-identical "
                f"{same}, max abs err {err:.3e}, radiance changed on "
                f"{moved:.4f}")
            if not same:
                raise AssertionError(f"sky-tap kernel differs from its plain "
                                     f"version ({impl}, {tag})")
            by_impl.setdefault(tag, []).append(got)
    for tag, (a, b) in by_impl.items():
        if not bits_equal(torch.stack(a), torch.stack(b)):
            raise AssertionError(f"sky-tap fetch modes differ ({tag})")
    del by_impl, got, want, edge_rows, d, ray_index
    # Times on the main path's output; the compose goes into a scratch copy
    # of the radiance, again at every launch.
    rad_m, se_m, sd_m = main_rows
    scratch = tuple(c.clone() for c in rad_m)
    for name, impl, line, table_bytes in (
            ("env", "int8x8", 88, packed.numel() * 4),
            ("env_planes", "bf16", 63, packed.numel() * 4)):
        kernels[name] = dict(
            route="cuda", source="unityraytracer_tpu_torch/csrc/env_kernel.cu",
            replaces=f"unityraytracer_tpu/ops/pallas_env.py:{line}",
            max_abs_err=sky_err[impl], shape=[n_env], plain_shape=[n_env],
            ms=cuda_ms(lambda: sky_tap(hw, packed, scratch, se_m, sd_m,
                                       sky_keys, impl=impl), 20, 3),
            plain_ms=cuda_ms(lambda: sky_tap_plain(hw, packed, scratch, se_m,
                                                   sd_m, sky_keys, impl=impl),
                             5, 1))
        # Radiance, sky throughput and sky direction read, radiance
        # written, the sky map read once; two threefry draws a ray.
        kernels[name]["bound_ms"], kernels[name]["bound_by"] = bound(
            n_env * 48 + table_bytes, n_env * 2 * draw_ops, PEAK_I32)
        log(f"{name}:", json.dumps(kernels[name]))
    del main_rows, rad_m, se_m, sd_m, scratch

    # 3a'. The threefry kernels against their plain versions (int64 torch
    # hashes), bit for bit: one row, and the path kernel's uniform rows.
    for n in (n_env, 5 * n_env):
        key = rng.fold_in(rng.key(50), n)
        got = rng.uniform(key, (n,), device=dev)
        want = rng.uniform_plain(key, (n,), device=dev)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise AssertionError(f"threefry uniform kernel differs from its "
                                 f"plain version on {n} counters")
        log(f"uniform: {n} counters bit-identical")
    del got, want
    ukey = rng.key(51)
    kernels["uniform"] = dict(
        route="cuda", source="unityraytracer_tpu_torch/csrc/uniform_kernel.cu",
        replaces="unityraytracer_tpu/render.py:465",
        max_abs_err=0.0, shape=[n_env], plain_shape=[n_env],
        ms=cuda_ms(lambda: rng.uniform(ukey, (n_env,), device=dev), 20, 3),
        plain_ms=cuda_ms(lambda: rng.uniform_plain(ukey, (n_env,),
                                                   device=dev), 5, 1))
    kernels["uniform"]["bound_ms"], kernels["uniform"]["bound_by"] = bound(
        n_env * 4, n_env * draw_ops, PEAK_I32)
    log("uniform:", json.dumps(kernels["uniform"]))

    qsub = RenderConfig(**QUALITY).replace(spp=QUALITY["spp_chunk"],
                                           spp_chunk=None)
    H_m = cfg_m.height
    row_cases = {   # (config, band rows, row0)
        "main 1920x1080 x 8, rr_group step": (cfg_m, H_m, 0),
        "quality chunk spp 5 x 10 bounces": (qsub, H_m, 0),
        "band rows 216-431 of dispatch_bands=5": (cfg_m, 216, 216),
    }
    max_ulp, max_abs = {}, 0.0
    for tag, (cfg_r, h_r, row0_r) in row_cases.items():
        kb = rng.split(rng.fold_in(rng.key(52), row0_r), 3)[2]
        got = bounce_rows(kb, cfg_r, h_r, row0_r, True, dev)
        want = bounce_rows_plain(kb, cfg_r, h_r, row0_r, True, dev)
        torch.cuda.synchronize()
        exact = [bits_equal(got[:, r], want[:, r]) for r in range(5)]
        d = (got - want).abs()
        ulp = (d / torch.maximum(got.abs(), want.abs()).clamp_min(
            1e-38).mul(2.0 ** -23)).amax(dim=(0, 2)).cpu().tolist()
        for r in range(5):
            max_ulp[r] = max(max_ulp.get(r, 0.0), ulp[r])
        max_abs = max(max_abs, float(d.max()))
        log(f"bounce_rows[{tag}]: {tuple(got.shape)}, rows bit-identical "
            f"{exact}, max ulp per row {[f'{u:.2f}' for u in ulp]}")
        # u_r and the roulette row must be bit-identical; the log2, cos and
        # sin rows within ROWS_ULP (the CUDA math library on both sides).
        if not (exact[0] and exact[4] and max(ulp[1:4]) <= ROWS_ULP):
            raise AssertionError(f"uniform-row kernel vs plain ({tag}): "
                                 f"exact {exact}, ulp {ulp}")
    del got, want, d
    kb = rng.split(rng.key(53), 3)[2]
    n_m = cfg_m.num_rays
    draws = n_m * (3 * cfg_m.bounces + (cfg_m.bounces - 3))
    kernels["bounce_rows"] = dict(
        route="cuda", source="unityraytracer_tpu_torch/csrc/uniform_kernel.cu",
        replaces="unityraytracer_tpu/render.py:495",
        max_abs_err=max_abs, max_ulp_by_row=max_ulp,
        shape=[cfg_m.bounces, 5, n_m], plain_shape=[cfg_m.bounces, 5, n_m],
        ms=cuda_ms(lambda: bounce_rows(kb, cfg_m, H_m, 0, True, dev), 20, 3),
        plain_ms=cuda_ms(lambda: bounce_rows_plain(kb, cfg_m, H_m, 0, True,
                                                   dev), 3, 1),
        draw_ops=draw_ops)
    # The rows written once and the draws' integer work; the log2, cos and
    # sin are left out (cosf and sinf branch to a slow path that a static
    # count would include), so the bound errs low.
    kernels["bounce_rows"]["bound_ms"], kernels["bounce_rows"]["bound_by"] = \
        bound(cfg_m.bounces * 5 * n_m * 4, draws * draw_ops, PEAK_I32)
    log("bounce_rows:", json.dumps(kernels["bounce_rows"]))

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
    # Traversal counts on the 1080p camera rays; the counts output changes
    # no hit.
    n_m = rom[0].shape[0]
    cnt = torch.empty((2, n_m), dtype=torch.int32, device=dev)
    hc = trace_hits(ks, rom, rdm, counts=cnt)
    _build.raise_on_overflow(dev)
    if not (torch.equal(hc.prim, hm.prim) and torch.equal(hc.t, hm.t)):
        raise AssertionError("closest-hit kernel: the counts output changed "
                             "its hits")
    tests = cnt.sum(dim=1, dtype=torch.int64).cpu().tolist()
    trav = {"trace_1080p_camera_rays": dict(
        rays=n_m, box_tests=tests[0], tri_tests=tests[1],
        box_per_ray=tests[0] / n_m, tri_per_ray=tests[1] / n_m,
        exhaustive_tri_per_ray=ks.accel.triangles.count)}
    log("traversal counts:", json.dumps(trav))
    kernels["trace"] = dict(
        route="cuda", source="unityraytracer_tpu_torch/csrc/trace_kernel.cu",
        replaces="unityraytracer_tpu/ops/pallas_trace.py:1109",
        max_abs_err=err_hits, shape=[n_m], plain_shape=[ro[0].shape[0]],
        ms=cuda_ms(lambda: trace_hits(ks, rom, rdm), 5, 1),
        plain_ms=plain_ms, ms_small=ms_small)
    # Rays and the alive row read, 14 rows and the winner written, the
    # scene's tables read once; the box and MT97 tests this run made.
    kernels["trace"]["bound_ms"], kernels["trace"]["bound_by"] = bound(
        n_m * (28 + 56 + 4) + scene_bytes(ks),
        tests[0] * FLOP_BOX + tests[1] * FLOP_TRI)
    log("trace:", json.dumps(kernels["trace"]))

    # 3c. Path kernel vs plain on the render's own rays and uniform rows:
    # all nine output rows (radiance, sky throughput, sky direction). Both
    # run the same MT97, winner rules and float32 shading (-fmad=false), so
    # every value must agree bit for bit; the radiance must also meet the
    # repo's image bar, RMSE < 1e-3.
    def path_check(cfg, cam, key, stride, tag):
        ro, rd, uni, _, _ = _frame_inputs(scene, cam, key, cfg)
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
        same = bool((a.view(np.uint32) == b.view(np.uint32)).all())
        log(f"path[{tag}]: {ro[0].shape[0]} rays (plain on {idx.numel()}), "
            f"radiance RMSE {err:.3e}, max abs over 9 rows "
            f"{float(diff.max()):.3e}, max {ulps:.1f} ulp, bit-identical "
            f"{same}")
        if not (err < 1e-3 and same):
            raise AssertionError(f"path kernel vs plain ({tag}): RMSE {err}, "
                                 f"{ulps} ulp")
        return ro, rd, uni, uni_s, sel, float(diff.max())

    def state_check(cfg, cam, key, stride, nb, tag):
        """The 16 resume-state rows after ``nb`` bounces, kernel vs plain,
        bit for bit, dead rays included (zero energy where alive is 0)."""
        ro, rd, uni, _, _ = _frame_inputs(scene, cam, key, cfg)
        *_, sk = path_trace(ks, ro, rd, uni[:nb], cfg, nb=nb, emit_state=True)
        idx = torch.arange(0, ro[0].shape[0], stride, device=dev)
        sel = lambda v3: tuple(c[idx].contiguous() for c in v3)  # noqa: E731
        *_, sp = path_trace_plain(ks, sel(ro), sel(rd),
                                  uni[:nb, :, idx].contiguous(), cfg, nb=nb,
                                  emit_state=True)
        _build.raise_on_overflow(dev)
        sk = sk[:, idx]
        same = torch.equal(sk.view(torch.int32), sp.view(torch.int32))
        dead = sk[9] == 0
        zero_dead = bool((sk[6:9, dead] == 0).all() and (sk[10:] == 0).all())
        log(f"path state[{tag}]: {idx.numel()} rays, nb={nb}, 16 rows "
            f"bit-identical {same}, alive {float((~dead).float().mean()):.4f}, "
            f"dead rays' energy 0 {zero_dead}")
        if not (same and zero_dead):
            raise AssertionError(f"path kernel state vs plain ({tag})")

    cfg_s = small_cfg()
    ro, rd, uni, _, _, err_path = path_check(cfg_s, cam_small, rng.key(7), 1,
                                             "192x96x4")
    state_check(cfg_s, cam_small, rng.key(7), 1, 4, "192x96x4")
    ms_small = cuda_ms(lambda: path_trace(ks, ro, rd, uni, cfg_s), 10, 2)
    plain_ms = cuda_ms(lambda: path_trace_plain(ks, ro, rd, uni, cfg_s), 2, 1)
    rom, rdm, unim, _, _, err_m = path_check(cfg_m, cam_main, rng.key(8), 97,
                                             "1080p x 8 subset")
    state_check(cfg_m, cam_main, rng.key(8), 97, 2, "1080p x 8 subset")
    # Traversal counts over the 8 bounces of the 1080p frame; the counts
    # output changes none of the nine rows.
    n_m = rom[0].shape[0]
    cnt = torch.empty((2, n_m), dtype=torch.int32, device=dev)
    with_c = path_trace(ks, rom, rdm, unim, cfg_m, counts=cnt)
    without = path_trace(ks, rom, rdm, unim, cfg_m)
    _build.raise_on_overflow(dev)
    if not all(bits_equal(torch.stack(a), torch.stack(b))
               for a, b in zip(with_c, without)):
        raise AssertionError("path kernel: the counts output changed its "
                             "rows")
    tests = cnt.sum(dim=1, dtype=torch.int64).cpu().tolist()
    trav["path_1080p_x8"] = dict(
        rays=n_m, box_tests=tests[0], tri_tests=tests[1],
        box_per_ray=tests[0] / n_m, tri_per_ray=tests[1] / n_m,
        max_tri_per_ray=int(cnt[1].max()))
    log("traversal counts:", json.dumps(trav["path_1080p_x8"]))
    del with_c, without, cnt
    kernels["path"] = dict(
        route="cuda", source="unityraytracer_tpu_torch/csrc/path_kernel.cu",
        replaces="unityraytracer_tpu/ops/pallas_path.py:59",
        max_abs_err=max(err_path, err_m), shape=[cfg_m.bounces, 5, n_m],
        plain_shape=[cfg_s.bounces, 5, ro[0].shape[0]],
        ms=cuda_ms(lambda: path_trace(ks, rom, rdm, unim, cfg_m), 5, 1),
        plain_ms=plain_ms, ms_small=ms_small, traversal=trav)
    # Rays and uniform rows read, nine rows written, the scene's tables
    # read once; the box and MT97 tests this run made (the shading's ~150
    # FLOP a bounce are left out, so the bound errs low).
    kernels["path"]["bound_ms"], kernels["path"]["bound_by"] = bound(
        n_m * (24 + cfg_m.bounces * 20 + 36) + scene_bytes(ks),
        tests[0] * FLOP_BOX + tests[1] * FLOP_TRI)
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
    for k in ("path", "env", "uniform", "bounce_rows"):
        if launches[k] < 1:
            raise AssertionError(f"kernel {k!r} never launched on the main "
                                 f"path: {launches}")
    # One sky-tap launch a frame, and only the camera's four draws.
    nf = len(frame_ms)
    if launches["env"] != nf or launches["uniform"] != 4 * nf \
            or launches["env_planes"] != 0:
        raise AssertionError(f"main path: expected 1 sky-tap and 4 uniform "
                             f"launches a frame, got {launches} in {nf}")
    by_path = {"main": launches}
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
    ro, rd, uni, k_bounce, from_blocks = _frame_inputs(scene, cam_main, fkey,
                                                       cfg_m)
    rad, se, sd = path_trace(r.accel, ro, rd, uni, cfg_m)
    scratch = tuple(c.clone() for c in rad)

    def accumulate():
        img = torch.stack([from_blocks(c).mean(dim=0) for c in rad], dim=-1)
        return progressive_step(r.state, img)

    layers = {
        "camera_rays": cuda_ms(lambda: _camera_rays(
            cam_main, fkey, cfg_m, H_m, cfg_m.width, 1, 0, True,
            lambda a: a, dev), 10, 2),
        "uniform_rows": cuda_ms(lambda: bounce_rows(
            k_bounce, cfg_m, H_m, 0, True, dev), 10, 2),
        "rays_and_rows": cuda_ms(
            lambda: _frame_inputs(scene, cam_main, fkey, cfg_m), 10, 2),
        "path_kernel": cuda_ms(lambda: path_trace(r.accel, ro, rd, uni, cfg_m),
                               5),
        "sky_tap": cuda_ms(lambda: _env_tap(scene, cfg_m, scratch, se, sd,
                                            k_bounce), 5),
        "accumulate": cuda_ms(accumulate, 5),
    }
    log("layers (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in layers.items()))
    del ro, rd, uni, rad, se, sd, scratch

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
        f"{busy_us / 1e3:.3f} ms over {len(spans)} device events "
        f"({len(spans) / 3:.1f} a frame), busy share "
        f"{busy_us / 1e3 / wall_ms:.4f}")
    log(f"device launches a frame: before {LAUNCHES_BEFORE} (PERF.md), now "
        f"{len(spans) / 3:.1f}")

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

    # 6. This slice's paths, each counted on its own.
    def counted(fn):
        for k in _build.LAUNCHES:
            _build.LAUNCHES[k] = 0
        out = fn()
        return out, dict(_build.LAUNCHES)

    # 6a. The quality preset.
    qcfg = RenderConfig(**QUALITY)
    scene_q = fixtures.sample_scene()
    cam_q = fixtures.sample_scene_camera(16 / 9)
    torch.cuda.reset_peak_memory_stats()
    rq = Renderer(scene_q, cam_q, qcfg, seed=0, device="cuda").step(1)
    q_ms, q_launch = [], []
    for _ in range(2):
        _, la = counted(lambda: rq.step(1))
        q_ms.append(rq.stats["ms_per_frame"])
        q_launch.append(la)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    img = rq.image
    n_chunks = -(-qcfg.spp // qcfg.spp_chunk)
    if not (np.isfinite(img).all() and img.max() > 0):
        raise AssertionError("quality preset: non-finite or black image")
    for la in q_launch:
        if la["path"] != n_chunks or la["env"] != n_chunks \
                or la["uniform"] != 4 * n_chunks:
            raise AssertionError(f"quality preset: expected {n_chunks} path "
                                 f"and sky-tap launches and {4 * n_chunks} "
                                 f"uniform launches a frame, got {la}")
    by_path["quality"] = q_launch[-1]
    q_rays = qcfg.num_rays * qcfg.bounces
    log(f"quality preset 1920x1080 spp 25 x 10 bounces (spp_chunk 5) on "
        f"sample_scene ({scene_q.num_triangles} triangles): frames "
        f"{', '.join(f'{t:.2f}' for t in q_ms)} ms, "
        f"{q_rays / np.mean(q_ms) / 1e3:.2f} Mrays/s dispatched "
        f"({q_rays / 1e6:.1f}M slots a frame), peak device memory "
        f"{peak_gb:.3f} GiB; launches a frame {q_launch[-1]}")
    # Where one chunk's time goes (CUDA events, each layer alone).
    qkey = rng.key(13)
    ro, rd, uni, qk_bounce, _ = _frame_inputs(rq.scene, cam_q, qkey, qsub)
    rad, se, sd = path_trace(rq.accel, ro, rd, uni, qsub)
    q_layers = {
        "rays_and_uniform_rows": cuda_ms(
            lambda: _frame_inputs(rq.scene, cam_q, qkey, qsub), 3),
        "uniform_rows": cuda_ms(lambda: bounce_rows(
            qk_bounce, qsub, qsub.height, 0, True, dev), 3),
        "path_kernel": cuda_ms(lambda: path_trace(rq.accel, ro, rd, uni,
                                                  qsub), 3),
        "sky_tap": cuda_ms(lambda: _env_tap(rq.scene, qsub, rad, se, sd,
                                            qk_bounce), 3),
    }
    log("quality preset, one chunk of 10.4M rays, layers (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in q_layers.items()))
    # The uniform-row kernel at the chunk's shape, against its bound there.
    n_q = qsub.num_rays
    q_draws = n_q * (3 * qsub.bounces + (qsub.bounces - 3))
    qb, qby = bound(qsub.bounces * 5 * n_q * 4, q_draws * draw_ops, PEAK_I32)
    kernels["bounce_rows"]["quality_chunk"] = dict(
        shape=[qsub.bounces, 5, n_q], ms=q_layers["uniform_rows"],
        bound_ms=qb, bound_by=qby, share=qb / q_layers["uniform_rows"])
    log("bounce_rows at the quality chunk:",
        json.dumps(kernels["bounce_rows"]["quality_chunk"]))
    del rq, ro, rd, uni, rad, se, sd

    # 6b. The bounce split on the main path's cell.
    scfg = cfg_m.replace(**SPLIT)
    fkey = rng.key(21)
    unsplit = render_frame(scene, cfg_m, cam_main, fkey, r.accel)
    split, la = counted(lambda: render_frame(scene, scfg, cam_main, fkey,
                                             r.accel))
    _build.raise_on_overflow(dev)
    split_err = float((split - unsplit).abs().max())
    log(f"split vs unsplit (1080p x 8, split_bounce 2, frac 0.125): "
        f"max |diff| {split_err:.3e}; launches {la}")
    if not (torch.isfinite(split).all() and split_err <= 1e-5):
        raise AssertionError(f"split frame differs from unsplit: {split_err}")
    ro, rd, uni, k_bounce, _ = _frame_inputs(scene, cam_main, fkey, cfg_m)
    *_, st = path_trace(r.accel, ro, rd, uni[:2], cfg_m, nb=2,
                        emit_state=True)
    n_alive = int(st[9].sum())
    cap = split_capacity(cfg_m.num_rays, SPLIT["split_frac"])
    dead = torch.zeros_like(ro[0])
    rem_ms = cuda_ms(lambda: path_trace(
        r.accel, tuple(st[0:3]), tuple(st[3:6]), uni[2:], cfg_m, b0=2, nb=6,
        energy0=tuple(st[6:9]), alive0=dead), 10, 2)
    rad_rem, se_rem, sd_rem = path_trace(r.accel, tuple(st[0:3]),
                                         tuple(st[3:6]), uni[2:], cfg_m, b0=2,
                                         nb=6, energy0=tuple(st[6:9]),
                                         alive0=dead)
    rem_sky_ms = cuda_ms(lambda: _env_tap(scene, cfg_m, rad_rem, se_rem,
                                          sd_rem, k_bounce), 10, 2)
    log(f"split: {n_alive} of {cfg_m.num_rays} rays alive after bounce 2, "
        f"compact buffer {cap}; remainder pass with no overflow: path "
        f"kernel {rem_ms:.3f} ms + full-width sky tap {rem_sky_ms:.3f} ms")
    del ro, rd, uni, st, rad_rem, se_rem, sd_rem, dead
    rs = Renderer(scene_np, cam_main, scfg, accel=r.accel, seed=0,
                  device="cuda")
    ru = Renderer(scene_np, cam_main, cfg_m, accel=r.accel, seed=0,
                  device="cuda")
    rs.step(1)
    ru.step(1)
    waits = {}
    for tag, rr in (("split", rs), ("unsplit", ru)):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rr.step(1)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        waits[tag] = [f"{os.path.basename(w.filename)}:{w.lineno}"
                      for w in caught
                      if "called a synchronizing" in str(w.message)]
    log(f"host waits in one step(1), by the line that waited: {waits}")
    if len(waits["split"]) > len(waits["unsplit"]):
        raise AssertionError(f"the split step waits on the device: {waits}")
    ab = {"split": [], "unsplit": []}
    split_launch = {k: 0 for k in _build.LAUNCHES}
    for _ in range(15):
        _, la = counted(lambda: rs.step(1))
        ab["split"].append(rs.stats["ms_per_frame"])
        for k in la:
            split_launch[k] += la[k]
        ru.step(1)
        ab["unsplit"].append(ru.stats["ms_per_frame"])
    by_path["split"] = split_launch
    # Three sky taps a split frame: the compact pass's, the remainder
    # pass's and the full-width one of the first segment's misses.
    if split_launch["path"] != 45 or split_launch["env"] != 45 \
            or split_launch["uniform"] != 60:
        raise AssertionError(f"split frames: expected 3 path, 3 sky-tap "
                             f"and 4 uniform launches each, got "
                             f"{split_launch} in 15")
    log("split A/B, 15 step(1) frames each in turns: " + "; ".join(
        f"{k} median {np.median(v):.2f} ms (min {min(v):.2f}, max "
        f"{max(v):.2f}), {cfg_m.num_rays * cfg_m.bounces / np.median(v) / 1e3:.2f}"
        f" Mrays/s" for k, v in ab.items()))
    del rs, ru, split, unsplit

    # 6c. Bands: one step against the manual composition under the key chain.
    bcfg5 = cfg_m.replace(dispatch_bands=5)
    rb, la = counted(lambda: Renderer(scene_np, cam_main, bcfg5,
                                      accel=r.accel, seed=5,
                                      device="cuda").step(1))
    by_path["bands"] = la
    _, sub5 = rng.split(rng.key(5))
    fkey5 = rng.fold_in(sub5, 0)
    bh = -(-cfg_m.height // 5)
    manual = [render_frame(scene, bcfg5, cam_main, rng.fold_in(fkey5, bi),
                           r.accel, row0=row0, rows=min(bh, cfg_m.height - row0))
              for bi, row0 in enumerate(range(0, cfg_m.height, bh))]
    want = progressive_step(RenderState.create(cfg_m.width, cfg_m.height, dev),
                            torch.cat(manual, dim=0)).accum
    same = bits_equal(rb.state.accum, want)
    log(f"bands: 5 bands of {[m.shape[0] for m in manual]} rows, "
        f"{rb.stats['ms_per_frame']:.2f} ms; bit-equal to the manual "
        f"composition {same}; launches {la}")
    if not (same and la["path"] == 5 and la["env"] == 5):
        raise AssertionError("banded step differs from its manual "
                             f"composition or launched {la}")
    band_ms = [rb.step(1).stats["ms_per_frame"] for _ in range(5)]
    log(f"bands: 5 more step(1) frames, median {np.median(band_ms):.2f} ms "
        f"(min {min(band_ms):.2f}, max {max(band_ms):.2f})")
    del rb, manual, want

    # 6d. The bf16 impl: the byte-plane kernel in a main-path frame.
    r_def = Renderer(scene_np, cam_main, cfg_m, accel=r.accel, seed=9,
                     device="cuda").step(1)
    cuda_env.ENV_IMPL = "bf16"
    try:
        r_bf, la = counted(lambda: Renderer(scene_np, cam_main, cfg_m,
                                            accel=r.accel, seed=9,
                                            device="cuda").step(1))
    finally:
        cuda_env.ENV_IMPL = "int8x8"
    by_path["bf16"] = la
    same = bits_equal(r_bf.state.accum, r_def.state.accum)
    log(f"bf16 impl frame: bit-equal to the default impl {same}; "
        f"launches {la}")
    if not (same and la["env_planes"] == 1 and la["env"] == 0):
        raise AssertionError(f"bf16 impl frame: equal {same}, launches {la}")
    del r_def, r_bf

    # Small checks: the split's overflow regime, and chunk composition.
    ocfg = cfg_s.replace(split_bounce=1, split_frac=1e-9)
    okey = rng.key(31)
    ro, rd, uni, _, _ = _frame_inputs(scene, cam_small, okey, cfg_s)
    *_, st = path_trace(ks, ro, rd, uni[:1], cfg_s, nb=1, emit_state=True)
    n_alive, cap = int(st[9].sum()), split_capacity(ro[0].shape[0], 1e-9)
    a = render_frame(scene, cfg_s, cam_small, okey, ks)
    b = render_frame(scene, ocfg, cam_small, okey, ks)
    over_err = float((a - b).abs().max())
    log(f"split overflow at 192x96x4: {n_alive} survivors, buffer {cap}, "
        f"max |diff| {over_err:.3e}")
    if not (n_alive > cap and over_err <= 1e-5):
        raise AssertionError(f"split overflow regime: {n_alive} vs {cap}, "
                             f"diff {over_err}")
    ccfg = cfg_s.replace(spp=5, spp_chunk=2)
    ckey = rng.key(41)
    chunked = render_frame(scene, ccfg, cam_small, ckey, ks)
    s2, s1 = ccfg.replace(spp=2, spp_chunk=None), \
        ccfg.replace(spp=1, spp_chunk=None)
    parts = (render_frame(scene, s2, cam_small, rng.fold_in(ckey, 0), ks) * 0.4
             + render_frame(scene, s2, cam_small, rng.fold_in(ckey, 1), ks)
             * 0.4
             + render_frame(scene, s1, cam_small, rng.fold_in(ckey, 2), ks)
             * 0.2)
    chunk_err = float((chunked - parts).abs().max())
    log(f"spp_chunk composition at 192x96 (spp 5, chunk 2): max |diff| "
        f"{chunk_err:.3e}")
    torch.testing.assert_close(chunked, parts, rtol=1e-4, atol=5e-5)
    del ro, rd, uni, st

    # 7. The preview path on the main path's cell, each sub-phase counted.
    from unityraytracer_tpu_torch.models.exr import load_exr
    from unityraytracer_tpu_torch.render import aov_buffers, pixel_center_rays
    from unityraytracer_tpu_torch.utils.denoise import (ATROUS_ULP,
                                                        atrous_denoise,
                                                        atrous_denoise_plain)
    H_p, W_p = cfg_m.height, cfg_m.width
    n_p = H_p * W_p
    rp = Renderer(scene_np, cam_main, cfg_m, accel=r.accel, seed=17,
                  device="cuda").step(4)

    # 7a. aovs(): one closest-hit launch, against the plain version.
    g, la = counted(rp.aovs)
    torch.cuda.synchronize()
    _build.raise_on_overflow(dev)
    by_path["aovs"] = la
    if la["trace"] != 1 or sum(la.values()) != 1:
        raise AssertionError(f"aovs(): expected one closest-hit launch, "
                             f"got {la}")
    ro, rd = pixel_center_rays(cam_main, H_p, W_p, dev)
    alive = torch.ones(n_p, dtype=torch.bool, device=dev)
    hk = trace_hits(rp.accel, ro, rd, alive)
    gk = aov_buffers(hk, H_p, W_p)
    if not all(torch.equal(g[k], gk[k]) for k in g):
        raise AssertionError("aovs() differs from one trace of the "
                             "pixel-centre rays")
    sub = torch.arange(0, n_p, 97, device=dev)
    pick = lambda v3: tuple(c[sub].contiguous() for c in v3)  # noqa: E731
    hp = closest_hit_plain(rp.accel, pick(ro), pick(rd))
    _build.raise_on_overflow(dev)
    gp = aov_buffers(hp, 1, sub.numel())
    flat = {k: v.reshape(n_p, -1)[sub] for k, v in gk.items()}
    flat_p = {k: v.reshape(sub.numel(), -1) for k, v in gp.items()}
    hit_agree = float((flat["hit"] == flat_p["hit"]).float().mean())
    same = (hk.prim[sub] == hp.prim) & flat["hit"][:, 0]
    prim_agree = float((hk.prim[sub] == hp.prim).float().mean())
    attr_equal = all(torch.equal(flat[k][same], flat_p[k][same])
                     for k in ("albedo", "emission"))
    normal_err = float((flat["normal"][same] - flat_p["normal"][same])
                       .abs().max())
    t_rel = float(((flat["depth"][same] - flat_p["depth"][same]).abs()
                   / flat_p["depth"][same]).max())
    aov_ms = cuda_ms(rp.aovs, 10, 2)
    aov_trace_ms = cuda_ms(lambda: trace_hits(rp.accel, ro, rd, alive), 10, 2)
    log(f"7a aovs 1920x1080: 1 closest-hit launch {la['trace']}; vs plain on "
        f"{sub.numel()} rays: hit masks agree {hit_agree:.6f}, winners agree "
        f"{prim_agree:.6f}, albedo/emission equal {attr_equal}, normal max "
        f"abs err {normal_err:.3e}, t max rel err {t_rel:.3e}; hit fraction "
        f"{float(g['hit'].float().mean()):.4f}; aovs() {aov_ms:.3f} ms, its "
        f"trace alone {aov_trace_ms:.3f} ms")
    if not (hit_agree >= 0.9999 and prim_agree >= 0.9999 and attr_equal
            and normal_err <= 1e-6 and t_rel <= 1e-5):
        raise AssertionError("aovs() vs the plain closest hit")
    del ro, rd, alive, hk, hp, gk, gp, flat, flat_p

    # 7b. The a-trous kernel on the accumulator after 4 frames.
    accum = rp.state.accum
    guides = dict(albedo=g["albedo"], normal=g["normal"])
    max_ulp, max_abs = 0, 0.0
    for tag, kw in (("unguided", {}), ("guided", guides)):
        for levels in (3, 5):
            got, la = counted(lambda: atrous_denoise(accum, levels, 0.1, **kw))
            want = atrous_denoise_plain(accum, levels, 0.1, **kw)
            torch.cuda.synchronize()
            ulp = ulp_distance(got, want)
            err = float((got - want).abs().max())
            max_ulp, max_abs = max(max_ulp, ulp), max(max_abs, err)
            log(f"7b atrous [{tag}, {levels} levels] 1080x1920x3: max "
                f"{ulp} ulp, max abs err {err:.3e}, launches {la['atrous']}, "
                f"finite {bool(torch.isfinite(got).all())}")
            if not (ulp <= ATROUS_ULP and la["atrous"] == levels
                    and sum(la.values()) == levels
                    and torch.isfinite(got).all()):
                raise AssertionError(f"a-trous kernel vs plain ({tag}, "
                                     f"{levels}): {ulp} ulp, {la}")
    del got, want
    ms_level = {tag: cuda_ms(lambda: atrous_denoise(accum, 3, 0.1, **kw), 10,
                             2) / 3
                for tag, kw in (("unguided", {}), ("guided", guides))}
    plain_level = cuda_ms(lambda: atrous_denoise_plain(accum, 3, 0.1,
                                                       **guides), 2, 1) / 3
    flop_tap = FLOP_TAP + 2 * FLOP_TAP_GUIDE + n_exp
    kernels["atrous"] = dict(
        route="cuda",
        source="unityraytracer_tpu_torch/csrc/denoise_kernel.cu",
        replaces="unityraytracer_tpu/utils/denoise.py:65",
        max_abs_err=max_abs, max_ulp=max_ulp, shape=[H_p, W_p, 3],
        plain_shape=[H_p, W_p, 3], ms=ms_level["guided"],
        ms_unguided=ms_level["unguided"], plain_ms=plain_level,
        expf_instructions=n_exp, flop_per_tap=flop_tap)
    # One guided level: the image read and written once, both guides read
    # once; 25 taps a pixel, expf counted by its instructions.
    kernels["atrous"]["bound_ms"], kernels["atrous"]["bound_by"] = bound(
        n_p * 12 * 4, n_p * 25 * flop_tap)
    kernels["atrous"]["bound_ms_unguided"] = bound(
        n_p * 6 * 4, n_p * 25 * (FLOP_TAP + n_exp))[0]
    log("atrous:", json.dumps(kernels["atrous"]))

    # 7c. The live preview with its HTTP view.
    tmp = tempfile.mkdtemp(prefix="urt_preview_")
    try:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        rw = Renderer(scene_np, cam_main, cfg_m, accel=r.accel, seed=19,
                      device="cuda")
        ticks = []
        png = os.path.join(tmp, "preview.png")
        _, la = counted(lambda: rw.watch(
            png, every=4, frames=12, denoise=True, guided=True,
            http_port=port,
            on_update=lambda rr: ticks.append(dict(rr.stats["tick"]))))
        by_path["preview"] = la
        try:
            got = {}
            for url in ("/", "/preview.png"):
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{url}",
                                            timeout=30) as resp:
                    got[url] = (resp.status, len(resp.read()))
        finally:
            rw._preview_server.shutdown()
            rw._preview_server.server_close()
        med = {k: float(np.median([t[k] for t in ticks])) for k in ticks[0]}
        log(f"7c watch 12 frames, every 4, guided denoise: {len(ticks)} "
            f"ticks, median step {med['step_ms']:.2f} ms, denoise "
            f"{med['denoise_ms']:.2f} ms, PNG {med['png_ms']:.2f} ms; "
            f"GET {got}; launches {la}")
        if not (rw.sample_count == 12 and len(ticks) == 3
                and all(v[0] == 200 and v[1] > 0 for v in got.values())
                and la["atrous"] == 9 and la["trace"] == 3
                and la["path"] == 12):
            raise AssertionError(f"watch: samples {rw.sample_count}, ticks "
                                 f"{len(ticks)}, GET {got}, launches {la}")
        del rw

        # 7d. The AOV export at 1080p, read back part by part.
        exr = os.path.join(tmp, "aovs.exr")
        t0 = time.perf_counter()
        _, la = counted(lambda: rp.save_aovs(exr))
        save_s = time.perf_counter() - t0
        half = lambda a: a.astype(np.float16).astype(np.float32)  # noqa: E731
        gh = {k: v.cpu().numpy() for k, v in g.items()}
        want = {"beauty": rp.image, "albedo": gh["albedo"],
                "normal": gh["normal"], "depth": gh["depth"][..., None],
                "emission": gh["emission"]}
        t0 = time.perf_counter()
        ok = {name: bool(np.array_equal(load_exr(exr, part=name), half(a)))
              for name, a in want.items()}
        load_s = time.perf_counter() - t0
        log(f"7d save_aovs 1920x1080, 5 parts: {save_s:.3f} s, "
            f"{os.path.getsize(exr)} bytes; read back {load_s:.3f} s, parts "
            f"equal to the half-rounded buffers {ok}; launches {la}")
        if not all(ok.values()) or la["trace"] != 1:
            raise AssertionError(f"save_aovs round trip: {ok}, {la}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 7e. The per-stage device profile of three frames.
    prof, la = counted(lambda: rp.profile(3))
    log("7e profile(3):\n" + prof.report())
    log(f"7e launches {la}")
    if not all(prof.stages_ms.get(k, 0.0) > 0.0
               for k in ("path", "env", "rng")) or la["path"] != 4:
        raise AssertionError(f"profile: stages {prof.stages_ms}, {la}")
    del rp, accum, g, guides

    for k in kernels:
        use = {"env_planes": "bf16", "trace": "preview",
               "atrous": "preview"}.get(k, "main")
        kernels[k]["launches"] = by_path[use][k]
        kernels[k]["launches_by_path"] = {p_: v[k] for p_, v in
                                          by_path.items()}
    for k in ("env_planes", "trace", "atrous"):
        if kernels[k]["launches"] < 1:
            raise AssertionError(f"kernel {k!r} never launched on its path")

    _build.raise_on_overflow(dev)
    log(card)
    keys = ("route", "source", "replaces", "launches",
            "launches_megakernel_false", "launches_by_path", "max_abs_err",
            "max_ulp", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "shape", "plain_shape")
    for v in kernels.values():
        v["library_ms"] = None     # no single PyTorch call computes these
    log(json.dumps({"kernels": [
        {"name": k, **{f: v[f] for f in keys if f in v}}
        for k, v in kernels.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
