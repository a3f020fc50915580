#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the kernel build from ``unityraytracer_tpu_torch/csrc`` (nvcc, sm_90a),
   and the native host library's (g++, ``native.build``);
3. each CUDA kernel against its plain PyTorch version on the same inputs:
   the sky-tap kernel (draws, texel pick, fetch, decode and compose in one
   launch) bit-identical in both fetch modes, on the main path's own
   1920x1080 x 8 path-kernel output and on 2,073,600 random directions
   with the pick's edge cases, with the draws at the ray index, at a
   ray_index row and at the block slots of a pixel-order lattice; the
   threefry kernels bit-identical to their plain versions (``urt_uniform``
   on 2,073,600 and 10,368,000 counters; ``urt_bounce_rows``, which derives
   its keys from k_bounce on the card, at the main path's 1920x1080 x 8
   with ``rr_group="step"``, at the quality preset's chunk of spp 5 x 10
   bounces and at a band with ``row0 > 0``); the camera-ray kernel
   (``urt_camera_rays``: the frame key's draws, the lattice and the
   thin-lens camera in one launch) within CAMERA_ULP of its plain version
   at 1920x1080 in block order, at the band of rows 216-431, at the
   quality chunk (spp 5) and at 192x96 in pixel order (the oracle's
   layout); these three kernels timed alone from graph replays of their
   raw launch, each beside its wrapper call's host time; the closest hit on 192x96 camera rays plus one scattered bounce of
   bench_scene(100_000) (winners agree on >= 99.99% of rays, t to 1e-5
   relative); the path kernel at 192x96 x 4 bounces (all nine output rows
   bit-identical, radiance RMSE < 1e-3);
   the closest-hit and path kernels also at the main path's 1920x1080 x 8
   shape, held against their plain versions on a strided subset of rays,
   and their traversal counts (box and triangle tests per ray) there;
4. the main path: ``Renderer(bench_scene(100_000), RenderConfig(1920, 1080,
   spp=1, bounces=8, tracer="pallas", wavefront=True, rr_group="step"),
   device="cuda")`` with bench.py's camera — a warm-up step, then timed
   steps whose launch counts must show the path, sky-tap, camera-ray and
   uniform-row kernels ran (one launch of each a frame and no
   ``urt_uniform``), with a finite image, and the Python threefry hashes of
   one step (at most 7); then one frame through the bounce-loop entry
   point (megakernel=False), counted apart, which must launch the
   closest-hit kernel and ``urt_uniform``; the main path's layers timed
   alone (camera rays, uniform rows,
   path kernel, sky tap with its compose, accumulation), and its device
   busy share and device launches per frame over a profiled window of
   three frames, printed beside the count before the camera-ray kernel;
5. the oracle gate: the main path at 192x96 x 4 bounces against
   tracer="brute" at the same seed, RMSE < 1e-3;
6. the other configurations of the megakernel frame, each driven through
   ``Renderer(..., device="cuda")`` with the launch counts set to 0 just
   before it and read just after:
   a. the quality preset: ``fixtures.sample_scene()`` at 1920x1080, spp 25,
      10 bounces, ``spp_chunk=5`` (5 path, sky-tap, camera-ray and
      uniform-row launches a frame, no ``urt_uniform``),
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

8. the command line (``unityraytracer_tpu_torch/__main__.py``) at the main
   path's width, every renderer it builds checked to hold all its tensors on
   the card and every run's launch counts asserted:
   a. ``info --scene bench`` prints the card's name;
   b. ``render --scene bench --width 1920 --height 1080 --frames 32 --aovs
      ... --denoise`` in this process: 32 path, 32 sky-tap, 32 camera-ray,
      0 ``urt_uniform``, 32 ``urt_bounce_rows``, 2 closest-hit (the denoise's
      guides, the export) and 3 a-trous launches; the accumulator bit-equal
      to a hand-built ``Renderer(...).step(32)``, the PNG's bytes and the
      EXR's parts equal to that renderer's; seconds by stage;
   c. the same render as a child process (``python3 -m
      unityraytracer_tpu_torch``) with its wall time from start to exit, its
      exit code checked, and a second child that times start-up alone;
   d. ``render --obj --env``: the bench scene's 100,000+ triangles written
      with ``save_obj`` and a two-material MTL, a 2048x1024 ``.hdr`` written
      with ``save_hdr``; parse and read times; the triangle count; the
      loaded scene at 192x96 x 4 bounces within RMSE 1e-3 of the brute
      tracer;
   e. ``render --env`` on 1024x512 ``.exr`` skies written with PIZ (loaded
      equal to written) and DWAA (within 0.02 x max of the half-rounded
      map), the sky tap launched on each;
   f. ``render --unity`` on ``UNITY_SCENE`` (2 spheres, 14 triangles, the
      settings line);
   g. ``preview --frames 12 --every 4 --port p`` with both URLs fetched;
   h. an unknown ``--rng`` and an unknown tracer raise, and ``preview --shard
      rows`` returns 2.

9. the rest of the port's surface at the main path's width
   (``accel_shard_native_phase``), each path counted on its own:
   a. ``Renderer(tracer="bvh")`` and ``"cluster"`` at 1920x1080 x 8: 8
      closest-hit launches a frame, no path kernel, the traversal
      strategies and the plain closest hit patched to raise; the two
      accumulators bit-equal; the oracle gate at 192x96 x 4 for each; the
      kernel against both strategies run on the card on 36,864 rays (the
      192x96 pixel centres and their mirror bounce): prims equal apart from
      near ties (t within 1e-5 relative), which are counted;
   b. ``ShardedRenderer`` on four logical shards of the card (``[cuda:0] *
      4``): ``"scene"`` with ``"cluster"`` and ``"pallas"`` against a
      ``Renderer(megakernel=False)`` of the same seed (RMSE < 1e-3), 4 x 8
      closest-hit launches a frame, each shard's triangles, accel bytes and
      box and triangle tests a ray, the combine's CUDA-event time;
      ``"rows"`` with the path kernel, each band bit-equal to
      ``render_frame(row0=k*h, rows=h)`` at ``fold_in(fold_in(key, 0),
      k)``; ``"spp"``, and ``"rows_scene"`` on a 2x2 mesh (finite image,
      sample counts); ms a frame of each;
   c. ``render --shard scene``, ``--shard rows`` and ``--tracer bvh`` at
      1080p x 8, 4 frames, in this process with their launch counts, and
      ``--shard scene`` as a child process with its wall time;
   d. the native host library (its build seconds are printed in phase 2):
      the LBVH build with and without it at 100k and 1M triangles
      (identical accels, both times) and the PIZ decode of a 1024x512
      float sky with and without it (equal, both times), then ``render
      --env`` on that sky.

10. the ray sort (``ray_bin_bounces``, default (1, 2), and ``bin_rays``;
   ``ray_sort_phase``), sorted against unsorted (``(None, None)``):
   a. the path kernel's nine rows and counts at 192x96 x 4 and 1080p x 8
      and its 16 state rows after two bounces, all bit-equal; its times in
      10 pairs in turns;
   b. the closest-hit kernel on the 1080p bounce-1 rays (from
      ``path_trace(..., nb=1, emit_state=True)``): 14 rows, winner and
      counts bit-equal, its trace order equal to ``bin_destinations``', 10
      pairs of times, the bin-sort-scatter prologue alone (the kernel
      without its traversal);
   c. the warps of those rays in ray order and in sorted order: the SIMT
      efficiency of their box and triangle tests (the sum over warps of the
      lanes' mean over the sum of their max) and the share of warps with no
      live ray;
   d. the split frame, a ``megakernel=False`` frame and a
      ``ShardedRenderer(mode="scene")`` frame on ``[cuda:0] * 4``, each
      bit-equal with the window on and off, with the same launches;
   e. the main path, sorted and unsorted ``Renderer.step(1)`` in turns
      (medians of 12 with their spreads), the same launches and device
      events a frame, the accumulators bit-equal.

11. ``rng_impl="rbg"``, the configuration ``bench.py`` runs (``rbg_phase``;
   Philox4x32-10 bits, which equal the JAX package's on XLA:CPU):
   a. each draw kernel's rbg mode against its plain version (the int64
      Philox of ``rng.py``), bit for bit: ``urt_uniform`` on 2,073,600 and
      10,368,000 counters under a key whose counter carries out of word 0;
      ``urt_bounce_rows`` at 1920x1080 x 8 with ``rr_group="step"``, at the
      quality chunk and at a band with ``row0 > 0``; ``urt_camera_rays``
      (within CAMERA_ULP) at 1080p in block order and at 192x96 in pixel
      order; ``urt_sky_tap`` at the ray index, a ray_index row and a
      pixel-order lattice in both fetches; each timed from graph replays in
      turns with its threefry launch of the same shape (``ms_threefry``),
      its bound priced by a Philox block's SASS (``sass_counts``);
   b. the main path, ``Renderer(bench_scene(100_000), RenderConfig(1920,
      1080, spp=1, bounces=8, tracer="pallas", wavefront=True,
      rr_group="step", rng_impl="rbg"), device="cuda")``: 12 ``step(1)``
      frames in turns with 12 threefry frames, one launch a frame of the
      path kernel and of the sky-tap, camera-ray and uniform-row kernels'
      rbg modes and nothing else, at most 14 Python threefry hashes a step
      (both halves of each key), the layers timed alone;
   c. the oracle gate under rbg at 192x96 x 4, RMSE < 1e-3;
   d. one frame each under rbg: the quality preset (timed in turns with
      threefry, peak memory), ``megakernel=False`` (``urt_uniform``'s rbg
      mode), ``ENV_IMPL="bf16"`` (bit-equal), the split (within 1e-5) and
      ``dispatch_bands=5`` (bit-equal to its bands).
   The kernels line lists the rbg modes as ``uniform_rbg``,
   ``camera_rays_rbg``, ``bounce_rows_rbg`` and ``env_rbg``, with their
   launches on the rbg main path (``uniform_rbg``: the rbg
   ``megakernel=False`` frame).

12. scenes of 100k to 2M triangles (``scale_phase``), the sizes the JAX
   package serves with its sharded tiers (``SCALING_r05.json``), through
   the same kernels:
   a. the ladder (``LADDER``): ``bench_scene(n)`` for 100k, 200k, 400k, 1M
      and 2M triangles under phase 11b's rbg main path at 1920x1080 x 8:
      per rung the host seconds of the scene build and of
      ``build_cluster_accel`` (native), of ``KernelScene.create``, the
      scene's bytes against the L2, the LBVH's depth, 12 ``step(1)``
      frames (median, min, max, Mrays/s) each launching one path, sky-tap,
      camera-ray and uniform-row kernel and nothing else, the path kernel
      alone by CUDA events with its box and triangle tests a ray
      (``counts=``) and its bound, the camera rays' tests and hit fraction
      through the closest-hit kernel, peak device memory, no traversal
      overflow and a finite image; at 2M a ``megakernel=False`` frame in
      turns with the path-kernel frame, and on ``SLICE`` rays from the
      middle of that rung's own frame the closest-hit kernel against
      ``closest_hit_plain`` and the path kernel against
      ``path_trace_plain``, bit for bit;
   b. gate1m (``examples/gate_scale_tiers.py:94-101``): 1M triangles,
      192x96, 4 bounces, ``dispatch_bands=4``, rbg, seed 7: the
      ``"pallas"`` image against ``"brute"`` (RMSE < 1e-3) and
      ``"cluster"``, with the gate's report;
   c. gate2m_b1 (``:102-107``): 2M triangles, 1 bounce, 4 bands: the
      ``"pallas"`` image bit-exact with ``"brute"``, and the camera rays'
      hit records of the closest-hit kernel bit-equal to ``trace_brute``'s;
   d. gate2m_part: 2M triangles, 4 bounces, ``ShardedRenderer(mode=
      "scene")`` on ``[cuda:0] * 2`` and ``[cuda:0] * 4``, two partitions
      of one Morton order: bit-identical images, the 4-shard image within
      RMSE 1e-3 of one device's path-kernel frame, the frames in turns and
      the combine's CUDA-event time.
   The kernels line carries the ladder under the path kernel's
   ``ladder``, and in each kernel's ``launches_by_path`` a ``"scale"``
   path (the 12 frames of the 2M rung, which launch the main path's four
   kernels and no closest-hit kernel) and one path for each gate run
   (``scale_part4``: the closest-hit kernel in gate2m_part's four-shard
   frame).

Phase 3 also holds the path kernel's 16 resume-state rows against the plain
version's (bit for bit, at 192x96 x 4 and on the 1080p x 8 subset with two
bounces). Phases 3 to 9 run the default config, so the path kernel sorts
at bounces 1 and 2 there.

The line before the last is a JSON object with each kernel's launches in
the run of the path that uses it (the main path for the path, sky-tap
("env"), camera-ray and uniform-row kernels; the megakernel=False frame
for ``urt_uniform``, which the main path no longer launches; the preview
for the closest-hit kernel, whose count from the megakernel=False frame
stands under ``launches_megakernel_false``; the bf16 frame for the sky
tap's byte-plane fetch, "env_planes"), the counts of every path under
``launches_by_path``,
its error against the plain version (the a-trous kernel also in ulp),
both times (``shape`` and
``plain_shape`` say at what size; for the threefry and camera-ray kernels
also ``host_ms``, one wrapper call's host time, and ``call_ms``, the events
around wrapper calls back to back), ``bound_ms``, the least time the card
could take for the kernel's work at ``shape`` (the larger of its bytes over
3.35 TB/s and its operations over the peak rate of their type,
``bound_by`` naming which), and ``library_ms``, null: no single PyTorch
call computes any of these functions (none computes an edge-stopping
bilateral a-trous pass). A threefry draw and an expf are priced by their
SASS instructions: a kernel of one draw (or one expf) against a kernel of
one copy, built with the kernels' flags and read with cuobjdump (phase 2);
a draw's integer-ALU instructions at the ALU's rate, or all of them at the
SM's issue rate, whichever is slower. The closest-hit and a-trous kernels' ``launches``
are those of the preview run (7c). The path and closest-hit rows also carry
phase 10's ``sort_window``, ``ms_binned``, ``ms_unbinned`` and
``binned_bit_equal`` (the closest-hit kernel's on the bounce-1 rays, with
``binned_shape``, ``sort_prologue_ms`` and ``order_equal``). The last line is ``{"ok": true,
"device": {...}}``. Without a CUDA device it exits non-zero and prints no
result.
"""

import ctypes
import json
import os
import re
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
# Triangle counts at which phase 9 times the LBVH build with and without
# the native host library.
NATIVE_TRIS = (N_TRIS, 1_000_000)
# Phase 12's ladder of bench_scene sizes (SCALING_r05.json's rungs: 101k,
# 201k, 401k, 1.0M and 2.0M triangles after the icosphere rounding).
LADDER = (N_TRIS, 200_000, 400_000, 1_000_000, 2_000_000)
# Rays from the middle of the last rung's frame held against the plain
# versions (trace_brute over every triangle: about 7 s a bounce at 2M).
SLICE = 16_384
# The scale gates' frame (examples/gate_scale_tiers.py:52-62): 192x96, the
# bench camera, bench.py's streams, seed 7.
GATE = dict(width=192, height=96, spp=1, ray_chunk=4096, wavefront=True,
            rr_group="step", rng_impl="rbg")
GATE_CAM = dict(position=(0.0, 14.0, -42.0), look_at=(0.0, 2.0, 0.0),
                fov_y_deg=60.0)
GATE_SEED = 7
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
# Device launches a frame of the main path before the camera-ray kernel
# (PERF.md section 5: 361 device events in a profiled window of three
# frames).
LAUNCHES_BEFORE = 120.3
# The camera-ray kernel's rows against its plain version's, in ulp (0: bit
# for bit; the divisions are IEEE on both sides, and the sqrt, cos and sin
# are the CUDA math library's, as in torch's CUDA kernels).
CAMERA_ULP = 0

# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): memory, and
# float32 outside the tensor cores as separate instructions: 132 SMs x 128
# lanes x 1.98 GHz. The data sheet's 67 TFLOP/s counts an FMA as two
# operations; every kernel here is built with -fmad=false and spells each
# product and sum as its own instruction, so each operation counted below
# is one instruction, and 33.45e12 of them a second is the most the card
# issues. The int32 rate is the integer ALU's 64 lanes an SM a clock: 132
# SMs x 64 lanes x 1.98 GHz; an SM issues 128 instructions of any kind a
# clock, twice that.
PEAK_BYTES = 3.35e12
PEAK_F32 = 132 * 128 * 1.98e9
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
# One Philox4x32-10 block, the four words of four rbg draws, for
# sass_counts: the block of counter (i, 0, k1, 0) under (k0, k1), its words
# XORed so that none is dropped.
PHILOX_BLOCK = ("[&] { const uint4 b = urt_philox4x32_10(k0, k1, "
                "make_uint4(i, 0u, k1, 0u)); "
                "return __uint_as_float(b.x ^ b.y ^ b.z ^ b.w); }()")


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


def kernel_ms(launch, calls=20, replays=5):
    """Mean device milliseconds of one call of ``launch``, a raw kernel
    launch with its arguments already built, from the replays of a CUDA
    graph of ``calls`` launches: nothing of the host's work lies between
    the kernels the events span. One call runs first, outside the capture
    (it asks the grid's occupancy once)."""
    import torch

    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def host_ms(fn, calls=20):
    """Mean host milliseconds of one call of ``fn`` as a caller issues it
    (no synchronize between the calls, one after them, outside the clock)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


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
    ``k0``, ``k1`` by value, csrc/philox.cuh and threefry.cuh included),
    all built at once
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
                    f.write('#include "philox.cuh"\n'
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


def _unity_object(fid, name, pos, scale, color, shape) -> str:
    """One GameObject of Unity's text serialization with a RayTraceObject
    component, and a SphereCollider (``shape`` a radius) or a MeshFilter on
    a built-in mesh (``shape`` its fileID)."""
    geometry = (f"--- !u!135 &{fid + 3}\nSphereCollider:\n"
                f"  m_GameObject: {{fileID: {fid}}}\n  m_Enabled: 1\n"
                f"  m_Radius: {shape}\n  m_Center: {{x: 0, y: 0, z: 0}}\n"
                if isinstance(shape, float) else
                f"--- !u!33 &{fid + 3}\nMeshFilter:\n"
                f"  m_GameObject: {{fileID: {fid}}}\n"
                f"  m_Mesh: {{fileID: {shape}, guid: "
                "0000000000000000e000000000000000, type: 0}\n")
    return (f"--- !u!1 &{fid}\nGameObject:\n  m_Name: {name}\n"
            "  m_IsActive: 1\n"
            f"--- !u!4 &{fid + 1}\nTransform:\n"
            f"  m_GameObject: {{fileID: {fid}}}\n"
            "  m_LocalRotation: {x: 0, y: 0.38268343, z: 0, w: 0.92387953}\n"
            f"  m_LocalPosition: {{x: {pos[0]}, y: {pos[1]}, z: {pos[2]}}}\n"
            f"  m_LocalScale: {{x: {scale}, y: {scale}, z: {scale}}}\n"
            "  m_Father: {fileID: 0}\n"
            f"--- !u!114 &{fid + 2}\nMonoBehaviour:\n"
            f"  m_GameObject: {{fileID: {fid}}}\n  m_Enabled: 1\n"
            "  m_Script: {fileID: 11500000, guid: "
            "7fba285130b2c3342be00e9cfa2e3c7c,\n    type: 3}\n"
            f"  albedoColor: {{r: {color[0]}, g: {color[1]}, b: {color[2]}, "
            "a: 1}\n  smoothness: 0.5\n" + geometry)


# A small Unity scene: two spheres by SphereCollider, a built-in cube
# (fileID 10202, 12 triangles) and quad (10210, 2 triangles), and a camera
# that carries the RayTraceMaster settings.
UNITY_SCENE = (
    "%YAML 1.1\n%TAG !u! tag:unity3d.com,2011:\n"
    + _unity_object(100, "Ball", (-1.5, 1, 0), 2, (0.9, 0.2, 0.2), 0.5)
    + _unity_object(110, "Pearl", (0.5, 0.6, -1.5), 1.2, (0.9, 0.9, 0.8), 0.5)
    + _unity_object(120, "Box", (1.5, 0.75, 0.5), 1.5, (0.2, 0.4, 0.8), 10202)
    + _unity_object(130, "Card", (0, 1.5, 3), 3, (0.3, 0.8, 0.3), 10210)
    + "--- !u!1 &160\nGameObject:\n  m_Name: Main Camera\n  m_IsActive: 1\n"
    "--- !u!4 &161\nTransform:\n  m_GameObject: {fileID: 160}\n"
    "  m_LocalRotation: {x: 0.08715578, y: 0, z: 0, w: 0.9961947}\n"
    "  m_LocalPosition: {x: 0, y: 2.5, z: -7}\n"
    "  m_LocalScale: {x: 1, y: 1, z: 1}\n  m_Father: {fileID: 0}\n"
    "--- !u!20 &162\nCamera:\n  m_GameObject: {fileID: 160}\n"
    "  field of view: 50\n"
    "--- !u!114 &163\nMonoBehaviour:\n  m_GameObject: {fileID: 160}\n"
    "  m_Enabled: 1\n  m_Script: {fileID: 11500000, guid: "
    "b2e91413b60a86f49ac7969f1637f0cd, type: 3}\n"
    "  numBounces: 5\n  numRays: 2\n")


def tensors_of(obj) -> list:
    """Every tensor reachable from ``obj`` through dataclass fields, dicts,
    lists and tuples."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        kids = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        kids = list(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        kids = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    else:
        return []
    return [t for k in kids for t in tensors_of(k)]


def cli_run(counted, argv):
    """``main(argv)`` of the command line in this process -> (exit code,
    its stdout and stderr, the renderer it built, seconds by stage, launch
    counts). Raises if that renderer holds a tensor off the card."""
    import contextlib
    import io

    import unityraytracer_tpu_torch.__main__ as cli
    from unityraytracer_tpu_torch import Renderer
    from unityraytracer_tpu_torch.models import skybox

    built, secs = [], {}
    make, build_scene, load_env = (cli._make_renderer, cli._build_scene,
                                   skybox.load_environment)

    def timed(name, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            secs[name] = time.perf_counter() - t0
            return out
        return wrapper

    def make_and_keep(args):
        built.append(make(args))
        return built[-1]

    cli._make_renderer = timed("renderer", make_and_keep)
    cli._build_scene = timed("scene", build_scene)
    skybox.load_environment = timed("env_load", load_env)
    out, err = io.StringIO(), io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc, la = counted(lambda: cli.main(argv))
        secs["main"] = time.perf_counter() - t0
    finally:
        cli._make_renderer, cli._build_scene = make, build_scene
        skybox.load_environment = load_env
    r = built[0] if built else None
    if r is not None:
        held = tensors_of(vars(r))
        off = [tuple(t.shape) for t in held if not t.is_cuda]
        found = {id(t) for t in held}
        if off or isinstance(r, Renderer) and (
                r.device.type != "cuda" or not {
                    id(r.state.accum), id(r.scene.skybox_rgbe),
                    *map(id, r.accel.tables.values())} <= found):
            raise AssertionError(f"{argv[:3]}: the renderer holds tensors "
                                 f"off the card ({off}), or the walk "
                                 "missed its accumulator, sky or tables")
    return rc, out.getvalue(), err.getvalue(), r, secs, la


def command_line_phase(counted, bits_equal) -> dict:
    """Phase 8: the command line at full width, on the card. Returns the
    launch counts of its paths by name. Raises on any failure; a renderer
    the command line built must hold every tensor on the card."""
    import numpy as np
    import torch

    from unityraytracer_tpu_torch import RenderConfig, Renderer
    from unityraytracer_tpu_torch.models import fixtures, skybox
    from unityraytracer_tpu_torch.models.exr import load_exr, write_exr
    from unityraytracer_tpu_torch.models.obj import save_obj
    from unityraytracer_tpu_torch.utils.image import (rmse, tonemap_aces,
                                                      write_png)

    card_name = torch.cuda.get_device_name(0)
    by_path = {}
    W, H, FRAMES, BOUNCES = MAIN["width"], MAIN["height"], 32, MAIN["bounces"]
    full = ["--width", str(W), "--height", str(H), "--bounces", str(BOUNCES)]
    bench = ["--scene", "bench", "--tris", str(N_TRIS)]

    def run(argv):
        return cli_run(counted, argv)

    def expect(la, frames, trace=0, atrous=0):
        want = dict({k: 0 for k in la}, path=frames, env=frames,
                    bounce_rows=frames, camera=frames, trace=trace,
                    atrous=atrous)
        if la != want:
            raise AssertionError(f"launches {la}, expected {want}")

    tmp = tempfile.mkdtemp(prefix="urt_cli_")
    try:
        # 8a. info: the torch device, not a backend.
        rc, out, _, _, _, _ = run(["info", *bench])
        log("8a info:", out.strip().replace("\n", " | "))
        lines = out.splitlines()
        if not (rc == 0 and lines[0].startswith("device: cuda  count: ")
                and card_name in lines[0] and "backend" not in out
                and f"{fixtures.bench_scene(N_TRIS).num_triangles} triangles"
                in lines[1]):
            raise AssertionError(f"info printed {out!r}")

        # 8b. render at 1080p x 8 bounces x 32 frames with AOVs and the
        # guided denoise, in this process: launches, files, and the image
        # against a renderer built by hand.
        png, exr = os.path.join(tmp, "bench.png"), os.path.join(tmp, "aovs.exr")
        argv = ["render", *bench, *full, "--frames", str(FRAMES),
                "--aovs", exr, "--denoise", "-o", png]
        rc, out, _, r, secs, la = run(argv)
        by_path["cli_render"] = la
        # One trace for the denoise's guides and one for the export.
        expect(la, FRAMES, trace=2, atrous=3)
        cfg = RenderConfig(width=W, height=H, spp=1, bounces=BOUNCES,
                           tracer="pallas", wavefront=True)
        t0 = time.perf_counter()
        hand = Renderer(fixtures.bench_scene(N_TRIS),
                        fixtures.bench_camera(W / H), cfg, seed=0,
                        device="cuda")
        hand_setup = time.perf_counter() - t0
        hand.step(FRAMES)
        same = bits_equal(r.state.accum, hand.state.accum)
        want_png = write_png(os.path.join(tmp, "hand.png"),
                             tonemap_aces(hand.denoised_image(guided=True)))
        png_same = open(png, "rb").read() == open(want_png, "rb").read()
        half = lambda a: a.astype(np.float16).astype(np.float32)  # noqa: E731
        g = {k: v.cpu().numpy() for k, v in hand.aovs().items()}
        parts = {"beauty": hand.image, "albedo": g["albedo"],
                 "normal": g["normal"], "depth": g["depth"][..., None],
                 "emission": g["emission"]}
        exr_same = {k: bool(np.array_equal(load_exr(exr, part=k), half(a)))
                    for k, a in parts.items()}
        lines = out.strip().splitlines()
        writes = secs["main"] - secs["renderer"] - r.stats["seconds"]
        log(f"8b render bench 1920x1080x8, 32 frames, --aovs --denoise: "
            f"{lines}; accumulator bit-equal to a hand-built "
            f"Renderer.step(32) {same}; PNG bytes equal {png_same} "
            f"({os.path.getsize(png)} bytes); EXR parts equal {exr_same}; "
            f"launches {la}")
        log(f"8b in-process seconds: main {secs['main']:.3f} = scene "
            f"{secs['scene']:.3f} + accel build and upload "
            f"{secs['renderer'] - secs['scene']:.3f} + frames "
            f"{r.stats['seconds']:.3f} + denoise, PNG and EXR writes "
            f"{writes:.3f} (hand-built Renderer setup {hand_setup:.3f})")
        if not (rc == 0 and same and png_same and all(exr_same.values())
                and lines[0].startswith(f"wrote {png}: {FRAMES} samples, ")
                and lines[0].endswith(" Mrays/s") and lines[1] ==
                f"wrote {exr} (beauty/albedo/normal/depth/emission)"):
            raise AssertionError("8b: the command line's render differs from "
                                 "the hand-built renderer's")
        inproc = dict(secs, frames=r.stats["seconds"], writes=writes)
        del r, hand, g, parts

        # 8c. The same render as a child process: what a user of the
        # command line waits for, from process start to exit; and the
        # start-up alone (interpreter, imports, CUDA context, library load).
        env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        child_png = os.path.join(tmp, "child.png")
        child_argv = [sys.executable, "-m", "unityraytracer_tpu_torch",
                      *argv[:-1], child_png]
        child_argv[child_argv.index(exr)] = os.path.join(tmp, "child.exr")
        t0 = time.perf_counter()
        child = subprocess.run(child_argv, cwd=HERE, env=env, timeout=600,
                               capture_output=True, text=True)
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            raise AssertionError(f"child render exited {child.returncode}: "
                                 f"{child.stderr[-2000:]}")
        child_same = open(child_png, "rb").read() == open(png, "rb").read()
        probe = ("import time, json; t0 = time.perf_counter(); import torch; "
                 "t1 = time.perf_counter(); "
                 "import unityraytracer_tpu_torch.__main__; "
                 "from unityraytracer_tpu_torch import _build; "
                 "t2 = time.perf_counter(); "
                 "torch.zeros(1, device='cuda'); torch.cuda.synchronize(); "
                 "t3 = time.perf_counter(); _build.lib(); "
                 "t4 = time.perf_counter(); "
                 "print(json.dumps(dict(import_torch=t1 - t0, "
                 "import_package=t2 - t1, cuda_context=t3 - t2, "
                 "library_load=t4 - t3)))")
        t0 = time.perf_counter()
        start = subprocess.run([sys.executable, "-c", probe], cwd=HERE,
                               env=env, timeout=600, capture_output=True,
                               text=True)
        probe_s = time.perf_counter() - t0
        if start.returncode != 0:
            raise AssertionError(f"start-up probe exited {start.returncode}: "
                                 f"{start.stderr[-2000:]}")
        startup = json.loads(start.stdout.strip().splitlines()[-1])
        log(f"8c child `python3 -m unityraytracer_tpu_torch render` (same "
            f"arguments): exit 0, wall {child_s:.3f} s from start to exit, "
            f"{child.stdout.strip().splitlines()}; PNG equal to the "
            f"in-process one {child_same}")
        log(f"8c start-up alone (a second child): wall {probe_s:.3f} s, of it "
            + ", ".join(f"{k} {v:.3f}" for k, v in startup.items()))
        log("8c cli wall split: " + json.dumps(dict(
            wall_s=child_s, startup_s=probe_s, scene_s=inproc["scene"],
            accel_s=inproc["renderer"] - inproc["scene"],
            frames_s=inproc["frames"], writes_s=inproc["writes"])))
        if not child_same:
            raise AssertionError("the child's PNG differs from the "
                                 "in-process render's")

        # 8d. render --obj --env: a mesh of >= 100,000 triangles with two
        # MTL materials, under a 2048x1024 .hdr sky, both written here.
        tr = fixtures.bench_scene(N_TRIS).triangles
        n_tri = tr.v0.shape[0]
        verts = np.stack([tr.v0, tr.v1, tr.v2], axis=1).reshape(-1, 3)
        norms = np.stack([tr.n0, tr.n1, tr.n2], axis=1).reshape(-1, 3)
        obj = os.path.join(tmp, "field.obj")
        t0 = time.perf_counter()
        save_obj(obj, verts, np.arange(3 * n_tri).reshape(-1, 3), norms)
        obj_write_s = time.perf_counter() - t0
        with open(obj) as f:
            text = f.read().splitlines()
        faces = [ln for ln in text if ln.startswith("f ")]
        rest = [ln for ln in text if not ln.startswith("f ")]
        with open(obj, "w") as f:
            f.write("\n".join(["mtllib field.mtl"] + rest + ["usemtl warm"]
                              + faces[:n_tri // 2] + ["usemtl steel"]
                              + faces[n_tri // 2:]) + "\n")
        with open(os.path.join(tmp, "field.mtl"), "w") as f:
            f.write("newmtl warm\nKd 0.8 0.3 0.2\nKs 0.1 0.1 0.1\nNs 100\n"
                    "newmtl steel\nKd 0.3 0.3 0.35\nKs 0.6 0.6 0.6\nNs 600\n")
        from unityraytracer_tpu_torch.models.obj import load_obj_with_materials
        t0 = time.perf_counter()
        parsed = load_obj_with_materials(obj)
        obj_parse_s = time.perf_counter() - t0
        sky = skybox.sun_sky(1024, 2048)
        hdr = skybox.save_hdr(os.path.join(tmp, "sky.hdr"), sky)
        rc, out, _, r, secs, la = run(
            ["render", "--obj", obj, "--env", hdr, *full, "--frames",
             str(FRAMES), "-o", os.path.join(tmp, "obj.png")])
        by_path["cli_obj"] = la
        expect(la, FRAMES)
        hdr_same = bool(np.array_equal(r.scene.skybox.cpu().numpy(),
                                       skybox.load_hdr(hdr)))
        log(f"8d render --obj ({n_tri} triangles written, "
            f"{os.path.getsize(obj)} bytes, 2 MTL materials) --env "
            f"2048x1024 .hdr ({os.path.getsize(hdr)} bytes): scene has "
            f"{r.scene.num_triangles} triangles, {len(parsed[4])} materials "
            f"parsed; OBJ write {obj_write_s:.3f} s, OBJ parse "
            f"{obj_parse_s:.3f} s (the command parses it twice), HDR read "
            f"{secs['env_load']:.3f} s, scene {secs['scene']:.3f} s, accel "
            f"build and upload {secs['renderer'] - secs['scene']:.3f} s, "
            f"frames {r.stats['seconds']:.3f} s "
            f"({r.stats['ms_per_frame']:.2f} ms/frame); sky equals the "
            f"file's {hdr_same}; {out.strip()}; launches {la}")
        if not (rc == 0 and n_tri >= 100_000 and hdr_same
                and r.scene.num_triangles == n_tri
                and tuple(r.scene.skybox.shape) == (1024, 2048, 3)
                and np.isfinite(r.image).all() and r.image.max() > 0):
            raise AssertionError("8d: render --obj --env")
        # The loaded scene at 192x96 x 4 bounces against the brute tracer.
        rc, _, _, rs, _, la = run(
            ["render", "--obj", obj, "--env", hdr, "--width", "192",
             "--height", "96", "--bounces", "4", "--frames", "1", "-o",
             os.path.join(tmp, "obj_small.png")])
        expect(la, 1)
        rb = Renderer(rs.scene, rs.camera,
                      rs.config.replace(tracer="brute", ray_chunk=1024),
                      seed=0, device="cuda").step(1)
        obj_rmse = rmse(rs.image, rb.image)
        log(f"8d loaded scene at 192x96x4: command line vs the brute "
            f"tracer RMSE {obj_rmse:.3e}")
        if not (rc == 0 and obj_rmse < 1e-3):
            raise AssertionError(f"8d oracle gate: RMSE {obj_rmse}")
        del r, rs, rb, parsed, verts, norms, text, faces, rest

        # 8e. render --env on .exr skies written here with PIZ (lossless)
        # and DWAA (lossy: the bound of the codec's own tests).
        sky = skybox.sun_sky(512, 1024)
        ref16 = half(sky)
        for comp, dtype in (("piz", "float"), ("dwaa", "half")):
            path = os.path.join(tmp, f"sky_{comp}.exr")
            t0 = time.perf_counter()
            write_exr(path, sky, dtype=dtype, compression=comp)
            enc_s = time.perf_counter() - t0
            rc, out, _, r, secs, la = run(
                ["render", *bench, "--env", path, *full,
                 "--frames", "4", "-o", os.path.join(tmp, f"{comp}.png")])
            by_path[f"cli_env_{comp}"] = la
            expect(la, 4)
            got = r.scene.skybox.cpu().numpy()
            err = float(np.abs(got - (sky if comp == "piz" else ref16)).max())
            lim = 0.0 if comp == "piz" else \
                0.02 * max(1.0, float(ref16.max()))
            log(f"8e render --env {comp} .exr 1024x512 {dtype} "
                f"({os.path.getsize(path)} bytes): encode {enc_s:.3f} s, "
                f"decode {secs['env_load']:.3f} s, max |loaded - written| "
                f"{err:.3e} (limit {lim:.3e}); {out.strip()}; launches {la}")
            if not (rc == 0 and got.shape == sky.shape and err <= lim
                    and np.isfinite(r.image).all()):
                raise AssertionError(f"8e: {comp} environment")
        del r

        # 8f. render --unity: two spheres by SphereCollider, a built-in
        # cube and quad, a RayTraceMaster camera.
        unity = os.path.join(tmp, "scene.unity")
        with open(unity, "w") as f:
            f.write(UNITY_SCENE)
        rc, out, err, r, _, la = run(
            ["render", "--unity", unity, *full, "--frames", "4", "-o",
             os.path.join(tmp, "unity.png")])
        by_path["cli_unity"] = la
        expect(la, 4)
        log(f"8f render --unity: {r.scene.num_spheres} spheres, "
            f"{r.scene.num_triangles} triangles; {err.strip()}; "
            f"{out.strip()}; launches {la}")
        if not (rc == 0 and r.scene.num_spheres == 2
                and r.scene.num_triangles == 14 and err.strip() ==
                "unity scene settings: {'numBounces': 5, 'numRays': 2, "
                "'skybox_guid': None}" and np.isfinite(r.image).all()
                and r.image.max() > 0):
            raise AssertionError("8f: render --unity")
        del r

        # 8g. preview: 12 frames in ticks of 4 with the HTTP view.
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        pv = os.path.join(tmp, "preview.png")
        rc, out, _, r, secs, la = run(
            ["preview", *bench, *full, "--frames", "12",
             "--every", "4", "--port", str(port), "-o", pv])
        by_path["cli_preview"] = la
        try:
            got = {}
            for url in ("/", "/preview.png"):
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{url}",
                                            timeout=30) as resp:
                    got[url] = (resp.status, len(resp.read()))
        finally:
            r._preview_server.shutdown()
            r._preview_server.server_close()
        expect(la, 12, atrous=9)
        log(f"8g preview 12 frames every 4: {out.strip()}; GET {got}; last "
            f"tick {r.stats['tick']}; main {secs['main']:.3f} s; "
            f"launches {la}")
        if not (rc == 0 and out.strip() == f"wrote {pv} (12 samples)"
                and got["/preview.png"] == (200, os.path.getsize(pv))
                and got["/"][0] == 200):
            raise AssertionError("8g: preview")
        del r

        # 8h. What the port refuses raises, and renders nothing.
        base = ["render", *bench, "-o",
                os.path.join(tmp, "never.png")]
        raised = {}
        for flags, exc, word in ((["--rng", "philox4x32"], ValueError,
                                  "unknown rng_impl"),
                                 (["--tracer", "embree"], ValueError,
                                  "unknown tracer")):
            try:
                run(base + flags)
            except exc as e:
                raised[" ".join(flags)] = f"{type(e).__name__}: {e}"
                if word not in str(e):
                    raise AssertionError(f"{flags}: {e}")
            else:
                raise AssertionError(f"{flags} did not raise")
        rc, _, err, _, _, _ = run(["preview", "--shard", "rows"])
        log(f"8h raises: {raised}; preview --shard rows -> {rc}, "
            f"{err.strip()!r}")
        if rc != 2 or os.path.exists(base[-1]) or err.strip() != \
                "--shard applies to `render` (preview is single-chip)":
            raise AssertionError("8h: preview --shard")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return by_path


def accel_shard_native_phase(counted, bits_equal, scene_np, accel_np, ks,
                             cfg_s, oracle, oracle_key) -> dict:
    """Phase 9: the "bvh" and "cluster" tracers, ``ShardedRenderer`` over
    four logical shards of the card, their command-line flags and the native
    host library, at the main path's width. Returns the launch counts of its
    paths by name. Raises on any failure."""
    import numpy as np
    import torch

    from unityraytracer_tpu_torch import RenderConfig, Renderer, native, rng
    from unityraytracer_tpu_torch.models import fixtures, skybox
    from unityraytracer_tpu_torch.models.exr import load_exr, write_exr
    from unityraytracer_tpu_torch.ops import cuda_trace, traverse
    from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
    from unityraytracer_tpu_torch.ops.cuda_trace import trace_hits
    from unityraytracer_tpu_torch.ops.shade import MISS_T
    from unityraytracer_tpu_torch.parallel import scene_shard
    from unityraytracer_tpu_torch.parallel.sharding import (
        ShardedRenderer, create_sharded_state, gather_image, make_mesh,
        make_mesh2, make_sharded_step)
    from unityraytracer_tpu_torch.render import (pixel_center_rays,
                                                 render_frame)
    from unityraytracer_tpu_torch.utils.image import rmse

    dev = ks.device
    scene = ks.scene
    B, W, H, F = MAIN["bounces"], MAIN["width"], MAIN["height"], 4
    cam_main = fixtures.bench_camera(aspect=W / H)
    cam_small = fixtures.bench_camera(aspect=2.0)
    by_path = {}

    def frames(r):
        """F timed ``step(1)`` frames of ``r``, counted; -> (ms, launches)."""
        ms = []

        def run():
            for _ in range(F):
                r.step(1)
                ms.append(r.stats["ms_per_frame"])
        _, la = counted(run)
        return ms, la

    def med(ms):
        return float(np.median(ms))

    # 9a. The two accel tracers at 1080p x 8: the closest-hit kernel once a
    # bounce, and never a traversal strategy or a plain version.
    def refuse(name):
        def fn(*a, **kw):
            raise AssertionError(f"{name} ran on the card's render path")
        return fn

    patched = {(traverse, "_triangle_bvh_candidate"),
               (traverse, "_triangle_cluster_candidate"),
               (cuda_trace, "closest_hit_plain")}
    saved = {(m, n): getattr(m, n) for m, n in patched}
    accums = {}
    try:
        for m, n in patched:
            setattr(m, n, refuse(n))
        for t in ("bvh", "cluster"):
            r = Renderer(scene_np, cam_main, RenderConfig(**dict(MAIN,
                                                                 tracer=t)),
                         accel=accel_np, seed=0, device=dev).step(1)
            ms, la = frames(r)
            by_path[t] = la
            img = r.image
            log(f"9a tracer={t!r} {W}x{H}x{B}: {med(ms):.2f} ms/frame median "
                f"of {F} (min {min(ms):.2f}, max {max(ms):.2f}); launches "
                f"{la}")
            if not (la["trace"] == B * F and la["path"] == 0
                    and la["camera"] == F and np.isfinite(img).all()
                    and img.max() > 0):
                raise AssertionError(f"9a {t}: expected {B} closest-hit "
                                     f"launches a frame and no path kernel, "
                                     f"got {la}")
            accums[t] = r.state.accum
            del r
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
    same = bits_equal(accums["bvh"], accums["cluster"])
    log(f"9a bvh and cluster accumulators bit-equal: {same}")
    if not same:
        raise AssertionError("9a: the bvh and cluster frames differ")
    del accums
    for t in ("bvh", "cluster"):
        fast = render_frame(scene, cfg_s.replace(tracer=t), cam_small,
                            oracle_key, ks).cpu().numpy()
        e = rmse(fast, oracle)
        log(f"9a oracle gate tracer={t!r}: RMSE {e:.3e} against brute "
            "(192x96x4, same key)")
        if not (np.isfinite(fast).all() and e < 1e-3):
            raise AssertionError(f"9a oracle gate {t}: RMSE {e}")
    # Kernel 2 against the two strategies run on the card: 192x96 pixel
    # centres and their mirror bounce off each hit.
    ro, rd = pixel_center_rays(cam_small, 96, 192, dev)
    h = trace_hits(ks, ro, rd)
    ok = h.t < MISS_T
    dn = sum(rd[k] * h.normal[k] for k in range(3))
    ro = tuple(torch.cat([ro[k], torch.where(
        ok, h.position[k] + h.normal[k] * 1e-3, ro[k])]) for k in range(3))
    rd = tuple(torch.cat([rd[k], torch.where(
        ok, rd[k] - 2 * dn * h.normal[k], rd[k])]) for k in range(3))
    hk = trace_hits(ks, ro, rd)
    n_r = hk.t.shape[0]
    for t in ("bvh", "cluster"):
        cfg_t = RenderConfig(tracer=t, cluster_size=64, ray_chunk=1 << 16)
        t0 = time.perf_counter()
        hs = traverse.accel_tracer_plain(scene, ks, cfg_t)(ro, rd)
        hs.t.cpu()
        strat_s = time.perf_counter() - t0
        flips = hk.prim != hs.prim
        tie = (hk.t - hs.t).abs() <= 1e-5 * hs.t.abs()
        agree = ~flips & (hs.t < MISS_T)
        rel = float(((hk.t - hs.t).abs() / hs.t.abs())[agree].max())
        n_flip, n_far = int(flips.sum()), int((flips & ~tie).sum())
        log(f"9a kernel 2 vs {t} strategy on the card ({n_r} rays: 192x96 "
            f"pixel centres and their mirror bounce): prim equal on "
            f"{n_r - n_flip}, near-tie flips {n_flip - n_far}, other flips "
            f"{n_far}; t max rel err {rel:.3e} where prims agree; strategy "
            f"{strat_s:.2f} s")
        if rel > 1e-5 or n_far or n_flip > 1e-3 * n_r:
            raise AssertionError(f"9a kernel 2 vs {t}: {n_flip} flips, "
                                 f"{n_far} beyond a near tie, rel {rel}")
    del ro, rd, h, hk, hs

    # 9b. ShardedRenderer over four logical shards of the card.
    mesh4 = make_mesh([dev] * 4)
    log(f"9b make_mesh(): {len(make_mesh())} device(s); the phase runs on "
        f"{len(mesh4)} logical shards of {dev}")
    rp, dp = pixel_center_rays(cam_main, H, W, dev)
    for t in ("cluster", "pallas"):
        cfg = RenderConfig(**dict(MAIN, tracer=t))
        t0 = time.perf_counter()
        sr = ShardedRenderer(scene_np, cam_main, cfg, mesh=mesh4, seed=5,
                             mode="scene")
        setup_s = time.perf_counter() - t0
        sr.step(1)
        ms, la = frames(sr)
        by_path[f"scene_{t}"] = la
        ref = Renderer(scene_np, cam_main, cfg.replace(megakernel=False),
                       accel=accel_np, seed=5, device=dev)
        for _ in range(F + 1):
            ref.step(1)
        e = rmse(sr.image, ref.image)
        worst = float(np.abs(sr.image - ref.image).max())
        per = []
        for k, s in enumerate(sr.accel):
            cnt = torch.empty((2, rp[0].shape[0]), dtype=torch.int32,
                              device=dev)
            trace_hits(s, rp, dp, counts=cnt)
            tests = cnt.sum(dim=1, dtype=torch.int64).cpu().tolist()
            per.append(dict(shard=k, triangles=s.accel.triangles.count,
                            accel_bytes=scene_bytes(s),
                            box_per_ray=tests[0] / rp[0].shape[0],
                            tri_per_ray=tests[1] / rp[0].shape[0]))
        hits = [trace_hits(s, rp, dp) for s in sr.accel]
        comb_ms = cuda_ms(lambda: scene_shard.allreduce_hit(hits), 10, 2)
        log(f"9b scene mode, tracer={t!r}, 4 shards, {W}x{H}x{B}: "
            f"{med(ms):.2f} ms/frame median of {F} (min {min(ms):.2f}, max "
            f"{max(ms):.2f}); setup {setup_s:.2f} s; launches {la}; vs "
            f"Renderer(megakernel=False) of the same seed: RMSE {e:.3e}, "
            f"max abs err {worst:.3e}; combine of 4 x {W * H} hits "
            f"{comb_ms:.3f} ms (CUDA events)")
        log(f"9b shards (tracer={t!r}; box and triangle tests a ray on the "
            f"{W}x{H} pixel centres): {json.dumps(per)}")
        if not (la["trace"] == 4 * B * F and la["path"] == 0 and e < 1e-3
                and np.isfinite(sr.image).all()):
            raise AssertionError(f"9b scene {t}: launches {la}, RMSE {e}")
        del sr, ref, hits
    del rp, dp

    # rows: band k of a frame is render_frame(row0=k*h, rows=h) at
    # fold_in(fold_in(key, 0), k), through the path kernel.
    cfg = RenderConfig(**MAIN)
    sr = ShardedRenderer(scene_np, cam_main, cfg, mesh=mesh4, accel=accel_np,
                         seed=0, mode="rows")
    key = rng.key(7)
    step = make_sharded_step(cfg, mesh4, "rows")
    state, la = counted(lambda: step(create_sharded_state(cfg, mesh4, "rows"),
                                     sr.scenes, cam_main, sr.accel, key, 1))
    img = gather_image(state)
    hb = H // 4
    fkey = rng.fold_in(key, 0)
    bands_equal = [bits_equal(img[k * hb:(k + 1) * hb], render_frame(
        sr.scenes[k], cfg, cam_main, rng.fold_in(fkey, k), sr.accel[k],
        row0=k * hb, rows=hb).cpu()) for k in range(4)]
    sr.step(1)
    ms, la_rows = frames(sr)
    by_path["rows"] = la_rows
    log(f"9b rows mode, 4 bands of {hb} rows: one step's launches {la}; "
        f"bands bit-equal to render_frame {bands_equal}; "
        f"{med(ms):.2f} ms/frame median of {F}; launches {la_rows}")
    if not (all(bands_equal) and la["path"] == 4 and la_rows["path"] == 4 * F
            and np.isfinite(sr.image).all()):
        raise AssertionError(f"9b rows: bands {bands_equal}, {la}")
    del sr, state, img

    sr = ShardedRenderer(scene_np, cam_main, cfg, mesh=mesh4, accel=accel_np,
                         seed=0, mode="spp").step(1)
    ms, la = frames(sr)
    by_path["spp"] = la
    img = sr.image
    log(f"9b spp mode, 4 shards: {med(ms):.2f} ms/frame median of {F}; "
        f"samples {sr.sample_count}; launches {la}")
    if not (sr.sample_count == F + 1 and la["path"] == 4 * F
            and np.isfinite(img).all() and img.max() > 0):
        raise AssertionError(f"9b spp: {sr.sample_count} samples, {la}")
    del sr

    mesh2 = make_mesh2(2, 2, [dev] * 4)
    sr = ShardedRenderer(scene_np, cam_main, cfg.replace(tracer="cluster"),
                         mesh=mesh2, seed=0, mode="rows_scene").step(1)
    ms, la = frames(sr)
    by_path["rows_scene"] = la
    img = sr.image
    log(f"9b rows_scene mode, 2 x 2 mesh: {med(ms):.2f} ms/frame median of "
        f"{F}; samples {sr.sample_count}; launches {la}")
    if not (sr.sample_count == F + 1 and la["trace"] == 2 * 2 * B * F
            and np.isfinite(img).all() and img.max() > 0
            and img.shape == (H, W, 3)):
        raise AssertionError(f"9b rows_scene: {sr.sample_count}, {la}")
    del sr, img

    # 9c. The command line: --shard scene, --shard rows, --tracer bvh.
    tmp = tempfile.mkdtemp(prefix="urt_p9_")
    try:
        base = ["render", "--scene", "bench", "--tris", str(N_TRIS),
                "--width", str(W), "--height", str(H), "--bounces", str(B),
                "--frames", str(F), "--device", dev.type]
        for flags, want in ((["--shard", "scene"], dict(trace=B * F)),
                            (["--shard", "rows"], dict(path=F)),
                            (["--tracer", "bvh"], dict(trace=B * F))):
            png = os.path.join(tmp, "_".join(flags).strip("-") + ".png")
            rc, out, _, r, secs, la = cli_run(counted, base + flags
                                              + ["-o", png])
            name = "cli_" + flags[1]
            by_path[name] = la
            log(f"9c render {' '.join(flags)} {W}x{H}x{B}, {F} frames: rc "
                f"{rc}, {out.strip()}; {type(r).__name__}; main "
                f"{secs['main']:.3f} s; launches {la}")
            if not (rc == 0 and os.path.getsize(png) > 1000
                    and all(la[k] == v for k, v in want.items())):
                raise AssertionError(f"9c {flags}: rc {rc}, {la}")
            del r
        child_png = os.path.join(tmp, "child.png")
        env = dict(os.environ, PYTHONPATH=HERE)
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-m",
                                "unityraytracer_tpu_torch", *base, "--shard",
                                "scene", "-o", child_png], cwd=HERE, env=env,
                               timeout=600, capture_output=True, text=True)
        child_s = time.perf_counter() - t0
        log(f"9c child `python3 -m unityraytracer_tpu_torch render --shard "
            f"scene`: exit {child.returncode}, wall {child_s:.3f} s from "
            f"start to exit, {child.stdout.strip()}")
        if child.returncode != 0 or not os.path.exists(child_png):
            raise AssertionError(f"9c child exited {child.returncode}: "
                                 f"{child.stderr[-2000:]}")

        # 9d. The native host library: the LBVH build with and without it
        # at 100k and 1M triangles, and the PIZ decode of a 1024x512 sky.
        if not native.available():
            raise AssertionError(f"native library: {native.BUILD_LOG}")
        fields = ("cluster_vmin", "cluster_vmax", "node_vmin", "node_vmax",
                  "node_left", "node_right")
        for n in NATIVE_TRIS:
            tris = (scene_np if n == N_TRIS
                    else fixtures.bench_scene(n_tris=n)).triangles
            secs = {}
            built = {}
            for use in (False, True, False, True):
                t0 = time.perf_counter()
                built[use] = build_cluster_accel(tris, 64, use_native=use)
                secs.setdefault(use, []).append(time.perf_counter() - t0)
            equal = all(np.array_equal(getattr(built[True], f),
                                       getattr(built[False], f))
                        for f in fields)
            log(f"9d LBVH build at {built[True].triangles.count} triangles "
                f"({built[True].num_clusters} clusters): numpy "
                f"{min(secs[False]):.4f} s, native {min(secs[True]):.4f} s "
                f"(best of 2 each); accels identical {equal}")
            if not equal:
                raise AssertionError(f"9d: native and numpy accels differ "
                                     f"at {n} triangles")
            del tris, built
        sky_path = os.path.join(tmp, "sky_piz.exr")
        write_exr(sky_path, skybox.sun_sky(512, 1024), dtype="float",
                  compression="piz")
        t0 = time.perf_counter()
        fast = load_exr(sky_path)
        fast_s = time.perf_counter() - t0
        huf = native.huf_decode
        native.huf_decode = lambda *a: None
        try:
            t0 = time.perf_counter()
            slow = load_exr(sky_path)
            slow_s = time.perf_counter() - t0
        finally:
            native.huf_decode = huf
        rc, _, _, r, secs, la = cli_run(counted, base + [
            "--env", sky_path, "-o", os.path.join(tmp, "piz.png")])
        by_path["cli_env_piz_native"] = la
        log(f"9d PIZ 1024x512 float sky: read {fast_s:.3f} s native, "
            f"{slow_s:.3f} s Python, equal {np.array_equal(fast, slow)}; "
            f"`render --env` on it: rc {rc}, main {secs['main']:.3f} s, of "
            f"it the sky read {secs['env_load']:.3f} s")
        if not (np.array_equal(fast, slow) and rc == 0
                and la["env"] == F):
            raise AssertionError("9d: the native PIZ decode differs, or "
                                 "render --env failed")
        del r
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return by_path


def device_window(r, frames=3, names=None):
    """(wall ms, device-busy ms, device events) of ``r.step(frames)`` under
    torch.profiler: the union of the device intervals against the host's
    clock (the profiler's own per-launch cost slows the host a little, so
    the busy share errs low). ``names``: a dict that gets the count of the
    device events by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # A window can miss the device events of its first frame when the
        # frame starts as the profiler does; a pause first, outside the
        # clock, narrows that.
        time.sleep(0.05)
        t0 = time.perf_counter()
        r.step(frames)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if names is not None:
        for e in events:
            names[e.name] = names.get(e.name, 0) + 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, reach = 0.0, float("-inf")
    for s, e in spans:
        if e > reach:
            busy_us += e - max(s, reach)
            reach = e
    return wall_ms, busy_us / 1e3, len(spans)


def ray_sort_phase(counted, scene_np, accel_np, ks, cfg_s, kernels) -> dict:
    """Phase 10: the ray sort of ``ray_bin_bounces`` (the path kernel) and
    ``bin_rays`` (the closest-hit kernel) at the main path's shape: sorted
    against unsorted bit for bit in every output and every path that sorts,
    the closest-hit kernel's trace order against ``bin_destinations``, the
    times of both in turns, the sort prologue alone, and what the sort does
    to the warps of the bounce-1 rays. Adds
    its numbers to the ``path`` and ``trace`` rows of ``kernels``; returns
    the launch counts of its paths. Raises on any failure."""
    import numpy as np
    import torch

    from unityraytracer_tpu_torch import RenderConfig, Renderer, _build, rng
    from unityraytracer_tpu_torch.models import fixtures
    from unityraytracer_tpu_torch.ops.cuda_path import path_trace
    from unityraytracer_tpu_torch.ops.cuda_trace import (
        SORT_WINDOW, bin_destinations, launch_trace, ray_bin_ids, trace_hits)
    from unityraytracer_tpu_torch.parallel.sharding import (ShardedRenderer,
                                                            make_mesh)
    from unityraytracer_tpu_torch.render import _frame_inputs, render_frame

    t_phase = time.perf_counter()
    dev = ks.device
    scene = ks.scene
    W, H = MAIN["width"], MAIN["height"]
    cam_main = fixtures.bench_camera(aspect=W / H)
    cam_small = fixtures.bench_camera(aspect=2.0)
    cfg_m = RenderConfig(**MAIN)
    if cfg_m.ray_bin_bounces != (1, 2):
        raise AssertionError(f"the main path's window is "
                             f"{cfg_m.ray_bin_bounces}, not the JAX (1, 2)")

    def off(cfg):
        return cfg.replace(ray_bin_bounces=(None, None))

    def equal(a, b):
        a = torch.stack(a) if isinstance(a, tuple) else a
        b = torch.stack(b) if isinstance(b, tuple) else b
        if a.is_floating_point():
            a, b = (x.contiguous().view(torch.int32) for x in (a, b))
        return a.shape == b.shape and torch.equal(a, b)

    def all_equal(xs, ys):
        return all(equal(a, b) for a, b in zip(xs, ys))

    checks, by_path = {}, {}

    def check(tag, ok):
        checks[tag] = bool(ok)
        log(f"10 sorted vs unsorted, {tag}: bit-equal {bool(ok)}")

    # 10a. The path kernel: nine rows and counts at 192x96 x 4 and 1080p x
    # 8; the 16 state rows after two bounces.
    def path_pair(cfg, cam, key, nb=None, state=False):
        ro, rd, uni, _, _ = _frame_inputs(scene, cam, key, cfg)
        uni = uni if nb is None else uni[:nb]
        outs = []
        for c in (cfg, off(cfg)):
            cnt = torch.zeros((2, ro[0].shape[0]), dtype=torch.int32,
                              device=dev)
            outs.append(path_trace(ks, ro, rd, uni, c, nb=nb,
                                   emit_state=state, counts=cnt) + (cnt,))
        _build.raise_on_overflow(dev)
        return all_equal(*outs), ro, rd, uni

    check("path kernel 192x96 x 4, 9 rows + counts",
          path_pair(cfg_s, cam_small, rng.key(7))[0])
    ok, rom, rdm, unim = path_pair(cfg_m, cam_main, rng.key(8))
    check("path kernel 1080p x 8, 9 rows + counts", ok)
    check("path kernel 1080p, nb=2, 16 state rows + 9 rows + counts",
          path_pair(cfg_m, cam_main, rng.key(8), nb=2, state=True)[0])
    pairs = {"sorted": [], "unsorted": []}
    for _ in range(10):
        pairs["sorted"].append(cuda_ms(
            lambda: path_trace(ks, rom, rdm, unim, cfg_m), 3, 0))
        pairs["unsorted"].append(cuda_ms(
            lambda: path_trace(ks, rom, rdm, unim, off(cfg_m)), 3, 0))
    path_ms = {k: float(np.median(v)) for k, v in pairs.items()}
    log(f"10a path kernel 1080p x 8, 10 pairs in turns (window "
        f"{SORT_WINDOW}): sorted median "
        f"{path_ms['sorted']:.4f} ms (min {min(pairs['sorted']):.4f}, max "
        f"{max(pairs['sorted']):.4f}), unsorted median "
        f"{path_ms['unsorted']:.4f} (min {min(pairs['unsorted']):.4f}, max "
        f"{max(pairs['unsorted']):.4f})")

    # 10b. The closest-hit kernel on the 1080p bounce-1 rays: rows, prim
    # and counts, and its trace order against bin_destinations on the card.
    *_, st = path_trace(ks, rom, rdm, unim[:1], cfg_m, nb=1, emit_state=True)
    o1, d1, a1 = tuple(st[0:3]), tuple(st[3:6]), st[9] > 0
    del rom, rdm, unim, st
    n1 = o1[0].shape[0]
    order = torch.full((n1,), -1, dtype=torch.int32, device=dev)
    cnt_s = torch.zeros((2, n1), dtype=torch.int32, device=dev)
    cnt_u = torch.zeros((2, n1), dtype=torch.int32, device=dev)
    hs = trace_hits(ks, o1, d1, a1, counts=cnt_s, bin_rays=True, order=order)
    hu = trace_hits(ks, o1, d1, a1, counts=cnt_u)
    _build.raise_on_overflow(dev)

    def rows(h):
        return [h.t, *h.normal, *h.albedo, *h.specular, *h.emission,
                h.smoothness, h.prim]

    check(f"closest-hit kernel, {n1} bounce-1 rays, 14 rows + prim + counts",
          all_equal(rows(hs) + [cnt_s], rows(hu) + [cnt_u]))
    want = bin_destinations(ray_bin_ids(o1, d1, a1, ks.bin_center))
    check("closest-hit kernel's trace order vs bin_destinations",
          torch.equal(order, want))
    del hs, hu
    tpairs = {"sorted": [], "unsorted": []}
    for _ in range(10):
        tpairs["sorted"].append(cuda_ms(
            lambda: trace_hits(ks, o1, d1, a1, bin_rays=True), 3, 0))
        tpairs["unsorted"].append(cuda_ms(
            lambda: trace_hits(ks, o1, d1, a1), 3, 0))
    trace_ms = {k: float(np.median(v)) for k, v in tpairs.items()}
    prologue_ms = float(np.median([cuda_ms(
        lambda: launch_trace(ks, o1, d1, a1, mode=2), 3, 0)
        for _ in range(5)]))
    log(f"10b closest-hit kernel, bounce-1 rays (alive "
        f"{float(a1.float().mean()):.4f}), 10 pairs in turns: sorted median "
        f"{trace_ms['sorted']:.4f} ms (min {min(tpairs['sorted']):.4f}, max "
        f"{max(tpairs['sorted']):.4f}), unsorted {trace_ms['unsorted']:.4f} "
        f"(min {min(tpairs['unsorted']):.4f}, max "
        f"{max(tpairs['unsorted']):.4f}); the bin, sort and scatter prologue "
        f"alone (no traversal) {prologue_ms:.4f} ms")

    # 10c. What the sort does to the warps of the bounce-1 rays: SIMT
    # efficiency of the box tests (sum over warps of the lanes' mean over
    # sum over warps of their max; a warp is 32 consecutive slots) and the
    # share of warps with no live ray, in ray order and in sorted order.
    if n1 % 32:
        raise AssertionError(f"{n1} rays do not fill whole warps")
    ar = torch.arange(n1, device=dev)
    slot = ar - ar % SORT_WINDOW + want.long()

    def warps(v, permute):
        v = v.float()
        if permute:
            v = torch.empty_like(v).scatter_(0, slot, v)
        return v.reshape(-1, 32)

    simt = {}
    for tag, permute in (("ray order", False), ("sorted order", True)):
        box, tri = warps(cnt_u[0], permute), warps(cnt_u[1], permute)
        live = warps(a1, permute) > 0
        simt[tag] = dict(
            box_simt=float(box.mean(1).sum() / box.amax(1).sum()),
            tri_simt=float(tri.mean(1).sum() / tri.amax(1).sum()),
            dead_warp_share=float((~live.any(1)).float().mean()),
            part_dead_warp_share=float((live.any(1) & ~live.all(1))
                                       .float().mean()))
        log(f"10c warps of the bounce-1 rays, {tag}: " + json.dumps(
            simt[tag]))
    del o1, d1, a1, cnt_s, cnt_u, order, want, slot, ar

    # 10d. Frames: the split frame, a megakernel=False frame and a
    # scene-sharded frame on four logical shards, each with the window on
    # and off.
    key = rng.key(21)
    split = cfg_m.replace(**SPLIT)
    check("split frame (split_bounce=2), 1080p x 8",
          equal(render_frame(scene, split, cam_main, key, ks),
                render_frame(scene, off(split), cam_main, key, ks)))
    def in_turns(renderers, frames=4):
        """ms/frame of ``frames`` step(1) each, the renderers in turns."""
        ms = [[] for _ in renderers]
        for _ in range(frames):
            for k, r in enumerate(renderers):
                r.step(1)
                ms[k].append(r.stats["ms_per_frame"])
        return [float(np.median(m)) for m in ms], ms

    loops = []
    for c in (cfg_m, off(cfg_m)):
        c = c.replace(megakernel=False)
        r, la = counted(lambda: Renderer(scene_np, cam_main, c,
                                         accel=accel_np, seed=0,
                                         device=dev).step(1))
        loops.append(r)
        by_path["loop_sorted" if c.ray_bin_bounces[0] is not None
                else "loop_unsorted"] = la
    check("megakernel=False frame, 1080p x 8",
          equal(*(r.state.accum for r in loops)))
    shards = []
    for c in (cfg_m, off(cfg_m)):
        sr, la = counted(lambda: ShardedRenderer(
            scene_np, cam_main, c, mesh=make_mesh([dev] * 4), seed=5,
            mode="scene").step(1))
        shards.append(sr)
        by_path["scene_sorted" if c.ray_bin_bounces[0] is not None
                else "scene_unsorted"] = la
    check("ShardedRenderer(mode='scene') frame on 4 logical shards",
          equal(*(torch.from_numpy(sr.image) for sr in shards)))
    for tag, rs_ in (("megakernel=False", loops), ("scene, 4 shards",
                                                   shards)):
        med, ms = in_turns(rs_)
        log(f"10d {tag} 1080p x 8, 4 step(1) each in turns: sorted median "
            f"{med[0]:.2f} ms/frame {[round(x, 2) for x in ms[0]]}, "
            f"unsorted {med[1]:.2f} {[round(x, 2) for x in ms[1]]}")
    del loops, shards, sr
    if by_path["loop_sorted"] != by_path["loop_unsorted"] or \
            by_path["scene_sorted"] != by_path["scene_unsorted"]:
        raise AssertionError(f"10d: the sort changed the launches: {by_path}")

    # 10e. The main path, sorted and unsorted Renderer.step(1) in turns,
    # with their launches and device events a frame.
    rs = Renderer(scene_np, cam_main, cfg_m, accel=accel_np, seed=0,
                  device=dev)
    ru = Renderer(scene_np, cam_main, off(cfg_m), accel=accel_np, seed=0,
                  device=dev)
    rs.step(1)
    ru.step(1)
    frame = {"sorted": [], "unsorted": []}
    launches = {}
    for _ in range(12):
        for tag, r in (("sorted", rs), ("unsorted", ru)):
            _, launches[tag] = counted(lambda: r.step(1))
            frame[tag].append(r.stats["ms_per_frame"])
    # Two profiled windows each, in turns; the fuller of the two counts (a
    # window can still miss its first frame's device events: it then shows
    # 2 of each kernel for 3 frames). The launch counts are what must be
    # equal; the device events are read and compared, not required equal.
    events, names = {}, {}
    for _ in range(2):
        for tag, r in (("sorted", rs), ("unsorted", ru)):
            by_name = {}
            w = device_window(r, names=by_name)
            if tag not in events or w[2] > events[tag][2]:
                events[tag], names[tag] = w, by_name

    def kinds(by_name):
        """Events by kernel, the two path kernels under one name."""
        out = {}
        for k, v in by_name.items():
            k = "urt_path" if "urt_path" in k else \
                re.sub(r"\(.*", "", k).replace("void ", "")[:48]
            out[k] = out.get(k, 0) + v
        return out

    check("main path accumulators after 19 frames",
          equal(rs.state.accum, ru.state.accum))
    for tag in frame:
        wall, busy, ev = events[tag]
        v = frame[tag]
        log(f"10e main path 1080p x 8, {tag}: {float(np.median(v)):.3f} "
            f"ms/frame median of 12 in turns (min {min(v):.3f}, max "
            f"{max(v):.3f}); launches a step {launches[tag]}; profiled 3 "
            f"frames: wall {wall:.3f} ms, busy {busy:.3f} ms, "
            f"{ev / 3:.1f} device events a frame, busy share "
            f"{busy / wall:.4f}; events by kernel "
            f"{json.dumps(kinds(names[tag]))}")
    log(f"10e device events by kernel equal, sorted and unsorted: "
        f"{kinds(names['sorted']) == kinds(names['unsorted'])}")
    if launches["sorted"] != launches["unsorted"]:
        raise AssertionError(f"10e: the sort changed the launches: "
                             f"{launches}")
    by_path["main_sorted"] = launches["sorted"]
    del rs, ru
    if not all(checks.values()):
        raise AssertionError(f"10: sorted and unsorted differ: {checks}")

    kernels["path"].update(
        sort_window=SORT_WINDOW,
        ms_binned=path_ms["sorted"], ms_unbinned=path_ms["unsorted"],
        binned_bit_equal=all(v for k, v in checks.items()
                             if not k.startswith("closest")))
    kernels["trace"].update(
        sort_window=SORT_WINDOW, binned_shape=[n1],
        ms_binned=trace_ms["sorted"], ms_unbinned=trace_ms["unsorted"],
        sort_prologue_ms=prologue_ms,
        binned_bit_equal=checks[f"closest-hit kernel, {n1} bounce-1 rays, "
                                "14 rows + prim + counts"],
        order_equal=checks["closest-hit kernel's trace order vs "
                           "bin_destinations"],
        simt_bounce1=simt)
    log(f"10 ray sort phase: {time.perf_counter() - t_phase:.1f} s")
    return by_path


def rbg_phase(counted, bits_equal, scene_np, ks, kernels, block_ops) -> dict:
    """Phase 11: ``rng_impl="rbg"``, bench.py's own configuration. Each draw
    kernel's rbg mode against its plain version bit for bit (the camera
    within CAMERA_ULP), timed from graph replays in turns with its threefry
    launch of the same shape; the main path under rbg in turns with the
    threefry main path, its launches, host hashes and layers; the oracle
    gate; a frame of each other configuration. Adds the ``*_rbg`` rows to
    ``kernels`` and returns the launch counts of its paths. Raises on any
    failure."""
    import numpy as np
    import torch

    from unityraytracer_tpu_torch import RenderConfig, Renderer, _build, rng
    from unityraytracer_tpu_torch.models import fixtures
    from unityraytracer_tpu_torch.ops import cuda_env
    from unityraytracer_tpu_torch.ops.cuda_env import sky_tap, sky_tap_plain
    from unityraytracer_tpu_torch.ops.cuda_path import path_trace
    from unityraytracer_tpu_torch.ops.shade import rgbe_scale
    from unityraytracer_tpu_torch.render import (RenderState, _camera_rays,
                                                 _env_tap, _frame_inputs,
                                                 _sky_keys, bounce_args,
                                                 bounce_rows,
                                                 bounce_rows_plain,
                                                 camera_args,
                                                 camera_rays_plain,
                                                 progressive_step,
                                                 render_frame)
    from unityraytracer_tpu_torch.utils.image import rmse, ulp_distance

    t_phase = time.perf_counter()
    dev, scene, lib = ks.device, ks.scene, _build.lib()
    cfg_r, cfg_t = RenderConfig(**MAIN, rng_impl="rbg"), RenderConfig(**MAIN)
    W, H = cfg_r.width, cfg_r.height
    n = W * H
    nb = cfg_r.bounces
    cam_main = fixtures.bench_camera(aspect=W / H)
    cam_small = fixtures.bench_camera(aspect=2.0)
    qsub = RenderConfig(**QUALITY, rng_impl="rbg").replace(
        spp=QUALITY["spp_chunk"], spp_chunk=None)
    # Word 0 of the 128-bit counter carries at block 100,001, into word 1
    # and on into word 2.
    carry = np.array([0x2545F491, 0x4F6CDD1D, 0xFFFFFFFF - 100_000,
                      0xFFFFFFFF], np.uint32)

    def in_turns(rbg_launch, tf_launch, rounds=3):
        """Medians of kernel_ms of the two launches, taken in turns."""
        ms = {"rbg": [], "threefry": []}
        for i in range(rounds):
            order = (("rbg", rbg_launch), ("threefry", tf_launch))
            for tag, fn in (order if i % 2 == 0 else order[::-1]):
                ms[tag].append(kernel_ms(fn))
        return float(np.median(ms["rbg"])), float(np.median(ms["threefry"]))

    def entry(name, source, replaces, err, ulp, ms, ms_tf, plain_ms, nbytes,
              blocks, shape):
        b, by = bound(nbytes, blocks * block_ops, PEAK_I32)
        kernels[name] = dict(
            route="cuda", source=f"unityraytracer_tpu_torch/csrc/{source}",
            replaces=f"unityraytracer_tpu/{replaces}", max_abs_err=err,
            max_ulp=ulp, ms=ms, ms_threefry=ms_tf, plain_ms=plain_ms,
            bound_ms=b, bound_by=by, shape=shape, plain_shape=shape,
            philox_blocks=blocks, block_ops=block_ops)
        log(f"11a {name}:", json.dumps(kernels[name]))

    # 11a. urt_uniform: the carry key, bit for bit.
    for size in (n, 5 * n):
        got = rng.uniform(carry, (size,), device=dev)
        want = rng.uniform_plain(carry, (size,), device=dev)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise AssertionError(f"11a urt_uniform rbg differs from its plain "
                                 f"version on {size} counters")
        log(f"11a uniform rbg: {size} counters, carry key, bit-identical")
    del got, want
    uout = torch.empty(n, dtype=torch.float32, device=dev)

    def uniform_launch(key_):
        words, rbg = rng.kernel_words(key_)

        def launch():
            _build.check(lib.urt_uniform(*words, rbg, uout.data_ptr(), n,
                                         _build.stream_ptr(dev)), "uniform")
        return launch

    ms, ms_tf = in_turns(uniform_launch(rng.key(51, "rbg")),
                         uniform_launch(rng.key(51)))
    plain_ms = cuda_ms(lambda: rng.uniform_plain(carry, (n,), device=dev), 3,
                       1)
    entry("uniform_rbg", "uniform_kernel.cu", "render.py:465", 0.0, 0, ms,
          ms_tf, plain_ms, n * 4, n // 4, [n])
    del uout

    # urt_bounce_rows: 1080p x 8 (rr_group="step"), the quality chunk and a
    # band with row0 > 0.
    row_cases = {"main 1920x1080 x 8, rr_group step": (cfg_r, H, 0),
                 "quality chunk spp 5 x 10 bounces": (qsub, H, 0),
                 "band rows 216-431 of dispatch_bands=5": (cfg_r, 216, 216)}
    for tag, (c, h, row0) in row_cases.items():
        kb = rng.split(rng.fold_in(rng.key(52, "rbg"), row0), 3)[2]
        got = bounce_rows(kb, c, h, row0, True, dev)
        want = bounce_rows_plain(kb, c, h, row0, True, dev)
        torch.cuda.synchronize()
        same = bits_equal(got, want)
        log(f"11a bounce_rows rbg [{tag}]: {tuple(got.shape)}, bit-identical "
            f"{same}")
        if not same:
            raise AssertionError(f"11a urt_bounce_rows rbg vs plain ({tag})")
    del got, want

    def rows_launch(c, key_):
        args = bounce_args(key_, c, c.height, 0, True)
        out = torch.empty((c.bounces, 5, args.n), dtype=torch.float32,
                          device=dev)

        def launch():
            _build.check(lib.urt_bounce_rows(ctypes.byref(args),
                                             out.data_ptr(),
                                             _build.stream_ptr(dev)),
                         "bounce_rows")
        return launch

    kb_r = rng.split(rng.key(53, "rbg"), 3)[2]
    kb_t = rng.split(rng.key(53), 3)[2]
    ms, ms_tf = in_turns(rows_launch(cfg_r, kb_r), rows_launch(cfg_t, kb_t))
    plain_ms = cuda_ms(lambda: bounce_rows_plain(kb_r, cfg_r, H, 0, True,
                                                 dev), 3, 1)
    # The rows written once; a block of each of u_r, u1 and u2 for four
    # rays, and one of the roulette key for four rays' shared group
    # counter on the bounces that draw it (log2, cos and sin left out).
    rr_lo, rr_hi = 2, nb - 1
    entry("bounce_rows_rbg", "uniform_kernel.cu", "render.py:495", 0.0, 0,
          ms, ms_tf, plain_ms, nb * 5 * n * 4,
          n // 4 * (3 * nb + rr_hi - rr_lo), [nb, 5, n])
    n_q, nb_q = qsub.num_rays, qsub.bounces
    q_ms, q_ms_tf = in_turns(rows_launch(qsub, kb_r),
                             rows_launch(qsub.replace(rng_impl="threefry2x32"),
                                         kb_t))
    qb, qby = bound(nb_q * 5 * n_q * 4,
                    n_q // 4 * (3 * nb_q + nb_q - 3) * block_ops, PEAK_I32)
    kernels["bounce_rows_rbg"]["quality_chunk"] = dict(
        shape=[nb_q, 5, n_q], ms=q_ms, ms_threefry=q_ms_tf, bound_ms=qb,
        bound_by=qby, share=qb / q_ms)
    log("11a bounce_rows rbg at the quality chunk:",
        json.dumps(kernels["bounce_rows_rbg"]["quality_chunk"]))

    # urt_camera_rays: 1080p in block order, the oracle's 192x96 in pixel
    # order.
    small_b = RenderConfig(**dict(MAIN, width=192, height=96, bounces=4,
                                  tracer="brute", rng_impl="rbg"))
    cam_err, cam_ulp = 0.0, 0
    for tag, (cam, c, h, blk) in {
            "main 1920x1080 block order": (cam_main, cfg_r, H, True),
            "oracle 192x96 pixel order": (cam_small, small_b, 96,
                                          False)}.items():
        key = rng.key(54, "rbg")
        ro_k, rd_k, _ = _camera_rays(cam, key, c, h, c.width, 1, 0, blk, dev)
        ro_p, rd_p = camera_rays_plain(cam, key, c, h, c.width, 1, 0, blk,
                                       dev)
        torch.cuda.synchronize()
        got, want = torch.stack(ro_k + rd_k), torch.stack(ro_p + rd_p)
        ulp = ulp_distance(got, want)
        err = float((got - want).abs().max())
        cam_err, cam_ulp = max(cam_err, err), max(cam_ulp, ulp)
        log(f"11a camera rays rbg [{tag}]: {tuple(got.shape)}, max {ulp} ulp, "
            f"finite {bool(torch.isfinite(got).all())}")
        if not (ulp <= CAMERA_ULP and torch.isfinite(got).all()):
            raise AssertionError(f"11a urt_camera_rays rbg vs plain ({tag}): "
                                 f"{ulp} ulp")
    del got, want, ro_k, rd_k, ro_p, rd_p
    cout = torch.empty((6, n), dtype=torch.float32, device=dev)

    def camera_launch(key_):
        args = camera_args(cam_main, key_, cfg_r, H, W, 1, 0, True)

        def launch():
            _build.check(lib.urt_camera_rays(ctypes.byref(args),
                                             cout.data_ptr(),
                                             _build.stream_ptr(dev)),
                         "camera")
        return launch

    ms, ms_tf = in_turns(camera_launch(rng.key(55, "rbg")),
                         camera_launch(rng.key(55)))
    ckey = rng.key(55, "rbg")
    plain_ms = cuda_ms(lambda: camera_rays_plain(cam_main, ckey, cfg_r, H, W,
                                                 1, 0, True, dev), 3, 1)
    # ro and rd written once; a block of each of the four keys for four
    # rays (the ~80 float operations a ray are left out).
    entry("camera_rays_rbg", "camera_kernel.cu", "render.py:460", cam_err,
          cam_ulp, ms, ms_tf, plain_ms, n * 24, n // 4 * 4, [6, n])
    del cout

    # urt_sky_tap: counter i, a ray_index row and a pixel-order lattice, in
    # both fetches, on random directions with the pick's edge cases.
    hw = tuple(scene_np.skybox.shape[:2])
    packed = scene.skybox_rgbe
    g = torch.Generator(device=dev).manual_seed(11)
    d = torch.randn((3, n), generator=g, device=dev)
    d = d / d.norm(dim=0, keepdim=True)
    d[:, :len(SKY_EDGES)] = torch.tensor(SKY_EDGES, device=dev).T
    rows = (tuple(torch.rand((3, n), generator=g, device=dev)),
            tuple(torch.rand((3, n), generator=g, device=dev) * 2), tuple(d))
    k_sky = _sky_keys(cfg_r, rng.split(rng.key(56, "rbg"), 3)[2])
    modes = {"counter i": {},
             "ray_index": {"ray_index": torch.randint(
                 0, 5 * n, (n,), generator=g, device=dev)},
             "block slot": {"lattice": (H, W, 1)}}
    for impl in ("int8x8", "bf16"):
        for tag, kw in modes.items():
            rad, se, sd = rows
            got = sky_tap(hw, packed, tuple(c.clone() for c in rad), se, sd,
                          k_sky, impl=impl, **kw)
            want = sky_tap_plain(hw, packed, tuple(c.clone() for c in rad),
                                 se, sd, k_sky, impl=impl, **kw)
            torch.cuda.synchronize()
            same = bits_equal(torch.stack(got), torch.stack(want))
            log(f"11a sky tap rbg [{impl}, {tag}]: {n} rays, bit-identical "
                f"{same}")
            if not same:
                raise AssertionError(f"11a urt_sky_tap rbg vs plain ({impl}, "
                                     f"{tag})")
    del got, want, modes
    # Timed on the rbg main path's own 1080p path-kernel output.
    ro, rd, uni, k_b, _ = _frame_inputs(scene, cam_main, rng.key(57, "rbg"),
                                        cfg_r)
    rad, se, sd = path_trace(ks, ro, rd, uni, cfg_r)
    scratch = tuple(c.clone() for c in rad)

    def sky_launch(keys):
        (w1, rbg), (w2, _) = (rng.kernel_words(k) for k in keys)
        k8 = (*w1, *w2) if rbg else (*w1[:2], *w2[:2], 0, 0, 0, 0)
        ptrs = [c.data_ptr() for c in (*scratch, *se, *sd)]
        scale = rgbe_scale(dev).data_ptr()

        def launch():
            _build.check(lib.urt_sky_tap(*ptrs, packed.data_ptr(), 0, scale,
                                         hw[0], hw[1], *k8, rbg, None, 0, 0,
                                         n, _build.stream_ptr(dev)),
                         "env")
        return launch

    keys_r = _sky_keys(cfg_r, k_b)
    keys_t = _sky_keys(cfg_t, rng.fold_in(rng.key(57), 2))
    ms, ms_tf = in_turns(sky_launch(keys_r), sky_launch(keys_t))
    plain_ms = cuda_ms(lambda: sky_tap_plain(hw, packed, scratch, se, sd,
                                             keys_r), 3, 1)
    # Radiance, sky throughput and sky direction read, radiance written,
    # the sky map read once; a block of each key for four rays.
    entry("env_rbg", "env_kernel.cu", "ops/pallas_env.py:88", 0.0, 0, ms,
          ms_tf, plain_ms, n * 48 + packed.numel() * 4, n // 4 * 2, [n])
    del ro, rd, uni, rad, se, sd, scratch, rows, d

    # 11b. The main path under rbg, in turns with the threefry main path.
    rr = Renderer(scene_np, cam_main, cfg_r, seed=0, device="cuda")
    rt = Renderer(scene_np, cam_main, cfg_t, accel=rr.accel, seed=0,
                  device="cuda")
    rr.step(1)
    rt.step(1)
    ms_ab = {"rbg": [], "threefry": []}
    main_launch = {k: 0 for k in _build.LAUNCHES}
    for _ in range(12):
        _, la = counted(lambda: rr.step(1))
        for k in la:
            main_launch[k] += la[k]
        ms_ab["rbg"].append(rr.stats["ms_per_frame"])
        rt.step(1)
        ms_ab["threefry"].append(rt.stats["ms_per_frame"])
    img = rr.image
    if not (np.isfinite(img).all() and img.max() > 0):
        raise AssertionError("11b rbg main path: non-finite or black image")
    want = {"path": 12, "env_rbg": 12, "camera_rbg": 12, "bounce_rows_rbg": 12}
    if any(main_launch[k] != v for k, v in want.items()) \
            or sum(main_launch.values()) != 48:
        raise AssertionError(f"11b rbg main path: expected one path, sky-tap, "
                             f"camera-ray and uniform-row launch a frame in "
                             f"their rbg modes and no urt_uniform, got "
                             f"{main_launch} in 12")
    by_path = {"rbg": main_launch}
    hashes, hash_ = [], rng.threefry2x32
    rng.threefry2x32 = lambda *a: hashes.append(a) or hash_(*a)
    try:
        rr.step(1)
    finally:
        rng.threefry2x32 = hash_
    if len(hashes) > 14:
        raise AssertionError(f"11b rbg step(1) hashed {len(hashes)} keys on "
                             "the host")
    spread = {k: (float(np.median(v)), min(v), max(v))
              for k, v in ms_ab.items()}
    log("11b main path 1080p x 8, 12 step(1) frames each in turns: "
        + "; ".join(f"{k} median {m:.3f} ms (min {lo:.3f}, max {hi:.3f}), "
                    f"{n * nb / m / 1e3:.2f} Mrays/s"
                    for k, (m, lo, hi) in spread.items())
        + f"; rbg launches {main_launch}; host threefry hashes in one rbg "
        f"step(1): {len(hashes)}")
    wall_ms, busy_ms, n_events = device_window(rr)
    log(f"11b rbg profiled window: 3 frames, wall {wall_ms:.3f} ms, device "
        f"busy {busy_ms:.3f} ms, {n_events / 3:.1f} device events a frame")
    fkey_r, fkey_t = rng.key(58, "rbg"), rng.key(58)
    layers = {}
    for tag, c, fk in (("rbg", cfg_r, fkey_r), ("threefry", cfg_t, fkey_t)):
        ro, rd, uni, k_b, _ = _frame_inputs(scene, cam_main, fk, c)
        rad, se, sd = path_trace(rr.accel, ro, rd, uni, c)
        layers[tag] = {
            "camera_rays": cuda_ms(lambda: _camera_rays(
                cam_main, fk, c, H, W, 1, 0, True, dev), 10, 2),
            "uniform_rows": cuda_ms(lambda: bounce_rows(
                k_b, c, H, 0, True, dev), 10, 2),
            "sky_tap": cuda_ms(lambda: _env_tap(scene, c, rad, se, sd, k_b),
                               10, 2)}
        del ro, rd, uni, rad, se, sd
    log("11b layers (ms, CUDA events around calls back to back): " + "; ".join(
        f"{tag} " + ", ".join(f"{k} {v:.4f}" for k, v in ls.items())
        for tag, ls in layers.items()))

    # 11c. The oracle gate under rbg.
    cfg_s = RenderConfig(**dict(MAIN, width=192, height=96, bounces=4,
                                rng_impl="rbg"))
    key = rng.key(42, "rbg")
    fast = render_frame(scene, cfg_s, cam_small, key, ks).cpu().numpy()
    oracle = render_frame(scene, cfg_s.replace(tracer="brute",
                                               ray_chunk=1024), cam_small,
                          key).cpu().numpy()
    oracle_rmse = rmse(fast, oracle)
    log(f"11c oracle gate under rbg: RMSE {oracle_rmse:.3e} (megakernel vs "
        "brute, 192x96x4, same key)")
    if not (np.isfinite(fast).all() and oracle_rmse < 1e-3):
        raise AssertionError(f"11c rbg oracle gate failed: RMSE {oracle_rmse}")

    # 11d. One frame of each other configuration under rbg.
    qcfg = RenderConfig(**QUALITY, rng_impl="rbg")
    scene_q, cam_q = fixtures.sample_scene(), fixtures.sample_scene_camera(
        16 / 9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    rq = Renderer(scene_q, cam_q, qcfg, seed=0, device="cuda").step(1)
    peak = torch.cuda.max_memory_allocated()
    rqt = Renderer(scene_q, cam_q, qcfg.replace(rng_impl="threefry2x32"),
                   accel=rq.accel, seed=0, device="cuda").step(1)
    q_ms = {"rbg": [], "threefry": []}
    for _ in range(2):
        _, la = counted(lambda: rq.step(1))
        q_ms["rbg"].append(rq.stats["ms_per_frame"])
        rqt.step(1)
        q_ms["threefry"].append(rqt.stats["ms_per_frame"])
    n_chunks = -(-qcfg.spp // qcfg.spp_chunk)
    by_path["rbg_quality"] = la
    if not (np.isfinite(rq.image).all() and rq.image.max() > 0) or any(
            la[k] != n_chunks for k in ("path", "env_rbg", "camera_rbg",
                                        "bounce_rows_rbg")) \
            or sum(la.values()) != 4 * n_chunks:
        raise AssertionError(f"11d rbg quality preset: image or launches {la}")
    log(f"11d quality preset under rbg: frames {q_ms['rbg']} ms, threefry in "
        f"turns {q_ms['threefry']} ms; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB, {(peak - resident) / 2 ** 30:.3f} GiB of "
        f"it above what was resident before the renderer; launches a frame "
        f"{la}")
    del rq, rqt

    loop, la = counted(lambda: Renderer(
        scene_np, cam_main, cfg_r.replace(megakernel=False), accel=rr.accel,
        seed=0, device="cuda").step(1))
    by_path["rbg_loop"] = la
    if not (np.isfinite(loop.image).all() and la["trace"] >= 1
            and la["uniform_rbg"] >= 1 and la["camera_rbg"] == 1
            and la["uniform"] == 0 and la["camera"] == 0):
        raise AssertionError(f"11d rbg megakernel=False frame: launches {la}")
    log(f"11d megakernel=False under rbg: "
        f"{loop.stats['ms_per_frame']:.2f} ms; launches {la}")
    del loop

    r_def = Renderer(scene_np, cam_main, cfg_r, accel=rr.accel, seed=9,
                     device="cuda").step(1)
    cuda_env.ENV_IMPL = "bf16"
    try:
        r_bf, la = counted(lambda: Renderer(scene_np, cam_main, cfg_r,
                                            accel=rr.accel, seed=9,
                                            device="cuda").step(1))
    finally:
        cuda_env.ENV_IMPL = "int8x8"
    by_path["rbg_bf16"] = la
    same = bits_equal(r_bf.state.accum, r_def.state.accum)
    log(f"11d ENV_IMPL='bf16' under rbg: bit-equal to the default fetch "
        f"{same}; launches {la}")
    if not (same and la["env_planes_rbg"] == 1 and la["env_rbg"] == 0):
        raise AssertionError(f"11d rbg bf16 frame: equal {same}, {la}")
    del r_def, r_bf

    fkey = rng.key(21, "rbg")
    unsplit = render_frame(scene, cfg_r, cam_main, fkey, rr.accel)
    split, la = counted(lambda: render_frame(scene, cfg_r.replace(**SPLIT),
                                             cam_main, fkey, rr.accel))
    _build.raise_on_overflow(dev)
    split_err = float((split - unsplit).abs().max())
    by_path["rbg_split"] = la
    log(f"11d split vs unsplit under rbg: max |diff| {split_err:.3e}; "
        f"launches {la}")
    if not (torch.isfinite(split).all() and split_err <= 1e-5
            and la["env_rbg"] == 3):
        raise AssertionError(f"11d rbg split frame: {split_err}, {la}")
    del split, unsplit

    bcfg5 = cfg_r.replace(dispatch_bands=5)
    rb, la = counted(lambda: Renderer(scene_np, cam_main, bcfg5,
                                      accel=rr.accel, seed=5,
                                      device="cuda").step(1))
    by_path["rbg_bands"] = la
    fkey5 = rng.fold_in(rng.split(rng.key(5, "rbg"))[1], 0)
    bh = -(-H // 5)
    manual = [render_frame(scene, bcfg5, cam_main, rng.fold_in(fkey5, bi),
                           rr.accel, row0=row0, rows=min(bh, H - row0))
              for bi, row0 in enumerate(range(0, H, bh))]
    want = progressive_step(RenderState.create(W, H, dev),
                            torch.cat(manual, dim=0)).accum
    same = bits_equal(rb.state.accum, want)
    log(f"11d dispatch_bands=5 under rbg: bit-equal to its bands' "
        f"composition {same}; launches {la}")
    if not (same and la["path"] == 5 and la["camera_rbg"] == 5
            and la["env_rbg"] == 5):
        raise AssertionError(f"11d rbg bands: equal {same}, {la}")
    del rb, manual, want, rr, rt
    log(f"11 rbg phase: {time.perf_counter() - t_phase:.1f} s")
    return by_path


def lbvh_depth(accel) -> int:
    """Inner nodes on the longest root-to-leaf path of a ClusterAccel's
    radix tree (host arrays; 0 for a single leaf)."""
    import numpy as np

    C = accel.num_clusters
    if C < 2:
        return 0
    left = np.asarray(accel.node_left[:C - 1])
    right = np.asarray(accel.node_right[:C - 1])
    depth, level = 0, np.array([0])
    while level.size:
        depth += 1
        kids = np.concatenate([left[level], right[level]])
        level = kids[kids < C - 1]
    return depth


def gate_report(tag, img_a, img_b, **extra) -> dict:
    """``examples/gate_scale_tiers.py:report``: the images' RMSE, largest
    pixel difference, pixels off by more than 1e-2 and 1e-4, bit-exactness
    and pixel count."""
    import numpy as np

    from unityraytracer_tpu_torch.utils.image import rmse

    d = np.abs(img_a - img_b).max(axis=-1)
    out = {"tag": tag, "rmse": float(rmse(img_a, img_b)),
           "max_diff": float(d.max()), "bad_px_1e2": int((d > 1e-2).sum()),
           "bad_px_1e4": int((d > 1e-4).sum()),
           "bit_exact": bool(np.array_equal(img_a, img_b)),
           "n_px": int(d.size), **extra}
    log("12 RESULT " + json.dumps(out))
    return out


def scale_phase(counted, bits_equal, kernels) -> dict:
    """Phase 12: scenes of 100k to 2M triangles on the card. The ladder of
    rbg main-path frames at 1080p x 8 (``LADDER``), the 2M frame against
    the per-bounce loop (``megakernel=False``) in turns, and the three
    gates of ``examples/gate_scale_tiers.py`` at 192x96: gate1m (pallas
    against brute and cluster at 1M, 4 bounces, 4 bands), gate2m_b1 (bounce
    1 at 2M bit-exact, and the camera rays' hit records against
    ``trace_brute``) and gate2m_part (``ShardedRenderer(mode="scene")`` on
    two and four logical shards of one Morton order, bit-identical). Adds
    the ladder to ``kernels["path"]`` and returns the launch counts of its
    paths. Raises on any failure."""
    import numpy as np
    import torch

    from unityraytracer_tpu_torch import (Camera, RenderConfig, Renderer,
                                          _build, rng)
    from unityraytracer_tpu_torch.models import fixtures
    from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
    from unityraytracer_tpu_torch.ops.cuda_path import (path_trace,
                                                        path_trace_plain)
    from unityraytracer_tpu_torch.ops.cuda_trace import (KernelScene,
                                                         closest_hit_plain,
                                                         trace_hits)
    from unityraytracer_tpu_torch.parallel.scene_shard import allreduce_hit
    from unityraytracer_tpu_torch.parallel.sharding import ShardedRenderer
    from unityraytracer_tpu_torch.render import _frame_inputs
    from unityraytracer_tpu_torch.utils.image import rmse

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = RenderConfig(**MAIN, rng_impl="rbg")
    W, H, nb = cfg.width, cfg.height, cfg.bounces
    n = W * H
    cam = fixtures.bench_camera(aspect=W / H)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    main_kernels = ("path", "env_rbg", "camera_rbg", "bounce_rows_rbg")
    by_path, ladder, keep = {}, [], {}

    def rows(h):
        return torch.stack([h.t, *h.normal, *h.albedo, *h.specular,
                            *h.emission, h.smoothness])

    # 12a. The ladder.
    for n_tris in LADDER:
        t0 = time.perf_counter()
        s_np = fixtures.bench_scene(n_tris=n_tris)
        scene_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        a_np = build_cluster_accel(s_np.triangles, cluster_size=64)
        accel_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ks_n = KernelScene.create(s_np.to(dev), a_np, dev)
        torch.cuda.synchronize()
        create_s = time.perf_counter() - t0
        sb, depth = scene_bytes(ks_n), lbvh_depth(a_np)
        torch.cuda.reset_peak_memory_stats()
        r = Renderer(s_np, cam, cfg, accel=ks_n, seed=0, device="cuda")
        r.step(1)
        frames, total = [], {k: 0 for k in _build.LAUNCHES}
        for _ in range(12):
            _, la = counted(lambda: r.step(1))
            frames.append(r.stats["ms_per_frame"])
            if any(la[k] != 1 for k in main_kernels) or sum(la.values()) != 4:
                raise AssertionError(f"12a {n_tris} triangles: a frame "
                                     f"launched {la}, expected one each of "
                                     f"{main_kernels}")
            for k in la:
                total[k] += la[k]
        _build.raise_on_overflow(dev)
        peak = torch.cuda.max_memory_allocated()
        img = r.image
        if not (np.isfinite(img).all() and img.max() > 0):
            raise AssertionError(f"12a {n_tris} triangles: non-finite or "
                                 "black image")
        ro, rd, uni, _, _ = _frame_inputs(r.scene, cam, rng.key(60, "rbg"),
                                          cfg)
        path_ms = cuda_ms(lambda: path_trace(ks_n, ro, rd, uni, cfg), 5, 1)
        cnt = torch.empty((2, n), dtype=torch.int32, device=dev)
        path_trace(ks_n, ro, rd, uni, cfg, counts=cnt)
        _build.raise_on_overflow(dev)
        tests = cnt.sum(dim=1, dtype=torch.int64).cpu().tolist()
        # The camera rays alone (bounce 1) through the closest-hit kernel:
        # how much of the growth in tests is the first bounce's.
        h1 = trace_hits(ks_n, ro, rd, counts=cnt)
        _build.raise_on_overflow(dev)
        cam_tests = cnt.sum(dim=1, dtype=torch.int64).cpu().tolist()
        cam_hit = float((h1.t < 1e30).float().mean())
        slice_check = None
        if n_tris == LADDER[-1]:
            # Both kernels on this rung's own inputs: SLICE rays from the
            # middle of the frame against the plain versions, bit for bit
            # (the camera rays' 14 hit rows and winners; the path kernel's
            # nine output rows over all eight bounces).
            sl = slice(n // 2 - SLICE // 2, n // 2 + SLICE // 2)
            cut = lambda v3: tuple(c[sl].contiguous() for c in v3)  # noqa: E731
            t0 = time.perf_counter()
            hp = closest_hit_plain(ks_n, cut(ro), cut(rd))
            torch.cuda.synchronize()
            hit_plain_s = time.perf_counter() - t0
            same_hits = (bits_equal(rows(h1)[:, sl], rows(hp))
                         and bool(torch.equal(h1.prim[sl], hp.prim)))
            rk = path_trace(ks_n, ro, rd, uni, cfg)
            t0 = time.perf_counter()
            rp = path_trace_plain(ks_n, cut(ro), cut(rd),
                                  uni[:, :, sl].contiguous(), cfg)
            torch.cuda.synchronize()
            path_plain_s = time.perf_counter() - t0
            _build.raise_on_overflow(dev)
            a = torch.stack([c[sl] for v3 in rk for c in v3])
            b = torch.stack([c for v3 in rp for c in v3])
            same_path = bits_equal(a, b)
            slice_check = dict(
                rays=SLICE, first_ray=sl.start,
                hit_fraction=float((hp.t < 1e30).float().mean()),
                hit_rows_bit_equal=same_hits, path_rows_bit_equal=same_path,
                path_max_abs=float((a - b).abs().max()),
                closest_hit_plain_s=hit_plain_s,
                path_trace_plain_s=path_plain_s)
            log(f"12a {s_np.num_triangles} triangles, {SLICE} rays of the "
                "frame against the plain versions: "
                + json.dumps(slice_check))
            if not (same_hits and same_path):
                raise AssertionError(f"12a {n_tris} triangles: kernels "
                                     f"against plain {slice_check}")
            del hp, rk, rp, a, b
        del ro, rd, uni, cnt, h1
        # Bytes: the rays and uniform rows read and nine rows written, and
        # the scene bytes its tests touch (a box test reads 32 bytes of a
        # 64-byte node or 24 of a leaf's 192 bytes of run boxes, taken as
        # 32; a triangle test 48 bytes of float4 rows), each byte once: at
        # most the scene's tables.
        touched = tests[0] * 32 + tests[1] * 48
        ray_bytes = n * (24 + nb * 20 + 36)
        b_ms, b_by = bound(ray_bytes + min(sb, touched),
                           tests[0] * FLOP_BOX + tests[1] * FLOP_TRI)
        med = float(np.median(frames))
        rung = dict(
            n_tris=s_np.num_triangles, scene_s=scene_s, accel_s=accel_s,
            kernel_scene_s=create_s, scene_bytes=sb, l2_bytes=l2,
            scene_over_l2=sb / l2, lbvh_depth=depth, clusters=a_np.num_clusters,
            frame_ms_median=med, frame_ms_min=min(frames),
            frame_ms_max=max(frames), mrays_per_s=n * nb / med / 1e3,
            launches_per_frame={k: v / 12 for k, v in total.items() if v},
            path_kernel_ms=path_ms, box_per_ray=tests[0] / n,
            tri_per_ray=tests[1] / n, camera_box_per_ray=cam_tests[0] / n,
            camera_tri_per_ray=cam_tests[1] / n, camera_hit_fraction=cam_hit,
            touched_bytes=touched,
            path_bound_ms=b_ms, path_bound_by=b_by,
            path_bound_share=b_ms / path_ms, peak_bytes=peak,
            against_plain=slice_check)
        log("12a rung " + json.dumps(rung))
        ladder.append(rung)
        by_path["scale"] = total
        if n_tris in (1_000_000, 2_000_000):
            keep[n_tris] = (s_np, ks_n)
        if n_tris == LADDER[-1]:
            # The per-bounce route at this size, in turns with the path
            # kernel's frame.
            rl = Renderer(s_np, cam, cfg.replace(megakernel=False),
                          accel=ks_n, seed=0, device="cuda")
            _, la = counted(lambda: rl.step(1))
            by_path["scale_loop"] = la
            if not (la["trace"] >= 1 and la["path"] == 0
                    and np.isfinite(rl.image).all()):
                raise AssertionError(f"12a megakernel=False at {n_tris}: "
                                     f"{la}")
            ab = {"path kernel": [], "megakernel=False": []}
            for _ in range(3):
                for tag, rr in (("path kernel", r), ("megakernel=False", rl)):
                    rr.step(1)
                    ab[tag].append(rr.stats["ms_per_frame"])
            _build.raise_on_overflow(dev)
            log(f"12a {s_np.num_triangles} triangles, frames in turns: "
                + "; ".join(f"{k} {v}" for k, v in ab.items())
                + f" ms; megakernel=False launches a frame {la}")
            rung["loop_ms"] = ab["megakernel=False"]
            del rl
        del r, img
        torch.cuda.empty_cache()
    kernels["path"]["ladder"] = ladder

    # The gates of examples/gate_scale_tiers.py at 192x96, seed 7.
    gcam = Camera.create(**GATE_CAM, aspect=GATE["width"] / GATE["height"])

    def gate_cfg(bounces, bands, tracer):
        return RenderConfig(**GATE, bounces=bounces, tracer=tracer,
                            dispatch_bands=bands)

    def gate_render(s_np, ks_, c, tag):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rr, la = counted(lambda: Renderer(s_np, gcam, c, accel=ks_,
                                          seed=GATE_SEED,
                                          device="cuda").step(1))
        s = time.perf_counter() - t0
        by_path[f"scale_{tag}"] = la
        log(f"12 {tag}: {s:.2f} s; launches {la}")
        return rr.image

    # 12b. gate1m: 4 bounces, 4 bands, pallas against brute and cluster.
    s1, ks1 = keep[1_000_000]
    img_p = gate_render(s1, ks1, gate_cfg(4, 4, "pallas"), "gate1m_pallas")
    img_c = gate_render(s1, ks1, gate_cfg(4, 4, "cluster"), "gate1m_cluster")
    img_b = gate_render(s1, ks1, gate_cfg(4, 4, "brute"), "gate1m_brute")
    g1 = gate_report("gate1m_b4_vs_brute", img_p, img_b)
    gate_report("gate1m_b4_vs_cluster", img_p, img_c)
    if not (np.isfinite(img_p).all() and img_p.max() > 0
            and g1["rmse"] < 1e-3):
        raise AssertionError(f"12b gate1m: RMSE {g1['rmse']} against brute")
    del img_p, img_c, img_b, s1, ks1
    keep.pop(1_000_000)

    # 12c. gate2m_b1: bounce 1 at 2M, 4 bands: pallas bit-exact with brute;
    # the camera rays' hit records of the kernel equal trace_brute's.
    s2, ks2 = keep[2_000_000]
    img_p = gate_render(s2, ks2, gate_cfg(1, 4, "pallas"), "gate2m_b1_pallas")
    img_c = gate_render(s2, ks2, gate_cfg(1, 4, "cluster"),
                        "gate2m_b1_cluster")
    img_b = gate_render(s2, ks2, gate_cfg(1, 4, "brute"), "gate2m_b1_brute")
    g2 = gate_report("gate2m_bounce1_vs_brute", img_p, img_b)
    gate_report("gate2m_bounce1_vs_cluster", img_p, img_c)
    c1 = gate_cfg(1, None, "pallas")
    ro, rd, _, _, _ = _frame_inputs(ks2.scene, gcam, rng.key(GATE_SEED,
                                                             "rbg"), c1)
    hk = trace_hits(ks2, ro, rd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hp = closest_hit_plain(ks2, ro, rd)
    torch.cuda.synchronize()
    brute_s = time.perf_counter() - t0
    _build.raise_on_overflow(dev)
    same_rows = bits_equal(rows(hk), rows(hp))
    same_prim = bool(torch.equal(hk.prim, hp.prim))
    hit_frac = float((hk.t < 1e30).float().mean())
    log(f"12c hit records of {ro[0].shape[0]} camera rays at "
        f"{s2.num_triangles} triangles: 14 rows bit-equal {same_rows}, "
        f"prims equal {same_prim}, hit fraction {hit_frac:.4f}; "
        f"trace_brute {brute_s:.2f} s")
    if not (g2["bit_exact"] and same_rows and same_prim
            and img_p.max() > 0):
        raise AssertionError(f"12c gate2m_b1: image bit-exact "
                             f"{g2['bit_exact']}, rows {same_rows}, prims "
                             f"{same_prim}")
    del img_p, img_c, img_b, hk, hp

    # 12d. gate2m_part: 4 bounces through ShardedRenderer(mode="scene") on
    # two and four logical shards of the card.
    c4 = gate_cfg(4, None, "pallas")
    imgs, srs = {}, {}
    for shards in (2, 4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sr = ShardedRenderer(s2, gcam, c4, mesh=["cuda:0"] * shards,
                             seed=GATE_SEED, mode="scene")
        setup_s = time.perf_counter() - t0
        _, la = counted(lambda: sr.step(1))
        by_path[f"scale_part{shards}"] = la
        imgs[shards] = sr.image
        srs[shards] = sr
        log(f"12d scene shards {shards}: set-up {setup_s:.2f} s, frame "
            f"{sr.stats['ms_per_frame']:.2f} ms, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB, "
            f"launches {la}")
        if la["trace"] < shards or la["path"] != 0:
            raise AssertionError(f"12d {shards} shards: launches {la}")
    g3 = gate_report("gate2m_partition_2_vs_4", imgs[2], imgs[4])
    # The sharded image against one device's path-kernel frame of the same
    # key chain (the bounce loop's shading in torch against the kernel's):
    # the repo's image bar.
    g4 = gate_report("gate2m_part4_b4_vs_pallas", imgs[4], gate_render(
        s2, ks2, c4, "gate2m_b4_pallas"))
    sr = srs[4]
    ro4 = tuple(c.contiguous() for c in ro)
    hits = [trace_hits(ks_, ro4, rd) for ks_ in sr.accel]
    combine_ms = cuda_ms(lambda: allreduce_hit(hits), 10, 2)
    frame_ms = {}
    for shards in (2, 4, 2, 4):
        srs[shards].step(1)
        frame_ms.setdefault(shards, []).append(
            srs[shards].stats["ms_per_frame"])
    _build.raise_on_overflow(dev)
    log(f"12d frames in turns (ms): {frame_ms}; the combine of 4 shards' "
        f"hits on {ro[0].shape[0]} rays {combine_ms:.4f} ms (CUDA events)")
    if not (g3["bit_exact"] and np.isfinite(imgs[2]).all()
            and imgs[2].max() > 0 and g4["rmse"] < 1e-3):
        raise AssertionError(f"12d gate2m_part: 2 against 4 shards {g3}; "
                             f"4 shards against one device {g4}")
    del srs, sr, hits, imgs, ro, rd, ro4, keep
    torch.cuda.empty_cache()
    log(f"12 scale phase: {time.perf_counter() - t_phase:.1f} s")
    return by_path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from unityraytracer_tpu_torch import (RenderConfig, Renderer, _build,
                                          native, rng)
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
                                                 _sky_keys, bounce_args,
                                                 bounce_rows,
                                                 bounce_rows_plain,
                                                 camera_args,
                                                 camera_rays_plain,
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
    # The native host library (g++, at first use), which the LBVH build
    # below and the PIZ decode call.
    fresh = not native.library_path(native._cxx() or "g++").exists()
    t0 = time.perf_counter()
    if not native.build():
        raise AssertionError(f"native host library: {native.BUILD_LOG}")
    log(f"native host library {'build' if fresh else 'load'} "
        f"{time.perf_counter() - t0:.2f} s -> "
        f"{native.library_path(native._cxx()).name}")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())
    # The instructions of one threefry draw and of one expf, as the kernels
    # are built: they price the bounds of the threefry and a-trous kernels.
    sass = sass_counts({"draw": ("urt_uniform_at(k0, k1, i)",
                                 "__uint_as_float(i)"),
                        "expf": ("expf(x[i])", "x[i]"),
                        "philox": (PHILOX_BLOCK, "__uint_as_float(i)")},
                       _build.NVCC_FLAGS)
    draw_ops, n_exp = int_ops(sass["draw"]), sum(sass["expf"].values())
    block_ops = int_ops(sass["philox"])
    log(f"SASS of one threefry draw {sass['draw']}: {draw_ops} int32 ops "
        f"for its bound; of one expf {sass['expf']}: {n_exp} instructions; "
        f"of one Philox4x32-10 block (four rbg draws) {sass['philox']}: "
        f"{block_ops} int32 ops")

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
    # Each kernel's time comes from graph replays of its raw launch with the
    # arguments built (kernel_ms); host_ms is one wrapper call's host time,
    # and call_ms the CUDA events around 20 wrapper calls back to back,
    # which time the host wherever a call's host work outlasts its kernel.
    lib = _build.lib()
    ukey = rng.key(51)
    uk0, uk1 = (int(w) for w in ukey)
    uout = torch.empty(n_env, dtype=torch.float32, device=dev)

    def uniform_launch():
        _build.check(lib.urt_uniform(uk0, uk1, 0, 0, 0, uout.data_ptr(),
                                     n_env, _build.stream_ptr(dev)),
                     "uniform")

    def uniform_call():
        return rng.uniform(ukey, (n_env,), device=dev)

    kernels["uniform"] = dict(
        route="cuda", source="unityraytracer_tpu_torch/csrc/uniform_kernel.cu",
        replaces="unityraytracer_tpu/render.py:465",
        max_abs_err=0.0, shape=[n_env], plain_shape=[n_env],
        ms=kernel_ms(uniform_launch), host_ms=host_ms(uniform_call),
        call_ms=cuda_ms(uniform_call, 20, 3),
        plain_ms=cuda_ms(lambda: rng.uniform_plain(ukey, (n_env,),
                                                   device=dev), 5, 1))
    del uout
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

    def rows_launcher(cfg_r, kb=kb):
        args = bounce_args(kb, cfg_r, cfg_r.height, 0, True)
        out = torch.empty((cfg_r.bounces, 5, args.n), dtype=torch.float32,
                          device=dev)

        def launch():
            _build.check(lib.urt_bounce_rows(ctypes.byref(args),
                                             out.data_ptr(),
                                             _build.stream_ptr(dev)),
                         "bounce_rows")
        return launch

    def rows_call():
        return bounce_rows(kb, cfg_m, H_m, 0, True, dev)

    kernels["bounce_rows"] = dict(
        route="cuda", source="unityraytracer_tpu_torch/csrc/uniform_kernel.cu",
        replaces="unityraytracer_tpu/render.py:495",
        max_abs_err=max_abs, max_ulp_by_row=max_ulp,
        shape=[cfg_m.bounces, 5, n_m], plain_shape=[cfg_m.bounces, 5, n_m],
        ms=kernel_ms(rows_launcher(cfg_m)), host_ms=host_ms(rows_call),
        call_ms=cuda_ms(rows_call, 20, 3),
        plain_ms=cuda_ms(lambda: bounce_rows_plain(kb, cfg_m, H_m, 0, True,
                                                   dev), 3, 1),
        draw_ops=draw_ops)
    # The rows written once and the draws' integer work; the log2, cos and
    # sin are left out (cosf and sinf branch to a slow path that a static
    # count would include), so the bound errs low.
    kernels["bounce_rows"]["bound_ms"], kernels["bounce_rows"]["bound_by"] = \
        bound(cfg_m.bounces * 5 * n_m * 4, draws * draw_ops, PEAK_I32)
    log("bounce_rows:", json.dumps(kernels["bounce_rows"]))

    # 3a''. The camera-ray kernel against its plain version (the int64
    # threefry draws and the torch camera ops), within CAMERA_ULP: at the
    # main path's 1080p in block order, a band of dispatch_bands=5, the
    # quality preset's chunk of spp 5, and the oracle's 192x96 in pixel
    # order (the bounce loop's draws at block slots).
    cam_q = fixtures.sample_scene_camera(16 / 9)
    cam_cases = {   # (camera, config, band rows, row0, blocked)
        "main 1920x1080 block order": (cam_main, cfg_m, H_m, 0, True),
        "band rows 216-431 of dispatch_bands=5": (cam_main, cfg_m, 216, 216,
                                                  True),
        "quality chunk spp 5": (cam_q, qsub, H_m, 0, True),
        "oracle 192x96 pixel order": (cam_small, small_cfg(tracer="brute"),
                                      96, 0, False),
    }
    cam_err, cam_ulp = 0.0, 0
    for tag, (cam, cfg_c, h_c, row0_c, blk) in cam_cases.items():
        ckey = rng.fold_in(rng.key(54), row0_c + cfg_c.spp)
        W_c, spp_c = cfg_c.width, cfg_c.spp
        ro_k, rd_k, _ = _camera_rays(cam, ckey, cfg_c, h_c, W_c, spp_c,
                                     row0_c, blk, dev)
        ro_p, rd_p = camera_rays_plain(cam, ckey, cfg_c, h_c, W_c, spp_c,
                                       row0_c, blk, dev)
        torch.cuda.synchronize()
        got, want = torch.stack(ro_k + rd_k), torch.stack(ro_p + rd_p)
        same = bits_equal(got, want)
        ulp = ulp_distance(got, want)
        err = float((got - want).abs().max())
        cam_err, cam_ulp = max(cam_err, err), max(cam_ulp, ulp)
        log(f"camera rays [{tag}]: {tuple(got.shape)}, bit-identical {same}, "
            f"max {ulp} ulp, max abs err {err:.3e}, finite "
            f"{bool(torch.isfinite(got).all())}")
        if not (ulp <= CAMERA_ULP and torch.isfinite(got).all()):
            raise AssertionError(f"camera-ray kernel vs plain ({tag}): {ulp} "
                                 "ulp")
    del got, want, ro_k, rd_k, ro_p, rd_p
    ckey = rng.key(55)
    cargs = camera_args(cam_main, ckey, cfg_m, H_m, cfg_m.width, 1, 0, True)
    cout = torch.empty((6, n_m), dtype=torch.float32, device=dev)

    def camera_launch():
        _build.check(lib.urt_camera_rays(ctypes.byref(cargs), cout.data_ptr(),
                                         _build.stream_ptr(dev)), "camera")

    def camera_call():
        return _camera_rays(cam_main, ckey, cfg_m, H_m, cfg_m.width, 1, 0,
                            True, dev)

    kernels["camera_rays"] = dict(
        route="cuda", source="unityraytracer_tpu_torch/csrc/camera_kernel.cu",
        replaces="unityraytracer_tpu/render.py:460",
        max_abs_err=cam_err, max_ulp=cam_ulp, shape=[6, n_m],
        plain_shape=[6, n_m], ms=kernel_ms(camera_launch),
        host_ms=host_ms(camera_call), call_ms=cuda_ms(camera_call, 20, 3),
        plain_ms=cuda_ms(lambda: camera_rays_plain(
            cam_main, ckey, cfg_m, H_m, cfg_m.width, 1, 0, True, dev), 5, 1))
    # ro and rd written once; four threefry draws a ray (the prologue's six
    # hashes a block and the ~80 float operations a ray are left out).
    kernels["camera_rays"]["bound_ms"], kernels["camera_rays"]["bound_by"] = \
        bound(n_m * 24, n_m * 4 * draw_ops, PEAK_I32)
    log("camera_rays:", json.dumps(kernels["camera_rays"]))
    del cout

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
    for k in ("path", "env", "camera", "bounce_rows"):
        if launches[k] < 1:
            raise AssertionError(f"kernel {k!r} never launched on the main "
                                 f"path: {launches}")
    # One launch a frame of the path, sky-tap, camera-ray and uniform-row
    # kernels; the camera's draws are the camera-ray kernel's, so no
    # urt_uniform.
    nf = len(frame_ms)
    if any(launches[k] != nf for k in ("path", "env", "camera",
                                       "bounce_rows")) \
            or launches["uniform"] != 0 or launches["env_planes"] != 0:
        raise AssertionError(f"main path: expected 1 path, sky-tap, camera "
                             f"and uniform-row launch and no urt_uniform a "
                             f"frame, got {launches} in {nf}")
    by_path = {"main": launches}
    # The Python threefry hashes of one step(1): split (2), the frame key,
    # k_bounce and the sky tap's three keys; the kernels derive the rest.
    hashes, hash_ = [], rng.threefry2x32
    rng.threefry2x32 = lambda *a: hashes.append(a) or hash_(*a)
    try:
        r.step(1)
    finally:
        rng.threefry2x32 = hash_
    log(f"host threefry hashes in one main-path step(1): {len(hashes)}")
    if len(hashes) > 7:
        raise AssertionError(f"step(1) hashed {len(hashes)} keys on the host")
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
    if not (np.isfinite(loop.image).all() and loop_launches["trace"] >= 1
            and loop_launches["uniform"] >= 1
            and loop_launches["camera"] == 1):
        raise AssertionError(f"megakernel=False frame: non-finite image or "
                             f"no closest-hit, urt_uniform or camera-ray "
                             f"launch: {loop_launches}")
    by_path["loop"] = loop_launches
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
            cam_main, fkey, cfg_m, H_m, cfg_m.width, 1, 0, True, dev), 10, 2),
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
    # main-path frames, both read under torch.profiler.
    wall_ms, busy_ms, n_events = device_window(r)
    log(f"profiled window: 3 frames, wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms over {n_events} device events "
        f"({n_events / 3:.1f} a frame), busy share "
        f"{busy_ms / wall_ms:.4f}")
    log(f"device launches a frame: before the camera-ray kernel "
        f"{LAUNCHES_BEFORE} (PERF.md), now {n_events / 3:.1f}")

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
        if any(la[k] != n_chunks for k in ("path", "env", "camera",
                                           "bounce_rows")) \
                or la["uniform"] != 0:
            raise AssertionError(f"quality preset: expected {n_chunks} path, "
                                 f"sky-tap, camera and uniform-row launches "
                                 f"and no urt_uniform a frame, got {la}")
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
    q_kernel_ms = kernel_ms(rows_launcher(qsub))
    kernels["bounce_rows"]["quality_chunk"] = dict(
        shape=[qsub.bounces, 5, n_q], ms=q_kernel_ms,
        call_ms=q_layers["uniform_rows"], bound_ms=qb, bound_by=qby,
        share=qb / q_kernel_ms)
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
            or split_launch["camera"] != 15 or split_launch["uniform"] != 0:
        raise AssertionError(f"split frames: expected 3 path, 3 sky-tap, "
                             f"1 camera and no urt_uniform launches each, "
                             f"got {split_launch} in 15")
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
    if not (same and la["path"] == 5 and la["env"] == 5
            and la["camera"] == 5 and la["uniform"] == 0):
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
               for k in ("path", "env", "rng", "camera")) or la["path"] != 4:
        raise AssertionError(f"profile: stages {prof.stages_ms}, {la}")
    del rp, accum, g, guides

    # 8. The command line at full width.
    by_path.update(command_line_phase(counted, bits_equal))

    # 9. The accel tracers, the sharded renderer, their flags, and the
    # native host library.
    by_path.update(accel_shard_native_phase(counted, bits_equal, scene_np,
                                            accel_np, ks, cfg_s, oracle,
                                            key))

    # 10. The ray sort, sorted against unsorted.
    by_path.update(ray_sort_phase(counted, scene_np, accel_np, ks, cfg_s,
                                  kernels))

    # 11. rng_impl="rbg": bench.py's own random streams.
    by_path.update(rbg_phase(counted, bits_equal, scene_np, ks, kernels,
                             block_ops))

    # 12. Scenes of 100k to 2M triangles: the ladder and the scale gates.
    by_path.update(scale_phase(counted, bits_equal, kernels))

    for k in kernels:
        use = {"env_planes": "bf16", "trace": "preview",
               "atrous": "preview", "uniform": "loop",
               "uniform_rbg": "rbg_loop", "camera_rays_rbg": "rbg",
               "bounce_rows_rbg": "rbg", "env_rbg": "rbg"}.get(k, "main")
        count = {"camera_rays": "camera",
                 "camera_rays_rbg": "camera_rbg"}.get(k, k)
        kernels[k]["launches"] = by_path[use][count]
        kernels[k]["launches_by_path"] = {p_: v[count] for p_, v in
                                          by_path.items()}
    for k in kernels:
        if kernels[k]["launches"] < 1:
            raise AssertionError(f"kernel {k!r} never launched on its path")

    _build.raise_on_overflow(dev)
    log(card)
    keys = ("route", "source", "replaces", "launches",
            "launches_megakernel_false", "launches_by_path", "max_abs_err",
            "max_ulp", "ms", "ms_threefry", "host_ms", "call_ms", "plain_ms",
            "bound_ms",
            "bound_by", "library_ms", "shape", "plain_shape", "sort_window",
            "ms_binned", "ms_unbinned", "binned_bit_equal", "binned_shape",
            "sort_prologue_ms", "order_equal", "simt_bounce1", "ladder")
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
