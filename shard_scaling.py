#!/usr/bin/env python3
"""Multi-card rendering on real cards: a renderer on a card other than card
0, the four sharding modes against logical shards of one card, the hit
combine, a four-card checkpoint resumed on one card, the command line over
every card, and the 2M-triangle scene split over the cards.

    python3 shard_scaling.py          # every phase, on every card torch sees
    python3 shard_scaling.py frame    # the one-card main frame alone

With no argument it needs two or more CUDA devices and uses every one torch
sees (n cards). It prints each card's name and power limit, the
peer-access matrix, ``nvidia-smi topo -m`` and ``nvidia-smi nvlink
--status`` (as far as the machine answers them), one line a measurement
(``key {json}``) and a JSON object last, and exits non-zero with fewer than
two cards or when a check fails. ``run(cards, ...)`` takes any list of
devices (the CPU tests pass ``["cpu"] * 4`` at a small size; off the card
the launch counts, peak memory and busy shares read empty). On the bench
cell (1920x1080, spp 1, 8 bounces, ``bench_scene(100_000)``, the bench
camera), under each ``rng_impl`` of ``IMPLS``:

1. One card: ``Renderer(device=cards[-1])`` and ``Renderer(device=
   cards[0])`` in turns, their images bit-equal and a frame's launches all
   on the renderer's own card; ``aovs()`` and ``denoised_image(guided=
   True)`` on the last card launch there and equal card 0's.
2. ``ShardedRenderer`` in ``rows``, ``spp`` (the path kernel), ``scene``
   and ``rows_scene`` (``tracer="cluster"``; ``make_mesh2(n // 2, 2)``),
   each on the cards and on ``[cards[0]] * n`` in turns: median and range
   of FRAMES ``step(1)`` frames, the two images bit-equal, ``scene`` also
   within RMSE 1e-3 of a one-card ``Renderer(tracer="cluster")`` of the
   same seed and steps (its frames timed too). For each card: its launches in the first frame
   (``_build.CARD_LAUNCHES``); its peak memory from building the renderer
   to the end of that frame, above what the card held before; and its busy
   share, the card's own work in one frame over the frame's median wall
   time. The card's work is timed by CUDA events on its stream while spin
   kernels hold every card of the mesh until the host has queued each
   segment of the frame (``queued_frame``), so it holds no wait for the
   host (it may hold waits for another card). Every
   card of the mesh must launch in its first frame. Then ``profile(1)`` of
   each mesh (``torch.profiler``).
3. The hit combine: ``allreduce_hit`` of the n scene shards' hits of the
   2,073,600 pixel-centre rays onto card 0, host clock around COMBINE_CALLS
   calls ended by a synchronize of every card, on the cards and on logical
   shards; and the same bytes as one copy a shard (a (17, N) block).
4. Checkpoints: ``save_state`` of a ``scene`` mesh of the n cards resumed by
   a one-card ``Renderer(tracer="cluster")``, and of a ``rows`` mesh by
   ``[cards[0]] * n``; one more frame on each, images bit-equal.
5. The command line: ``render --device <last card>`` in this process, its
   accumulator bit-equal to ``--device <card 0>``'s and, as a child
   process, its PNG byte-equal; ``render --shard rows`` and ``--shard
   scene`` over every card as child processes against the same commands in
   this process, PNG for PNG, with the children's wall time; ``info`` as a
   child lists every card.
6. ``bench_scene(2_000_000)`` under ``mode="scene"``: gate2m_part (the
   scale gates' 192x96 frame, 4 bounces, ``tracer="pallas"``, rbg, seed 7;
   ``chip_smoke.py`` phase 12d) on 2 and on 4 cards and on 2 and 4 logical
   shards, all bit-exact, and within RMSE 1e-3 of one card's path-kernel
   frame; then the bench cell on the big scene (rbg, ``"cluster"``) on the
   cards and on logical shards as in 2, against one card's frame.

``frame`` times ``Renderer(device="cuda:0")`` on the bench cell, FRAMES
frames under each impl, and prints one JSON line each, after the host
microseconds of entering and leaving ``_build.on_card`` where the checkout
has it. It uses only names
that the port has had since its first slices, so a copy of this script in
an older checkout times that checkout's frame (an A/B of two trees on one
card, in turns).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FRAMES = 12
COMBINE_CALLS = 20
N_TRIS = 100_000
BIG_TRIS = 2_000_000
IMPLS = ("threefry2x32", "rbg")
MODES = ("rows", "spp", "scene", "rows_scene")
CELL = dict(width=1920, height=1080, spp=1, bounces=8, wavefront=True,
            rr_group="step")
# The scale gates' frame (examples/gate_scale_tiers.py:52-62; chip_smoke.py
# GATE): 192x96, 4 bounces, bench.py's streams, seed 7.
GATE = dict(width=192, height=96, spp=1, bounces=4, ray_chunk=4096,
            wavefront=True, rr_group="step", rng_impl="rbg")
GATE_SEED = 7
# queued_frame: the spin (ms) that holds the cards while the host queues
# each segment of SEGMENT torch ops (a card's queue holds about a thousand
# launches, fewer than a bounce-loop frame makes).
SPIN_MS = 10.0
SEGMENT = 64


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def cuda_of(devices) -> list:
    """The card indices among ``devices`` (any nesting of lists)."""
    flat = []
    for d in devices:
        flat.extend(d if isinstance(d, list) else [d])
    return sorted({d.index for d in flat if d.type == "cuda"})


def sync(devices) -> None:
    import torch

    for k in cuda_of(devices):
        torch.cuda.synchronize(k)


def spread(ms) -> dict:
    import numpy as np

    return dict(median=float(np.median(ms)), min=min(ms), max=max(ms),
                ms=list(ms))


def in_turns(renderers: dict, frames: int) -> dict:
    """``frames`` ``step(1)`` frames of each renderer, in turns (the order
    reversed every round): each one's host ms a frame."""
    ms = {name: [] for name in renderers}
    names = list(renderers)
    for i in range(frames):
        for name in names if i % 2 == 0 else names[::-1]:
            renderers[name].step(1)
            ms[name].append(renderers[name].stats["ms_per_frame"])
    return {name: spread(v) for name, v in ms.items()}


def counted_step(r) -> dict:
    """One ``step(1)`` of ``r``: its launches by card and kernel."""
    from unityraytracer_tpu_torch import _build

    _build.CARD_LAUNCHES.clear()
    r.step(1)
    return {k: {n: c for n, c in v.items() if c}
            for k, v in sorted(_build.CARD_LAUNCHES.items())}


@contextlib.contextmanager
def peak_mib(devices, out: dict):
    """Fill ``out[card]`` with the card's peak allocation inside the block
    above what it held when the block began (MiB)."""
    import torch

    cards = cuda_of(devices)
    base = {}
    for k in cards:
        torch.cuda.synchronize(k)
        torch.cuda.reset_peak_memory_stats(k)
        base[k] = torch.cuda.memory_allocated(k)
    yield out
    for k in cards:
        torch.cuda.synchronize(k)
        out[k] = (torch.cuda.max_memory_allocated(k) - base[k]) / 2 ** 20


_SPIN = {}


def spin_cycles(ms: float) -> int:
    """Clock cycles of ``torch.cuda._sleep`` that last about ``ms`` on card
    0 (measured once with CUDA events)."""
    import torch

    if "per_ms" not in _SPIN:
        with torch.cuda.device(0):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(1_000_000)
            a.record()
            torch.cuda._sleep(20_000_000)
            b.record()
            b.synchronize()
            _SPIN["per_ms"] = 20_000_000 / a.elapsed_time(b)
    return int(_SPIN["per_ms"] * ms)


def queued_frame(r) -> dict:
    """One ``step(1)`` of ``r`` (a ShardedRenderer) whose every card is
    held by a spin kernel while the host queues each segment of SEGMENT
    torch ops: a card's own work is its span, from a CUDA event before its
    first spin to one after its last op, less its spins (each timed by its
    own pair of events). It holds no wait for the host wherever every spin
    outlasted the queueing of its segment (``held``; else ``broke_at`` names
    the op whose segment the card reached first); it may hold waits for
    another card. Empty off the card."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    cards = cuda_of(r.mesh)
    if not cards:
        return {}
    cycles = spin_cycles(SPIN_MS)
    spins = {k: [] for k in cards}
    state = dict(ops=0, held=True, broke_at=None)

    def spin():
        for k in cards:
            with torch.cuda.device(k):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                torch.cuda._sleep(cycles)
                b.record()
                spins[k].append((a, b))

    def still_held(where):
        if state["held"] and any(spins[k][-1][1].query() for k in cards):
            state.update(held=False, broke_at=where)

    class Segments(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            state["ops"] += 1
            if state["ops"] % SEGMENT == 0:
                still_held(str(func))
                spin()
            return func(*args, **(kwargs or {}))

    end = {}
    cls_sync = r._sync

    def mark():
        still_held("the end of the frame")
        for k in cards:
            with torch.cuda.device(k):
                end[k] = torch.cuda.Event(enable_timing=True)
                end[k].record()
        cls_sync()

    with Segments():                # the mode's first use costs the host
        torch.ones(1).add_(1)       # seconds: keep it out of the frame
    state["ops"] = 0
    r._sync = mark
    try:
        spin()
        with Segments():
            r.step(1)
    finally:
        del r._sync
    card_ms = {k: spins[k][0][0].elapsed_time(end[k])
               - sum(a.elapsed_time(b) for a, b in spins[k]) for k in cards}
    return dict(held=state["held"], broke_at=state["broke_at"],
                ops=state["ops"], spins=len(spins[cards[0]]),
                card_ms=card_ms)


def frame_inputs(n_tris, cell):
    from unityraytracer_tpu_torch.models import fixtures
    from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel

    scene = fixtures.bench_scene(n_tris=n_tris)
    cam = fixtures.bench_camera(aspect=cell["width"] / cell["height"])
    return scene, cam, build_cluster_accel(scene.triangles, cluster_size=64)


def one_card_phase(cards, scene, cam, accel, cell, impl, frames, log,
                   preview: bool) -> dict:
    """Phase 1 under ``impl``."""
    import numpy as np
    import torch

    from unityraytracer_tpu_torch import RenderConfig, Renderer

    cfg = RenderConfig(**cell, tracer="pallas", rng_impl=impl)
    last, first = (Renderer(scene, cam, cfg, accel=accel, seed=0, device=d)
                   for d in (cards[-1], cards[0]))
    la = {"last": counted_step(last), "first": counted_step(first)}
    for name, d in (("last", cards[-1]), ("first", cards[0])):
        if d.type == "cuda" and set(la[name]) != {d.index}:
            raise AssertionError(f"a frame of Renderer(device={d}) launched "
                                 f"on cards {sorted(la[name])}: {la[name]}")
    out = dict(launches=la, ms=in_turns({"last": last, "first": first},
                                        frames))
    same = bool(np.array_equal(last.image, first.image))
    out["bit_equal"] = same
    log(f"one_card_{impl}", out)
    if not (same and np.isfinite(last.image).all() and last.image.max() > 0):
        raise AssertionError(f"Renderer(device={cards[-1]}) under {impl}: "
                             f"image bit-equal to card 0's {same}")
    if preview:
        from unityraytracer_tpu_torch import _build

        res = {}
        for name, r in (("last", last), ("first", first)):
            _build.CARD_LAUNCHES.clear()
            aov = r.aovs()
            den = r.denoised_image(guided=True)
            sync([r.device])
            res[name] = (aov, den, {k: {n: c for n, c in v.items() if c}
                                    for k, v in _build.CARD_LAUNCHES.items()})
        same_aov = all(torch.equal(res["last"][0][k].cpu(),
                                   res["first"][0][k].cpu())
                       for k in res["first"][0])
        same_den = bool(np.array_equal(res["last"][1], res["first"][1]))
        pv = dict(launches_last=res["last"][2], aovs_equal=same_aov,
                  denoised_equal=same_den)
        log("one_card_preview", pv)
        d = cards[-1]
        want = {d.index: {"trace": 2, "atrous": 3}} if d.type == "cuda" \
            else {}
        if not (same_aov and same_den and res["last"][2] == want):
            raise AssertionError(f"aovs()/denoised_image() on {d}: {pv}")
        out["preview"] = pv
    del last, first
    return out


def one_card_frames(one, frames: int) -> dict:
    """``frames`` ``step(1)`` frames of the one-card renderer ``one``: the
    spread of all but the first."""
    ms = [one.step(1).stats["ms_per_frame"] for _ in range(frames)]
    return spread(ms[1:] or ms)


def meshes_of(mode, cards):
    from unityraytracer_tpu_torch.parallel.sharding import make_mesh2

    n = len(cards)
    logical = [cards[0]] * n
    if mode == "rows_scene":
        return {"cards": make_mesh2(n // 2, 2, cards),
                "logical": make_mesh2(n // 2, 2, logical)}
    return {"cards": list(cards), "logical": logical}


def mode_phase(mode, cards, scene, cam, accel, cell, impl, frames,
               log) -> dict:
    """Phase 2: one mode under ``impl``, the cards against logical shards."""
    import numpy as np

    from unityraytracer_tpu_torch import RenderConfig, Renderer
    from unityraytracer_tpu_torch.parallel.sharding import ShardedRenderer
    from unityraytracer_tpu_torch.utils.image import rmse

    tracer = "pallas" if mode in ("rows", "spp") else "cluster"
    cfg = RenderConfig(**cell, tracer=tracer, rng_impl=impl)
    rs, out = {}, {"peak_mib": {}, "launches": {}}
    for name, mesh in meshes_of(mode, cards).items():
        with peak_mib(mesh, out["peak_mib"].setdefault(name, {})):
            t0 = time.perf_counter()
            rs[name] = ShardedRenderer(
                scene, cam, cfg, mesh=mesh, seed=0, mode=mode,
                accel=accel if tracer == "pallas" else None)
            out.setdefault("setup_s", {})[name] = time.perf_counter() - t0
            out["launches"][name] = counted_step(rs[name])
        if sorted(out["launches"][name]) != cuda_of(mesh):
            raise AssertionError(f"{mode} on {name}: a frame launched on "
                                 f"cards {sorted(out['launches'][name])}")
    out["ms"] = in_turns(rs, frames)
    out["queued"], out["busy"] = {}, {}
    for name, r in rs.items():
        q = queued_frame(r)
        out["queued"][name] = q
        out["busy"][name] = {k: v / out["ms"][name]["median"]
                             for k, v in q.get("card_ms", {}).items()}
    for name, r in rs.items():
        prof = r.profile(1)
        out.setdefault("profile", {})[name] = dict(
            total_ms=prof.total_ms, stages_ms=prof.stages_ms)
    imgs = {name: r.image for name, r in rs.items()}
    same = bool(np.array_equal(imgs["cards"], imgs["logical"]))
    out["bit_equal"] = same
    ok = same and np.isfinite(imgs["cards"]).all() and imgs["cards"].max() > 0
    if mode == "scene":
        one = Renderer(scene, cam, cfg, accel=accel, seed=0, device=cards[0])
        out["one_card_ms"] = one_card_frames(one, rs["cards"].sample_count)
        e = rmse(imgs["cards"], one.image)
        out["vs_one_card"] = dict(rmse=e, max_abs=float(
            np.abs(imgs["cards"] - one.image).max()), bit_equal=bool(
            np.array_equal(imgs["cards"], one.image)))
        ok = ok and e < 1e-3
        del one
    log(f"{mode}_{impl}", out)
    if not ok:
        raise AssertionError(f"{mode} under {impl}: the cards' image "
                             f"bit-equal to the logical shards' {same}, "
                             f"{out.get('vs_one_card')}")
    return out


def combine_phase(cards, scene, cell, cam, log) -> dict:
    """Phase 3: the combine of the n scene shards' hits onto card 0."""
    import torch

    from unityraytracer_tpu_torch import RenderConfig
    from unityraytracer_tpu_torch.ops.cuda_trace import trace_hits
    from unityraytracer_tpu_torch.parallel.scene_shard import (
        allreduce_hit, on_device, shard_kernel_scenes, shard_scene_accels)
    from unityraytracer_tpu_torch.render import pixel_center_rays

    cfg = RenderConfig(**cell, tracer="cluster")
    stacked = shard_scene_accels(scene, cfg, len(cards))
    dev = cards[0]
    ro, rd = pixel_center_rays(cam, cell["height"], cell["width"], dev)
    out = {}
    for name, mesh in meshes_of("scene", cards).items():
        hits = []
        for ks in shard_kernel_scenes(scene, stacked, mesh):
            with on_device(ks.device):
                hits.append(trace_hits(ks, tuple(c.to(ks.device) for c in ro),
                                       tuple(c.to(ks.device) for c in rd)))
        blocks = [torch.stack([h.t, *h.position, *h.normal, *h.albedo,
                               *h.specular, *h.emission, h.smoothness])
                  for h in hits]
        allreduce_hit(hits, dev)
        sync(mesh)
        t0 = time.perf_counter()
        for _ in range(COMBINE_CALLS):
            allreduce_hit(hits, dev)
        sync(mesh)
        combine = (time.perf_counter() - t0) / COMBINE_CALLS * 1e3
        [b.to(dev) for b in blocks]
        sync(mesh)
        t0 = time.perf_counter()
        for _ in range(COMBINE_CALLS):
            [b.to(dev) for b in blocks]
        sync(mesh)
        one_copy = (time.perf_counter() - t0) / COMBINE_CALLS * 1e3
        moved = sum(b.numel() * b.element_size() for b in blocks
                    if b.device != dev)
        out[name] = dict(combine_ms=combine, one_copy_a_shard_ms=one_copy,
                         bytes_to_card0=moved,
                         one_copy_gb_s=moved / one_copy / 1e6 if moved else
                         None)
        del hits, blocks
    log("combine", out)
    return out


def checkpoint_phase(cards, scene, cam, accel, cell, log) -> dict:
    """Phase 4: a checkpoint of the n-card mesh resumed on one card."""
    import numpy as np

    from unityraytracer_tpu_torch import RenderConfig, Renderer
    from unityraytracer_tpu_torch.parallel.sharding import ShardedRenderer

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = RenderConfig(**cell, tracer="cluster")
        sr = ShardedRenderer(scene, cam, cfg, mesh=cards, seed=3,
                             mode="scene").step(2)
        path = sr.save_state(os.path.join(tmp, "scene.npz"))
        one = Renderer(scene, cam, cfg, accel=accel, seed=99,
                       device=cards[0]).load_state(path)
        sr.step(1)
        one.step(1)
        out["scene_to_renderer"] = bool(np.array_equal(sr.image, one.image))
        cfg = RenderConfig(**cell, tracer="pallas")
        sr = ShardedRenderer(scene, cam, cfg, mesh=cards, accel=accel, seed=3,
                             mode="rows").step(2)
        path = sr.save_state(os.path.join(tmp, "rows.npz"))
        lr = ShardedRenderer(scene, cam, cfg, mesh=[cards[0]] * len(cards),
                             accel=accel, seed=99,
                             mode="rows").load_state(path)
        sr.step(1)
        lr.step(1)
        out["rows_to_logical"] = bool(np.array_equal(sr.image, lr.image))
        out["samples"] = one.sample_count
    log("checkpoint", out)
    if not (out["scene_to_renderer"] and out["rows_to_logical"]):
        raise AssertionError(f"checkpoint resumed on one card: {out}")
    return out


def cli_in_process(argv):
    """``main(argv)`` of the command line here -> (exit code, stdout, the
    renderer it built)."""
    import unityraytracer_tpu_torch.__main__ as cli

    built, make = [], cli._make_renderer
    cli._make_renderer = lambda args: built.append(make(args)) or built[-1]
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            rc = cli.main(argv)
    finally:
        cli._make_renderer = make
    return rc, text.getvalue(), built[0]


def cli_child(argv) -> tuple:
    """``python3 -m unityraytracer_tpu_torch *argv`` -> (exit code, wall s
    from start to exit, stdout, stderr)."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "unityraytracer_tpu_torch",
                        *argv], cwd=HERE, capture_output=True, text=True,
                       timeout=600)
    return p.returncode, time.perf_counter() - t0, p.stdout, p.stderr


def cli_phase(cards, n_tris, cell, log) -> dict:
    """Phase 5: the command line on the last card and over every card."""
    import torch

    base = ["render", "--scene", "bench", "--tris", str(n_tris), "--width",
            str(cell["width"]), "--height", str(cell["height"]), "--bounces",
            str(cell["bounces"]), "--frames", "4"]
    on_card = cards[0].type == "cuda"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        def png(tag):
            return os.path.join(tmp, f"{tag}.png")

        def read(tag):
            with open(png(tag), "rb") as f:
                return f.read()

        accum = {}
        for tag, d in (("last", cards[-1]), ("first", cards[0])):
            rc, text, r = cli_in_process(base + ["--device", str(d), "-o",
                                                 png(tag)])
            if rc != 0 or r.state.accum.device != d:
                raise AssertionError(f"render --device {d}: exit {rc}, "
                                     f"accumulator on {r.state.accum.device}")
            accum[tag] = r.state.accum.cpu()
            del r
        same = bool(torch.equal(accum["last"], accum["first"]))
        rc, wall, text, err = cli_child(base + ["--device", str(cards[-1]),
                                                "-o", png("child")])
        child_same = rc == 0 and read("child") == read("first")
        out["device_last"] = dict(accum_bit_equal=same, child_rc=rc,
                                  child_wall_s=wall,
                                  child_png_equal=child_same,
                                  child_stdout=text.strip())
        if not (same and child_same):
            raise AssertionError(f"render --device {cards[-1]}: "
                                 f"{out['device_last']} {err[-2000:]}")
        rc, wall, text, err = cli_child(["info", "--scene", "bench", "--tris",
                                         str(n_tris)])
        n = len(cuda_of(cards))
        listed = f"count: {n}" in text if on_card else "device: cpu" in text
        out["info"] = dict(child_rc=rc, child_wall_s=wall,
                           stdout=text.strip())
        if rc != 0 or not listed:
            raise AssertionError(f"info: exit {rc}, {text!r} {err[-2000:]}")
        device = [] if on_card else ["--device", str(cards[0])]
        for mode in ("rows", "scene"):
            argv = base + ["--shard", mode] + device
            rc_in, _, r = cli_in_process(argv + ["-o", png(f"{mode}_in")])
            mesh = [str(d) for d in getattr(r, "mesh")]
            del r
            rc, wall, text, err = cli_child(argv + ["-o", png(mode)])
            same = rc == 0 and rc_in == 0 and read(mode) == read(f"{mode}_in")
            out[f"shard_{mode}"] = dict(mesh=mesh, child_rc=rc,
                                        child_wall_s=wall, png_equal=same,
                                        child_stdout=text.strip())
            if not same:
                raise AssertionError(f"render --shard {mode}: "
                                     f"{out[f'shard_{mode}']} {err[-2000:]}")
    log("cli", out)
    return out


def large_phase(cards, big_tris, cell, gate, frames, log) -> dict:
    """Phase 6: the big scene split over the cards."""
    import numpy as np

    from unityraytracer_tpu_torch import RenderConfig, Renderer
    from unityraytracer_tpu_torch.models import fixtures
    from unityraytracer_tpu_torch.parallel.sharding import ShardedRenderer
    from unityraytracer_tpu_torch.utils.image import rmse

    t0 = time.perf_counter()
    scene, cam, accel = frame_inputs(big_tris, cell)
    out = {"triangles": scene.num_triangles,
           "host_build_s": time.perf_counter() - t0}
    gcam = fixtures.bench_camera(aspect=gate["width"] / gate["height"])
    gcfg = RenderConfig(**gate, tracer="pallas")
    imgs, part = {}, {}
    for k in (2, 4):
        meshes = {"logical": [cards[0]] * k}
        if k <= len(cards):
            meshes["cards"] = list(cards[:k])
        for name, mesh in meshes.items():
            rec = {}
            with peak_mib(mesh, rec.setdefault("peak_mib", {})):
                t0 = time.perf_counter()
                sr = ShardedRenderer(scene, gcam, gcfg, mesh=mesh,
                                     seed=GATE_SEED, mode="scene")
                rec["setup_s"] = time.perf_counter() - t0
                rec["launches"] = counted_step(sr)
            if sorted(rec["launches"]) != cuda_of(mesh):
                raise AssertionError(f"gate2m_part on {name}: a frame "
                                     f"launched on {sorted(rec['launches'])}")
            rec["frame_ms"] = sr.stats["ms_per_frame"]
            imgs[(name, k)] = sr.image
            part[f"{name}_{k}"] = rec
            del sr
    one = Renderer(scene, gcam, gcfg, accel=accel, seed=GATE_SEED,
                   device=cards[0]).step(1)
    first = next(iter(imgs.values()))
    exact = all(np.array_equal(first, im) for im in imgs.values())
    e = rmse(first, one.image)
    out["gate2m_part"] = dict(shards=part, bit_exact=exact,
                              images=[f"{a}_{b}" for a, b in imgs],
                              vs_one_card_pallas_rmse=e)
    log("gate2m_part", out["gate2m_part"])
    if not (exact and np.isfinite(first).all() and first.max() > 0
            and e < 1e-3):
        raise AssertionError(f"gate2m_part on the cards: bit-exact {exact}, "
                             f"RMSE against one card {e}")
    del one, imgs
    cfg = RenderConfig(**cell, tracer="cluster", rng_impl="rbg")
    rs, rec = {}, {"peak_mib": {}, "launches": {}}
    for name, mesh in meshes_of("scene", cards).items():
        with peak_mib(mesh, rec["peak_mib"].setdefault(name, {})):
            t0 = time.perf_counter()
            rs[name] = ShardedRenderer(scene, cam, cfg, mesh=mesh, seed=0,
                                       mode="scene")
            rec.setdefault("setup_s", {})[name] = time.perf_counter() - t0
            rec["launches"][name] = counted_step(rs[name])
        if sorted(rec["launches"][name]) != cuda_of(mesh):
            raise AssertionError(f"big scene on {name}: a frame launched on "
                                 f"cards {sorted(rec['launches'][name])}")
    rec["ms"] = in_turns(rs, frames)
    rec["queued"] = {name: queued_frame(r) for name, r in rs.items()}
    rec["busy"] = {name: {k: v / rec["ms"][name]["median"]
                          for k, v in q.get("card_ms", {}).items()}
                   for name, q in rec["queued"].items()}
    one = Renderer(scene, cam, cfg, accel=accel, seed=0, device=cards[0])
    rec["one_card_ms"] = one_card_frames(one, rs["cards"].sample_count)
    a, b = rs["cards"].image, rs["logical"].image
    rec["bit_equal"] = bool(np.array_equal(a, b))
    rec["vs_one_card"] = dict(rmse=rmse(a, one.image), bit_equal=bool(
        np.array_equal(a, one.image)))
    out["scene_1080p"] = rec
    log("big_scene_1080p", rec)
    if not (rec["bit_equal"] and np.isfinite(a).all()
            and rec["vs_one_card"]["rmse"] < 1e-3):
        raise AssertionError(f"the big scene on the cards: bit-equal to the "
                             f"logical shards {rec['bit_equal']}, "
                             f"{rec['vs_one_card']}")
    return out


def run(cards, n_tris=N_TRIS, big_tris=BIG_TRIS, cell=CELL, gate=GATE,
        frames=FRAMES, impls=IMPLS, log=None) -> dict:
    """Every phase on the devices ``cards`` (two or more); raises when a
    check fails. Returns the measurements by key, each also passed to
    ``log(key, value)`` as it is taken (default: printed)."""
    import torch

    from unityraytracer_tpu_torch.parallel.sharding import make_mesh

    cards = make_mesh(cards)
    if len(cards) < 2:
        raise ValueError(f"run() needs two or more devices, got {cards}")
    out = {"cards": [str(d) for d in cards]}

    def note(key, value):
        out[key] = value
        if log is None:
            print(key, json.dumps(value, default=str), flush=True)
        else:
            log(key, value)

    t_all = time.perf_counter()
    scene, cam, accel = frame_inputs(n_tris, cell)
    for impl in impls:
        one_card_phase(cards, scene, cam, accel, cell, impl, frames, note,
                       preview=impl == impls[0])
    for impl in impls:
        for mode in MODES:
            mode_phase(mode, cards, scene, cam, accel, cell, impl, frames,
                       note)
            if cards[0].type == "cuda":
                torch.cuda.empty_cache()
    combine_phase(cards, scene, cell, cam, note)
    checkpoint_phase(cards, scene, cam, accel, cell, note)
    cli_phase(cards, n_tris, cell, note)
    del scene, accel
    large_phase(cards, big_tris, cell, gate, frames, note)
    note("seconds", time.perf_counter() - t_all)
    return out


def frame_main(frames=FRAMES) -> int:
    """``frame``: the one-card main frame under each impl on card 0."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("shard_scaling frame: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from unityraytracer_tpu_torch import RenderConfig, Renderer

    from unityraytracer_tpu_torch import _build

    if hasattr(_build, "on_card"):
        # The launch guard's host cost: entering and leaving it on the card
        # that is already current, as every launch of a one-card frame does.
        dev = torch.device("cuda", 0)
        calls = 100_000
        t0 = time.perf_counter()
        for _ in range(calls):
            with _build.on_card(dev):
                pass
        print(json.dumps(dict(tree=HERE, guard_us=(time.perf_counter() - t0)
                              / calls * 1e6)), flush=True)
    scene, cam, accel = frame_inputs(N_TRIS, CELL)
    for impl in IMPLS:
        cfg = RenderConfig(**CELL, tracer="pallas", rng_impl=impl)
        r = Renderer(scene, cam, cfg, accel=accel, seed=0,
                     device="cuda:0").step(1)
        ms = []
        for _ in range(frames):
            ms.append(r.step(1).stats["ms_per_frame"])
        print(json.dumps(dict(tree=HERE, impl=impl, median=float(
            np.median(ms)), min=min(ms), max=max(ms), ms=ms)), flush=True)
    print(card_line())
    return 0


def main(argv) -> int:
    import torch

    if argv[1:] == ["frame"]:
        return frame_main()
    if argv[1:]:
        print(__doc__, file=sys.stderr)
        return 2
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"shard_scaling: torch sees {n} CUDA device(s); this needs two "
              "or more", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from unityraytracer_tpu_torch import _build, native

    cards = card_line()
    print(cards, flush=True)
    peer = [[None if i == j else torch.cuda.can_device_access_peer(i, j)
             for j in range(n)] for i in range(n)]
    print("peer_access", json.dumps(peer), flush=True)
    for query in (["topo", "-m"], ["nvlink", "--status"]):
        res = subprocess.run(["nvidia-smi", *query], capture_output=True,
                             text=True, timeout=60)
        print(f"nvidia-smi {' '.join(query)} (exit {res.returncode}):\n"
              f"{res.stdout}{res.stderr}", flush=True)
    t0 = time.perf_counter()
    _build.lib()
    native.build()
    print("build_s", time.perf_counter() - t0, flush=True)
    out = run([torch.device("cuda", i) for i in range(n)])
    print(cards)
    print(json.dumps({"ok": True, "cards": cards.splitlines(),
                      "peer_access": peer, **out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
