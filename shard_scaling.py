#!/usr/bin/env python3
"""Sharded rendering across real cards against logical shards of one card.

    python3 shard_scaling.py

Needs two or more CUDA devices and uses every one torch sees (n). On the
main path's cell (1920x1080, 8 bounces, ``bench_scene(100_000)``, the
bench camera) it runs each mode on two meshes: ``make_mesh()`` (the n
cards) and ``make_mesh(["cuda:0"] * n)`` (n logical shards of card 0):

* ``ShardedRenderer(mode="scene", tracer="cluster")``: a warm-up frame,
  then FRAMES timed ``step(1)`` frames; its image against a one-card
  ``Renderer(tracer="cluster")`` of the same seed and steps (RMSE < 1e-3),
  and the two meshes' images bit-equal;
* the hit combine (``allreduce_hit``) of the n shards' hits of the
  2,073,600 pixel-centre rays onto card 0: host clock around 20 calls
  ended by a synchronize of every card, so the copies between cards count;
* ``"rows"`` and ``"spp"`` with the path kernel: timed frames, and the two
  meshes' images bit-equal.

It prints every card's name and power limit, one line a measurement and a
JSON object last. It exits non-zero with fewer than two cards or when a
check fails.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FRAMES = 8
CELL = dict(width=1920, height=1080, spp=1, bounces=8, wavefront=True,
            rr_group="step")


def sync(devices) -> None:
    import torch

    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run(real, logical, n_tris=100_000, cell=CELL, frames=FRAMES) -> dict:
    """Every measurement on the mesh ``real`` (None: ``make_mesh()``) and on
    ``logical``; raises when a check fails."""
    import numpy as np

    from unityraytracer_tpu_torch import RenderConfig, Renderer
    from unityraytracer_tpu_torch.models import fixtures
    from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
    from unityraytracer_tpu_torch.ops.cuda_trace import trace_hits
    from unityraytracer_tpu_torch.parallel.scene_shard import (allreduce_hit,
                                                               on_device)
    from unityraytracer_tpu_torch.parallel.sharding import (ShardedRenderer,
                                                            make_mesh)
    from unityraytracer_tpu_torch.render import pixel_center_rays
    from unityraytracer_tpu_torch.utils.image import rmse

    W, H = cell["width"], cell["height"]
    scene = fixtures.bench_scene(n_tris=n_tris)
    cam = fixtures.bench_camera(aspect=W / H)
    accel = build_cluster_accel(scene.triangles, cluster_size=64)
    meshes = {"cards": make_mesh(real), "logical": make_mesh(logical)}
    out = {"shards": len(meshes["cards"])}

    def timed(r):
        r.step(1)
        ms = []
        for _ in range(frames):
            r.step(1)
            ms.append(r.stats["ms_per_frame"])
        return dict(median=float(np.median(ms)), min=min(ms), max=max(ms))

    def log(key, value):
        out[key] = value
        print(key, json.dumps(value), flush=True)

    cfg = RenderConfig(**cell, tracer="cluster")
    one = Renderer(scene, cam, cfg, accel=accel, seed=0,
                   device=meshes["cards"][0])
    log("one_card_cluster_ms", timed(one))
    images = {}
    for name, mesh in meshes.items():
        r = ShardedRenderer(scene, cam, cfg, mesh=mesh, seed=0, mode="scene")
        log(f"scene_{name}_ms", timed(r))
        images[name] = r.image
        e, worst = rmse(images[name], one.image), float(
            np.abs(images[name] - one.image).max())
        log(f"scene_{name}_vs_one_card", dict(rmse=e, max_abs=worst))
        if not (np.isfinite(images[name]).all() and e < 1e-3):
            raise AssertionError(f"scene on {name}: RMSE {e}")
        ro, rd = pixel_center_rays(cam, H, W, mesh[0])
        hits = []
        for ks in r.accel:
            with on_device(ks.device):
                hits.append(trace_hits(ks, tuple(c.to(ks.device) for c in ro),
                                       tuple(c.to(ks.device) for c in rd)))
        allreduce_hit(hits, mesh[0])
        sync(mesh)
        t0 = time.perf_counter()
        for _ in range(20):
            allreduce_hit(hits, mesh[0])
        sync(mesh)
        log(f"combine_{name}_ms", (time.perf_counter() - t0) / 20 * 1e3)
        del r, hits
    if not np.array_equal(images["cards"], images["logical"]):
        raise AssertionError("scene: the cards' image differs from the "
                             "logical shards'")
    for mode in ("rows", "spp"):
        cfg = RenderConfig(**cell, tracer="pallas")
        images = {}
        for name, mesh in meshes.items():
            r = ShardedRenderer(scene, cam, cfg, mesh=mesh, accel=accel,
                                seed=0, mode=mode)
            log(f"{mode}_{name}_ms", timed(r))
            images[name] = r.image
            del r
        if not (np.isfinite(images["cards"]).all() and np.array_equal(
                images["cards"], images["logical"])):
            raise AssertionError(f"{mode}: the cards' image differs from "
                                 "the logical shards'")
    return out


def main() -> int:
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"shard_scaling: torch sees {n} CUDA device(s); this needs two "
              "or more", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60).stdout.strip()
    print(cards, flush=True)
    out = run(None, [torch.device("cuda", 0)] * n)
    print(cards)
    print(json.dumps({"ok": True, "cards": cards.splitlines(), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
