"""Multi-device rendering: framebuffer, sample and scene sharding.

The port of the JAX package's ``parallel/sharding.py``, with its four modes:

* ``"rows"``: each shard renders a disjoint horizontal band of the image
  with its own stream, ``fold_in(frame key, shard)``; scene and accel are
  replicated, and each band's accumulator stays on its shard's device.
* ``"spp"``: each shard renders the whole frame with its own stream; the
  frames are averaged (the JAX ``pmean``).
* ``"scene"``: each shard holds 1/n of the triangles
  (``scene_shard.py``); the bounce loop shades once, and every bounce
  traces all rays on every shard and combines the closest hits. All shards
  share the frame key.
* ``"rows_scene"``: a 2-D mesh, bands on its rows and triangle shards on
  its columns; band i folds in its row index only, so every shard of a band
  traces the same rays.

One process drives the mesh, as JAX's single controller does. A mesh is a
list of ``torch.device``s (``"rows_scene"``: a list of rows of them), and a
device may repeat: each entry is one logical shard. ``make_mesh()`` takes
every CUDA device and raises where torch sees none; the CPU tests pass
``["cpu"] * 8``, and ``[cuda:0] * 4`` runs the scene combine at full width
on one card. Collectives are explicit copies to the mesh's first device (a
row's first device in ``"rows_scene"``) and the reduction there.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import _build, rng
from ..camera import Camera
from ..config import RenderConfig
from ..ops.bvh import build_accel, build_cluster_accel
from ..ops.cuda_trace import KernelScene
from ..render import (PreviewExportMixin, RenderState, progressive_step,
                      render_frame, render_sample)
from ..scene import Scene
from ..utils.image import tonemap_aces, write_png
from .scene_shard import (make_scene_sharded_tracer, on_device,
                          shard_kernel_scenes, shard_scene_accels,
                          shard_scene_pallas_accels)

MODES = ("rows", "spp", "scene", "rows_scene")


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """1-D mesh over all CUDA devices, or over ``devices`` (a device may
    repeat: each entry is one logical shard). Raises where no devices are
    given and torch sees no CUDA device; it never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(): torch sees no CUDA device; pass "
                               "devices=[...] (e.g. ['cpu'] * 8)")
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    mesh = [_device(d) for d in devices]
    if not mesh:
        raise ValueError("make_mesh(): no devices")
    return mesh


def make_mesh2(n_rows: int, n_scene: int,
               devices: Optional[Sequence] = None) -> List[List[torch.device]]:
    """2-D ``(rows, scene)`` mesh for mode ``"rows_scene"``: ``n_rows`` rows
    of ``n_scene`` devices, taken in order, so a row's triangle shards are
    neighbours."""
    devices = make_mesh(devices)
    if n_rows < 1 or n_scene < 1 or len(devices) < n_rows * n_scene:
        raise ValueError(f"need {n_rows} x {n_scene} devices, "
                         f"have {len(devices)}")
    return [devices[i * n_scene:(i + 1) * n_scene] for i in range(n_rows)]


def _flat(mesh) -> List[torch.device]:
    return [d for row in mesh for d in row] if isinstance(mesh[0], list) \
        else list(mesh)


@dataclasses.dataclass
class ShardedState:
    """Progressive state over a mesh: ``bands[i]`` is the (h, W, 3) running
    mean of band i on its row's first device (one whole-frame band in the
    replicated modes)."""

    bands: List[torch.Tensor]
    n_samples: int

    @property
    def accum(self) -> torch.Tensor:
        """The whole (H, W, 3) image, gathered on the first band's device."""
        dev = self.bands[0].device
        return torch.cat([b.to(dev) for b in self.bands])


def _band_devices(mesh, mode: str) -> List[torch.device]:
    if mode == "rows":
        return list(mesh)
    if mode == "rows_scene":
        return [row[0] for row in mesh]
    return [_flat(mesh)[0]]


def create_sharded_state(cfg: RenderConfig, mesh,
                         mode: str = "rows") -> ShardedState:
    """Zero state: one accumulator band per row shard on its device
    (``"rows"``, ``"rows_scene"``), one whole frame on the mesh's first
    device otherwise."""
    devs = _band_devices(mesh, mode)
    if cfg.height % len(devs):
        raise ValueError(f"height {cfg.height} not divisible by "
                         f"{len(devs)} devices")
    h = cfg.height // len(devs)
    return ShardedState(bands=[torch.zeros((h, cfg.width, 3),
                                           dtype=torch.float32, device=d)
                               for d in devs], n_samples=0)


def _accumulate(state: ShardedState, frames) -> ShardedState:
    """The 1/(N+1) running mean of every band (``progressive_step``)."""
    n = state.n_samples
    return ShardedState(
        bands=[progressive_step(RenderState(b, n), f).accum
               for b, f in zip(state.bands, frames)], n_samples=n + 1)


def make_sharded_step(cfg: RenderConfig, mesh, mode: str = "rows") -> Callable:
    """The progressive step over a mesh: ``step(state, scenes, camera,
    accels, key, n_frames=1) -> state``, where ``scenes[k]`` is the scene on
    flat shard k's device and ``accels[k]`` that shard's accel (the
    replicated ``KernelScene``, or None for ``"brute"``; in the scene modes
    the shard's own ``KernelScene``). Frame i renders at ``fold_in(key,
    n_samples + i)``, then band or shard k at ``fold_in(that, k)`` in
    ``"rows"``/``"spp"`` and band i at ``fold_in(that, i)`` in
    ``"rows_scene"``; ``"scene"`` uses the frame key itself."""
    if mode not in MODES:
        raise ValueError(f"unknown sharding mode {mode!r}")
    if mode in ("scene", "rows_scene") and cfg.tracer not in (
            "cluster", "bvh", "pallas"):
        raise ValueError(
            f"{mode} sharding traces per-shard accels (got "
            f"tracer={cfg.tracer!r}); use cluster/bvh/pallas (the per-bounce "
            "closest-hit kernel: the combine runs between bounces, so the "
            "path kernel cannot serve this mode)")
    two_d = isinstance(mesh[0], list)
    if two_d != (mode == "rows_scene"):
        raise ValueError(f"mode {mode!r} takes a "
                         f"{'2-D' if mode == 'rows_scene' else '1-D'} mesh")
    n_sc = len(mesh[0]) if two_d else len(mesh)
    n_bands = len(_band_devices(mesh, mode))
    h = cfg.height // n_bands

    def frame(scenes, camera, accels, key):
        """Each shard's (band's) frame on its device, launched with that
        device current."""
        if mode in ("rows", "spp"):
            frames = []
            for k in range(len(scenes)):
                with on_device(scenes[k].skybox.device):
                    frames.append(render_frame(
                        scenes[k], cfg, camera, rng.fold_in(key, k),
                        accels[k], **(dict(row0=k * h, rows=h)
                                      if mode == "rows" else {})))
            if mode == "rows":
                return frames
            dev = scenes[0].skybox.device
            total = frames[0]
            for f in frames[1:]:
                total = total + f.to(dev)
            return [total / len(scenes)]
        out = []
        for i in range(n_bands):
            group = slice(i * n_sc, (i + 1) * n_sc)
            tracer = make_scene_sharded_tracer(accels[group], cfg)
            with on_device(scenes[i * n_sc].skybox.device):
                out.append(render_sample(
                    scenes[i * n_sc], tracer, camera,
                    key if mode == "scene" else rng.fold_in(key, i), cfg,
                    row0=i * h, rows=h))
        return out

    def step(state: ShardedState, scenes, camera: Camera, accels, key,
             n_frames: int = 1) -> ShardedState:
        for _ in range(n_frames):
            sub = rng.fold_in(key, state.n_samples)
            state = _accumulate(state, frame(scenes, camera, accels, sub))
        return state

    return step


def gather_image(state: ShardedState) -> np.ndarray:
    """The whole accumulator on the host."""
    return state.accum.cpu().numpy()


class ShardedRenderer(PreviewExportMixin):
    """Progressive renderer over a mesh (``Renderer``'s surface: ``step``,
    ``profile``, ``image``, checkpoints, and the preview and export mixin).
    ``mesh`` defaults to every CUDA device (``"rows_scene"``: two columns);
    pass a list of devices to choose, repeats allowed."""

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig,
                 mesh=None, accel=None, seed: int = 0, mode: str = "rows"):
        if config.dispatch_bands is not None and config.dispatch_bands > 1:
            raise ValueError(
                f"dispatch_bands={config.dispatch_bands}: the bands apply to "
                "Renderer.step; a ShardedRenderer already renders each "
                "shard's band in one dispatch (set dispatch_bands=None)")
        if mesh is None:
            mesh = (make_mesh() if mode != "rows_scene"
                    else make_mesh2(len(make_mesh()) // 2, 2))
        elif isinstance(mesh[0], (list, tuple)):
            mesh = [make_mesh(row) for row in mesh]
        else:
            mesh = make_mesh(mesh)
        self.mesh, self.mode = mesh, mode
        self.camera, self.config = camera, config
        self._step = make_sharded_step(config, mesh, mode)
        shards = _flat(mesh)
        on = {}
        for d in shards:
            if d not in on:
                on[d] = scene.to(d)
        self.scenes = [on[d] for d in shards]
        self.scene = self.scenes[0]
        self._host_scene = scene
        if mode in ("scene", "rows_scene"):
            rows = mesh if mode == "rows_scene" else [mesh]
            if accel is None:
                split = (shard_scene_pallas_accels
                         if config.tracer == "pallas" else shard_scene_accels)
                accel = split(scene, config, len(rows[0]))
            self.accel = [ks for row in rows
                          for ks in shard_kernel_scenes(scene, accel, row)]
        else:
            if accel is None:
                accel = build_accel(scene, config)
            if isinstance(accel, KernelScene):
                accel = accel.accel
            replicas = {d: KernelScene.create(on[d], accel, d)
                        for d in on} if accel is not None else {}
            self.accel = [replicas.get(d) for d in shards]
        self._key = rng.key(seed, config.rng_impl)
        self.state = create_sharded_state(config, mesh, mode)
        self.stats = {}

    def _aov_accel(self):
        """The whole scene's accel for the single-device AOV trace: the
        replicated one, or in the scene modes (no shard holds the whole
        scene) a host LBVH built once."""
        if self.mode not in ("scene", "rows_scene"):
            return self.accel[0]
        if getattr(self, "_aov_accel_cache", None) is None:
            self._aov_accel_cache = KernelScene.create(
                self.scene, build_cluster_accel(
                    self._host_scene.triangles,
                    cluster_size=self.config.cluster_size),
                self.scene.skybox.device)
        return self._aov_accel_cache

    def _sync(self) -> None:
        for d in set(_flat(self.mesh)):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
                _build.raise_on_overflow(d)

    def step(self, n_frames: int = 1, fused: bool = True
             ) -> "ShardedRenderer":
        """Advance the progressive render by ``n_frames`` with the JAX
        package's key chains: ``fused=True`` splits the key once for the
        block, ``fused=False`` once per frame. Records synchronized
        throughput in ``self.stats`` (rays of the whole frame, as the JAX
        renderer counts them), then raises if a kernel overflowed its
        traversal stack."""
        t0 = time.perf_counter()
        if fused:
            self._key, sub = rng.split(self._key)
            self.state = self._step(self.state, self.scenes, self.camera,
                                    self.accel, sub, n_frames)
        else:
            for _ in range(n_frames):
                self._key, sub = rng.split(self._key)
                self.state = self._step(self.state, self.scenes, self.camera,
                                        self.accel, sub, 1)
        self._sync()
        dt = time.perf_counter() - t0
        rays = self.config.num_rays * self.config.bounces * n_frames
        self.stats = dict(frames=n_frames, seconds=dt,
                          ms_per_frame=dt / n_frames * 1000.0,
                          mrays_per_sec=rays / dt / 1e6)
        return self

    def profile(self, n_frames: int = 1):
        """Per-stage device-time breakdown (``utils/profiling.py``): one
        warm-up frame, then ``n_frames`` frames of ``step(1, fused=False)``
        inside the profiled window, on the mesh's first device."""
        from ..utils.profiling import profile_stages

        self.step(1)
        prof = profile_stages(lambda: self.step(n_frames, fused=False),
                              device=self.scene.skybox.device)
        self.stats["device"] = prof
        return prof

    @property
    def image(self) -> np.ndarray:
        return gather_image(self.state)

    @property
    def sample_count(self) -> int:
        return self.state.n_samples

    # -- export / checkpoint -------------------------------------------------
    def save_screenshot(self, path: Optional[str] = None,
                        tonemap: bool = True) -> str:
        """PNG of the gathered image (default name
        ``Screenshots/<time>-<sample>.png``)."""
        if path is None:
            os.makedirs("Screenshots", exist_ok=True)
            path = os.path.join(
                "Screenshots", f"{int(time.time())}-{self.sample_count}.png")
        img = self.image
        return write_png(path, tonemap_aces(img) if tonemap else img)

    def save_state(self, path: str) -> str:
        """Checkpoint the gathered accumulator, sample count and key as
        ``.npz`` (the format of both packages' renderers, resumable on any
        mesh)."""
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez(path, accum=self.image,
                 n_samples=np.int32(self.sample_count),
                 key=np.asarray(self._key, np.uint32))
        return path

    def load_state(self, path: str) -> "ShardedRenderer":
        """Resume from a checkpoint of either package; the image is split
        into this mesh's bands. Key data of the other ``rng_impl`` raises
        ``ValueError``."""
        with np.load(path) as data:
            accum = np.asarray(data["accum"], np.float32)
            want = (self.config.height, self.config.width, 3)
            if accum.shape != want:
                raise ValueError(f"checkpoint image {accum.shape} does not "
                                 f"match the config's {want}")
            key = rng.wrap_key_data(data["key"], self.config.rng_impl)
            devs = _band_devices(self.mesh, self.mode)
            h = self.config.height // len(devs)
            self.state = ShardedState(
                bands=[torch.as_tensor(accum[i * h:(i + 1) * h], device=d)
                       for i, d in enumerate(devs)],
                n_samples=int(data["n_samples"]))
            self._key = key
        return self
