"""Frame rendering: path-traced sample pass + progressive accumulation.

The port of the JAX package's ``render.py``:

* ``render_sample``: one frame of ``spp`` jittered camera rays per pixel,
  bounced ``bounces`` times through a tracer (``"brute"`` or the
  closest-hit kernel), with wavefront parking and Russian roulette.
* ``render_sample_mega``: the same frame through the path kernel — every
  bounce in one launch, fed the same uniform rows.
* ``progressive_step``: the 1/(N+1) running mean.
* ``Renderer``: the stateful frame loop with the JAX package's key chains.

Every random number is drawn with ``rng.py`` from the same keys in the same
layout as the JAX package (the block-native ``_draw_fn`` convention), so a
port render and a JAX render of one seed agree pixel for pixel.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import _build, rng
from .camera import Camera, camera_rays_soa
from .config import RenderConfig
from .ops import vec as vec_ops
from .ops import trace as trace_ops
from .ops.bvh import ClusterAccel, build_accel
from .ops.cuda_env import sample_skybox_tap
from .ops.cuda_path import path_trace
from .ops.cuda_trace import KernelScene, make_pallas_tracer
from .ops.sampling import sample_unit_disk
from .ops.shade import sample_skybox, sample_skybox_rgbe, shade
from .scene import Scene
from .utils.image import tonemap_aces, write_png

# Rays run in 8x16 pixel-block order on the megakernel path, as in the JAX
# package (MEGA_BLOCKED); the uniforms follow the block-native convention.
MEGA_BLOCKED = True


@dataclasses.dataclass
class RenderState:
    """Progressive accumulation state."""

    accum: torch.Tensor   # (H, W, 3) running mean, linear radiance
    n_samples: int        # frames accumulated

    @staticmethod
    def create(width: int, height: int, device="cpu") -> "RenderState":
        return RenderState(accum=torch.zeros((height, width, 3),
                                             dtype=torch.float32,
                                             device=device),
                           n_samples=0)


def _scene_device(scene: Scene) -> torch.device:
    return scene.skybox.device


def get_tracer(scene: Scene, cfg: RenderConfig, accel=None) -> Callable:
    """Resolve cfg.tracer to a ``fn(ro, rd, alive, bin_rays) -> Hit``."""
    if cfg.tracer == "brute":
        return trace_ops.make_brute_tracer(scene, chunk=cfg.ray_chunk)
    if accel is None:
        accel = build_accel(scene, cfg)
    return make_pallas_tracer(scene, accel)


def _uniform(key, n: int, device):
    return rng.uniform(key, (n,), device=device)


def _rr_uniform(key, cfg: RenderConfig, spp: int, h: int, W: int,
                row0: int, to_blocks: Callable, device) -> torch.Tensor:
    """Russian-roulette uniforms, per ray or shared per (8, 128)-pixel group
    on absolute output coordinates (cfg.rr_group == "step")."""
    N = spp * h * W
    if cfg.rr_group != "step":
        return to_blocks(_uniform(key, N, device))
    Hg = (cfg.height + 7) // 8
    Wg = (W + 127) // 128
    ug = rng.uniform(key, (spp, Hg, Wg), device=device)
    full = ug[:, :, None, :, None].expand(spp, Hg, 8, Wg, 128) \
        .reshape(spp, Hg * 8, Wg * 128)
    band = full[:, row0:row0 + h, :W]
    return to_blocks(band.reshape(N))


def _ray_lattice(h: int, W: int, spp: int, blocked: bool, device):
    """Per-ray pixel coordinates (px, row-in-band) as (N,) int32 in ray
    order: 8x16 pixel-block order when ``blocked``, row-major otherwise."""
    N = spp * h * W
    n = torch.arange(N, dtype=torch.int32, device=device)
    if blocked:
        w16 = W // 16
        px = (n // 128) % w16 * 16 + n % 16
        row = (n // (128 * w16)) % (h // 8) * 8 + (n // 16) % 8
    else:
        px = n % W
        row = (n // W) % h
    return px, row


def _draw_fn(h: int, W: int, spp: int, blocked: bool):
    """Canonical per-ray uniform assignment shared by every tracer path: at
    sizes that tile into 8x16 blocks, pixel p's draw is the flat element at
    p's block slot. Returns ``f(flat_draw) -> draw in ray-layout order``."""
    N = spp * h * W
    if blocked or not (h % 8 == 0 and W % 16 == 0):
        return lambda a: a

    def to_pixel_order(a):
        return (a.reshape(spp, h // 8, W // 16, 8, 16)
                .permute(0, 1, 3, 2, 4).reshape(N))
    return to_pixel_order


def _block_permutes(h: int, W: int, spp: int, blocked: bool):
    N = spp * h * W
    if not blocked:
        return (lambda a: a), (lambda a: a.reshape(spp, h, W))

    def to_blocks(a):
        return (a.reshape(spp, h // 8, 8, W // 16, 16)
                .permute(0, 1, 3, 2, 4).reshape(N))

    def from_blocks(a):
        return (a.reshape(spp, h // 8, W // 16, 8, 16)
                .permute(0, 1, 3, 2, 4).reshape(spp, h, W))
    return to_blocks, from_blocks


def _camera_rays(camera, key, cfg, h, W, spp, row0, blocked, draw, device):
    """Jittered thin-lens camera rays in ray-layout order (keys k_jit,
    k_lens of the frame key, as in the JAX package)."""
    H = cfg.height
    N = spp * h * W
    k_jit, k_lens, k_bounce = rng.split(key, 3)
    px, prow = _ray_lattice(h, W, spp, blocked, device)
    py = (H - 1) - (row0 + prow)
    jx = draw(_uniform(rng.fold_in(k_jit, 0), N, device))
    jy = draw(_uniform(rng.fold_in(k_jit, 1), N, device))
    u = (px.to(torch.float32) + jx) / W * 2.0 - 1.0
    v = (py.to(torch.float32) + jy) / H * 2.0 - 1.0
    lu1 = draw(_uniform(rng.fold_in(k_lens, 0), N, device))
    lu2 = draw(_uniform(rng.fold_in(k_lens, 1), N, device))
    lens_u, lens_v = sample_unit_disk(lu1, lu2)
    ro, rd = camera_rays_soa(camera, u, v, lens_u, lens_v)
    return ro, rd, k_bounce


def _sky_uniforms(cfg, k_bounce, uniform):
    if not cfg.sky_rgbe:
        return None, None
    ks = rng.fold_in(k_bounce, cfg.bounces)
    return uniform(rng.fold_in(ks, 0)), uniform(rng.fold_in(ks, 1))


def _env_tap(scene: Scene, cfg: RenderConfig, sky_d, su1, su2):
    """Once-per-frame environment resolve for the recorded miss directions:
    one stochastic RGBE tap per ray, through the env kernel when
    ``cfg.sky_mxu`` (bit-identical to the plain gather); the bilinear float
    sky without ``sky_rgbe``."""
    if su1 is None:
        return sample_skybox(scene.skybox, sky_d)
    H, W = scene.skybox.shape[0], scene.skybox.shape[1]
    if cfg.sky_mxu and scene.skybox_rgbe is not None:
        return sample_skybox_tap((H, W), scene.skybox_rgbe, sky_d, su1, su2)
    return sample_skybox_rgbe(scene.skybox, sky_d, u1=su1, u2=su2,
                              packed=scene.skybox_rgbe)


def render_sample(scene: Scene, tracer: Callable, camera: Camera, key,
                  cfg: RenderConfig, row0: int = 0,
                  rows: Optional[int] = None,
                  with_alive_count: bool = False):
    """Render one frame band: (rows, W, 3) linear radiance, mean over spp.

    Row 0 is the top of the image. ``with_alive_count``: also return the
    summed per-bounce count of rays entering each bounce.
    """
    H, W, spp = cfg.height, cfg.width, cfg.spp
    h = H if rows is None else rows
    N = h * W * spp
    device = _scene_device(scene)

    blocked = cfg.tracer == "pallas" and h % 8 == 0 and W % 16 == 0
    draw = _draw_fn(h, W, spp, blocked)
    ro, rd, k_bounce = _camera_rays(camera, key, cfg, h, W, spp, row0,
                                    blocked, draw, device)
    to_blocks, from_blocks = _block_permutes(h, W, spp, blocked)

    def uniform(key_):
        return draw(_uniform(key_, N, device))

    one = torch.ones(N, dtype=torch.float32, device=device)
    zero = torch.zeros(N, dtype=torch.float32, device=device)
    energy = (one, one, one)
    radiance = (zero, zero, zero)
    sky_e = (zero, zero, zero)
    sky_d = (zero, one, zero)

    alive = torch.ones(N, dtype=torch.bool, device=device)
    alive_total = torch.zeros((), dtype=torch.float32, device=device)
    for b in range(cfg.bounces):
        if with_alive_count:
            alive_total = alive_total + alive.to(torch.float32).sum()
        hit = tracer(ro, rd, alive, bin_rays=False)
        kb = rng.fold_in(k_bounce, b)
        uniforms = tuple(uniform(rng.fold_in(kb, i)) for i in range(3))
        energy_before = energy
        ro, rd_new, energy, contrib, missed = shade(ro, rd, energy, hit,
                                                    uniforms)
        radiance = vec_ops.add(radiance, contrib)
        record = missed & alive
        sky_e = vec_ops.where(record, energy_before, sky_e)
        sky_d = vec_ops.where(record, rd, sky_d)
        rd = rd_new
        alive = alive & ~missed & ((energy[0] > 0) | (energy[1] > 0)
                                   | (energy[2] > 0))
        if cfg.russian_roulette and 2 <= b < cfg.bounces - 1:
            u_rr = _rr_uniform(rng.fold_in(kb, 3), cfg, spp, h, W, row0,
                               to_blocks, device)
            p_surv = torch.clamp(torch.maximum(torch.maximum(energy[0],
                                                             energy[1]),
                                               energy[2]), 0.05, 1.0)
            keep = u_rr < p_surv
            boost = torch.where(keep, 1.0 / p_surv, 0.0)
            energy = vec_ops.scale(energy, boost)
            alive = alive & keep
        if cfg.wavefront and b + 1 < cfg.bounces:
            # Park dead rays far outside the scene, pointing away from it.
            ro = vec_ops.where(alive, ro, vec_ops.splat((1e7, 1e7, 1e7), ro[0]))
            rd = vec_ops.where(alive, rd, vec_ops.splat((0.0, 1.0, 0.0), rd[0]))

    su1, su2 = _sky_uniforms(cfg, k_bounce, uniform)
    sky = _env_tap(scene, cfg, sky_d, su1, su2)
    radiance = vec_ops.add(radiance, vec_ops.mul(sky_e, sky))
    img = torch.stack([from_blocks(c).mean(dim=0) for c in radiance], dim=-1)
    if with_alive_count:
        return img, alive_total
    return img


def mega_inputs(scene: Scene, camera: Camera, key, cfg: RenderConfig,
                row0: int = 0, rows: Optional[int] = None):
    """What the path kernel consumes for one frame: camera rays in 8x16
    block order, the (bounces, 5, N) uniform rows (roulette, log2 u1,
    cos 2 pi u2, sin 2 pi u2, RR) and the sky-tap uniforms — the same
    numbers the JAX package's ``render_sample_mega`` computes."""
    H, W, spp = cfg.height, cfg.width, cfg.spp
    h = H if rows is None else rows
    N = h * W * spp
    device = _scene_device(scene)
    blocked = MEGA_BLOCKED and h % 8 == 0 and W % 16 == 0
    draw = _draw_fn(h, W, spp, blocked)
    ro, rd, k_bounce = _camera_rays(camera, key, cfg, h, W, spp, row0,
                                    blocked, draw, device)
    to_blocks, from_blocks = _block_permutes(h, W, spp, blocked)

    def uniform(key_):
        return draw(_uniform(key_, N, device))

    two_pi = 2.0 * 3.14159265
    uni = torch.empty((cfg.bounces, 5, N), dtype=torch.float32, device=device)
    for b in range(cfg.bounces):
        kb = rng.fold_in(k_bounce, b)
        u_r, u1, u2 = (uniform(rng.fold_in(kb, i)) for i in range(3))
        uni[b, 0] = u_r
        uni[b, 1] = torch.log2(torch.clamp_min(u1, 1e-12))
        phi = two_pi * u2
        uni[b, 2] = torch.cos(phi)
        uni[b, 3] = torch.sin(phi)
        if cfg.russian_roulette and 2 <= b < cfg.bounces - 1:
            uni[b, 4] = _rr_uniform(rng.fold_in(kb, 3), cfg, spp, h, W, row0,
                                    to_blocks, device)
        else:
            uni[b, 4] = 1.0
    su1, su2 = _sky_uniforms(cfg, k_bounce, uniform)
    return ro, rd, uni, su1, su2, from_blocks


def render_sample_mega(scene: Scene, accel, camera: Camera, key,
                       cfg: RenderConfig, row0: int = 0,
                       rows: Optional[int] = None):
    """``render_sample`` through the path kernel (``ops/cuda_path.py``):
    the same uniform streams, every bounce in one launch. ``accel``: a
    ``KernelScene`` or the scene's ``ClusterAccel``."""
    ks = accel if isinstance(accel, KernelScene) else \
        KernelScene.create(scene, accel)
    ro, rd, uni, su1, su2, from_blocks = mega_inputs(scene, camera, key, cfg,
                                                     row0, rows)
    radiance, sky_e, sky_d = path_trace(ks, ro, rd, uni, cfg)
    sky = _env_tap(scene, cfg, sky_d, su1, su2)
    radiance = vec_ops.add(radiance, vec_ops.mul(sky_e, sky))
    return torch.stack([from_blocks(c).mean(dim=0) for c in radiance], dim=-1)


def render_frame(scene: Scene, cfg: RenderConfig, camera: Camera, key,
                 accel=None, row0: int = 0, rows: Optional[int] = None):
    """One sample frame via the best path for cfg: the path kernel for
    tracer="pallas" with megakernel, the bounce loop otherwise."""
    if cfg.tracer == "pallas" and cfg.megakernel:
        if accel is None:
            accel = build_accel(scene, cfg)
        return render_sample_mega(scene, accel, camera, key, cfg,
                                  row0=row0, rows=rows)
    tracer = get_tracer(scene, cfg, accel)
    return render_sample(scene, tracer, camera, key, cfg, row0=row0,
                         rows=rows)


def progressive_step(state: RenderState, frame: torch.Tensor) -> RenderState:
    """Running mean with weight 1/(N+1), in float32 (the weights are host
    floats, so the step never waits for the device)."""
    n = float(state.n_samples)
    accum = state.accum * (n / (n + 1.0)) + frame / (n + 1.0)
    return RenderState(accum=accum, n_samples=state.n_samples + 1)


class Renderer:
    """Stateful renderer around the pure functions: holds (scene, camera,
    config) on ``device``, accumulates progressively, resets on
    invalidation."""

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig,
                 accel=None, seed: int = 0, device="cpu"):
        self.device = torch.device(device)
        self.camera = camera
        self.config = config
        self._key = rng.key(seed)
        self.stats = {}
        self.set_scene(scene, accel)

    # -- invalidation ---------------------------------------------------------
    def reset(self):
        self.state = RenderState.create(self.config.width, self.config.height,
                                        self.device)

    def set_camera(self, camera: Camera):
        self.camera = camera
        self.reset()

    def resize(self, width: int, height: int):
        self.config = self.config.replace(width=width, height=height)
        self.reset()

    def set_scene(self, scene: Scene, accel=None):
        """Upload the scene (and its accel, built when the tracer needs one
        and none is given) to the renderer's device; resets accumulation."""
        self.scene = scene.to(self.device)
        if accel is None:
            accel = build_accel(scene, self.config)
        self.accel = (KernelScene.create(self.scene, accel, self.device)
                      if isinstance(accel, ClusterAccel) else accel)
        self.reset()

    # -- stepping --------------------------------------------------------------
    def _frame(self, key) -> None:
        fkey = rng.fold_in(key, self.state.n_samples)
        frame = render_frame(self.scene, self.config, self.camera, fkey,
                             self.accel)
        self.state = progressive_step(self.state, frame)

    def step(self, n_frames: int = 1, fused: bool = True) -> "Renderer":
        """Advance the progressive render by ``n_frames``.

        The key chains are the JAX package's: ``fused=True`` splits the key
        once for the block (its jitted fori_loop), ``fused=False`` once per
        frame; each frame folds in its absolute sample index. Records
        synchronized throughput in ``self.stats``, then raises if a kernel
        overflowed its traversal stack in these frames."""
        t0 = time.perf_counter()
        if fused:
            self._key, sub = rng.split(self._key)
            for _ in range(n_frames):
                self._frame(sub)
        else:
            for _ in range(n_frames):
                self._key, sub = rng.split(self._key)
                self._frame(sub)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        rays = self.config.num_rays * self.config.bounces * n_frames
        self.stats = dict(frames=n_frames, seconds=dt,
                          ms_per_frame=dt / n_frames * 1000.0,
                          mrays_per_sec=rays / dt / 1e6)
        if self.device.type == "cuda":
            _build.raise_on_overflow(self.device)
        return self

    @property
    def image(self) -> np.ndarray:
        """Current converged image, (H, W, 3) linear float32, row 0 = top."""
        return self.state.accum.cpu().numpy()

    @property
    def sample_count(self) -> int:
        return self.state.n_samples

    # -- export / checkpoint ---------------------------------------------------
    def save_screenshot(self, path: Optional[str] = None,
                        tonemap: bool = True) -> str:
        """Write the converged image as a PNG (default name
        ``Screenshots/<time>-<sample>.png``)."""
        if path is None:
            os.makedirs("Screenshots", exist_ok=True)
            path = os.path.join(
                "Screenshots", f"{int(time.time())}-{self.sample_count}.png")
        img = self.image
        return write_png(path, tonemap_aces(img) if tonemap else img)

    def save_state(self, path: str) -> str:
        """Checkpoint (accum, n_samples, key data) as ``.npz`` — the JAX
        package's format, so either package resumes the other's file."""
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez(path, accum=self.image,
                 n_samples=np.int32(self.sample_count),
                 key=np.asarray(self._key, np.uint32))
        return path

    def load_state(self, path: str) -> "Renderer":
        """Resume from a checkpoint of either package (same key chain)."""
        with np.load(path) as data:
            accum = np.asarray(data["accum"], np.float32)
            want = (self.config.height, self.config.width, 3)
            if accum.shape != want:
                raise ValueError(f"checkpoint image {accum.shape} does not "
                                 f"match the config's {want}")
            self.state = RenderState(
                accum=torch.as_tensor(accum, device=self.device),
                n_samples=int(data["n_samples"]))
            self._key = np.asarray(data["key"], np.uint32).reshape(2)
        return self
