"""Frame rendering: path-traced sample pass + progressive accumulation.

The port of the JAX package's ``render.py``:

* ``render_sample``: one frame of ``spp`` jittered camera rays per pixel,
  bounced ``bounces`` times through a tracer (``"brute"`` or the
  closest-hit kernel), with wavefront parking and Russian roulette.
* ``render_sample_mega``: the same frame through the path kernel — every
  bounce in one launch, fed the same uniform rows, which ``bounce_rows``
  draws in one launch of the threefry kernel; with ``split_bounce``,
  the deep bounces on a compact buffer of the surviving rays
  (``_path_trace_split``); then the sky tap, whose kernel draws, picks,
  fetches and composes into the radiance in one launch (``_env_tap``).
* ``render_frame``: the best path for a config, in ``spp_chunk`` sub-frames
  when the config asks for them.
* ``render_aovs``: the first-hit G-buffer at pixel centres, one launch of
  the closest-hit kernel.
* ``progressive_step``: the 1/(N+1) running mean.
* ``PreviewExportMixin``: live preview (``watch`` with its HTTP view), the
  a-trous ``denoised_image``, AOVs and their multi-part EXR export.
* ``Renderer``: the stateful frame loop with the JAX package's key chains,
  whole frames or ``dispatch_bands`` bands, and ``profile``, its per-stage
  device breakdown.

Every random number is drawn with ``rng.py`` from the same keys in the same
layout as the JAX package (the block-native ``_draw_fn`` convention), so a
port render and a JAX render of one seed agree pixel for pixel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
import tempfile
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
from .ops.cuda_env import sky_tap
from .ops.cuda_path import path_trace
from .ops.cuda_trace import KernelScene, make_pallas_tracer
from .ops.sampling import sample_unit_disk
from .ops.shade import MISS_T, sample_skybox, sample_skybox_rgbe, shade
from .scene import Scene
from .utils.denoise import atrous_denoise
from .utils.image import tonemap_aces, write_png

# Rays run in 8x16 pixel-block order on the megakernel path, as in the JAX
# package (MEGA_BLOCKED); the uniforms follow the block-native convention.
MEGA_BLOCKED = True
# The bounce-split compact buffer is a multiple of this many rays, the JAX
# kernel's step (pallas_trace.BLOCK), so both size it alike for any
# split_frac and overflow in the same frames.
SPLIT_BLOCK = 1024


@dataclasses.dataclass
class RenderState:
    """Progressive accumulation state."""

    accum: torch.Tensor   # (H, W, 3) running mean, linear radiance
    n_samples: int        # frames accumulated

    @staticmethod
    def create(width: int, height: int, device="cuda") -> "RenderState":
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
                row0: int, to_blocks: Callable, device,
                uniform: Callable = rng.uniform) -> torch.Tensor:
    """Russian-roulette uniforms, per ray or shared per (8, 128)-pixel group
    on absolute output coordinates (cfg.rr_group == "step"), drawn with
    ``uniform(key, shape, device)``."""
    N = spp * h * W
    if cfg.rr_group != "step":
        return to_blocks(uniform(key, (N,), device))
    Hg = (cfg.height + 7) // 8
    Wg = (W + 127) // 128
    ug = uniform(key, (spp, Hg, Wg), device)
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


def _pixel_order(h: int, W: int, blocked: bool) -> bool:
    """Whether rays run in pixel order at a size that tiles into 8x16
    blocks, where ``_draw_fn`` moves each draw to its block slot."""
    return not blocked and h % 8 == 0 and W % 16 == 0


def _draw_fn(h: int, W: int, spp: int, blocked: bool):
    """Canonical per-ray uniform assignment shared by every tracer path: at
    sizes that tile into 8x16 blocks, pixel p's draw is the flat element at
    p's block slot. Returns ``f(flat_draw) -> draw in ray-layout order``."""
    N = spp * h * W
    if not _pixel_order(h, W, blocked):
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


def _sky_keys(cfg, k_bounce):
    """The keys of the sky tap's two draws."""
    ks = rng.fold_in(k_bounce, cfg.bounces)
    return rng.fold_in(ks, 0), rng.fold_in(ks, 1)


def _env_tap(scene: Scene, cfg: RenderConfig, radiance, sky_e, sky_d,
             k_bounce, ray_index=None, lattice=None, n_rays=None):
    """Once-per-frame environment resolve for the recorded miss directions:
    ``radiance + sky_e * sky``. With ``cfg.sky_rgbe`` the sky is one
    stochastic RGBE tap per ray, whose two draws sit at the ray's counter
    in the frame's sky rows (``cuda_env.sky_counters``: the ray's index,
    ``ray_index[i]`` into the frame's ``n_rays`` rays, or its block slot in
    ``lattice``); with ``cfg.sky_mxu`` and a packed plane, the sky-tap
    kernel draws, picks, fetches and composes into ``radiance`` in place
    (bit-identical to the plain gather). Without ``sky_rgbe``, the bilinear
    float sky."""
    if not cfg.sky_rgbe:
        return vec_ops.add(radiance,
                           vec_ops.mul(sky_e, sample_skybox(scene.skybox,
                                                            sky_d)))
    H, W = scene.skybox.shape[0], scene.skybox.shape[1]
    keys = _sky_keys(cfg, k_bounce)
    if cfg.sky_mxu and scene.skybox_rgbe is not None:
        return sky_tap((H, W), scene.skybox_rgbe, radiance, sky_e, sky_d,
                       keys, ray_index=ray_index, lattice=lattice)
    device = sky_d[0].device
    n = sky_d[0].shape[0] if n_rays is None else n_rays
    draw = _draw_fn(*lattice, False) if lattice else (lambda a: a)
    su1, su2 = (draw(_uniform(k, n, device)) for k in keys)
    if ray_index is not None:
        su1, su2 = su1[ray_index], su2[ray_index]
    sky = sample_skybox_rgbe(scene.skybox, sky_d, u1=su1, u2=su2,
                             packed=scene.skybox_rgbe)
    return vec_ops.add(radiance, vec_ops.mul(sky_e, sky))


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

    lattice = (h, W, spp) if _pixel_order(h, W, blocked) else None
    radiance = _env_tap(scene, cfg, radiance, sky_e, sky_d, k_bounce,
                        lattice=lattice)
    img = torch.stack([from_blocks(c).mean(dim=0) for c in radiance], dim=-1)
    if with_alive_count:
        return img, alive_total
    return img


def _rr_bounces(cfg: RenderConfig):
    """The bounces [lo, hi) whose roulette row is drawn (2 <= b < B-1 with
    Russian roulette); the row is 1 elsewhere."""
    return (2, cfg.bounces - 1) if cfg.russian_roulette else (0, 0)


def bounce_rows_plain(k_bounce, cfg: RenderConfig, h: int, row0: int,
                      blocked: bool, device) -> torch.Tensor:
    """Plain version of ``bounce_rows``: bounce by bounce, the int64
    threefry draws of ``rng.uniform_plain`` and torch's log2, cos and sin.
    The draws are block-native (``_draw_fn`` is the identity on the
    megakernel's layout), so u_r, u1 and u2 of ray i sit at counter i."""
    W, spp = cfg.width, cfg.spp
    N = spp * h * W
    to_blocks, _ = _block_permutes(h, W, spp, blocked)
    rr_lo, rr_hi = _rr_bounces(cfg)
    two_pi = 2.0 * 3.14159265
    uni = torch.empty((cfg.bounces, 5, N), dtype=torch.float32, device=device)
    for b in range(cfg.bounces):
        kb = rng.fold_in(k_bounce, b)
        u_r, u1, u2 = (rng.uniform_plain(rng.fold_in(kb, i), (N,), device)
                       for i in range(3))
        uni[b, 0] = u_r
        uni[b, 1] = torch.log2(torch.clamp_min(u1, 1e-12))
        phi = two_pi * u2
        uni[b, 2] = torch.cos(phi)
        uni[b, 3] = torch.sin(phi)
        if rr_lo <= b < rr_hi:
            uni[b, 4] = _rr_uniform(rng.fold_in(kb, 3), cfg, spp, h, W, row0,
                                    to_blocks, device, rng.uniform_plain)
        else:
            uni[b, 4] = 1.0
    return uni


def bounce_args(k_bounce, cfg: RenderConfig, h: int, row0: int,
                blocked: bool) -> _build.BounceArgs:
    """The threefry kernel's by-value arguments for one frame's uniform
    rows: the keys of ``rng.bounce_keys`` and the ray lattice."""
    if cfg.bounces > _build.MAX_BOUNCES:
        raise ValueError(f"{cfg.bounces} bounces: the uniform-row kernel "
                         f"takes at most {_build.MAX_BOUNCES}")
    W = cfg.width
    if cfg.spp * h * W >= 2 ** 31:
        raise ValueError(f"{cfg.spp * h * W} rays exceed the uniform-row "
                         "kernel's 32-bit indexing")
    args = _build.BounceArgs()
    keys = rng.bounce_keys(k_bounce, cfg.bounces).reshape(-1)
    args.keys[:keys.size] = keys.tolist()
    args.n, args.nb, args.h, args.W, args.row0 = (cfg.spp * h * W,
                                                  cfg.bounces, h, W, row0)
    args.Hg, args.Wg = (cfg.height + 7) // 8, (W + 127) // 128
    args.blocked = int(blocked)
    args.rr_step = int(cfg.rr_group == "step")
    args.rr_lo, args.rr_hi = _rr_bounces(cfg)
    return args


def bounce_rows(k_bounce, cfg: RenderConfig, h: int, row0: int,
                blocked: bool, device) -> torch.Tensor:
    """The path kernel's (bounces, 5, N) uniform rows for a band of ``h``
    rows from ``row0``: roulette u_r, log2 max(u1, 1e-12), cos 2 pi u2,
    sin 2 pi u2 and the Russian-roulette draw (1 outside the bounces that
    draw it), per ray in 8x16 block order when ``blocked``. For a CUDA
    device in one launch of the threefry kernel, with the keys passed by
    value (no host-to-device copy); for the CPU, ``bounce_rows_plain``."""
    device = torch.device(device)
    if device.type == "cpu":
        return bounce_rows_plain(k_bounce, cfg, h, row0, blocked, device)
    if device.type != "cuda":
        raise ValueError(f"no uniform-row kernel for device {device}")
    args = bounce_args(k_bounce, cfg, h, row0, blocked)
    uni = torch.empty((cfg.bounces, 5, args.n), dtype=torch.float32,
                      device=device)
    code = _build.lib().urt_bounce_rows(ctypes.byref(args), uni.data_ptr(),
                                        _build.stream_ptr(device))
    _build.LAUNCHES["bounce_rows"] += 1
    _build.check(code, "bounce_rows")
    return uni


def _frame_inputs(scene: Scene, camera: Camera, key, cfg: RenderConfig,
                  row0: int = 0, rows: Optional[int] = None):
    """What the path kernel consumes for one frame: camera rays in 8x16
    block order and the (bounces, 5, N) uniform rows (``bounce_rows``),
    with the frame's bounce key and the block-to-image permute."""
    H, W, spp = cfg.height, cfg.width, cfg.spp
    h = H if rows is None else rows
    device = _scene_device(scene)
    blocked = MEGA_BLOCKED and h % 8 == 0 and W % 16 == 0
    draw = _draw_fn(h, W, spp, blocked)
    ro, rd, k_bounce = _camera_rays(camera, key, cfg, h, W, spp, row0,
                                    blocked, draw, device)
    _, from_blocks = _block_permutes(h, W, spp, blocked)
    uni = bounce_rows(k_bounce, cfg, h, row0, blocked, device)
    return ro, rd, uni, k_bounce, from_blocks


def mega_inputs(scene: Scene, camera: Camera, key, cfg: RenderConfig,
                row0: int = 0, rows: Optional[int] = None):
    """``_frame_inputs`` with the sky tap's two uniform rows drawn as
    tensors (the frame itself draws them inside the sky-tap kernel) — the
    same numbers the JAX package's ``render_sample_mega`` computes."""
    ro, rd, uni, k_bounce, from_blocks = _frame_inputs(scene, camera, key,
                                                       cfg, row0, rows)
    su1 = su2 = None
    if cfg.sky_rgbe:
        n = ro[0].shape[0]
        su1, su2 = (_uniform(k, n, ro[0].device)
                    for k in _sky_keys(cfg, k_bounce))
    return ro, rd, uni, su1, su2, from_blocks


def split_capacity(n_rays: int, split_frac: float) -> int:
    """Slots of the bounce-split compact buffer for ``n_rays`` rays:
    ceil(n_rays * split_frac) rounded up to SPLIT_BLOCK, at least one block
    and at most n_rays rounded up (the JAX package's rule)."""
    B = SPLIT_BLOCK
    C = max(B, int(math.ceil(n_rays * split_frac / B)) * B)
    return min(C, -(-n_rays // B) * B)


def _path_trace_split(scene: Scene, ks: KernelScene, ro, rd, uni, k_bounce,
                      cfg: RenderConfig, sb: int):
    """Bounce-split path kernel (the JAX package's ``_path_trace_split``):
    full width for bounces [0, sb), then the deep bounces on a compact
    buffer of the rays still alive.

    The alive rays get cumsum destinations; one gather moves their packed
    (16, N) resume state into the buffer, one more their remaining uniform
    rows, taken by original ray index so that each ray's stream is the
    unsplit kernel's. The compact radiance gets its sky tap in the compact
    domain, each slot drawing at its original ray's counter, and is
    scatter-added back. The returned sky records hold only misses of
    bounces [0, sb): a ray that reached the deep bounces has no record
    there, so the caller's full-width sky tap stays right.

    The buffer holds ``split_capacity(N, split_frac)`` rays. Survivors past
    it (overflow) finish at full width in a remainder pass on their
    original state. The JAX package skips that pass
    with ``lax.cond`` when nothing overflows; here it always runs, since a
    branch on the count would wait for the device every frame. With no
    overflow every thread of it is dead on entry and leaves at once, and it
    adds exact zeros.
    """
    N = ro[0].shape[0]
    device = ro[0].device
    C = split_capacity(N, cfg.split_frac)

    rad1, se1, sd1, st = path_trace(ks, ro, rd, uni[:sb], cfg, nb=sb,
                                    emit_state=True)
    alive = st[9] > 0
    ordv = torch.cumsum(alive.to(torch.int32), 0, dtype=torch.int32) - 1
    # Slot C of a C+1 buffer takes the dead and overflow rays and is thrown
    # away (JAX's scatter mode="drop"). Unwritten slots alias ray 0.
    dest = torch.where(alive, torch.clamp_max(ordv, C), C).long()
    idx = torch.zeros(C + 1, dtype=torch.int64, device=device).scatter_(
        0, dest, torch.arange(N, dtype=torch.int64, device=device))[:C]
    n_alive = alive.sum()
    slot_live = torch.arange(C, device=device) < torch.clamp_max(n_alive, C)

    stc = st.index_select(1, idx)             # one packed (16, C) gather
    ro_c, rd_c, en_c = tuple(stc[0:3]), tuple(stc[3:6]), tuple(stc[6:9])
    alive_c = torch.where(slot_live, stc[9], 0.0)

    nb2 = cfg.bounces - sb
    uni_c = uni[sb:].reshape(nb2 * 5, N).index_select(1, idx) \
        .reshape(nb2, 5, C)

    rad2, se2, sd2 = path_trace(ks, ro_c, rd_c, uni_c, cfg, b0=sb, nb=nb2,
                                energy0=en_c, alive0=alive_c)
    rad_c = _env_tap(scene, cfg, rad2, se2, sd2, k_bounce, ray_index=idx,
                     n_rays=N)
    # In place into the first segment's radiance rows. Pad slots alias ray
    # 0 and add exact zeros (slot_live masks them), so the atomics of the
    # CUDA index_add give the same sums in any order.
    radiance = tuple(rad1[k].index_add_(0, idx,
                                        torch.where(slot_live, rad_c[k], 0.0))
                     for k in range(3))

    # Overflow: survivors past the buffer finish at full width on their
    # original state and streams, so the image is the unsplit one in every
    # regime.
    overflow = alive & (ordv >= C)
    rad3, se3, sd3 = path_trace(ks, tuple(st[0:3]), tuple(st[3:6]), uni[sb:],
                                cfg, b0=sb, nb=nb2, energy0=tuple(st[6:9]),
                                alive0=overflow)
    rad3 = _env_tap(scene, cfg, rad3, se3, sd3, k_bounce)
    radiance = vec_ops.add(radiance, rad3)
    return radiance, se1, sd1


def render_sample_mega(scene: Scene, accel, camera: Camera, key,
                       cfg: RenderConfig, row0: int = 0,
                       rows: Optional[int] = None):
    """``render_sample`` through the path kernel (``ops/cuda_path.py``):
    the same uniform streams, every bounce in one launch (or two segments
    with ``cfg.split_bounce``), then the sky tap composed into the radiance
    in one launch. ``accel``: a ``KernelScene`` or the scene's
    ``ClusterAccel``."""
    ks = accel if isinstance(accel, KernelScene) else \
        KernelScene.create(scene, accel)
    ro, rd, uni, k_bounce, from_blocks = _frame_inputs(scene, camera, key,
                                                       cfg, row0, rows)
    sb = cfg.split_bounce
    if sb is not None and 0 < sb < cfg.bounces:
        radiance, sky_e, sky_d = _path_trace_split(scene, ks, ro, rd, uni,
                                                   k_bounce, cfg, sb)
    else:
        radiance, sky_e, sky_d = path_trace(ks, ro, rd, uni, cfg)
    radiance = _env_tap(scene, cfg, radiance, sky_e, sky_d, k_bounce)
    return torch.stack([from_blocks(c).mean(dim=0) for c in radiance], dim=-1)


def render_frame(scene: Scene, cfg: RenderConfig, camera: Camera, key,
                 accel=None, row0: int = 0, rows: Optional[int] = None):
    """One sample frame via the best path for cfg: the path kernel for
    tracer="pallas" with megakernel, the bounce loop otherwise.

    With ``cfg.spp_chunk`` below ``cfg.spp`` the frame is the spp-weighted
    sum of sub-frames of ``spp_chunk`` samples at ``fold_in(key, i)`` and a
    remainder sub-frame at ``fold_in(key, n_full)``, rendered one after the
    other: only the running image outlives a sub-frame, not its rays or
    uniform rows. Chunking sits above the tracer dispatch, so it applies to
    every tracer."""
    if cfg.tracer == "pallas" and accel is None:
        accel = build_accel(scene, cfg)
    if isinstance(accel, ClusterAccel):
        accel = KernelScene.create(scene, accel)
    chunk = cfg.spp_chunk
    if chunk and cfg.spp > chunk:
        n_full, rem = divmod(cfg.spp, chunk)
        sub = cfg.replace(spp=chunk, spp_chunk=None)
        img = render_frame(scene, sub, camera, rng.fold_in(key, 0), accel,
                           row0, rows)
        for i in range(1, n_full):
            img = img + render_frame(scene, sub, camera, rng.fold_in(key, i),
                                     accel, row0, rows)
        img = img * (chunk / cfg.spp)
        if rem:
            subr = cfg.replace(spp=rem, spp_chunk=None)
            img = img + render_frame(scene, subr, camera,
                                     rng.fold_in(key, n_full), accel, row0,
                                     rows) * (rem / cfg.spp)
        return img
    if cfg.tracer == "pallas" and cfg.megakernel:
        return render_sample_mega(scene, accel, camera, key, cfg,
                                  row0=row0, rows=rows)
    tracer = get_tracer(scene, cfg, accel)
    return render_sample(scene, tracer, camera, key, cfg, row0=row0,
                         rows=rows)


def aov_buffers(hit, H: int, W: int) -> dict:
    """The G-buffer of first hits in pixel order: albedo, normal and
    emission (H, W, 3) and depth (H, W), zero where ``t >= MISS_T`` (a
    miss, which the closest-hit kernel writes as t = INF, or a dead ray),
    and the bool hit mask."""
    hitm = hit.t < MISS_T

    def img3(v3):
        return torch.stack([torch.where(hitm, c, 0.0).reshape(H, W)
                            for c in v3], dim=-1)

    return dict(albedo=img3(hit.albedo), normal=img3(hit.normal),
                emission=img3(hit.emission),
                depth=torch.where(hitm, hit.t, 0.0).reshape(H, W),
                hit=hitm.reshape(H, W))


def pixel_center_rays(camera: Camera, H: int, W: int, device):
    """Camera rays through the pixel centres in pixel order (row 0 the
    top), no jitter, the lens sample at (0, 0)."""
    N = H * W
    px = torch.arange(W, device=device).expand(H, W)
    py = (H - 1 - torch.arange(H, device=device))[:, None].expand(H, W)
    u = ((px.to(torch.float32) + 0.5) / W * 2.0 - 1.0).reshape(N)
    v = ((py.to(torch.float32) + 0.5) / H * 2.0 - 1.0).reshape(N)
    zero = torch.zeros(N, dtype=torch.float32, device=device)
    return camera_rays_soa(camera, u, v, zero, zero)


def render_aovs(scene: Scene, cfg: RenderConfig, camera: Camera,
                accel=None) -> dict:
    """First-hit G-buffer at pixel centres: ``aov_buffers`` of one trace of
    ``pixel_center_rays``, as tensors on the scene's device. No random
    numbers, so every tracer gives the same buffers; with
    ``tracer="pallas"`` on the card it is one launch of the closest-hit
    kernel on H*W rays. The guides of the guided a-trous denoiser and the
    AOV export (``Renderer.save_aovs``)."""
    H, W = cfg.height, cfg.width
    device = _scene_device(scene)
    ro, rd = pixel_center_rays(camera, H, W, device)
    tracer = get_tracer(scene, cfg, accel)
    hit = tracer(ro, rd, torch.ones(H * W, dtype=torch.bool, device=device),
                 bin_rays=False)
    return aov_buffers(hit, H, W)


def progressive_step(state: RenderState, frame: torch.Tensor) -> RenderState:
    """Running mean with weight 1/(N+1), in float32 (the weights are host
    floats, so the step never waits for the device)."""
    n = float(state.n_samples)
    accum = state.accum * (n / (n + 1.0)) + frame / (n + 1.0)
    return RenderState(accum=accum, n_samples=state.n_samples + 1)


class PreviewExportMixin:
    """Live preview, denoise, and AOV/EXR export (the JAX package's mixin of
    the same name). Hosts provide ``step``, ``image``, ``sample_count``,
    ``state``, ``config``, ``scene``, ``camera`` and ``_aov_accel()``, an
    accel a single-device ``render_aovs`` trace can use (by default
    ``self.accel``; a sharded renderer overrides it)."""

    def _aov_accel(self):
        return self.accel

    def watch(self, path: str = "preview.png", every: int = 4,
              frames: Optional[int] = None, denoise: bool = True,
              guided: bool = False, http_port: Optional[int] = None,
              on_update: Optional[Callable] = None):
        """Progressive live preview for a headless box: render ``every``
        frames per tick, write the (optionally denoised) tonemapped
        accumulator to ``path`` atomically, repeat until ``frames`` samples
        have accumulated (None: until KeyboardInterrupt).

        ``http_port`` serves the refreshing preview at
        ``http://localhost:<port>/`` from a daemon thread. After every tick
        ``self.stats["tick"]`` holds its host milliseconds (``step_ms``,
        ``denoise_ms``, ``png_ms``), and ``on_update`` (if given) is called
        with this renderer."""
        if http_port is not None:
            self._serve_preview(path, http_port)
        try:
            while frames is None or self.sample_count < frames:
                n = every if frames is None \
                    else min(every, frames - self.sample_count)
                t0 = time.perf_counter()
                self.step(n)
                t1 = time.perf_counter()
                img = (self.denoised_image(guided=guided) if denoise
                       else self.image)
                t2 = time.perf_counter()
                fd, tmp = tempfile.mkstemp(
                    dir=os.path.dirname(os.path.abspath(path)) or ".",
                    suffix=".png")
                os.close(fd)
                write_png(tmp, tonemap_aces(img))
                os.replace(tmp, path)     # atomic: readers never see a torn file
                t3 = time.perf_counter()
                self.stats["tick"] = dict(step_ms=(t1 - t0) * 1e3,
                                          denoise_ms=(t2 - t1) * 1e3,
                                          png_ms=(t3 - t2) * 1e3)
                if on_update is not None:
                    on_update(self)
        except KeyboardInterrupt:
            pass
        return self

    def _serve_preview(self, path: str, port: int) -> None:
        """Daemon HTTP thread on 127.0.0.1: / auto-refreshes, /preview.png
        is the file. The server is ``self._preview_server`` (its
        ``shutdown()`` stops the thread)."""
        import http.server
        import threading

        html = (b"<html><head><meta http-equiv='refresh' content='2'>"
                b"<title>unityraytracer_tpu_torch preview</title></head>"
                b"<body style='background:#111;margin:0'>"
                b"<img src='/preview.png' style='width:100%'></body></html>")

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(h):
                if h.path == "/preview.png":
                    try:
                        with open(path, "rb") as f:
                            data = f.read()
                    except OSError:
                        h.send_response(404)
                        h.end_headers()
                        return
                    h.send_response(200)
                    h.send_header("Content-Type", "image/png")
                    h.send_header("Cache-Control", "no-store")
                    h.end_headers()
                    h.wfile.write(data)
                else:
                    h.send_response(200)
                    h.send_header("Content-Type", "text/html")
                    h.end_headers()
                    h.wfile.write(html)

            def log_message(h, *a):      # quiet
                pass

        srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        self._preview_server = srv

    def aovs(self) -> dict:
        """First-hit G-buffer (albedo/normal/emission/depth/hit) as tensors
        on the renderer's device; recomputed per call (one trace)."""
        return render_aovs(self.scene, self.config, self.camera,
                           accel=self._aov_accel())

    def denoised_image(self, iterations: int = 3, sigma_color: float = 0.1,
                       guided: bool = False) -> np.ndarray:
        """Edge-preserving a-trous denoise of the current accumulator
        (``utils/denoise.py``; on the card one kernel launch per level), as
        an (H, W, 3) float32 array; the accumulator itself stays untouched
        and unbiased. ``guided=True`` adds albedo/normal edge-stopping from
        the first-hit G-buffer."""
        kw = {}
        if guided:
            g = self.aovs()
            kw = dict(albedo=g["albedo"], normal=g["normal"])
        return atrous_denoise(self.state.accum, iterations, sigma_color,
                              **kw).cpu().numpy()

    def save_aovs(self, path: str, tonemapped_beauty: bool = False) -> str:
        """Write beauty + G-buffer AOVs as one multi-part EXR (parts:
        beauty, albedo, normal, depth, emission; half floats, ZIP)."""
        from .models.exr import write_exr_multipart

        g = {k: v.cpu().numpy() for k, v in self.aovs().items()}
        beauty = self.image
        if tonemapped_beauty:
            beauty = tonemap_aces(beauty)
        write_exr_multipart(path, [
            ("beauty", beauty), ("albedo", g["albedo"]),
            ("normal", g["normal"]), ("depth", g["depth"]),
            ("emission", g["emission"])])
        return path


class Renderer(PreviewExportMixin):
    """Stateful renderer around the pure functions: holds (scene, camera,
    config) on ``device`` — the card unless the caller asks for the CPU
    (``device="cpu"``, where every kernel runs its plain version) —
    accumulates progressively, resets on invalidation."""

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig,
                 accel=None, seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Renderer(device='cuda'): torch sees no CUDA device; pass "
                "device='cpu' to render with the plain versions")
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

    def _frame_banded(self, key) -> None:
        """One frame as ``dispatch_bands`` horizontal bands: band ``bi``
        renders at ``fold_in(fold_in(key, n_samples), bi)``."""
        cfg = self.config
        H = cfg.height
        bh = -(-H // cfg.dispatch_bands)
        fkey = rng.fold_in(key, self.state.n_samples)
        bands = [render_frame(self.scene, cfg, self.camera,
                              rng.fold_in(fkey, bi), self.accel, row0=row0,
                              rows=min(bh, H - row0))
                 for bi, row0 in enumerate(range(0, H, bh))]
        self.state = progressive_step(self.state, torch.cat(bands, dim=0))

    def step(self, n_frames: int = 1, fused: bool = True) -> "Renderer":
        """Advance the progressive render by ``n_frames``.

        The key chains are the JAX package's: ``fused=True`` splits the key
        once for the block (its jitted fori_loop), ``fused=False`` once per
        frame; each frame folds in its absolute sample index. A config with
        ``dispatch_bands > 1`` renders each frame in bands and always takes
        the per-frame chain, as the JAX package's banded step does, so
        ``fused`` has no effect there. Records synchronized throughput in
        ``self.stats``, then raises if a kernel overflowed its traversal
        stack in these frames."""
        t0 = time.perf_counter()
        bands = self.config.dispatch_bands
        if bands is not None and bands > 1:
            for _ in range(n_frames):
                self._key, sub = rng.split(self._key)
                self._frame_banded(sub)
        elif fused:
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

    def profile(self, n_frames: int = 1):
        """Per-stage device-time breakdown of the frame step
        (``utils/profiling.py``): one warm-up frame outside the profiled
        window, then ``n_frames`` frames inside it, each as ``step(1,
        fused=False)`` renders it — in bands when the config sets
        ``dispatch_bands``. The result lands in ``self.stats["device"]``
        and is returned; every frame advances the accumulator."""
        from .utils.profiling import profile_stages

        self.step(1)
        prof = profile_stages(lambda: self.step(n_frames, fused=False),
                              device=self.device)
        self.stats["device"] = prof
        return prof

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
