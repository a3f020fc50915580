"""Path-kernel wrapper and its plain version.

The counterpart of the JAX package's ``ops/pallas_path.py``: ``path_trace``
traces and shades every bounce of every path — for CUDA tensors in one
launch of ``csrc/path_kernel.cu``, for CPU tensors through the plain version,
a torch bounce loop over ``closest_hit_plain`` with the kernel's shade
written out op for op. Same inputs and outputs as the JAX function: rays as
Vec3 of (N,), the five uniform rows per bounce (roulette, log2 u1,
cos 2 pi u2, sin 2 pi u2, RR), and (radiance, sky throughput, sky direction)
as Vec3 of (N,); with ``emit_state`` also the packed (16, N) resume state
that the bounce split (``render._path_trace_split``) gathers.

At each global bounce in ``cfg.ray_bin_bounces`` both versions trace the
rays in their sorted order (``cuda_trace.sort_slots``, windows of
``SORT_WINDOW`` rays, the kernel's thread block), as the JAX kernel does;
the results are the same bits with the sort on or off.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import vec
from .cuda_trace import (SORT_WINDOW, KernelScene, _check_rays,
                         check_counts, closest_hit_plain)
from .vec import Vec3

_F32_MAX = float(np.finfo(np.float32).max)
MISS = 1.0e30
_LOG2_1000 = float(np.float32(np.log2(1000.0)))


def sort_bounces(cfg):
    """The inclusive global bounce window of ``cfg.ray_bin_bounces``, or
    None: a window with a None end sorts nothing
    (``pallas_path.py:424-428``)."""
    lo, hi = cfg.ray_bin_bounces
    return None if lo is None or hi is None else (lo, hi)


def path_trace_plain(ks: KernelScene, ro: Vec3, rd: Vec3, uni, cfg, *,
                     b0: int = 0, nb: int = None, energy0=None, alive0=None,
                     emit_state: bool = False):
    """Plain torch version of the path kernel (see ``path_trace``)."""
    nb = cfg.bounces if nb is None else nb
    window_b = sort_bounces(cfg)
    like = ro[0]
    one = torch.ones_like(like)
    zero = torch.zeros_like(like)
    energy = tuple(energy0) if energy0 is not None else (one, one, one)
    alive = (alive0 > 0) if alive0 is not None else torch.ones_like(like, dtype=torch.bool)
    radiance = (zero, zero, zero)
    sky_e = (zero, zero, zero)
    sky_d = (zero, one, zero)
    for lb in range(nb):
        bg = b0 + lb
        u_r, log2_u1, cos_phi, sin_phi, u_rr = uni[lb]
        sort = window_b is not None and window_b[0] <= bg <= window_b[1]
        hit = closest_hit_plain(ks, ro, rd, alive,
                                bin_rays=sort)  # dead rays: t = INF
        t = torch.where(hit.t >= _F32_MAX * 0.5, MISS * 1.5, hit.t)
        missed = t >= MISS
        n = hit.normal
        spec, emis, smooth = hit.specular, hit.emission, hit.smoothness

        albedo = tuple(torch.minimum(1.0 - s, a)
                       for s, a in zip(spec, hit.albedo))
        # A tensor divisor: by a Python scalar, torch's CUDA division
        # multiplies by its reciprocal, which rounds unlike the kernel's.
        three = torch.full_like(like, 3.0)
        spec_chance = (spec[0] + spec[1] + spec[2]) / three
        diff_chance = (albedo[0] + albedo[1] + albedo[2]) / three
        total = spec_chance + diff_chance
        safe_total = torch.where(total > 0, total, 1.0)
        spec_chance = spec_chance / safe_total
        diff_chance = diff_chance / safe_total
        is_spec = (total > 0) & (u_r < spec_chance)
        is_diff = (total > 0) & ~is_spec & (diff_chance > 0)

        k2 = 2.0 * (rd[0] * n[0] + rd[1] * n[1] + rd[2] * n[2])
        refl = tuple(rd[k] - k2 * n[k] for k in range(3))
        axis = vec.where(is_spec, refl, n)
        alpha = torch.exp2(smooth * smooth * _LOG2_1000)
        cos_t = torch.exp2(log2_u1 / torch.where(is_spec, alpha + 1.0, 2.0))
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        sg = torch.where(axis[2] >= 0.0, 1.0, -1.0)
        a_ = -1.0 / (sg + axis[2])
        b_ = axis[0] * axis[1] * a_
        tang = (1.0 + sg * axis[0] * axis[0] * a_, sg * b_, -sg * axis[0])
        binorm = (b_, sg + axis[1] * axis[1] * a_, -axis[1])
        ca, sa = cos_phi * sin_t, sin_phi * sin_t
        new_dir = tuple(tang[k] * ca + binorm[k] * sa + axis[k] * cos_t
                        for k in range(3))
        f = (alpha + 2.0) / (alpha + 1.0)
        nd = n[0] * new_dir[0] + n[1] * new_dir[1] + n[2] * new_dir[2]
        w_spec_s = torch.clamp(nd * f, 0.0, 1.0) \
            / torch.clamp_min(spec_chance, 1e-8)
        w_diff_d = torch.clamp_min(diff_chance, 1e-8)
        lobe = tuple(torch.where(is_spec, spec[k] * w_spec_s,
                                 torch.where(is_diff, albedo[k] / w_diff_d, 0.0))
                     for k in range(3))
        pos = tuple(ro[k] + t * rd[k] for k in range(3))
        contrib = vec.where(missed, (zero,) * 3, vec.mul(energy, emis))
        new_energy = vec.where(missed, (zero,) * 3, vec.mul(energy, lobe))
        new_ro = vec.where(missed, ro, tuple(pos[k] + n[k] * 0.001
                                             for k in range(3)))
        new_dir = vec.where(missed, rd, new_dir)

        record = missed & alive
        radiance = vec.add(radiance, contrib)
        sky_e = vec.where(record, energy, sky_e)
        sky_d = vec.where(record, rd, sky_d)
        ro, rd, energy = new_ro, new_dir, new_energy
        alive = alive & ~missed & ((energy[0] > 0) | (energy[1] > 0)
                                   | (energy[2] > 0))
        if cfg.russian_roulette and 2 <= bg < cfg.bounces - 1:
            p_surv = torch.clamp(torch.maximum(torch.maximum(energy[0], energy[1]),
                                               energy[2]), 0.05, 1.0)
            keep = u_rr < p_surv
            boost = torch.where(keep, 1.0 / p_surv, 0.0)
            energy = vec.scale(energy, boost)
            alive = alive & keep
    if emit_state:     # the layout of pallas_path.py:324-332
        state = torch.stack([*ro, *rd, *energy, alive.to(torch.float32),
                             *(zero,) * 6])
        return radiance, sky_e, sky_d, state
    return radiance, sky_e, sky_d


def path_trace(ks: KernelScene, ro: Vec3, rd: Vec3, uni, cfg, *,
               b0: int = 0, nb: int = None, energy0=None, alive0=None,
               emit_state: bool = False, counts=None):
    """Trace + shade path bounces [b0, b0+nb) of all rays.

    ro/rd: Vec3 of (N,) rays. ``uni``: the (nb, 5, N) uniform rows of the
    local bounces. ``energy0``/``alive0``: optional (N,) start throughput
    (Vec3) and liveness. Returns (radiance, sky_energy, sky_dir), three Vec3
    of (N,), and with ``emit_state`` a fourth value, the (16, N) float32
    resume state after the last local bounce: rows 0-2 ro, 3-5 rd, 6-8
    energy after roulette, 9 alive, 10-15 zero. It is the JAX kernel's for
    every ray: a dead ray keeps the ray of the bounce where it died, and its
    energy is 0 once a bounce ran after its death (so always, for nb >= 1,
    unless it died in the last one). ``counts``: optional (2, N) int32 CUDA
    tensor that the kernel fills with each ray's box and triangle tests over
    its bounces (None on the main path). The CUDA kernel runs for CUDA
    tensors, the plain version for CPU tensors. A traversal overflow raises
    at the next ``_build.raise_on_overflow``.

    The global bounces ``b0 + lb`` in ``cfg.ray_bin_bounces`` trace each
    window of ``SORT_WINDOW`` rays in its sorted order; a launch none of
    whose bounces lies in the window is the unsorted kernel, with no block
    barrier."""
    nb = cfg.bounces if nb is None else nb
    # The sorted global bounces of this launch (lo = -1: none).
    wb = sort_bounces(cfg)
    lo, hi = (-1, -1) if wb is None else (max(wb[0], b0),
                                          min(wb[1], b0 + nb - 1))
    if lo > hi:
        lo = hi = -1
    if ro[0].device.type == "cpu":
        return path_trace_plain(ks, ro, rd, uni, cfg, b0=b0, nb=nb,
                                energy0=energy0, alive0=alive0,
                                emit_state=emit_state)
    if ro[0].device.type != "cuda":
        raise ValueError(f"no path kernel for device {ro[0].device}")
    n = _check_rays(ks, *ro, *rd)
    uni = uni.contiguous()
    if uni.shape != (nb, 5, n) or uni.dtype != torch.float32 \
            or uni.device != ks.device:
        raise ValueError(f"uniform rows {tuple(uni.shape)} {uni.dtype} on "
                         f"{uni.device}, expected ({nb}, 5, {n}) float32")
    ro3, rd3 = vec.stack(ro), vec.stack(rd)
    e3 = vec.stack(energy0) if energy0 is not None else None
    a1 = alive0.to(torch.float32).contiguous() if alive0 is not None else None
    if e3 is not None:
        _check_rays(ks, *energy0)
    if a1 is not None:
        _check_rays(ks, a1)
    out = torch.empty((9, n), dtype=torch.float32, device=ks.device)
    state = (torch.empty((16, n), dtype=torch.float32, device=ks.device)
             if emit_state else None)
    with _build.on_card(out.device):
        code = _build.lib().urt_path_trace(
            ctypes.byref(ks.args), ro3.data_ptr(), rd3.data_ptr(),
            a1.data_ptr() if a1 is not None else None,
            e3.data_ptr() if e3 is not None else None,
            uni.data_ptr(), out.data_ptr(),
            state.data_ptr() if emit_state else None,
            check_counts(ks, counts, n), n, b0, nb, cfg.bounces,
            int(cfg.russian_roulette), lo, hi, SORT_WINDOW,
            _build.error_flag(out.device).data_ptr(),
            _build.stream_ptr(out.device))
    _build.count("path", out.device)
    _build.check(code, "path")
    ret = (out[0], out[1], out[2]), (out[3], out[4], out[5]), \
        (out[6], out[7], out[8])
    return ret + (state,) if emit_state else ret
