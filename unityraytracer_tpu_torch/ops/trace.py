"""Closest-hit by exhaustive testing: the port's own oracle.

The port of the JAX package's ``ops/trace.py``: ground, spheres and every
triangle are tested against every ray (chunked over rays), and the nearest
candidate wins by the same strict ``<`` left fold (ground, then spheres, then
triangles). Within a kind, an exact tie goes to the lowest index, which is
what ``argmin`` gives. The CUDA closest-hit kernel
(``csrc/closest_hit.cuh``) applies the same rules, so this file is also its
plain version (``ops/cuda_trace.py``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..scene import Scene
from ..utils.math3d import INF
from . import vec
from .intersect import intersect_ground, intersect_spheres, intersect_triangles
from .shade import Hit, MISS_T
from .vec import Vec3

# Largest (rays x primitives) float32 temporary a chunk may create: the
# eager torch MT97 keeps about a dozen of them alive at once.
_CHUNK_ELEMS = {"cpu": 1 << 21, "cuda": 1 << 25}


def _cat(parts):
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat(parts)
    if isinstance(first, tuple):
        return tuple(_cat([p[k] for p in parts]) for k in range(len(first)))
    return dataclasses.replace(first, **{
        f.name: _cat([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(first)})


def map_chunked(fn, ray_args, chunk: int):
    """Apply ``fn(*ray_args)`` over rays in chunks of ``chunk`` and
    concatenate the (dataclass, tuple or tensor) results."""
    R = ray_args[0].shape[0]
    if R <= chunk:
        return fn(*ray_args)
    return _cat([fn(*(a[i:i + chunk] for a in ray_args))
                 for i in range(0, R, chunk)])


def _expand(x, like):
    return x.expand(like.shape)


def _empty_candidate(like):
    z = torch.zeros_like(like)
    zv = (z, z, z)
    return dict(t=torch.full_like(like, INF), normal=zv, albedo=zv,
                specular=zv, emission=zv, smoothness=z,
                prim=torch.full(like.shape, -1, dtype=torch.int64,
                                device=like.device))


def materials_for(scene: Scene, mid):
    """Per-ray material params by id gather (the plain paths; the CUDA
    kernels resolve materials themselves)."""
    mats = scene.materials
    return dict(albedo=vec.gather_rows(mats.albedo, mid),
                specular=vec.gather_rows(mats.specular, mid),
                emission=vec.gather_rows(mats.emission, mid),
                smoothness=mats.smoothness[mid])


def _ground_candidate(scene: Scene, ro: Vec3, rd: Vec3):
    t = intersect_ground(ro, rd)
    t = torch.where(scene.ground_enabled > 0, t, INF)
    zeros = torch.zeros_like(t)
    mats = scene.materials
    gid = scene.ground_material_id.long()

    def row3(tab):
        return tuple(_expand(tab[gid, k], t) for k in range(3))

    return dict(t=t, normal=(zeros, torch.ones_like(t), zeros),
                albedo=row3(mats.albedo), specular=row3(mats.specular),
                emission=row3(mats.emission),
                smoothness=_expand(mats.smoothness[gid], t),
                prim=torch.full(t.shape, scene.num_triangles,
                                dtype=torch.int64, device=t.device))


def _sphere_candidate(scene: Scene, ro: Vec3, rd: Vec3):
    sp = scene.spheres
    if sp.count == 0:
        return _empty_candidate(ro[0])
    ts = intersect_spheres(ro, rd, sp.center, sp.radius)      # (R, S)
    best = torch.argmin(ts, dim=1)
    t = torch.gather(ts, 1, best[:, None])[:, 0]
    center = vec.gather_rows(sp.center, best)
    pos = vec.add(ro, vec.scale(rd, t))
    n = vec.normalize(vec.sub(pos, center))
    return dict(t=t, normal=n, prim=best + (scene.num_triangles + 1),
                **materials_for(scene, sp.material_id[best].long()))


def _triangle_candidate(scene: Scene, ro: Vec3, rd: Vec3):
    tr = scene.triangles
    if tr.count == 0:
        return _empty_candidate(ro[0])
    tt, u, v = intersect_triangles(ro, rd, tr.v0, tr.v1, tr.v2)  # (R, T)
    best = torch.argmin(tt, dim=1)

    def take(a):
        return torch.gather(a, 1, best[:, None])[:, 0]

    t, bu, bv = take(tt), take(u), take(v)
    del tt, u, v
    # Barycentric smooth-normal blend, world space.
    w = 1.0 - bu - bv
    n0 = vec.gather_rows(tr.n0, best)
    n1 = vec.gather_rows(tr.n1, best)
    n2 = vec.gather_rows(tr.n2, best)
    n = vec.add(vec.add(vec.scale(n0, w), vec.scale(n1, bu)), vec.scale(n2, bv))
    return dict(t=t, normal=vec.normalize(n), prim=best,
                **materials_for(scene, tr.material_id[best].long()))


def fold_candidate(best, c):
    """One strict nearest-wins fold step over full-material candidates."""
    closer = c["t"] < best["t"]
    return dict(
        t=torch.where(closer, c["t"], best["t"]),
        normal=vec.where(closer, c["normal"], best["normal"]),
        albedo=vec.where(closer, c["albedo"], best["albedo"]),
        specular=vec.where(closer, c["specular"], best["specular"]),
        emission=vec.where(closer, c["emission"], best["emission"]),
        smoothness=torch.where(closer, c["smoothness"], best["smoothness"]),
        prim=torch.where(closer, c["prim"], best["prim"]),
    )


def combine_candidates(scene: Scene, ro: Vec3, rd: Vec3, candidates) -> Hit:
    """Nearest-wins merge of full-material candidates."""
    best = candidates[0]
    for c in candidates[1:]:
        best = fold_candidate(best, c)
    bt = best["t"]
    pos = vec.add(ro, vec.scale(rd, bt))
    prim = torch.where(bt < MISS_T, best["prim"], -1)
    return Hit(t=bt, position=pos, normal=best["normal"],
               albedo=best["albedo"], specular=best["specular"],
               emission=best["emission"], smoothness=best["smoothness"],
               prim=prim)


def trace_brute(scene: Scene, ro: Vec3, rd: Vec3, alive=None,
                bin_rays: bool = False, chunk: int = 8192) -> Hit:
    """Exhaustive closest-hit over ground + spheres + triangles.

    ``alive``/``bin_rays`` are accepted for tracer-interface parity; the
    dense oracle ignores them. ``chunk`` caps the rays per pass, lowered
    further so no (rays x triangles) temporary outgrows a fixed budget."""
    del alive, bin_rays
    budget = _CHUNK_ELEMS.get(ro[0].device.type, _CHUNK_ELEMS["cpu"])
    chunk = max(1, min(chunk, budget // max(scene.num_triangles, 1)))

    def body(rox, roy, roz, rdx, rdy, rdz):
        ro_c = (rox, roy, roz)
        rd_c = (rdx, rdy, rdz)
        cands = [_ground_candidate(scene, ro_c, rd_c),
                 _sphere_candidate(scene, ro_c, rd_c),
                 _triangle_candidate(scene, ro_c, rd_c)]
        return combine_candidates(scene, ro_c, rd_c, cands)

    return map_chunked(body, (*ro, *rd), chunk)


def make_brute_tracer(scene: Scene, chunk: int = 8192):
    return functools.partial(trace_brute, scene, chunk=chunk)
