"""Closest-hit tracers over the cluster LBVH: ``tracer="bvh"`` and
``"cluster"``.

The port of the JAX package's ``ops/traverse.py``. On the card both names
(and ``"pallas"`` with ``megakernel=False``) return the closest-hit kernel's
tracer, ``cuda_trace.make_pallas_tracer``: that kernel is already a per-ray
stack traversal of the same cluster LBVH, built from the same
``ClusterAccel``. The JAX package's two jnp strategies are the TPU's means
to that closest hit (masked lanes for divergent traversal, a dense sweep
with no per-lane gathers); on a GPU a thread per ray walks the tree itself.

On CPU tensors the two strategies run as ported, so the tests hold them
against the JAX functions:

* ``_triangle_bvh_candidate``: per-ray stack traversal of the radix tree as
  one lock-step loop over the batch with per-ray stacks (the TPU form of
  divergent traversal);
* ``_triangle_cluster_candidate``: every cluster box tested per ray,
  clusters sorted by entry distance, then swept in rounds until every ray's
  best hit precedes its nearest unvisited cluster.

Ground and spheres come from the dense candidates of ``ops/trace.py``. Hits
carry ``prim`` numbered as the kernel numbers it (triangles in accel order,
``C*S`` the ground, ``C*S + 1 + s`` sphere s).
"""

from __future__ import annotations

import torch

from ..scene import Scene
from ..utils.math3d import EPSILON, INF
from . import vec
from .bvh import ClusterAccel
from .cuda_trace import KernelScene, make_pallas_tracer
from .intersect import intersect_aabb, safe_inv_dir
from .shade import Hit
from .trace import (_ground_candidate, _sphere_candidate,
                    combine_candidates, map_chunked, materials_for)
from .vec import Vec3


def _cluster_triangle_hit(accel: ClusterAccel, ro: Vec3, rd: Vec3,
                          cluster_ids):
    """MT97 of each ray against its own cluster's triangles.

    ``ro``, ``rd``: Vec3 of (R,); ``cluster_ids``: (R,) integer. Returns the
    best (t, u, v, tri_idx) per ray within the cluster, t = INF on a miss;
    an exact tie goes to the lower triangle index (``argmin``)."""
    S = accel.cluster_size
    tr = accel.triangles
    tri_idx = (cluster_ids.long()[:, None] * S
               + torch.arange(S, device=cluster_ids.device)[None, :])

    def g(tab, k):
        return tab[:, k][tri_idx]                                # (R, S)

    v0x, v0y, v0z = g(tr.v0, 0), g(tr.v0, 1), g(tr.v0, 2)
    e1x = g(tr.v1, 0) - v0x
    e1y = g(tr.v1, 1) - v0y
    e1z = g(tr.v1, 2) - v0z
    e2x = g(tr.v2, 0) - v0x
    e2y = g(tr.v2, 1) - v0y
    e2z = g(tr.v2, 2) - v0z
    rox, roy, roz = (c[:, None] for c in ro)                     # (R, 1)
    rdx, rdy, rdz = (c[:, None] for c in rd)
    px = rdy * e2z - rdz * e2y
    py = rdz * e2x - rdx * e2z
    pz = rdx * e2y - rdy * e2x
    det = e1x * px + e1y * py + e1z * pz
    front = det >= EPSILON
    inv_det = 1.0 / torch.where(front, det, 1.0)
    tx = rox - v0x
    ty = roy - v0y
    tz = roz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (rdx * qx + rdy * qy + rdz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = front & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0)
    t = torch.where(ok, t, INF)
    s_best = torch.argmin(t, dim=1)[:, None]

    def take(a):
        return torch.gather(a, 1, s_best)[:, 0]

    return take(t), take(u), take(v), take(tri_idx)


def _finish_triangle_hit(scene: Scene, accel: ClusterAccel, t, u, v, tri_idx):
    """A full-material triangle candidate from the best (t, u, v, tri)."""
    tr = accel.triangles
    w = 1.0 - u - v
    n0 = vec.gather_rows(tr.n0, tri_idx)
    n1 = vec.gather_rows(tr.n1, tri_idx)
    n2 = vec.gather_rows(tr.n2, tri_idx)
    n = vec.add(vec.add(vec.scale(n0, w), vec.scale(n1, u)), vec.scale(n2, v))
    return dict(t=t, normal=vec.normalize(n), prim=tri_idx,
                **materials_for(scene, tr.material_id[tri_idx].long()))


def _pick(v3: Vec3, idx) -> Vec3:
    return tuple(c[idx] for c in v3)


def _take_better(best, idx, cand):
    """Write ``cand`` = (t, u, v, tri) of rays ``idx`` into ``best`` where
    its t is strictly smaller."""
    lt, lu, lv, ltri = cand
    take = lt < best[0][idx]
    sel = idx[take]
    for dst, src in zip(best, cand):
        dst[sel] = src[take]


# ---------------------------------------------------------------------------
# Strategy 1: per-ray stack traversal (lock-step loop)
# ---------------------------------------------------------------------------

STACK_DEPTH = 64  # fixed stack (the reference pins 32; LBVH depth over C
                  # clusters is <= ~2*log2(C), 64 covers C ~ 2^30)


def _aabb_single(ro: Vec3, inv: Vec3, bmin: Vec3, bmax: Vec3, best_t):
    """Per-ray slab test against per-ray boxes (all (R,) components)."""
    t_min = torch.full_like(ro[0], -INF)
    t_max = torch.full_like(ro[0], INF)
    for a in range(3):
        t1 = (bmin[a] - ro[a]) * inv[a]
        t2 = (bmax[a] - ro[a]) * inv[a]
        t_min = torch.maximum(t_min, torch.minimum(t1, t2))
        t_max = torch.minimum(t_max, torch.maximum(t1, t2))
    return (t_max >= t_min) & (t_max > 0) & (torch.clamp_min(t_min, 0.0)
                                             < best_t)


def _masked_push(stack, sp, value, mask):
    """``stack[i, sp[i]] = value[i]`` where ``mask[i]``, in place (one
    ``scatter_``; the loop owns the stack); the slot is clipped to the
    stack, as the JAX one-hot push clips it. Returns ``stack``."""
    slot = torch.clamp(sp, 0, STACK_DEPTH - 1).long()[:, None]
    cur = torch.gather(stack, 1, slot)[:, 0]
    return stack.scatter_(1, slot, torch.where(mask, value, cur)[:, None])


def _triangle_bvh_candidate(scene: Scene, accel: ClusterAccel, ro: Vec3,
                            rd: Vec3):
    """Closest triangle hit by masked stack traversal: every iteration pops
    one node per ray with a non-empty stack, tests its box, and either
    tests the leaf's cluster (rays at a leaf only) or pushes both
    children."""
    R = ro[0].shape[0]
    C = accel.num_clusters
    LEAF0 = C - 1 if C > 1 else 0
    dev = ro[0].device
    inv_rd = safe_inv_dir(rd)
    left, right = accel.node_left, accel.node_right

    stack = torch.zeros((R, STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = torch.ones((R,), dtype=torch.int32, device=dev)  # root pre-pushed
    best = (torch.full((R,), INF, device=dev), torch.zeros((R,), device=dev),
            torch.zeros((R,), device=dev),
            torch.zeros((R,), dtype=torch.int64, device=dev))

    while bool((sp > 0).any()):
        active = sp > 0
        top = torch.clamp_min(sp - 1, 0).long()[:, None]
        node = torch.where(active, torch.gather(stack, 1, top)[:, 0], 0).long()
        sp = torch.where(active, sp - 1, sp)

        hit = _aabb_single(ro, inv_rd, vec.gather_rows(accel.node_vmin, node),
                           vec.gather_rows(accel.node_vmax, node),
                           best[0]) & active
        is_leaf = left[node] < 0
        leaf = torch.nonzero(hit & is_leaf)[:, 0]
        if leaf.numel():
            ids = torch.clamp(node[leaf] - LEAF0, 0, C - 1)
            _take_better(best, leaf, _cluster_triangle_hit(
                accel, _pick(ro, leaf), _pick(rd, leaf), ids))

        push = hit & ~is_leaf
        stack = _masked_push(stack, sp, left[node], push)
        sp = torch.where(push, sp + 1, sp)
        stack = _masked_push(stack, sp, right[node], push)
        sp = torch.where(push, sp + 1, sp)
    return _finish_triangle_hit(scene, accel, *best)


# ---------------------------------------------------------------------------
# Strategy 2: dense cluster culling with sorted rounds
# ---------------------------------------------------------------------------

def _triangle_cluster_candidate(scene: Scene, accel: ClusterAccel, ro: Vec3,
                                rd: Vec3, round_size: int = 8):
    """Closest triangle hit by a sorted dense cluster sweep: rounds of
    ``round_size`` clusters, nearest entry first, while some ray's next
    unvisited cluster could beat its hit."""
    R = ro[0].shape[0]
    C = accel.num_clusters
    dev = ro[0].device
    inv_rd = safe_inv_dir(rd)

    hit, t_enter = intersect_aabb(ro, inv_rd, accel.cluster_vmin,
                                  accel.cluster_vmax)          # (R, C)
    t_enter = torch.where(hit, t_enter, INF)
    order = torch.argsort(t_enter, dim=1, stable=True)         # nearest first
    t_sorted = torch.gather(t_enter, 1, order)

    n_rounds = (C + round_size - 1) // round_size
    pad = n_rounds * round_size - C
    if pad:
        order = torch.nn.functional.pad(order, (0, pad))
        t_sorted = torch.nn.functional.pad(t_sorted, (0, pad), value=INF)

    best = (torch.full((R,), INF, device=dev), torch.zeros((R,), device=dev),
            torch.zeros((R,), device=dev),
            torch.zeros((R,), dtype=torch.int64, device=dev))
    rnd = 0
    while rnd < n_rounds and bool(
            (t_sorted[:, rnd * round_size] < best[0]).any()):
        for k in range(rnd * round_size, (rnd + 1) * round_size):
            useful = torch.nonzero(t_sorted[:, k] < best[0])[:, 0]
            if useful.numel():
                _take_better(best, useful, _cluster_triangle_hit(
                    accel, _pick(ro, useful), _pick(rd, useful),
                    order[useful, k]))
        rnd += 1
    return _finish_triangle_hit(scene, accel, *best)


# ---------------------------------------------------------------------------
# Tracer factories
# ---------------------------------------------------------------------------

def accel_tracer_plain(scene: Scene, accel, cfg):
    """``fn(ro, rd, alive=None, bin_rays=False) -> Hit`` for ``cfg.tracer``
    in {"bvh", "cluster"} through the JAX package's strategy of that name,
    in torch ops on the scene's device (``accel``: a ``ClusterAccel`` or a
    ``KernelScene``). Rays run in chunks of ``cfg.ray_chunk``; like the JAX
    tracers it ignores ``alive`` and ``bin_rays``."""
    tri_fn = {"bvh": _triangle_bvh_candidate,
              "cluster": _triangle_cluster_candidate}.get(cfg.tracer)
    if tri_fn is None:
        raise ValueError(f"no traversal strategy for tracer {cfg.tracer!r}")
    if isinstance(accel, KernelScene):
        scene, accel = accel.scene, accel.accel
    else:
        accel = accel.to(scene.skybox.device)
    has_tris = scene.num_triangles > 0
    # The accel's padded triangles number the ground and sphere prims as the
    # kernel numbers them.
    scene = scene.replace(triangles=accel.triangles)

    def tracer(ro: Vec3, rd: Vec3, alive=None, bin_rays: bool = False) -> Hit:
        del alive, bin_rays

        def body(rox, roy, roz, rdx, rdy, rdz):
            ro_c, rd_c = (rox, roy, roz), (rdx, rdy, rdz)
            cands = [_ground_candidate(scene, ro_c, rd_c),
                     _sphere_candidate(scene, ro_c, rd_c)]
            if has_tris:
                cands.append(tri_fn(scene, accel, ro_c, rd_c))
            return combine_candidates(scene, ro_c, rd_c, cands)

        return map_chunked(body, (*ro, *rd), cfg.ray_chunk)

    return tracer


def make_accel_tracer(scene: Scene, accel, cfg):
    """``fn(ro, rd, alive=None, bin_rays=False) -> Hit`` for ``cfg.tracer``
    in {"bvh", "cluster", "pallas"}: the closest-hit kernel's tracer for a
    scene on the card and for ``"pallas"``, ``accel_tracer_plain`` for
    ``"bvh"``/``"cluster"`` on the CPU."""
    device = accel.device if isinstance(accel, KernelScene) \
        else scene.skybox.device
    if cfg.tracer == "pallas" or device.type == "cuda":
        # Only "pallas" sorts its rays; "bvh" and "cluster" ignore bin_rays
        # as the JAX package's do (its ops/traverse.py:270).
        return make_pallas_tracer(scene, accel, sort=cfg.tracer == "pallas")
    if device.type != "cpu":
        raise ValueError(f"no tracer for device {device}")
    return accel_tracer_plain(scene, accel, cfg)
