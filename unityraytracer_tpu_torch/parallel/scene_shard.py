"""Scene sharding: each logical shard holds 1/n of the triangles.

The port of the JAX package's ``parallel/scene_shard.py``.

* **Host prep.** ``shard_scene_accels`` sorts the triangles by the Morton
  code of their centroid (each shard a spatially compact slab), splits them
  into ``n`` equal chunks padded with degenerate triangles parked at
  ``_FAR`` (det == 0 never hits), and builds one equal-shape
  ``ClusterAccel`` per chunk, stacked leaf-wise along a leading shard axis:
  the same host arrays as the JAX function's. ``shard_scene_pallas_accels``
  is the same split with ``tracer="pallas"``'s padding: degenerate
  triangles anchored at the shard's last vertex, so no box of the shard
  stretches toward ``_FAR``. ``shard_kernel_scenes`` puts shard k's accel
  on its device as a ``KernelScene``, the closest-hit kernel's input.
* **The combine.** Every shard traces all rays against its sub-scene (the
  ground and spheres are in every shard; the min is idempotent over equal
  records), and ``allreduce_hit`` picks the closest hit on the device
  that shades.

Shading runs once, on the first shard's device, so the frame is the one a
single device renders from the same key, up to exact ties between
triangles of different shards.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from .. import _build
from ..ops.bvh import ClusterAccel, build_cluster_accel, morton_encode_3d
from ..ops.cuda_trace import KernelScene, scene_bbox
from ..ops.shade import Hit
from ..scene import Scene, Triangles, tree_map

# Padding triangles park far outside every real scene (the parked-ray
# convention of render.py): degenerate (det == 0, never hit), their point
# boxes outside any real geometry.
_FAR = 1.0e7


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _morton_sorted_soa(scene: Scene):
    """Triangle SoA arrays in Morton-centroid order (host numpy)."""
    tr = scene.triangles
    v0, v1, v2, n0, n1, n2 = (_host(getattr(tr, k)).astype(np.float32)
                              for k in ("v0", "v1", "v2", "n0", "n1", "n2"))
    mid = _host(tr.material_id).astype(np.int32)
    T = len(v0)
    if T:
        centroid = (v0 + v1 + v2) / 3.0
        lo = centroid.min(axis=0)
        extent = np.maximum(centroid.max(axis=0) - lo, 1e-12)
        order = np.argsort(morton_encode_3d((centroid - lo) / extent),
                           kind="stable")
        v0, v1, v2, n0, n1, n2, mid = (a[order]
                                       for a in (v0, v1, v2, n0, n1, n2, mid))
    return v0, v1, v2, n0, n1, n2, mid, T


def _stack(trees):
    """Stack equal-shape dataclass trees leaf-wise along a new axis 0."""
    first = trees[0]
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _stack([getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(first)})
    return np.stack(trees)


def shard_scene_accels(scene: Scene, cfg, n_dev: int) -> ClusterAccel:
    """Split the scene's triangles into ``n_dev`` Morton-contiguous chunks,
    padded to equal length with ``_FAR`` degenerates, and build one
    ClusterAccel per chunk. Returns them stacked leaf-wise along a leading
    shard axis (host numpy, equal to the JAX function's arrays)."""
    v0, v1, v2, n0, n1, n2, mid, T = _morton_sorted_soa(scene)
    per = max(-(-T // n_dev), 1)

    def chunk(a, k, fill):
        part = a[k * per:(k + 1) * per]
        pad = per - len(part)
        if pad:
            part = np.concatenate(
                [part, np.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)
        return part

    accels = []
    for k in range(n_dev):
        tris = Triangles(
            v0=chunk(v0, k, _FAR), v1=chunk(v1, k, _FAR),
            v2=chunk(v2, k, _FAR),
            n0=chunk(n0, k, 0.0), n1=chunk(n1, k, 0.0), n2=chunk(n2, k, 0.0),
            material_id=chunk(mid, k, 0))
        accels.append(build_cluster_accel(tris,
                                          cluster_size=cfg.cluster_size))
    return _stack(accels)


def shard_scene_pallas_accels(scene: Scene, cfg, n_dev: int) -> ClusterAccel:
    """The split of ``shard_scene_accels`` with the JAX ``tracer="pallas"``
    shards' padding: the degenerates sit at the shard's last real vertex
    (v0 == v1 == v2, det == 0), inside the shard's own box, where the
    ``_FAR`` padding would stretch the last leaf's box and every box above
    it to 1e7 and get it tested by nearly every ray. The JAX package also
    gives each shard the whole scene's bbox, which centres its kernel's ray
    sort; ``shard_kernel_scenes`` does the same."""
    v0, v1, v2, n0, n1, n2, mid, T = _morton_sorted_soa(scene)
    per = max(-(-T // n_dev), 1)

    accels = []
    for k in range(n_dev):
        sl = slice(k * per, (k + 1) * per)
        cv0, cv1, cv2 = v0[sl], v1[sl], v2[sl]
        cn0, cn1, cn2, cmid = n0[sl], n1[sl], n2[sl], mid[sl]
        pad = per - len(cv0)
        if pad:
            anchor = (cv0[-1:] if len(cv0)
                      else np.zeros((1, 3), np.float32))
            pt = np.repeat(anchor, pad, axis=0)
            cv0, cv1, cv2 = (np.concatenate([c, pt]) for c in (cv0, cv1, cv2))
            zz = np.zeros((pad, 3), np.float32)
            cn0, cn1, cn2 = (np.concatenate([c, zz]) for c in (cn0, cn1, cn2))
            cmid = np.concatenate([cmid, np.zeros((pad,), cmid.dtype)])
        tris = Triangles(v0=cv0, v1=cv1, v2=cv2, n0=cn0, n1=cn1, n2=cn2,
                         material_id=cmid)
        accels.append(build_cluster_accel(tris,
                                          cluster_size=cfg.cluster_size))
    return _stack(accels)


def local_accel(stacked_accel: ClusterAccel, k: int) -> ClusterAccel:
    """Shard ``k`` of a stacked accel."""
    return tree_map(lambda a: a[k], stacked_accel)


def shard_kernel_scenes(scene: Scene, stacked_accel: ClusterAccel,
                        devices: Sequence) -> List[KernelScene]:
    """Shard k's ``KernelScene`` (the scene with ``local_accel(stacked, k)``)
    on ``devices[k]``; the scene is uploaded once per distinct device. Every
    shard sorts its rays around the whole scene's bounds, as the JAX
    package's shards do (``pallas_trace.py:3150-3159``)."""
    bbox = scene_bbox(scene.triangles)
    on = {}
    out = []
    for k, d in enumerate(devices):
        d = torch.device(d)
        if d not in on:
            on[d] = scene.to(d)
        out.append(KernelScene.create(on[d], local_accel(stacked_accel, k), d,
                                      bbox=bbox))
    return out


_ROWS = ("position", "normal", "albedo", "specular", "emission")


def on_device(device):
    """Context that makes ``device`` the current CUDA device (a no-op off
    the card), so that a shard's torch work that names no card, and its
    current stream, are that card's. Each kernel wrapper also makes its
    tensors' card current around its own launch (``_build.on_card``)."""
    device = torch.device(device)
    return (_build.on_card(device) if device.type == "cuda"
            else contextlib.nullcontext())


def allreduce_hit(hits: Sequence[Hit], device=None) -> Hit:
    """The closest hit across scene shards, on ``device`` (the first hit's
    by default): each shard's records are copied there, the winner is the
    least t, and a tie goes to the lowest shard index (a cross-shard tie is
    nearly always the replicated ground or a sphere, the same record
    everywhere).

    The JAX package selects the winner's 16 attribute rows with one stacked
    ``psum`` of rows × (shard == winner). A sum turns a winning -0.0 into
    +0.0 and a loser's infinite row times 0 into NaN; here each row is
    taken from the winner with a chain of ``where`` instead, which keeps
    the winner's bits, so the combine equals a single trace of the whole
    scene wherever no exact tie crosses shards. ``prim`` is shard-local and
    is not combined (None)."""
    dev = hits[0].t.device if device is None else torch.device(device)
    t = [h.t.to(dev) for h in hits]
    tmin = t[0]
    for tk in t[1:]:
        tmin = torch.minimum(tmin, tk)
    win = torch.full_like(tmin, len(hits), dtype=torch.int32)
    for k in reversed(range(len(hits))):
        win = torch.where(t[k] <= tmin, k, win)

    def select(get):
        out = get(hits[0]).to(dev)
        for k in range(1, len(hits)):
            out = torch.where(win == k, get(hits[k]).to(dev), out)
        return out

    rows = {name: tuple(select(lambda h, n=name, c=c: getattr(h, n)[c])
                        for c in range(3)) for name in _ROWS}
    return Hit(t=tmin, smoothness=select(lambda h: h.smoothness), **rows)


def make_scene_sharded_tracer(shards: Sequence[KernelScene], cfg):
    """The sub-scene tracers of ``shards`` (``traverse.make_accel_tracer``
    each: the closest-hit kernel on the card) with the cross-shard combine:
    the rays are copied to each shard's device, traced, and the hits
    combined on the rays' device."""
    from ..ops.traverse import make_accel_tracer

    bases = [(ks.device, make_accel_tracer(ks.scene, ks, cfg))
             for ks in shards]

    def tracer(ro, rd, alive=None, bin_rays: bool = False) -> Hit:
        def on(d, v3):
            return tuple(c.to(d) for c in v3)

        hits = []
        for d, base in bases:
            with on_device(d):
                hits.append(base(on(d, ro), on(d, rd), None if alive is None
                                 else alive.to(d), bin_rays))
        return allreduce_hit(hits, ro[0].device)

    return tracer
