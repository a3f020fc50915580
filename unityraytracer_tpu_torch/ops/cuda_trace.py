"""Closest-hit kernel wrapper and its plain version.

The counterpart of the JAX package's ``ops/pallas_trace.py`` as the bounce
loop uses it (``make_pallas_tracer`` with the merged ground/sphere/triangle
kernel). ``KernelScene`` holds a scene and its ``ClusterAccel`` on one
device, with the traversal tables the CUDA kernels read
(``kernel_tables``: float4 triangle records, per-leaf run boxes, 64-byte
inner-node records), derived once on the scene's device; ``trace_hits``
launches ``csrc/trace_kernel.cu`` for CUDA tensors and runs the plain version,
exhaustive MT97 over the accel's triangles (``ops/trace.py``), for CPU
tensors. Both apply the same winner rules, so their hits agree.

The ray coherence sort of the JAX kernels (``_ray_bin_ids`` and
``_bin_destinations``, scheme ``"oct_cell"``): ``ray_bin_ids`` keys each ray
by direction octant and origin cell around the centre of the scene's
triangle bounds (``scene_bbox``, carried by ``KernelScene``), dead rays in
the last bin; ``bin_destinations`` is the stable counting sort of each
window of ``SORT_WINDOW`` rays. With ``bin_rays`` both the kernel and the
plain version trace each window in that order and put the hits back in ray
order, so the sort changes no bit of any result.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _build
from ..scene import Scene
from ..utils.math3d import INF
from . import vec
from .bvh import ClusterAccel
from .shade import Hit, MISS_T
from .trace import trace_brute
from .vec import Vec3


RUNS = 8   # run boxes per leaf (URT_RUNS in csrc/closest_hit.cuh)
# Bins of the ray sort: 8 octants x 8 origin cells, the dead bin last, padded
# to 72 as the JAX kernel's _nbins("oct_cell") (URT_NBINS in
# csrc/ray_sort.cuh).
NBINS = 72
DEAD_BIN = NBINS - 1
# Rays sorted together: the kernels' thread-block size in a sorted launch
# (URT_SORT_W in csrc/ray_sort.cuh), passed to them as an argument, which
# they check.
SORT_WINDOW = 128


def scene_bbox(triangles) -> tuple:
    """The scene's triangle bounds as six floats (min xyz, max xyz), as the
    JAX package's ``PallasAccel.bbox`` (``pallas_trace.py:2952-2957``):
    over the scene's own triangles, (0, 0, 0, 1, 1, 1) when it has none."""
    if triangles is None or triangles.count == 0:
        return (0.0, 0.0, 0.0, 1.0, 1.0, 1.0)
    v = [np.asarray(torch.as_tensor(x).detach().cpu(), np.float32)
         for x in (triangles.v0, triangles.v1, triangles.v2)]
    lo = np.minimum(np.minimum(v[0], v[1]), v[2]).min(axis=0)
    hi = np.maximum(np.maximum(v[0], v[1]), v[2]).max(axis=0)
    return tuple(float(x) for x in np.concatenate([lo, hi]))


def bin_center(bbox) -> tuple:
    """The origin-cell split of the sort: the JAX kernel's ``0.5 * (lo +
    hi)`` in Python doubles, rounded to float32 once, as the kernel's weak
    scalar is when compared with float32 origins."""
    return tuple(float(np.float32(0.5 * (bbox[a] + bbox[a + 3])))
                 for a in range(3))


def ray_bin_ids(ro: Vec3, rd: Vec3, alive, center) -> torch.Tensor:
    """(N,) int32 bin of each ray: ``oct * 8 + cell`` with ``oct = (dx > 0)
    + 2 (dy > 0) + 4 (dz > 0)`` (false for -0.0) and ``cell`` the same of
    the origin against ``center``; ``DEAD_BIN`` where ``alive`` (bool, or
    None for all alive) is false."""
    i32 = torch.int32
    oct_ = ((rd[0] > 0).to(i32) + 2 * (rd[1] > 0).to(i32)
            + 4 * (rd[2] > 0).to(i32))
    cell = ((ro[0] > center[0]).to(i32) + 2 * (ro[1] > center[1]).to(i32)
            + 4 * (ro[2] > center[2]).to(i32))
    key = oct_ * 8 + cell
    return key if alive is None else key.masked_fill(~alive, DEAD_BIN)


def bin_destinations(bins: torch.Tensor, window: int = SORT_WINDOW
                     ) -> torch.Tensor:
    """(N,) int32 slot of each ray within its window of ``window`` rays in
    the stable sort by bin: rays of a lower bin first, rays of one bin in
    their order. A short last window sorts as if filled with dead rays,
    which go last, so its rays' slots stay below its length."""
    n = bins.shape[0]
    pad = (-n) % window
    b = torch.cat([bins.long(), bins.new_full((pad,), DEAD_BIN).long()])
    lane = torch.arange(window, device=bins.device)
    src = torch.argsort(b.reshape(-1, window) * window + lane, dim=1)
    dest = torch.empty_like(src).scatter_(1, src, lane.expand_as(src))
    return dest.reshape(-1)[:n].to(torch.int32)


def sort_slots(ro: Vec3, rd: Vec3, alive, center):
    """(slot, src): each ray's slot in the sorted order (its window's start
    plus ``bin_destinations``) and the ray at each slot."""
    n = ro[0].shape[0]
    dest = bin_destinations(ray_bin_ids(ro, rd, alive, center))
    ar = torch.arange(n, device=dest.device)
    slot = ar - ar % SORT_WINDOW + dest.long()
    return slot, torch.empty_like(ar).scatter_(0, slot, ar)


def kernel_tables(accel: ClusterAccel) -> dict:
    """The closest-hit function's traversal tables, derived from a
    ``ClusterAccel`` of tensors on its device (the accel itself stays as
    ``build_cluster_accel`` makes it, bit-exact with the JAX package's):

    * ``tris`` (C*S, 12) float32: per triangle in accel order three float4,
      v0, e1 = v1 - v0 and e2 = v2 - v0 (w = 0): the exact IEEE edges that
      MT97 forms itself, so its bits do not change.
    * ``leaf_boxes`` (C, 48) float32: leaf k split into ``RUNS`` runs of
      S / RUNS triangles, run r's box the exact min and max of its
      triangles' vertices (padding rows of the last cluster, degenerate
      triangles at the origin that never hit, included), as 12 float4:
      float4 (side * 3 + axis) * 2 + half holds runs 4 * half .. 4 * half
      + 3, side 0 the min.
    * ``nodes`` (max(C-1, 1), 16) int32: inner node m's record, float bits
      of x of (left min, left max, right min, right max), then y, then z,
      then its child codes (inner node c, or ~k for leaf k) and two zeros.
    * ``root_box`` (8,) float32: node 0's box, min xyz, max xyz, 0, 0.
    """
    C, S = accel.num_clusters, accel.cluster_size
    if S % RUNS:
        raise ValueError(f"cluster_size {S}: the kernels split a leaf into "
                         f"{RUNS} runs, so it must be a multiple of {RUNS}")
    tr = accel.triangles
    v0, v1, v2 = tr.v0, tr.v1, tr.v2
    pad = torch.zeros_like(v0[:, :1])
    tris = torch.cat([v0, pad, v1 - v0, pad, v2 - v0, pad], dim=1)

    runs = (C, RUNS, S // RUNS, 3)
    lo = torch.minimum(torch.minimum(v0, v1), v2).reshape(runs)
    hi = torch.maximum(torch.maximum(v0, v1), v2).reshape(runs)
    box = torch.stack([lo.amin(dim=2), hi.amax(dim=2)], dim=1)  # (C,2,R,3)
    leaf_boxes = box.permute(0, 1, 3, 2).reshape(C, 48).contiguous()

    vmin, vmax = accel.node_vmin, accel.node_vmax
    root_box = torch.cat([vmin[0], vmax[0], torch.zeros_like(vmin[0, :2])])
    if C == 1:
        nodes = torch.zeros((1, 16), dtype=torch.int32, device=v0.device)
    else:
        left = accel.node_left[:C - 1].long()
        right = accel.node_right[:C - 1].long()
        rows = [torch.stack([vmin[left, a], vmax[left, a], vmin[right, a],
                             vmax[right, a]], dim=1) for a in range(3)]
        bits = torch.cat(rows, dim=1).contiguous().view(torch.int32)

        def code(child):
            return torch.where(child >= C - 1, -(child - (C - 1)) - 1,
                               child).to(torch.int32)
        z = torch.zeros_like(bits[:, :2])
        nodes = torch.cat([bits, code(left)[:, None], code(right)[:, None], z],
                          dim=1).contiguous()
    return dict(tris=tris.contiguous(), leaf_boxes=leaf_boxes,
                nodes=nodes, root_box=root_box.contiguous())


@dataclasses.dataclass
class KernelScene:
    """A scene and its accel as contiguous float32/int32 tensors on one
    device, with the traversal tables of ``kernel_tables`` — what the CUDA
    kernels read — and what their plain versions test exhaustively
    (``plain_scene``: the scene with the accel's Morton-ordered, padded
    triangles, so triangle indices agree). ``bbox``: the scene's triangle
    bounds (``scene_bbox`` of ``scene.triangles``, not of the accel's
    padded triangles, whose zero padding would add the origin), and
    ``bin_center`` the sort's origin-cell split derived from it."""

    scene: Scene
    accel: ClusterAccel
    ground_enabled: float
    ground_material_id: int
    tables: dict
    bbox: tuple
    bin_center: tuple
    _args: object = None

    @staticmethod
    def create(scene: Scene, accel: ClusterAccel, device=None,
               bbox=None) -> "KernelScene":
        """``bbox``: the bounds that centre the ray sort, the scene's own by
        default; a scene shard takes the whole scene's, as the JAX
        package's shards do (``pallas_trace.py:3150-3159``)."""
        if device is None:
            device = scene.skybox.device if isinstance(
                scene.skybox, torch.Tensor) else "cpu"
        bbox = scene_bbox(scene.triangles) if bbox is None else \
            tuple(float(x) for x in bbox)
        scene = scene.to(device)
        accel = accel.to(device)
        for leaf in _leaves(scene) + _leaves(accel):
            if leaf.dtype not in (torch.float32, torch.int32) \
                    or not leaf.is_contiguous():
                raise TypeError(f"kernel scene leaf of dtype {leaf.dtype} "
                                "(contiguous float32/int32 required)")
        return KernelScene(scene=scene, accel=accel,
                           ground_enabled=float(scene.ground_enabled),
                           ground_material_id=int(scene.ground_material_id),
                           tables=kernel_tables(accel), bbox=bbox,
                           bin_center=bin_center(bbox))

    @property
    def device(self) -> torch.device:
        return self.accel.node_left.device

    @property
    def plain_scene(self) -> Scene:
        return self.scene.replace(triangles=self.accel.triangles)

    @property
    def args(self) -> _build.SceneArgs:
        """ctypes struct of device pointers (CUDA only)."""
        if self._args is None:
            s, a, t = self.scene, self.accel, self.tables
            sp, m, tr = s.spheres, s.materials, a.triangles
            ptr = lambda x: x.data_ptr()  # noqa: E731
            self._args = _build.SceneArgs(
                ptr(sp.center), ptr(sp.radius), ptr(sp.material_id),
                sp.count,
                ptr(m.albedo), ptr(m.specular), ptr(m.emission),
                ptr(m.smoothness),
                self.ground_enabled, self.ground_material_id,
                ptr(t["root_box"]), ptr(t["nodes"]), ptr(t["leaf_boxes"]),
                a.num_clusters, a.cluster_size,
                ptr(t["tris"]), ptr(tr.n0), ptr(tr.n1), ptr(tr.n2),
                ptr(tr.material_id), *self.bin_center)
        return self._args


def _leaves(obj):
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out += _leaves(v)
        elif isinstance(v, torch.Tensor) and f.name != "skybox_rgbe":
            out.append(v)
    return out


def _check_rays(ks: KernelScene, *arrays) -> int:
    n = arrays[0].shape[0]
    for a in arrays:
        if a.device != ks.device:
            raise ValueError(f"tensor on {a.device}, kernel scene on {ks.device}")
        if a.dtype != torch.float32 or a.shape != (n,):
            raise ValueError(f"expected ({n},) float32, got {tuple(a.shape)} "
                             f"{a.dtype}")
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays exceed the kernels' 32-bit indexing")
    return n


def check_counts(ks: KernelScene, counts, n: int):
    """Pointer of an optional (2, n) int32 traversal-count buffer on the
    kernel scene's device (None stays None)."""
    if counts is None:
        return None
    if counts.shape != (2, n) or counts.dtype != torch.int32 \
            or counts.device != ks.device or not counts.is_contiguous():
        raise ValueError(f"counts {tuple(counts.shape)} {counts.dtype} on "
                         f"{counts.device}, expected contiguous (2, {n}) "
                         "int32")
    return counts.data_ptr()


def _hit_from_rows(ro: Vec3, rd: Vec3, rows, prim) -> Hit:
    """Hit from the kernel's 14 output rows (t = INF on a miss)."""
    t = rows[0]
    tc = torch.clamp_max(t, 1.0e30)   # keeps miss positions finite
    pos = (ro[0] + tc * rd[0], ro[1] + tc * rd[1], ro[2] + tc * rd[2])
    return Hit(t=t, position=pos, normal=tuple(rows[1:4]),
               albedo=tuple(rows[4:7]), specular=tuple(rows[7:10]),
               emission=tuple(rows[10:13]), smoothness=rows[13],
               prim=prim.long())


def _plain_rows(ks: KernelScene, ro: Vec3, rd: Vec3, alive, chunk: int):
    """The kernel's 14 rows and winner by ``trace_brute`` over the accel's
    triangles; dead rays and misses carry t = INF and zero attributes."""
    h = trace_brute(ks.plain_scene, ro, rd, chunk=chunk)
    hit = h.t < MISS_T
    if alive is not None:
        hit = hit & alive
    z = torch.zeros_like(h.t)
    rows = [torch.where(hit, h.t, INF)] + [
        torch.where(hit, c, z) for c in (*h.normal, *h.albedo, *h.specular,
                                         *h.emission, h.smoothness)]
    return torch.stack(rows), torch.where(hit, h.prim, -1)


def closest_hit_plain(ks: KernelScene, ro: Vec3, rd: Vec3, alive=None,
                      chunk: int = 8192, bin_rays: bool = False) -> Hit:
    """Plain version of the closest-hit kernel: ``trace_brute`` over the
    accel's triangles; dead rays and misses carry t = INF and zero
    attributes, as the kernel writes them. With ``bin_rays`` the rays are
    traced in their sorted order (``sort_slots``) and the rows put back in
    ray order, as the kernel does."""
    if not bin_rays:
        rows, prim = _plain_rows(ks, ro, rd, alive, chunk)
        return _hit_from_rows(ro, rd, rows, prim)
    slot, src = sort_slots(ro, rd, alive, ks.bin_center)
    take = lambda v3: tuple(c[src] for c in v3)  # noqa: E731
    rows, prim = _plain_rows(ks, take(ro), take(rd),
                             None if alive is None else alive[src], chunk)
    return _hit_from_rows(ro, rd, rows[:, slot], prim[slot])


def launch_trace(ks: KernelScene, ro: Vec3, rd: Vec3, alive=None,
                 counts=None, order=None, mode: int = 0):
    """One launch of the closest-hit kernel on CUDA tensors: (rows (14, N),
    prim (N,) int32). ``mode`` 0 traces the rays in their order, 1 in their
    sorted order in windows of ``SORT_WINDOW`` rays, 2 runs the sorted launch's
    bin, sort and scatter without the traversal (every ray a miss; for
    timing the prologue). ``order``: optional (N,) int32 tensor that gets
    each ray's slot in its window (sorted modes only)."""
    n = _check_rays(ks, *ro, *rd)
    if order is not None and (not mode or order.shape != (n,)
                              or order.dtype != torch.int32
                              or order.device != ks.device
                              or not order.is_contiguous()):
        raise ValueError(f"order {tuple(order.shape)} {order.dtype} on "
                         f"{order.device}: a contiguous ({n},) int32 tensor "
                         "of a sorted launch")
    alive_f = (torch.ones(n, dtype=torch.float32, device=ks.device)
               if alive is None else alive.to(torch.float32).contiguous())
    ro3, rd3 = vec.stack(ro), vec.stack(rd)
    out = torch.empty((14, n), dtype=torch.float32, device=ks.device)
    prim = torch.empty((n,), dtype=torch.int32, device=ks.device)
    with _build.on_card(out.device):
        code = _build.lib().urt_trace_hits(
            ctypes.byref(ks.args), ro3.data_ptr(), rd3.data_ptr(),
            alive_f.data_ptr(), out.data_ptr(), prim.data_ptr(),
            check_counts(ks, counts, n),
            order.data_ptr() if order is not None else None, n, mode,
            SORT_WINDOW, _build.error_flag(out.device).data_ptr(),
            _build.stream_ptr(out.device))
    _build.check(code, "trace")
    _build.count("trace", out.device)
    return out, prim


def trace_hits(ks: KernelScene, ro: Vec3, rd: Vec3, alive=None,
               counts=None, bin_rays: bool = False, order=None) -> Hit:
    """Closest hit of every ray: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``alive``: optional (N,) bool; dead rays miss.
    ``counts``: optional (2, N) int32 CUDA tensor that the kernel fills with
    each ray's box and triangle tests. ``bin_rays``: trace each window of
    ``SORT_WINDOW`` rays in its sorted order (the JAX kernel's coherence sort;
    the hits are the same bits); ``order`` (with ``bin_rays``) gets each
    ray's slot in its window. A traversal overflow raises at the next
    ``_build.raise_on_overflow``."""
    if ro[0].device.type == "cpu":
        if order is not None and bin_rays:
            order.copy_(bin_destinations(
                ray_bin_ids(ro, rd, alive, ks.bin_center)))
        return closest_hit_plain(ks, ro, rd, alive, bin_rays=bin_rays)
    if ro[0].device.type != "cuda":
        raise ValueError(f"no closest-hit kernel for device {ro[0].device}")
    out, prim = launch_trace(ks, ro, rd, alive, counts, order,
                             1 if bin_rays else 0)
    return _hit_from_rows(ro, rd, out, prim)


def make_pallas_tracer(scene: Scene, accel: ClusterAccel, cfg=None,
                       interpret=None, *, sort: bool = True):
    """``fn(ro, rd, alive=None, bin_rays=False) -> Hit`` on the closest-hit
    kernel (``tracer="pallas"`` with ``megakernel=False``), which sorts the
    rays when the bounce loop asks (``bin_rays``). ``cfg`` and
    ``interpret`` take the JAX signature's places and change no hit: the
    kernel reads no config, and a CPU tensor, not ``interpret``, selects
    the plain version. ``sort=False`` ignores ``bin_rays``, as the JAX
    package's ``"bvh"`` and ``"cluster"`` tracers do
    (``ops/traverse.py:270``)."""
    del cfg, interpret
    ks = accel if isinstance(accel, KernelScene) else \
        KernelScene.create(scene, accel)

    def tracer(ro, rd, alive=None, bin_rays: bool = False) -> Hit:
        return trace_hits(ks, ro, rd, alive, bin_rays=sort and bin_rays)

    return tracer
