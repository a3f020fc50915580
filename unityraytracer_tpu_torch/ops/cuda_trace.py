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
"""

from __future__ import annotations

import ctypes
import dataclasses

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
    triangles, so triangle indices agree)."""

    scene: Scene
    accel: ClusterAccel
    ground_enabled: float
    ground_material_id: int
    tables: dict
    _args: object = None

    @staticmethod
    def create(scene: Scene, accel: ClusterAccel, device=None) -> "KernelScene":
        if device is None:
            device = scene.skybox.device if isinstance(
                scene.skybox, torch.Tensor) else "cpu"
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
                           tables=kernel_tables(accel))

    @property
    def device(self) -> torch.device:
        return self.accel.node_left.device

    @property
    def plain_scene(self) -> Scene:
        return dataclasses.replace(self.scene, triangles=self.accel.triangles)

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
                ptr(tr.material_id))
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


def closest_hit_plain(ks: KernelScene, ro: Vec3, rd: Vec3, alive=None,
                      chunk: int = 8192) -> Hit:
    """Plain version of the closest-hit kernel: ``trace_brute`` over the
    accel's triangles; dead rays and misses carry t = INF and zero
    attributes, as the kernel writes them."""
    h = trace_brute(ks.plain_scene, ro, rd, chunk=chunk)
    hit = h.t < MISS_T
    if alive is not None:
        hit = hit & alive
    z = torch.zeros_like(h.t)
    rows = [torch.where(hit, h.t, INF)] + [
        torch.where(hit, c, z) for c in (*h.normal, *h.albedo, *h.specular,
                                         *h.emission, h.smoothness)]
    return _hit_from_rows(ro, rd, rows, torch.where(hit, h.prim, -1))


def trace_hits(ks: KernelScene, ro: Vec3, rd: Vec3, alive=None,
               counts=None) -> Hit:
    """Closest hit of every ray: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``alive``: optional (N,) bool; dead rays miss.
    ``counts``: optional (2, N) int32 CUDA tensor that the kernel fills with
    each ray's box and triangle tests. A traversal overflow raises at the
    next ``_build.raise_on_overflow``."""
    if ro[0].device.type == "cpu":
        return closest_hit_plain(ks, ro, rd, alive)
    if ro[0].device.type != "cuda":
        raise ValueError(f"no closest-hit kernel for device {ro[0].device}")
    n = _check_rays(ks, *ro, *rd)
    alive_f = (torch.ones(n, dtype=torch.float32, device=ks.device)
               if alive is None else alive.to(torch.float32).contiguous())
    ro3, rd3 = vec.stack(ro), vec.stack(rd)
    out = torch.empty((14, n), dtype=torch.float32, device=ks.device)
    prim = torch.empty((n,), dtype=torch.int32, device=ks.device)
    code = _build.lib().urt_trace_hits(
        ctypes.byref(ks.args), ro3.data_ptr(), rd3.data_ptr(),
        alive_f.data_ptr(), out.data_ptr(), prim.data_ptr(),
        check_counts(ks, counts, n), n,
        _build.error_flag(ks.device).data_ptr(), _build.stream_ptr(ks.device))
    _build.LAUNCHES["trace"] += 1
    _build.check(code, "trace")
    return _hit_from_rows(ro, rd, out, prim)


def make_pallas_tracer(scene: Scene, accel: ClusterAccel):
    """``fn(ro, rd, alive=None, bin_rays=False) -> Hit`` on the closest-hit
    kernel (``tracer="pallas"`` with ``megakernel=False``). ``bin_rays`` is
    accepted for interface parity; the kernel traces rays in their order."""
    ks = accel if isinstance(accel, KernelScene) else \
        KernelScene.create(scene, accel)

    def tracer(ro, rd, alive=None, bin_rays: bool = False) -> Hit:
        del bin_rays
        return trace_hits(ks, ro, rd, alive)

    return tracer
