"""Closest-hit kernel wrapper and its plain version.

The counterpart of the JAX package's ``ops/pallas_trace.py`` as the bounce
loop uses it (``make_pallas_tracer`` with the merged ground/sphere/triangle
kernel). ``KernelScene`` holds a scene and its ``ClusterAccel`` on one
device in the layout the CUDA kernels read; ``trace_hits`` launches
``csrc/trace_kernel.cu`` for CUDA tensors and runs the plain version,
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


@dataclasses.dataclass
class KernelScene:
    """A scene and its accel as contiguous float32/int32 tensors on one
    device — what the CUDA kernels read, and what their plain versions
    test exhaustively (``plain_scene``: the scene with the accel's
    Morton-ordered, padded triangles, so triangle indices agree)."""

    scene: Scene
    accel: ClusterAccel
    ground_enabled: float
    ground_material_id: int
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
                           ground_material_id=int(scene.ground_material_id))

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
            s, a = self.scene, self.accel
            sp, m, tr = s.spheres, s.materials, a.triangles
            ptr = lambda t: t.data_ptr()  # noqa: E731
            self._args = _build.SceneArgs(
                ptr(sp.center), ptr(sp.radius), ptr(sp.material_id),
                sp.count,
                ptr(m.albedo), ptr(m.specular), ptr(m.emission),
                ptr(m.smoothness),
                self.ground_enabled, self.ground_material_id,
                ptr(a.node_vmin), ptr(a.node_vmax), ptr(a.node_left),
                ptr(a.node_right), a.num_clusters, a.cluster_size,
                ptr(tr.v0), ptr(tr.v1), ptr(tr.v2), ptr(tr.n0), ptr(tr.n1),
                ptr(tr.n2), ptr(tr.material_id))
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


def trace_hits(ks: KernelScene, ro: Vec3, rd: Vec3, alive=None) -> Hit:
    """Closest hit of every ray: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``alive``: optional (N,) bool; dead rays miss.
    A traversal overflow raises at the next ``_build.raise_on_overflow``."""
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
        alive_f.data_ptr(), out.data_ptr(), prim.data_ptr(), n,
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
