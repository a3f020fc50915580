"""Acceleration-structure inspection — the code equivalent of the reference's
editor gizmos (DrawBVHTree / DrawNormals / test-ray highlight,
RayTraceDebug.cs:92-183), replaced by dump-to-numpy + OBJ export since a
headless framework has no editor viewport. The accel may hold numpy leaves
(as ``build_cluster_accel`` returns it) or tensors on any device; the probe
ray is tested with torch on the CPU.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..ops.bvh import ClusterAccel
from ..ops.intersect import intersect_aabb, safe_inv_dir


def _host(a, dtype=None) -> np.ndarray:
    """An accel leaf as a numpy array, from the host or from a device."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def accel_stats(accel: ClusterAccel) -> Dict:
    """Structure summary (the analog of the BVH depth/length log lines,
    RayTraceMaster.cs:734-735)."""
    C = accel.num_clusters
    left = _host(accel.node_left)
    vmin = _host(accel.node_vmin)
    vmax = _host(accel.node_vmax)
    right = _host(accel.node_right)

    depths = {0: 0}
    max_depth = 0
    stack = [0]
    while stack:
        n = stack.pop()
        if left[n] >= 0:
            for ch in (int(left[n]), int(right[n])):
                depths[ch] = depths[n] + 1
                max_depth = max(max_depth, depths[ch])
                stack.append(ch)
    ext = np.maximum(vmax - vmin, 0)
    return dict(
        num_clusters=C,
        cluster_size=accel.cluster_size,
        num_triangles=accel.triangles.count,
        num_nodes=len(left),
        max_depth=max_depth,
        root_volume=float(np.prod(ext[0])) if len(ext) else 0.0,
        mean_leaf_volume=float(np.mean(np.prod(
            np.maximum(_host(accel.cluster_vmax)
                       - _host(accel.cluster_vmin), 0), axis=1))),
    )


def dump_tree(accel: ClusterAccel, max_nodes: int = 64) -> str:
    """ASCII tree of the radix hierarchy with AABBs and (heap, leaf) labels —
    the textual DrawBVH (RayTraceDebug.cs:92-117)."""
    left = _host(accel.node_left)
    right = _host(accel.node_right)
    vmin = _host(accel.node_vmin)
    vmax = _host(accel.node_vmax)
    C = accel.num_clusters
    lines: List[str] = []

    def walk(n, depth):
        if len(lines) >= max_nodes:
            return
        box = (f"[{vmin[n][0]:.2f},{vmin[n][1]:.2f},{vmin[n][2]:.2f}]-"
               f"[{vmax[n][0]:.2f},{vmax[n][1]:.2f},{vmax[n][2]:.2f}]")
        if left[n] < 0:
            leaf = n - (C - 1) if C > 1 else 0
            lines.append("  " * depth + f"leaf #{leaf} node={n} {box}")
        else:
            lines.append("  " * depth + f"node {n} {box}")
            walk(int(left[n]), depth + 1)
            walk(int(right[n]), depth + 1)

    walk(0, 0)
    if len(lines) >= max_nodes:
        lines.append(f"... truncated at {max_nodes} nodes")
    return "\n".join(lines)


def to_implicit_heap(accel: ClusterAccel):
    """Re-encode the LBVH in the reference's implicit complete-binary-heap
    array layout — the CPU-side debug/compat representation promised by the
    build plan (SURVEY §7 step 3).

    Matches the contract of ``JoinBVH`` (RayTraceMaster.cs:459-505): children
    of heap slot ``i`` live at ``2i+1`` / ``2i+2``; the LARGER subtree goes
    left (cs:468-472); slots under a shallow subtree are padded with filler
    nodes ``{vmin=0, vmax=0, index=-1}`` (cs:490-494). Leaves carry their
    cluster index in ``index`` (>= 0); internal nodes carry -1, exactly the
    ``index < 0`` parent test the reference traversal uses
    (RayTraceShader.compute:313-314). Pure numpy, debug/interop only — the
    CUDA kernels traverse the tables of ``ops/cuda_trace.kernel_tables``,
    never this.

    Returns ``(vmin, vmax, index)``: ``(M, 3) f32 ×2`` and ``(M,) int32``
    with ``M = 2**depth - 1`` for the deepest root-to-leaf path.
    """
    left = _host(accel.node_left)
    right = _host(accel.node_right)
    nvmin = _host(accel.node_vmin, np.float32)
    nvmax = _host(accel.node_vmax, np.float32)
    C = accel.num_clusters
    LEAF0 = C - 1 if C > 1 else 0

    # Subtree sizes (node count) drive the larger-goes-left rule; depths
    # size the heap. Iterative post-order over the pointer tree.
    size = np.ones(len(left), np.int64)
    depth_of = {0: 0}
    max_depth = 0
    order: List[int] = []
    stack = [0]
    while stack:
        n = stack.pop()
        order.append(n)
        max_depth = max(max_depth, depth_of[n])
        if left[n] >= 0:
            for ch in (int(left[n]), int(right[n])):
                depth_of[ch] = depth_of[n] + 1
                stack.append(ch)
    for n in reversed(order):
        if left[n] >= 0:
            size[n] = 1 + size[int(left[n])] + size[int(right[n])]

    M = (1 << (max_depth + 1)) - 1
    hvmin = np.zeros((M, 3), np.float32)
    hvmax = np.zeros((M, 3), np.float32)
    hidx = np.full(M, -1, np.int32)

    place = [(0, 0)]
    while place:
        n, slot = place.pop()
        hvmin[slot] = nvmin[n]
        hvmax[slot] = nvmax[n]
        if left[n] < 0:
            hidx[slot] = n - LEAF0 if C > 1 else 0
        else:
            l, r = int(left[n]), int(right[n])
            if size[r] > size[l]:                     # larger subtree LEFT
                l, r = r, l
            place.append((l, 2 * slot + 1))
            place.append((r, 2 * slot + 2))
    return hvmin, hvmax, hidx


def export_aabbs_obj(accel: ClusterAccel, path: str,
                     leaves_only: bool = True) -> str:
    """Write cluster (or all node) AABBs as wireframe boxes in an OBJ file —
    load in any viewer to eyeball the hierarchy like the editor gizmos."""
    if leaves_only:
        vmin = _host(accel.cluster_vmin)
        vmax = _host(accel.cluster_vmax)
    else:
        vmin = _host(accel.node_vmin)
        vmax = _host(accel.node_vmax)
    with open(path, "w") as f:
        for i, (lo, hi) in enumerate(zip(vmin, vmax)):
            base = i * 8 + 1
            for zc in (lo[2], hi[2]):
                for yc in (lo[1], hi[1]):
                    for xc in (lo[0], hi[0]):
                        f.write(f"v {xc} {yc} {zc}\n")
            edges = [(0, 1), (1, 3), (3, 2), (2, 0), (4, 5), (5, 7), (7, 6),
                     (6, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
            for a, b in edges:
                f.write(f"l {base + a} {base + b}\n")
    return path


def export_normals_obj(triangles, path: str, scale: float = 0.25,
                       max_tris: int = 50_000) -> str:
    """Write per-vertex normal vectors as OBJ line segments — the headless
    analog of the editor normal gizmos (``RayTraceDebug.DrawNormals``,
    RayTraceDebug.cs:165-183: a line from each vertex along its normal).

    Args:
      triangles: a Triangles SoA (scene.triangles or accel.triangles).
      scale: segment length in world units (the reference's ``normalLength``).
      max_tris: safety cap for huge scenes (uniformly strided).
    """
    v = [_host(x) for x in (triangles.v0, triangles.v1, triangles.v2)]
    n = [_host(x) for x in (triangles.n0, triangles.n1, triangles.n2)]
    T = len(v[0])
    stride = max(1, (T + max_tris - 1) // max_tris)
    with open(path, "w") as f:
        count = 0
        for ti in range(0, T, stride):
            for c in range(3):
                p = v[c][ti]
                q = p + n[c][ti] * scale
                f.write(f"v {p[0]} {p[1]} {p[2]}\n")
                f.write(f"v {q[0]} {q[1]} {q[2]}\n")
                f.write(f"l {count * 2 + 1} {count * 2 + 2}\n")
                count += 1
    return path


def test_ray_report(accel: ClusterAccel, origin, direction) -> Dict:
    """Host-side ray-vs-hierarchy probe (the steerable debug test ray,
    RayTraceDebug.cs:70-89,120-133): which clusters does this ray's slab test
    touch, in entry order?"""
    import torch

    o = np.asarray(origin, np.float32)
    d = np.asarray(direction, np.float64)
    d = (d / np.linalg.norm(d)).astype(np.float32)
    ro = tuple(torch.full((1,), float(o[k])) for k in range(3))
    rdt = tuple(torch.full((1,), float(d[k])) for k in range(3))
    hit, t_enter = intersect_aabb(ro, safe_inv_dir(rdt),
                                  torch.as_tensor(_host(accel.cluster_vmin)),
                                  torch.as_tensor(_host(accel.cluster_vmax)))
    hit = hit.numpy()[0]
    t_enter = t_enter.numpy()[0]
    order = np.argsort(np.where(hit, t_enter, np.inf))
    touched = [(int(c), float(t_enter[c])) for c in order if hit[c]]
    return dict(n_touched=len(touched), clusters=touched[:32])
