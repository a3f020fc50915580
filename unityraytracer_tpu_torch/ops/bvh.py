"""LBVH acceleration structure: Morton sort + Karras radix tree over
triangle clusters (host numpy).

The port of the JAX package's ``ops/bvh.py``. The radix tree comes from the
native host library (``native.py``, ``csrc/lbvh.cpp``) where it builds, else
from the numpy builder here; both give the same tree, and the arrays are
equal to the JAX builder's. The CUDA kernels traverse this
structure straight from device memory (``ClusterAccel.to``).

Node layout: internal nodes 0..C-2, leaf nodes C-1..2C-2 (leaf k at C-1+k).
Root is node 0. Leaf k covers triangles [k*S, (k+1)*S).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..scene import Replaceable, Scene, Triangles, tree_to


@dataclasses.dataclass
class ClusterAccel(Replaceable):
    """Render-ready acceleration structure (numpy leaves; ``to`` uploads)."""

    triangles: Triangles   # Morton-reordered, padded to C * cluster_size
    cluster_vmin: object   # (C, 3)
    cluster_vmax: object   # (C, 3)
    node_vmin: object      # (2C-1, 3)
    node_vmax: object      # (2C-1, 3)
    node_left: object      # (2C-1,) int32 node index; -1 on leaves
    node_right: object     # (2C-1,) int32

    @property
    def num_clusters(self) -> int:
        return self.cluster_vmin.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.triangles.count // self.num_clusters

    def to(self, device) -> "ClusterAccel":
        return tree_to(self, device)


def morton_encode_3d(pts01: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for points normalized to [0, 1)^3. (N,3) -> (N,)."""
    q = np.clip((pts01 * 1024.0), 0, 1023).astype(np.uint64)

    def expand_bits(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (expand_bits(q[:, 0]) << np.uint64(2)) \
        | (expand_bits(q[:, 1]) << np.uint64(1)) | expand_bits(q[:, 2])


def _radix_tree(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Karras 2012 binary radix tree over sorted unique 64-bit keys.

    Returns (left, right): (C-1,) node-index arrays; child >= C-1 is the leaf
    (child - (C-1)).
    """
    n = len(keys)
    ikeys = [int(k) for k in keys]
    LEAF0 = n - 1

    def delta(i, j):
        if j < 0 or j >= n:
            return -1
        return 64 - (ikeys[i] ^ ikeys[j]).bit_length()

    left = np.full(n - 1, -1, np.int32)
    right = np.full(n - 1, -1, np.int32)
    for i in range(n - 1):
        d = 1 if delta(i, i + 1) > delta(i, i - 1) else -1
        dmin = delta(i, i - d)
        lmax = 2
        while delta(i, i + lmax * d) > dmin:
            lmax *= 2
        l = 0
        t = lmax // 2
        while t >= 1:
            if delta(i, i + (l + t) * d) > dmin:
                l += t
            t //= 2
        j = i + l * d
        dnode = delta(i, j)
        s = 0
        t = (l + 1) // 2
        while True:
            if delta(i, i + (s + t) * d) > dnode:
                s += t
            if t == 1:
                break
            t = (t + 1) // 2
        gamma = i + s * d + min(d, 0)
        lo, hi = min(i, j), max(i, j)
        left[i] = (LEAF0 + gamma) if lo == gamma else gamma
        right[i] = (LEAF0 + gamma + 1) if hi == gamma + 1 else gamma + 1
    return left, right


def _internal_aabbs(left, right, leaf_vmin, leaf_vmax):
    """Bottom-up AABB propagation over the radix tree (iterative postorder)."""
    C = len(leaf_vmin)
    n_nodes = 2 * C - 1
    vmin = np.empty((n_nodes, 3), np.float32)
    vmax = np.empty((n_nodes, 3), np.float32)
    vmin[C - 1:] = leaf_vmin
    vmax[C - 1:] = leaf_vmax
    if C == 1:
        return vmin, vmax
    stack = [(0, False)]
    while stack:
        node, expanded = stack.pop()
        if node >= C - 1:
            continue
        if expanded:
            l, r = left[node], right[node]
            vmin[node] = np.minimum(vmin[l], vmin[r])
            vmax[node] = np.maximum(vmax[l], vmax[r])
        else:
            stack.append((node, True))
            stack.append((int(left[node]), False))
            stack.append((int(right[node]), False))
    return vmin, vmax


def build_cluster_accel(triangles: Triangles, cluster_size: int = 64,
                        use_native: bool = True) -> ClusterAccel:
    """Build the LBVH + cluster structure from world-space triangles
    (numpy arrays or tensors on any device; the build runs on the host).
    ``use_native`` takes the radix tree from the native library when it is
    available (the numpy builder otherwise)."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    v0, v1, v2, n0, n1, n2, mid = (host(getattr(triangles, k)) for k in (
        "v0", "v1", "v2", "n0", "n1", "n2", "material_id"))
    T = len(v0)
    if T == 0:
        # Single empty cluster: degenerate triangles never hit.
        S = cluster_size
        z = np.zeros((S, 3), np.float32)
        tri = Triangles(v0=z, v1=z.copy(), v2=z.copy(),
                        n0=z.copy(), n1=z.copy(), n2=z.copy(),
                        material_id=np.zeros((S,), np.int32))
        one = np.zeros((1, 3), np.float32)
        return ClusterAccel(
            triangles=tri,
            cluster_vmin=one, cluster_vmax=one.copy(),
            node_vmin=one.copy(), node_vmax=one.copy(),
            node_left=np.full((1,), -1, np.int32),
            node_right=np.full((1,), -1, np.int32))

    # 1. Morton order on centroids.
    centroid = (v0 + v1 + v2) / 3.0
    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    codes = morton_encode_3d((centroid - lo) / extent)
    order = np.argsort(codes, kind="stable").astype(np.int64)

    def reorder_pad(a, pad_count, pad_value=0.0):
        a = a[order]
        if pad_count:
            pad = np.full((pad_count,) + a.shape[1:], pad_value, a.dtype)
            a = np.concatenate([a, pad], axis=0)
        return a

    S = cluster_size
    C = (T + S - 1) // S
    pad_count = C * S - T
    v0s, v1s, v2s = (reorder_pad(a, pad_count) for a in (v0, v1, v2))
    n0s, n1s, n2s = (reorder_pad(a, pad_count) for a in (n0, n1, n2))
    mids = reorder_pad(mid, pad_count)

    # 2. Cluster AABBs over real (unpadded) members.
    member_min = np.minimum(np.minimum(v0s, v1s), v2s).reshape(C, S, 3)
    member_max = np.maximum(np.maximum(v0s, v1s), v2s).reshape(C, S, 3)
    valid = (np.arange(C * S) < T).reshape(C, S, 1)
    cl_vmin = np.where(valid, member_min, np.inf).min(axis=1).astype(np.float32)
    cl_vmax = np.where(valid, member_max, -np.inf).max(axis=1).astype(np.float32)

    # 3. Radix tree over cluster keys (cluster centroid Morton, index-
    #    tiebroken so keys are unique as Karras requires).
    cl_centroid = (cl_vmin + cl_vmax) * 0.5
    cl_codes = morton_encode_3d((cl_centroid - lo) / extent)
    keys = (cl_codes.astype(np.uint64) << np.uint64(32)) \
        | np.arange(C, dtype=np.uint64)
    perm = np.argsort(keys, kind="stable")
    keys_sorted = keys[perm]
    # Triangles move with their cluster (leaf k = sorted cluster k).
    cl_vmin = cl_vmin[perm]
    cl_vmax = cl_vmax[perm]
    tri_perm = (perm[:, None] * S + np.arange(S)[None, :]).reshape(-1)
    v0s, v1s, v2s = v0s[tri_perm], v1s[tri_perm], v2s[tri_perm]
    n0s, n1s, n2s = n0s[tri_perm], n1s[tri_perm], n2s[tri_perm]
    mids = mids[tri_perm]

    if C > 1:
        tree = None
        if use_native:
            from .. import native
            tree = native.radix_tree(keys_sorted)
        left, right = tree if tree is not None else _radix_tree(keys_sorted)
        node_vmin, node_vmax = _internal_aabbs(left, right, cl_vmin, cl_vmax)
        node_left = np.concatenate([left, np.full(C, -1, np.int32)])
        node_right = np.concatenate([right, np.full(C, -1, np.int32)])
    else:
        node_vmin, node_vmax = cl_vmin.copy(), cl_vmax.copy()
        node_left = np.full(1, -1, np.int32)
        node_right = np.full(1, -1, np.int32)

    tri = Triangles(v0=v0s, v1=v1s, v2=v2s, n0=n0s, n1=n1s, n2=n2s,
                    material_id=np.asarray(mids, np.int32))
    return ClusterAccel(
        triangles=tri,
        cluster_vmin=cl_vmin, cluster_vmax=cl_vmax,
        node_vmin=node_vmin, node_vmax=node_vmax,
        node_left=np.asarray(node_left, np.int32),
        node_right=np.asarray(node_right, np.int32))


def build_accel(scene: Scene, cfg):
    """The acceleration structure a config's tracer needs: the ClusterAccel
    for "bvh", "cluster" and "pallas" (the CUDA kernels traverse it), None
    for "brute"."""
    if cfg.tracer == "brute":
        return None
    return build_cluster_accel(scene.triangles, cluster_size=cfg.cluster_size)


def validate_accel(accel: ClusterAccel, triangles_before: Triangles) -> None:
    """Assert structural invariants; raises AssertionError on violation.

    * every leaf reachable from the root exactly once
    * parent AABB contains both child AABBs
    * cluster AABBs contain their member triangles
    * reordered triangle soup is a permutation of the input (plus padding)
    """
    C = accel.num_clusters
    left = np.asarray(accel.node_left)
    right = np.asarray(accel.node_right)
    vmin = np.asarray(accel.node_vmin)
    vmax = np.asarray(accel.node_vmax)

    seen = np.zeros(2 * C - 1 if C > 1 else 1, bool)
    stack = [0]
    while stack:
        n = stack.pop()
        assert not seen[n], f"node {n} reached twice"
        seen[n] = True
        if left[n] >= 0:
            l, r = int(left[n]), int(right[n])
            for ch in (l, r):
                assert (vmin[n] <= vmin[ch] + 1e-5).all(), "parent vmin !⊇ child"
                assert (vmax[n] >= vmax[ch] - 1e-5).all(), "parent vmax !⊇ child"
            stack += [l, r]
    assert seen.all(), "unreachable nodes exist"

    S = accel.cluster_size
    v0 = np.asarray(accel.triangles.v0).reshape(C, S, 3)
    v1 = np.asarray(accel.triangles.v1).reshape(C, S, 3)
    v2 = np.asarray(accel.triangles.v2).reshape(C, S, 3)
    T = triangles_before.count
    cvmin = np.asarray(accel.cluster_vmin)
    cvmax = np.asarray(accel.cluster_vmax)
    # Padding rows are all-zero degenerates, detected by all-vertices-zero.
    real = ~((v0 == 0).all(-1) & (v1 == 0).all(-1) & (v2 == 0).all(-1))
    assert int(real.sum()) == T, "real-triangle count changed by reordering"
    for arr in (v0, v1, v2):
        inside_min = (arr >= cvmin[:, None, :] - 1e-5) | ~real[:, :, None]
        inside_max = (arr <= cvmax[:, None, :] + 1e-5) | ~real[:, :, None]
        assert inside_min.all() and inside_max.all(), "cluster AABB violated"

    if T:
        def key(vs):
            return set(map(tuple, np.round(vs.reshape(-1, 3), 4).tolist()))
        before = key(np.asarray(triangles_before.v0))
        after_v0 = v0.reshape(-1, 3)[real.reshape(-1)]
        assert key(after_v0) == before, "triangle set changed by reordering"
