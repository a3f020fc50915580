"""Per-ray twins of three CUDA kernels, written from one ray as each kernel
computes it, for tests on the CPU and on the card (no JAX here):

* ``bounce_rows_twin``: ``csrc/uniform_kernel.cu:urt_bounce_rows_kernel``,
  the keys of its prologue (``bounce_prologue_keys``), the counters of ray
  i and the five rows it writes per bounce;
* ``camera_rays_twin``: ``csrc/camera_kernel.cu:urt_camera_rays_kernel``
  from the ``CameraArgs`` it is launched with: the keys of its prologue
  (``camera_prologue_keys``), ray i's lattice and counter, its four draws
  and the camera, in the kernel's order of operations;
* ``closest_hit_twin``: ``csrc/closest_hit.cuh:urt_closest_hit`` on the
  tables of ``ops/cuda_trace.kernel_tables``, in float32 numpy, with the
  kernel's box and triangle test counts.

float32 numpy arithmetic rounds as the kernels do under ``-fmad=false``
(IEEE add, multiply, divide and square root, min and max exact).
"""

import numpy as np
import torch

from unityraytracer_tpu_torch import rng

MASK = 0xFFFFFFFF
F32_MAX = np.float32(3.402823466e+38)
WIDEN = np.float32(1.0000004)
RUNS = 8


def ray_lattice(n, h, W, blocked):
    """(s, row, px) of rays ``n`` (int64 tensor), as the kernel computes
    them: 8x16 block order when ``blocked``, row-major otherwise."""
    hw = h * W
    s = n // hw
    if blocked:
        w16 = W // 16
        px = (n // 128) % w16 * 16 + n % 16
        row = (n // (128 * w16)) % (h // 8) * 8 + (n // 16) % 8
    else:
        px = n % W
        row = (n // W) % h
    return s, row, px


def rr_counter(cfg, h, row0, blocked, n):
    """The roulette draw's counter of rays ``n``."""
    W = cfg.width
    s, row, px = ray_lattice(n, h, W, blocked)
    if cfg.rr_group == "step":
        Hg, Wg = (cfg.height + 7) // 8, (W + 127) // 128
        return s * Hg * Wg + (row0 + row) // 8 * Wg + px // 128
    return s * h * W + row * W + px


def uniform_at(key, counters):
    """float32 uniforms of ``key`` at int64 ``counters``."""
    k = np.asarray(key, np.uint32)
    b1, b2 = rng.threefry2x32(int(k[0]), int(k[1]), counters >> 32,
                             counters & MASK)
    bits = b1 ^ b2
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _hash_key(key, data):
    """threefry(key, (0, data)): one prologue thread's hash."""
    k = np.asarray(key, np.uint32)
    return np.array(rng.threefry2x32(int(k[0]), int(k[1]), 0, data),
                    np.uint32)


def bounce_prologue_keys(k_bounce, nb):
    """(nb, 4, 2) keys of the uniform-row kernel's prologue: level one hashes
    kb = (k_bounce, (0, b)), level two (kb, (0, row))."""
    kb = [_hash_key(k_bounce, b) for b in range(nb)]
    return np.array([[_hash_key(kb[b], row) for row in range(4)]
                     for b in range(nb)], np.uint32).reshape(nb, 4, 2)


def camera_prologue_keys(key):
    """(4, 2) keys of the camera-ray kernel's prologue, jitter x, jitter y,
    lens 1, lens 2: level one hashes parent j = (key, (0, j)) for j = 0, 1,
    level two (parent j, (0, r)) for r = 0, 1."""
    parent = [_hash_key(key, j) for j in range(2)]
    return np.array([_hash_key(parent[j], r) for j in range(2)
                     for r in range(2)], np.uint32)


def camera_rays_twin(args):
    """((3, N), (3, N)) ro and rd the camera-ray kernel writes for its
    ``CameraArgs``, ray by ray."""
    f = np.float32
    n = torch.arange(args.n, dtype=torch.int64)
    h, W = args.h, args.W
    s, row, px = ray_lattice(n, h, W, bool(args.blocked))
    if args.pixel_order:
        c = (s * h * W + row // 8 * (W // 16) * 128 + px // 16 * 128
             + row % 8 * 16 + px % 16)
    else:
        c = n
    jx, jy, lu1, lu2 = (uniform_at(k, c) for k in camera_prologue_keys(
        (args.k0, args.k1)))
    py = (args.H - 1) - (args.row0 + row)

    def t(x):
        return torch.tensor(f(x))

    m = [t(x) for x in args.m]
    u = (px.to(torch.float32) + jx) / t(args.W) * 2.0 - 1.0
    v = (py.to(torch.float32) + jy) / t(args.H) * 2.0 - 1.0
    r = torch.sqrt(lu1)
    phi = t(2.0 * 3.14159265) * lu2
    lens_u, lens_v = r * torch.cos(phi), r * torch.sin(phi)

    def normalize(x, y, z):
        inv = 1.0 / torch.sqrt(torch.clamp_min(x * x + y * y + z * z,
                                               t(1e-20)))
        return x * inv, y * inv, z * inv

    dx, dy = u * t(args.thf_aspect), v * t(args.thf)
    d = normalize(*(m[4 * k] * dx + m[4 * k + 1] * dy + m[4 * k + 2]
                    for k in range(3)))
    cos_fwd = d[0] * m[2] + d[1] * m[6] + d[2] * m[10]
    focus_t = t(args.focus) / torch.clamp_min(cos_fwd, t(1e-6))
    focal = [m[4 * k + 3] + d[k] * focus_t for k in range(3)]
    lu, lv = lens_u * t(args.aperture), lens_v * t(args.aperture)
    o = [m[4 * k + 3] + m[4 * k] * lu + m[4 * k + 1] * lv for k in range(3)]
    d = normalize(*(focal[k] - o[k] for k in range(3)))
    return torch.stack(o), torch.stack(d)


def bounce_rows_twin(k_bounce, cfg, h, row0, blocked):
    """The (bounces, 5, N) rows the kernel writes, ray by ray."""
    N = cfg.spp * h * cfg.width
    n = torch.arange(N, dtype=torch.int64)
    c_rr = rr_counter(cfg, h, row0, blocked, n)
    keys = bounce_prologue_keys(k_bounce, cfg.bounces)
    out = torch.empty((cfg.bounces, 5, N), dtype=torch.float32)
    for b in range(cfg.bounces):
        out[b, 0] = uniform_at(keys[b, 0], n)
        out[b, 1] = torch.log2(torch.clamp_min(uniform_at(keys[b, 1], n),
                                               1e-12))
        phi = torch.tensor(np.float32(2.0 * 3.14159265)) * uniform_at(
            keys[b, 2], n)
        out[b, 2] = torch.cos(phi)
        out[b, 3] = torch.sin(phi)
        rr = cfg.russian_roulette and 2 <= b < cfg.bounces - 1
        out[b, 4] = uniform_at(keys[b, 3], c_rr) if rr else 1.0
    return out


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class SceneTwin:
    """A ``KernelScene``'s spheres, ground and tables as numpy arrays."""

    def __init__(self, ks):
        s, a, t = ks.scene, ks.accel, ks.tables
        self.sph_c = _np(s.spheres.center).astype(np.float32)
        self.sph_r = _np(s.spheres.radius).astype(np.float32)
        self.ground = ks.ground_enabled > 0
        self.C, self.S = a.num_clusters, a.cluster_size
        self.root = _np(t["root_box"])
        nodes = _np(t["nodes"])
        self.node_f = nodes[:, :12].view(np.float32).reshape(-1, 3, 4)
        self.node_c = nodes[:, 12:14]
        lb = _np(t["leaf_boxes"]).reshape(self.C, 2, 3, RUNS)
        self.run_lo = lb[:, 0].transpose(0, 2, 1)   # (C, RUNS, 3)
        self.run_hi = lb[:, 1].transpose(0, 2, 1)
        tris = _np(t["tris"]).reshape(-1, 3, 4)
        self.v0, self.e1, self.e2 = (tris[:, k, :3] for k in range(3))


def _slab(lo, hi, o, inv, bound):
    """urt_slab over boxes (..., 3): (hit, tnear)."""
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    tmin = np.maximum(-F32_MAX, np.minimum(t1, t2).max(axis=-1))
    tmax = np.minimum(F32_MAX, np.maximum(t1, t2).min(axis=-1)) * WIDEN
    return (tmax >= tmin) & (tmax > 0) & (tmin <= bound), tmin


def _mt97(tw, j, o, d):
    """urt_mt97 on triangles ``j``: (hit, t)."""
    e1, e2, a = tw.e1[j], tw.e2[j], tw.v0[j]
    px = d[1] * e2[:, 2] - d[2] * e2[:, 1]
    py = d[2] * e2[:, 0] - d[0] * e2[:, 2]
    pz = d[0] * e2[:, 1] - d[1] * e2[:, 0]
    det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
    front = det >= np.float32(1e-8)
    inv_det = np.float32(1.0) / np.where(front, det, np.float32(1.0))
    tx, ty, tz = o[0] - a[:, 0], o[1] - a[:, 1], o[2] - a[:, 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[:, 2] - tz * e1[:, 1]
    qy = tz * e1[:, 0] - tx * e1[:, 2]
    qz = tx * e1[:, 1] - ty * e1[:, 0]
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
    t = (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * inv_det
    ok = front & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0)
    return ok, t


def closest_hit_twin(tw, o, d):
    """(prim, t, box tests, triangle tests) of one ray, o and d (3,)
    float32, as urt_closest_hit finds them."""
    one = np.float32(1.0)
    dy = d[1] if abs(d[1]) >= np.float32(1e-20) else np.float32(1e-20)
    tg = -o[1] / dy
    if not (tg > 0 and tw.ground):
        tg = F32_MAX
    ts, si = F32_MAX, -1
    for k in range(len(tw.sph_r)):
        oc = o - tw.sph_c[k]
        p1 = -((d[0] * oc[0] + d[1] * oc[1]) + d[2] * oc[2])
        p2sqr = (p1 * p1 - ((oc[0] * oc[0] + oc[1] * oc[1]) + oc[2] * oc[2])
                 + tw.sph_r[k] * tw.sph_r[k])
        p2 = np.sqrt(max(p2sqr, np.float32(0.0)))
        tn = p1 - p2
        t = tn if tn > 0 else p1 + p2
        if not (p2sqr >= 0 and t > 0):
            t = F32_MAX
        if t < ts:
            ts, si = t, k
    sphere_wins = ts < tg
    tgs = ts if sphere_wins else tg

    tiny = np.float32(1e-12)
    inv = np.array([one / (c if abs(c) >= tiny else (-tiny if c < 0 else tiny))
                    for c in d], np.float32)
    tt, ti, nbox, ntri = F32_MAX, -1, 1, 0
    stack = []
    hit, tn = _slab(tw.root[:3], tw.root[3:6], o, inv, tgs)
    if hit:
        stack.append((0 if tw.C > 1 else ~0, tn))
    run = tw.S // RUNS
    while stack:
        code, t_in = stack.pop()
        bound = min(tt, tgs)
        if t_in > bound:
            continue
        if code < 0:
            k = ~code
            hits, tns = _slab(tw.run_lo[k], tw.run_hi[k], o, inv, bound)
            nbox += RUNS
            left = [q for q in range(RUNS) if hits[q]]
            while left:
                q = min(left, key=lambda r: (tns[r], r))
                left.remove(q)
                if tns[q] > min(tt, tgs):
                    break
                j = np.arange(k * tw.S + q * run, k * tw.S + (q + 1) * run)
                ntri += run
                ok, t = _mt97(tw, j, o, d)
                for jj, okj, tj in zip(j, ok, t):
                    if okj and tj < tgs and (tj < tt or
                                             (tj == tt and jj < ti)):
                        tt, ti = tj, int(jj)
            continue
        f = tw.node_f[code]
        hl, tl = _slab(f[:, 0], f[:, 1], o, inv, bound)
        hr, tr = _slab(f[:, 2], f[:, 3], o, inv, bound)
        nbox += 2
        l, r = int(tw.node_c[code, 0]), int(tw.node_c[code, 1])
        if hl and hr:
            if tl <= tr:
                stack += [(r, tr), (l, tl)]
            else:
                stack += [(l, tl), (r, tr)]
        elif hl or hr:
            stack.append((l, tl) if hl else (r, tr))
    n_tris = tw.C * tw.S
    if ti >= 0:
        return ti, tt, nbox, ntri
    if sphere_wins:
        return n_tris + 1 + si, ts, nbox, ntri
    if tg < F32_MAX:
        return n_tris, tg, nbox, ntri
    return -1, F32_MAX, nbox, ntri
