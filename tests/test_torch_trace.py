"""Closest hit: the port's trace_brute and the plain version of the
closest-hit kernel (exhaustive MT97 over the accel's triangles) against the
JAX package's trace_brute on bench_scene(n_tris=2000) rays.

Hit/miss and winners must be identical; t agrees to 1e-5 relative (the MT97
arithmetic is the same IEEE sequence on both sides, so t is in practice
bit-equal; sphere t and normals pass through sqrt, which torch rounds
differently from XLA:CPU by an ulp)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unityraytracer_tpu.models import fixtures as jfix
from unityraytracer_tpu.ops.trace import trace_brute as jax_trace_brute
from unityraytracer_tpu_torch.models import fixtures as tfix
from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
from unityraytracer_tpu_torch.ops.cuda_trace import (KernelScene,
                                                     closest_hit_plain,
                                                     make_pallas_tracer,
                                                     trace_hits)
from unityraytracer_tpu_torch.ops.trace import trace_brute


@pytest.fixture(scope="module")
def setup():
    js = jfix.bench_scene(n_tris=2000)
    ts = tfix.bench_scene(n_tris=2000)
    rng = np.random.default_rng(11)
    # Camera rays over the field plus rays from random points in all
    # directions (hits from inside spheres, grazing rays, sky).
    cam = tfix.bench_camera(aspect=64 / 48)
    u = rng.uniform(-1, 1, 3072).astype(np.float32)
    v = rng.uniform(-1, 1, 3072).astype(np.float32)
    from unityraytracer_tpu_torch.camera import camera_rays_soa
    co, cd = camera_rays_soa(cam, torch.from_numpy(u), torch.from_numpy(v))
    ro = rng.uniform(-4, 4, (3, 1024)).astype(np.float32)
    ro[1] = np.abs(ro[1]) + 0.5
    rd = rng.normal(size=(3, 1024)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    ro = np.concatenate([np.stack([c.numpy() for c in co]), ro], axis=1)
    rd = np.concatenate([np.stack([c.numpy() for c in cd]), rd], axis=1)
    jh = jax_trace_brute(js, tuple(jnp.asarray(c) for c in ro),
                         tuple(jnp.asarray(c) for c in rd))
    tro = tuple(torch.from_numpy(c.copy()) for c in ro)
    trd = tuple(torch.from_numpy(c.copy()) for c in rd)
    return js, ts, jh, tro, trd


def _check_against_jax(jh, th):
    jt = np.asarray(jh.t)
    tt = th.t.numpy()
    jhit = jt < 1e30
    np.testing.assert_array_equal(tt < 1e30, jhit)
    assert jhit.mean() > 0.3 and (~jhit).mean() > 0.05
    np.testing.assert_allclose(tt[jhit], jt[jhit], rtol=1e-5)
    # Same winner: same material and (to rounding) the same shading normal.
    for k in range(3):
        np.testing.assert_array_equal(th.albedo[k].numpy()[jhit],
                                      np.asarray(jh.albedo[k])[jhit])
        np.testing.assert_array_equal(th.emission[k].numpy()[jhit],
                                      np.asarray(jh.emission[k])[jhit])
        np.testing.assert_allclose(th.normal[k].numpy()[jhit],
                                   np.asarray(jh.normal[k])[jhit],
                                   rtol=1e-5, atol=1e-6)


def test_trace_brute_matches_jax(setup):
    js, ts, jh, tro, trd = setup
    th = trace_brute(ts.to("cpu"), tro, trd)
    _check_against_jax(jh, th)
    # Small chunks give the same records.
    th2 = trace_brute(ts.to("cpu"), tro, trd, chunk=333)
    np.testing.assert_array_equal(th2.t.numpy(), th.t.numpy())
    np.testing.assert_array_equal(th2.prim.numpy(), th.prim.numpy())


def test_closest_hit_plain_matches_jax(setup):
    js, ts, jh, tro, trd = setup
    accel = build_cluster_accel(ts.triangles, cluster_size=64)
    ks = KernelScene.create(ts, accel)
    th = closest_hit_plain(ks, tro, trd)
    _check_against_jax(jh, th)
    # Winners identical to the scene-order oracle: map accel triangle
    # indices back to scene indices through the vertex data.
    tb = trace_brute(ts.to("cpu"), tro, trd)
    key = lambda a, b, c: [x.tobytes() for x in np.concatenate(  # noqa: E731
        [np.asarray(a), np.asarray(b), np.asarray(c)], axis=1)]
    scene_idx = {k: i for i, k in enumerate(key(ts.triangles.v0,
                                                 ts.triangles.v1,
                                                 ts.triangles.v2))}
    a_keys = key(accel.triangles.v0, accel.triangles.v1, accel.triangles.v2)
    T_acc, T = accel.triangles.count, ts.num_triangles
    pa, pb = th.prim.numpy(), tb.prim.numpy()
    mapped = np.array([scene_idx[a_keys[p]] if 0 <= p < T_acc
                       else (-1 if p < 0 else p - T_acc + T) for p in pa])
    np.testing.assert_array_equal(mapped, pb)
    # Dead rays report a miss with zero attributes, as the kernel does.
    alive = torch.arange(len(tro[0])) % 3 != 0
    hd = trace_hits(ks, tro, trd, alive)
    assert (hd.t.numpy()[~alive.numpy()] > 1e30).all()
    assert (hd.albedo[0].numpy()[~alive.numpy()] == 0).all()
    np.testing.assert_array_equal(hd.t.numpy()[alive.numpy()],
                                  th.t.numpy()[alive.numpy()])
    # The per-bounce tracer of tracer="pallas" is the same function on CPU.
    hp = make_pallas_tracer(ts.to("cpu"), accel)(tro, trd)
    np.testing.assert_array_equal(hp.t.numpy(), th.t.numpy())


# The closest-hit kernels' tables (ops/cuda_trace.kernel_tables), checked
# against the ClusterAccel they are derived from, and a per-ray twin of the
# kernels' traversal over them (tests/torch_twins.py) against the exhaustive
# plain version: winners and t bit for bit.

def _tables(scene, cluster_size=64):
    accel = build_cluster_accel(scene.triangles, cluster_size=cluster_size)
    ks = KernelScene.create(scene, accel, "cpu")
    return ks, {k: v.numpy() for k, v in ks.tables.items()}


@pytest.fixture(scope="module")
def bench_tables():
    return _tables(tfix.bench_scene(n_tris=2000))


def test_kernel_tables_triangle_records(bench_tables):
    ks, t = bench_tables
    tr = ks.accel.triangles
    v0, v1, v2 = (getattr(tr, k).numpy() for k in ("v0", "v1", "v2"))
    rec = t["tris"].reshape(-1, 3, 4)
    assert rec.shape[0] == ks.accel.triangles.count
    np.testing.assert_array_equal(rec[:, 0, :3].view(np.uint32),
                                  v0.view(np.uint32))
    np.testing.assert_array_equal(rec[:, 1, :3].view(np.uint32),
                                  (v1 - v0).view(np.uint32))
    np.testing.assert_array_equal(rec[:, 2, :3].view(np.uint32),
                                  (v2 - v0).view(np.uint32))
    assert (rec[:, :, 3] == 0).all()


def _run_boxes(t, C):
    lb = t["leaf_boxes"].reshape(C, 2, 3, 8)
    return lb[:, 0].transpose(0, 2, 1), lb[:, 1].transpose(0, 2, 1)


def _one_cluster_scene():
    from unityraytracer_tpu_torch.scene import SceneBuilder
    r = np.random.default_rng(3)
    verts = r.uniform(-2, 2, (30, 3)).astype(np.float32) + [0, 3, 0]
    faces = r.integers(0, 30, (20, 3))
    return SceneBuilder().add_mesh(verts, faces).build()


@pytest.mark.parametrize("name", ["bench_2000", "sample", "one_cluster"])
def test_kernel_tables_run_boxes(name):
    # bench_2000 fills its 40 leaves; sample's 108 triangles pad the second
    # of two; one_cluster's 20 triangles make a single leaf (no inner node)
    # whose runs 3-7 hold padding only.
    scene = {"bench_2000": lambda: tfix.bench_scene(n_tris=2000),
             "sample": tfix.sample_scene,
             "one_cluster": _one_cluster_scene}[name]()
    ks, t = _tables(scene)
    C, S = ks.accel.num_clusters, ks.accel.cluster_size
    T = scene.num_triangles
    assert (C * S > T) == (name != "bench_2000")
    tr = ks.accel.triangles
    verts = np.stack([getattr(tr, k).numpy() for k in ("v0", "v1", "v2")], 1)
    runs = verts.reshape(C, 8, S // 8 * 3, 3)
    lo, hi = _run_boxes(t, C)
    np.testing.assert_array_equal(lo, runs.min(axis=2))
    np.testing.assert_array_equal(hi, runs.max(axis=2))
    assert (runs >= lo[:, :, None]).all() and (runs <= hi[:, :, None]).all()
    # Padding rows are all zero; a run of padding only is the point at the
    # origin (its degenerate triangles never hit); the other runs lie inside
    # their leaf's node box.
    real = (verts != 0).any(axis=(1, 2)).reshape(C, 8, S // 8)
    assert real.sum() == T
    pad_runs = ~real.any(axis=2)
    assert (lo[pad_runs] == 0).all() and (hi[pad_runs] == 0).all()
    vmin = ks.accel.node_vmin.numpy()[C - 1:]
    vmax = ks.accel.node_vmax.numpy()[C - 1:]
    whole = real.all(axis=2)
    inside = (lo >= vmin[:, None]) & (hi <= vmax[:, None])
    assert inside.all(axis=2)[whole].all()
    if name == "one_cluster":
        assert C == 1 and pad_runs[0, 3:].all() and not pad_runs[0, :2].any()
        np.testing.assert_array_equal(t["nodes"], np.zeros((1, 16), np.int32))
        np.testing.assert_array_equal(t["root_box"][:3],
                                      ks.accel.node_vmin.numpy()[0])


def test_kernel_tables_node_records(bench_tables):
    ks, t = bench_tables
    a = ks.accel
    C = a.num_clusters
    vmin, vmax = a.node_vmin.numpy(), a.node_vmax.numpy()
    left, right = a.node_left.numpy(), a.node_right.numpy()
    rec = t["nodes"]
    assert rec.shape == (C - 1, 16)
    box = rec[:, :12].view(np.float32).reshape(C - 1, 3, 4)
    for m in range(C - 1):
        l, r = left[m], right[m]
        np.testing.assert_array_equal(box[m, :, 0], vmin[l])
        np.testing.assert_array_equal(box[m, :, 1], vmax[l])
        np.testing.assert_array_equal(box[m, :, 2], vmin[r])
        np.testing.assert_array_equal(box[m, :, 3], vmax[r])
        for code, child in ((rec[m, 12], l), (rec[m, 13], r)):
            assert code == (child if child < C - 1 else ~(child - (C - 1)))
    assert (rec[:, 14:] == 0).all()
    np.testing.assert_array_equal(t["root_box"],
                                  np.concatenate([vmin[0], vmax[0], [0, 0]]))


def test_kernel_tables_need_whole_runs():
    scene = tfix.bench_scene(n_tris=200)
    with pytest.raises(ValueError, match="multiple of 8"):
        KernelScene.create(scene, build_cluster_accel(scene.triangles, 12))


def test_traversal_twin_matches_exhaustive(setup):
    from torch_twins import SceneTwin, closest_hit_twin
    js, ts, jh, tro, trd = setup
    ks = KernelScene.create(ts, build_cluster_accel(ts.triangles, 64), "cpu")
    hp = closest_hit_plain(ks, tro, trd)
    tw = SceneTwin(ks)
    o = np.stack([c.numpy() for c in tro], 1)
    d = np.stack([c.numpy() for c in trd], 1)
    idx = np.arange(0, o.shape[0], 11)
    n_tris = ks.accel.triangles.count
    tri_tests = []
    for i in idx:
        prim, t, nbox, ntri = closest_hit_twin(tw, o[i], d[i])
        assert prim == int(hp.prim[i]), i
        if 0 <= prim < n_tris:
            assert np.float32(t).view(np.uint32) == \
                hp.t[i].numpy().view(np.uint32)
        assert nbox >= 1 and ntri % 8 == 0
        tri_tests.append(ntri)
    # The run boxes keep a ray well short of the exhaustive 2,560 tests.
    assert np.mean(tri_tests) < 0.1 * n_tris
