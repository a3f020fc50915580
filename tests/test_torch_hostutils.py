"""The port's host utilities against the JAX package's: ``utils/logging``
(levels and file), ``utils/timing`` (stage timer, throughput, the profiler
trace context) and ``utils/debugviz`` (accel statistics, tree dump, implicit
heap, OBJ exports, the probe ray) on the same accel, which both packages
build to equal arrays."""

import json
import os

import numpy as np
import pytest
import torch

from unityraytracer_tpu.models import primitives as JP
from unityraytracer_tpu.ops.bvh import build_cluster_accel as jbuild
from unityraytracer_tpu.scene import Material as JMaterial
from unityraytracer_tpu.scene import SceneBuilder as JSceneBuilder
from unityraytracer_tpu.utils import debugviz as jviz
from unityraytracer_tpu.utils import logging as jlog
from unityraytracer_tpu.utils import timing as jtiming
from unityraytracer_tpu.utils.math3d import trs_matrix
from unityraytracer_tpu_torch import Material, SceneBuilder
from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel as tbuild
from unityraytracer_tpu_torch.utils import debugviz as tviz
from unityraytracer_tpu_torch.utils import logging as tlog
from unityraytracer_tpu_torch.utils import timing as ttiming


def _scene(Builder, Mat):
    b = Builder()
    v, f, n = JP.icosphere(2)
    b.add_mesh(v, f, transform=trs_matrix((0, 1, 0), (0, 0, 0), 2.0))
    b.add_sphere((2, 0.5, 0), 0.5, Mat(albedo=(0.9, 0.1, 0.1)))
    b.set_skybox(np.ones((4, 8, 3), np.float32) * 0.7)
    return b.build()


@pytest.fixture(scope="module")
def accels():
    """(port accel, the same on torch tensors, JAX accel) at 16 a leaf."""
    ta = tbuild(_scene(SceneBuilder, Material).triangles, cluster_size=16)
    ja = jbuild(_scene(JSceneBuilder, JMaterial).triangles, cluster_size=16,
                use_native=False)
    return ta, ta.to("cpu"), ja


# -- logging ----------------------------------------------------------------

def test_leveled_logger_matches_jax(tmp_path):
    texts = []
    for mod, name in ((tlog, "port"), (jlog, "jax")):
        log = mod.DebugLog(name, directory=str(tmp_path), level=mod.BASIC)
        log.log("basic message")
        log.detail("too detailed, filtered")
        log.warn("warned")
        log.close()
        log.log("after close")                        # silently dropped
        assert log.path == os.path.join(str(tmp_path), f"{name}.txt")
        texts.append(open(log.path).read())
    for text in texts:
        assert "basic message" in text and "warned" in text
        assert "too detailed" not in text and "after close" not in text
        assert "=== run" in text and "level=BASIC" in text
    # Same lines but for the clock: strip the [HH:MM:SS] stamps and header.
    strip = lambda t: [l.split("]", 1)[1] for l in t.splitlines()  # noqa: E731
                       if l.startswith("[")]
    assert strip(texts[0]) == strip(texts[1]) \
        == ["[BASIC] basic message", "[WARN] warned"]
    assert (tlog.NONE, tlog.WARNING, tlog.BASIC, tlog.DETAILED) \
        == (jlog.NONE, jlog.WARNING, jlog.BASIC, jlog.DETAILED)


def test_logger_levels_echo_and_configure(tmp_path, capsys):
    silent = tlog.DebugLog("s", directory=str(tmp_path / "never"),
                           level=tlog.NONE)
    silent.warn("dropped")
    assert not (tmp_path / "never").exists()          # NONE opens no file
    log = tlog.configure("cfg", directory=str(tmp_path), level=tlog.DETAILED,
                         echo=True)
    try:
        assert tlog.get_logger() is log
        log.detail("fine grain")
        assert "[DETAIL] fine grain" in capsys.readouterr().err
        again = tlog.configure("cfg", directory=str(tmp_path),
                               level=tlog.WARNING)
        assert log._fh is None and tlog.get_logger() is again
        again.log("basic is above WARNING")
        again.warn("kept")
    finally:
        tlog.configure(level=tlog.NONE)
    text = open(again.path).read()
    assert text.count("=== run") == 2                 # appended, two headers
    assert "kept" in text and "above WARNING" not in text


# -- timing -----------------------------------------------------------------

def test_stage_timer_and_report_format():
    t, j = ttiming.StageTimer(block=False), jtiming.StageTimer(block=False)
    for timer in (t, j):
        for name in ("build", "build", "trace"):
            with timer.stage(name):
                pass
    assert t.counts == j.counts == {"build": 2, "trace": 1}
    # The report is the JAX module's format: fix the clocks, compare text.
    t.totals = j.totals = {"build": 0.5, "trace": 0.125}
    assert t.report() == j.report()
    assert t.report().splitlines()[0] \
        == "build               500.00 ms total (2x, 250.00 ms avg)"
    assert ttiming.mrays_per_sec(2_000_000, 0.02) == pytest.approx(100.0)
    assert ttiming.mrays_per_sec(5, 0.0) == jtiming.mrays_per_sec(5, 0.0)


def test_stage_timer_blocks_on_results():
    t = ttiming.StageTimer()                          # block=True
    holder = []
    with t.stage("matmul", holder):
        holder.append({"a": [torch.ones(64, 64) @ torch.ones(64, 64)]})
    assert t.counts == {"matmul": 1} and t.totals["matmul"] > 0
    ttiming.device_sync((torch.zeros(1), [None, 3], {"k": torch.ones(2)}))


def test_measure_throughput_on_a_cpu_function():
    calls = []

    def fn(x, y):
        calls.append(1)
        return x @ y

    a = torch.ones(32, 32)
    best, mrays = ttiming.measure_throughput(fn, a, a, warmup=2, iters=3,
                                             n_rays=1000)
    assert len(calls) == 5
    assert 0 < best < 1.0
    assert mrays == pytest.approx(ttiming.mrays_per_sec(1000, best))
    assert ttiming.measure_throughput(fn, a, a, warmup=0, iters=1)[1] is None


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with ttiming.profiler_trace(logdir):
        (torch.ones(128, 128) @ torch.ones(128, 128)).sum()
    path = os.path.join(logdir, "torch.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# -- debugviz ---------------------------------------------------------------

@pytest.mark.parametrize("leaves", ["numpy", "tensors"])
def test_accel_stats_and_dump_equal_jax(accels, leaves):
    ta, tt, ja = accels
    acc = ta if leaves == "numpy" else tt
    stats = tviz.accel_stats(acc)
    assert stats == jviz.accel_stats(ja)
    assert stats["num_clusters"] > 1 and stats["max_depth"] >= 1
    assert stats["num_triangles"] == acc.triangles.count
    for n in (16, 64, 10_000):
        tree = tviz.dump_tree(acc, max_nodes=n)
        assert tree == jviz.dump_tree(ja, max_nodes=n)
    assert "node 0" in tree and "leaf" in tree


@pytest.mark.parametrize("leaves", ["numpy", "tensors"])
def test_implicit_heap_equals_jax(accels, leaves):
    ta, tt, ja = accels
    got = tviz.to_implicit_heap(ta if leaves == "numpy" else tt)
    want = jviz.to_implicit_heap(ja)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    hvmin, hvmax, hidx = got
    M = len(hidx)
    assert M & (M + 1) == 0                           # 2**d - 1 slots
    assert sorted(hidx[hidx >= 0].tolist()) == list(range(ta.num_clusters))
    np.testing.assert_allclose(hvmin[0], ta.node_vmin[0])
    np.testing.assert_allclose(hvmax[0], ta.node_vmax[0])


@pytest.mark.parametrize("leaves_only", [True, False])
def test_export_aabbs_obj_bytes_equal_jax(accels, tmp_path, leaves_only):
    ta, tt, ja = accels
    a = jviz.export_aabbs_obj(ja, str(tmp_path / "j.obj"), leaves_only)
    for i, acc in enumerate((ta, tt)):
        b = tviz.export_aabbs_obj(acc, str(tmp_path / f"t{i}.obj"),
                                  leaves_only)
        assert open(a, "rb").read() == open(b, "rb").read()
    n_boxes = ta.num_clusters if leaves_only else len(ta.node_left)
    assert open(a).read().count("v ") == n_boxes * 8


def test_export_normals_obj_bytes_equal_jax(tmp_path):
    ts = _scene(SceneBuilder, Material)
    js = _scene(JSceneBuilder, JMaterial)
    for kw in (dict(scale=0.5), dict(scale=0.25, max_tris=100)):
        a = jviz.export_normals_obj(js.triangles, str(tmp_path / "j.obj"),
                                    **kw)
        b = tviz.export_normals_obj(ts.triangles, str(tmp_path / "t.obj"),
                                    **kw)
        c = tviz.export_normals_obj(ts.to("cpu").triangles,
                                    str(tmp_path / "tt.obj"), **kw)
        assert open(a, "rb").read() == open(b, "rb").read() \
            == open(c, "rb").read()
    lines = open(tviz.export_normals_obj(ts.triangles,
                                         str(tmp_path / "n.obj"),
                                         scale=0.5)).read().splitlines()
    n_l = sum(1 for l in lines if l.startswith("l "))
    assert n_l == ts.num_triangles * 3                # a segment per corner
    assert sum(1 for l in lines if l.startswith("v ")) == 2 * n_l
    p = np.array([float(x) for x in lines[0].split()[1:]])
    q = np.array([float(x) for x in lines[1].split()[1:]])
    np.testing.assert_allclose((q - p) / 0.5, ts.triangles.n0[0], atol=1e-5)


@pytest.mark.parametrize("ray", [((0, 1, -5), (0, 0, 1)),
                                 ((3, 4, -5), (-0.4, -0.5, 1)),
                                 ((0, 1, -5), (0, 0, -1)),       # away: none
                                 ((0, 1, 0), (0, 1, 0))])        # from inside
def test_probe_ray_report_equals_jax(accels, ray):
    ta, tt, ja = accels
    want = jviz.test_ray_report(ja, *ray)
    for acc in (ta, tt):
        got = tviz.test_ray_report(acc, *ray)
        assert got["n_touched"] == want["n_touched"]
        assert [c for c, _ in got["clusters"]] \
            == [c for c, _ in want["clusters"]]
        np.testing.assert_allclose([t for _, t in got["clusters"]],
                                   [t for _, t in want["clusters"]],
                                   rtol=1e-6, atol=1e-6)
    if ray[1] == (0, 0, 1):
        assert want["n_touched"] >= 1


def test_intersect_aabb_equals_jax():
    import jax.numpy as jnp
    from unityraytracer_tpu.ops import intersect as jint
    from unityraytracer_tpu_torch.ops import intersect as tint

    rng = np.random.default_rng(2)
    ro = rng.uniform(-3, 3, (3, 50)).astype(np.float32)
    rd = rng.normal(size=(3, 50)).astype(np.float32)
    rd[0, :5] = 0.0                                    # axis-parallel rays
    rd[1, 5:8] = -0.0
    lo = rng.uniform(-2, 1, (20, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2, (20, 3)).astype(np.float32)
    tinv = tint.safe_inv_dir(tuple(torch.as_tensor(c) for c in rd))
    jinv = jint.safe_inv_dir(tuple(jnp.asarray(c) for c in rd))
    for a, b in zip(tinv, jinv):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    hit, t = tint.intersect_aabb(tuple(torch.as_tensor(c) for c in ro), tinv,
                                 torch.as_tensor(lo), torch.as_tensor(hi))
    jhit, jt = jint.intersect_aabb(tuple(jnp.asarray(c) for c in ro), jinv,
                                   jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
