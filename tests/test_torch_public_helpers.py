"""The port's small public helpers against their JAX counterparts on the same
seeded numpy inputs: ``ops/vec.py`` (``vec3``, ``from_rows``, ``to_rows``,
``cross``), ``utils/math3d.py``'s vector helpers, ``ops/sampling.
uniform_from_bits``, ``ops/shade.pack_rgbe``, ``ops/trace.materials_for`` and
``utils/profiling.fetch_sync``.

Tolerances: the component products and sums, the bit-to-float map, the
RGBE packing and the gathers are the same float32 operations on both sides
and must be equal (the RGBE words to the JAX package's numpy packer; its
device packer rounds its exp2 otherwise, see ``test_pack_rgbe``); the
(..., 3) reductions and matrix products
(``dot``, ``norm``, ``normalize``, ``sdot``, ``reflect``, the transforms)
may sum in another order, so they are held to rtol 1e-6, atol 1e-7."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unityraytracer_tpu.models import fixtures as jfix
from unityraytracer_tpu.ops import sampling as jsampling
from unityraytracer_tpu.ops import shade as jshade
from unityraytracer_tpu.ops import trace as jtrace
from unityraytracer_tpu.ops import vec as jvec
from unityraytracer_tpu.utils import math3d as jm
from unityraytracer_tpu.utils import profiling as jprofiling
from unityraytracer_tpu_torch.models import fixtures
from unityraytracer_tpu_torch.ops import sampling, shade, trace, vec
from unityraytracer_tpu_torch.utils import math3d as tm
from unityraytracer_tpu_torch.utils import profiling


def _arrays(seed, shape=(5, 7, 3)):
    g = np.random.default_rng(seed)
    return [g.normal(size=shape).astype(np.float32) for _ in range(3)]


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def test_vec_rows_and_cross():
    a, b, _ = _arrays(1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert vec.vec3(1, 2, 3) == jvec.vec3(1, 2, 3) == (1, 2, 3)
    for got, want in zip(vec.from_rows(ta), jvec.from_rows(jnp.asarray(a))):
        np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(
        _np(vec.to_rows(vec.from_rows(ta))),
        _np(jvec.to_rows(jvec.from_rows(jnp.asarray(a)))))
    got = vec.cross(vec.from_rows(ta), vec.from_rows(tb))
    want = jvec.cross(jvec.from_rows(jnp.asarray(a)),
                      jvec.from_rows(jnp.asarray(b)))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(_np(g_), _np(w_))


@pytest.mark.parametrize("name", ["dot", "cross", "norm", "normalize", "sdot",
                                  "reflect"])
def test_math3d_vector_helpers(name):
    a, b, _ = _arrays(2)
    if name == "reflect":
        b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    args = (a, b) if name in ("dot", "cross", "sdot", "reflect") else (a,)
    got = getattr(tm, name)(*map(torch.from_numpy, args))
    want = getattr(jm, name)(*map(jnp.asarray, args))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-7)
    if name == "sdot":
        np.testing.assert_allclose(
            _np(tm.sdot(torch.from_numpy(a), torch.from_numpy(b), 0.3)),
            _np(jm.sdot(jnp.asarray(a), jnp.asarray(b), 0.3)),
            rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["transform_points", "transform_dirs"])
def test_math3d_transforms(name):
    m = jm.trs_matrix((1.0, -2.0, 0.5), (10.0, 35.0, -20.0), (1.5, 0.7, 2.0))
    assert np.array_equal(m, tm.trs_matrix((1.0, -2.0, 0.5),
                                           (10.0, 35.0, -20.0),
                                           (1.5, 0.7, 2.0)))
    pts = _arrays(3)[0]
    got = getattr(tm, name)(m, torch.from_numpy(pts))
    want = getattr(jm, name)(jnp.asarray(m), jnp.asarray(pts))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    # A tensor matrix gives the same as a numpy one.
    np.testing.assert_array_equal(
        _np(getattr(tm, name)(torch.from_numpy(m), torch.from_numpy(pts))),
        _np(got))


def test_uniform_from_bits():
    g = np.random.default_rng(4)
    bits = g.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    bits[:4] = [0, 0xFF, 0x100, 0xFFFFFFFF]
    want = _np(jsampling.uniform_from_bits(jnp.asarray(bits)))
    for t in (torch.from_numpy(bits.astype(np.int64)),
              torch.from_numpy(bits.view(np.int32))):
        got = sampling.uniform_from_bits(t)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_np(got), want)
    assert want.max() < 1.0 and want.min() == 0.0


def test_pack_rgbe():
    g = np.random.default_rng(5)
    sky = np.exp(g.normal(0, 3, (16, 24, 3))).astype(np.float32)
    sky[0, :4] = 0.0
    sky[1, :3] = [[1.0, 0.5, 0.25], [2.0 ** -20, 0, 0], [300.0, 1.0, 8.0]]
    got = _np(shade.pack_rgbe(torch.from_numpy(sky)))
    np.testing.assert_array_equal(got, jshade.pack_rgbe_np(sky).astype(
        np.int64))
    np.testing.assert_array_equal(got, shade.pack_rgbe_np(sky).astype(
        np.int64))
    # XLA:CPU takes exp2 as exp(x ln 2), so the JAX device version's scale
    # is not always an exact power of two (ROADMAP, "Not faults"): a texel
    # may differ from its numpy twin's by one in a channel byte, never in
    # the exponent.
    want = _np(jshade.pack_rgbe(jnp.asarray(sky))).astype(np.int64)
    off = got != want
    assert off.mean() <= 1e-2
    assert (got[off] >> 24 == want[off] >> 24).all()
    for sh in (16, 8, 0):
        assert (np.abs((got[off] >> sh & 0xFF) - (want[off] >> sh & 0xFF))
                <= 1).all()


def test_materials_for():
    js, ts = jfix.scene1(), fixtures.scene1().to("cpu")
    mid = np.random.default_rng(6).integers(0, ts.materials.albedo.shape[0],
                                            257)
    got = trace.materials_for(ts, torch.from_numpy(mid))
    want = jtrace.materials_for(jax.tree_util.tree_map(jnp.asarray, js),
                                jnp.asarray(mid))
    assert sorted(got) == sorted(want)
    for k in got:
        g_, w_ = got[k], want[k]
        g_ = torch.stack(g_) if isinstance(g_, tuple) else g_
        w_ = np.stack(w_) if isinstance(w_, tuple) else w_
        np.testing.assert_array_equal(_np(g_), _np(w_))


def test_fetch_sync_reads_every_tensor_leaf():
    tree = {"scene": fixtures.scene1().to("cpu"),
            "rows": [torch.ones(3), (torch.zeros(2), 4)], "n": 7}
    jtree = {"scene": jax.tree_util.tree_map(jnp.asarray, jfix.scene1()),
             "rows": [jnp.ones(3), (jnp.zeros(2), 4)], "n": 7}
    leaves = profiling._tensor_leaves(tree)
    jleaves = [x for x in jax.tree_util.tree_leaves(jtree)
               if hasattr(x, "shape")]
    # The same leaves (the port keeps a scene's scalars as (1,) tensors).
    assert sorted(x.numel() for x in leaves) == sorted(
        int(x.size) for x in jleaves)
    assert profiling.fetch_sync(tree) is None
    assert jprofiling.fetch_sync(jtree) is None
