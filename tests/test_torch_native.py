"""The native host library (``native.py``, ``csrc/lbvh.cpp``,
``csrc/piz.cpp``) against the numpy and Python code it stands in for, and
against the JAX package's builders.

Bars: exact. The radix tree and the Morton sort are integer work, the
accel's boxes are min/max of the same floats, and the Huffman decode
returns symbols, so every array must be equal."""

import numpy as np
import pytest

from unityraytracer_tpu.ops import bvh as jbvh
from unityraytracer_tpu_torch import native
from unityraytracer_tpu_torch.models import fixtures, piz
from unityraytracer_tpu_torch.models.exr import load_exr, write_exr
from unityraytracer_tpu_torch.ops import bvh

FIELDS = ("cluster_vmin", "cluster_vmax", "node_vmin", "node_vmax",
          "node_left", "node_right")


def test_builds_from_the_checkout():
    assert native.available(), native.BUILD_LOG
    path = native.library_path(native._cxx())
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parent.name == "unityraytracer_tpu_torch"
    assert all((native.CSRC / s).exists() for s in native.SOURCES)


@pytest.mark.parametrize("n", [2, 3, 17, 1000, 4096])
def test_radix_tree_equals_numpy(n):
    g = np.random.default_rng(n)
    keys = np.unique(g.integers(0, 2 ** 62, n * 2, dtype=np.uint64))[:n]
    left, right = native.radix_tree(keys)
    for want in (bvh._radix_tree(keys), jbvh._radix_tree(keys)):
        assert np.array_equal(left, want[0])
        assert np.array_equal(right, want[1])


def test_morton_sort_equals_numpy():
    pts = np.random.default_rng(0).random((5000, 3)).astype(np.float32)
    pts[:100] = pts[100:200]                   # equal codes: stable order
    codes, order = native.morton_sort(pts)
    want = bvh.morton_encode_3d(pts)
    assert np.array_equal(codes, want)
    assert np.array_equal(codes, jbvh.morton_encode_3d(pts))
    assert np.array_equal(order, np.argsort(want, kind="stable"))


@pytest.mark.parametrize("n_tris", [100, 30_000])
def test_accel_native_equals_numpy_and_jax(n_tris):
    tris = fixtures.bench_scene(n_tris=n_tris).triangles
    a = bvh.build_cluster_accel(tris, 16, use_native=True)
    b = bvh.build_cluster_accel(tris, 16, use_native=False)
    c = jbvh.build_cluster_accel(tris, 16, use_native=False)
    for f in FIELDS:
        for other in (b, c):
            want = np.asarray(getattr(other, f))
            assert getattr(a, f).tobytes() == want.tobytes(), f


def test_huf_decode_equals_python(monkeypatch):
    g = np.random.default_rng(1)
    raw = np.concatenate([g.integers(0, 300, 20000), np.full(700, 7),
                          g.geometric(0.01, 5000) % 65535]).astype(np.uint16)
    blob = piz.huf_compress(raw)
    got = piz.huf_decompress(blob, len(raw))
    monkeypatch.setattr(native, "huf_decode", lambda *a: None)
    want = piz.huf_decompress(blob, len(raw))
    assert np.array_equal(got, raw) and np.array_equal(want, raw)


def test_piz_exr_reads_the_same_through_either_decoder(tmp_path,
                                                       monkeypatch):
    img = np.random.default_rng(2).random((24, 40, 3)).astype(np.float32)
    path = str(tmp_path / "sky.exr")
    write_exr(path, img, dtype="half", compression="piz")
    fast = load_exr(path)
    monkeypatch.setattr(native, "huf_decode", lambda *a: None)
    assert np.array_equal(fast, load_exr(path))
    assert np.array_equal(fast, img.astype(np.float16).astype(np.float32))


def test_corrupt_stream_raises():
    raw = np.arange(5000, dtype=np.uint16) % 50
    blob = piz.huf_compress(raw)
    with pytest.raises(ValueError):
        piz.huf_decompress(blob, len(raw) + 10)     # the stream ends early
    lengths = np.zeros(65537, np.int32)
    lengths[0] = 99                                   # over the 58-bit cap
    with pytest.raises(ValueError, match="corrupt"):
        native.huf_decode(b"\xff" * 8, 0, 64, lengths, 1, 4)
