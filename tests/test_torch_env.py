"""Sky tap: the plain versions of the env kernels must be BIT-identical to the
JAX package's Pallas env kernels (_env_lookup8 and _env_lookup, run in
interpret mode) and to its gather path (sample_skybox_rgbe with u1/u2), for
every fetch impl. The decode scale table of ops/shade.py reproduces XLA's
jnp.exp2 exactly, subnormal flush included."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unityraytracer_tpu.ops.pallas_env import (_byte_planes, _env_lookup,
                                               _env_lookup8,
                                               sample_skybox_rgbe_mxu)
from unityraytracer_tpu.ops.shade import sample_skybox_rgbe as jax_tap
from unityraytracer_tpu_torch.models.skybox import gradient_sky, sun_sky
from unityraytracer_tpu_torch.ops import cuda_env
from unityraytracer_tpu_torch.ops.cuda_env import (byte_planes,
                                                   env_lookup_planes_plain,
                                                   env_lookup_plain,
                                                   sample_skybox_tap)
from unityraytracer_tpu_torch.ops.shade import RGBE_SCALE, pack_rgbe_np


def _plane(sky):
    packed = pack_rgbe_np(sky)
    return jnp.asarray(packed), torch.from_numpy(packed.view(np.int32).copy())


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("n", [1024, 1061])
def test_env_plain_bit_identical_to_pallas_kernel(n):
    sky = sun_sky()
    H, W = sky.shape[:2]
    jp, tp = _plane(sky)
    rng = np.random.default_rng(n)
    yn = rng.integers(0, H, n).astype(np.int32)
    xn = rng.integers(0, W, n).astype(np.int32)
    want = _env_lookup8(jp, jnp.asarray(yn), jnp.asarray(xn), H, W,
                        interpret=True, block=128)
    got = env_lookup_plain(tp, torch.from_numpy(yn), torch.from_numpy(xn), W)
    for k in range(3):
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))


@pytest.mark.parametrize("sky_fn", [sun_sky, lambda: gradient_sky(16, 40)])
def test_env_tap_bit_identical_to_gather_path(sky_fn):
    sky = sky_fn()
    H, W = sky.shape[:2]
    jp, tp = _plane(sky)
    rng = np.random.default_rng(3)
    n = 5000
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    u1, u2 = rng.uniform(size=(2, n)).astype(np.float32)
    want = jax_tap(jnp.asarray(sky), tuple(jnp.asarray(c) for c in d),
                   u1=jnp.asarray(u1), u2=jnp.asarray(u2), packed=jp)
    got = sample_skybox_tap((H, W), tp, tuple(torch.from_numpy(c.copy())
                                              for c in d),
                            torch.from_numpy(u1), torch.from_numpy(u2))
    for k in range(3):
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))


def test_decode_covers_every_exponent():
    # One texel per exponent byte and mantissa pattern; e == 0 decodes to 0.
    e = np.arange(256, dtype=np.uint32)
    words = (e << 24) | (np.uint32(0xFF) << 16) | (np.uint32(0x80) << 8) | 1
    tp = torch.from_numpy(words.view(np.int32).copy())
    idx = torch.arange(256, dtype=torch.int32)
    r, g, b = env_lookup_plain(tp, torch.zeros_like(idx), idx, 256)
    np.testing.assert_array_equal(r.numpy(), 255 * RGBE_SCALE)
    np.testing.assert_array_equal(g.numpy(), 128 * RGBE_SCALE)
    np.testing.assert_array_equal(b.numpy(), RGBE_SCALE)
    assert RGBE_SCALE[0] == 0 and RGBE_SCALE[136] == 1.0


# The impl switch and the byte-plane kernel (_env_kernel). Bar: bit-identical,
# since every impl fetches the same bytes and decodes them through the same
# table (the one-hot dots of the TPU kernels sum one exact product).

@pytest.mark.parametrize("impl", ["bf16", "bf16x8", "int8x8"])
def test_tap_impls_bit_identical_to_pallas(impl):
    sky = sun_sky()
    H, W = sky.shape[:2]
    jp, tp = _plane(sky)
    rng = np.random.default_rng(11)
    n = 1500
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    u1, u2 = rng.uniform(size=(2, n)).astype(np.float32)
    want = sample_skybox_rgbe_mxu((H, W), jp, tuple(jnp.asarray(c) for c in d),
                                  jnp.asarray(u1), jnp.asarray(u2),
                                  interpret=True, block=128, impl=impl)
    got = sample_skybox_tap((H, W), tp, tuple(torch.from_numpy(c.copy())
                                              for c in d),
                            torch.from_numpy(u1), torch.from_numpy(u2),
                            impl=impl)
    for k in range(3):
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))


@pytest.mark.parametrize("n", [1024, 1061])
def test_env_planes_plain_bit_identical_to_pallas_kernel(n):
    sky = sun_sky()
    H, W = sky.shape[:2]
    jp, tp = _plane(sky)
    rng = np.random.default_rng(n + 1)
    yn = rng.integers(0, H, n).astype(np.int32)
    xn = rng.integers(0, W, n).astype(np.int32)
    want = _env_lookup(jp, jnp.asarray(yn), jnp.asarray(xn), H, W,
                       interpret=True, block=128)
    got = env_lookup_planes_plain(byte_planes(tp, H, W), torch.from_numpy(yn),
                                  torch.from_numpy(xn), W)
    for k in range(3):
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))


def test_byte_planes_match_jax_table():
    sky = sun_sky()
    H, W = sky.shape[:2]
    jp, tp = _plane(sky)
    want = np.asarray(_byte_planes(jp, H, W, "bf16").astype(jnp.float32))
    got = byte_planes(tp, H, W)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (H, 4 * W)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))
    assert (want == got.numpy().astype(np.float32)).all()


def test_unknown_env_impl_raises(monkeypatch):
    sky = sun_sky()
    _, tp = _plane(sky)
    d = tuple(torch.tensor([0.0, 1.0, 0.0]).reshape(3, 1))
    u = torch.zeros(1)
    with pytest.raises(ValueError, match="unknown env impl"):
        sample_skybox_tap(sky.shape[:2], tp, d, u, u, impl="f32")
    monkeypatch.setattr(cuda_env, "ENV_IMPL", "bf16x4")
    with pytest.raises(ValueError, match="unknown env impl"):
        sample_skybox_tap(sky.shape[:2], tp, d, u, u)


def test_byte_planes_built_once_per_plane(monkeypatch):
    # The "bf16" impl reads a table built once per packed plane, not once
    # per tap; a new plane gets its own table.
    sky = sun_sky()
    H, W = sky.shape[:2]
    _, tp = _plane(sky)
    calls = []
    real = cuda_env.byte_planes
    monkeypatch.setattr(cuda_env, "byte_planes",
                        lambda *a: calls.append(1) or real(*a))
    d = tuple(torch.tensor([0.3, 0.8, -0.5]).reshape(3, 1))
    u = torch.full((1,), 0.5)
    a = sample_skybox_tap((H, W), tp, d, u, u, impl="bf16")
    b = sample_skybox_tap((H, W), tp, d, u, u, impl="bf16")
    assert len(calls) == 1 and all(torch.equal(x, y) for x, y in zip(a, b))
    sample_skybox_tap((H, W), tp.clone(), d, u, u, impl="bf16")
    assert len(calls) == 2
