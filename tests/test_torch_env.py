"""Sky tap: the plain version of the env kernel must be BIT-identical to the
JAX package's Pallas env kernel (_env_lookup8, run in interpret mode) and to
its gather path (sample_skybox_rgbe with u1/u2). The decode scale table of
ops/shade.py reproduces XLA's jnp.exp2 exactly, subnormal flush included."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unityraytracer_tpu.ops.pallas_env import _env_lookup8
from unityraytracer_tpu.ops.shade import sample_skybox_rgbe as jax_tap
from unityraytracer_tpu_torch.models.skybox import gradient_sky, sun_sky
from unityraytracer_tpu_torch.ops.cuda_env import (env_lookup,
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
    got = env_lookup(tp, torch.from_numpy(yn), torch.from_numpy(xn), W)
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
