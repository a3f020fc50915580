"""The port's threefry streams (unityraytracer_tpu_torch/rng.py) against
jax.random: key, split, fold_in and uniform must agree bit for bit, because
the golden image and the oracle gates compare renders pixel for pixel."""

import numpy as np
import jax
import pytest
import torch

from unityraytracer_tpu_torch import rng

SEEDS = [0, 1, 42, 123, 2 ** 31 - 1, -7]


def _data(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_bit_exact(seed):
    np.testing.assert_array_equal(rng.key(seed), _data(jax.random.key(seed)))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("num", [1, 2, 3, 17])
def test_split_bit_exact(seed, num):
    got = rng.split(rng.key(seed), num)
    want = _data(jax.random.split(jax.random.key(seed), num))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("data", [0, 1, 7, 12345, 2 ** 31 - 1])
def test_fold_in_bit_exact(data):
    for seed in SEEDS[:3]:
        got = rng.fold_in(rng.key(seed), data)
        want = _data(jax.random.fold_in(jax.random.key(seed), data))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1,), (2,), (7,), (1001,), (3, 5, 4),
                                   (2, 13, 1)])
def test_uniform_bit_exact(shape):
    for seed in SEEDS:
        got = rng.uniform(rng.key(seed), shape).numpy()
        want = np.asarray(jax.random.uniform(jax.random.key(seed), shape))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_derived_key_chain_bit_exact():
    # The renderer's chain: split, fold_in by sample index, split in three,
    # fold_in per bounce and row, then a block of uniforms.
    jk, pk = jax.random.key(9), rng.key(9)
    for n in range(3):
        jk, jsub = jax.random.split(jk)
        pk, psub = rng.split(pk)
        jf = jax.random.fold_in(jsub, n)
        pf = rng.fold_in(psub, n)
        jks = jax.random.split(jf, 3)
        pks = rng.split(pf, 3)
        np.testing.assert_array_equal(pks, _data(jks))
        ju = jax.random.uniform(jax.random.fold_in(jax.random.fold_in(
            jks[2], 1), 2), (513,))
        pu = rng.uniform(rng.fold_in(rng.fold_in(pks[2], 1), 2), (513,))
        np.testing.assert_array_equal(pu.numpy().view(np.uint32),
                                      np.asarray(ju).view(np.uint32))


def test_uniform_range_and_device_arg():
    u = rng.uniform(rng.key(3), (4096,), device=torch.device("cpu"))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert u.dtype == torch.float32


def test_seed_out_of_range_raises():
    with pytest.raises(ValueError):
        rng.key(2 ** 40)
