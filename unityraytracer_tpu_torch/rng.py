"""Threefry-2x32 random streams, bit-for-bit equal to ``jax.random``.

The counterpart of ``jax.random`` under jax 0.9.0 with
``jax_threefry_partitionable=True`` (the default), for the four calls the
renderer makes: ``key``, ``split``, ``fold_in`` and ``uniform``. The golden
image and the oracle gates compare renders pixel for pixel, so the port has
to draw the very same uniforms as the JAX package.

A key is a host ``numpy`` array of shape (2,) and dtype uint32 — the same
words ``jax.random.key_data`` returns — so key derivation never touches the
device. ``uniform`` evaluates the hash on a torch device. Its uint32
arithmetic runs in int64 tensors masked with 0xFFFFFFFF, because torch's
uint32 coverage is thin; the same code runs on CPU and CUDA tensors.

Reference: ``jax/_src/prng.py`` — ``threefry_2x32``,
``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable`` and ``iota_2x32_shape``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on uint32 words held in wider integers.

    ``k1``/``k2`` are Python ints; ``x1``/``x2`` are int64 torch tensors or
    uint64 numpy arrays with values below 2**32. Returns the two output words
    in the same container type."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def _words(key) -> tuple:
    k = np.asarray(key, np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)`` key data: (seed >> 32, seed & 0xFFFFFFFF) of
    the seed as a 32-bit integer (JAX's default without x64)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit a 32-bit integer")
    return np.array([0, seed & MASK], np.uint32)


def split(key_: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) keys, key i = threefry(key, (0, i))."""
    k1, k2 = _words(key_)
    lo = np.arange(num, dtype=np.uint64)
    b1, b2 = threefry2x32(k1, k2, np.zeros_like(lo), lo)
    return np.stack([b1, b2], axis=-1).astype(np.uint32)


def fold_in(key_: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: threefry(key, (0, data mod 2**32))."""
    k1, k2 = _words(key_)
    b1, b2 = threefry2x32(k1, k2, np.zeros(1, np.uint64),
                          np.array([int(data) & MASK], np.uint64))
    return np.array([b1[0], b2[0]], np.uint32)


def random_bits(key_: np.ndarray, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """32-bit words ``bits1 ^ bits2`` of threefry on the (hi, lo) counter
    pair of each flat index, as int64 values in [0, 2**32)."""
    k1, k2 = _words(key_)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key_: np.ndarray, shape: Sequence[int],
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1) float32: the top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key_, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0
