"""Threefry-2x32 random streams, bit-for-bit equal to ``jax.random``.

The counterpart of ``jax.random`` under jax 0.9.0 with
``jax_threefry_partitionable=True`` (the default), for the four calls the
renderer makes: ``key``, ``split``, ``fold_in`` and ``uniform``. The golden
image and the oracle gates compare renders pixel for pixel, so the port has
to draw the very same uniforms as the JAX package.

A key is a host ``numpy`` array of shape (2,) and dtype uint32 — the same
words ``jax.random.key_data`` returns — so key derivation never touches the
device. ``uniform`` evaluates the hash on a torch device: for a CUDA device
in one launch of the threefry kernel (``csrc/uniform_kernel.cu``), for the
CPU through its plain version ``uniform_plain``, whose uint32 arithmetic
runs in int64 tensors masked with 0xFFFFFFFF (torch's uint32 coverage is
thin). ``bounce_keys`` derives the per-bounce keys of the path kernel's
uniform rows on the host, for their plain version
(``render.bounce_rows_plain``; the kernel derives the same keys itself,
from k_bounce).

Reference: ``jax/_src/prng.py`` — ``threefry_2x32``,
``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable`` and ``iota_2x32_shape``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from . import _build

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on uint32 words held in wider integers.

    ``k1``/``k2`` are Python ints; ``x1``/``x2`` are Python ints, int64
    torch tensors or uint64 numpy arrays with values below 2**32. Returns
    the two output words in the same container type."""
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
    """``jax.random.split``: (num, 2) keys, key i = threefry(key, (0, i)),
    which is ``fold_in(key, i)``; hashed on Python ints (the renderer splits
    in two or three, where numpy's per-call cost outweighs the hash)."""
    k1, k2 = _words(key_)
    return np.array([threefry2x32(k1, k2, 0, i) for i in range(num)],
                    np.uint32).reshape(num, 2)


def fold_in(key_: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: threefry(key, (0, data mod 2**32)), hashed
    on Python ints (a frame folds in dozens of keys on the host)."""
    k1, k2 = _words(key_)
    b1, b2 = threefry2x32(k1, k2, 0, int(data) & MASK)
    return np.array([b1, b2], np.uint32)


def bounce_keys(k_bounce: np.ndarray, bounces: int) -> np.ndarray:
    """(bounces, 4, 2) uint32 keys ``fold_in(fold_in(k_bounce, b), row)``
    of the uniform rows u_r, u1, u2 and the roulette draw of each bounce."""
    out = np.empty((bounces, 4, 2), np.uint32)
    for b in range(bounces):
        kb = fold_in(k_bounce, b)
        for row in range(4):
            out[b, row] = fold_in(kb, row)
    return out


def random_bits(key_: np.ndarray, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """32-bit words ``bits1 ^ bits2`` of threefry on the (hi, lo) counter
    pair of each flat index, as int64 values in [0, 2**32)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return _bits_at(key_, idx).reshape(tuple(shape))


def _bits_at(key_: np.ndarray, counters: torch.Tensor) -> torch.Tensor:
    k1, k2 = _words(key_)
    b1, b2 = threefry2x32(k1, k2, counters >> 32, counters & MASK)
    return b1 ^ b2


def _to_unit(bits: torch.Tensor) -> torch.Tensor:
    """The top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform_plain(key_: np.ndarray, shape: Sequence[int],
                  device=None) -> torch.Tensor:
    """Plain version of ``uniform``: the int64 torch hash of
    ``random_bits``, mapped to [0, 1)."""
    return _to_unit(random_bits(key_, shape, device))


def uniform_at_plain(key_: np.ndarray, counters: torch.Tensor) -> torch.Tensor:
    """The floats ``uniform_plain(key, shape)`` puts at the flat indices
    ``counters`` (an int64 tensor), without drawing the others."""
    return _to_unit(_bits_at(key_, counters.to(torch.int64)))


def uniform(key_: np.ndarray, shape: Sequence[int],
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1) float32 on ``device``
    (the CPU when None): the threefry kernel for a CUDA device, the plain
    version for the CPU; bit for bit the same floats."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cpu":
        return uniform_plain(key_, shape, device)
    if device.type != "cuda":
        raise ValueError(f"no threefry kernel for device {device}")
    k1, k2 = _words(key_)
    n = math.prod(shape)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    code = _build.lib().urt_uniform(k1, k2, out.data_ptr(), n,
                                    _build.stream_ptr(device))
    _build.LAUNCHES["uniform"] += 1
    _build.check(code, "uniform")
    return out
