"""Random streams bit-for-bit equal to ``jax.random``, in both of the JAX
package's implementations.

The counterpart of ``jax.random`` under jax 0.9.0 with
``jax_threefry_partitionable=True`` (the default), for the four calls the
renderer makes: ``key``, ``split``, ``fold_in`` and ``uniform``. The golden
image and the oracle gates compare renders pixel for pixel, so the port has
to draw the very same uniforms as the JAX package.

A key is a host ``numpy`` uint32 array — the words ``jax.random.key_data``
returns — so key derivation never touches the device. Its length names its
implementation, as a typed JAX key's impl does:

* shape (2,): ``"threefry2x32"``, JAX's default. Bits are the Threefry-2x32
  hash of each flat index's (hi, lo) counter pair, XORed.
* shape (4,): ``"rbg"``. Keys are derived with Threefry on each half
  (``key(seed)`` is ``[0, seed, 0, seed]``; ``split`` and ``fold_in`` hash
  words (0, 1) and (2, 3) separately), and bits come from XLA's
  RngBitGenerator, which on XLA:CPU is Philox4x32-10: key (w0, w1), 128-bit
  counter ``w2 | w3 << 32 | w0 << 64 | w1 << 96`` plus ``i >> 2`` for flat
  index i, output word ``i & 3`` of that block. These are the bits of the
  JAX package on the CPU; a TPU draws other words for the same key.

``uniform`` evaluates the bits on a torch device: for a CUDA device in one
launch of the uniform kernel (``csrc/uniform_kernel.cu``, either mode), for
the CPU through its plain version ``uniform_plain``, whose uint32 arithmetic
runs in int64 tensors masked with 0xFFFFFFFF (torch's uint32 coverage is
thin). Both implementations map bits to floats alike: the top 23 bits as
the mantissa of a float in [1, 2), minus 1. ``bounce_keys`` derives the
per-bounce keys of the path kernel's uniform rows on the host, for their
plain version (``render.bounce_rows_plain``; the kernel derives the same
keys itself, from k_bounce).

Reference: ``jax/_src/prng.py`` — ``threefry_2x32``,
``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``, ``iota_2x32_shape``,
``_rbg_seed``, ``_rbg_split``, ``_rbg_fold_in`` and ``_rbg_random_bits``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from . import _build
from .config import IMPLS

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KEY_WORDS = {"threefry2x32": 2, "rbg": 4}
# Philox4x32-10's multipliers and key bumps (Salmon et al., SC'11).
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


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


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) words of the 64-bit product of the 32-bit constant ``m`` and
    the int64 tensor ``x`` (values below 2**32). The product can reach
    2**64, past int64, so ``m`` goes in 16-bit halves: each partial product
    stays below 2**48."""
    t_lo = x * (m & 0xFFFF)
    t_hi = x * (m >> 16)
    low = t_lo + ((t_hi & 0xFFFF) << 16)
    return (t_hi >> 16) + (low >> 32), low & MASK


def philox4x32_10(k0: int, k1: int, c0, c1, c2, c3):
    """Philox4x32-10 of the counter words ``c0..c3`` (int64 tensors below
    2**32, c0 the lowest) under the key (k0, k1): the four output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & MASK
        k1 = (k1 + _PHILOX_W[1]) & MASK
    return c0, c1, c2, c3


def impl_of(key_) -> str:
    """The implementation of a key, from its length."""
    n = np.asarray(key_).size
    for impl, words in _KEY_WORDS.items():
        if n == words:
            return impl
    raise ValueError(f"a key has 2 words (threefry2x32) or 4 (rbg), got {n}")


def _words(key_) -> tuple:
    """The key's uint32 words as Python ints: two or four."""
    k = np.asarray(key_, np.uint32).reshape(-1)
    impl_of(k)
    return tuple(int(w) for w in k)


def kernel_words(key_) -> tuple:
    """What the kernels take for a key: its four words (a threefry key's
    two, then two zeros) and 1 for an rbg key, else 0."""
    w = _words(key_)
    return (*w, 0, 0)[:4], int(len(w) == 4)


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown rng_impl {impl!r}: the port draws "
                         f"{' and '.join(map(repr, IMPLS))}")


def key(seed: int, impl: str = "threefry2x32") -> np.ndarray:
    """``jax.random.key(seed, impl=impl)`` key data: the seed as a 32-bit
    integer gives threefry's (seed >> 32, seed & 0xFFFFFFFF) (JAX's default
    without x64), and rbg's is that pair twice."""
    _check_impl(impl)
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit a 32-bit integer")
    half = [0, seed & MASK]
    return np.array(half * (_KEY_WORDS[impl] // 2), np.uint32)


def wrap_key_data(data, impl: str) -> np.ndarray:
    """``jax.random.wrap_key_data(data, impl=impl)``: the words as a key of
    ``impl``; a length of the other implementation raises ``ValueError``."""
    _check_impl(impl)
    k = np.asarray(data, np.uint32).reshape(-1)
    if k.size != _KEY_WORDS[impl]:
        raise ValueError(f"key data of {k.size} words is not an {impl} key "
                         f"({_KEY_WORDS[impl]} words)")
    return k.copy()


def _halves(key_) -> list:
    w = _words(key_)
    return [w[j:j + 2] for j in range(0, len(w), 2)]


def split(key_: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) or (num, 4) keys. Key i of each half is
    threefry(half, (0, i)), which is ``fold_in(half, i)``; hashed on Python
    ints (the renderer splits in two or three, where numpy's per-call cost
    outweighs the hash)."""
    halves = _halves(key_)
    return np.array([[w for k1, k2 in halves
                      for w in threefry2x32(k1, k2, 0, i)]
                     for i in range(num)], np.uint32).reshape(
                         num, 2 * len(halves))


def fold_in(key_: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: threefry(half, (0, data mod 2**32)) of each
    half, hashed on Python ints (a frame folds in dozens of keys on the
    host)."""
    d = int(data) & MASK
    return np.array([w for k1, k2 in _halves(key_)
                     for w in threefry2x32(k1, k2, 0, d)], np.uint32)


def bounce_keys(k_bounce: np.ndarray, bounces: int) -> np.ndarray:
    """(bounces, 4, 2) or (bounces, 4, 4) uint32 keys
    ``fold_in(fold_in(k_bounce, b), row)`` of the uniform rows u_r, u1, u2
    and the roulette draw of each bounce."""
    words = len(_words(k_bounce))
    out = np.empty((bounces, 4, words), np.uint32)
    for b in range(bounces):
        kb = fold_in(k_bounce, b)
        for row in range(4):
            out[b, row] = fold_in(kb, row)
    return out


def _rbg_blocks(key_, blocks: torch.Tensor):
    """The four Philox words of rbg block ``blocks`` (int64 indices): the
    key's 128-bit counter plus the block index, carried word by word."""
    w0, w1, w2, w3 = _words(key_)
    s = w2 + (blocks & MASK)
    c0 = s & MASK
    s = w3 + (blocks >> 32) + (s >> 32)
    c1 = s & MASK
    s = w0 + (s >> 32)
    c2 = s & MASK
    c3 = (w1 + (s >> 32)) & MASK
    return philox4x32_10(w0, w1, c0, c1, c2, c3)


def random_bits(key_: np.ndarray, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """32-bit words of ``jax.random.bits(key, shape)`` as int64 values in
    [0, 2**32): threefry's ``bits1 ^ bits2`` of the (hi, lo) counter pair
    of each flat index, or rbg's Philox words, four a block."""
    n = math.prod(shape)
    if impl_of(key_) == "rbg":
        blocks = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
        bits = torch.stack(_rbg_blocks(key_, blocks), dim=1).reshape(-1)[:n]
        return bits.reshape(tuple(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return _bits_at(key_, idx).reshape(tuple(shape))


def _bits_at(key_: np.ndarray, counters: torch.Tensor) -> torch.Tensor:
    if impl_of(key_) == "rbg":
        words = torch.stack(_rbg_blocks(key_, counters >> 2))
        return words.gather(0, (counters & 3)[None])[0]
    k1, k2 = _words(key_)
    b1, b2 = threefry2x32(k1, k2, counters >> 32, counters & MASK)
    return b1 ^ b2


def _to_unit(bits: torch.Tensor) -> torch.Tensor:
    """The top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform_plain(key_: np.ndarray, shape: Sequence[int],
                  device=None) -> torch.Tensor:
    """Plain version of ``uniform``: the int64 torch bits of
    ``random_bits``, mapped to [0, 1)."""
    return _to_unit(random_bits(key_, shape, device))


def uniform_at_plain(key_: np.ndarray, counters: torch.Tensor) -> torch.Tensor:
    """The floats ``uniform_plain(key, shape)`` puts at the flat indices
    ``counters`` (an int64 tensor), without drawing the others."""
    return _to_unit(_bits_at(key_, counters.to(torch.int64)))


def uniform(key_: np.ndarray, shape: Sequence[int],
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1) float32 on ``device``
    (the CPU when None): the uniform kernel in the key's mode for a CUDA
    device, the plain version for the CPU; bit for bit the same floats."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cpu":
        return uniform_plain(key_, shape, device)
    if device.type != "cuda":
        raise ValueError(f"no uniform kernel for device {device}")
    words, rbg = kernel_words(key_)
    n = math.prod(shape)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    with _build.on_card(out.device):
        code = _build.lib().urt_uniform(*words, rbg, out.data_ptr(), n,
                                        _build.stream_ptr(out.device))
    name = "uniform_rbg" if rbg else "uniform"
    _build.count(name, out.device)
    _build.check(code, name)
    return out
