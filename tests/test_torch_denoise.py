"""The port's a-trous denoiser (plain route, CPU) against the JAX package's.

Inputs come from numpy with fixed seeds and go through both functions.
Tolerance: abs 1e-5 + rel 1e-5 — the two evaluate each pixel in the same
float32 order, but torch's and XLA:CPU's exp differ by an ulp. The
behaviour tests of tests/test_denoise.py (noise drops, the hard edge
survives, the guided edge survives) run on the port as they run there."""

import numpy as np
import pytest
import torch

from unityraytracer_tpu.utils.denoise import atrous_denoise as jax_denoise
from unityraytracer_tpu_torch import _build
from unityraytracer_tpu_torch.utils.denoise import (ATROUS_ULP,
                                                    atrous_denoise,
                                                    atrous_denoise_plain,
                                                    inv2s2)
from unityraytracer_tpu_torch.utils.image import ulp_distance

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(h, w, seed, constant=False):
    rng = np.random.default_rng(seed)
    if constant:
        img = np.full((h, w, 3), 0.7, np.float32)
    else:
        img = rng.gamma(0.6, 0.5, (h, w, 3)).astype(np.float32)
        img[:, w // 3:, 1] += 1.0                      # an edge in one channel
    albedo = np.clip(rng.normal(0.5, 0.2, (h, w, 3)), 0, 1).astype(np.float32)
    albedo[h // 2:] *= 0.25
    n = rng.normal(0, 1, (h, w, 3)).astype(np.float32)
    normal = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    return img, albedo, normal


GUIDES = {"unguided": (), "albedo": ("albedo",),
          "albedo_normal": ("albedo", "normal")}


@pytest.mark.parametrize("guides", list(GUIDES))
@pytest.mark.parametrize("iterations", [1, 3, 5])
@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_plain_matches_jax(hw, iterations, guides):
    img, albedo, normal = _inputs(*hw, seed=hw[1] + iterations)
    kw = {k: v for k, v in (("albedo", albedo), ("normal", normal))
          if k in GUIDES[guides]}
    args = dict(iterations=iterations, sigma_color=0.4, sigma_albedo=0.2,
                sigma_normal=0.5)
    want = np.asarray(jax_denoise(img, **args, **kw))
    got = atrous_denoise(torch.from_numpy(img), **args,
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.dtype == torch.float32 and got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("guides", list(GUIDES))
def test_constant_image_matches_jax(guides):
    img, albedo, normal = _inputs(40, 56, seed=1, constant=True)
    kw = {k: v for k, v in (("albedo", albedo), ("normal", normal))
          if k in GUIDES[guides]}
    want = np.asarray(jax_denoise(img, iterations=3, **kw))
    got = atrous_denoise(img, iterations=3, **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, img, atol=1e-5)     # a fixed point


def test_inverse_sigma_rounds_as_jax():
    import jax.numpy as jnp
    for s in (0.1, 0.15, 0.3, 1.0, 5.0, 1e-7, 0.0):
        want = np.float32(1.0 / jnp.maximum(2.0 * s * s, 1e-12))
        assert np.float32(inv2s2(s)) == want, s


def test_ulp_distance_counts_float32_steps():
    # The measure that holds the a-trous kernel to its plain version on the
    # card (ATROUS_ULP): steps between neighbouring float32 values, signed
    # zeros equal, across zero counted through it.
    x = np.array([1.0, 0.0, -np.float32(1e-45), 3.5], np.float32)
    y = np.nextafter(x, np.float32(np.inf))
    assert ulp_distance(torch.from_numpy(x), torch.from_numpy(x)) == 0
    assert ulp_distance(torch.from_numpy(x), torch.from_numpy(y)) == 1
    z = torch.tensor([0.0, -0.0, 2.0])
    assert ulp_distance(z, torch.tensor([-0.0, 0.0, 2.0])) == 0
    assert ulp_distance(torch.tensor([-1e-45]), torch.tensor([1e-45])) == 2
    big = torch.tensor([1.0]) + torch.tensor([2.0 ** -23]) * 5
    assert ulp_distance(torch.tensor([1.0]), big) == 5
    assert ATROUS_ULP == 0


def test_cpu_route_is_the_plain_version():
    img, albedo, normal = _inputs(24, 40, seed=3)
    before = dict(_build.LAUNCHES)
    a = atrous_denoise(img, 4, 0.3, albedo=albedo, normal=normal)
    b = atrous_denoise_plain(img, 4, 0.3, albedo=albedo, normal=normal)
    assert _build.LAUNCHES == before
    assert torch.equal(a, b)
    assert atrous_denoise(img, 0) is not None and torch.equal(
        atrous_denoise(img, 0), torch.from_numpy(img))
    with pytest.raises(ValueError):
        atrous_denoise(img, 2, albedo=albedo[:-1])
    with pytest.raises(ValueError):
        atrous_denoise(torch.empty((8, 8, 3), device="meta"), 1)


# The JAX package's behaviour tests (tests/test_denoise.py), on the port.
def _noisy_edge(h=64, w=64, noise=0.3, seed=0):
    rng = np.random.default_rng(seed)
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, w // 2:, :] = 1.0                     # hard vertical edge
    noisy = clean + rng.normal(0, noise, clean.shape).astype(np.float32)
    return clean, noisy


def test_port_reduces_noise_flat_regions():
    clean, noisy = _noisy_edge()
    out = atrous_denoise(noisy, iterations=3, sigma_color=1.0).numpy()
    for sl in (np.s_[8:-8, 8:24], np.s_[8:-8, 40:-8]):
        assert out[sl].std() < 0.35 * noisy[sl].std()
    assert abs(out.mean() - noisy.mean()) < 0.02


def test_port_preserves_hard_edge():
    clean, noisy = _noisy_edge(noise=0.05)
    out = atrous_denoise(noisy, iterations=3, sigma_color=0.1).numpy()
    left = out[16:-16, 24:30].mean()
    right = out[16:-16, 34:40].mean()
    assert right - left > 0.8
    rmse_after = np.sqrt(((out - clean) ** 2).mean())
    rmse_before = np.sqrt(((noisy - clean) ** 2).mean())
    assert rmse_after < rmse_before


def test_port_guided_denoise_preserves_albedo_edge():
    rng = np.random.default_rng(3)
    h, w = 64, 64
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, w // 2:, :] = 0.6
    noisy = clean + rng.normal(0, 0.25, clean.shape).astype(np.float32)
    albedo = np.zeros_like(clean)
    albedo[:, w // 2:, :] = 1.0
    normal = np.zeros_like(clean)
    normal[..., 2] = 1.0
    plain = atrous_denoise(noisy, iterations=4, sigma_color=5.0).numpy()
    guided = atrous_denoise(noisy, iterations=4, sigma_color=5.0,
                            albedo=albedo, normal=normal,
                            sigma_albedo=0.05).numpy()

    def edge_step(img):
        return float(img[:, w // 2 + 2:w // 2 + 6].mean()
                     - img[:, w // 2 - 6:w // 2 - 2].mean())
    assert edge_step(guided) > 0.5
    assert edge_step(guided) > edge_step(plain) + 0.2
    assert guided[8:-8, 8:24].std() < 0.4 * noisy[8:-8, 8:24].std()
