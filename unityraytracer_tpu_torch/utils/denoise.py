"""Edge-avoiding a-trous denoising of progressive frames.

The port of the JAX package's ``utils/denoise.py``: the a-trous wavelet
filter of Dammertz et al. 2010 ("Edge-Avoiding A-Trous Wavelet Transform
for Fast Global Illumination Filtering"). Each level is a 5x5 B3-spline
cross-bilateral pass with the kernel dilated by 2^level and edge-clamped
taps; the range weight is exp(-|dc|^2 / 2 sigma_c^2) of the color distance,
optionally times albedo and normal guide terms from the first-hit G-buffer
(``render.render_aovs``), which are noise-free and so keep texture and
silhouette edges when the color sigma is opened wide. Guides are read, not
filtered.

``atrous_denoise`` launches ``csrc/denoise_kernel.cu:urt_atrous`` once per
level for CUDA tensors and runs ``atrous_denoise_plain``, the same math in
torch ops, for CPU tensors. Both evaluate every pixel in the same float32
order: d2 = (c0 + c1) + c2 of the squared differences, logw = -d2 * inv_c
minus each guide's gd2 * inv_g, w = w_k * exp(logw), taps dy-major and
dx-minor, then one true division acc / max(wsum, 1e-12).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

# B3 spline taps (outer product gives the 5x5 kernel); each product is a
# multiple of 1/256, exact in float32.
_TAPS = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)

# The a-trous kernel against atrous_denoise_plain on the same card, in ulp
# (``utils.image.ulp_distance``; 0: bit for bit).
ATROUS_ULP = 0


def inv2s2(s: float) -> float:
    """1 / max(2 s^2, 1e-12) rounded as the JAX package rounds it: 2 s s in
    double, then float32, the max in float32 and a float32 division. The
    float32 result, as a Python float (exact)."""
    x = np.maximum(np.float32(2.0 * s * s), np.float32(1e-12))
    return float(np.float32(1.0) / x)


def _guides(img, albedo, normal, sigma_albedo, sigma_normal):
    """[(guide, inv_g), ...] in the filter's order: albedo, then normal."""
    out = []
    for g, s in ((albedo, sigma_albedo), (normal, sigma_normal)):
        if g is not None:
            g = torch.as_tensor(g, dtype=torch.float32, device=img.device)
            if g.shape != img.shape:
                raise ValueError(f"guide {tuple(g.shape)} does not match the "
                                 f"image {tuple(img.shape)}")
            out.append((g.contiguous(), inv2s2(s)))
    return out


def _level_plain(out, step: int, inv_c: float, guides):
    """One a-trous level in torch ops (the kernel's plain version)."""
    H, W = out.shape[0], out.shape[1]
    ys = torch.arange(H, device=out.device)
    xs = torch.arange(W, device=out.device)
    acc = torch.zeros_like(out)
    wsum = torch.zeros((H, W), dtype=torch.float32, device=out.device)
    for dy in range(-2, 3):
        rows = torch.clamp(ys + dy * step, 0, H - 1)[:, None]
        for dx in range(-2, 3):
            cols = torch.clamp(xs + dx * step, 0, W - 1)[None, :]
            w_k = _TAPS[dy + 2] * _TAPS[dx + 2]
            shifted = out[rows, cols]
            d = shifted - out
            sq = d * d
            logw = -((sq[..., 0] + sq[..., 1]) + sq[..., 2]) * inv_c
            for g, inv_g in guides:
                gd = g[rows, cols] - g
                gq = gd * gd
                logw = logw - ((gq[..., 0] + gq[..., 1]) + gq[..., 2]) * inv_g
            w = w_k * torch.exp(logw)
            acc = acc + shifted * w[..., None]
            wsum = wsum + w
    # A true division by a tensor on either device (torch's CUDA division
    # by a Python scalar would multiply by its reciprocal).
    return acc / torch.clamp_min(wsum, 1e-12)[..., None]


def atrous_denoise_plain(img, iterations: int = 3, sigma_color: float = 0.1,
                         albedo=None, normal=None, sigma_albedo: float = 0.15,
                         sigma_normal: float = 0.3) -> torch.Tensor:
    """Plain version of ``atrous_denoise``: each level in torch ops on the
    image's device (25 gathers of the image and of each guide a level)."""
    img = torch.as_tensor(img, dtype=torch.float32)
    guides = _guides(img, albedo, normal, sigma_albedo, sigma_normal)
    inv_c = inv2s2(sigma_color)
    out = img
    for level in range(iterations):
        out = _level_plain(out, 1 << level, inv_c, guides)
    return out


def atrous_denoise(img, iterations: int = 3, sigma_color: float = 0.1,
                   albedo=None, normal=None, sigma_albedo: float = 0.15,
                   sigma_normal: float = 0.3) -> torch.Tensor:
    """Edge-avoiding a-trous filter, optionally G-buffer guided.

    Args:
      img: (H, W, 3) linear radiance (tensor or array).
      iterations: wavelet levels (dilation 1, 2, 4, ...). 3 suits preview;
        5 for very noisy 1-sample frames.
      sigma_color: range sigma in linear radiance units — smaller preserves
        more edges.
      albedo/normal: optional (H, W, 3) first-hit guide buffers
        (``render.render_aovs``); not filtered across levels.
      sigma_albedo/sigma_normal: range sigmas for the guide terms.
    Returns:
      (H, W, 3) float32 filtered image on the image's device. For a CUDA
      image, one launch of the a-trous kernel per level, ping-ponging
      between two buffers (the input is never written); for a CPU image,
      ``atrous_denoise_plain``.
    """
    img = torch.as_tensor(img, dtype=torch.float32)
    if img.device.type == "cpu":
        return atrous_denoise_plain(img, iterations, sigma_color, albedo,
                                    normal, sigma_albedo, sigma_normal)
    if img.device.type != "cuda":
        raise ValueError(f"no a-trous kernel for device {img.device}")
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {tuple(img.shape)}")
    H, W = img.shape[0], img.shape[1]
    if H * W * 3 >= 2 ** 31:
        raise ValueError(f"{H}x{W} exceeds the a-trous kernel's 32-bit "
                         "indexing")
    img = img.contiguous()
    guides = _guides(img, albedo, normal, sigma_albedo, sigma_normal)
    # The kernel's two guide slots, in the filter's order; None is NULL.
    gp = [g.data_ptr() for g, _ in guides] + [None] * (2 - len(guides))
    gi = [inv for _, inv in guides] + [0.0] * (2 - len(guides))
    inv_c = inv2s2(sigma_color)
    if iterations <= 0:
        return img
    bufs = (torch.empty_like(img), torch.empty_like(img))
    src = img
    for level in range(iterations):
        dst = bufs[level % 2]
        with _build.on_card(dst.device):
            code = _build.lib().urt_atrous(
                src.data_ptr(), dst.data_ptr(), gp[0], gp[1], H, W,
                1 << level, inv_c, gi[0], gi[1],
                _build.stream_ptr(dst.device))
        _build.count("atrous", dst.device)
        _build.check(code, "atrous")
        src = dst
    return src
