"""Static render configuration (PyTorch port).

Same fields and defaults as the JAX package's ``RenderConfig``, so configs
written for it (the golden test, the bench settings) carry over unchanged.
``tracer="pallas"`` keeps its name: in this package it selects the
hand-written CUDA kernels (``ops/cuda_trace.py``, ``ops/cuda_path.py``),
which run for CUDA tensors; for CPU tensors the same entry points run their
plain PyTorch versions.

``split_bounce``/``split_frac``, ``spp_chunk``, ``dispatch_bands`` and
``ray_bin_bounces`` keep the JAX package's meanings. ``ray_bin_bounces``
changes speed only: at those bounces the kernels sort each thread block's
rays by direction octant and origin cell before tracing them
(``ops/cuda_trace.SORT_WINDOW``), and the results are the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# The rng_impl values, in rng.py's terms: a key of 2 words or of 4.
IMPLS = ("threefry2x32", "rbg")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering knobs.

    Attributes:
      width/height: framebuffer size in pixels.
      spp: rays launched per pixel per frame.
      bounces: path depth.
      tracer: intersection backend:
        - "brute": exhaustive torch ray x primitive tests (the oracle)
        - "bvh", "cluster": the bounce loop over the cluster LBVH
          (``ops/traverse.py``): on the card the closest-hit kernel, on
          the CPU the JAX package's per-ray stack traversal and sorted
          cluster sweep
        - "pallas": the hand-written CUDA kernels (plain torch on CPU)
      ray_chunk: rays per brute-force chunk (bounds peak memory).
      cluster_size: triangles per LBVH leaf cluster.
      wavefront: park dead rays far outside the scene between bounces.
      max_traversal_steps: accepted for config parity and read by neither
        package (the JAX package declares it and never reads it).
      sky_rgbe: one stochastic RGBE sky tap per ray (else bilinear float sky).
      sky_mxu: route the RGBE tap through the env kernel
        (``ops/cuda_env.py``), bit-identical to the plain gather.
      russian_roulette: unbiased RR from bounce 3 (2 <= b < bounces - 1).
      ray_bin_bounces: inclusive window of global bounces at which the
        "pallas" tracer sorts its rays by direction octant and origin cell
        (dead rays last) before tracing them, in the path kernel and in
        the closest-hit kernel of the bounce loop; (None, None), or a None
        end, sorts nothing. No effect on results.
      rr_group: "ray" (one RR draw per ray) or "step" (one per 8x128 pixels).
      megakernel: with tracer="pallas", run every bounce in one path-kernel
        launch; False runs the bounce loop on the closest-hit kernel.
      split_bounce/split_frac: with the path kernel, and only when
        0 < split_bounce < bounces, run bounces [0, split_bounce) at full
        width, then the rest on a compact buffer of the surviving rays,
        ceil(N * split_frac) slots rounded up to 1024; survivors past it
        finish in a full-width remainder pass. Each ray keeps its own
        uniform stream, so the image equals the unsplit one up to float
        addition order (``render._path_trace_split``).
      spp_chunk: when spp > spp_chunk, render the frame as sub-frames of
        spp_chunk samples at keys fold_in(key, i), plus one remainder
        sub-frame, averaged with exact spp weights. Bounds the per-launch
        buffers; matches the unchunked frame in distribution, not bitwise.
      dispatch_bands: n > 1 makes ``Renderer.step`` render each frame as n
        horizontal bands (ceil(height / n) rows, a ragged last band) keyed
        fold_in(frame key, band). Matches the whole frame in distribution.
        With tracer="pallas" keep band heights multiples of 8 (the 8x16
        pixel blocking).
      rng_impl: "threefry2x32" (the default) or "rbg", the JAX package's
        two values (``rng.py``, bit-exact with jax.random). Under "rbg" the
        keys are derived with threefry on each half of a 4-word key and the
        bits are Philox4x32-10, which is what XLA's RngBitGenerator draws
        on the CPU: the port's "rbg" bits equal the JAX package's on the
        CPU, while a TPU draws other bits for the same key (the JAX
        config's PORTABILITY note). Streams are identical across tracers
        for a given key under either value; they differ between the two,
        which changes the noise pattern, not the estimator. Any other name
        raises ``ValueError``.
    """

    width: int = 256
    height: int = 256
    spp: int = 1
    bounces: int = 8
    tracer: str = "brute"
    ray_chunk: int = 8192
    cluster_size: int = 64
    wavefront: bool = False
    max_traversal_steps: Optional[int] = None
    sky_rgbe: bool = True
    sky_mxu: bool = True
    russian_roulette: bool = True
    ray_bin_bounces: tuple = (1, 2)
    rr_group: str = "ray"
    megakernel: bool = True
    split_bounce: Optional[int] = None
    split_frac: float = 0.125
    spp_chunk: Optional[int] = None
    dispatch_bands: Optional[int] = None
    rng_impl: str = "threefry2x32"

    def __post_init__(self):
        if self.tracer not in ("brute", "bvh", "cluster", "pallas"):
            raise ValueError(f"unknown tracer {self.tracer!r}")
        if self.rng_impl not in IMPLS:
            raise ValueError(
                f"unknown rng_impl {self.rng_impl!r}: the port draws "
                f"{' and '.join(map(repr, IMPLS))}")
        if self.rr_group not in ("ray", "step"):
            raise ValueError(f"unknown rr_group {self.rr_group!r}")

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def num_rays(self) -> int:
        return self.width * self.height * self.spp

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
