"""Static render configuration (PyTorch port).

Same fields and defaults as the JAX package's ``RenderConfig``, so configs
written for it (the golden test, the bench settings) carry over unchanged.
``tracer="pallas"`` keeps its name: in this package it selects the
hand-written CUDA kernels (``ops/cuda_trace.py``, ``ops/cuda_path.py``),
which run for CUDA tensors; for CPU tensors the same entry points run their
plain PyTorch versions.

Knobs that the port does not implement yet raise ``NotImplementedError`` on
a non-default value rather than being ignored: ``split_bounce``,
``spp_chunk`` and ``dispatch_bands``. ``ray_bin_bounces`` only changes speed
in the JAX package (its coherence sort is bit-identical), and is accepted and
ignored here: the CUDA kernels trace rays in their given order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering knobs.

    Attributes:
      width/height: framebuffer size in pixels.
      spp: rays launched per pixel per frame.
      bounces: path depth.
      tracer: intersection backend:
        - "brute": exhaustive torch ray x primitive tests (the oracle)
        - "pallas": the hand-written CUDA kernels (plain torch on CPU)
        "bvh" and "cluster" exist in the JAX package and are not ported yet.
      ray_chunk: rays per brute-force chunk (bounds peak memory).
      cluster_size: triangles per LBVH leaf cluster.
      wavefront: park dead rays far outside the scene between bounces.
      max_traversal_steps: used by the JAX package's jnp BVH tracer only.
      sky_rgbe: one stochastic RGBE sky tap per ray (else bilinear float sky).
      sky_mxu: route the RGBE tap through the env kernel
        (``ops/cuda_env.py``), bit-identical to the plain gather.
      russian_roulette: unbiased RR from bounce 3 (2 <= b < bounces - 1).
      ray_bin_bounces: accepted for config parity; no effect in the port.
      rr_group: "ray" (one RR draw per ray) or "step" (one per 8x128 pixels).
      megakernel: with tracer="pallas", run every bounce in one path-kernel
        launch; False runs the bounce loop on the closest-hit kernel.
      split_bounce/split_frac, spp_chunk, dispatch_bands: not ported yet.
      rng_impl: only "threefry2x32" (``rng.py``, bit-exact with jax.random).
        "rbg" bits depend on the XLA backend and cannot be reproduced.
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
        if self.tracer in ("bvh", "cluster"):
            raise NotImplementedError(f"tracer {self.tracer!r} is not ported yet")
        if self.tracer not in ("brute", "pallas"):
            raise ValueError(f"unknown tracer {self.tracer!r}")
        if self.rng_impl != "threefry2x32":
            raise ValueError(
                f"rng_impl={self.rng_impl!r}: the port reproduces only "
                "threefry2x32 (rbg bits depend on the XLA backend)")
        if self.split_bounce is not None:
            raise NotImplementedError("split_bounce is not ported yet")
        if self.spp_chunk is not None:
            raise NotImplementedError("spp_chunk is not ported yet")
        if self.dispatch_bands is not None and self.dispatch_bands > 1:
            raise NotImplementedError("dispatch_bands is not ported yet")
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
