"""unityraytracer_tpu_torch — the path tracer in PyTorch, with hand-written
CUDA kernels for the NVIDIA H100 (sm_90a).

A port of the JAX package beside it, which stays the reference:
same public names, same configs, same random streams. It imports torch and
numpy only. The kernels (``csrc/``) are built with nvcc at first use on a
machine with the CUDA toolkit; on CPU tensors every kernel entry point runs
its plain PyTorch version instead.
"""

from .camera import Camera, camera_from_numpy, camera_rays_soa
from .config import RenderConfig
from .render import (Renderer, RenderState, progressive_step, render_frame,
                     render_sample, render_sample_mega)
from .scene import (Material, Scene, SceneBuilder, scene_from_numpy,
                    scene_to_numpy)

__all__ = [
    "Camera", "Material", "RenderConfig", "RenderState", "Renderer", "Scene",
    "SceneBuilder", "camera_from_numpy", "camera_rays_soa", "progressive_step",
    "render_frame", "render_sample", "render_sample_mega", "scene_from_numpy",
    "scene_to_numpy",
]
