"""The CUDA build and binding plumbing that can be checked without a card:
the ctypes mirror of the kernels' SceneArgs struct, the source-hashed library
name, and the wrappers' routing (plain version for CPU tensors, a clear
error for devices without a kernel)."""

import re

import numpy as np
import pytest
import torch

from unityraytracer_tpu_torch import _build
from unityraytracer_tpu_torch.models import fixtures
from unityraytracer_tpu_torch.ops.bvh import build_cluster_accel
from unityraytracer_tpu_torch import rng
from unityraytracer_tpu_torch.ops.cuda_env import byte_planes, sky_tap
from unityraytracer_tpu_torch.ops.cuda_path import path_trace
from unityraytracer_tpu_torch.ops.cuda_trace import KernelScene, trace_hits
from unityraytracer_tpu_torch.config import RenderConfig


def test_scene_args_mirror_the_header():
    src = (_build.CSRC / "closest_hit.cuh").read_text()
    body = re.search(r"struct SceneArgs \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(const float\*|const int\*|int|float)\s+(\w+);",
                        body, re.M)
    ctypes_of = {"const float*": "c_void_p", "const int*": "c_void_p",
                 "int": "c_int", "float": "c_float"}
    want = [(name, ctypes_of[ty]) for ty, name in fields]
    got = [(name, ty.__name__) for name, ty in _build.SceneArgs._fields_]
    assert got == want


def test_library_name_tracks_sources():
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR
    assert re.fullmatch(r"liburt_kernels_[0-9a-f]{16}\.so", p.name)
    assert p == _build.library_path()
    assert {s.name for s in _build.CSRC.glob("*.cu")} == {
        "camera_kernel.cu", "denoise_kernel.cu", "env_kernel.cu",
        "path_kernel.cu", "trace_kernel.cu", "uniform_kernel.cu"}


def test_cpu_tensors_never_touch_the_kernels():
    scene = fixtures.scene1()
    ks = KernelScene.create(scene, build_cluster_accel(scene.triangles, 64))
    before = dict(_build.LAUNCHES)
    ro = tuple(torch.zeros(4) + c for c in (0.0, 1.0, -10.0))
    rd = tuple(torch.zeros(4) + c for c in (0.0, -1.0, 0.0))   # ground
    h = trace_hits(ks, ro, rd)
    assert (h.t == 1.0).all()
    uni = torch.full((2, 5, 4), 0.5)
    path_trace(ks, ro, rd, uni, RenderConfig(bounces=2))
    packed = ks.scene.skybox_rgbe
    H, W = ks.scene.skybox.shape[:2]
    rad = tuple(torch.zeros(4) for _ in range(3))
    sky_tap((H, W), packed, rad, rd, rd, (rng.key(1), rng.key(2)))
    assert all(torch.isfinite(r).all() for r in rad)
    assert _build.LAUNCHES == before


def test_overflow_flag_is_sticky_until_checked():
    # The kernels atomicOr the flag; here a CPU flag stands in for the
    # card's, since only the host-side read and reset are under test.
    _build.raise_on_overflow("cpu")                # no flag yet: no error
    flag = _build.error_flag("cpu")
    assert flag is _build.error_flag("cpu") and int(flag) == 0
    _build.raise_on_overflow("cpu")
    flag.fill_(1)
    with pytest.raises(RuntimeError, match="stack overflow"):
        _build.raise_on_overflow("cpu")
    assert int(flag) == 0
    _build.raise_on_overflow("cpu")


def test_kernel_scene_pointers_and_device_errors():
    scene = fixtures.scene1()
    accel = build_cluster_accel(scene.triangles, 64)
    ks = KernelScene.create(scene, accel)
    args = ks.args
    assert args.n_spheres == scene.num_spheres
    assert args.n_clusters == accel.num_clusters and args.cluster_size == 64
    assert args.tris == ks.tables["tris"].data_ptr()
    assert args.nodes == ks.tables["nodes"].data_ptr()
    assert args.tri_n0 == ks.accel.triangles.n0.data_ptr()
    assert args.ground_mat == int(scene.ground_material_id)
    meta = tuple(torch.empty(4, device="meta") for _ in range(3))
    with pytest.raises(ValueError):
        trace_hits(ks, meta, meta)
    with pytest.raises(ValueError):
        sky_tap((2, 4), torch.empty(8, dtype=torch.int32, device="meta"),
                meta, meta, meta, (rng.key(0), rng.key(1)))
    with pytest.raises(TypeError):
        bad = scene.to("cpu")
        bad.spheres.radius = bad.spheres.radius.double()
        KernelScene.create(bad, accel)
    assert np.isfinite(ks.ground_enabled)


def test_planes_and_state_entry_points_route_by_device():
    # The byte-plane lookup and the path kernel's state output take their
    # plain versions for CPU tensors and raise for a device without a kernel.
    scene = fixtures.scene1()
    ks = KernelScene.create(scene, build_cluster_accel(scene.triangles, 64))
    H, W = ks.scene.skybox.shape[:2]
    before = dict(_build.LAUNCHES)
    planes = byte_planes(ks.scene.skybox_rgbe, H, W)
    assert planes.dtype == torch.uint8 and tuple(planes.shape) == (H, 4 * W)
    ro = tuple(torch.zeros(4) + c for c in (0.0, 1.0, -10.0))
    rd = tuple(torch.zeros(4) + c for c in (0.0, -1.0, 0.0))   # ground
    keys = (rng.key(1), rng.key(2))
    rad = sky_tap((H, W), ks.scene.skybox_rgbe,
                  tuple(torch.zeros(4) for _ in range(3)), rd, rd, keys,
                  impl="bf16")
    assert all(c.shape == (4,) for c in rad)
    out = path_trace(ks, ro, rd, torch.full((2, 5, 4), 0.5),
                     RenderConfig(bounces=2), emit_state=True)
    assert len(out) == 4 and tuple(out[3].shape) == (16, 4)
    assert _build.LAUNCHES == before
    meta = tuple(torch.empty(4, device="meta") for _ in range(3))
    with pytest.raises(ValueError):
        sky_tap((H, W), torch.empty(H * W, dtype=torch.int32, device="meta"),
                meta, meta, meta, keys, impl="bf16")
