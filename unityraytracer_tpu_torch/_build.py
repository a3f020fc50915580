"""Build, load and bind the CUDA kernels of ``csrc/``.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` to an object, all of
them at once in parallel, and links the objects into one shared library
with a plain C interface, which ``ctypes`` loads. The library goes to
``build/`` beside this file, named by a hash of the sources and flags: it is
built at first use and rebuilt when a source changes. ``-fmad=false`` keeps
nvcc from contracting multiply-adds, so the kernels round as their plain
torch versions do and the kernel-vs-plain checks stay tight.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on a non-zero code. CUDA launches a
kernel only into a stream of the current card, so each wrapper makes the
card of its launch's tensors current around the call (``on_card``) and
hands it that card's current stream (``stream_ptr``). ``count`` counts a
launch by name in ``LAUNCHES`` and by card in ``CARD_LAUNCHES``; each
wrapper calls it where it launches.

A traversal-stack overflow sets the device's ``error_flag`` (the kernels
``atomicOr`` it) instead of dropping nodes silently. Reading the flag waits
for the device, so the wrappers leave it there and ``raise_on_overflow``
reads it: ``Renderer.step`` once per call, after its synchronize.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

# "env" and "env_planes" count the sky-tap kernel by its fetch: the packed
# words or the byte planes. The draw kernels' rbg modes are kernels of their
# own, counted under the same names with "_rbg" appended.
LAUNCHES = {"path": 0, "trace": 0, "env": 0, "env_planes": 0, "uniform": 0,
            "bounce_rows": 0, "camera": 0, "atrous": 0, "env_rbg": 0,
            "env_planes_rbg": 0, "uniform_rbg": 0, "bounce_rows_rbg": 0,
            "camera_rbg": 0}
# CARD_LAUNCHES[card index][name]: the launches of ``LAUNCHES`` by card.
CARD_LAUNCHES = {}
# Bounces whose keys the uniform-row kernel's prologue holds
# (URT_MAX_BOUNCES in uniform_kernel.cu).
MAX_BOUNCES = 32

_LIB = None
BUILD_LOG = ""


class SceneArgs(ctypes.Structure):
    """Mirror of ``struct SceneArgs`` in csrc/closest_hit.cuh."""

    _fields_ = [
        ("sph_center", ctypes.c_void_p), ("sph_radius", ctypes.c_void_p),
        ("sph_mat", ctypes.c_void_p), ("n_spheres", ctypes.c_int),
        ("mat_albedo", ctypes.c_void_p), ("mat_specular", ctypes.c_void_p),
        ("mat_emission", ctypes.c_void_p), ("mat_smooth", ctypes.c_void_p),
        ("ground_enabled", ctypes.c_float), ("ground_mat", ctypes.c_int),
        ("root_box", ctypes.c_void_p), ("nodes", ctypes.c_void_p),
        ("leaf_boxes", ctypes.c_void_p),
        ("n_clusters", ctypes.c_int), ("cluster_size", ctypes.c_int),
        ("tris", ctypes.c_void_p), ("tri_n0", ctypes.c_void_p),
        ("tri_n1", ctypes.c_void_p), ("tri_n2", ctypes.c_void_p),
        ("tri_mat", ctypes.c_void_p),
        ("bin_cx", ctypes.c_float), ("bin_cy", ctypes.c_float),
        ("bin_cz", ctypes.c_float),
    ]


class BounceArgs(ctypes.Structure):
    """Mirror of ``struct BounceArgs`` in csrc/uniform_kernel.cu: the bounce
    key k_bounce (the kernel derives the per-bounce keys from it; words 2
    and 3 and ``rbg`` for an rbg key) and the ray lattice of one frame's
    uniform rows, handed to the kernel by value."""

    _fields_ = [
        ("k0", ctypes.c_uint32), ("k1", ctypes.c_uint32),
        ("k2", ctypes.c_uint32), ("k3", ctypes.c_uint32),
        ("n", ctypes.c_int), ("nb", ctypes.c_int), ("h", ctypes.c_int),
        ("W", ctypes.c_int), ("row0", ctypes.c_int), ("Hg", ctypes.c_int),
        ("Wg", ctypes.c_int), ("blocked", ctypes.c_int),
        ("rr_step", ctypes.c_int), ("rr_lo", ctypes.c_int),
        ("rr_hi", ctypes.c_int), ("rbg", ctypes.c_int),
    ]


class CameraArgs(ctypes.Structure):
    """Mirror of ``struct CameraArgs`` in csrc/camera_kernel.cu: the frame
    key (words 2 and 3 and ``rbg`` for an rbg key), the ray lattice and the
    camera of one launch of the camera-ray kernel, handed to the kernel by
    value."""

    _fields_ = [
        ("k0", ctypes.c_uint32), ("k1", ctypes.c_uint32),
        ("k2", ctypes.c_uint32), ("k3", ctypes.c_uint32),
        ("n", ctypes.c_int), ("h", ctypes.c_int), ("W", ctypes.c_int),
        ("H", ctypes.c_int), ("row0", ctypes.c_int), ("blocked", ctypes.c_int),
        ("pixel_order", ctypes.c_int), ("m", ctypes.c_float * 12),
        ("thf", ctypes.c_float), ("thf_aspect", ctypes.c_float),
        ("focus", ctypes.c_float), ("aperture", ctypes.c_float),
        ("rbg", ctypes.c_int),
    ]


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sum(_sources(), []):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"liburt_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return nvcc


def _run_all(cmds):
    """Run the commands at once; return their (code, stderr) in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True, cwd=CSRC)
             for c in cmds]
    errs = [p.communicate()[1] for p in procs]
    return [(p.returncode, e) for p, e in zip(procs, errs)]


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one nvcc per source, all started together, then one link. The ptxas
    report (registers, stack, spills) lands in ``BUILD_LOG``."""
    global BUILD_LOG
    path = library_path()
    if path.exists():
        return path
    nvcc = _nvcc()
    tmp_dir = BUILD_DIR / f"{path.stem}.{os.getpid()}.tmp"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    try:
        cus, _ = _sources()
        objs = [tmp_dir / f"{cu.stem}.o" for cu in cus]
        results = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-c", "-o",
                             str(o), str(cu)] for cu, o in zip(cus, objs)])
        for cu, (code, err) in zip(cus, results):
            if code != 0:
                raise RuntimeError(
                    f"nvcc failed on {cu.name} ({code}):\n{err}")
        tmp = tmp_dir / path.name
        (code, err), = _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o",
                                  str(tmp), *map(str, objs)]])
        if code != 0:
            raise RuntimeError(f"nvcc link failed ({code}):\n{err}")
        BUILD_LOG = "".join(err for _, err in results)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        so = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        u32 = ctypes.c_uint32
        so.urt_trace_hits.argtypes = [p] * 8 + [i, i, i, p, p]
        so.urt_path_trace.argtypes = [p] * 9 + [i] * 8 + [p, p]
        so.urt_sky_tap.argtypes = [p] * 10 + [i, p, i, i] + [u32] * 8 + [
            i, p, i, i, i, p]
        so.urt_uniform.argtypes = [u32] * 4 + [i, p, ctypes.c_longlong, p]
        so.urt_bounce_rows.argtypes = [p, p, p]
        so.urt_camera_rays.argtypes = [p, p, p]
        f32 = ctypes.c_float
        so.urt_atrous.argtypes = [p, p, p, p, i, i, i, f32, f32, f32, p]
        for fn in (so.urt_trace_hits, so.urt_path_trace, so.urt_sky_tap,
                   so.urt_uniform, so.urt_bounce_rows, so.urt_camera_rays,
                   so.urt_atrous):
            fn.restype = ctypes.c_int
        _LIB = so
    return _LIB


def on_card(device):
    """Context in which ``device``'s card is the current CUDA device. Each
    wrapper enters it around its launch with the device of the launch's
    tensors: CUDA refuses a launch into a stream of another card than the
    current one. A null context when that card is already current (every
    launch of a one-card frame), ``torch.cuda.device`` otherwise."""
    import torch

    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")


def count(name: str, device) -> None:
    """Count one launch of kernel ``name`` on ``device`` (a tensor's device,
    which names its card)."""
    LAUNCHES[name] += 1
    card = CARD_LAUNCHES.get(device.index)
    if card is None:
        card = CARD_LAUNCHES[device.index] = dict.fromkeys(LAUNCHES, 0)
    card[name] += 1


_ERR_FLAGS = {}


def _cuda_device(device):
    import torch

    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def error_flag(device):
    """The device's (1,) int32 traversal-overflow flag, set by the kernels
    and cleared only by ``raise_on_overflow``."""
    import torch

    d = _cuda_device(device)
    if d not in _ERR_FLAGS:
        _ERR_FLAGS[d] = torch.zeros((1,), dtype=torch.int32, device=d)
    return _ERR_FLAGS[d]


def raise_on_overflow(device) -> None:
    """Raise if a kernel on ``device`` overflowed its traversal stack since
    the last check (waits for the device)."""
    flag = _ERR_FLAGS.get(_cuda_device(device))
    if flag is not None and int(flag.item()):
        flag.zero_()
        raise RuntimeError("BVH traversal stack overflow: a kernel dropped "
                           "nodes, so its hits are not the closest")
