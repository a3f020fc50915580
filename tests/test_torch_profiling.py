"""The port's profile parser and ``Renderer.profile``, on the CPU.

``parse_device_trace`` gives the JAX parser's ``DeviceProfile`` field for
field on the synthetic traces of tests/test_profiling.py (with the JAX
package's stage table, whose names those traces use), and reads a
torch.profiler-shaped trace by its events' ``cat``. ``Renderer.profile``
stores its profile, runs one warm-up frame plus ``n_frames``, and renders
the profiled frames in bands when the config sets ``dispatch_bands``."""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from unityraytracer_tpu.utils import profiling as jprof
from unityraytracer_tpu_torch import RenderConfig, Renderer
from unityraytracer_tpu_torch.models import fixtures
from unityraytracer_tpu_torch.utils.profiling import (DEFAULT_STAGES,
                                                      DeviceProfile,
                                                      parse_device_trace,
                                                      profile_stages)

JAX_TRACES = {
    "flat": [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "python host"}},
        {"ph": "M", "pid": 3, "name": "process_name",
         "args": {"name": "/device:TPU:0"}},
        {"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 99000,
         "name": "python_dispatch"},
        {"ph": "X", "pid": 3, "tid": 1, "ts": 100, "dur": 2000,
         "name": "_trace_kernel"},
        {"ph": "X", "pid": 3, "tid": 1, "ts": 3000, "dur": 5000,
         "name": "_trace_kernel"},
        {"ph": "X", "pid": 3, "tid": 1, "ts": 9000, "dur": 7000,
         "name": "_trace_kernel"},
        {"ph": "X", "pid": 3, "tid": 1, "ts": 17000, "dur": 1500,
         "name": "loop_fusion.42"},
        {"ph": "X", "pid": 3, "tid": 1, "ts": 19000, "dur": 500,
         "name": "custom-call.7"},
    ],
    "nested": [
        {"ph": "M", "pid": 3, "name": "process_name",
         "args": {"name": "/device:TPU:0"}},
        {"ph": "X", "pid": 3, "tid": 1, "ts": 0, "dur": 10000,
         "name": "jit_step"},
        {"ph": "X", "pid": 3, "tid": 1, "ts": 1000, "dur": 6000,
         "name": "_trace_kernel"},
        {"ph": "X", "pid": 3, "tid": 1, "ts": 8000, "dur": 1000,
         "name": "loop_fusion.1"},
    ],
    "no_process_names": [
        {"ph": "X", "pid": 3, "tid": 1, "ts": 0, "dur": 4000, "name": "k"},
    ],
}

# What torch.profiler's export_chrome_trace writes for a CUDA window: host
# ops and runtime calls on the process's pid, kernels, copies and memsets
# on the card's rows, told apart by their "cat".
TORCH_TRACE = [
    {"ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 4242, "ts": 0,
     "dur": 50000, "name": "aten::mul"},
    {"ph": "X", "cat": "cuda_runtime", "pid": 4242, "tid": 4242, "ts": 10,
     "dur": 20, "name": "cudaLaunchKernel"},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 100, "dur": 2300,
     "name": "urt_path_trace_kernel(SceneArgs, float const*)"},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 2500, "dur": 45,
     "name": "void urt_sky_tap_kernel<true>(float*)"},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 2600, "dur": 600,
     "name": "urt_bounce_rows_kernel(BounceArgs, float*)"},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 3300, "dur": 20,
     "name": "urt_uniform_kernel(unsigned int, unsigned int, float*, long)"},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 3400, "dur": 90,
     "name": "void urt_atrous_kernel<2>(float const*, float*)"},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 3500, "dur": 700,
     "name": "urt_trace_hits_kernel(SceneArgs)"},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 4300, "dur": 10,
     "name": "void at::native::vectorized_elementwise_kernel<4, "
             "at::native::AUnaryFunctor<float, float, float, "
             "at::native::binary_internal::MulFunctor<float> > >(int)"},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 4400, "dur": 30,
     "name": "void at::native::reduce_kernel<512, 1>(float)"},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 4500, "dur": 40,
     "name": "void at::native::index_elementwise_kernel<128, 4>(long)"},
    {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 8, "ts": 4600,
     "dur": 5, "name": "Memcpy DtoH (Device -> Pinned)"},
    {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 8, "ts": 4700,
     "dur": 1, "name": "Memset (Device)"},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 4800, "dur": 4,
     "name": "void at::native::(anonymous namespace)::CatArrayBatchedCopy"},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 4900, "dur": 2,
     "name": "some_other_kernel"},
]


def _write_trace(tmp_path, events, name="host.trace.json.gz"):
    path = os.path.join(str(tmp_path), name)
    opener = gzip.open if name.endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return path


@pytest.mark.parametrize("case", list(JAX_TRACES))
def test_parser_matches_jax_field_for_field(tmp_path, case):
    _write_trace(tmp_path, JAX_TRACES[case])
    want = jprof.parse_device_trace(str(tmp_path))
    got = parse_device_trace(str(tmp_path), stages=jprof.DEFAULT_STAGES)
    assert isinstance(got, DeviceProfile)
    assert got.total_ms == want.total_ms
    assert got.stages_ms == want.stages_ms
    assert got.per_occurrence_ms == want.per_occurrence_ms
    assert got.top_ops == [tuple(t) for t in want.top_ops]
    assert got.report() == want.report()


def test_parser_reads_a_torch_trace_by_category(tmp_path):
    path = _write_trace(tmp_path, TORCH_TRACE, "torch.trace.json")
    prof = parse_device_trace(path)
    np.testing.assert_allclose(prof.total_ms, 3.847)   # no host event
    want = {"path": 2.3, "env": 0.045, "rng": 0.62, "denoise": 0.09,
            "trace_kernel": 0.7, "elementwise": 0.01, "reduce": 0.03,
            "index": 0.04, "copy": 0.01, "other": 0.002}
    assert set(prof.stages_ms) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(prof.stages_ms[k], v, rtol=1e-12)
    np.testing.assert_allclose(prof.per_occurrence_ms["rng"], [0.6, 0.02])
    assert prof.top_ops[0][0].startswith("urt_path_trace_kernel")
    # The directory form finds the uncompressed export too.
    assert parse_device_trace(str(tmp_path)).total_ms == prof.total_ms
    assert [s for s, _ in DEFAULT_STAGES][:5] == [
        "path", "trace_kernel", "env", "rng", "denoise"]


def _renderer(**kw):
    cfg = RenderConfig(width=16, height=16, spp=1, bounces=2,
                       tracer="pallas", **kw)
    return Renderer(fixtures.scene1(), fixtures.scene1_camera(1.0), cfg,
                    seed=0, device="cpu")


def test_renderer_profile_stores_its_profile():
    r = _renderer()
    prof = r.profile(2)
    assert r.stats["device"] is prof
    assert prof.total_ms > 0.0 and "other" in prof.stages_ms
    assert r.sample_count == 3          # warm-up + 2 profiled frames
    assert np.isfinite(r.image).all()


def test_profile_frames_follow_the_step_chain():
    # The warm-up and profiled frames are the frames step(1) and
    # step(n, fused=False) render from the same key: whole, or in bands
    # when the config sets dispatch_bands.
    for kw in ({}, {"dispatch_bands": 2}):
        a = _renderer(**kw)
        a.profile(2)
        b = _renderer(**kw).step(1).step(2, fused=False)
        assert torch.equal(a.state.accum, b.state.accum)
        np.testing.assert_array_equal(a._key, b._key)
    whole = _renderer()
    whole.profile(2)
    assert not torch.equal(whole.state.accum, a.state.accum)


def test_profile_stages_on_the_cpu(tmp_path):
    x = torch.ones((128, 128))
    prof = profile_stages(lambda: torch.tanh(x @ x).sum(), device="cpu",
                          logdir=str(tmp_path))
    assert prof.total_ms >= 0.0
    assert list(tmp_path.glob("*.trace.json"))       # logdir kept
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profile_stages(lambda: None)
