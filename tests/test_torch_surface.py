"""The port's public surface against the JAX package's, module by module.

For every public module of ``unityraytracer_tpu``, each public function and
class it defines must have a counterpart of the same name in the matching
module of ``unityraytracer_tpu_torch``, and each public method of such a
class a method of the same name on the port's class. Where both sides have a
signature, the JAX parameter names must be a prefix of the port's: a call
written for the JAX package binds the same arguments in the port (the port
may add parameters after them, such as ``device=``).

``NO_PORT_MODULE`` and ``OTHER_SIGNATURE`` list the documented differences,
and only those.
"""

import importlib
import inspect
import pkgutil

import pytest

import unityraytracer_tpu
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Modules the port does not copy: TPU machinery (ROADMAP.md, "What the port
# does not copy"). The Pallas kernels' work lives in ops/cuda_{path,trace,
# env}.py and csrc/; the XLA compile cache has no counterpart under eager
# torch.
NO_PORT_MODULE = {
    "unityraytracer_tpu.ops.pallas_path",
    "unityraytracer_tpu.ops.pallas_trace",
    "unityraytracer_tpu.ops.pallas_env",
    "unityraytracer_tpu.utils.compcache",
}
# Names whose signatures differ by design (ROADMAP.md, "Not faults"): the
# JAX versions run inside shard_map over a mesh axis (``axis``, ``n_dev``);
# the port's take the shards' list and the shading device.
OTHER_SIGNATURE = {
    ("unityraytracer_tpu.parallel.scene_shard", "allreduce_hit"),
    ("unityraytracer_tpu.parallel.scene_shard", "make_scene_sharded_tracer"),
}

MODULES = ["unityraytracer_tpu"] + sorted(
    m.name for m in pkgutil.walk_packages(unityraytracer_tpu.__path__,
                                          "unityraytracer_tpu."))


def _params(fn):
    try:
        return [p.name for p in inspect.signature(fn).parameters.values()]
    except (TypeError, ValueError):
        return None


def _methods(cls):
    """Public methods of ``cls``: functions, static and class methods."""
    out = {}
    for name in dir(cls):
        if name.startswith("_"):
            continue
        raw = inspect.getattr_static(cls, name)
        if isinstance(raw, (staticmethod, classmethod)) \
                or inspect.isfunction(raw):
            out[name] = getattr(cls, name)
    return out


def _prefix_fault(where, jax_fn, port_fn):
    want, got = _params(jax_fn), _params(port_fn)
    if want is not None and (got is None or got[:len(want)] != want):
        return f"{where}: JAX parameters {want}, port {got}"
    return None


def surface_faults(name):
    """Faults of the port's counterpart of JAX module ``name``."""
    jm = importlib.import_module(name)
    pm = importlib.import_module(
        name.replace("unityraytracer_tpu", "unityraytracer_tpu_torch", 1))
    faults = []
    for attr, obj in sorted(vars(jm).items()):
        if attr.startswith("_") or getattr(obj, "__module__", None) != name \
                or not (inspect.isfunction(obj) or inspect.isclass(obj)) \
                or (name, attr) in OTHER_SIGNATURE:
            continue
        if not hasattr(pm, attr):
            faults.append(f"{name}.{attr}: missing in the port")
            continue
        port = getattr(pm, attr)
        if inspect.isfunction(obj):
            faults.append(_prefix_fault(f"{name}.{attr}", obj, port))
            continue
        port_methods = _methods(port)
        for mname, meth in _methods(obj).items():
            where = f"{name}.{attr}.{mname}"
            if mname not in port_methods:
                faults.append(f"{where}: missing in the port")
            else:
                faults.append(_prefix_fault(where, meth, port_methods[mname]))
    return [f for f in faults if f]


@pytest.mark.parametrize("name", MODULES)
def test_port_has_the_jax_surface(name):
    if name in NO_PORT_MODULE:
        with pytest.raises(ImportError):
            importlib.import_module(name.replace(
                "unityraytracer_tpu", "unityraytracer_tpu_torch", 1))
        return
    assert surface_faults(name) == []


def test_allowed_differences_are_real():
    """Each allowed difference is still one, so the allow-list names
    nothing that has become equal or gone."""
    for name, attr in sorted(OTHER_SIGNATURE):
        jm = importlib.import_module(name)
        pm = importlib.import_module(
            name.replace("unityraytracer_tpu", "unityraytracer_tpu_torch", 1))
        assert _prefix_fault(attr, getattr(jm, attr), getattr(pm, attr))
    assert NO_PORT_MODULE <= set(MODULES)
