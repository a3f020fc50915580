"""The multi-card path that a machine without a card can check.

* Every kernel launch of the package runs on its tensors' card: each
  ``_build.lib().urt_*`` call sits inside ``with _build.on_card(t.device)``
  for a tensor ``t`` whose pointer the call passes, and the stream, the
  overflow flag and the launch count of that call name the same device
  (read from the source with ``ast``).
* ``shard_scaling.run``, the multi-card script, on CPU meshes of two and
  four shards at a small size (32x16, 2 bounces, 1,280 and 2,560
  triangles, both ``rng_impl``\\ s): every phase and every check of the
  script's own logic, the command-line children included.
* A checkpoint of a four-shard ``scene`` mesh resumed by one ``Renderer``,
  bit for bit.

The same paths on real cards: ``tests/test_torch_cuda.py -k multicard`` and
``python3 shard_scaling.py`` on a machine with two or more cards."""

import ast
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from unityraytracer_tpu_torch import RenderConfig, Renderer, _build
from unityraytracer_tpu_torch.models import fixtures
from unityraytracer_tpu_torch.parallel.sharding import ShardedRenderer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "unityraytracer_tpu_torch"
sys.path.insert(0, str(ROOT))
import shard_scaling  # noqa: E402

# The C entry points the package launches, one wrapper each.
ENTRY_POINTS = {"urt_path_trace", "urt_trace_hits", "urt_sky_tap",
                "urt_camera_rays", "urt_bounce_rows", "urt_uniform",
                "urt_atrous"}
SMALL = dict(shard_scaling.CELL, width=32, height=16, bounces=2)


def _is_build_call(node, name):
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == name
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "_build")


def _launches(tree):
    """(call, its enclosing with-statements, its function) of every
    ``_build.lib().urt_*`` call."""
    out = []

    def walk(node, withs, fn):
        if isinstance(node, ast.FunctionDef):
            fn = node
        if isinstance(node, ast.With):
            withs = withs + [node]
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr.startswith("urt_")
                and _is_build_call(node.func.value, "lib")):
            out.append((node, withs, fn))
        for child in ast.iter_child_nodes(node):
            walk(child, withs, fn)

    walk(tree, [], None)
    return out


def test_every_launch_runs_under_its_tensors_card():
    found = set()
    for path in sorted(PACKAGE.rglob("*.py")):
        tree = ast.parse(path.read_text())
        where = path.relative_to(ROOT)
        # _build.lib() only ever as the receiver of an entry point: no alias
        # of the library can launch outside the guard.
        receivers = {id(c.func.value) for c, _, _ in _launches(tree)}
        for node in ast.walk(tree):
            if _is_build_call(node, "lib") and path.name != "_build.py":
                assert id(node) in receivers, f"{where}:{node.lineno}"
        for call, withs, fn in _launches(tree):
            name = call.func.attr
            found.add(name)
            guards = [item.context_expr for w in withs for item in w.items
                      if _is_build_call(item.context_expr, "on_card")]
            assert len(guards) == 1, f"{where}:{call.lineno} {name} unguarded"
            dev = guards[0].args[0]
            # The guard's device is a tensor's, and the call passes that
            # tensor's pointer.
            assert isinstance(dev, ast.Attribute) and dev.attr == "device" \
                and isinstance(dev.value, ast.Name), f"{where}:{call.lineno}"
            ptrs = {n.func.value.id for n in ast.walk(call)
                    if isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "data_ptr"
                    and isinstance(n.func.value, ast.Name)}
            assert dev.value.id in ptrs, f"{where}:{call.lineno} {name}"
            # Stream and overflow flag of the same card.
            streams = [n for n in ast.walk(call)
                       if _is_build_call(n, "stream_ptr")]
            assert len(streams) == 1, f"{where}:{call.lineno} {name}"
            for n in ast.walk(call):
                if _is_build_call(n, "stream_ptr") or _is_build_call(
                        n, "error_flag"):
                    assert ast.dump(n.args[0]) == ast.dump(dev), \
                        f"{where}:{n.lineno} {name}"
            # The wrapper counts the launch on that card, once.
            counts = [n for n in ast.walk(fn) if _is_build_call(n, "count")]
            assert len(counts) == 1 and ast.dump(counts[0].args[1]) == \
                ast.dump(dev), f"{where}:{call.lineno} {name}"
    assert found == ENTRY_POINTS


def test_launches_are_counted_by_card():
    before = dict(_build.LAUNCHES)
    cards = dict(_build.CARD_LAUNCHES)
    try:
        _build.CARD_LAUNCHES.clear()
        _build.count("path", torch.device("cuda", 2))
        _build.count("trace", torch.device("cuda", 2))
        _build.count("path", torch.device("cuda", 0))
        assert _build.LAUNCHES["path"] == before["path"] + 2
        assert _build.LAUNCHES["trace"] == before["trace"] + 1
        assert {k: {n: c for n, c in v.items() if c}
                for k, v in _build.CARD_LAUNCHES.items()} == {
            2: {"path": 1, "trace": 1}, 0: {"path": 1}}
    finally:
        _build.LAUNCHES.update(before)
        _build.CARD_LAUNCHES.clear()
        _build.CARD_LAUNCHES.update(cards)


@pytest.mark.parametrize("n", [2, 4])
def test_shard_scaling_runs_on_cpu_meshes(n, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    seen = {}
    out = shard_scaling.run(
        ["cpu"] * n, n_tris=600, big_tris=2_000, cell=SMALL,
        gate=dict(shard_scaling.GATE, width=32, height=16), frames=2,
        log=lambda key, value: seen.setdefault(key, value))
    impls = shard_scaling.IMPLS
    want = ({f"one_card_{i}" for i in impls} | {"one_card_preview"}
            | {f"{m}_{i}" for m in shard_scaling.MODES for i in impls}
            | {"combine", "checkpoint", "cli", "gate2m_part",
               "big_scene_1080p", "seconds"})
    assert set(seen) == want and set(out) == want | {"cards"}
    for m in shard_scaling.MODES:
        rec = seen[f"{m}_rbg"]
        assert rec["bit_equal"] and len(rec["ms"]["cards"]["ms"]) == 2
        assert rec["launches"] == {"cards": {}, "logical": {}}
    assert seen["scene_rbg"]["vs_one_card"]["bit_equal"]
    assert seen["checkpoint"] == dict(scene_to_renderer=True,
                                      rows_to_logical=True, samples=3)
    assert seen["cli"]["device_last"]["child_rc"] == 0
    assert seen["cli"]["shard_scene"]["mesh"] == ["cpu"]
    assert seen["cli"]["info"]["child_rc"] == 0
    assert seen["gate2m_part"]["bit_exact"]
    assert seen["gate2m_part"]["images"] == (
        ["logical_2", "cards_2", "logical_4"]
        + (["cards_4"] if n >= 4 else []))
    assert seen["big_scene_1080p"]["bit_equal"]


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_four_shard_checkpoint_resumes_on_one_renderer(impl, tmp_path):
    scene = fixtures.bench_scene(n_tris=2_000)
    cam = fixtures.bench_camera(aspect=SMALL["width"] / SMALL["height"])
    cfg = RenderConfig(**SMALL, tracer="cluster", rng_impl=impl)
    sr = ShardedRenderer(scene, cam, cfg, mesh=["cpu"] * 4, seed=5,
                         mode="scene").step(2)
    path = sr.save_state(os.path.join(tmp_path, "four"))
    one = Renderer(scene, cam, cfg, seed=11, device="cpu").load_state(path)
    assert np.array_equal(one.image, sr.image) and one.sample_count == 2
    sr.step(1)
    one.step(1)
    assert one.sample_count == sr.sample_count == 3
    assert np.array_equal(one.image, sr.image)
    assert np.isfinite(one.image).all() and one.image.max() > 0
