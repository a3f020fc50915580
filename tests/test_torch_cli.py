"""The port's command line, ``python -m unityraytracer_tpu_torch
render|preview|info``, driven on the CPU (``--device cpu``) at a small size.

A render's PNG equals, byte for byte, the tonemapped image of a ``Renderer``
built by hand with the same scene, camera, config and seed (with
``--shard``, a ``ShardedRenderer`` over ``[cpu]``); the printed lines have
the JAX command line's format; what the port refuses raises. One
case runs both command lines on the same arguments (``--tracer brute``) and
holds the two PNGs within one 8-bit step on at least 99.9% of the pixels
(the two packages' images differ by an RMSE of ~5e-6 before quantisation).
"""

import os
import re
import subprocess
import sys
import urllib.request
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from unityraytracer_tpu_torch import (Camera, Material, RenderConfig,
                                      Renderer, SceneBuilder)
from unityraytracer_tpu_torch.__main__ import main
from unityraytracer_tpu_torch.models import fixtures, skybox
from unityraytracer_tpu_torch.models.obj import save_obj
from unityraytracer_tpu_torch.models import primitives as P
from unityraytracer_tpu_torch.utils.image import tonemap_aces, write_png
from unityraytracer_tpu_torch.utils.math3d import trs_matrix
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


ROOT = Path(__file__).resolve().parents[1]
W, H = 64, 48
SIZE = ["--width", str(W), "--height", str(H)]
SUMMARY = re.compile(r"^wrote (\S+): (\d+) samples, \d+\.\d ms/frame, "
                     r"\d+\.\d Mrays/s$")


def _png_pixels(path) -> np.ndarray:
    """Decode one of ``write_png``'s files (8-bit RGB, filter 0) back to
    (H, W, 3) uint8."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            size = (int.from_bytes(body[4:8], "big"),
                    int.from_bytes(body[:4], "big"))
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8) \
        .reshape(size[0], 1 + size[1] * 3)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(size[0], size[1], 3)


def _by_hand(scene, cam, tmp_path, frames=2, bounces=2, seed=0, spp=1,
             tracer="pallas", bands=None):
    """The PNG a hand-built renderer gives for the CLI's config."""
    cfg = RenderConfig(width=W, height=H, spp=spp, bounces=bounces,
                       tracer=tracer, wavefront=True, dispatch_bands=bands)
    r = Renderer(scene, cam, cfg, seed=seed, device="cpu").step(frames)
    path = write_png(str(tmp_path / "by_hand.png"), tonemap_aces(r.image))
    return open(path, "rb").read(), r


def _render(tmp_path, capsys, *extra, frames=2, bounces=2):
    out = str(tmp_path / "cli.png")
    rc = main(["render", *SIZE, "--frames", str(frames), "--bounces",
               str(bounces), "--device", "cpu", "-o", out, *extra])
    assert rc == 0
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    m = SUMMARY.match(lines[0])
    assert m and m.group(1) == out and int(m.group(2)) == frames, lines
    return open(out, "rb").read(), lines, cap.err


FIXTURES = {
    "scene1": (lambda: fixtures.scene1(),
               lambda a: fixtures.scene1_camera(a), []),
    "sample": (lambda: fixtures.sample_scene(),
               lambda a: fixtures.sample_scene_camera(a), []),
    "bench": (lambda: fixtures.bench_scene(n_tris=2000),
              lambda a: fixtures.bench_camera(a), ["--tris", "2000"]),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_render_fixture_equals_hand_built_renderer(tmp_path, capsys, name):
    scene, cam, extra = FIXTURES[name]
    png, lines, _ = _render(tmp_path, capsys, "--scene", name, *extra)
    want, _ = _by_hand(scene(), cam(W / H), tmp_path)
    assert png == want and len(lines) == 1


def test_render_seed_spp_bands_and_no_tonemap(tmp_path, capsys):
    png, _, _ = _render(tmp_path, capsys, "--seed", "7", "--spp", "2",
                        "--bands", "2", frames=1)
    want, r = _by_hand(fixtures.scene1(), fixtures.scene1_camera(W / H),
                       tmp_path, frames=1, seed=7, spp=2, bands=2)
    assert png == want
    raw, _, _ = _render(tmp_path, capsys, "--seed", "7", "--spp", "2",
                        "--bands", "2", "--no-tonemap", frames=1)
    write_png(str(tmp_path / "raw.png"), r.image)
    assert raw == open(tmp_path / "raw.png", "rb").read() and raw != png


def _obj_with_mtl(tmp_path, with_mtl=True):
    v, f, n = P.icosphere(1)
    path = save_obj(str(tmp_path / "ico.obj"), v * 2.0 + (5, 0, 1), f, n)
    if with_mtl:
        (tmp_path / "ico.mtl").write_text(
            "newmtl warm\nKd 0.8 0.3 0.2\nKs 0.1 0.1 0.1\nNs 100\n"
            "newmtl glow\nKd 0.1 0.1 0.1\nKe 3 3 2\n")
        lines = open(path).read().splitlines()
        faces = [l for l in lines if l.startswith("f ")]
        rest = [l for l in lines if not l.startswith("f ")]
        half = len(faces) // 2
        open(path, "w").write("\n".join(
            ["mtllib ico.mtl"] + rest + ["usemtl warm"] + faces[:half]
            + ["usemtl glow"] + faces[half:]) + "\n")
    return path, v * 2.0 + (5, 0, 1), f, n


@pytest.mark.parametrize("with_mtl", [True, False])
def test_render_obj_equals_hand_built_renderer(tmp_path, capsys, with_mtl):
    path, v, f, n = _obj_with_mtl(tmp_path, with_mtl)
    png, _, _ = _render(tmp_path, capsys, "--obj", path)
    from unityraytracer_tpu_torch.models.obj import load_obj
    v = load_obj(path)[0]                      # as the file rounds them
    size = float((v.max(axis=0) - v.min(axis=0)).max())
    offset = -v.mean(axis=0) + (0, size / 2, 0)
    b = SceneBuilder()
    if with_mtl:
        b.add_obj(path, transform=trs_matrix(tuple(offset), (0, 0, 0)))
    else:
        b.add_mesh(v + offset, f, normals=load_obj(path)[2],
                   material=Material(albedo=(0.75, 0.71, 0.65),
                                     specular=(0.05,) * 3, smoothness=0.4))
    b.set_skybox(skybox.sun_sky())
    scene = b.build()
    assert scene.num_triangles == 80
    cam = Camera.create(position=(0, size * 0.8, -size * 2.2),
                        look_at=(0, size / 2, 0), fov_y_deg=45, aspect=W / H)
    want, _ = _by_hand(scene, cam, tmp_path)
    assert png == want


@pytest.mark.parametrize("kind", ["hdr", "exr_piz", "exr_rgba_zip"])
def test_render_env_map_from_disk(tmp_path, capsys, kind):
    from unityraytracer_tpu_torch.models.exr import write_exr

    sky = skybox.sun_sky(16, 32)
    if kind == "hdr":
        path = skybox.save_hdr(str(tmp_path / "sky.hdr"), sky)
        loaded = skybox.load_hdr(path)
    else:
        img = sky if kind == "exr_piz" else np.concatenate(
            [sky, np.ones_like(sky[..., :1])], axis=-1)   # alpha is dropped
        path = write_exr(str(tmp_path / "sky.exr"), img, dtype="float",
                         compression=kind.split("_")[-1])
        loaded = sky
    png, _, _ = _render(tmp_path, capsys, "--scene", "sample", "--env", path)
    want, r = _by_hand(fixtures.sample_scene(skybox=loaded),
                       fixtures.sample_scene_camera(W / H), tmp_path)
    assert png == want
    assert tuple(r.scene.skybox.shape) == (16, 32, 3)


UNITY_SCENE = """%YAML 1.1
%TAG !u! tag:unity3d.com,2011:
--- !u!1 &100
GameObject:
  m_Name: Ball
  m_IsActive: 1
--- !u!4 &101
Transform:
  m_GameObject: {fileID: 100}
  m_LocalRotation: {x: 0, y: 0, z: 0, w: 1}
  m_LocalPosition: {x: -1.5, y: 1, z: 0}
  m_LocalScale: {x: 2, y: 2, z: 2}
  m_Father: {fileID: 0}
--- !u!114 &102
MonoBehaviour:
  m_GameObject: {fileID: 100}
  m_Enabled: 1
  m_Script: {fileID: 11500000, guid: 7fba285130b2c3342be00e9cfa2e3c7c,
    type: 3}
  albedoColor: {r: 0.9, g: 0.2, b: 0.2, a: 1}
  smoothness: 0.4
--- !u!135 &103
SphereCollider:
  m_GameObject: {fileID: 100}
  m_Enabled: 1
  m_Radius: 0.5
  m_Center: {x: 0, y: 0, z: 0}
--- !u!1 &120
GameObject:
  m_Name: Box
  m_IsActive: 1
--- !u!4 &121
Transform:
  m_GameObject: {fileID: 120}
  m_LocalRotation: {x: 0, y: 0.38268343, z: 0, w: 0.92387953}
  m_LocalPosition: {x: 1.5, y: 0.75, z: 0.5}
  m_LocalScale: {x: 1.5, y: 1.5, z: 1.5}
  m_Father: {fileID: 0}
--- !u!114 &122
MonoBehaviour:
  m_GameObject: {fileID: 120}
  m_Enabled: 0
  m_Script: {fileID: 11500000, guid: 7fba285130b2c3342be00e9cfa2e3c7c, type: 3}
  albedoColor: {r: 0.2, g: 0.4, b: 0.8, a: 1}
  smoothness: 0.8
--- !u!33 &123
MeshFilter:
  m_GameObject: {fileID: 120}
  m_Mesh: {fileID: 10202, guid: 0000000000000000e000000000000000, type: 0}
--- !u!1 &160
GameObject:
  m_Name: Main Camera
  m_IsActive: 1
--- !u!4 &161
Transform:
  m_GameObject: {fileID: 160}
  m_LocalRotation: {x: 0.08715578, y: 0, z: 0, w: 0.9961947}
  m_LocalPosition: {x: 0, y: 2.5, z: -7}
  m_LocalScale: {x: 1, y: 1, z: 1}
  m_Father: {fileID: 0}
--- !u!20 &162
Camera:
  m_GameObject: {fileID: 160}
  field of view: 50
--- !u!114 &163
MonoBehaviour:
  m_GameObject: {fileID: 160}
  m_Enabled: 1
  m_Script: {fileID: 11500000, guid: b2e91413b60a86f49ac7969f1637f0cd, type: 3}
  numBounces: 3
  numRays: 2
"""


@pytest.mark.parametrize("include_disabled", [False, True])
def test_render_unity_scene(tmp_path, capsys, include_disabled):
    from unityraytracer_tpu_torch.models.unity_scene import load_unity_scene

    path = tmp_path / "scene.unity"
    path.write_text(UNITY_SCENE)
    flags = ["--include-disabled"] if include_disabled else []
    png, _, err = _render(tmp_path, capsys, "--unity", str(path), *flags)
    assert err.strip() == ("unity scene settings: {'numBounces': 3, "
                           "'numRays': 2, 'skybox_guid': None}")
    scene, cam, _ = load_unity_scene(str(path), aspect=W / H,
                                     include_disabled=include_disabled)
    assert (scene.num_spheres, scene.num_triangles) \
        == (1, 12 if include_disabled else 0)
    want, _ = _by_hand(scene, cam, tmp_path)
    assert png == want


def test_render_aovs_and_denoise(tmp_path, capsys):
    from unityraytracer_tpu.models.exr import load_exr as jax_load_exr

    aovs = str(tmp_path / "aovs.exr")
    png, lines, _ = _render(tmp_path, capsys, "--aovs", aovs, "--denoise")
    assert lines[1] == f"wrote {aovs} (beauty/albedo/normal/depth/emission)"
    _, r = _by_hand(fixtures.scene1(), fixtures.scene1_camera(W / H),
                    tmp_path)
    write_png(str(tmp_path / "dn.png"),
              tonemap_aces(r.denoised_image(guided=True)))
    assert png == open(tmp_path / "dn.png", "rb").read()
    g = {k: v.numpy() for k, v in r.aovs().items()}
    half = lambda a: a.astype(np.float16).astype(np.float32)  # noqa: E731
    # The JAX reader on the port's file.
    np.testing.assert_array_equal(jax_load_exr(aovs, part="beauty"),
                                  half(r.image))
    np.testing.assert_array_equal(jax_load_exr(aovs, part="albedo"),
                                  half(g["albedo"]))
    assert jax_load_exr(aovs, part="normal").shape == (H, W, 3)
    assert jax_load_exr(aovs, part="depth").shape[:2] == (H, W)


def test_preview_writes_its_file_and_serves_it(tmp_path, capsys):
    out = str(tmp_path / "preview.png")
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    import unityraytracer_tpu_torch.__main__ as cli
    built = []
    make = cli._make_renderer
    cli._make_renderer = lambda a: built.append(make(a)) or built[-1]
    try:
        rc = main(["preview", *SIZE, "--bounces", "2", "--frames", "4",
                   "--every", "2", "--device", "cpu", "-o", out, "--port",
                   str(port)])
    finally:
        cli._make_renderer = make
    try:
        assert rc == 0
        assert capsys.readouterr().out.strip() == f"wrote {out} (4 samples)"
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/").read()
        assert b"/preview.png" in page
        served = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/preview.png").read()
        assert served == open(out, "rb").read()
    finally:
        built[0]._preview_server.shutdown()
        built[0]._preview_server.server_close()
    # The file is the unguided denoise of 4 frames in two fused steps.
    cfg = RenderConfig(width=W, height=H, bounces=2, tracer="pallas",
                       wavefront=True)
    r = Renderer(fixtures.scene1(), fixtures.scene1_camera(W / H), cfg,
                 device="cpu").step(2).step(2)
    write_png(str(tmp_path / "want.png"), tonemap_aces(r.denoised_image()))
    assert served == open(tmp_path / "want.png", "rb").read()
    assert set(built[0].stats["tick"]) == {"step_ms", "denoise_ms", "png_ms"}


def test_info_prints_device_and_counts(capsys):
    assert main(["info", "--scene", "scene1"]) == 0
    out = capsys.readouterr().out.splitlines()
    if torch.cuda.is_available():
        assert out[0].startswith("device: cuda  count: ")
        assert torch.cuda.get_device_name(0) in out[0]
    else:
        assert out[0] == "device: cpu  (torch sees no CUDA device)"
    assert "backend" not in out[0]
    assert out[1] == "scene: 8 spheres, 940 triangles, skybox (256, 512, 3)"
    assert main(["info", "--scene", "bench", "--tris", "3000"]) == 0
    assert "0 spheres, 3840 triangles" in capsys.readouterr().out


def test_what_is_not_ported_raises(tmp_path, capsys):
    """What the port refuses raises and renders nothing: an unknown
    ``--rng``, an unknown tracer, an unknown ``--shard`` mode; ``preview
    --shard`` returns 2 with the JAX message. ``--tracer bvh|cluster``,
    ``--shard`` (``test_accel_tracer_and_shard_flags_render``) and ``--rng
    rbg`` (``test_torch_rbg.py``) are ported."""
    base = ["render", *SIZE, "--device", "cpu", "-o",
            str(tmp_path / "never.png")]
    for tracer in ("bvh", "cluster"):
        assert RenderConfig(tracer=tracer).tracer == tracer
    with pytest.raises(ValueError, match="unknown rng_impl 'philox4x32'"):
        main(base + ["--rng", "philox4x32"])
    with pytest.raises(ValueError, match="unknown tracer"):
        main(base + ["--tracer", "embree"])
    assert not (tmp_path / "never.png").exists()
    # preview --shard: the JAX command line's message and code, first.
    assert main(["preview", "--shard", "rows", "--device", "cpu"]) == 2
    assert capsys.readouterr().err.strip() \
        == "--shard applies to `render` (preview is single-chip)"
    with pytest.raises(SystemExit):                   # argparse: bad choice
        main(base + ["--shard", "tiles"])


@pytest.mark.parametrize("flags", [["--tracer", "bvh"],
                                   ["--tracer", "cluster"],
                                   ["--shard", "rows"], ["--shard", "spp"],
                                   ["--shard", "scene"],
                                   ["--shard", "scene", "--tracer", "bvh"]],
                         ids=lambda f: "-".join(a.strip("-") for a in f))
def test_accel_tracer_and_shard_flags_render(tmp_path, capsys, flags):
    """The PNG equals a hand-built renderer's: a ``Renderer`` with the
    tracer, or a ``ShardedRenderer`` of the mode over ``[cpu]`` (``--shard
    scene`` turns the default ``pallas`` into ``cluster``)."""
    from unityraytracer_tpu_torch.parallel.sharding import ShardedRenderer

    png, lines, _ = _render(tmp_path, capsys, *flags)
    opts = dict(zip(flags[::2], flags[1::2]))
    shard = opts.get("--shard")
    tracer = opts.get("--tracer", "cluster" if shard == "scene"
                      else "pallas")
    if shard is None:
        want, _ = _by_hand(fixtures.scene1(), fixtures.scene1_camera(W / H),
                           tmp_path, tracer=tracer)
    else:
        cfg = RenderConfig(width=W, height=H, spp=1, bounces=2,
                           tracer=tracer, wavefront=True)
        r = ShardedRenderer(fixtures.scene1(),
                            fixtures.scene1_camera(W / H), cfg,
                            mesh=["cpu"], seed=0, mode=shard).step(2)
        want = open(write_png(str(tmp_path / "hand.png"),
                              tonemap_aces(r.image)), "rb").read()
    assert png == want and len(lines) == 1


def test_shard_scene_aovs_and_denoise(tmp_path, capsys):
    """``--aovs`` and ``--denoise`` through the sharded renderer's preview
    and export mixin."""
    from unityraytracer_tpu_torch.models.exr import load_exr

    aovs = str(tmp_path / "aovs.exr")
    png, lines, _ = _render(tmp_path, capsys, "--shard", "scene", "--aovs",
                            aovs, "--denoise")
    assert lines[1] == f"wrote {aovs} (beauty/albedo/normal/depth/emission)"
    _, r = _by_hand(fixtures.scene1(), fixtures.scene1_camera(W / H),
                    tmp_path, tracer="cluster")
    write_png(str(tmp_path / "dn.png"),
              tonemap_aces(r.denoised_image(guided=True)))
    assert png == open(tmp_path / "dn.png", "rb").read()
    half = lambda a: a.astype(np.float16).astype(np.float32)  # noqa: E731
    np.testing.assert_array_equal(load_exr(aovs, part="albedo"),
                                  half(r.aovs()["albedo"].numpy()))


def test_default_device_is_the_card(tmp_path):
    """With no ``--device`` the command renders on the card, and where
    torch sees none it fails as ``Renderer`` does: never a CPU render."""
    out = str(tmp_path / "card.png")
    argv = ["render", *SIZE, "--frames", "1", "--bounces", "2", "-o", out]
    if torch.cuda.is_available():
        assert main(argv) == 0 and os.path.getsize(out) > 100
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
        assert not os.path.exists(out)


def test_module_runs_as_a_child_process(tmp_path):
    out = str(tmp_path / "child.png")
    argv = [sys.executable, "-m", "unityraytracer_tpu_torch", "render",
            "--scene", "scene1", "-o", out, "--frames", "2", *SIZE]
    ok = subprocess.run(argv + ["--device", "cpu"], cwd=ROOT,
                        capture_output=True, text=True)
    assert ok.returncode == 0, ok.stderr
    assert SUMMARY.match(ok.stdout.strip()) and os.path.getsize(out) > 100
    assert _png_pixels(out).shape == (H, W, 3)
    if not torch.cuda.is_available():
        os.remove(out)
        bad = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True)
        assert bad.returncode != 0 and "no CUDA device" in bad.stderr
        assert not os.path.exists(out)
    script = re.search(r'^unityraytracer-tpu-torch = "(.+):main"$',
                       (ROOT / "pyproject.toml").read_text(), re.M)
    assert script.group(1) == "unityraytracer_tpu_torch.__main__"


def test_both_command_lines_agree(tmp_path, capsys):
    """The JAX command line and the port's on the same arguments."""
    from unityraytracer_tpu.__main__ import main as jax_main

    args = ["render", "--scene", "scene1", *SIZE, "--bounces", "3",
            "--frames", "3", "--tracer", "brute", "--seed", "5"]
    a, b = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    assert jax_main(args + ["-o", a]) == 0
    jline = capsys.readouterr().out.strip().splitlines()[0]
    assert main(args + ["-o", b, "--device", "cpu"]) == 0
    tline = capsys.readouterr().out.strip().splitlines()[0]
    assert SUMMARY.match(jline) and SUMMARY.match(tline)
    pa = _png_pixels(a).astype(np.int32)
    pb = _png_pixels(b).astype(np.int32)
    diff = np.abs(pa - pb).max(axis=-1)
    assert (diff <= 1).mean() >= 0.999, (diff > 1).sum()
    assert diff.max() <= 8
