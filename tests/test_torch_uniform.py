"""The path kernel's uniform rows: the threefry kernel's per-ray counter
mapping, its by-value struct (k_bounce's words, from which the kernel's
prologue derives the keys), and the rows against the JAX package's
``render_sample_mega`` draws.

Bars: the per-ray twin of the kernel (``torch_twins.bounce_rows_twin``) is
bit-equal to ``mega_inputs``' rows on the CPU, where ``bounce_rows`` runs its
plain version; against the JAX package, u_r and the roulette row are
bit-exact (the same threefry streams); cos 2 pi u2 and sin 2 pi u2 agree to
1 ulp and log2 u1 to 2 ulp, the documented difference between torch's and
XLA:CPU's transcendental functions (ROADMAP.md, "Port vs JAX on the same
seed"; about a third of the log2 values and one in twenty of the cos and
sin values differ at all)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twins import bounce_prologue_keys, bounce_rows_twin
from unityraytracer_tpu import RenderConfig as JConfig
from unityraytracer_tpu.render import _draw_fn as jax_draw_fn
from unityraytracer_tpu.render import _rr_uniform as jax_rr_uniform
from unityraytracer_tpu_torch import RenderConfig, _build, rng
from unityraytracer_tpu_torch.models import fixtures as tfix
from unityraytracer_tpu_torch.render import (bounce_args, bounce_rows,
                                             bounce_rows_plain, mega_inputs)

# (width, height, rows, row0, spp, rr_group, russian_roulette): blocked
# 32x16; unblocked (h % 8 != 0); a band with row0 > 0; spp 3; per-ray and
# grouped roulette; roulette off.
CASES = {
    "blocked_step": (32, 16, None, 0, 1, "step", True),
    "blocked_ray": (32, 16, None, 0, 1, "ray", True),
    "unblocked_step": (20, 12, None, 0, 1, "step", True),
    "unblocked_ray": (20, 12, None, 0, 2, "ray", True),
    "band_step": (32, 40, 16, 8, 1, "step", True),
    "band_ray": (32, 40, 16, 16, 1, "ray", True),
    "spp3_ray": (32, 16, None, 0, 3, "ray", True),
    "spp3_step_wide": (160, 16, None, 0, 3, "step", True),
    "rr_off": (32, 16, None, 0, 1, "step", False),
}


def _cfg(case, bounces=5):
    W, H, _, _, spp, group, rr = CASES[case]
    return RenderConfig(width=W, height=H, spp=spp, bounces=bounces,
                        tracer="pallas", rr_group=group, russian_roulette=rr)


def _band(case):
    _, H, rows, row0, *_ = CASES[case]
    h = H if rows is None else rows
    return h, row0


def _blocked(cfg, h):
    return h % 8 == 0 and cfg.width % 16 == 0


def _k_bounce(key):
    return rng.split(key, 3)[2]


@pytest.mark.parametrize("case", list(CASES))
def test_twin_is_mega_inputs_rows(case):
    cfg = _cfg(case)
    h, row0 = _band(case)
    key = rng.key(17)
    scene = tfix.scene1().to("cpu")
    *_, uni, _, _, _ = mega_inputs(scene, tfix.scene1_camera(2.0), key, cfg,
                                   row0=row0, rows=h)
    twin = bounce_rows_twin(_k_bounce(key), cfg, h, row0, _blocked(cfg, h))
    assert uni.shape == twin.shape == (cfg.bounces, 5, cfg.spp * h * cfg.width)
    assert torch.equal(uni.view(torch.int32), twin.view(torch.int32))
    if not cfg.russian_roulette:
        assert (uni[:, 4] == 1).all()
    else:
        assert (uni[2:4, 4] < 1).all() and (uni[[0, 1, 4], 4] == 1).all()


def _jax_rows(key_data, cfg, h, row0):
    """The rows ``render_sample_mega`` feeds the JAX path kernel, drawn as
    it draws them (``bounce_rows`` of unityraytracer_tpu/render.py)."""
    jcfg = JConfig(width=cfg.width, height=cfg.height, spp=cfg.spp,
                   bounces=cfg.bounces, rr_group=cfg.rr_group,
                   russian_roulette=cfg.russian_roulette)
    W, spp = cfg.width, cfg.spp
    N = spp * h * W
    key = jax.random.wrap_key_data(jnp.asarray(key_data, jnp.uint32))
    k_bounce = jax.random.split(key, 3)[2]
    blocked = h % 8 == 0 and W % 16 == 0
    draw = jax_draw_fn(h, W, spp, blocked)
    if blocked:
        def to_blocks(a):
            return (a.reshape(spp, h // 8, 8, W // 16, 16)
                    .transpose(0, 1, 3, 2, 4).reshape(N))
    else:
        def to_blocks(a):
            return a
    out = []
    for b in range(cfg.bounces):
        kb = jax.random.fold_in(k_bounce, b)
        u_r, u1, u2 = (draw(jax.random.uniform(jax.random.fold_in(kb, i),
                                               (N,))) for i in range(3))
        if cfg.russian_roulette and 2 <= b < cfg.bounces - 1:
            u_rr = jax_rr_uniform(jax.random.fold_in(kb, 3), jcfg, spp, h, W,
                                  row0, to_blocks)
        else:
            u_rr = jnp.ones((N,), jnp.float32)
        two_pi = 2.0 * 3.14159265
        out.append(np.stack([np.asarray(r) for r in (
            u_r, jnp.log2(jnp.maximum(u1, 1e-12)), jnp.cos(two_pi * u2),
            jnp.sin(two_pi * u2), u_rr)]))
    return np.stack(out)


@pytest.mark.parametrize("case", ["blocked_step", "unblocked_ray",
                                  "band_step", "spp3_ray", "rr_off"])
def test_rows_match_jax(case):
    cfg = _cfg(case, bounces=6)
    h, row0 = _band(case)
    key = rng.key(23)
    got = bounce_rows_plain(_k_bounce(key), cfg, h, row0, _blocked(cfg, h),
                            "cpu").numpy()
    want = _jax_rows(key, cfg, h, row0)
    assert got.shape == want.shape
    for r in (0, 4):
        np.testing.assert_array_equal(got[:, r].view(np.uint32),
                                      want[:, r].view(np.uint32))
    for r, bound in ((1, 2.0), (2, 1.0), (3, 1.0)):
        ulps = np.abs(got[:, r] - want[:, r]) / np.spacing(np.maximum(
            np.abs(got[:, r]), np.abs(want[:, r])))
        assert ulps.max() <= bound, (r, ulps.max())


def test_bounce_args_keys_are_fold_in_chain(monkeypatch):
    # bounce_args hands the kernel k_bounce's words and hashes nothing; the
    # kernel's prologue (its twin here) derives the fold_in chain from them.
    cfg = _cfg("band_step", bounces=7)
    k_bounce = _k_bounce(rng.key(5))
    calls, hash_ = [], rng.threefry2x32
    monkeypatch.setattr(rng, "threefry2x32",
                        lambda *a: calls.append(a) or hash_(*a))
    args = bounce_args(k_bounce, cfg, 16, 8, True)
    assert calls == []
    monkeypatch.undo()
    assert (args.k0, args.k1) == tuple(int(w) for w in k_bounce)
    keys = bounce_prologue_keys(np.array([args.k0, args.k1], np.uint32),
                                args.nb)
    jk = jax.random.wrap_key_data(jnp.asarray(k_bounce, jnp.uint32))
    for b in range(cfg.bounces):
        kb = rng.fold_in(k_bounce, b)
        for row in range(4):
            np.testing.assert_array_equal(keys[b, row], rng.fold_in(kb, row))
            np.testing.assert_array_equal(keys[b, row], np.asarray(
                jax.random.key_data(jax.random.fold_in(
                    jax.random.fold_in(jk, b), row))))
    assert (args.n, args.nb, args.h, args.W, args.row0) == (512, 7, 16, 32, 8)
    assert (args.Hg, args.Wg, args.blocked, args.rr_step) == (5, 1, 1, 1)
    assert (args.rr_lo, args.rr_hi) == (2, 6)
    off = bounce_args(k_bounce, cfg.replace(russian_roulette=False,
                                            rr_group="ray"), 16, 8, False)
    assert (off.rr_lo, off.rr_hi, off.rr_step, off.blocked) == (0, 0, 0, 0)
    with pytest.raises(ValueError, match="at most 32"):
        bounce_args(k_bounce, cfg.replace(bounces=33), 16, 8, True)


def test_bounce_args_mirror_the_header():
    src = (_build.CSRC / "uniform_kernel.cu").read_text()
    body = re.search(r"struct BounceArgs \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(unsigned int|int)\s+(\w+)(\[[^\]]+\])?;", body,
                        re.M)
    got = [(name, ty) for name, ty in _build.BounceArgs._fields_]
    assert [name for _, name, _ in fields] == [name for name, _ in got]
    # k_bounce's four words (threefry reads k0 and k1), then ints.
    assert [name for _, name, _ in fields[:4]] == ["k0", "k1", "k2", "k3"]
    assert all(ty == "unsigned int" and not arr for ty, _, arr in fields[:4])
    assert all(ty.__name__ == "c_uint" for _, ty in got[:4])
    assert all(ty == "int" and not arr for ty, _, arr in fields[4:])
    assert all(ty.__name__ == "c_int" for _, ty in got[4:])
    assert re.search(r"#define URT_MAX_BOUNCES (\d+)", src).group(1) == str(
        _build.MAX_BOUNCES)


def test_cpu_draws_take_the_plain_versions():
    before = dict(_build.LAUNCHES)
    key = rng.key(3)
    np.testing.assert_array_equal(rng.uniform(key, (7, 3)).numpy(),
                                  rng.uniform_plain(key, (7, 3)).numpy())
    cfg = _cfg("blocked_step")
    a = bounce_rows(key, cfg, 16, 0, True, "cpu")
    b = bounce_rows_plain(key, cfg, 16, 0, True, "cpu")
    assert torch.equal(a, b)
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError):
        rng.uniform(key, (4,), device="meta")
    with pytest.raises(ValueError):
        bounce_rows(key, cfg, 16, 0, True, "meta")
