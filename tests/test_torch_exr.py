"""The port's EXR module against the JAX package's ``models/exr.py``.

Writers: byte-identical files for the same arrays and arguments, for every
compression the module codes itself (none, rle, zips, zip, pxr24) x half
and float, single-part, multi-part and tiled (one level and mipmapped).
Reader: the port's ``load_exr`` equals the JAX ``load_exr`` exactly on
files the JAX package wrote in those modes. PIZ, B44/B44A and DWAA/DWAB,
whose codec modules are not ported, raise ``NotImplementedError`` on write
and on read."""

import numpy as np
import pytest

from unityraytracer_tpu.models import exr as jexr
from unityraytracer_tpu_torch.models import exr as texr

COMPS = ["none", "rle", "zips", "zip", "pxr24"]
DTYPES = ["half", "float"]
WRITERS = ["scanline", "multipart", "tiled_one", "tiled_mip"]
UNPORTED = ["piz", "b44", "b44a", "dwaa", "dwab"]
# 70000 is past half's range on purpose (it encodes as inf on both sides).
pytestmark = pytest.mark.filterwarnings("ignore:overflow encountered in cast")


def _image(h=37, w=29, c=3, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.gamma(0.8, 1.5, (h, w, c)).astype(np.float32)
    img[5:15, 3:20] = 0.25                      # runs for RLE
    img[20:, :, 0] *= -1.0                      # signs
    img[0, 0] = 70000.0                         # beyond half's range
    return img


def _write(mod, writer, path, comp, dtype):
    img = _image()
    if writer == "scanline":
        return mod.write_exr(path, img, compression=comp, dtype=dtype)
    if writer == "multipart":
        parts = [("beauty", img), ("depth", _image(c=1, seed=1)[..., 0]),
                 ("rgba", _image(19, 23, 4, seed=2))]
        return mod.write_exr_multipart(path, parts, compression=comp,
                                       dtype=dtype)
    return mod.write_exr_tiled(path, _image(c=4), tile=(16, 8),
                               compression=comp, dtype=dtype,
                               level_mode=writer.split("_")[1])


def _parts(writer):
    return [0, 1, 2, "beauty", "depth", "rgba"] if writer == "multipart" \
        else [0]


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("comp", COMPS)
def test_writer_byte_identical(tmp_path, comp, dtype, writer):
    a = _write(jexr, writer, str(tmp_path / "jax.exr"), comp, dtype)
    b = _write(texr, writer, str(tmp_path / "port.exr"), comp, dtype)
    ja, tb = open(a, "rb").read(), open(b, "rb").read()
    assert len(ja) == len(tb) and ja == tb


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("comp", COMPS)
def test_reader_matches_jax(tmp_path, comp, dtype, writer):
    path = _write(jexr, writer, str(tmp_path / "jax.exr"), comp, dtype)
    for part in _parts(writer):
        want = jexr.load_exr(path, part=part)
        got = texr.load_exr(path, part=part)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("comp", UNPORTED)
def test_unported_compressions_raise(tmp_path, comp):
    img = _image(16, 16)
    for writer in (lambda p: texr.write_exr(p, img, compression=comp),
                   lambda p: texr.write_exr_multipart(p, [("a", img)],
                                                      compression=comp),
                   lambda p: texr.write_exr_tiled(p, img, compression=comp)):
        with pytest.raises(NotImplementedError, match="not have yet"):
            writer(str(tmp_path / "port.exr"))
    # A smooth image, so the codec wins and its chunks are stored coded.
    ramp = np.linspace(0, 1, 16, dtype=np.float32)
    smooth = np.broadcast_to(ramp[:, None, None], (16, 16, 3))
    path = jexr.write_exr(str(tmp_path / "jax.exr"), smooth, compression=comp)
    with pytest.raises(NotImplementedError, match=comp.upper()):
        texr.load_exr(path)


def test_reader_errors_match(tmp_path):
    path = texr.write_exr_multipart(str(tmp_path / "m.exr"),
                                    [("a", _image(4, 4))])
    with pytest.raises(ValueError, match="no part named"):
        texr.load_exr(path, part="b")
    bad = tmp_path / "bad.exr"
    bad.write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match="not an EXR"):
        texr.load_exr(str(bad))
