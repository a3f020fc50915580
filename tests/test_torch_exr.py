"""The port's EXR module against the JAX package's ``models/exr.py``.

Writers: byte-identical files for the same arrays and arguments, for every
compression of the scanline set (none, rle, zips, zip, pxr24, and the codec
modules' piz, b44, b44a, dwaa, dwab) x half and float, single-part,
multi-part and tiled (one level and mipmapped). Reader: the port's
``load_exr`` equals the JAX ``load_exr`` exactly on files the JAX package
wrote in those modes (both decode the same bits with the same numpy code,
so the lossy codecs agree exactly too), and each package reads the other's
file. The codec modules are also held stage by stage (wavelet, Huffman,
block packing, the DWA chunk) and against libOpenEXR through
``tests/exr_oracle.py`` where the JAX tests use it."""

import sys
import os

import numpy as np
import pytest

from unityraytracer_tpu.models import exr as jexr
from unityraytracer_tpu_torch.models import exr as texr

sys.path.insert(0, os.path.dirname(__file__))
import exr_oracle as oracle  # noqa: E402
from unityraytracer_tpu.models import b44 as jb44  # noqa: E402
from unityraytracer_tpu.models import dwa as jdwa  # noqa: E402
from unityraytracer_tpu.models import piz as jpiz  # noqa: E402
from unityraytracer_tpu_torch.models import b44 as tb44  # noqa: E402
from unityraytracer_tpu_torch.models import dwa as tdwa  # noqa: E402
from unityraytracer_tpu_torch.models import piz as tpiz  # noqa: E402

CODECS = ["piz", "b44", "b44a", "dwaa", "dwab"]
COMPS = ["none", "rle", "zips", "zip", "pxr24"] + CODECS
DTYPES = ["half", "float"]
WRITERS = ["scanline", "multipart", "tiled_one", "tiled_mip"]
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


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("comp", CODECS)
def test_jax_reads_the_ports_codec_file(tmp_path, comp, dtype, writer):
    """The other direction: the JAX reader on the port's file, against the
    port's own reader."""
    path = _write(texr, writer, str(tmp_path / "port.exr"), comp, dtype)
    for part in _parts(writer):
        np.testing.assert_array_equal(jexr.load_exr(path, part=part),
                                      texr.load_exr(path, part=part))


def _smooth(h=40, w=48, c=3):
    """A smooth image, so every codec wins and its chunks are stored coded
    (a chunk that does not shrink is stored raw)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([(x + 2 * y) / (w + 2 * h) + 0.1 * i for i in range(c)],
                    axis=-1).astype(np.float32)


@pytest.mark.parametrize("comp", CODECS)
def test_codec_chunks_are_stored_coded(tmp_path, comp):
    """The codec really ran: the file is smaller than the raw one, equal to
    the JAX writer's, and reads back as the JAX reader reads it (exactly
    for PIZ, which is lossless)."""
    img = _smooth()
    a = jexr.write_exr(str(tmp_path / "jax.exr"), img, compression=comp)
    b = texr.write_exr(str(tmp_path / "port.exr"), img, compression=comp)
    raw = texr.write_exr(str(tmp_path / "raw.exr"), img, compression="none")
    assert open(a, "rb").read() == open(b, "rb").read()
    assert os.path.getsize(b) < os.path.getsize(raw)
    got = texr.load_exr(b)
    np.testing.assert_array_equal(got, jexr.load_exr(a))
    half = img.astype(np.float16).astype(np.float32)
    if comp == "piz":
        np.testing.assert_array_equal(got, half)
    else:
        assert np.abs(got - half).max() <= 0.02


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (32, 29), (33, 64)])
@pytest.mark.parametrize("mx", [(1 << 14) - 1, (1 << 16) - 1])
def test_piz_wavelet_matches_jax(shape, mx):
    rng = np.random.default_rng(shape[0] * 131 + mx)
    data = rng.integers(0, mx + 1, shape).astype(np.uint16)
    enc, want = data.copy(), data.copy()
    tpiz.wav2_encode(enc, mx)                   # both work in place
    jpiz.wav2_encode(want, mx)
    np.testing.assert_array_equal(enc, want)
    dec, jdec = enc.copy(), enc.copy()
    tpiz.wav2_decode(dec, mx)
    jpiz.wav2_decode(jdec, mx)
    np.testing.assert_array_equal(dec, data)
    np.testing.assert_array_equal(jdec, data)


@pytest.mark.parametrize("kind", ["uniform", "skewed", "runs", "constant"])
def test_piz_huffman_matches_jax(kind):
    rng = np.random.default_rng(11)
    n = 3000
    data = {"uniform": rng.integers(0, 65536, n),
            "skewed": np.minimum(rng.geometric(0.05, n), 65535),
            "runs": np.repeat(rng.integers(0, 300, n // 50), 50),
            "constant": np.full(n, 7)}[kind].astype(np.uint16)
    blob = tpiz.huf_compress(data)
    assert blob == jpiz.huf_compress(data)
    np.testing.assert_array_equal(tpiz.huf_decompress(blob, len(data)), data)
    # The JAX decoder (its C++ loop where built, else its Python loop).
    np.testing.assert_array_equal(jpiz.huf_decompress(blob, len(data)), data)


@pytest.mark.parametrize("sizes", [[1, 1, 1], [2, 2], [1, 2, 1, 2]])
def test_piz_chunk_matches_jax(sizes):
    rng = np.random.default_rng(len(sizes))
    nx, ny = 23, 9
    raw = rng.integers(0, 2048, sum(sizes) * nx * ny).astype("<u2").tobytes()
    packed = tpiz.piz_compress(raw, sizes, nx, ny)
    assert packed == jpiz.piz_compress(raw, sizes, nx, ny)
    assert tpiz.piz_decompress(packed, sizes, nx, ny) == raw
    assert jpiz.piz_decompress(packed, sizes, nx, ny) == raw


@pytest.mark.parametrize("flat3", [False, True])
@pytest.mark.parametrize("dt", ["<f2", "<f4"])
def test_b44_chunk_matches_jax(flat3, dt):
    rng = np.random.default_rng(5)
    w, n_lines = 22, 10
    chans = [("B", np.dtype(dt)), ("G", np.dtype(dt)), ("R", np.dtype(dt))]
    vals = rng.uniform(0.5, 1.0, (n_lines, 3, w)).astype(dt)
    vals[:4, 1, :8] = 0.625                                 # a flat block
    vals[5, 0, 3], vals[6, 2, 4] = np.inf, np.nan           # flushed to zero
    raw = vals.tobytes()
    packed = tb44.b44_compress(raw, chans, w, n_lines, flat3=flat3)
    assert packed == jb44.b44_compress(raw, chans, w, n_lines, flat3=flat3)
    out = tb44.b44_decompress(packed, chans, w, n_lines, fixed14=not flat3)
    assert out == jb44.b44_decompress(packed, chans, w, n_lines,
                                      fixed14=not flat3)
    assert len(out) == len(raw)


@pytest.mark.parametrize("dwab", [False, True])
@pytest.mark.parametrize("names", [("B", "G", "R"), ("A", "B", "G", "R"),
                                   ("Y",)])
def test_dwa_chunk_matches_jax(dwab, names):
    """RGB takes the DCT route with the colour transform, A the RLE planes,
    a lone Y the DCT without it."""
    rng = np.random.default_rng(len(names))
    w, n_lines = 27, 19
    chans = [(n, np.dtype("<f2")) for n in names]
    raw = (rng.gamma(0.8, 1.5, (n_lines, len(names), w)).astype("<f2")
           .tobytes())
    packed = tdwa.dwa_compress(raw, chans, w, n_lines, dwab=dwab)
    assert packed == jdwa.dwa_compress(raw, chans, w, n_lines, dwab=dwab)
    out = tdwa.dwa_decompress(packed, chans, w, n_lines)
    assert out == jdwa.dwa_decompress(packed, chans, w, n_lines)
    a = np.frombuffer(out, "<f2").astype(np.float32)
    b = np.frombuffer(raw, "<f2").astype(np.float32)
    assert np.abs(a - b).max() <= 0.02 * max(1.0, float(b.max()))


def test_dwa_tables_match_jax():
    for name in ("_ZIG", "_IDCT_M", "_TO_LINEAR", "_TO_NONLINEAR"):
        np.testing.assert_array_equal(getattr(tdwa, name),
                                      getattr(jdwa, name))


def _oracle_image():
    rng = np.random.default_rng(7)
    h, w = 37, 53
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.stack([x / w, y / h, (x + y) % 7.0], axis=-1) \
        + rng.random((h, w, 3), np.float32) * 4.0
    out[0, 0], out[1, 1], out[2, 2] = 0.0, 65504.0, -1.5
    return out.astype(np.float32)


needs_oracle = pytest.mark.skipif(not oracle.available(),
                                  reason="libOpenEXR not installed")


@needs_oracle
@pytest.mark.parametrize("comp", CODECS)
def test_libopenexr_file_read_by_the_port(tmp_path, comp):
    """A file libOpenEXR wrote: the lossless and fixed-rate codecs decode
    to what libOpenEXR itself decodes; DWA within the JAX tests' bound
    (98% of the halves equal, none more than 8 half-ulps off, alpha
    exact)."""
    p = str(tmp_path / "real.exr")
    oracle.write_rgba(p, _oracle_image(), comp)
    ref, ours = oracle.read_rgba(p), texr.load_exr(p)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, jexr.load_exr(p))
    if comp in ("dwaa", "dwab"):
        ulp = np.abs(
            ours.astype(np.float16).view(np.uint16).astype(np.int32)
            - ref.astype(np.float16).view(np.uint16).astype(np.int32))
        assert (ulp == 0).mean() > 0.98 and ulp.max() <= 8
        np.testing.assert_array_equal(ours[..., 3], ref[..., 3])
    else:
        np.testing.assert_array_equal(ours, ref)


@needs_oracle
@pytest.mark.parametrize("comp", CODECS)
def test_ports_file_read_by_libopenexr(tmp_path, comp):
    p = str(tmp_path / "ours.exr")
    img = _oracle_image()
    texr.write_exr(p, img, compression=comp)
    back = oracle.read_rgba(p)[..., :3]
    if comp in ("dwaa", "dwab"):
        ref = img.astype(np.float16).astype(np.float32)
        assert np.abs(back - ref).max() <= 0.02 * max(1.0, float(ref.max()))
    else:
        np.testing.assert_array_equal(back, texr.load_exr(p)[..., :3])


@needs_oracle
@pytest.mark.parametrize("comp", ["piz", "b44"])
def test_libopenexr_tiled_file_read_by_the_port(tmp_path, comp):
    p = str(tmp_path / "tiled.exr")
    oracle.write_rgba_tiled(p, _oracle_image(), comp, tile=(16, 16))
    np.testing.assert_array_equal(texr.load_exr(p), oracle.read_rgba(p))


def test_unknown_compression_id_is_rejected(tmp_path):
    """Past DWAB nothing is known: the reader names the id, as the JAX
    reader does."""
    path = texr.write_exr(str(tmp_path / "z.exr"), _image(8, 8),
                          compression="zip", dtype="float")
    raw = bytearray(open(path, "rb").read())
    key = b"compression\x00compression\x00"
    raw[raw.index(key) + len(key) + 4] = 10
    bad = tmp_path / "bad.exr"
    bad.write_bytes(bytes(raw))
    for mod in (texr, jexr):
        with pytest.raises(ValueError, match="10"):
            mod.load_exr(str(bad))
    with pytest.raises(KeyError):
        texr.write_exr(str(tmp_path / "k.exr"), _image(8, 8),
                       compression="zstd")


def test_reader_errors_match(tmp_path):
    path = texr.write_exr_multipart(str(tmp_path / "m.exr"),
                                    [("a", _image(4, 4))])
    with pytest.raises(ValueError, match="no part named"):
        texr.load_exr(path, part="b")
    bad = tmp_path / "bad.exr"
    bad.write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match="not an EXR"):
        texr.load_exr(str(bad))
