"""The port's PNG codec (rgbdslam_v2_tpu_torch/io/png.py) against OpenCV.

cv2 is the JAX package's PNG reader and writer (io/tum.py). Held here:
cv2-written 8-bit RGB and 16-bit grey PNGs decode exactly as cv2.imread
reads them (cv2 is BGR: its channels are reversed) through both unfilter
routes; crafted rows in all five filter types, at 2 and 3 bytes a pixel
and odd widths, and each type in the first row, unfilter bitwise equal in
C and in numpy, and a PNG of
such rows split over several IDAT chunks decodes equal in cv2 and here;
the port's writer's files read back equal through cv2; a bad CRC,
interlacing, palettes, alpha and a wrong bit depth raise ValueError. And
the port imports none of jax, rgbdslam_v2_tpu, cv2, PIL or libpng.
"""
import re
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from rgbdslam_v2_tpu_torch.io import png  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _rgb(img):
    return img[..., ::-1] if img.ndim == 3 else img


def _decode(data, route):
    """decode_png (the C unfilter), or the same inflated rows through the
    numpy plain version."""
    if route == "native":
        return png.decode_png(data)
    inf = png.inflate_png(data)
    return inf.image(png.unfilter_numpy(inf.filtered, inf.height, inf.row_bytes, inf.bpp))


def _png_bytes(raw_rows: np.ndarray, width: int, height: int, depth: int, ctype: int,
               types, n_idat: int = 1, interlace: int = 0, extra=()) -> bytes:
    """A PNG holding raw_rows filtered with `types`, its deflate stream cut
    into n_idat chunks."""
    bpp = {(2, 8): 3, (2, 16): 6, (0, 8): 1, (0, 16): 2}.get((ctype, depth), 1)
    body = zlib.compress(png.filter_rows(raw_rows, bpp, types), 6)
    cuts = np.linspace(0, len(body), n_idat + 1).astype(int)
    ihdr = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, interlace)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + b"".join(png._chunk(k, v) for k, v in extra)
            + b"".join(png._chunk(b"IDAT", body[a:b]) for a, b in zip(cuts, cuts[1:]))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("shape,dtype", [((37, 23, 3), np.uint8), ((120, 160, 3), np.uint8),
                                         ((41, 19), np.uint16), ((120, 160), np.uint16)])
def test_decodes_cv2_files_as_cv2_reads_them(tmp_path, route, shape, dtype):
    rng = np.random.default_rng(sum(shape))
    # smooth ramps plus noise; OpenCV writes them as Sub rows in several
    # IDAT chunks (the crafted files below hold the other filter types)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    base = (3 * yy + 5 * xx)[..., None] if len(shape) == 3 else 97 * yy + 211 * xx
    img = (base + rng.integers(0, 4, shape)).astype(np.int64)
    img = (img % (256 if dtype == np.uint8 else 65536)).astype(dtype)
    path = tmp_path / "cv2.png"
    assert cv2.imwrite(str(path), img)
    want = _rgb(cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
    got = _decode(path.read_bytes(), route)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bpp,width", [(3, 7), (3, 33), (2, 7), (2, 160), (1, 5)])
def test_all_five_filters_unfilter_equal_in_c_and_numpy(bpp, width):
    rng = np.random.default_rng(bpp * 100 + width)
    rows = 25
    raw = rng.integers(0, 256, (rows, width * bpp)).astype(np.uint8)
    raw[::4] = raw[::4] // 17  # near-flat rows, where Paeth ties are common
    types = np.arange(rows) % 5
    filtered = png.filter_rows(raw, bpp, types)
    assert sorted(set(filtered[k * (width * bpp + 1)] for k in range(rows))) == [0, 1, 2, 3, 4]
    c = png.unfilter_native(filtered, rows, width * bpp, bpp)
    n = png.unfilter_numpy(filtered, rows, width * bpp, bpp)
    np.testing.assert_array_equal(c, n)
    np.testing.assert_array_equal(c, raw)


@pytest.mark.parametrize("first", range(5))
@pytest.mark.parametrize("bpp", [2, 3])
def test_first_row_in_each_filter_type_unfilters_as_numpy(first, bpp):
    """The first row reads zeros above it, and a row's first pixel zeros to
    its left: each filter type in that place, one pixel wide too."""
    rng = np.random.default_rng(first * 10 + bpp)
    for width in (1, 9):
        raw = rng.integers(0, 256, (6, width * bpp)).astype(np.uint8)
        filtered = png.filter_rows(raw, bpp, (np.arange(6) + first) % 5)
        c = png.unfilter_native(filtered, 6, width * bpp, bpp)
        np.testing.assert_array_equal(c, png.unfilter_numpy(filtered, 6, width * bpp, bpp))
        np.testing.assert_array_equal(c, raw)


@pytest.mark.parametrize("ctype,depth,shape", [(2, 8, (19, 13, 3)), (0, 16, (21, 11))])
def test_every_filter_type_decodes_as_cv2_decodes_it(tmp_path, ctype, depth, shape):
    """One file, rows in all five filter types, several IDAT chunks: cv2
    and the port read the same pixels (the filters mean the same)."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256 if depth == 8 else 65536, shape).astype(
        np.uint8 if depth == 8 else np.uint16)
    raw = (img.reshape(shape[0], -1) if depth == 8
           else img.astype(">u2").view(np.uint8).reshape(shape[0], -1))
    data = _png_bytes(raw, shape[1], shape[0], depth, ctype, np.arange(shape[0]) % 5,
                      n_idat=3)
    path = tmp_path / "filters.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(_rgb(cv2.imread(str(path), cv2.IMREAD_UNCHANGED)), img)
    for route in ("native", "numpy"):
        np.testing.assert_array_equal(_decode(data, route), img)


@pytest.mark.parametrize("shape,dtype", [((120, 160, 3), np.uint8), ((33, 17, 3), np.uint8),
                                         ((120, 160), np.uint16), ((9, 31), np.uint16)])
def test_writer_output_reads_back_through_cv2(tmp_path, shape, dtype):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256 if dtype == np.uint8 else 65536, shape).astype(dtype)
    path = tmp_path / "port.png"
    png.write_png(path, img)
    got = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(_rgb(got), img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_writer_refuses_other_layouts():
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4, 4), np.uint8))


def _bad_files():
    raw = np.zeros((2, 6), np.uint8)
    good = _png_bytes(raw, 2, 2, 8, 2, 0)
    crc_at = 8 + 8 + 13  # the IHDR's CRC
    bad_crc = good[:crc_at] + bytes([good[crc_at] ^ 1]) + good[crc_at + 1 :]
    pal = _png_bytes(np.zeros((2, 2), np.uint8), 2, 2, 8, 3, 0,
                     extra=[(b"PLTE", bytes(6))])
    return {
        "signature": b"\x88" + good[1:],
        "crc": bad_crc,
        "interlaced": _png_bytes(raw, 2, 2, 8, 2, 0, interlace=1),
        "palette": pal,
        "alpha": _png_bytes(np.zeros((2, 8), np.uint8), 2, 2, 8, 6, 0),
        "grey_alpha": _png_bytes(np.zeros((2, 4), np.uint8), 2, 2, 8, 4, 0),
        "four_bit": _png_bytes(np.zeros((2, 1), np.uint8), 2, 2, 4, 0, 0),
        "truncated": good[:-20],
        "filter_type_5": (png.SIGNATURE
                          + png._chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 0))
                          + png._chunk(b"IDAT", zlib.compress(bytes([5] + [0] * 6) * 2))
                          + png._chunk(b"IEND", b"")),
    }


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("name", sorted(_bad_files()))
def test_bad_files_raise(name, route):
    with pytest.raises(ValueError):
        _decode(_bad_files()[name], route)


def test_port_imports_no_jax_cv2_pil_or_libpng(tmp_path):
    """No source of the port or of chip_smoke.py imports jax, the JAX
    package, cv2 or PIL, or builds against libpng; every module imports and
    a PNG round trip runs with jax, cv2 and PIL blocked."""
    sources = [*(ROOT / "rgbdslam_v2_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    imports = re.compile(r"^\s*(?:import|from)\s+(jax|cv2|PIL|rgbdslam_v2_tpu)\b", re.M)
    bad = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}" for p in sources
           for m in imports.finditer(p.read_text())]
    native = [*(ROOT / "rgbdslam_v2_tpu_torch" / "csrc").iterdir(),
              ROOT / "rgbdslam_v2_tpu_torch" / "backend.py"]
    bad += [str(p.relative_to(ROOT)) for p in native
            if re.search(r"<png\.h>|-lpng|libpng\.so", p.read_text())]
    assert not bad, bad
    code = (
        "import sys, importlib, pkgutil\n"
        "import numpy as np\n"
        "for m in ('jax', 'cv2', 'PIL'): sys.modules[m] = None\n"
        "import rgbdslam_v2_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from rgbdslam_v2_tpu_torch.io import png\n"
        "img = np.arange(60, dtype=np.uint16).reshape(6, 10) * 999\n"
        "assert (png.decode_png(png.encode_png(img)) == img).all()\n"
        "assert not any(k.split('.')[0] in ('rgbdslam_v2_tpu', 'cv2', 'PIL', 'jax')\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr
