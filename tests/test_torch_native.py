"""The port's native C++ tile reader (``sequoia_tpu_torch.native``) against
the JAX package's (``sequoia_tpu.native``): the same regions, bit for bit,
from the same files, and ``open_slide``'s choice of backend."""

import sys
import types

import numpy as np
import pytest

from sequoia_tpu import native as jnative
from sequoia_tpu_torch import native
from sequoia_tpu_torch.data import wsi

if not jnative.available():
    pytest.skip("the JAX package's native reader did not build", allow_module_level=True)


def _gradient(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)],
                    axis=-1).astype(np.uint8)


@pytest.fixture(params=["tiled_rgb", "jpeg_svs"])
def pyramid(request, tmp_path):
    """A tiled RGB pyramid of noise, or an Aperio-SVS-like pyramid of
    JPEG-compressed YCbCr tiles with an AppMag description, written by the
    port's writer."""
    if request.param == "tiled_rgb":
        lv0 = np.random.default_rng(0).integers(0, 255, size=(300, 400, 3), dtype=np.uint8)
        kw = {}
    else:
        lv0 = _gradient(300, 400)
        kw = dict(jpeg_quality=90, description="Aperio Image Library v12.0.15\n"
                  "400x300 (64x64) JPEG/RGB Q=90|AppMag = 20|MPP = 0.5040")
    path = str(tmp_path / f"{request.param}.tiff")
    native.write_tiled_tiff(path, [lv0, lv0[::4, ::4].copy()], tile=(64, 64), **kw)
    return request.param, path, lv0


def test_regions_equal_jax_reader(pyramid):
    kind, path, lv0 = pyramid
    r, j = native.NativeTiffReader(path), jnative.NativeTiffReader(path)
    try:
        assert r.level_dimensions == j.level_dimensions == [(400, 300), (100, 75)]
        assert r.properties == j.properties
        assert r.tile_dims(0) == j.tile_dims(0) == (64, 64)
        for loc, level, size in (((37, 99), 0, (150, 80)), ((40, 100), 1, (20, 10)),
                                 ((392, 296), 0, (16, 16)), ((0, 0), 0, (400, 300))):
            np.testing.assert_array_equal(r.read_region(loc, level, size),
                                          j.read_region(loc, level, size))
        locs = [(int(x), int(y)) for x, y in zip(
            np.random.default_rng(1).integers(0, 336, 24),
            np.random.default_rng(2).integers(0, 236, 24))]
        got = r.read_regions(locs, 0, (64, 64), nthreads=4)
        np.testing.assert_array_equal(got, j.read_regions(locs, 0, (64, 64), nthreads=4))
        if kind == "tiled_rgb":  # lossless: the pixels written
            np.testing.assert_array_equal(got[0], lv0[locs[0][1]:locs[0][1] + 64,
                                                      locs[0][0]:locs[0][0] + 64])
            assert r.ycbcr_subsampling(0, (64, 64)) is None
        else:
            assert r.properties["aperio.AppMag"] == "20"
            tiles = [(0, 0), (64, 128), (320, 192)]
            assert r.ycbcr_subsampling(0, (64, 64)) == j.ycbcr_subsampling(0, (64, 64))
            np.testing.assert_array_equal(r.read_regions_ycbcr(tiles, 0, (64, 64)),
                                          j.read_regions_ycbcr(tiles, 0, (64, 64)))
    finally:
        r.close()
        j.close()


def test_port_reads_jax_written_file(tmp_path):
    lv0 = _gradient(128, 192)
    path = str(tmp_path / "jax.tiff")
    jnative.write_tiled_tiff(path, [lv0], tile=(64, 64))
    np.testing.assert_array_equal(native.NativeTiffReader(path).read_region((0, 0), 0,
                                                                            (192, 128)), lv0)


def test_open_slide_prefers_native_and_ignores_stub_openslide(pyramid, monkeypatch):
    _, path, _ = pyramid
    assert isinstance(wsi.open_slide(path), native.NativeTiffReader)
    monkeypatch.setitem(sys.modules, "openslide", types.ModuleType("openslide"))
    r = wsi.open_slide(path)
    assert isinstance(r, native.NativeTiffReader)
    batch = wsi.read_regions(r, [(0, 0), (64, 64)], 0, (32, 32))
    np.testing.assert_array_equal(batch[1], r.read_region((64, 64), 0, (32, 32)))


def test_open_slide_falls_back_to_pillow_for_a_flat_image(tmp_path):
    from PIL import Image

    img = _gradient(48, 64)
    path = str(tmp_path / "flat.png")
    Image.fromarray(img).save(path)
    r = wsi.open_slide(path)
    assert isinstance(r, wsi.PILReader)
    np.testing.assert_array_equal(r.read_region((8, 4), 0, (16, 8)), img[4:12, 8:24])


def test_writer_rejects_non_mcu_jpeg_tiles(tmp_path):
    with pytest.raises(ValueError, match="multiple-of-16"):
        native.write_tiled_tiff(str(tmp_path / "bad.tiff"), [np.zeros((64, 64, 3), np.uint8)],
                                tile=(60, 60), jpeg_quality=90)


def test_unloadable_library_degrades_to_unavailable(tmp_path, monkeypatch):
    """A library that exists but cannot load (wrong architecture, libtiff
    missing at run time) makes available() False, with the loader's message."""
    bad = tmp_path / "libsequoia_native_bad.so"
    bad.write_bytes(b"not an ELF file")
    monkeypatch.setattr(native, "_library_path", lambda: bad)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.available() is False
    assert native.build_error()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.NativeTiffReader("x.tiff")
    # open_slide carries on with Pillow, even for a TIFF
    from PIL import Image

    path = str(tmp_path / "strips.tiff")
    Image.fromarray(_gradient(32, 48)).save(path)
    assert isinstance(wsi.open_slide(path), wsi.PILReader)


def test_failed_build_keeps_the_compiler_message(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.available() is False
    assert "no_such_header_here.h" in native.build_error()
    assert not list((tmp_path / "build").glob("*.so"))  # nothing half-built is kept
