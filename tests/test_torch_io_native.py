"""The port's native IO codec (``io/native.py`` over the repo's
``native/librgbe.so``): its HDR decode and BMP encode against the port's
pure-numpy path and against the JAX package's ``io/native.py`` on the
same written files, and the fallback to the numpy path when the library
is absent. The library is built with ``make -C native`` when it is not
there; without a C++ toolchain the native cases skip, as
``tests/test_io.py`` does.
"""

import subprocess

import numpy as np
import pytest

from cpuperformanceraytracer_tpu_torch.io import image, native
from cpuperformanceraytracer_tpu_torch.texture import hdr


@pytest.fixture
def lib():
    if native.get_lib() is None:
        r = subprocess.run(["make", "-C", str(native.LIB_PATH.parent)],
                           capture_output=True, text=True)
        native._TRIED, native._LIB = False, None  # look again
        if r.returncode != 0 or native.get_lib() is None:
            pytest.skip("no C++ toolchain for the native codec")
    return native.get_lib()


@pytest.mark.parametrize("flip", [True, False])
def test_native_hdr_decode_matches_numpy_and_jax(lib, tmp_path, flip):
    from cpuperformanceraytracer_tpu.io import native as jax_native

    img = np.random.RandomState(7).rand(9, 33, 3).astype(np.float32) * 4.0
    p = str(tmp_path / "t.hdr")
    hdr.write_hdr(p, img)
    got = native.read_hdr_native(p, flip)
    assert got is not None and got.shape == (9, 33, 3)
    np.testing.assert_array_equal(got, hdr.read_hdr_numpy(p, flip))
    np.testing.assert_array_equal(got, jax_native.read_hdr_native(p, flip))
    np.testing.assert_array_equal(hdr.read_hdr(p, flip), got)


@pytest.mark.parametrize("width", [22, 24])
def test_native_bmp_encode_matches_numpy_and_jax(lib, tmp_path, width):
    from cpuperformanceraytracer_tpu.io import native as jax_native

    u8 = np.random.RandomState(3).randint(0, 256, (11, width, 3), np.uint8)
    paths = [str(tmp_path / f"{n}.bmp") for n in ("native", "numpy", "jax",
                                                  "write")]
    assert native.write_bmp_native(paths[0], u8)
    image.write_bmp_numpy(paths[1], u8)
    assert jax_native.write_bmp_native(paths[2], u8)
    image.write_bmp(paths[3], u8)
    blobs = [open(p, "rb").read() for p in paths]
    assert all(b == blobs[0] for b in blobs[1:])
    np.testing.assert_array_equal(image.read_bmp(paths[0]), u8)


def test_without_the_library_the_numpy_path_runs(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "absent.so")
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    img = np.random.RandomState(1).rand(5, 8, 3).astype(np.float32)
    p = str(tmp_path / "t.hdr")
    hdr.write_hdr(p, img)
    assert native.read_hdr_native(p) is None
    np.testing.assert_array_equal(hdr.read_hdr(p), hdr.read_hdr_numpy(p))
    u8 = np.random.RandomState(2).randint(0, 256, (3, 5, 3), np.uint8)
    assert not native.write_bmp_native(str(tmp_path / "n.bmp"), u8)
    image.write_bmp(str(tmp_path / "a.bmp"), u8)
    np.testing.assert_array_equal(image.read_bmp(str(tmp_path / "a.bmp")), u8)
