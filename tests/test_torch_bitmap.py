"""The port's image I/O and colour functions against the JAX package's.

PFM, EXR and ``.npy`` files written by one package are read by the
other, and both writers give the same bytes (EXR: float32 ZIP blocks of
16 rows, incompressible blocks stored raw).  RGBE ``.hdr`` files (flat
and run-length scanlines) are written by the test.  PNG runs only where
PIL is present.  The colour functions agree within 1e-6 (PyTorch and
XLA round ``pow`` differently); ``blackbody_rgb`` is numpy in both and
equal.
"""
import importlib.util

import numpy as np
import pytest
import torch

from epsm_mitsuba3_tpu.core import bitmap as BJ
from epsm_mitsuba3_tpu.core import spectrum as SJ

from epsm_mitsuba3_torch.core import bitmap as BT
from epsm_mitsuba3_torch.core import spectrum as ST

HAS_PIL = importlib.util.find_spec("PIL") is not None


def _image(h, w, c, smooth, seed=0):
    rng = np.random.default_rng(seed)
    if smooth:
        y, x = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([np.sin(x / 7 + k) * np.cos(y / 5) + 1.5
                        for k in range(c)], -1)
        return img.astype(np.float32)
    return rng.exponential(size=(h, w, c)).astype(np.float32)


CASES = [(20, 13, 3, True), (37, 16, 3, False), (16, 9, 1, True),
         (33, 5, 4, False)]


@pytest.mark.parametrize("ext", [".pfm", ".exr", ".npy"])
@pytest.mark.parametrize("h,w,c,smooth", CASES)
def test_round_trip_across_packages(tmp_path, ext, h, w, c, smooth):
    img = _image(h, w, c, smooth)
    pt, pj = tmp_path / f"t{ext}", tmp_path / f"j{ext}"
    BT.write_image(str(pt), img)
    BJ.write_image(str(pj), img)
    assert pt.read_bytes() == pj.read_bytes()
    # PFM holds RGB or grey; the EXR reader returns RGB where it has it
    expect = img[..., :3] if ext != ".npy" and c >= 3 else img
    for path in (pt, pj):
        got = BT.read_image(str(path))
        ref = BJ.read_image(str(path))
        np.testing.assert_array_equal(got.data, ref.data)
        np.testing.assert_array_equal(got.data, expect)
        assert (got.width, got.height) == (w, h)


def test_write_image_takes_a_tensor(tmp_path):
    img = _image(8, 8, 3, True)
    BT.write_image(str(tmp_path / "a.exr"), torch.from_numpy(img))
    BJ.write_image(str(tmp_path / "b.exr"), img)
    assert (tmp_path / "a.exr").read_bytes() == \
        (tmp_path / "b.exr").read_bytes()


def _write_rgbe(path, raw, rle_rows):
    """RGBE bytes ``raw`` (H, W, 4) uint8, the rows in ``rle_rows``
    run-length encoded (new-style scanlines), the others flat."""
    h, w, _ = raw.shape
    out = [b"#?RADIANCE\n", b"FORMAT=32-bit_rle_rgbe\n", b"\n",
           f"-Y {h} +X {w}\n".encode()]
    for y in range(h):
        if y in rle_rows:
            out.append(bytes([2, 2, w >> 8, w & 255]))
            for c in range(4):
                row = raw[y, :, c]
                x = 0
                while x < w:        # alternate a run and a literal stretch
                    run = min(8, w - x)
                    if (x // 8) % 2 == 0:
                        out.append(bytes([128 + run, int(row[x])]))
                        raw[y, x:x + run, c] = row[x]
                    else:
                        out.append(bytes([run]) + row[x:x + run].tobytes())
                    x += run
        else:
            out.append(raw[y].tobytes())
    path.write_bytes(b"".join(out))


def test_hdr_read_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, size=(6, 21, 4)).astype(np.uint8)
    raw[..., 3] = rng.integers(120, 140, size=(6, 21))
    raw[0, 0, 3] = 0
    _write_rgbe(tmp_path / "a.hdr", raw, rle_rows={1, 4})
    got = BT.read_image(str(tmp_path / "a.hdr")).data
    np.testing.assert_array_equal(got, BJ.read_image(
        str(tmp_path / "a.hdr")).data)
    e = raw[..., 3].astype(np.int32)
    expect = raw[..., :3] * np.where(e > 0, np.ldexp(1.0, e - 136),
                                     0.0)[..., None]
    np.testing.assert_array_equal(got, expect.astype(np.float32))


@pytest.mark.skipif(not HAS_PIL, reason="PIL is not installed")
def test_png_across_packages(tmp_path):
    img = _image(12, 10, 3, True) / 3.0
    BT.write_image(str(tmp_path / "t.png"), img)
    BJ.write_image(str(tmp_path / "j.png"), img)
    a = BT.read_image(str(tmp_path / "t.png")).data
    b = BJ.read_image(str(tmp_path / "j.png")).data
    assert a.shape == (12, 10, 3)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(a, img, rtol=0, atol=0.02)


def test_unknown_format_raises(tmp_path):
    with pytest.raises(ValueError, match="format"):
        BT.write_image(str(tmp_path / "a.tiff"), np.zeros((2, 2, 3)))
    with pytest.raises(ValueError, match="format"):
        BT.read_image(str(tmp_path / "a.tiff"))


def test_bitmap_convert_equals_jax():
    img = _image(6, 7, 3, False) / 4.0
    for src_srgb, dst_srgb in ((False, True), (True, False)):
        got = BT.Bitmap(img, src_srgb).convert(dst_srgb)
        ref = BJ.Bitmap(img, src_srgb).convert(dst_srgb)
        assert got.srgb_gamma == ref.srgb_gamma == dst_srgb
        np.testing.assert_allclose(got.data, ref.data, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fn", ["luminance", "srgb_to_linear",
                                "linear_to_srgb"])
def test_colour_functions_equal_jax(fn):
    x = np.random.default_rng(2).uniform(-0.1, 1.2, (64, 3)).astype(
        np.float32)
    ref = np.asarray(getattr(SJ, fn)(x))
    got_np = getattr(ST, fn)(x)
    got_t = getattr(ST, fn)(torch.from_numpy(x))
    assert isinstance(got_np, np.ndarray) and isinstance(got_t, torch.Tensor)
    assert got_np.dtype == ref.dtype
    np.testing.assert_array_equal(got_np, got_t.numpy())
    np.testing.assert_allclose(got_np, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("temperature", [1500.0, 3000.0, 6500.0])
def test_blackbody_equals_jax(temperature):
    for norm in (False, True):
        np.testing.assert_array_equal(
            ST.blackbody_rgb(temperature, normalize=norm),
            SJ.blackbody_rgb(temperature, normalize=norm))
