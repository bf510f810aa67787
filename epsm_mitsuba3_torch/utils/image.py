"""Image utilities (counterpart of ``utils/image.py``; mi.util):
``convert_to_bitmap``, ``write_bitmap``, and the per-pixel Z-test of the
reference's render regression harness (test_renders.py:160-233), fed by
the ``moment`` integrator (``render_z_test``).  The statistics run on the
host in float64 numpy."""
from __future__ import annotations

import numpy as np
import torch

from ..core.bitmap import write_image
from ..core.device import resolve_device
from ..core.spectrum import to_bitmap_u8
from ..integrators import aov
from .tonemap import _numpy


def convert_to_bitmap(img, uint8_srgb: bool = True):
    """HDR linear -> sRGB uint8 (mi.util.convert_to_bitmap); with
    ``uint8_srgb`` False, the float32 array as it is."""
    arr = _numpy(img)
    if not uint8_srgb:
        return arr
    return np.asarray(to_bitmap_u8(arr))


def write_bitmap(path, img):
    write_image(path, _numpy(img))


def _f64(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _two_sided_p(z: np.ndarray) -> np.ndarray:
    """2 * the standard normal's upper tail at ``z`` >= 0, float64."""
    return torch.special.erfc(torch.from_numpy(z / np.sqrt(2.0))).numpy()


def z_test(mean, variance, reference, sample_count: int,
           significance: float = 0.01):
    """Per-pixel Z-test of ``mean`` against ``reference`` with the
    per-sample ``variance`` over ``sample_count`` samples, Sidak-corrected
    over the pixels.  Returns (passed, the least p-value, the fraction of
    pixels that fail)."""
    mean, reference = _f64(mean), _f64(reference)
    variance = np.maximum(_f64(variance), 1e-8)
    z = np.abs(mean - reference) * np.sqrt(sample_count / variance)
    p = _two_sided_p(z)
    alpha = 1.0 - (1.0 - significance) ** (1.0 / p.size)
    fails = (p < alpha).mean()
    return bool((p >= alpha).all()), float(p.min()), float(fails)


def render_z_test(scene, spp: int = 64, seed: int = 0, max_depth: int = 4,
                  reference=None, significance: float = 0.01, device=None):
    """Render the mean and the per-sample variance (Bessel-corrected) with
    ``moment`` in one pass; without ``reference`` return them (numpy), or
    Z-test the mean against ``reference`` with half the sample count (a
    same-spp reference doubles the difference's variance).  ``device=None``
    means the GPU and raises without CUDA; the scene must live on the
    device the call names."""
    device = resolve_device(device)
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, render_z_test was "
                         f"asked to run on {device}")
    img6 = _numpy(aov.render_moment(scene, seed=seed, spp=spp,
                                    max_depth=max_depth))
    mean = img6[..., :3]
    var = np.maximum(img6[..., 3:] - mean ** 2, 0.0) * spp / max(spp - 1, 1)
    if reference is None:
        return mean, var
    return z_test(mean, var, reference, spp // 2, significance)
