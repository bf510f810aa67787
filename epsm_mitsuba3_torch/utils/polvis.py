"""Polarization visualization (counterpart of ``utils/polvis.py``; the
reference's src/python/python/polvis.py): false colour of a Stokes
image, S0 as luminance, the degree of linear or circular polarization
as a heat map, the angle of linear polarization as hue.  Numpy on the
host: pass ``render(..., integrator={"type": "stokes"})[..., 3::3]``
(the first channel of S0..S3) or any (H, W, 4) stack."""
from __future__ import annotations

import numpy as np


def polvis(stokes_img, mode: str = "dolp"):
    """``stokes_img``: (H, W, 4[+]) with channels (S0, S1, S2, S3).

    ``mode``: 's0', 'dolp' (degree of linear polarization), 'aolp'
    (angle of linear polarization, as hue) or 'docp' (degree of circular
    polarization).  Returns (H, W, 3) float32 in [0, 1] (S0 unclipped
    above)."""
    s = np.asarray(stokes_img, np.float32)
    s0 = np.maximum(s[..., 0], 1e-8)
    if mode == "s0":
        return np.clip(s[..., :1].repeat(3, -1), 0, None)
    if mode == "dolp":
        dolp = np.sqrt(s[..., 1] ** 2 + s[..., 2] ** 2) / s0
        return _colormap(np.clip(dolp, 0, 1))
    if mode == "docp":
        return _colormap(np.clip(np.abs(s[..., 3]) / s0, 0, 1))
    if mode == "aolp":
        ang = 0.5 * np.arctan2(s[..., 2], s[..., 1])  # [-pi/2, pi/2]
        hue = (ang / np.pi + 0.5) % 1.0
        return _hsv(hue, np.ones_like(hue),
                    np.clip(np.sqrt(s[..., 1] ** 2 + s[..., 2] ** 2) / s0,
                            0, 1))
    raise ValueError(f"unknown polvis mode '{mode}'")


def _colormap(x):
    """A blue-to-red heat map."""
    r = np.clip(1.5 * x - 0.25, 0, 1)
    g = np.clip(1.0 - np.abs(2 * x - 1.0), 0, 1) * 0.8
    b = np.clip(1.0 - 1.5 * x, 0, 1)
    return np.stack([r, g, b], -1)


def _hsv(h, s, v):
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.astype(np.int32) % 6
    out = np.zeros(h.shape + (3,), np.float32)
    for idx, (rr, gg, bb) in enumerate(
            [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
             (v, p, q)]):
        sel = i == idx
        out[sel, 0] = rr[sel]
        out[sel, 1] = gg[sel]
        out[sel, 2] = bb[sel]
    return out
