"""Tonemapping (counterpart of ``utils/tonemap.py``;
src/python/python/tonemap.py): HDR to LDR on the host, as the logger's
encoder (numpy float32 in, numpy out)."""
from __future__ import annotations

import numpy as np


def _numpy(img):
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return np.asarray(img, np.float32)


def tonemap(img, method: str = "gamma", exposure: float = 0.0,
            gamma: float = 2.2):
    """``img`` (a tensor or an array) times 2^exposure through 'gamma'
    (clip to [0, 1], then 1 / gamma), 'reinhard' (x / (1 + x)) or
    'filmic' (the ACES fit), each followed by the 1 / gamma power."""
    x = _numpy(img) * (2.0 ** exposure)
    if method == "gamma":
        return np.clip(x, 0, 1) ** (1.0 / gamma)
    if method == "reinhard":
        return (x / (1.0 + x)) ** (1.0 / gamma)
    if method == "filmic":
        a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        y = np.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0, 1)
        return y ** (1.0 / gamma)
    raise ValueError(f"unknown tonemap '{method}'")
