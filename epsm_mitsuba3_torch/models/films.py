"""Film accumulation (counterpart of ``models/films.py``): the
reconstruction filters, and three ways of putting samples on the hdrfilm.

* ``accumulate_coalesced``: the box filter on the pixel-major lane order
  (lane = pixel * spp + s), a reshape and a mean.
* ``splat``: the general scatter of each sample through its K x K filter
  footprint (``index_add_``), for positions anywhere on the film.
* ``splat_coalesced``: the same sums for pixel-major lanes without a
  scatter: a per-pixel sum for each footprint offset, moved into place by
  a roll.  It uses no atomics, so it is deterministic on the GPU too.

``develop`` divides by the weight channel; ``kahan_add`` is one step of
the compensated sum of sequential passes.
"""
from __future__ import annotations

import math

import torch

#: each filter's radius in pixels (src/rfilters/*.cpp)
_FILTER_RADIUS = {"box": 0.5, "tent": 1.0, "gaussian": 2.0,
                  "mitchell": 2.0, "catmullrom": 2.0, "lanczos": 3.0}
#: the filters the port has
FILTERS = tuple(_FILTER_RADIUS)
#: the gaussian's -1 / (2 stddev^2) at stddev 0.5, and its value at the
#: radius, subtracted so that it falls to 0 there (float32 exp)
_GAUSS_ALPHA = -1.0 / (2.0 * 0.5 * 0.5)
_GAUSS_FLOOR = float(torch.exp(torch.tensor(_GAUSS_ALPHA * 4.0)))


def filter_eval(kind: str, x: torch.Tensor) -> torch.Tensor:
    """Reconstruction filter weight at offset ``x`` (src/rfilters/*.cpp)."""
    ax = torch.abs(x)
    if kind == "box":
        return (ax <= 0.5).to(x.dtype)
    if kind == "tent":
        return torch.clamp(1.0 - ax, min=0.0)
    if kind == "gaussian":
        return torch.clamp(torch.exp(_GAUSS_ALPHA * x * x) - _GAUSS_FLOOR,
                           min=0.0)
    if kind in ("mitchell", "catmullrom"):
        b, c = (1 / 3, 1 / 3) if kind == "mitchell" else (0.0, 0.5)
        x2 = ax * ax
        x3 = x2 * ax
        y1 = ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2
              + (6 - 2 * b))
        y2 = ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2
              + (-12 * b - 48 * c) * ax + (8 * b + 24 * c))
        r = torch.where(ax < 1.0, y1, torch.where(ax < 2.0, y2, 0.0))
        return r * (1.0 / 6.0)
    if kind == "lanczos":
        a = 3.0
        pix = math.pi * ax
        r = torch.where(
            ax < 1e-4, 1.0,
            a * torch.sin(pix) * torch.sin(pix / a)
            / torch.clamp(pix * pix, min=1e-12))
        return torch.where(ax < a, r, 0.0)
    raise ValueError(f"unknown rfilter {kind}")


def accumulate_coalesced(values: torch.Tensor, width: int, height: int,
                         spp: int) -> torch.Tensor:
    """Box-filter accumulation for lane = pixel * spp + s.  Returns the
    (H, W, C) per-pixel mean."""
    c = values.shape[-1]
    return values.reshape(height, width, spp, c).mean(dim=2)


def splat(pos: torch.Tensor, values: torch.Tensor, width: int, height: int,
          rfilter: str = "gaussian"):
    """ImageBlock::put for samples anywhere on the film
    (imageblock.cpp:119-126).

    ``pos``: (N, 2) continuous film coordinates (x, y) in pixels.  Sample
    s adds ``w = f(px + 0.5 - x) f(py + 0.5 - y)`` to each pixel of its
    footprint, ``w * value`` to the data and ``w`` to the weight
    channel.  A footprint pixel outside
    the film adds weight 0 to a clamped index, as the reference does.
    Returns (data (H, W, C), weight (H, W)).  On the GPU ``index_add_``
    sums with float atomics, so the last bits vary from run to run."""
    radius = _FILTER_RADIUS[rfilter]
    k = max(1, int(2 * radius))
    c = values.shape[-1]
    x, y = pos[..., 0], pos[..., 1]
    x0 = torch.floor(x - radius + 0.5).to(torch.int64)
    y0 = torch.floor(y - radius + 0.5).to(torch.int64)
    data = torch.zeros((height * width, c), dtype=values.dtype,
                       device=values.device)
    wsum = torch.zeros((height * width,), dtype=values.dtype,
                       device=values.device)
    for dy in range(k):
        py = y0 + dy
        wy = filter_eval(rfilter, py.to(values.dtype) + 0.5 - y)
        in_y = (py >= 0) & (py < height)
        row = torch.clamp(py, 0, height - 1) * width
        for dx in range(k):
            px = x0 + dx
            wx = filter_eval(rfilter, px.to(values.dtype) + 0.5 - x)
            in_b = in_y & (px >= 0) & (px < width)
            w = torch.where(in_b, wx * wy, 0.0)
            idx = row + torch.clamp(px, 0, width - 1)
            data = data.index_add(0, idx, w[..., None] * values)
            wsum = wsum.index_add(0, idx, w)
    return data.reshape(height, width, c), wsum.reshape(height, width)


def splat_coalesced(jitter: torch.Tensor, values: torch.Tensor, width: int,
                    height: int, spp: int, rfilter: str = "gaussian"):
    """``splat`` for the pixel-major lane order (lane = pixel * spp + s,
    splat position = pixel + ``jitter``), without a scatter.

    Each sample's footprint is a fixed pattern of pixel offsets: for each
    offset (ox, oy) the samples' weighted values are summed per pixel (a
    reshape and a sum) and the image is moved by (oy, ox), the wrapped
    rows and columns zeroed.  ``(2 * ceil(radius - 0.5) + 1)^2`` offsets,
    each a handful of launches; the same sums as ``splat`` up to
    rounding.  Returns (data (H, W, C), weight (H, W))."""
    radius = _FILTER_RADIUS[rfilter]
    k = max(1, int(2 * radius))
    c = values.shape[-1]
    jx = jitter[..., 0].reshape(height, width, spp)
    jy = jitter[..., 1].reshape(height, width, spp)
    vals = values.reshape(height, width, spp, c)
    # the top-left covered pixel's offset from the sample's own pixel
    x0 = torch.floor(jx - radius + 0.5)
    y0 = torch.floor(jy - radius + 0.5)
    data = torch.zeros((height, width, c), dtype=values.dtype,
                       device=values.device)
    wsum = torch.zeros((height, width), dtype=values.dtype,
                       device=values.device)
    offsets = range(math.floor(0.5 - radius), math.ceil(radius - 0.5) + 1)
    # a filter weight depends on its own axis' offset only
    wxs = {ox: torch.where((x0 <= ox) & (ox <= x0 + (k - 1)),
                           filter_eval(rfilter, ox + 0.5 - jx), 0.0)
           for ox in offsets}
    for oy in offsets:
        wy = torch.where((y0 <= oy) & (oy <= y0 + (k - 1)),
                         filter_eval(rfilter, oy + 0.5 - jy), 0.0)
        for ox in offsets:
            w = wxs[ox] * wy
            # pixel p receives from the samples of pixel p - (ox, oy)
            contrib = torch.roll(torch.sum(w[..., None] * vals, dim=2),
                                 (oy, ox), dims=(0, 1))
            wacc = torch.roll(torch.sum(w, dim=2), (oy, ox), dims=(0, 1))
            for img in (contrib, wacc):
                _zero_wrapped(img, oy, ox)
            data = data + contrib
            wsum = wsum + wacc
    return data, wsum


def _zero_wrapped(img: torch.Tensor, oy: int, ox: int) -> None:
    """Zero, in place, the rows and columns that a roll by (oy, ox)
    wrapped around the film's border."""
    if oy > 0:
        img[:oy] = 0.0
    elif oy < 0:
        img[oy:] = 0.0
    if ox > 0:
        img[:, :ox] = 0.0
    elif ox < 0:
        img[:, ox:] = 0.0


def develop(data: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weight division (film develop); zero-weight pixels stay zero."""
    w = torch.where(weight > 0.0, weight, 1.0)
    return data / w[..., None]


def kahan_add(acc: torch.Tensor, comp: torch.Tensor, x: torch.Tensor):
    """One Kahan (compensated) summation step: returns (acc', comp')."""
    y = x - comp
    t = acc + y
    comp = (t - acc) - y
    return t, comp
