"""RGL measured BRDFs (counterpart of ``models/measured.py``, the
reference's src/bsdfs/measured.cpp: the Dupuy & Jakob 2018 adaptive
parameterisation in the ``tensor_file`` container, src/core/tensor.cpp).

On the host, once at load, in numpy: ``read_tensor_file`` parses the
container and ``bake`` turns the warped spectra into a dense isotropic
table f_r(theta_i, theta_o, phi_d) -> RGB (CIE-projected), un-warping
through the measured VNDF's marginal and conditional CDFs
(``_invert_marginal``) and weighting by ndf / (4 sigma); ``fit_ggx_alpha``
fits the roughness of the GGX visible-normal proxy that samples it.

On the device, ``eval_table`` is the trilinear lookup of the baked table
(a ``Texture`` of kind ``measured_brdf``: ``grid3d`` (Ti, To, Pd, 3),
``nodes`` the file's theta_i grid).  The BSDF (``models/bsdf.py``)
samples the proxy and divides by its pdf, so the estimator stays
unbiased whatever the fit.  Isotropic materials only (phi_i of at most
two entries, the whole RGL database); an anisotropic file raises at
load, as in the reference.
"""
from __future__ import annotations

import math
import struct
from typing import Dict

import numpy as np
import torch

from ..core import math as m
from ..core import spectral as sp

_DTYPES = {1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16,
           5: np.uint32, 6: np.int32, 7: np.uint64, 8: np.int64,
           9: np.float16, 10: np.float32, 11: np.float64}


def read_tensor_file(path: str) -> Dict[str, np.ndarray]:
    """Parse the RGL ``tensor_file`` container (tensor.cpp:7-52)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:12] != b"tensor_file\x00":
        raise ValueError(f"{path}: not a tensor_file")
    (n_fields,) = struct.unpack_from("<I", raw, 14)
    off = 18
    fields = {}
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<H", raw, off)
        off += 2
        name = raw[off:off + name_len].decode()
        off += name_len
        (ndim,) = struct.unpack_from("<H", raw, off)
        off += 2
        dtype = raw[off]
        off += 1
        (data_offset,) = struct.unpack_from("<Q", raw, off)
        off += 8
        shape = struct.unpack_from("<" + "Q" * ndim, raw, off)
        off += 8 * ndim
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(raw, _DTYPES[dtype], count=count,
                            offset=data_offset).reshape(shape)
        fields[name] = arr
    return fields


def write_tensor_file(path: str, fields: Dict[str, np.ndarray]) -> None:
    """Write ``fields`` as a ``tensor_file`` (the inverse of
    ``read_tensor_file``): uint8 arrays as uint8, every other as
    little-endian float32."""
    names = list(fields)
    header = b"tensor_file\x00" + bytes([1, 0]) + struct.pack("<I",
                                                              len(names))
    data_off = len(header) + sum(2 + len(n) + 2 + 1 + 8 + 8 * np.ndim(
        fields[n]) for n in names)
    blob, entries = b"", b""
    for n in names:
        a = np.asarray(fields[n])
        code = 1 if a.dtype == np.uint8 else 10
        a = a.astype(np.uint8 if code == 1 else "<f4")
        entries += struct.pack("<H", len(n)) + n.encode()
        entries += struct.pack("<H", a.ndim) + bytes([code])
        entries += struct.pack("<Q", data_off + len(blob))
        entries += struct.pack("<" + "Q" * a.ndim, *a.shape)
        blob += a.tobytes()
    with open(path, "wb") as f:
        f.write(header + entries + blob)


# --- angle <-> unit-square maps (measured.cpp theta2u/phi2u) ---------------

def _theta2u(theta):
    return np.sqrt(np.clip(theta, 0.0, None) * (2.0 / np.pi))


def _u2theta(u):
    return (u ** 2) * (np.pi / 2.0)


def _phi2u(phi):
    return (phi + np.pi) / (2.0 * np.pi)


def _bilinear(grid: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Bilinear lookup of grid[..., y, x] at continuous coords in [0,1]
    (node-centered: pos * (res-1), the Marginal2D convention)."""
    h, w = grid.shape[-2], grid.shape[-1]
    fx = np.clip(x, 0.0, 1.0) * (w - 1)
    fy = np.clip(y, 0.0, 1.0) * (h - 1)
    x0 = np.clip(np.floor(fx).astype(int), 0, w - 2) if w > 1 else 0
    y0 = np.clip(np.floor(fy).astype(int), 0, h - 2) if h > 1 else 0
    tx = fx - x0
    ty = fy - y0
    if w == 1:
        tx = 0.0 * fx
    if h == 1:
        ty = 0.0 * fy
    g = grid
    v00 = g[..., y0, x0]
    v10 = g[..., y0, np.minimum(x0 + 1, w - 1)]
    v01 = g[..., np.minimum(y0 + 1, h - 1), x0]
    v11 = g[..., np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)]
    return (v00 * (1 - tx) * (1 - ty) + v10 * tx * (1 - ty)
            + v01 * (1 - tx) * ty + v11 * tx * ty)


def _invert_marginal(vndf_slice: np.ndarray, pos_x: np.ndarray,
                     pos_y: np.ndarray, supersample: int = 8):
    """``Marginal2D<…, true>::invert`` semantics: map a position in the
    warped domain back to the uniform sample that produces it —
    sample_y = marginal CDF over rows at pos_y, sample_x = conditional
    CDF along the row at pos_x.  CDFs of the bilinear density are
    computed by trapezoid integration on a supersampled grid."""
    h, w = vndf_slice.shape
    hs, ws = h * supersample, w * supersample
    ys = np.linspace(0.0, 1.0, hs)
    xs = np.linspace(0.0, 1.0, ws)
    dens = _bilinear(vndf_slice, xs[None, :].repeat(hs, 0),
                     ys[:, None].repeat(ws, 1))          # (hs, ws)
    row_int = np.trapezoid(dens, xs, axis=1)             # (hs,)
    marg_cdf = np.concatenate(
        [[0.0], np.cumsum(0.5 * (row_int[1:] + row_int[:-1])
                          * np.diff(ys))])
    marg_cdf /= max(marg_cdf[-1], 1e-12)
    cond_cdf = np.concatenate(
        [np.zeros((hs, 1)),
         np.cumsum(0.5 * (dens[:, 1:] + dens[:, :-1]) * np.diff(xs),
                   axis=1)], axis=1)
    cond_cdf /= np.maximum(cond_cdf[:, -1:], 1e-12)

    shape = pos_x.shape
    px = np.clip(pos_x.reshape(-1), 0.0, 1.0)
    py = np.clip(pos_y.reshape(-1), 0.0, 1.0)
    sy = np.interp(py, ys, marg_cdf)
    yi = np.clip((py * (hs - 1)).round().astype(int), 0, hs - 1)
    fx = px * (ws - 1)
    xi = np.clip(np.floor(fx).astype(int), 0, ws - 2)
    t = fx - xi
    sx = cond_cdf[yi, xi] * (1 - t) + cond_cdf[yi, xi + 1] * t
    return sx.reshape(shape), sy.reshape(shape)


def _cie_project(spectra_vals: np.ndarray, wavelengths: np.ndarray):
    """Project per-wavelength reflectance (..., L) to linear sRGB with the
    same white-balanced weights the spectral pipeline uses."""
    ill = sp.illuminant_spd(wavelengths)
    xyz = sp.cie1931_xyz(wavelengths)                     # (L, 3)
    W = xyz * ill[:, None]
    W = W / np.maximum(W.sum(0, keepdims=True), 1e-9)
    M = W @ np.asarray(sp.XYZ_TO_SRGB, np.float64).T      # (L, 3)
    # white balance in sRGB, not XYZ: a FLAT reflectance spectrum must map
    # to gray (r=g=b=1), i.e. each output channel is normalized by its
    # response to the flat spectrum — without this, flat tables pick up a
    # (1.20, 0.95, 0.91) tint from the XYZ->sRGB row sums
    M = M / np.maximum(M.sum(0, keepdims=True), 1e-9)
    rgb = spectra_vals @ M
    return np.clip(rgb, 0.0, None)


def bake(path: str, n_theta_o: int = 32, n_phi_d: int = 32):
    """Load an RGL .bsdf file and bake the dense BRDF table.

    Returns (table (Ti, To, Pd, 3) float32 — f_r *without* cosine,
    theta_i grid (Ti,), ggx_alpha float).  θ axes use the theta2u sqrt
    warp (resolution concentrated near normal incidence)."""
    f = read_tensor_file(path)
    if f["phi_i"].shape[0] > 2:
        raise ValueError(f"{path}: anisotropic measured BRDFs unsupported")
    theta_i = np.asarray(f["theta_i"], np.float64)        # (Ti,)
    vndf = np.asarray(f["vndf"], np.float64)[0]           # (Ti, H, W)
    ndf = np.asarray(f["ndf"], np.float64)                # (H2, W2)
    sigma = np.asarray(f["sigma"], np.float64)            # (H3, W3)
    spectra = np.asarray(f["spectra"], np.float64)[0]     # (Ti, L, Hs, Ws)
    wavelengths = np.asarray(f["wavelengths"], np.float64)
    jac = bool(np.asarray(f["jacobian"]).reshape(-1)[0]) \
        if "jacobian" in f else True

    ti_n, L = spectra.shape[0], spectra.shape[1]
    u_to = (np.arange(n_theta_o) + 0.5) / n_theta_o
    u_pd = (np.arange(n_phi_d) + 0.5) / n_phi_d
    theta_o = _u2theta(u_to)                              # (To,)
    phi_d = u_pd * np.pi                                  # (Pd,) in [0, π]

    table = np.zeros((ti_n, n_theta_o, n_phi_d, 3), np.float32)
    for it in range(ti_n):
        ti = theta_i[it]
        wi = np.array([np.sin(ti), 0.0, np.cos(ti)])
        to, pd = np.meshgrid(theta_o, phi_d, indexing="ij")  # (To, Pd)
        wo = np.stack([np.sin(to) * np.cos(pd), np.sin(to) * np.sin(pd),
                       np.cos(to)], -1)
        mvec = wi[None, None] + wo
        mvec /= np.maximum(np.linalg.norm(mvec, axis=-1, keepdims=True),
                           1e-12)
        theta_m = np.arccos(np.clip(mvec[..., 2], -1, 1))
        phi_m = np.arctan2(mvec[..., 1], mvec[..., 0])
        # isotropic: vndf/spectra parameterized by φ_m - φ_i (φ_i = 0)
        um_x = _theta2u(theta_m)
        um_y = _phi2u(phi_m) % 1.0
        sx, sy = _invert_marginal(vndf[it], um_x, um_y)
        spec = np.stack([_bilinear(spectra[it, l], sx, sy)
                         for l in range(L)], -1)          # (To, Pd, L)
        if jac:
            nd = _bilinear(ndf, um_x, um_y)
            u_wi = np.full_like(um_x, _theta2u(ti))
            sg = _bilinear(sigma, u_wi, np.full_like(um_y, 0.5))
            spec = spec * (nd / np.maximum(4.0 * sg, 1e-12))[..., None]
        table[it] = _cie_project(spec, wavelengths)

    alpha = fit_ggx_alpha(ndf)
    return table, np.asarray(theta_i, np.float32), float(alpha)


def eval_table(tex, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The baked table ``tex.grid3d`` (Ti, To, Pd, 3) at the lanes'
    (theta_i, theta_o, phi_d), trilinear (``eval_table``, :208-258):
    f_r (N, 3) without the cosine, 0 below either horizon.  theta_i is
    looked up on the file's non-uniform ``tex.nodes``, theta_o on the
    sqrt warp's cells, phi_d (the azimuth difference, in [0, pi]) on
    uniform cells.  The arccos and square roots are ``core/math.py``'s
    safe forms: the same values, and a zero derivative where the plain
    ones' is infinite (normal incidence, coplanar wi and wo), which would
    turn a masked lane's zero cotangent into NaN."""
    cos_i = torch.clamp(wi[..., 2], -1.0, 1.0)
    cos_o = torch.clamp(wo[..., 2], -1.0, 1.0)
    theta_i = m.safe_acos(torch.abs(cos_i))
    theta_o = m.safe_acos(torch.abs(cos_o))
    pi_len = m.safe_sqrt(wi[..., 0] ** 2 + wi[..., 1] ** 2)
    po_len = m.safe_sqrt(wo[..., 0] ** 2 + wo[..., 1] ** 2)
    cos_pd = (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) \
        / torch.clamp(pi_len * po_len, min=1e-9)
    phi_d = m.safe_acos(cos_pd)
    phi_d = torch.where(torch.minimum(pi_len, po_len) < 1e-6, 0.0, phi_d)

    g = tex.grid3d
    nodes = tex.nodes.to(theta_i.dtype)
    n_ti, n_to, n_pd = g.shape[0], g.shape[1], g.shape[2]
    k = torch.clamp(torch.searchsorted(nodes, theta_i.contiguous()), 1,
                    n_ti - 1)
    lo, hi = nodes[k - 1], nodes[k]
    fz = (k - 1) + torch.clamp((theta_i - lo) / torch.clamp(hi - lo,
                                                             min=1e-9),
                               0.0, 1.0)
    fy = m.safe_sqrt(theta_o * (2.0 / math.pi)) * n_to - 0.5
    fx = (phi_d / math.pi) * n_pd - 0.5
    fz = torch.clamp(fz, 0.0, n_ti - 1.0)
    fy = torch.clamp(fy, 0.0, n_to - 1.0)
    fx = torch.clamp(fx, 0.0, n_pd - 1.0)
    z0 = torch.clamp(torch.floor(fz).long(), 0, max(n_ti - 2, 0))
    y0 = torch.clamp(torch.floor(fy).long(), 0, max(n_to - 2, 0))
    x0 = torch.clamp(torch.floor(fx).long(), 0, max(n_pd - 2, 0))
    tz = (fz - z0)[..., None]
    ty = (fy - y0)[..., None]
    tx = (fx - x0)[..., None]
    flat = g.reshape(-1, g.shape[-1])

    def at(zi, yi, xi):
        zi = torch.clamp(zi, 0, n_ti - 1)
        yi = torch.clamp(yi, 0, n_to - 1)
        xi = torch.clamp(xi, 0, n_pd - 1)
        return flat[(zi * n_to + yi) * n_pd + xi]

    c00 = at(z0, y0, x0) * (1 - tx) + at(z0, y0, x0 + 1) * tx
    c01 = at(z0, y0 + 1, x0) * (1 - tx) + at(z0, y0 + 1, x0 + 1) * tx
    c10 = at(z0 + 1, y0, x0) * (1 - tx) + at(z0 + 1, y0, x0 + 1) * tx
    c11 = at(z0 + 1, y0 + 1, x0) * (1 - tx) + at(z0 + 1, y0 + 1, x0 + 1) * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    out = c0 * (1 - tz) + c1 * tz
    ok = (cos_i > 0.0) & (cos_o > 0.0)
    return torch.where(ok[..., None], out, 0.0)


def fit_ggx_alpha(ndf: np.ndarray) -> float:
    """Fit a GGX roughness to the measured NDF (sampling proxy only):
    1-D log-space least squares over θ_m on the φ-averaged NDF."""
    h, w = ndf.shape
    u = (np.arange(w) + 0.5) / w
    theta = _u2theta(u)
    d_meas = np.maximum(ndf.mean(axis=0), 1e-12)
    d_meas = d_meas / d_meas.max()
    cos2 = np.cos(theta) ** 2
    tan2 = np.tan(theta) ** 2
    best, best_err = 0.1, np.inf
    for alpha in np.geomspace(0.005, 1.5, 120):
        a2 = alpha * alpha
        d = a2 / np.maximum(np.pi * (cos2 * (a2 + tan2)) ** 2, 1e-12)
        d = d / d.max()
        keep = d_meas > 1e-6
        err = np.mean((np.log(d[keep]) - np.log(d_meas[keep])) ** 2)
        if err < best_err:
            best, best_err = alpha, err
    return best
