"""Measured polarized BSDFs, pBSDF tables (counterpart of
``models/measured_polarized.py``; src/bsdfs/measured_polarized.cpp).

The reference plugin reads a tensor file with the fields

    theta_h (1, Nh) f32   half-angle nodes
    theta_d (1, Nd) f32   difference-angle nodes
    phi_d   (1, Np) f32   azimuth-difference nodes
    wvls    (Nw,)   u16   measured wavelengths (nm)
    M  (Np, Nd, Nh, Nw, 4, 4) f32   a Mueller matrix per Rusinkiewicz bin

(measured_polarized.cpp:127-175), interpolates the 4 x 4 Mueller matrix
in (phi_d, theta_d, theta_h, wavelength) and rotates its Stokes frames
from the measurement frame (in the plane of reflection, Baek et al.
Fig. 4) to the renderer's implicit bases (eval, :214-320).

On the host, once at load, in numpy: ``bake`` reduces the wavelength
axis to RGB with the CIE projection of ``models/measured.py`` (or to one
interpolated wavelength, broadcast to the three channels).  On the
device the lookup is a trilinear interpolation of the (Np, Nd, Nh, 16,
3) grid, a ``Texture`` of kind ``pbsdf``.  Sampling reads nothing of the
table: the BSDF samples the reference's cosine + GGX(alpha_sample)
mixture (``models/bsdf.py``).  ``synthesize_tensor_file`` writes a table,
so the tests and ``chip_smoke.py`` make theirs without a download.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..core import math as m
from ..core import mueller as mu
from .measured import _cie_project, read_tensor_file


# ---------------------------------------------------------------------------
# loading and baking
# ---------------------------------------------------------------------------

def bake(path: str, wavelength: float = -1.0):
    """Read a .pbsdf tensor file and reduce its wavelength axis (``bake``,
    :44-77).  Returns numpy (grid (Np, Nd, Nh, 16, 3) float32, the 4 x 4
    entries row-major; phi_d, theta_d, theta_h nodes): the CIE projection
    where ``wavelength`` < 0, else the table at that wavelength (linear
    between its neighbours, clamped) in every channel."""
    f = read_tensor_file(path)
    for k in ("theta_h", "theta_d", "phi_d", "wvls", "M"):
        if k not in f:
            raise ValueError(f"{path}: missing pBSDF field '{k}'")
    th = np.asarray(f["theta_h"], np.float32).reshape(-1)
    td = np.asarray(f["theta_d"], np.float32).reshape(-1)
    pd = np.asarray(f["phi_d"], np.float32).reshape(-1)
    wvls = np.asarray(f["wvls"], np.float64).reshape(-1)
    M = np.asarray(f["M"], np.float32)
    if M.shape != (pd.size, td.size, th.size, wvls.size, 4, 4):
        raise ValueError(f"{path}: M shape {M.shape} inconsistent with grids")
    # the reference stores invalid bins as NaN (:283) and kills the lanes
    # whose interpolated M00 is NaN; zeroed here, as the JAX package does,
    # so the interpolation cannot spread them
    M = np.nan_to_num(M, nan=0.0, posinf=0.0, neginf=0.0)
    spectra = np.moveaxis(M, 3, -1)                   # (Np, Nd, Nh, 4, 4, Nw)
    if wavelength < 0:
        rgb = _cie_project(spectra, wvls)             # (Np, Nd, Nh, 4, 4, 3)
    else:
        w = np.clip(wavelength, wvls[0], wvls[-1])
        k = int(np.clip(np.searchsorted(wvls, w), 1, wvls.size - 1))
        t = (w - wvls[k - 1]) / max(wvls[k] - wvls[k - 1], 1e-9)
        mono = spectra[..., k - 1] * (1 - t) + spectra[..., k] * t
        rgb = np.repeat(mono[..., None], 3, axis=-1)
    grid = rgb.reshape(pd.size, td.size, th.size, 16, 3).astype(np.float32)
    return grid, pd, td, th


def synthesize_tensor_file(path: str, grid: np.ndarray, phi_d: np.ndarray,
                           theta_d: np.ndarray, theta_h: np.ndarray,
                           wvls: np.ndarray) -> None:
    """Write a pBSDF tensor file (the reference's TensorFile container,
    tensor.cpp; ``synthesize_tensor_file``, :80-117): ``grid`` is M
    (Np, Nd, Nh, Nw, 4, 4), ``wvls`` the wavelengths in nm."""
    fields = {
        "theta_h": np.asarray(theta_h, np.float32).reshape(1, -1),
        "theta_d": np.asarray(theta_d, np.float32).reshape(1, -1),
        "phi_d": np.asarray(phi_d, np.float32).reshape(1, -1),
        "wvls": np.asarray(wvls, np.uint16).reshape(-1),
        "M": np.asarray(grid, np.float32),
    }
    dtype_code = {np.dtype(np.float32): 10, np.dtype(np.uint16): 3}
    header = b"tensor_file\x00" + struct.pack("<BB", 1, 0)
    body = struct.pack("<I", len(fields))
    entry_sz = sum(2 + len(k.encode()) + 2 + 1 + 8 + 8 * v.ndim
                   for k, v in fields.items())
    off = 18 + entry_sz
    entries, blobs = [], b""
    for k, v in fields.items():
        name = k.encode()
        entries.append(struct.pack("<H", len(name)) + name
                       + struct.pack("<H", v.ndim)
                       + bytes([dtype_code[v.dtype]])
                       + struct.pack("<Q", off)
                       + struct.pack("<" + "Q" * v.ndim, *v.shape))
        blobs += v.tobytes()
        off += v.nbytes
    with open(path, "wb") as fh:
        fh.write(header + body + b"".join(entries) + blobs)


def texture_arrays(grid: np.ndarray, pd: np.ndarray, td: np.ndarray,
                   th: np.ndarray):
    """The ``pbsdf`` texture's (grid3d (Np, Nd, Nh, 48), nodes) of a baked
    table (JAX models/scene.py:445-450)."""
    npd, ntd, nth = grid.shape[:3]
    return (grid.reshape(npd, ntd, nth, 48),
            np.concatenate([pd, td, th]).astype(np.float32))


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _rotate_z(v: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Vectors rotated about +z by ``angle`` (rotate_vector, :357-363)."""
    c, s = torch.cos(angle), torch.sin(angle)
    x = v[..., 0] * c - v[..., 1] * s
    y = v[..., 0] * s + v[..., 1] * c
    return torch.stack([x, y, v[..., 2]], -1)


def _rusinkiewicz(i: torch.Tensor, o: torch.Tensor):
    """(phi_d, theta_h, theta_d) of the direction pair (i, o)
    (directions_to_rusinkiewicz, :367-385)."""
    h = m.normalize(i + o, 1e-12)
    n = torch.zeros_like(h)
    n[..., 2] = 1.0
    b = m.normalize(m.cross(n, h), 1e-9)
    t = m.normalize(m.cross(b, h), 1e-9)
    td = m.safe_acos(torch.clamp(m.dot(h, i), -1.0, 1.0))
    th = m.safe_acos(torch.clamp(h[..., 2], -1.0, 1.0))
    i_prj = m.normalize(i - m.dot(i, h, keepdim=True) * h, 1e-9)
    cos_pd = torch.clamp(m.dot(t, i_prj), -1.0, 1.0)
    sin_pd = torch.clamp(m.dot(b, i_prj), -1.0, 1.0)
    return torch.atan2(sin_pd, cos_pd), th, td


def _axis_coord(nodes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The fractional index of ``x`` on an ascending node vector."""
    n = nodes.shape[0]
    if n == 1:
        return torch.zeros_like(x)
    k = torch.clamp(torch.searchsorted(nodes, x.contiguous()), 1, n - 1)
    lo, hi = nodes[k - 1], nodes[k]
    f = (k - 1) + torch.clamp((x - lo) / torch.clamp(hi - lo, min=1e-9),
                              0.0, 1.0)
    return torch.clamp(f, 0.0, n - 1.0)


def eval_grid(tex, pd: torch.Tensor, th: torch.Tensor,
              td: torch.Tensor) -> torch.Tensor:
    """The baked grid, trilinear at (phi_d, theta_d, theta_h): (N, 4, 4,
    3) (``eval_grid``, :155-187)."""
    g = tex.grid3d
    npd, ntd, nth = g.shape[0], g.shape[1], g.shape[2]
    flat = g.reshape(npd * ntd * nth, -1)
    nodes = tex.nodes
    fx = _axis_coord(nodes[:npd], pd)
    fy = _axis_coord(nodes[npd:npd + ntd], td)
    fz = _axis_coord(nodes[npd + ntd:npd + ntd + nth], th)
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, max(npd - 2, 0))
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, max(ntd - 2, 0))
    z0 = torch.clamp(torch.floor(fz).to(torch.int64), 0, max(nth - 2, 0))
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    tz = (fz - z0)[..., None]

    def at(xi, yi, zi):
        xi = torch.clamp(xi, 0, npd - 1)
        yi = torch.clamp(yi, 0, ntd - 1)
        zi = torch.clamp(zi, 0, nth - 1)
        return flat[(xi * ntd + yi) * nth + zi]

    c00 = at(x0, y0, z0) * (1 - tx) + at(x0 + 1, y0, z0) * tx
    c10 = at(x0, y0 + 1, z0) * (1 - tx) + at(x0 + 1, y0 + 1, z0) * tx
    c01 = at(x0, y0, z0 + 1) * (1 - tx) + at(x0 + 1, y0, z0 + 1) * tx
    c11 = at(x0, y0 + 1, z0 + 1) * (1 - tx) + at(x0 + 1, y0 + 1, z0 + 1) * tx
    c0 = c00 * (1 - ty) + c10 * ty
    c1 = c01 * (1 - ty) + c11 * ty
    out = c0 * (1 - tz) + c1 * tz                     # (N, 48)
    return out.reshape(out.shape[0], 4, 4, 3)


def _table_frame(wi, wo):
    """(phi_std, wo_std, wi_std): the pair rotated about z so that wi lies
    in the xz half-plane (:296-298)."""
    phi_std = torch.atan2(wi[..., 1], wi[..., 0])
    return phi_std, _rotate_z(wo, -phi_std), _rotate_z(wi, -phi_std)


def eval_m00(tex, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The unpolarized lobe f_r(wi, wo) (N, 3), without the cosine: the
    scalar pipeline's view of the pBSDF (eval's M00, :296-316)."""
    _, wo_std, wi_std = _table_frame(wi, wo)
    M = eval_grid(tex, *_rusinkiewicz(wo_std, wi_std))
    m00 = torch.clamp(M[:, 0, 0, :], min=0.0)
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(ok[..., None], m00, 0.0)


def eval_mueller_frames(tex, wi: torch.Tensor, wo: torch.Tensor):
    """The pBSDF's Mueller matrix with its measurement Stokes frames, in
    the local shading frame (eval's polarized branch, :243-299): (M (N,
    4, 4, 3), xo_hat (N, 3), xi_hat (N, 3), valid (N,)).  The frames lie
    in the plane of reflection for light arriving along -wo and leaving
    along +wi; the caller rotates M from (xo_hat, xi_hat) to its own
    bases."""
    phi_std, wo_std, wi_std = _table_frame(wi, wo)
    M = eval_grid(tex, *_rusinkiewicz(wo_std, wi_std))
    M = M.clone()
    M[:, 0, 0, :] = torch.clamp(M[:, 0, 0, :], min=0.0)
    zo = -wo_std
    to = m.normalize(m.cross(wo_std - wi_std, zo), 1e-9)
    yo = m.normalize(m.cross(to, zo), 1e-9)
    xo = m.cross(yo, zo)
    zi = wi_std
    ti = m.normalize(m.cross(wi_std - wo_std, zi), 1e-9)
    yi = m.normalize(m.cross(ti, zi), 1e-9)
    xi = m.cross(yi, zi)
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    # the frames rotated back from the phi_std alignment (:289-291)
    return M, _rotate_z(xo, phi_std), _rotate_z(xi, phi_std), ok


def eval_mueller_local(tex, wi: torch.Tensor, wo: torch.Tensor):
    """The Mueller matrix in the implicit Stokes bases of the local
    directions (-wo in, +wi out): (M (N, 4, 4, 3), valid (N,))."""
    M, xo_hat, xi_hat, ok = eval_mueller_frames(tex, wi, wo)
    in_fwd, out_fwd = -wo, wi
    M = mu.rotate_mueller_basis(
        M, in_fwd, xo_hat, mu.stokes_basis(in_fwd),
        out_fwd, xi_hat, mu.stokes_basis(out_fwd))
    return M, ok
