"""Quadrature rules (counterpart of ``core/quad.py``, the reference's
include/mitsuba/core/quad.h): nodes and weights on [-1, 1], computed in
float64 with numpy and returned as float32 tensors on ``device``
(``None``: the GPU, as every entry point of the port)."""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def _out(x, w, device):
    device = resolve_device(device)
    return (torch.as_tensor(np.asarray(x, np.float32), device=device),
            torch.as_tensor(np.asarray(w, np.float32), device=device))


def gauss_legendre(n: int, device=None):
    """Gauss-Legendre nodes and weights (quad.h ``gauss_legendre``)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return _out(x, w, device)


def gauss_lobatto(n: int, device=None):
    """Gauss-Lobatto nodes and weights (quad.h ``gauss_lobatto``): the
    end points and the n - 2 roots of P'_{n-1}, the eigenvalues of the
    Jacobi matrix of the (1, 1) Jacobi polynomials."""
    if n < 2:
        raise ValueError("gauss_lobatto needs n >= 2")
    if n == 2:
        x = np.array([-1.0, 1.0])
    else:
        k = np.arange(1, n - 2)
        b = np.sqrt(k * (k + 2.0) / ((2 * k + 1) * (2 * k + 3)))
        interior = np.sort(np.linalg.eigvalsh(np.diag(b, 1) + np.diag(b, -1)))
        x = np.concatenate([[-1.0], interior, [1.0]])
    pn = np.polynomial.legendre.Legendre.basis(n - 1)(x)
    return _out(x, 2.0 / (n * (n - 1) * pn ** 2), device)


def composite_simpson(n: int, device=None):
    """Composite Simpson nodes and weights (quad.h); an even ``n`` takes
    one node more."""
    if n % 2 == 0:
        n += 1
    x = np.linspace(-1.0, 1.0, n)
    w = np.ones(n)
    w[1:-1:2] = 4.0
    w[2:-1:2] = 2.0
    return _out(x, w * (2.0 / (n - 1)) / 3.0, device)
