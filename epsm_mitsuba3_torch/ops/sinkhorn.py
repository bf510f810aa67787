"""Sinkhorn optimal-transport matcher (counterpart of ``ops/sinkhorn.py``,
the reference's ``EPSM/utils/matcher.py``).

The reference calls ``geomloss.SamplesLoss("sinkhorn", blur=0.01,
scaling=0.9)`` over 5-D points (r, g, b, x, y) and feeds d loss / d points
back through the renderer's 5-channel image.  Semantics, as the JAX
package's:

- cost C(x, y) = |x - y|^2 / 2;
- epsilon annealing: eps from the diameter^2 of the unit box down to
  blur^2, by the factor scaling^2 a step (a static schedule);
- the debiased divergence S = OT(a, b) - OT(a, a) / 2 - OT(b, b) / 2;
- the gradient by the envelope theorem: symmetric averaged updates with
  detached potentials, then one attached step, differentiated with
  ``torch.autograd.grad``.

The soft-min is blocked by rows and by columns with an online
log-sum-exp, so only a (block, jblock) tile of logits is live.  Its cross
term ``x @ y.T`` is a matmul run with TF32 off: at eps = 1e-4 an error of
1e-3 in x.y is 10 in a logit, about what TF32's 10-bit mantissa gives.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from ..core.device import resolve_device


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matmuls in full precision (no TF32) inside the block,
    whatever the global setting; the setting is restored after it."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _softmin(eps: float, x, y, g, block: Optional[int] = None,
             jblock: Optional[int] = None):
    """f_i = -eps * LSE_j(g_j / eps - |x_i - y_j|^2 / (2 eps))
    (``_softmin``, :31-80).

    The cost expands as |x|^2/2 + |y|^2/2 - x.y.  Rows go by ``block``,
    columns by ``jblock`` with a running max and sum; padded columns carry
    g = -inf, so their exp is exactly 0.  Blocks default to the
    reference's 4,096 on the GPU and to 1,024 on the CPU, where a 4,096^2
    tile (64 MB) leaves the caches and the soft-min runs 3x slower."""
    tile = 4096 if x.is_cuda else 1024
    block, jblock = block or tile, jblock or tile
    n, d = x.shape
    mtot = y.shape[0]
    mb = -(-mtot // jblock)
    padm = mb * jblock - mtot
    if padm:
        y = torch.cat([y, y.new_zeros((padm, d))], 0)
        g = torch.cat([g, g.new_full((padm,), -math.inf)], 0)
    yb = y.reshape(mb, jblock, d)
    y2b = 0.5 * torch.sum(yb * yb, -1)
    gb = g.reshape(mb, jblock)

    def row_block(xb):
        x2 = 0.5 * torch.sum(xb * xb, -1)
        mx = xb.new_full((xb.shape[0],), -math.inf)
        sm = xb.new_zeros((xb.shape[0],))
        for k in range(mb):
            logits = (gb[k][None, :] - y2b[k][None, :] - x2[:, None]
                      + xb @ yb[k].T) / eps
            new_mx = torch.maximum(mx, torch.amax(logits, 1))
            # exp(-inf - -inf) arises only if every logit so far is -inf,
            # which a finite g forbids on real columns
            sm = (sm * torch.exp(mx - new_mx)
                  + torch.sum(torch.exp(logits - new_mx[:, None]), 1))
            mx = new_mx
        return -eps * (mx + torch.log(sm))

    with full_f32_matmul():
        if n <= block:
            return row_block(x)
        return torch.cat([row_block(x[i:i + block])
                          for i in range(0, n, block)])


def eps_schedule(d: int, blur: float, scaling: float):
    """geomloss's ``scaling`` heuristic for p = 2: from the diameter^2 of
    the [0, 1]^d box down to blur^2 (:98-106)."""
    eps_start, eps_target = float(d), blur ** 2
    n_iters = max(2, int(math.ceil(math.log(eps_target / eps_start)
                                   / math.log(scaling ** 2))) + 1)
    eps_list = [max(eps_target, eps_start * (scaling ** 2) ** i)
                for i in range(n_iters)]
    eps_list[-1] = eps_target
    return eps_list


def sinkhorn_divergence_grad(x, y, blur: float = 0.01, scaling: float = 0.9):
    """The debiased Sinkhorn divergence S(x, y) and dS/dx for uniform
    weights (``sinkhorn_divergence_grad``, :83-141).  x (N, D) the moving
    points, y (M, D) the targets.  Returns (loss, grad_x (N, D))."""
    n, d = x.shape
    m_ = y.shape[0]
    log_a, log_b = -math.log(n), -math.log(m_)
    eps_list = eps_schedule(d, blur, scaling)
    xd, yd = x.detach(), y.detach()

    with torch.no_grad():
        f_x = x.new_zeros((n,))
        g_y = x.new_zeros((m_,))
        a_x = x.new_zeros((n,))    # the symmetric potential of OT(a, a)
        b_y = x.new_zeros((m_,))   # the symmetric potential of OT(b, b)
        for eps in eps_list:
            # symmetric (averaged) updates, all detached
            f_new = _softmin(eps, xd, yd, g_y + log_b)
            g_new = _softmin(eps, yd, xd, f_x + log_a)
            a_new = _softmin(eps, xd, xd, a_x + log_a)
            b_new = _softmin(eps, yd, yd, b_y + log_b)
            f_x = 0.5 * (f_x + f_new)
            g_y = 0.5 * (g_y + g_new)
            a_x = 0.5 * (a_x + a_new)
            b_y = 0.5 * (b_y + b_new)

    eps = eps_list[-1]
    # one attached step (the envelope theorem): x is attached only through
    # its own potential, S = <a, f> + <b, g> - <a, a_x> - <b, b_y>, and
    # grad_x OT(a, a)/2 = grad_x <a, a(x as first argument)> by symmetry
    x_att = xd.clone().requires_grad_(True)
    with torch.enable_grad():
        f_att = _softmin(eps, x_att, yd, g_y + log_b)
        a_att = _softmin(eps, x_att, xd, a_x + log_a)
        const = torch.mean(g_y) - torch.mean(b_y)
        loss = torch.mean(f_att) - torch.mean(a_att) + const
        (grad,) = torch.autograd.grad(loss, x_att)
    return loss.detach(), grad


class Matcher:
    """``Matcher`` (:144-178), API-compatible with EPSM/utils/matcher.py:
    the target positions are the (col, row) grid of a ``res``^2 image.
    ``device=None`` means the GPU; without CUDA that raises."""

    def __init__(self, res: int, blur: float = 0.01, scaling: float = 0.9,
                 device=None):
        self.resolution = res
        self.blur = blur
        self.scaling = scaling
        xs = torch.linspace(0.0, 1.0, res, dtype=torch.float32,
                            device=resolve_device(device))
        gx, gy = torch.meshgrid(xs, xs, indexing="ij")
        # matcher.py:15-18 orders (pos[1], pos[0]) = (col, row)
        self.pos = torch.stack([gy, gx], -1).reshape(-1, 2)
        # sliced-Wasserstein settings (matcher.py:21-24)
        self.num_vectors = 50
        self.num_principle_vectors = 3
        self.rgb_weight = 1.0

    def match_Sinkhorn(self, render_rgb, gt_rgb):
        """render_rgb, gt_rgb: (res^2, 3) -> the gradient (res^2, 5), scaled
        by res^2 (matcher.py:51-63)."""
        return _match_impl(render_rgb, gt_rgb, self.pos.to(render_rgb.device),
                           self.blur, self.scaling)

    def sliced_basis(self, gt_rgb, generator: Optional[torch.Generator] = None):
        """The sliced-Wasserstein matcher's random part: the target colours'
        principal basis V_pc (3, n_pc) (each column up to its sign) and
        ``num_vectors`` unit directions (d_feat, num_vectors) drawn from
        ``generator``."""
        return _sliced_basis(gt_rgb, self.pos.to(gt_rgb.device),
                             self.num_vectors, self.num_principle_vectors,
                             self.rgb_weight, generator)

    def match_sliced_wasserstein(self, render_rgb, gt_rgb,
                                 generator: Optional[torch.Generator] = None,
                                 basis=None):
        """The sliced-Wasserstein alternative (matcher.py:76-180): the 5-D
        clouds projected on random directions, both projections sorted,
        L2 between the sorted sequences; the gradient routes through the
        sort.  ``basis``: (V_pc, dirs) from ``sliced_basis``, drawn here
        from ``generator`` when None.  Returns (res^2, 5)."""
        if basis is None:
            basis = self.sliced_basis(gt_rgb, generator)
        return _sliced_wasserstein_grad(render_rgb, gt_rgb,
                                        self.pos.to(render_rgb.device),
                                        *basis, self.rgb_weight)


def _features(p5, V_pc):
    if V_pc is None:
        return p5
    with full_f32_matmul():
        return torch.cat([p5[:, :3] @ V_pc, p5[:, 3:]], -1)


def _sliced_basis(gt_rgb, pos, num_vectors, n_pc, rgb_weight, generator):
    """PCA of the target colours (the ``torch.pca_lowrank`` analog) and the
    random unit directions (``_sliced_wasserstein_impl``, :195-214)."""
    target5 = torch.cat([torch.clamp(gt_rgb, 0.0, 1.0) * rgb_weight, pos], -1)
    V_pc = None
    if n_pc > 0:
        xc = target5[:, :3] - torch.mean(target5[:, :3], 0)
        _, _, vt = torch.linalg.svd(xc, full_matrices=False)
        V_pc = vt[:n_pc].T.detach()                      # (3, n_pc)
    d_feat = (n_pc if n_pc > 0 else 3) + 2
    dirs = torch.rand((d_feat, num_vectors), generator=generator,
                      dtype=gt_rgb.dtype,
                      device=generator.device if generator is not None
                      else gt_rgb.device) * 2.0 - 1.0
    dirs = dirs.to(gt_rgb.device)
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=0, keepdim=True),
                              min=1e-8)
    return V_pc, dirs


def _sliced_wasserstein_grad(render_rgb, gt_rgb, pos, V_pc, dirs,
                             rgb_weight):
    """The gradient of sum_k sum_i (sort(P_r V)_ik - sort(P_t V)_ik)^2 with
    respect to the rendered 5-D points, given the basis and directions
    (:216-222)."""
    target5 = torch.cat([torch.clamp(gt_rgb, 0.0, 1.0) * rgb_weight, pos], -1)
    render5 = torch.cat([torch.clamp(render_rgb, 0.0, 1.0) * rgb_weight,
                         pos], -1).detach().requires_grad_(True)
    with torch.enable_grad(), full_f32_matmul():
        proj_t = torch.sort(_features(target5, V_pc) @ dirs, dim=0).values
        proj_r = torch.sort(_features(render5, V_pc) @ dirs, dim=0).values
        loss = torch.sum((proj_r - proj_t.detach()) ** 2)
        (g,) = torch.autograd.grad(loss, render5)
    return torch.cat([g[:, :3] / rgb_weight, g[:, 3:]], -1)


def _match_impl(render_rgb, gt_rgb, pos, blur, scaling):
    n = render_rgb.shape[0]
    render5 = torch.cat([torch.clamp(render_rgb, 0.0, 1.0), pos], -1)
    target5 = torch.cat([torch.clamp(gt_rgb, 0.0, 1.0), pos], -1)
    _, g = sinkhorn_divergence_grad(render5, target5, blur, scaling)
    return g * n
