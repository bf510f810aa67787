"""The port's Sinkhorn matcher and the loop's resize against the JAX
package's (``ops/sinkhorn.py``, ``app/optim.py`` ``_resize``).

Tolerances, each with its reason:

- ``_softmin``: within 1e-5 relative (float32 log-sum-exp; the cross
  term's 5-term dot products summed in another order);
- the divergence within 5e-5 relative, its gradient and
  ``match_Sinkhorn`` within 5e-3 of the largest entry: 53 annealing
  steps end at eps = 1e-4, where a rounding difference of 1e-7 in a
  potential is 1e-3 in a logit, so float32 itself is that far from the
  exact result: against the port in float64, JAX's gradient was 2.3e-3
  of the largest entry away and the port's 3.3e-3 (256 points).  The test
  also holds the port's float32 gradient within 5e-3 of its float64 one;
- the sliced-Wasserstein gradient, given JAX's basis and directions,
  within 1e-4 of the largest entry (sums over sorted projections); the
  port's own basis equals JAX's up to each column's sign (SVD columns have
  arbitrary signs in both) within 1e-5;
- ``_resize``: within 1e-6 (separable float32 weights, the same
  formula).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from epsm_mitsuba3_tpu.app import optim as optim_j
from epsm_mitsuba3_tpu.ops import sinkhorn as SJ

from epsm_mitsuba3_torch.app import optim as optim_t
from epsm_mitsuba3_torch.ops import sinkhorn as ST
from torch_threads import one_torch_thread  # noqa: F401


def _points(seed, n, d=5):
    r = np.random.default_rng(seed)
    return r.random((n, d)).astype(np.float32)


@pytest.mark.parametrize("n,m,block,jblock", [
    (200, 150, 64, 48),      # rows and columns padded
    (96, 96, 4096, 4096),    # one tile
    (130, 257, 128, 64),     # a last row block of 2, columns padded
])
@pytest.mark.parametrize("eps", [5.0, 1e-2, 1e-4])
def test_softmin_matches_jax(n, m, block, jblock, eps):
    x, y = _points(1, n), _points(2, m)
    g = np.random.default_rng(3).normal(size=m).astype(np.float32) * 0.1
    ref = np.asarray(SJ._softmin(eps, jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(g), block, jblock))
    got = ST._softmin(eps, torch.from_numpy(x), torch.from_numpy(y),
                      torch.from_numpy(g), block, jblock).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_eps_schedule_is_the_reference_one():
    assert len(ST.eps_schedule(5, 0.01, 0.9)) == 53
    eps = ST.eps_schedule(5, 0.01, 0.9)
    assert eps[0] == 5.0 and eps[-1] == pytest.approx(1e-4)


@pytest.mark.parametrize("seed", [4, 6])
def test_divergence_and_gradient_match_jax(seed):
    """150 moving points against 190 targets (one JAX compile for both
    cases)."""
    x, y = _points(seed, 150), _points(seed + 1, 190)
    lj, gj = jax.jit(SJ.sinkhorn_divergence_grad)(jnp.asarray(x),
                                                  jnp.asarray(y))
    lt, gt = ST.sinkhorn_divergence_grad(torch.from_numpy(x),
                                         torch.from_numpy(y))
    np.testing.assert_allclose(float(lt), float(lj), rtol=5e-5)
    gj = np.asarray(gj)
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                               atol=5e-3 * np.abs(gj).max())
    l64, g64 = ST.sinkhorn_divergence_grad(torch.from_numpy(x).double(),
                                           torch.from_numpy(y).double())
    g64 = g64.numpy()
    np.testing.assert_allclose(float(lt), float(l64), rtol=5e-5)
    np.testing.assert_allclose(gt.numpy(), g64, rtol=0,
                               atol=5e-3 * np.abs(g64).max())


def test_match_sinkhorn_matches_jax():
    res = 16
    r = np.random.default_rng(6)
    render = (r.random((res * res, 3)) * 1.2).astype(np.float32)
    gt = (r.random((res * res, 3)) * 0.9).astype(np.float32)
    gj = np.asarray(SJ.Matcher(res).match_Sinkhorn(jnp.asarray(render),
                                                   jnp.asarray(gt)))
    gt_ = ST.Matcher(res, device="cpu").match_Sinkhorn(
        torch.from_numpy(render), torch.from_numpy(gt)).numpy()
    assert gt_.shape == (res * res, 5)
    np.testing.assert_allclose(ST.Matcher(res, device="cpu").pos.numpy(),
                               np.asarray(SJ.Matcher(res).pos), atol=1e-7)
    np.testing.assert_allclose(gt_, gj, rtol=0, atol=5e-3 * np.abs(gj).max())


def test_sliced_wasserstein_matches_jax_given_its_basis():
    res, seed = 12, 4
    r = np.random.default_rng(8)
    render = r.random((res * res, 3)).astype(np.float32)
    gt = r.random((res * res, 3)).astype(np.float32)
    mj = SJ.Matcher(res)
    ref = np.asarray(mj.match_sliced_wasserstein(jnp.asarray(render),
                                                 jnp.asarray(gt), seed))
    # JAX's basis and directions for this seed, drawn as its matcher does
    target5 = jnp.concatenate([jnp.clip(jnp.asarray(gt), 0, 1), mj.pos], -1)
    xc = target5[:, :3] - jnp.mean(target5[:, :3], 0)
    vt = jnp.linalg.svd(xc, full_matrices=False)[2]
    V_pc = np.asarray(vt[:3].T)
    dirs = jax.random.uniform(jax.random.PRNGKey(seed), (5, 50)) * 2.0 - 1.0
    dirs = np.asarray(dirs / jnp.maximum(
        jnp.linalg.norm(dirs, axis=0, keepdims=True), 1e-8))
    mt_ = ST.Matcher(res, device="cpu")
    got = mt_.match_sliced_wasserstein(
        torch.from_numpy(render), torch.from_numpy(gt),
        basis=(torch.tensor(V_pc), torch.tensor(dirs))).numpy()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    # the port's own basis: JAX's up to column signs; unit directions
    gen = torch.Generator().manual_seed(seed)
    V_t, dirs_t = mt_.sliced_basis(torch.from_numpy(gt), gen)
    signs = np.sign(np.sum(V_t.numpy() * V_pc, axis=0))
    np.testing.assert_allclose(V_t.numpy() * signs, V_pc, atol=1e-5)
    assert dirs_t.shape == (5, 50)
    np.testing.assert_allclose(torch.linalg.norm(dirs_t, dim=0).numpy(), 1.0,
                               atol=1e-6)
    again = mt_.match_sliced_wasserstein(
        torch.from_numpy(render), torch.from_numpy(gt),
        torch.Generator().manual_seed(seed))
    assert torch.isfinite(again).all() and again.shape == (res * res, 5)


@pytest.mark.parametrize("n_in,n_out", [(512, 128), (32, 16), (16, 16),
                                        (24, 32), (128, 48)])
def test_resize_matches_jax_image_resize(n_in, n_out):
    img = np.random.default_rng(n_in).random((n_in, n_in, 3)).astype(
        np.float32)
    ref = np.asarray(optim_j._resize(jnp.asarray(img), n_out))
    got = optim_t._resize(torch.from_numpy(img), n_out).numpy()
    assert got.shape == (n_out, n_out, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
