"""The Mueller / Stokes algebra (``core/mueller.py``) of the port against
the JAX package's, on seeded numpy inputs, and the reference's own
physics checks (JAX ``tests/test_polarized.py:19-76``) on the port alone.

Tolerances, each with its reason:

- every function: within 1e-6 absolute (float32 sums of four products
  and the trigonometry of the rotators, rounded differently by XLA and
  PyTorch); the basis rotations of a random matrix (sums of sixteen
  products of entries of order one) and the complex division by a
  random denominator (quotients up to ~100) within 1e-5;
- the Fresnel amplitudes and matrices within 1e-5 at grazing incidence
  (cos theta_i < 0.05) and under total internal reflection, and the
  conductor's complex amplitudes: the complex square root and division
  amplify a last-bit difference there (on the conductor case each
  package is up to 8.7e-6 from the float64 result, and the two are
  1.8e-6 apart);
- the physics checks: the JAX package's own bars.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from epsm_mitsuba3_tpu.core import mueller as muj
from epsm_mitsuba3_torch.core import mueller as mu

from torch_threads import one_torch_thread  # noqa: F401

N = 64


def _rng(seed):
    return np.random.default_rng(seed)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _perp(rng, fwd):
    """A unit vector perpendicular to each row of ``fwd``."""
    c = rng.normal(size=fwd.shape)
    p = c - np.sum(c * fwd, -1, keepdims=True) * fwd
    return (p / np.linalg.norm(p, axis=-1, keepdims=True)).astype(np.float32)


def _mueller(rng, n=N, c=3):
    return rng.normal(size=(n, 4, 4, c)).astype(np.float32)


def _both(fn_t, fn_j, *args):
    """Each function on the same numpy arguments: (port, JAX) as numpy."""
    out_t = fn_t(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                   for a in args])
    out_j = fn_j(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for a in args])
    flat_t = out_t if isinstance(out_t, tuple) else (out_t,)
    flat_j = out_j if isinstance(out_j, tuple) else (out_j,)
    return ([np.asarray(x) for x in _flatten(flat_t)],
            [np.asarray(x) for x in _flatten(flat_j)])


def _flatten(xs):
    for x in xs:
        if isinstance(x, tuple):
            yield from _flatten(x)
        else:
            yield x


def _cases():
    """name -> (function name, its arguments, tolerance)."""
    r = _rng
    cos = lambda g: g.uniform(0.05, 1.0, N).astype(np.float32)  # noqa: E731
    graze = lambda g: g.uniform(0.0, 0.05, N).astype(np.float32)  # noqa
    val = lambda g: g.uniform(0.0, 1.0, (N, 3)).astype(np.float32)  # noqa
    eta = lambda g: g.uniform(1.1, 2.5, (N, 3)).astype(np.float32)  # noqa

    def fwd_pair(g):
        f = _unit(g, N)
        return f, _perp(g, f), _perp(g, f)

    return {
        "matmul": ("matmul", lambda: (_mueller(r(1)), _mueller(r(2))), 1e-6),
        "matmul achromatic": ("matmul", lambda: (
            _mueller(r(3), c=1), _mueller(r(4))), 1e-6),
        "matvec": ("matvec", lambda: (
            _mueller(r(5)), r(6).normal(size=(N, 4, 3)).astype(np.float32)),
            1e-6),
        "depolarizer": ("depolarizer", lambda: (val(r(7)),), 1e-6),
        "absorber": ("absorber", lambda: (val(r(8)),), 1e-6),
        "linear_polarizer": ("linear_polarizer", lambda: (val(r(9)),), 1e-6),
        "linear_retarder": ("linear_retarder", lambda: (
            r(10).uniform(-np.pi, np.pi, (N, 3)).astype(np.float32),), 1e-6),
        "circular_polarizer": ("circular_polarizer", lambda: (val(r(11)),),
                               1e-6),
        "rotator": ("rotator", lambda: (
            r(12).uniform(-np.pi, np.pi, N).astype(np.float32),), 1e-6),
        "rotated_element": ("rotated_element", lambda: (
            r(13).uniform(-np.pi, np.pi, N).astype(np.float32),
            _mueller(r(14))), 1e-6),
        "csqrt": ("_csqrt", lambda: tuple(
            r(15).normal(size=(2, N)).astype(np.float32)), 1e-6),
        "cdiv": ("_cdiv", lambda: tuple(
            r(16).normal(size=(4, N)).astype(np.float32)), 1e-5),
        "fresnel_amplitudes conductor": ("fresnel_amplitudes", lambda: (
            cos(r(17))[:, None], r(18).uniform(0.1, 2.0, (N, 3)).astype(
                np.float32), r(19).uniform(0.5, 4.0, (N, 3)).astype(
                np.float32)), 1e-5),
        "fresnel_amplitudes grazing and TIR": ("fresnel_amplitudes",
                                               lambda: (
            graze(r(20))[:, None], r(21).uniform(0.4, 0.9, (N, 3)).astype(
                np.float32), np.zeros((N, 3), np.float32)), 1e-5),
        "specular_reflection dielectric": ("specular_reflection", lambda: (
            cos(r(22)), eta(r(23))), 1e-6),
        "specular_reflection conductor": ("specular_reflection", lambda: (
            cos(r(24)), r(25).uniform(0.1, 2.0, (N, 3)).astype(np.float32),
            r(26).uniform(0.5, 4.0, (N, 3)).astype(np.float32)), 1e-6),
        "specular_reflection TIR": ("specular_reflection", lambda: (
            cos(r(27)), r(28).uniform(0.4, 0.9, (N, 3)).astype(np.float32)),
            1e-5),
        "specular_transmission": ("specular_transmission", lambda: (
            cos(r(29)), eta(r(30))), 1e-6),
        "specular_transmission TIR": ("specular_transmission", lambda: (
            cos(r(31)), r(32).uniform(0.4, 0.9, (N, 3)).astype(np.float32)),
            1e-5),
        "stokes_basis": ("stokes_basis", lambda: (_unit(r(33), N),), 1e-6),
        "unit_angle": ("unit_angle", lambda: fwd_pair(r(34))[1:]
                       + fwd_pair(r(34))[:1], 1e-6),
        "rotate_stokes_basis": ("rotate_stokes_basis",
                                lambda: fwd_pair(r(35)), 1e-6),
        "rotate_mueller_basis": ("rotate_mueller_basis", lambda: (
            _mueller(r(36)),) + fwd_pair(r(37)) + fwd_pair(r(38)), 1e-5),
        "rotate_mueller_basis_collinear": (
            "rotate_mueller_basis_collinear", lambda: (
                _mueller(r(39)),) + fwd_pair(r(40)), 1e-5),
    }


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
def test_function_matches_jax(case):
    """Each function of ``core/mueller.py`` on the same inputs as JAX's,
    within the case's tolerance (the module's docstring)."""
    name, args, tol = CASES[case]
    outs_t, outs_j = _both(getattr(mu, name), getattr(muj, name), *args())
    assert len(outs_t) == len(outs_j)
    for a, b in zip(outs_t, outs_j):
        assert a.shape == b.shape, (a.shape, b.shape)
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def test_identity_and_scalar_inputs_match_jax():
    """``identity`` and the scalar (0-d) forms the reference's tests call:
    a rotator of a Python float, reflection at one cosine."""
    np.testing.assert_array_equal(mu.identity((2,), 3).numpy(),
                                  np.asarray(muj.identity((2,), 3)))
    np.testing.assert_allclose(mu.rotator(0.3).numpy(),
                               np.asarray(muj.rotator(jnp.asarray(0.3))),
                               atol=1e-7)
    np.testing.assert_allclose(
        mu.specular_reflection(torch.tensor(0.6), torch.tensor([1.5]))
        .numpy(), np.asarray(muj.specular_reflection(
            jnp.asarray(0.6), jnp.array([1.5]))), atol=1e-7)


# -- the reference's physics checks, on the port alone ------------------------

def test_malus_law():
    """Two ideal linear polarizers pass I0 / 2 cos^2 theta."""
    S = torch.tensor([[1.0], [0.0], [0.0], [0.0]])
    P0 = mu.linear_polarizer(torch.ones(1))
    for th in (0.0, np.pi / 6, np.pi / 4, np.pi / 3, np.pi / 2):
        P1 = mu.rotated_element(torch.tensor(th, dtype=torch.float32), P0)
        out = mu.matvec(mu.matmul(P1, P0), S)
        assert abs(float(out[0, 0]) - 0.5 * np.cos(th) ** 2) < 1e-6


def test_brewster_full_polarization():
    """At Brewster's angle the p amplitude vanishes: the reflection's
    degree of polarization is 1."""
    thb = np.arctan(1.5)
    M = mu.specular_reflection(torch.tensor(np.cos(thb), dtype=torch.float32),
                               torch.tensor([1.5]))
    dop = abs(float(M[1, 0, 0])) / float(M[0, 0, 0])
    assert abs(dop - 1.0) < 1e-5


def test_fresnel_normal_incidence_reflectance():
    """M00 at normal incidence is ((eta - 1)^2 + k^2) / ((eta + 1)^2 +
    k^2), and no plane is preferred (M01 = 0)."""
    M = mu.specular_reflection(torch.tensor(1.0), torch.tensor([0.2]),
                               torch.tensor([3.0]))
    expect = ((0.2 - 1) ** 2 + 9.0) / ((0.2 + 1) ** 2 + 9.0)
    assert abs(float(M[0, 0, 0]) - expect) < 1e-5
    assert abs(float(M[0, 1, 0])) < 1e-6


def test_tir_preserves_energy_with_phase():
    """Total internal reflection: |a_s| = |a_p| = 1 with a relative phase
    (the Fresnel rhomb)."""
    ci = np.cos(np.deg2rad(60.0))
    (asr, asi), (apr, api) = mu.fresnel_amplitudes(
        torch.tensor([ci], dtype=torch.float32), torch.tensor([1 / 1.5]),
        torch.tensor([0.0]))
    asr, asi, apr, api = (float(x[0]) for x in (asr, asi, apr, api))
    assert abs(asr ** 2 + asi ** 2 - 1.0) < 1e-5
    assert abs(apr ** 2 + api ** 2 - 1.0) < 1e-5
    assert abs(np.angle((asr + 1j * asi) / (apr + 1j * api))) > 0.1


def test_retarder_quarter_wave():
    """A quarter-wave plate at 45 degrees turns +Q into circular light."""
    S = torch.tensor([[1.0], [1.0], [0.0], [0.0]])
    Q = mu.rotated_element(torch.tensor(np.pi / 4, dtype=torch.float32),
                           mu.linear_retarder(torch.tensor([np.pi / 2],
                                                           dtype=torch.float32)))
    out = mu.matvec(Q, S).numpy().ravel()
    assert abs(out[0] - 1.0) < 1e-6
    assert abs(out[1]) < 1e-6 and abs(out[2]) < 1e-6
    assert abs(abs(out[3]) - 1.0) < 1e-6


def test_basis_rotation_double_angle():
    """Turning the Stokes basis by 90 degrees flips Q."""
    R = mu.rotate_stokes_basis(torch.tensor([0.0, 0.0, 1.0]),
                               torch.tensor([1.0, 0.0, 0.0]),
                               torch.tensor([0.0, 1.0, 0.0]))
    out = mu.matvec(R, torch.tensor([[1.0], [1.0], [0.0], [0.0]])).numpy()
    assert abs(out[1, 0] + 1.0) < 1e-5
