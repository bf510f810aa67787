"""``core/quad.py``, ``core/spline.py``, ``utils/chi2.py`` and
``utils/polvis.py`` in the port against the JAX package, on the same
inputs, JAX's own ``tests/test_core_extras.py`` checks of the first two
on the port, and ``utils/profiler.py`` and ``utils/sys_info.py``.

Tolerances: quadrature nodes and weights bit for bit (the same numpy
float64 arithmetic, rounded once to float32); the splines within 2e-6
(float32 arithmetic in two orders); the chi-square harness's histogram
exactly (the same samples), its integrated pdf and p-value to 1e-6
relative (the float32 densities of two libraries); polvis bit for bit
(the same numpy code)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from epsm_mitsuba3_tpu.core import quad as QJ
from epsm_mitsuba3_tpu.core import spline as SJ
from epsm_mitsuba3_tpu.utils import chi2 as CJ
from epsm_mitsuba3_tpu.utils import polvis as PJ

from epsm_mitsuba3_torch.core import quad as QT
from epsm_mitsuba3_torch.core import spline as ST
from epsm_mitsuba3_torch.utils import chi2 as CT
from epsm_mitsuba3_torch.utils import polvis as PT
from epsm_mitsuba3_torch.utils import profiler as PR
from epsm_mitsuba3_torch.utils import sys_info as SI


@pytest.mark.parametrize("rule", ["gauss_legendre", "gauss_lobatto",
                                  "composite_simpson"])
@pytest.mark.parametrize("n", [2, 5, 16])
def test_quad_equals_jax(rule, n):
    xt, wt = getattr(QT, rule)(n, device="cpu")
    xj, wj = getattr(QJ, rule)(n)
    assert xt.dtype == wt.dtype == torch.float32
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    # integral of x^4 over [-1, 1] = 2/5 (JAX's test_gauss_legendre_integrates)
    if n == 16:
        assert abs(float((wt * xt ** 4).sum()) - 0.4) < 1e-4
    with pytest.raises(ValueError):
        QT.gauss_lobatto(1, device="cpu")


def test_quad_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        QT.gauss_legendre(4)


def _curve(n, seed, uniform):
    r = np.random.default_rng(seed)
    nodes = (np.linspace(0, 1, n) if uniform
             else np.sort(r.uniform(0, 1, n))).astype(np.float32)
    nodes[0], nodes[-1] = 0.0, 1.0
    return nodes, r.normal(size=n).astype(np.float32), \
        r.uniform(-0.1, 1.1, 300).astype(np.float32)


@pytest.mark.parametrize("uniform", [True, False])
def test_spline_equals_jax(uniform):
    nodes, values, x = _curve(11, 3 if uniform else 4, uniform)
    got = ST.eval_1d(torch.from_numpy(nodes), torch.from_numpy(values),
                     torch.from_numpy(x)).numpy()
    ref = np.asarray(SJ.eval_1d(jnp.asarray(nodes), jnp.asarray(values),
                                jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    got = ST.integrate_1d(torch.from_numpy(nodes),
                          torch.from_numpy(values)).numpy()
    ref = np.asarray(SJ.integrate_1d(jnp.asarray(nodes),
                                     jnp.asarray(values)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    r = np.random.default_rng(1)
    f0, f1, d0, d1, t = (r.normal(size=64).astype(np.float32)
                         for _ in range(5))
    np.testing.assert_allclose(
        ST.eval_spline(*(torch.from_numpy(a) for a in (f0, f1, d0, d1, t)))
        .numpy(),
        np.asarray(SJ.eval_spline(*(jnp.asarray(a)
                                    for a in (f0, f1, d0, d1, t)))),
        rtol=0, atol=2e-6)


def test_spline_interpolates():
    """JAX's test_spline_interpolates on the port."""
    nodes = torch.linspace(0.0, 1.0, 9)
    x = torch.linspace(0.05, 0.95, 50)
    y = ST.eval_1d(nodes, torch.sin(nodes * 3.0), x)
    assert torch.allclose(y, torch.sin(x * 3.0), atol=5e-3)
    # the integral of sin(3x) over [0, 1]
    total = float(ST.integrate_1d(nodes, torch.sin(nodes * 3.0))[-1])
    assert abs(total - (1 - np.cos(3.0)) / 3.0) < 5e-3


def _cosine_pair(seed):
    """A cosine-weighted hemisphere: samples (numpy, the same for both
    packages) and its density in each package's arrays."""
    r = np.random.default_rng(seed)
    u = r.random((50_000, 2))
    rr = np.sqrt(u[:, 0])
    phi = 2 * np.pi * u[:, 1]
    s = np.stack([rr * np.cos(phi), rr * np.sin(phi),
                  np.sqrt(np.maximum(1 - u[:, 0], 0))], -1)
    return s


@pytest.mark.parametrize("domain", ["sphere", "plane"])
def test_chi2_equals_jax(domain):
    if domain == "sphere":
        s = _cosine_pair(7)

        def pdf_t(d):
            return torch.clamp(d[..., 2], min=0.0) / np.pi

        def pdf_j(d):
            return jnp.maximum(d[..., 2], 0.0) / np.pi
        dt, dj = CT.SphericalDomain(), CJ.SphericalDomain()
    else:
        r = np.random.default_rng(8)
        s = np.sqrt(r.random((50_000, 2)))       # density 4 x y

        def pdf_t(p):
            return 4.0 * p[..., 0] * p[..., 1]

        def pdf_j(p):
            return 4.0 * p[..., 0] * p[..., 1]
        dt, dj = CT.PlanarDomain(), CJ.PlanarDomain()
    tt = CT.ChiSquareTest(dt, lambda n: torch.from_numpy(s[:n]), pdf_t,
                          sample_count=len(s), res=11, device="cpu")
    tj = CJ.ChiSquareTest(dj, lambda n: s[:n], pdf_j, sample_count=len(s),
                          res=11)
    ok_t, ok_j = tt.run(), tj.run()
    assert ok_t == ok_j and ok_t, (tt.messages, tj.messages)
    np.testing.assert_array_equal(tt.histogram, tj.histogram)
    np.testing.assert_allclose(tt.pdf_table, tj.pdf_table, rtol=1e-6)
    np.testing.assert_allclose(tt.p_value, tj.p_value, rtol=1e-6)


def test_chi2_rejects_a_wrong_pdf():
    s = _cosine_pair(9)
    test = CT.ChiSquareTest(CT.SphericalDomain(),
                            lambda n: torch.from_numpy(s[:n]),
                            lambda d: torch.full(d.shape[:-1],
                                                 1 / (2 * np.pi)),
                            sample_count=len(s), res=11, device="cpu")
    assert not test.run()


@pytest.mark.parametrize("mode", ["s0", "dolp", "aolp", "docp"])
def test_polvis_equals_jax(mode):
    """Each mode on a seeded Stokes stack (S1..S3 within the cone |S| <=
    S0, some pixels dark); an unknown mode raises in both."""
    rng = np.random.default_rng(7)
    s0 = rng.uniform(0.0, 2.0, (9, 7))
    v = rng.normal(size=(9, 7, 3))
    v *= (s0 * rng.uniform(0, 1, (9, 7)) / np.linalg.norm(v, axis=-1))[
        ..., None]
    img = np.concatenate([s0[..., None], v], -1).astype(np.float32)
    img[0, 0] = 0.0
    out = PT.polvis(img, mode)
    assert out.shape == (9, 7, 3) and np.isfinite(out).all()
    np.testing.assert_array_equal(out, PJ.polvis(img, mode))
    with pytest.raises(ValueError, match="unknown polvis mode"):
        PT.polvis(img, "bogus")


def test_profiler_scopes_timer_and_kernel_history():
    """``scoped_phase`` and ``annotate`` name their block in a
    ``torch.profiler`` trace; ``timed`` writes its seconds; the kernel
    history counts the K1-K4 launches of its block only (none on the
    CPU, where the plain versions run) and leaves the counters as they
    were."""
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT_

    @PR.annotate(PR.ProfilerPhase.BSDFSample)
    def work(x):
        return (x * 2).sum()

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with PR.scoped_phase(PR.ProfilerPhase.Render):
            work(torch.ones(4))
    names = {e.name for e in prof.events()}
    assert {"Render", "BSDFSample"} <= names
    times = {}
    with PR.timed("block", times):
        pass
    assert times["block"] >= 0.0
    before = {**CI.launches, **CT_.launches}
    with PR.KernelHistory() as outer:
        CI.launches["mt_closest_hit"] += 2
        with PR.KernelHistory() as inner:
            CT_.launches["bvh4_any_hit"] += 1
        CI.launches["mt_closest_hit"] -= 2
        CT_.launches["bvh4_any_hit"] -= 1
    assert inner.launches["bvh4_any_hit"] == 1 and inner.total == 1
    assert outer.total == 0
    assert {**CI.launches, **CT_.launches} == before
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.scenes import cornell_box
    sc = mt.load_dict(cornell_box(res=4, spp=1), device="cpu")
    with PR.KernelHistory() as kh:
        mt.render(sc, spp=1, device="cpu")
    assert kh.total == 0 and set(kh.launches) == set(before)


def test_sys_info_reports_torch_and_the_device():
    """``info`` names torch's version and the devices (the CPU without
    CUDA, and then no power limits); ``print_info`` prints each key."""
    info = SI.info()
    assert info["torch"] == torch.__version__
    assert info["framework"] == "epsm_mitsuba3_torch"
    if not torch.cuda.is_available():
        assert info["backend"] == "cpu" and info["devices"] == ["cpu"]
        assert info["device_count"] == 1 and info["power_limits"] is None
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        SI.print_info()
    assert all(k in buf.getvalue() for k in info)
