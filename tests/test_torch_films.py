"""The port's reconstruction filters and films (``models/films.py``)
against the JAX package's.

Inputs come from numpy with a seed.  Tolerances, each with its reason:

- ``filter_eval``: within 2 ulp of the filters' peak value 1.0
  (2.4e-7) on a grid across each radius.  The box, tent, Mitchell and
  Catmull-Rom filters are equal bit for bit; the gaussian's ``exp`` and
  the Lanczos filter's ``sin`` are PyTorch's, not XLA's.
- ``splat`` and ``splat_coalesced`` against JAX's, and the port's
  ``splat_coalesced`` against its own ``splat`` on pixel-major lanes: data
  and weight within 1e-6 of their largest entry (the filters' last bits,
  and the sums of a pixel's samples in another order).
- the PRB film adjoint against ``jax.vjp`` of JAX's ``_film_fn``: within
  1e-6 of the largest entry.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from epsm_mitsuba3_tpu.ad import prb as prb_j
from epsm_mitsuba3_tpu.models import films as films_j
from epsm_mitsuba3_tpu.models import sensors as sns_j

from epsm_mitsuba3_torch.ad import prb as prb_t
from epsm_mitsuba3_torch.models import films as films_t
from epsm_mitsuba3_torch.models import sensors as sns_t

FILTERS = films_t.FILTERS
W, H, SPP = 9, 7, 4


def _close(got, ref, frac=1e-6, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=frac * max(np.abs(ref).max(), 1e-30),
                               err_msg=name)


def test_filter_table_equals_jax():
    assert films_t._FILTER_RADIUS == films_j._FILTER_RADIUS


@pytest.mark.parametrize("kind", FILTERS)
def test_filter_eval_matches_jax(kind):
    r = films_t._FILTER_RADIUS[kind]
    x = np.linspace(-1.1 * r, 1.1 * r, 4001).astype(np.float32)
    x = np.concatenate([x, np.float32([0.0, 0.5, -0.5, 1e-5, r, -r])])
    got = films_t.filter_eval(kind, torch.from_numpy(x)).numpy()
    ref = np.asarray(films_j.filter_eval(kind, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2 * np.spacing(np.float32(1.0)),
                               err_msg=kind)
    if kind in ("box", "tent", "mitchell", "catmullrom"):
        np.testing.assert_array_equal(got, ref, kind)


def _border_positions(n, seed):
    """(n, 2) film positions in [0, W) x [0, H), with samples on and next
    to each border of the film."""
    p = np.random.default_rng(seed).uniform(0, 1, (n, 2)).astype(np.float32)
    p *= np.float32([W, H])
    edge = np.float32([[0.0, 0.0], [W - 1e-3, H - 1e-3], [0.2, H / 2],
                       [W - 0.2, 0.3], [W / 2, 0.0], [3.0, H - 0.5],
                       [0.5, 0.5], [W - 0.5, H - 0.5]])
    return np.concatenate([edge, p[len(edge):]])


@pytest.mark.parametrize("kind", FILTERS)
def test_splat_matches_jax(kind):
    n = 300
    pos = _border_positions(n, 1)
    vals = np.random.default_rng(2).normal(size=(n, 3)).astype(np.float32)
    d_t, w_t = films_t.splat(torch.from_numpy(pos), torch.from_numpy(vals),
                             W, H, kind)
    d_j, w_j = films_j.splat(jnp.asarray(pos), jnp.asarray(vals), W, H, kind)
    _close(d_t, d_j, name=f"{kind} data")
    _close(w_t, w_j, name=f"{kind} weight")
    img_t = films_t.develop(d_t, w_t).numpy()
    _close(img_t, films_j.develop(d_j, w_j), name=f"{kind} developed")


def _pixel_major(seed):
    """Jitter (N, 2) and values (N, 3) of W x H x SPP pixel-major lanes,
    with jitters at 0 and just below 1."""
    rng = np.random.default_rng(seed)
    jit = rng.uniform(0, 1, (H * W * SPP, 2)).astype(np.float32)
    jit[:5] = np.float32([[0.0, 0.0], [np.nextafter(1, 0, dtype=np.float32),
                                       0.5], [0.5, 0.0], [0.25, 0.75],
                          [0.0, np.nextafter(1, 0, dtype=np.float32)]])
    vals = rng.normal(size=(H * W * SPP, 3)).astype(np.float32)
    return jit, vals


def _lane_positions(jit):
    pix = np.arange(H * W * SPP) // SPP
    return np.stack([pix % W, pix // W], -1).astype(np.float32) + jit


@pytest.mark.parametrize("kind", FILTERS)
def test_splat_coalesced_matches_jax_and_splat(kind):
    jit, vals = _pixel_major(4)
    d_t, w_t = films_t.splat_coalesced(torch.from_numpy(jit),
                                       torch.from_numpy(vals), W, H, SPP,
                                       kind)
    d_j, w_j = films_j.splat_coalesced(jnp.asarray(jit), jnp.asarray(vals),
                                       W, H, SPP, kind)
    _close(d_t, d_j, name=f"{kind} data vs JAX")
    _close(w_t, w_j, name=f"{kind} weight vs JAX")
    # the scatter of the same samples at pixel + jitter
    d_s, w_s = films_t.splat(torch.from_numpy(_lane_positions(jit)),
                             torch.from_numpy(vals), W, H, kind)
    _close(d_t, d_s, name=f"{kind} data vs splat")
    _close(w_t, w_s, name=f"{kind} weight vs splat")


@pytest.mark.parametrize("kind", ("gaussian", "lanczos", "tent"))
def test_border_sample_reaches_its_whole_footprint(kind):
    """A sample next to the film's corner adds its filter weight times its
    value to every film pixel its footprint covers, in both splats, and
    nothing elsewhere (every other sample's value is 0)."""
    r = films_t._FILTER_RADIUS[kind]
    for corner in ((0.6, 0.7), (W - 0.6, H - 0.7)):
        jit = np.zeros((H * W * SPP, 2), np.float32)
        vals = np.zeros((H * W * SPP, 3), np.float32)
        px, py = int(corner[0]), int(corner[1])
        lane = (py * W + px) * SPP
        jit[lane] = [corner[0] - px, corner[1] - py]
        vals[lane] = 1.0
        pos = _lane_positions(jit)
        expect = np.zeros((H, W), np.float32)
        for y in range(H):
            for x in range(W):
                dx, dy = x + 0.5 - corner[0], y + 0.5 - corner[1]
                if abs(dx) < r and abs(dy) < r:
                    expect[y, x] = float(
                        films_t.filter_eval(kind, torch.tensor(dx))
                        * films_t.filter_eval(kind, torch.tensor(dy)))
        assert (expect != 0).sum() >= 4
        datas = (
            films_t.splat(torch.from_numpy(pos), torch.from_numpy(vals),
                          W, H, kind)[0],
            films_t.splat_coalesced(torch.from_numpy(jit),
                                    torch.from_numpy(vals), W, H, SPP,
                                    kind)[0])
        for data in datas:
            _close(data[..., 0].numpy(), expect, name=f"{kind} at {corner}")


def test_accumulate_coalesced_and_kahan_match_jax():
    _, vals = _pixel_major(5)
    np.testing.assert_array_equal(
        films_t.accumulate_coalesced(torch.from_numpy(vals), W, H,
                                     SPP).numpy(),
        np.asarray(films_j.accumulate_coalesced(jnp.asarray(vals), W, H,
                                                SPP)))
    a, c, x = (np.random.default_rng(s).normal(size=(4, 3)).astype(
        np.float32) for s in (6, 7, 8))
    for got, ref in zip(films_t.kahan_add(*map(torch.from_numpy, (a, c, x))),
                        films_j.kahan_add(*map(jnp.asarray, (a, c, x)))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ("gaussian", "lanczos", "box"))
def test_film_adjoint_matches_jax_vjp(kind):
    """PRB's film (``ad/prb.py:93`` ``_film_fn``) and its adjoint: the
    image of seeded radiance and the per-lane δL of a seeded image
    cotangent, against JAX's ``_film_fn`` and ``jax.vjp`` of it."""
    jit, vals = _pixel_major(9)
    pos = _lane_positions(jit)
    weight = np.random.default_rng(10).uniform(
        0.5, 1.5, (H * W * SPP, 3)).astype(np.float32)
    g = np.random.default_rng(11).normal(size=(H, W, 3)).astype(np.float32)
    s_j = sns_j.Sensor(to_world=jnp.eye(4), width=W, height=H, rfilter=kind)
    s_t = sns_t.Sensor(to_world=torch.eye(4), width=W, height=H,
                       rfilter=kind)
    n = H * W * SPP
    img_j, vjp = jax.vjp(lambda v: prb_j._film_fn(
        v, jnp.asarray(pos), jnp.asarray(weight), s_j, SPP),
        jnp.asarray(vals))
    (dl_j,) = vjp(jnp.asarray(g))
    img_t = prb_t._film_fn(torch.from_numpy(vals), torch.from_numpy(pos),
                           torch.from_numpy(weight), s_t, SPP)
    dl_t = prb_t.film_adjoint(torch.from_numpy(g), torch.from_numpy(pos),
                              torch.from_numpy(weight), s_t, SPP, n)
    _close(img_t.numpy(), img_j, name=f"{kind} image")
    _close(dl_t.numpy(), dl_j, name=f"{kind} adjoint")
    assert np.abs(np.asarray(dl_j)).max() > 0


def test_film_jitter_that_rounds_up_stays_in_its_lanes_pixel():
    """On a wide film, pixel + jitter can round up to the next integer in
    float32 (300 + 0.99999994 == 301.0).  PRB's film takes the jitter as
    pos - floor(pos) = 0 and splats the sample from its lane's own pixel,
    as the reference's ``_film_fn`` does (``ROADMAP.md`` §3); the scatter
    ``splat`` at that position puts it one pixel to the right."""
    w, h, spp = 600, 1, 1
    pix = np.arange(w, dtype=np.float32)
    jit = np.full(w, 0.25, np.float32)
    jit[300] = jit[450] = np.nextafter(np.float32(1), np.float32(0))
    pos = np.stack([pix + jit, np.full(w, 0.5, np.float32)], -1)
    assert pos[300, 0] == 301.0 and pos[10, 0] == 10.25
    vals = np.random.default_rng(12).uniform(
        0, 1, (w, 3)).astype(np.float32)
    s_j = sns_j.Sensor(to_world=jnp.eye(4), width=w, height=h,
                       rfilter="gaussian")
    s_t = sns_t.Sensor(to_world=torch.eye(4), width=w, height=h,
                       rfilter="gaussian")
    ones = np.ones((w, 3), np.float32)
    got = prb_t._film_fn(torch.from_numpy(vals), torch.from_numpy(pos),
                         torch.from_numpy(ones), s_t, spp).numpy()
    ref = np.asarray(prb_j._film_fn(jnp.asarray(vals), jnp.asarray(pos),
                                    jnp.asarray(ones), s_j, spp))
    _close(got, ref, name="film")
    # the roll-sum equals the scatter at pixel + (pos - floor(pos))
    lane_pos = np.stack([pix + (pos[:, 0] - np.floor(pos[:, 0])),
                         pos[:, 1]], -1)
    scatter = films_t.develop(*films_t.splat(
        torch.from_numpy(lane_pos), torch.from_numpy(vals), w, h,
        "gaussian")).numpy()
    _close(got, scatter, name="roll-sum vs scatter")
    moved = films_t.develop(*films_t.splat(
        torch.from_numpy(pos), torch.from_numpy(vals), w, h,
        "gaussian")).numpy()
    assert np.abs(moved - got).max() > 1e-3
