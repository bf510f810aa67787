"""The port's five sampler kinds (``models/samplers.py``) against the JAX
package's.

Each kind at spp 1, 4, 8, 9 and 16 draws a mixed sequence of ``next_1d``
and ``next_2d`` (seven draws, eleven dimensions) over every lane of a
seeded wavefront.  Against JAX's functions called one by one the draws
are equal bit for bit.  Against the same draws under ``jax.jit`` (how
the renders run them) they are equal bit for bit, except the orthogonal
sampler's ``(x + jitter) / p``, which XLA turns into a multiply by the
float32 reciprocal of the prime p: there, for a prime p that is not a
power of two, draws may be 1 ulp apart (``ROADMAP.md`` §3).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from epsm_mitsuba3_tpu.models import samplers as smp_j

from epsm_mitsuba3_torch.models import samplers as smp_t

KINDS = smp_t.KINDS
SPPS = (1, 4, 8, 9, 16)
#: next_2d (2) and next_1d (1), in the order the tests draw them
DRAWS = (2, 1, 2, 2, 1, 1, 2)
PIXELS = 48


def _draws(mod, sampler, cat):
    out = []
    for w in DRAWS:
        sampler, v = mod.next_2d(sampler) if w == 2 else mod.next_1d(
            sampler)
        out.append(v.reshape(-1))
    return sampler, cat(out)


def _ulp(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref) / np.spacing(
        np.maximum(np.abs(got), np.abs(ref)).astype(np.float32))


@pytest.mark.parametrize("spp", SPPS)
@pytest.mark.parametrize("kind", KINDS)
def test_draws_match_jax(kind, spp):
    n = PIXELS * spp
    s_t, got = _draws(smp_t, smp_t.seed(5, n, kind=kind, spp=spp), torch.cat)
    s_j, ref = _draws(smp_j, smp_j.seed(5, n, kind=kind, spp=spp),
                      jnp.concatenate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert s_t.dim == int(s_j.dim) and s_t.spp == s_j.spp
    if kind == "independent":
        assert s_t.sample_index is None
    else:
        np.testing.assert_array_equal(s_t.sample_index.numpy(),
                                      np.asarray(s_j.sample_index))
    np.testing.assert_array_equal((s_t.rng.state & smp_t.M32).numpy(),
                                  np.asarray(s_j.rng.state_lo))
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    # under jit: equal, but for the orthogonal sampler's reciprocal
    jitted = np.asarray(jax.jit(lambda s: _draws(
        smp_j, s, jnp.concatenate)[1])(smp_j.seed(5, n, kind=kind,
                                                  spp=spp)))
    ulp = _ulp(got.numpy(), jitted)
    p = smp_t._smallest_prime_ge(int(np.ceil(np.sqrt(spp))))
    if kind == "orthogonal" and not smp_t._is_pow2(p):
        assert ulp.max() <= 1.0
    else:
        assert ulp.max() == 0.0


@pytest.mark.parametrize("kind", ("stratified", "multijitter", "ldsampler"))
def test_stratified_kinds_cover_their_strata(kind):
    """At spp 16 each pixel's 16 first 2-D draws fall one in each cell of
    a 4 x 4 grid (the ldsampler's draws are a (0,4,2)-net in base 2)."""
    spp = 16
    _, xy = smp_t.next_2d(smp_t.seed(2, PIXELS * spp, kind=kind, spp=spp))
    cells = (np.floor(xy.numpy() * 4).astype(int) @ [1, 4]).reshape(
        PIXELS, spp)
    for row in cells:
        assert sorted(row) == list(range(16))


@pytest.mark.parametrize("kind", KINDS)
def test_lane_offset_gives_the_slice(kind):
    """Lanes [off, off + m) seeded on their own draw what those lanes of
    the whole wavefront draw (a shard of the wavefront), as in JAX."""
    spp, off, m = 8, 24, 40
    whole = _draws(smp_t, smp_t.seed(9, 128, kind=kind, spp=spp), list)[1]
    part = _draws(smp_t, smp_t.seed(9, m, kind=kind, spp=spp,
                                    lane_offset=off), list)[1]
    ref = _draws(smp_j, smp_j.seed(9, m, kind=kind, spp=spp,
                                   lane_offset=off), list)[1]
    for w, p, r in zip(whole, part, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
        np.testing.assert_array_equal(
            p.reshape(m, -1).numpy(),
            w.reshape(128, -1)[off:off + m].numpy())


@pytest.mark.parametrize("kind", ("independent", "multijitter"))
def test_fork_matches_jax(kind):
    s_t = smp_t.next_2d(smp_t.seed(4, 256, kind=kind, spp=4))[0]
    s_j = smp_j.next_2d(smp_j.seed(4, 256, kind=kind, spp=4))[0]
    f_t, f_j = smp_t.fork(s_t, 77), smp_j.fork(s_j, 77)
    got = _draws(smp_t, f_t, torch.cat)[1]
    ref = _draws(smp_j, f_j, jnp.concatenate)[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert f_t.dim == int(f_j.dim)


def test_helpers_match_jax():
    """The scramble, the radical inverses and the primes, on seeded
    uint32 inputs."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    bits[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    t = torch.from_numpy(bits.astype(np.int64))
    j = jnp.asarray(bits)
    np.testing.assert_array_equal(smp_t._vdc(t).numpy(),
                                  np.asarray(smp_j._vdc(j)))
    for scramble in (0, 12345, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            smp_t._lp(t & 0xFFFF, scramble).numpy(),
            np.asarray(smp_j._lp(j & jnp.uint32(0xFFFF),
                                 jnp.uint32(scramble))))
    for spp in (2, 8, 64):
        key = int(rng.integers(0, 2 ** 32))
        i = np.arange(spp, dtype=np.uint32)
        got = smp_t._permute_pow2(torch.from_numpy(i.astype(np.int64)),
                                  spp - 1, key).numpy()
        ref = np.asarray(smp_j._permute_pow2(jnp.asarray(i),
                                             jnp.uint32(spp - 1),
                                             jnp.uint32(key)))
        np.testing.assert_array_equal(got, ref)
        assert sorted(got) == list(range(spp))
    for dim in (0, 1, 7, 2 ** 32 - 1):
        ref = smp_j._hash(jnp.asarray([dim], jnp.uint32), jnp.uint32(11))
        assert smp_t._dim_key(dim, 11) == int(ref[0])
    for n in range(0, 40):
        assert smp_t._smallest_prime_ge(n) == smp_j._smallest_prime_ge(n)


def test_unported_kind_raises():
    with pytest.raises(NotImplementedError, match="sobol"):
        smp_t.seed(0, 8, kind="sobol")
