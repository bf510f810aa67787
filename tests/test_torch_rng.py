"""The port's TEA / PCG32 streams equal the JAX package's bit for bit.

Inputs are made with numpy from a seed and handed to both packages.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from epsm_mitsuba3_tpu.core import rng as RJ
from epsm_mitsuba3_tpu.models import samplers as SJ
from epsm_mitsuba3_torch.core import rng as RT
from epsm_mitsuba3_torch.models import samplers as ST

SEEDS = [0, 1, 123, 0xFFFFFFFF]
LANES = 4096


def _u32(x) -> np.ndarray:
    """Port value (int64 tensor) or JAX value (uint32) -> uint32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).astype(np.uint32)


def _state_hi_lo(rng: RT.PCG32):
    s = rng.state.numpy().view(np.uint64)
    i = rng.inc.numpy().view(np.uint64)
    return [(a >> np.uint64(32)).astype(np.uint32) for a in (s, i)] + \
        [(a & np.uint64(0xFFFFFFFF)).astype(np.uint32) for a in (s, i)]


@pytest.mark.parametrize("seed", SEEDS)
def test_tea_bit_exact(seed):
    r = np.random.default_rng(seed)
    v0 = r.integers(0, 2 ** 32, LANES, dtype=np.uint64).astype(np.uint32)
    v1 = r.integers(0, 2 ** 32, LANES, dtype=np.uint64).astype(np.uint32)
    v1[:4] = [0, 1, seed & 0xFFFFFFFF, 0xFFFFFFFF]
    a0, a1 = RJ.sample_tea_32(jnp.asarray(v0), jnp.asarray(v1))
    b0, b1 = RT.sample_tea_32(torch.from_numpy(v0.astype(np.int64)),
                              torch.from_numpy(v1.astype(np.int64)))
    np.testing.assert_array_equal(_u32(a0), _u32(b0))
    np.testing.assert_array_equal(_u32(a1), _u32(b1))


@pytest.mark.parametrize("seed", SEEDS)
def test_pcg32_seed_and_draws_bit_exact(seed):
    r = np.random.default_rng(seed + 7)
    st = r.integers(0, 2 ** 32, LANES, dtype=np.uint64).astype(np.uint32)
    sq = r.integers(0, 2 ** 32, LANES, dtype=np.uint64).astype(np.uint32)
    sq[0] = seed & 0xFFFFFFFF
    z = jnp.zeros(LANES, jnp.uint32)
    rj = RJ.pcg32_seed(z, jnp.asarray(st), z, jnp.asarray(sq))
    rt = RT.pcg32_seed(torch.from_numpy(st.astype(np.int64)),
                       torch.from_numpy(sq.astype(np.int64)))
    for _ in range(3):
        rj, xj = RJ.pcg32_next_uint32(rj)
        rt, xt = RT.pcg32_next_uint32(rt)
        np.testing.assert_array_equal(_u32(xj), _u32(xt))
    rj, fj = RJ.pcg32_next_float32(rj)
    rt, ft = RT.pcg32_next_float32(rt)
    np.testing.assert_array_equal(np.asarray(fj).view(np.uint32),
                                  ft.numpy().view(np.uint32))
    s_hi, i_hi, s_lo, i_lo = _state_hi_lo(rt)
    for a, b in ((rj.state_hi, s_hi), (rj.state_lo, s_lo),
                 (rj.inc_hi, i_hi), (rj.inc_lo, i_lo)):
        np.testing.assert_array_equal(_u32(a), b)


def test_pcg32_reference_vector():
    # pcg32-demo: pcg32_srandom(42u, 54u) -> first six 32-bit outputs
    expected = [0xA15C02B7, 0x7B47F409, 0xBA1D3330, 0x83D2F293,
                0xBFA4784B, 0xCBED606E]
    rng = RT.pcg32_seed(torch.tensor([42]), torch.tensor([54]))
    for e in expected:
        rng, out = RT.pcg32_next_uint32(rng)
        assert int(out[0]) == e, hex(int(out[0]))


@pytest.mark.parametrize("lane_offset", [0, 1000, 2 ** 32 - 100])
@pytest.mark.parametrize("seed", SEEDS)
def test_seed_wavefront_bit_exact(seed, lane_offset):
    rj = RJ.seed_wavefront(0, seed, LANES, lane_offset)
    rt = RT.seed_wavefront(0, seed, LANES, lane_offset)
    rj, fj = RJ.pcg32_next_float32(rj)
    rt, ft = RT.pcg32_next_float32(rt)
    np.testing.assert_array_equal(np.asarray(fj).view(np.uint32),
                                  ft.numpy().view(np.uint32))
    s_hi, _, s_lo, _ = _state_hi_lo(rt)
    np.testing.assert_array_equal(_u32(rj.state_hi), s_hi)
    np.testing.assert_array_equal(_u32(rj.state_lo), s_lo)


@pytest.mark.parametrize("seed", [0, 123])
def test_independent_sampler_stream(seed):
    """next_2d, next_1d, next_2d of the independent sampler: the order of
    draws a bounce makes."""
    sj = SJ.seed(jnp.asarray(seed, jnp.uint32), LANES)
    stt = ST.seed(seed, LANES, device="cpu")
    for fn in ("next_2d", "next_1d", "next_2d"):
        sj, xj = getattr(SJ, fn)(sj)
        stt, xt = getattr(ST, fn)(stt)
        np.testing.assert_array_equal(np.asarray(xj).view(np.uint32),
                                      xt.numpy().view(np.uint32))
