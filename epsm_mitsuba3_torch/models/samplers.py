"""Samplers (counterpart of ``models/samplers.py``): the five kinds of the
reference's plugin set.

* ``independent``: per-lane PCG32 streams seeded with TEA, bit-exact with
  the reference (sampler.cpp:115-135).
* ``stratified``: jittered strata of the sample index, scrambled per
  dimension by a bijective hash (stratified.cpp).
* ``multijitter``: correlated multi-jittered 2-D samples (Kensler 2013,
  multijitter.cpp).
* ``ldsampler``: a scrambled (0,2)-sequence, van der Corput by
  Larcher-Pillichshammer (ldsampler.cpp).
* ``orthogonal``: a strength-2 orthogonal array over the smallest prime p
  with p >= ceil(sqrt(spp)) (orthogonal.cpp, Bush's construction).

The stratified kinds stratify the sample index s of lane = pixel * spp +
s and draw their jitter from the lane's PCG32 stream.  As in the
reference, a stratified, multijitter or orthogonal 1-D draw, and a
stratified or multijitter 2-D draw, is plain jitter when spp is not a
power of two; and the dimension counter ``dim`` is one number shared by
every lane, held here as a Python int, so a draw's scramble key is
computed on the host.  32-bit values are carried in masked ``int64``
(``core/rng.py``).  Any other kind raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..core import rng as _rng

M32 = _rng.M32
#: the kinds the port has (models/samplers.py:1-18)
KINDS = ("independent", "stratified", "multijitter", "ldsampler",
         "orthogonal")


@dataclass(frozen=True)
class Sampler:
    rng: _rng.PCG32
    kind: str = "independent"
    spp: int = 1
    #: (N,) int64: the lane's sample index s in [0, spp); None for the
    #: independent sampler
    sample_index: Optional[torch.Tensor] = None
    #: the dimension counter, shared by every lane (uint32)
    dim: int = 0
    #: the seed value (uint32)
    seed_val: int = 0


def seed(seed_value, wavefront_size: int, kind: str = "independent",
         spp: int = 1, lane_offset: int = 0, device=None) -> Sampler:
    """A sampler of ``kind`` over lanes ``lane_offset + [0, n)``: one PCG32
    stream a lane (sampler.cpp:115-135) and the lane's sample index
    ``lane % spp``.  A shard seeding lanes [off, off + n) gets the same
    draws as those lanes of the whole wavefront."""
    if kind not in KINDS:
        raise NotImplementedError(
            f"sampler '{kind}' is not ported (register_sampler plugins "
            "come with the registries)")
    seed_val = int(seed_value) & M32
    sample_index = None
    if kind != "independent":      # the independent draws never read it
        idx = (torch.arange(wavefront_size, dtype=torch.int64,
                            device=device) + lane_offset) & M32
        sample_index = idx % max(spp, 1)
    return Sampler(
        rng=_rng.seed_wavefront(0, seed_val, wavefront_size, lane_offset,
                                device=device),
        kind=kind, spp=spp, sample_index=sample_index, dim=0,
        seed_val=seed_val)


def fork(sampler: Sampler, salt: int) -> Sampler:
    """A decorrelated clone (ADIntegrator.prepare clones and reseeds)."""
    state_lo = sampler.rng.state & M32
    idx = torch.arange(state_lo.shape[0], dtype=torch.int64,
                       device=state_lo.device)
    v0, v1 = _rng.sample_tea_32(state_lo ^ (salt & M32), idx)
    return replace(sampler, rng=_rng.pcg32_seed(v0, v1))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _tea(v0: int, v1: int, rounds: int = 4) -> int:
    """``sample_tea_32(v0, v1)[0]`` on one pair of host integers."""
    s = 0
    for _ in range(rounds):
        s = (s + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & M32) ^ ((v1 + s) & M32)
                    ^ (((v1 >> 5) + 0xC8013EA4) & M32))) & M32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & M32) ^ ((v0 + s) & M32)
                    ^ (((v0 >> 5) + 0x7E95761E) & M32))) & M32
    return v0


def _dim_key(dim: int, seed_val: int) -> int:
    """The scramble key of dimension ``dim`` (``_hash(dim, seed_val)``)."""
    return _tea(dim & M32, seed_val)


def _permute_pow2(i, mask: int, key: int):
    """Bijective scramble of [0, 2^k) by xor and an odd multiply."""
    i = (i ^ key) & mask
    i = (i * 0x9E3779B1) & mask
    return (i ^ (key >> 7)) & mask


def _u32_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """A uint32 (in int64) as float32 times 2^-32, as the reference
    converts it (round to nearest, so the top values give 1.0)."""
    return bits.to(torch.float32) * (1.0 / 4294967296.0)


def _vdc(bits: torch.Tensor) -> torch.Tensor:
    """Van der Corput radical inverse, base 2, of a uint32."""
    b = bits & M32
    b = ((b & 0x0000FFFF) << 16) | (b >> 16)
    b = ((b & 0x00FF00FF) << 8) | ((b & 0xFF00FF00) >> 8)
    b = ((b & 0x0F0F0F0F) << 4) | ((b & 0xF0F0F0F0) >> 4)
    b = ((b & 0x33333333) << 2) | ((b & 0xCCCCCCCC) >> 2)
    b = ((b & 0x55555555) << 1) | ((b & 0xAAAAAAAA) >> 1)
    return _u32_to_unit(b)


def _lp(i: torch.Tensor, scramble: int) -> torch.Tensor:
    """The Larcher-Pillichshammer (0,2)-sequence's second component."""
    r = torch.full_like(i, scramble)
    v = 1 << 31
    for _ in range(32):
        r = torch.where((i & 1) != 0, r ^ v, r)
        v = v ^ (v >> 1)
        i = i >> 1
    return _u32_to_unit(r)


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _smallest_prime_ge(n: int) -> int:
    def is_prime(x):
        return x >= 2 and all(x % d for d in range(2, int(x ** 0.5) + 1))
    p = max(2, n)
    while not is_prime(p):
        p += 1
    return p


def _grid(spp: int):
    """(rows, columns) of the strata of a power-of-two spp: r x r when
    spp is an even power of two, else r x 2r."""
    r = 1 << (int(math.log2(spp)) // 2)
    return r, spp // r


# ---------------------------------------------------------------------------
# next_1d / next_2d
# ---------------------------------------------------------------------------

def _pcg_1d(sampler: Sampler):
    r, x = _rng.pcg32_next_float32(sampler.rng)
    return replace(sampler, rng=r), x


def next_1d(sampler: Sampler):
    """(sampler', x (N,)) in [0, 1)."""
    kind = sampler.kind
    if kind == "independent":
        return _pcg_1d(sampler)
    spp = sampler.spp
    s2, jitter = _pcg_1d(sampler)
    key = _dim_key(sampler.dim, sampler.seed_val)
    s2 = replace(s2, dim=(sampler.dim + 1) & M32)
    if kind in ("stratified", "multijitter", "orthogonal") and _is_pow2(spp):
        si = _permute_pow2(sampler.sample_index, spp - 1, key)
        return s2, (si.to(torch.float32) + jitter) / spp
    if kind == "ldsampler":
        return s2, _vdc(sampler.sample_index ^ key)
    return s2, jitter


def next_2d(sampler: Sampler):
    """(sampler', xy (N, 2)) in [0, 1)^2."""
    kind = sampler.kind
    if kind == "independent":
        r, x = _rng.pcg32_next_float32(sampler.rng)
        r, y = _rng.pcg32_next_float32(r)
        return replace(sampler, rng=r), torch.stack([x, y], dim=-1)
    spp, si0 = sampler.spp, sampler.sample_index
    s2, jx = _pcg_1d(sampler)
    s2, jy = _pcg_1d(s2)
    key = _dim_key(sampler.dim, sampler.seed_val)
    s2 = replace(s2, dim=(sampler.dim + 2) & M32)
    f32 = torch.float32

    if kind == "stratified" and _is_pow2(spp):
        rows, cols = _grid(spp)
        si = _permute_pow2(si0, spp - 1, key)
        x = ((si % cols).to(f32) + jx) / cols
        y = ((si // cols).to(f32) + jy) / rows
        return s2, torch.stack([x, y], dim=-1)

    if kind == "multijitter" and _is_pow2(spp):
        rows, cols = _grid(spp)
        si = _permute_pow2(si0, spp - 1, key)
        sx, sy = si % cols, si // cols
        # the sub-stratum offsets, permuted within rows and columns
        ox = _permute_pow2(sy, rows - 1, key ^ 0xA511E9B3)
        oy = _permute_pow2(sx, cols - 1, key ^ 0x63D83595)
        x = (sx.to(f32) + (ox.to(f32) + jx) / rows) / cols
        y = (sy.to(f32) + (oy.to(f32) + jy) / cols) / rows
        return s2, torch.stack([x, y], dim=-1)

    if kind == "ldsampler":
        scr2 = _dim_key(sampler.dim + 1, sampler.seed_val)
        x = _vdc(si0 ^ key)
        y = _lp(si0, scr2)
        return s2, torch.stack([x, y], dim=-1)

    if kind == "orthogonal":
        p = _smallest_prime_ge(math.ceil(math.sqrt(spp)))
        a, b = si0 % p, si0 // p
        k1 = key % (p - 1) + 1
        x = ((a + b * k1) % p).to(f32)
        y = ((b + a * k1) % p).to(f32)
        return s2, torch.stack([(x + jx) / p, (y + jy) / p], dim=-1)

    return s2, torch.stack([jx, jy], dim=-1)
