"""TEA + PCG32 random number generation, bit-exact with the JAX package.

Counterpart of ``epsm_mitsuba3_tpu/core/rng.py``.  PyTorch's ``uint32``
lacks add, shifts, compares and ``arange`` on the CPU, so every 32-bit
value is carried in ``int64`` and masked with ``& 0xFFFFFFFF`` after each
wrapping step.  The 64-bit PCG32 state is one ``int64``: wrapping multiply
and add leave the right low 64 bits, and each right shift is made logical
by masking after the arithmetic shift.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

M32 = 0xFFFFFFFF
PCG32_MULT = 0x5851F42D4C957F2D


def _u32(x, device=None) -> torch.Tensor:
    """A uint32 value (Python int or tensor) as a masked int64 tensor."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & M32


def _lsr64(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of a 64-bit pattern held in int64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def sample_tea_32(v0, v1, rounds: int = 4):
    """Tiny Encryption Algorithm scramble (random.h:77-90), bit exact.

    ``v0``/``v1`` are uint32 values carried in int64 tensors."""
    v0 = _u32(v0)
    v1 = _u32(v1, v0.device)
    s = 0
    for _ in range(rounds):
        s = (s + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & M32)
                    ^ ((v1 + s) & M32)
                    ^ (((v1 >> 5) + 0xC8013EA4) & M32))) & M32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & M32)
                    ^ ((v0 + s) & M32)
                    ^ (((v0 >> 5) + 0x7E95761E) & M32))) & M32
    return v0, v1


@dataclass(frozen=True)
class PCG32:
    """Per-lane PCG32 state: ``state`` and ``inc`` as 64-bit int64 lanes."""

    state: torch.Tensor
    inc: torch.Tensor


def pcg32_seed(initstate, initseq) -> PCG32:
    """PCG32 seed (pcg32.h ``seed``): inc = (initseq << 1) | 1, then
    advance, add initstate, advance.  Both arguments are 64-bit values in
    int64 tensors (zero-extended uint32 in every caller here)."""
    initstate = torch.as_tensor(initstate, dtype=torch.int64)
    initseq = torch.as_tensor(initseq, dtype=torch.int64,
                              device=initstate.device)
    inc = (initseq << 1) | 1
    rng = PCG32(state=torch.zeros_like(inc), inc=inc)
    rng, _ = pcg32_next_uint32(rng)
    rng = replace(rng, state=rng.state + initstate)
    rng, _ = pcg32_next_uint32(rng)
    return rng


def pcg32_next_uint32(rng: PCG32):
    """Advance every lane once; returns (rng', uint32 output in int64)."""
    old = rng.state
    new = replace(rng, state=old * PCG32_MULT + rng.inc)
    xorshifted = _lsr64(_lsr64(old, 18) ^ old, 27) & M32
    rot = _lsr64(old, 59)
    out = ((xorshifted >> rot)
           | (xorshifted << ((32 - rot) & 31))) & M32
    return new, out


def pcg32_next_float32(rng: PCG32):
    """Uniform float in [0, 1) from the top 23 bits (pcg32.h)."""
    rng, bits = pcg32_next_uint32(rng)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return rng, f - 1.0


def seed_wavefront(base_seed: int, seed, wavefront_size: int,
                   lane_offset: int = 0, device=None) -> PCG32:
    """Per-lane decorrelated PCG32 streams (sampler.cpp:115-135).

    ``(v0, v1) = sample_tea_32(base_seed + seed, lane)``, then
    ``pcg32_seed(v0, v1)``.  Lanes are ``lane_offset + [0, n)``, mod 2^32."""
    idx = (torch.arange(wavefront_size, dtype=torch.int64, device=device)
           + lane_offset) & M32
    seed_value = (_u32(base_seed, device) + _u32(seed, device)) & M32
    v0, v1 = sample_tea_32(seed_value.expand(idx.shape), idx)
    return pcg32_seed(v0, v1)
