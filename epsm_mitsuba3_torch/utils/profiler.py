"""Profiling scopes (counterpart of ``utils/profiler.py``; the
reference's include/mitsuba/core/profiler.h).

- ``scoped_phase`` / ``annotate``: a named range, ``torch.profiler``'s
  ``record_function`` (it shows in a ``torch.profiler`` trace) and, where
  CUDA is present, an NVTX range (it shows in an Nsight timeline);
- ``timed``: a host wall-clock timer;
- ``KernelHistory``: the reference's ``dr.kernel_history`` analog.  The
  JAX package counts XLA compilations there; PyTorch compiles nothing
  per call, so here it counts the launches of the port's hand-written
  kernels K1-K4 inside the block, from the counters their wrappers keep
  (``ops/cuda_intersect.py`` and ``ops/cuda_traverse.py`` ``launches``).
  On the CPU the plain versions run and count nothing.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict

import torch


class ProfilerPhase:
    """The reference's phase names (profiler.h:20-48)."""
    InitScene = "InitScene"
    LoadGeometry = "LoadGeometry"
    InitAccel = "InitAccel"
    Render = "Render"
    SamplingIntegratorSample = "SamplingIntegrator::sample"
    RayIntersect = "RayIntersect"
    RayTest = "RayTest"
    CreateSurfaceInteraction = "CreateSurfaceInteraction"
    BSDFEvaluate = "BSDFEvaluate"
    BSDFSample = "BSDFSample"
    EndpointEvaluate = "EndpointEvaluate"
    EndpointSampleDirection = "EndpointSampleDirection"
    SampleEmitterDirection = "SampleEmitterDirection"
    TextureEvaluate = "TextureEvaluate"
    MediumEvaluate = "MediumEvaluate"
    MediumSample = "MediumSample"
    PhaseFunctionEvaluate = "PhaseFunctionEvaluate"
    PhaseFunctionSample = "PhaseFunctionSample"


@contextlib.contextmanager
def scoped_phase(name: str):
    """ScopedPhase: ``record_function(name)``, inside an NVTX range of the
    same name where CUDA is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def annotate(name: str):
    """A decorator that runs the function inside ``scoped_phase(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with scoped_phase(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def _counters():
    from ..ops import cuda_intersect as CI
    from ..ops import cuda_traverse as CT
    return CI.launches, CT.launches


class KernelHistory:
    """The launches of K1-K4 inside a ``with`` block, by kernel entry:

        with KernelHistory() as kh:
            render(...)
        kh.launches     # {"mt_closest_hit": 12, ...}
        kh.total        # their sum

    Blocks may nest; the counters themselves are left as they were."""

    def __init__(self):
        self.launches: Dict[str, int] = {}
        self._start: Dict[str, int] = {}

    def __enter__(self):
        self._start = {k: v for c in _counters() for k, v in c.items()}
        self.launches = {}
        return self

    def __exit__(self, *exc):
        now = {k: v for c in _counters() for k, v in c.items()}
        self.launches = {k: v - self._start.get(k, 0) for k, v in now.items()}
        return False

    @property
    def total(self) -> int:
        return sum(self.launches.values())


@contextlib.contextmanager
def timed(label: str, results: Dict[str, float] = None):
    """Wall-clock seconds of the block into ``results[label]`` (the
    reference's Timer, integrator.cpp ``m_render_timer``).  It does not
    wait for the device: synchronize inside the block to time its work."""
    t0 = time.perf_counter()
    yield
    if results is not None:
        results[label] = time.perf_counter() - t0
