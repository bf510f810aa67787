"""Build the port's native sources into shared libraries at first use.

Every library the port loads with ``ctypes`` is compiled here from a
source in the checkout: the CUDA kernels with ``nvcc`` for ``sm_90a``,
the BVH builder (``native/bvh.cpp``) with ``g++``.  A library goes into
``epsm_mitsuba3_torch/_build/`` under a name keyed by a hash of its
source, the headers it includes and the flags, so an edit rebuilds it.
It is written under a temporary name and renamed into place, so several
processes may build it at once.  A missing compiler or a failed build
raises: nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Sequence, Tuple

PKG = Path(__file__).resolve().parents[1]
REPO = PKG.parent
BUILD_DIR = PKG / "_build"

#: --fmad=false keeps each multiply and add rounded on its own, as in the
#: plain PyTorch versions; -Xptxas=-v reports registers, stack and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")
#: no -march=native: the library must run on whatever host builds it
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


@dataclass(frozen=True)
class Spec:
    """One shared library: its stem, source, compiler and flags, and the
    headers the source includes (hashed with it)."""
    name: str
    source: Path
    compiler: str
    flags: Tuple[str, ...]
    headers: Tuple[Path, ...] = ()

    @property
    def path(self) -> Path:
        h = hashlib.sha256()
        for p in (self.source, *self.headers):
            h.update(p.read_bytes())
        h.update(" ".join((self.compiler, *self.flags)).encode())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"


#: compiler output of each library built by this process (ptxas lines)
build_logs: Dict[str, str] = {}


def _compiler(name: str) -> str:
    path = shutil.which(name)
    if path is None and name == "nvcc":
        path = "/usr/local/cuda/bin/nvcc"
    if path is None or not os.path.exists(path):
        raise RuntimeError(f"{name} not found: it builds the port's "
                           "native libraries")
    return path


def build(specs: Sequence[Spec]) -> None:
    """Compile every library of ``specs`` that is not built yet, all
    compilers started together; raise if any build fails."""
    jobs = []
    for spec in specs:
        out = spec.path
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_compiler(spec.compiler), *spec.flags, "-o", str(tmp),
               str(spec.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((spec, proc, tmp, out))
    failed = []
    for spec, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        build_logs[spec.name] = log
        if proc.returncode != 0:
            failed.append(f"{spec.compiler} failed on {spec.source}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(spec: Spec) -> ctypes.CDLL:
    """Build ``spec`` if needed and load it."""
    build([spec])
    return ctypes.CDLL(str(spec.path))


def check_launch(err: int, entry: str) -> None:
    """Raise if a kernel entry returned a CUDA error at its launch."""
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
