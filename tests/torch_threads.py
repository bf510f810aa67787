"""One intra-op thread for the port's CPU work in a test module: import
``one_torch_thread`` into the module (an autouse, module-scoped fixture).

The port's CPU work in the tests is small tensors over many operations.
With several test workers on the machine, each spinning as many PyTorch
threads as there are cores, a 32^2 render's operations wait on each
other's threads: ``test_torch_render.py``'s golden Z-test takes ~4 s
alone and ~90 s beside five other workers.  At the module's end the
fixture also returns the process's free heap to the system
(``release_free_memory``).

While the module runs, XLA compiles the JAX references with little
optimization (``jax_disable_most_optimizations``: LLVM at -O0, no
expensive LLVM passes).  The references are small programs run a few
times, so compiling them is nearly all of their cost: at -O0 a PRB
gradient of ``cornell_box(16, 4, 3)`` takes about 40 % less CPU time to
compile (``tests/jax_cost.py compile``).  The program is the same, so
its results are the same up to rounding (the code generator fuses fewer
multiply-adds); the port's tolerances against JAX were set for the
port's own rounding, which differs from XLA's either way.  The JAX
package's own tests keep the default."""
import ctypes
import ctypes.util
import gc
import os
import sys

import jax
import pytest
import torch


#: a worker's resident size above which ``release_free_memory`` drops
#: the in-memory compilation caches too
CACHE_LIMIT_BYTES = 5 * 2 ** 30


def _resident_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _trim():
    libc = ctypes.util.find_library("c")
    trim = getattr(ctypes.CDLL(libc), "malloc_trim", None) if libc else None
    if trim is not None:
        trim(0)


def release_free_memory():
    """Hand the heap's free pages back to the system (glibc
    ``malloc_trim``), and where the worker still holds more than
    ``CACHE_LIMIT_BYTES`` drop JAX's in-memory compilation caches too
    (the persistent cache on disk keeps them): a worker's resident size
    otherwise keeps every executable and the peak of every compile it
    ran, and six workers of the suite together outgrow the machine."""
    _trim()
    if "jax" in sys.modules and _resident_bytes() > CACHE_LIMIT_BYTES:
        sys.modules["jax"].clear_caches()
        gc.collect()
        _trim()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    effort = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", effort)
    torch.set_num_threads(n)
    release_free_memory()
