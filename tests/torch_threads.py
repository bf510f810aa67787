"""One intra-op thread for the port's CPU work in a test module: import
``one_torch_thread`` into the module (an autouse, module-scoped fixture).

The port's CPU work in the tests is small tensors over many operations.
With several test workers on the machine, each spinning as many PyTorch
threads as there are cores, a 32^2 render's operations wait on each
other's threads: ``test_torch_render.py``'s golden Z-test takes ~4 s
alone and ~90 s beside five other workers.  At the module's end the
fixture also returns the process's free heap to the system
(``release_free_memory``)."""
import ctypes
import ctypes.util
import gc
import os
import sys

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
    yield
    torch.set_num_threads(n)
    release_free_memory()
