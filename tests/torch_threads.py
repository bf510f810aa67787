"""One intra-op thread for the port's CPU work in a test module: import
``one_torch_thread`` into the module (an autouse, module-scoped fixture).

The port's CPU work in the tests is small tensors over many operations.
With several test workers on the machine, each spinning as many PyTorch
threads as there are cores, a 32^2 render's operations wait on each
other's threads: ``test_torch_render.py``'s golden Z-test takes ~4 s
alone and ~90 s beside five other workers."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
