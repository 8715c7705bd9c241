"""A module-scoped autouse fixture for the parity files that hold the
port's CPU ops to the JAX package: import ``one_torch_thread`` into a test
module to run that module's torch ops on the calling thread.

torch's CPU unary kernels (``sqrt``, ``exp``) hand a tensor of more than
2048 elements to OpenMP worker threads in chunks, MKL VML on each. In one
parallel test run the chunks of a TransformerConv mesh came back with
12-bit square roots (``x · rsqrt`` estimates, 0.25 → 0.24993896), which
bit-exact and 1e-5 checks then missed though the inputs had been asserted
identical. One thread takes the worker threads out of the comparison."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
