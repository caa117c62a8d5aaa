"""PyTorch settings of the port's CPU tests: one intra-op thread in each
test process, set when a port test module is imported, and
``plain_inference_mode``, a fixture that runs each test of the modules
that import it under ``torch.inference_mode()``.

The port's plain versions, which its CPU tests run, are loops of small
tensor ops.  They gain nothing from PyTorch's thread pool, and the
tier-1 suite runs six worker processes on the machine's cores at once:
with a pool in every process, the pools' waiting threads take cores
from the other workers (six copies of one two-pass case at once took 61
s each with the default pool, 37 s with one thread).  Inference mode
skips autograd's bookkeeping on each of those ops, as chip_smoke.py's
plain checks do (a 48x40 encode and decode of 4 frames: 5.7 s, 3.7 s
under it).  Neither changes a result.  A module whose tests run port
code on threads of their own (the server's) does not take the fixture:
inference mode is per thread."""
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def plain_inference_mode():
    with torch.inference_mode():
        yield
