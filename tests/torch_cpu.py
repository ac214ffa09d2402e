"""One torch thread per test process.

Every ``tests/test_torch_*.py`` imports this module before anything else.
The suite runs its files in several worker processes on one host; at the
tests' tiny sizes torch's intra-op threads buy nothing, and a pool of one
thread a core in every worker makes the workers wait on each other. The
environment variables carry the same setting into the CLI, serve and
torchrun subprocesses the tests start. A file run alone behaves as it does
in the suite.
"""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")

import torch  # noqa: E402

torch.set_num_threads(1)
