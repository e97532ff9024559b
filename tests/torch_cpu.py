"""The port's tests run torch on one CPU thread.

Every ``tests/test_torch_*.py`` imports this module before any torch work
(``tests/test_torch_cpu_policy.py`` holds them to it).  On import it pins
torch's intra-op pool of this process to one thread and sets
``OMP_NUM_THREADS`` and ``MKL_NUM_THREADS`` to 1 for the processes it
starts: the CLI and import-check subprocesses and ``parallel.dryrun``'s
gloo ranks.

Why: the suite runs in several worker processes (``pytest -n 6``), and
torch's default is one thread per core in each of them.  On an 8-core host
six workers of 8 threads each kept 48 spinning OpenMP threads on 8 cores:
the suite took 973 s, one training test alone 466 s of it (5.6 s run by
itself), and four copies of ``test_torch_train_graph.py`` 850 s each
against 28 s each on one thread.  With one thread each the same suite took
147 s.  The tests' shapes are tiny and gain nothing from more threads.

One thread also fixes the summation order of the CPU's accumulating
scatters (``index_put_`` with ``accumulate=True``), which
``tests/test_torch_gather_grad.py`` holds bit-equal to a serial sum.

It needs nothing but ``os`` and ``torch``, so it also serves the card's
test files, run there with ``--noconftest``.  Every xdist worker imports
every test file while collecting, so the pin holds in each worker before
its first test, the JAX package's tests included.
"""

import os

import torch

os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
torch.set_num_threads(1)
