"""Torch's intra-op threads for the port's tests: the cores this process
may run on, shared out among the pytest-xdist workers that run beside
it, and at least one.

Every ``test_torch_*.py`` imports this module, directly or through
``torch_port_common``, so the rule holds in each worker, and under
``-p no:xdist`` too, before any test runs.  Without it each of ``n``
workers runs torch's default of one thread per core, ``n`` times more
threads than cores, and a test that takes a fraction of a second alone
takes minutes.  JAX-free: it imports only ``os`` and ``torch``.
"""
import os

import torch

torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
