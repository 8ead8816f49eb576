"""Cap torch's CPU thread pool in the port's test modules.

Under ``pytest -n N`` every worker's torch would start one thread per
core, and N pools on the same cores make a small op wait on the others'
threads (a 0.03 ms call took ~40 ms under six busy workers). Each
``tests/test_torch_*.py`` imports this module, which gives a worker its
share of the cores: ``os.cpu_count() // N``, and all of them without
xdist.
"""
import os

import torch

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
