"""One intra-op thread for torch in the port's tests.

torch starts one intra-op thread a core in every process. The tier-1 run
holds several pytest workers at once, so on a machine of N cores each
worker's torch ops run N threads beside the other workers' and the cores
are oversubscribed many times over: a port file ran 5-7x its time alone.
The port's tests run small shapes, which gain little from threads, so
each worker keeps one. Every `tests/test_torch_*.py` imports this module
before it builds anything; the setting takes hold at collection, in each
worker. XLA's own thread pool is not affected. A subprocess a test starts
does not inherit the call: give it `OMP_NUM_THREADS=1` in its
environment (`ENV`).
"""

import os

import torch

torch.set_num_threads(1)

#: The environment for a subprocess that runs the port.
ENV = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
       "OMP_NUM_THREADS": "1"}
