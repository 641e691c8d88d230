"""One torch intra-op thread for the port's tests.

Every ``tests/test_torch_*.py`` imports this module, so every process that
collects them (each xdist worker) runs torch on one thread from then on.
The tests' tensors are small, and the suite runs several workers on the
machine's cores: with torch's default of one thread a core, a worker's
threads mostly wait on one another and on the other workers'. The
subprocesses the tests start get one thread too: ``dist.spawn`` ranks by
its ``threads`` default, ``tests/test_torch_nojax.py``'s interpreters by
``OMP_NUM_THREADS=1``. The program's own thread settings are left alone.
"""

import torch

torch.set_num_threads(1)
