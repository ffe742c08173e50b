"""One thread budget for every pytest-xdist worker.

Under `pytest -n N` each worker is a process of its own, and each would
run torch's OpenMP pool (and MKL's) at one thread per core: N workers
then spin N times as many threads as the machine has cores, and most of
the suite's time goes to contention.  In a worker, this file gives each
process its share of the cores it may run on, max(1, cores // N), before
any test module imports torch: `OMP_NUM_THREADS` and `MKL_NUM_THREADS`
(a caller's own values win) and `torch.set_num_threads`.  Subprocesses a
test starts inherit the budget unless the test sets its own counts.

Outside xdist (a developer running one file) nothing is set, and a
process keeps every core.
"""
import os

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    _share = max(1, len(os.sched_getaffinity(0)) // int(_workers))
    _threads = os.environ.setdefault("OMP_NUM_THREADS", str(_share))
    os.environ.setdefault("MKL_NUM_THREADS", _threads)

    import torch

    torch.set_num_threads(int(_threads))
