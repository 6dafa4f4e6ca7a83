"""Process fan-out for host work (BAM counting, SNP detection).

Workers start with the ``spawn`` method, so none inherits the parent's
threads or an initialised accelerator runtime; they run host code only and
never touch a JAX backend. ``n_jobs`` follows joblib's convention, which the
public ``joblib_n_jobs`` parameters keep for API parity: None or 1 runs
inline, -1 uses every CPU, -k all but k-1.
"""
from __future__ import annotations

import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, List, Optional, Sequence


def resolve_n_jobs(n_jobs: Optional[int]) -> int:
    """Worker count for a joblib-style ``n_jobs`` value."""
    if n_jobs is None or n_jobs == 0:
        return 1
    if n_jobs < 0:
        return max(1, (os.cpu_count() or 1) + 1 + n_jobs)
    return int(n_jobs)


def run_tasks(fn: Callable, tasks: Sequence[dict], n_jobs: Optional[int] = None,
              verbosity: int = 0) -> List:
    """``[fn(**task) for task in tasks]``, fanned out over spawned processes.

    Results keep the order of ``tasks``. ``fn`` and every argument must be
    picklable (``fn`` by import path). ``verbosity > 0`` prints one progress
    line per finished task to stderr.
    """
    n_workers = min(resolve_n_jobs(n_jobs), len(tasks))
    if n_workers <= 1:
        return [fn(**task) for task in tasks]
    context = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=n_workers, mp_context=context) as pool:
        futures = [pool.submit(fn, **task) for task in tasks]
        results = []
        for done, future in enumerate(futures, start=1):
            results.append(future.result())
            if verbosity > 0:
                print(f"[{fn.__name__}] {done}/{len(tasks)} tasks done",
                      file=sys.stderr, flush=True)
        return results
