"""Shared device-timing discipline for the benchmark scripts.

Every device timing here ends in ``jax.block_until_ready`` (JAX returns
before the device finishes), is taken warm (the first call compiles and is
reported separately), and is summarized as the min and the median over
iterations. Kept in one place so every script measures the same way.
"""
import time

import jax
import numpy as np


def warm_time(fn, *args, iters: int = 5) -> dict:
    """Compile seconds plus min/median warm seconds of ``fn(*args)``."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    return {
        "first_call_s": compile_s,
        "min_s": min(samples),
        "median_s": float(np.median(samples)),
    }
