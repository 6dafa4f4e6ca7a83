"""Profiling helper: device traces.

The reference's only tool was a wall-clock Timer (demuxalot/utils.py:134);
on an accelerator the interesting signal is the XLA/Pallas trace (view in
TensorBoard or Perfetto). Peak rates for roofline shares live with the
benchmark (``bench.py``).
"""
from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace around a block of device work.

    Open the resulting directory with TensorBoard (profile plugin) or
    xprof. Example::

        with device_trace("/tmp/demux_trace"):
            Demultiplexer.predict_posteriors(...)
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
