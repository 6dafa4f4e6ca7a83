"""Process set-up shared by the CLI and the benchmark scripts.

The accelerator is whatever JAX selects: ``JAX_PLATFORMS`` is honoured as
JAX honours it, and a run that asks for a platform JAX cannot find fails.
"""
from __future__ import annotations

import os
from pathlib import Path

# fixed, git-ignored, inside the checkout: a cache that moves never hits
DEFAULT_COMPILATION_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_compilation_cache() -> str:
    """Enable JAX's on-disk executable cache for this process; return its dir.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the cache and JAX reads it
    itself; otherwise the cache goes to :data:`DEFAULT_COMPILATION_CACHE_DIR`.
    Called by the CLI and the benchmark/entry scripts — the library itself
    never writes to disk implicitly. Every program is cached, however fast
    it compiled, so a warm rerun replays the whole pipeline.
    """
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = str(DEFAULT_COMPILATION_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir


def tune_numpy_allocator() -> None:
    """Disable numpy's MADV_HUGEPAGE on hosts where huge-page faults stall.

    numpy madvises transparent huge pages for every large buffer; on VMs
    where huge-page faults trigger synchronous compaction this makes each
    fresh allocation ~100x slower (measured here: 128 MB np.empty+fill
    6.7-14 s vs 0.06 s with the madvise off; raw malloc'd memory writes at
    ~2 GB/s either way). Host-side packing/layout at 4M calls dropped from
    ~53 s to ~2 s. Set ``DEMUX_NUMPY_HUGEPAGE=1`` to keep numpy's default.
    Uses the runtime setter so it works regardless of import order; the
    private API is absent on other numpy versions, in which case the env
    var (read at numpy import) is the only lever and we leave it alone.
    """
    if os.environ.get("DEMUX_NUMPY_HUGEPAGE") == "1":
        return
    try:
        try:
            from numpy._core import _multiarray_umath as _mu  # numpy >= 2
        except ImportError:
            from numpy.core import _multiarray_umath as _mu  # numpy 1.x

        _mu._set_madvise_hugepage(False)
    except Exception:
        pass
    _tune_glibc_malloc()


def _tune_glibc_malloc() -> None:
    """Serve large allocations from the persistent heap, not mmap/munmap.

    glibc hands every malloc above M_MMAP_THRESHOLD to mmap and unmaps it on
    free, so each multi-hundred-MB numpy buffer in the packing/layout path
    re-faults its whole extent — and minor-fault servicing on this VM is
    erratic (measured 0.5-3.6 s of stime for identical back-to-back work).
    Raising the mmap and trim thresholds keeps the pages in the heap across
    allocations of *different* sizes (numpy's own cache only helps repeats
    of the same size): measured 2x even on the warm same-size cycle, and it
    removes the multi-second outliers on mixed-size sequences. Costs RSS
    staying at the high-water mark — acceptable on this class of host.
    ``DEMUX_GLIBC_MALLOC_TUNE=0`` disables.
    """
    if os.environ.get("DEMUX_GLIBC_MALLOC_TUNE") == "0":
        return
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except Exception:
        pass
