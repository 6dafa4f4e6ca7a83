"""Process set-up: the compile-cache location and the spawned worker pool."""
import os

import jax
import pytest

from demuxalot_tpu.utils import platform
from demuxalot_tpu.utils.parallel import resolve_n_jobs, run_tasks

_CACHE_OPTIONS = (
    "jax_compilation_cache_dir",
    "jax_persistent_cache_min_compile_time_secs",
    "jax_persistent_cache_min_entry_size_bytes",
)


@pytest.fixture
def restore_cache_config():
    saved = {name: getattr(jax.config, name) for name in _CACHE_OPTIONS}
    yield
    for name, value in saved.items():
        jax.config.update(name, value)


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compilation_cache_placement(monkeypatch, tmp_path, restore_cache_config, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins untouched; else one fixed in-checkout path."""
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(platform.DEFAULT_COMPILATION_CACHE_DIR)
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        jax.config.update("jax_compilation_cache_dir", want)  # as JAX reads it at start-up
    assert platform.enable_persistent_compilation_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    if env_dir is None:
        checkout = platform.DEFAULT_COMPILATION_CACHE_DIR.parent
        assert (checkout / "demuxalot_tpu").is_dir()
        # the same on every call: no pid, time or home directory in the name
        assert platform.enable_persistent_compilation_cache() == want
        assert want == str(checkout / ".jax_cache")


@pytest.mark.parametrize("n_jobs,want", [
    (None, 1), (0, 1), (1, 1), (3, 3),
    (-1, os.cpu_count() or 1), (-2, max(1, (os.cpu_count() or 1) - 1)),
])
def test_resolve_n_jobs_follows_joblib_convention(n_jobs, want):
    assert resolve_n_jobs(n_jobs) == want


def test_run_tasks_spawns_clean_workers():
    """Workers are spawned: fresh processes, no inherited JAX backend, order kept."""
    from jax._src import xla_bridge

    jax.devices()  # the parent holds an initialised backend
    assert xla_bridge.backends_are_initialized()
    tasks = [{"x": i} for i in range(5)]
    assert run_tasks(dict, tasks, n_jobs=2) == tasks
    assert run_tasks(dict, tasks, n_jobs=None) == tasks
    pids = run_tasks(os.getpid, [{} for _ in range(4)], n_jobs=2)
    assert os.getpid() not in pids
    assert run_tasks(xla_bridge.backends_are_initialized, [{}, {}], n_jobs=2) == [False, False]
