"""Test harness config: force CPU JAX with 8 virtual devices.

Multi-chip sharding paths are exercised on a virtual CPU mesh
(`xla_force_host_platform_device_count`), per SURVEY §4 carry-over notes.

Tests run on the local CPU (fast eager dispatch, virtual multi-device), so
the platform is pinned BEFORE jax is imported anywhere in the test session.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Pin at the config level too, in case jax was imported before this file.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compile cache: the suite compiles hundreds of program shapes;
# caching makes repeat runs far faster and shrinks the window for the rare
# in-process XLA-CPU compiler crash (observed as a segfault deep in
# backend_compile_and_load after ~1500 compilations in one process).
#
# The cache dir is keyed by a fingerprint of the host's CPU features: the
# XLA:CPU cache key does NOT include the target machine, so an entry AOT-
# compiled on a different host (these sandboxes migrate) loads with
# "machine type doesn't match" and can MIS-EXECUTE (observed: one spurious
# bit-parity failure; XLA logs warn "could lead to execution errors such
# as SIGILL").  A per-machine dir makes stale entries unreachable.
def _cpu_fingerprint() -> str:
    import hashlib

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha1(line.encode()).hexdigest()[:12]
    except OSError:
        pass
    import platform

    return hashlib.sha1(platform.processor().encode()).hexdigest()[:12]


_cache_dir = os.path.join(
    os.path.dirname(__file__), f".jax_test_cache_{_cpu_fingerprint()}"
)
jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_compiler_state():
    """Clear JAX's executable caches between test modules.

    A long pytest process accumulates thousands of compiled executables;
    around ~1500 compilations the in-process XLA CPU compiler has been
    observed to segfault (deep in backend_compile_and_load).  Dropping the
    caches per module bounds that state; the persistent on-disk cache keeps
    recompiles cheap.
    """
    yield
    jax.clear_caches()

# --- smoke suite ----------------------------------------------------------
# `pytest -m smoke` is the mandatory pre-commit gate (<60 s): one decisive
# slice of every layer — golden episodes, native engine steps, the headline
# parity episode, and one small parity episode per specials config.
_SMOKE_MODULES = (
    "test_golden_episodes.py",
    "test_engine_native.py",
)
_SMOKE_NODES = ("test_episode_parity_headline_config",)


def pytest_collection_modifyitems(config, items):
    for item in items:
        nid = item.nodeid
        if any(m in nid for m in _SMOKE_MODULES) or any(
            n in nid for n in _SMOKE_NODES
        ):
            item.add_marker(pytest.mark.smoke)
        elif "test_episode_parity_small" in nid:
            params = getattr(item, "callspec", None)
            if params is not None and params.params.get("seed") == 0:
                item.add_marker(pytest.mark.smoke)
