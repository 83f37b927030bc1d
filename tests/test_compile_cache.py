"""Where the command-line entry points keep JAX's compile cache."""

import os
import subprocess
import sys

from tile_match_tpu import compile_cache

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_environment_variable_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.cache_dir() == str(tmp_path / "c")


def test_default_is_the_fixed_checkout_path(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    assert compile_cache.cache_dir() == os.path.join(_ROOT, ".jax_cache")


def test_enable_sets_jax_to_the_environment_directory(tmp_path):
    want = str(tmp_path / "cache")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=want)
    code = (
        "import jax\n"
        "from tile_match_tpu.compile_cache import enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=_ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [want, want]
    assert os.path.isdir(want)
