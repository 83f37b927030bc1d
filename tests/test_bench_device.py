"""bench.py measures a GPU; it runs on the CPU only when asked to."""

import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_bench(env):
    return subprocess.run(
        [sys.executable, "bench.py", "--config", "0"], cwd=_ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_bench_exits_non_zero_without_a_gpu():
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = _run_bench(env)
    assert out.returncode != 0
    assert "no GPU found" in out.stderr
    assert out.stdout.strip() == ""


def test_bench_runs_on_the_cpu_when_asked():
    env = dict(os.environ, JAX_PLATFORMS="cpu", TMT_BENCH_BATCH="16",
               TMT_BENCH_CHUNK="2", TMT_BENCH_STEPS="1", TMT_BENCH_REPS="1")
    env.pop("XLA_FLAGS", None)
    out = _run_bench(env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"metric": "env_steps_per_sec_5x5x3_no_specials_b16"' in out.stdout
