"""Tracing / profiling hooks + throughput CLI.

The reference's only performance artifact is a commented-out wall-clock probe
(`tests/test_wrappers.py:43-58`).  Here: a ``jax.profiler`` trace context
(XPlane traces viewable in XProf/TensorBoard) and a steps/s measurement
harness, exposed as a CLI:

    python -m tile_match_tpu.profiling --rows 10 --cols 10 --colours 4 \
        --batch 1024 --steps 32 [--trace /tmp/trace]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def trace(logdir: str | None):
    """jax.profiler trace context (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def measure_throughput(
    cfg,
    batch_size: int = 1024,
    num_steps: int = 32,
    reps: int = 3,
    seed: int = 0,
    logdir: str | None = None,
) -> dict:
    """steps/s of the jitted random-effective-policy batched step."""
    from .envs.batched import batched_reset, batched_step

    @jax.jit
    def step_random(states, mask, key):
        key, ka = jax.random.split(key)
        logits = jnp.where(mask, 0.0, -jnp.inf)
        acts = jnp.where(
            mask.any(-1), jax.random.categorical(ka, logits, axis=-1), 0
        ).astype(jnp.int32)
        states, ts = batched_step(cfg, states, acts, eff_mask=mask)
        return states, ts.info.effective_actions, ts.reward.sum(), key

    states, ts = jax.jit(lambda k: batched_reset(cfg, k, batch_size))(
        jax.random.PRNGKey(seed)
    )
    mask = ts.info.effective_actions
    key = jax.random.PRNGKey(seed + 1)
    states, mask, r, key = jax.block_until_ready(
        step_random(states, mask, key)
    )

    best, times = 0.0, []
    with trace(logdir):
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(num_steps):
                states, mask, r, key = step_random(states, mask, key)
            jax.block_until_ready((states, mask, r, key))
            dt = time.perf_counter() - t0
            times.append(dt)
            best = max(best, batch_size * num_steps / dt)
    return {
        "steps_per_sec": best,
        "batch_size": batch_size,
        "num_steps": num_steps,
        "times": times,
        "device": str(jax.devices()[0]),
    }


def main():
    from .compile_cache import enable_compile_cache
    from .config import EnvConfig

    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=10)
    p.add_argument("--cols", type=int, default=10)
    p.add_argument("--colours", type=int, default=4)
    p.add_argument("--moves", type=int, default=30)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--no-specials", action="store_true")
    p.add_argument("--trace", type=str, default=None, help="profiler logdir")
    args = p.parse_args()
    enable_compile_cache()
    cfg = EnvConfig(
        args.rows,
        args.cols,
        args.colours,
        args.moves,
        cookie=not args.no_specials,
        vertical_laser=not args.no_specials,
        horizontal_laser=not args.no_specials,
        bomb=not args.no_specials,
    )
    out = measure_throughput(
        cfg, args.batch, args.steps, args.reps, logdir=args.trace
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
