"""Weak-scaling measurement over a device mesh.

Measures batched env-steps/s at dp = 1, 2, 4, ... devices with a fixed
per-device batch (weak scaling).  Without several devices, run it on a
virtual CPU mesh for the scaling *shape*:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/scaling.py --per-device-batch 64 --steps 8

On a machine with several GPUs the same script measures the real scaling.
"""

import argparse
import json
import time

import jax

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tile_match_tpu.config import EnvConfig
from tile_match_tpu.parallel.sharding import make_mesh, sharded_rollout


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=10)
    p.add_argument("--cols", type=int, default=10)
    p.add_argument("--colours", type=int, default=4)
    p.add_argument("--per-device-batch", type=int, default=256)
    p.add_argument("--steps", type=int, default=16)
    args = p.parse_args()

    cfg = EnvConfig(args.rows, args.cols, args.colours, 30)
    n = len(jax.devices())
    dps = [d for d in [1, 2, 4, 8, 16, 32] if d <= n]
    base_sps = None
    for dp in dps:
        mesh = make_mesh(jax.devices()[:dp], dp=dp, tp=1)
        B = args.per_device_batch * dp
        fn = sharded_rollout(cfg, mesh, global_batch=B, num_steps=args.steps)
        out = fn(jax.random.PRNGKey(0))
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        _, rew, stats = jax.block_until_ready(fn(jax.random.PRNGKey(1)))
        dt = time.perf_counter() - t0
        total = float(rew.sum())
        shard_max = [float(x) for x in stats["shard_max_trips"]]
        trips_sum = float(stats["trips_sum"])
        sps = B * args.steps / dt
        if base_sps is None:
            base_sps = sps
        # Per-shard executed trips (sum over steps of max-over-shard-boards):
        # at fixed per-device batch this should be ~independent of dp — each
        # shard's while_loop runs its own max, with no cross-shard coupling —
        # which is the analytic basis for ~linear weak scaling on real chips
        # (virtual CPU meshes share silicon, so wall-clock efficiency there
        # measures sharding overhead, not hardware scaling).
        print(
            json.dumps(
                {
                    "dp": dp,
                    "global_batch": B,
                    "steps_per_sec": round(sps, 1),
                    "scaling_efficiency": round(sps / (base_sps * dp), 3),
                    "total_reward": total,
                    "mean_trips_per_board_step": round(
                        trips_sum / (B * args.steps), 3
                    ),
                    "shard_max_trips_per_step": [
                        round(x / args.steps, 2) for x in shard_max
                    ],
                }
            )
        )


if __name__ == "__main__":
    main()
