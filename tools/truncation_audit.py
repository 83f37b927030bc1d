"""Production truncation audit: run the batched step at an operating batch
and count sticky ``StepInfo.truncated`` flags (capacity-cap hits: cascade
cap, classify/activation slot caps, regen cap) over a random-effective
rollout.  A claim of no truncation holds only for the batches audited.

Usage:
  python tools/truncation_audit.py [--config N] [--batch B] [--steps S]
      [--json OUT.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--json", type=str, default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tile_match_tpu.baseline_configs import CONFIGS
    from tile_match_tpu.compile_cache import enable_compile_cache
    from tile_match_tpu.envs.batched import batched_reset, batched_step

    enable_compile_cache()
    cfg = CONFIGS[args.config]

    @jax.jit
    def run(key):
        key, k0 = jax.random.split(key)
        states, ts = batched_reset(cfg, k0, args.batch)
        mask = ts.info.effective_actions

        def body(carry, _):
            states, mask, key = carry
            key, ka = jax.random.split(key)
            logits = jnp.where(mask, 0.0, -jnp.inf)
            acts = jnp.where(
                mask.any(-1), jax.random.categorical(ka, logits, axis=-1), 0
            ).astype(jnp.int32)
            states, ts = batched_step(cfg, states, acts, eff_mask=mask)
            return (
                (states, ts.info.effective_actions, key),
                ts.info.truncated.sum(),
            )

        (_, _, _), truncs = jax.lax.scan(
            body, (states, mask, key), None, length=args.steps
        )
        return truncs.sum()

    total = int(jax.device_get(run(jax.random.PRNGKey(0))))
    result = {
        "config": args.config,
        "batch": args.batch,
        "steps": args.steps,
        "board_steps": args.batch * args.steps,
        "truncated_board_steps": total,
        "backend": jax.default_backend(),
    }
    print(json.dumps(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
