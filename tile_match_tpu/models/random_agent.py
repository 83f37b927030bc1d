"""Random-policy baseline, batched on device.

Counterpart of the reference's random-agent harness
(`examples/random_agent.py:12-96`): per-episode returns and
effective-action counts, but for thousands of envs at once in one jitted
policy+step program; results are saved in the reference's JSON layout.
"""

from __future__ import annotations

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EnvConfig
from ..envs.batched import batched_reset, batched_step


@functools.lru_cache(maxsize=None)
def _fns(cfg: EnvConfig, batch_size: int, use_effective: bool):
    reset_fn = jax.jit(lambda k: batched_reset(cfg, k, batch_size))

    @jax.jit
    def step_fn(states, mask, key):
        key, ka = jax.random.split(key)
        if use_effective:
            logits = jnp.where(mask, 0.0, -jnp.inf)
            acts = jnp.where(
                mask.any(-1), jax.random.categorical(ka, logits, axis=-1), 0
            ).astype(jnp.int32)
        else:
            acts = jax.random.randint(ka, mask.shape[:1], 0, cfg.num_actions)
        states, ts = batched_step(cfg, states, acts, eff_mask=mask)
        n_eff = mask.sum(-1)
        return states, ts.info.effective_actions, ts.reward, ts.done, n_eff, key

    return reset_fn, step_fn


def run_random(
    cfg: EnvConfig,
    seed: int = 0,
    num_episodes: int = 1000,
    use_effective_actions: bool = False,
    batch_size: int = 256,
    proportion_reward: bool = True,
):
    """Returns (episode_returns, episode_effective_action_counts).

    Episodes are fixed length (num_moves) and auto-reset, so a T x B reward
    grid folds into episodes exactly; the effective-action count matches the
    reference's accounting (mask size summed over the pre-step obs of every
    step plus reset, `examples/random_agent.py:16-25`).
    """
    n_batches = -(-num_episodes // batch_size)
    reset_fn, step_fn = _fns(cfg, batch_size, use_effective_actions)
    all_returns = []
    all_eff = []
    key = jax.random.PRNGKey(seed)
    for b in range(n_batches):
        key, kr = jax.random.split(key)
        states, ts = reset_fn(kr)
        mask = ts.info.effective_actions
        rewards = []
        effs = [np.asarray(mask.sum(-1))]
        for t in range(cfg.num_moves):
            states, mask, r, done, n_eff, key = step_fn(states, mask, key)
            rewards.append(np.asarray(r))
            if t < cfg.num_moves - 1:
                effs.append(np.asarray(mask.sum(-1)))
        ret = np.stack(rewards).sum(0)
        if proportion_reward:
            ret = ret / cfg.flat_size
        all_returns.append(ret)
        all_eff.append(np.stack(effs).sum(0))
    returns = np.concatenate(all_returns)[:num_episodes]
    eff = np.concatenate(all_eff)[:num_episodes]
    return returns, eff


def save_results(results, output_dir):
    """Reference-compatible results.json (`examples/random_agent.py:45-56`)."""
    os.makedirs(output_dir, exist_ok=True)
    r, env_eff_a = results
    with open(os.path.join(output_dir, "results.json"), "w") as f:
        json.dump(
            {
                "r": np.asarray(r).tolist(),
                "env_num_effective_actions": np.asarray(env_eff_a).tolist(),
            },
            f,
        )


def run_random_baseline(
    num_episodes,
    num_rows,
    num_cols,
    num_colours,
    num_moves,
    use_effective_actions=False,
    output_root="results",
    seed=0,
    **env_kwargs,
):
    cfg = EnvConfig.create(
        num_rows, num_cols, num_colours, num_moves,
        env_kwargs.pop("colourless_specials", []),
        env_kwargs.pop("colour_specials", ["vertical_laser"]),
    )
    out = f"{output_root}/{num_rows}_{num_cols}_{num_colours}_{num_moves}_specials"
    if use_effective_actions:
        out += "_effective_actions"
    results = run_random(
        cfg, seed, num_episodes, use_effective_actions
    )
    save_results(results, out)
    return results
