"""Tabular Q-learning hyperparameter sweep.

Counterpart of the reference's `examples/q_learning.py:125-150` (400-combo
mp.Pool sweep on a 3x3x2 board).  Two modes:

* --device : the dense-table device-resident learner (train_dense) — each
  hyperparameter combo runs a whole batch of envs under jit.
* default  : host dict-table agent through the Gymnasium adapter (reference
  behaviour), parallelised with multiprocessing.  The workers run on the
  CPU: a JAX process reserves most of a GPU's memory when it first uses it,
  so only one process per card can.
"""

import argparse
import itertools
import json
import os

import numpy as np
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def execute_run(eps_decay_frac, gamma, lr, seed, num_episodes, out_root):
    from tile_match_tpu.envs.gym_env import TileMatchEnv
    from tile_match_tpu.models.q_learning import (
        QLearningAgent,
        save_results,
        train,
    )
    from tile_match_tpu.wrappers import ProportionRewardWrapper

    num_moves = 10
    eps_decay = int(num_episodes * num_moves * eps_decay_frac)
    env = ProportionRewardWrapper(
        TileMatchEnv(3, 3, 2, num_moves, [], [], seed=seed, rng_mode="threefry")
    )
    agent = QLearningAgent(
        lr=lr, epsilon_decay_dur=eps_decay, gamma=gamma,
        num_actions=env.unwrapped.num_actions,
        rng=np.random.default_rng(seed),
    )
    r, eff, obs_seen, agent = train(agent, env, num_episodes)
    out = os.path.join(
        out_root, f"gamma_{gamma}_lr_{lr}_eps_{eps_decay}_seed_{seed}"
    )
    save_results({"r": r, "eff_a": eff, "obs_seen": obs_seen,
                  "r_auc": float(np.trapezoid(r))}, out)
    print(json.dumps({"gamma": gamma, "lr": lr, "eps_decay": eps_decay,
                      "seed": seed, "auc": float(np.trapezoid(r))}))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--episodes", type=int, default=2000)
    p.add_argument("--device", action="store_true")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--out", type=str, default="results/qlearning")
    args = p.parse_args()

    lrs = [0.1, 0.25] if args.quick else [0.01, 0.1, 0.25, 0.5]
    eps_fracs = [0.3] if args.quick else [0.1, 0.3, 0.5, 0.7, 0.9]
    gammas = [0.9] if args.quick else [0.7, 0.8, 0.9, 0.95, 0.99]
    seeds = [1] if args.quick else [1, 2, 3, 4]

    if args.device:
        from tile_match_tpu.config import EnvConfig
        from tile_match_tpu.models.q_learning import train_dense

        cfg = EnvConfig(3, 3, 2, 10)
        for lr, gamma in itertools.product(lrs, gammas):
            q, rewards = train_dense(
                cfg, num_steps=args.episodes, batch_size=128, lr=lr,
                gamma=gamma,
            )
            print(json.dumps({
                "lr": lr, "gamma": gamma,
                "final_reward_mean": float(rewards[-100:].mean()),
            }))
        return

    params = list(itertools.product(eps_fracs, gammas, lrs, seeds))
    import multiprocessing as mp

    # Inherited by the workers before any of them imports JAX.
    os.environ["JAX_PLATFORMS"] = "cpu"
    with mp.get_context("spawn").Pool(min(mp.cpu_count(), 8)) as pool:
        pool.starmap(
            execute_run,
            [(e, g, l, s, args.episodes, args.out) for (e, g, l, s) in params],
        )


if __name__ == "__main__":
    main()
