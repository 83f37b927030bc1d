"""Batched deep Q-learning on the native env — the framework's flagship model.

On-device replacement for the reference's SB3/QRDQN example
(`examples/qrdqn.py:15-40`, which trains a MultiInputPolicy on the Dict obs):
here the whole loop — env stepping, replay, epsilon-greedy action selection
with effective-action masking, Q-update — runs on device under one jit, with
the env batch data-parallel across devices and the network optionally
tensor-parallel (see ``parallel/`` and ``__graft_entry__``).
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import flax.linen as nn
import optax

from ..config import EnvConfig
from ..envs.batched import batched_reset, batched_step
from ..state import EnvState
from ..wrappers import one_hot_board


class QNetwork(nn.Module):
    """MLP over flattened one-hot planes + moves-left scalar.

    Hidden widths are multiples of 128; bfloat16 matmuls with f32
    accumulation.
    """

    num_actions: int
    hidden: int = 512

    @nn.compact
    def __call__(self, board_planes, moves_left):
        x = board_planes.reshape((board_planes.shape[0], -1))
        ml = (moves_left[:, None].astype(jnp.float32)) / 100.0
        x = jnp.concatenate([x, ml], axis=-1).astype(jnp.bfloat16)
        x = nn.Dense(self.hidden, dtype=jnp.bfloat16, name="dense1")(x)
        x = nn.relu(x)
        x = nn.Dense(self.hidden, dtype=jnp.bfloat16, name="dense2")(x)
        x = nn.relu(x)
        q = nn.Dense(self.num_actions, dtype=jnp.float32, name="head")(x)
        return q


class DQNState(NamedTuple):
    params: Any
    target_params: Any
    opt_state: Any
    env_states: EnvState
    obs_planes: jnp.ndarray  # f32[B, P, R, C]
    obs_moves: jnp.ndarray  # i32[B]
    eff_mask: jnp.ndarray  # bool[B, A]
    step_count: jnp.ndarray  # i32


def _encode(cfg, states: EnvState):
    boards = jnp.stack([states.colour, states.kind], axis=1)
    planes = jax.vmap(lambda b: one_hot_board(cfg, b))(boards)
    return planes, cfg.num_moves - states.timer


def make_dqn(
    cfg: EnvConfig,
    batch_size: int = 256,
    lr: float = 3e-4,
    gamma: float = 0.95,
    hidden: int = 512,
    target_period: int = 200,
    eps_start: float = 1.0,
    eps_end: float = 0.05,
    eps_decay_steps: int = 10_000,
):
    """Returns (init_fn, train_step_fn, act_fn).

    train_step: one env step for the whole batch + one Q-learning update on
    the freshly collected transitions (online DQN; no replay detour keeps the
    whole loop compiled and device-resident).
    """
    net = QNetwork(num_actions=cfg.num_actions, hidden=hidden)
    tx = optax.adam(lr)

    def init_fn(key) -> DQNState:
        key, k_env, k_net = jax.random.split(key, 3)
        env_states, ts = batched_reset(cfg, k_env, batch_size)
        planes, moves = _encode(cfg, env_states)
        params = net.init(k_net, planes, moves)
        return DQNState(
            params=params,
            target_params=params,
            opt_state=tx.init(params),
            env_states=env_states,
            obs_planes=planes,
            obs_moves=moves,
            eff_mask=ts.info.effective_actions,
            step_count=jnp.int32(0),
        )

    def act_fn(params, planes, moves, eff_mask, key, epsilon):
        q = net.apply(params, planes, moves)
        q_masked = jnp.where(eff_mask, q, -jnp.inf)
        any_eff = eff_mask.any(axis=-1)
        greedy = jnp.where(any_eff, jnp.argmax(q_masked, axis=-1), 0)
        k_eps, k_rand = jax.random.split(key)
        logits = jnp.where(eff_mask, 0.0, -jnp.inf)
        random_eff = jnp.where(
            any_eff,
            jax.random.categorical(k_rand, logits, axis=-1),
            0,
        )
        explore = jax.random.uniform(k_eps, greedy.shape) < epsilon
        return jnp.where(explore, random_eff, greedy).astype(jnp.int32)

    def loss_fn(params, target_params, batch):
        planes, moves, actions, rewards, dones, nplanes, nmoves, neff = batch
        q = net.apply(params, planes, moves)
        q_a = jnp.take_along_axis(q, actions[:, None], axis=-1)[:, 0]
        nq = net.apply(target_params, nplanes, nmoves)
        nq_masked = jnp.where(neff, nq, -jnp.inf)
        nq_max = jnp.where(neff.any(axis=-1), nq_masked.max(axis=-1), 0.0)
        target = rewards + gamma * (1.0 - dones) * nq_max
        td = q_a - jax.lax.stop_gradient(target)
        return jnp.mean(optax.huber_loss(td)), jnp.mean(jnp.abs(td))

    def train_step(state: DQNState, key):
        key, k_act = jax.random.split(key)
        frac = jnp.clip(state.step_count / eps_decay_steps, 0.0, 1.0)
        epsilon = eps_start + frac * (eps_end - eps_start)
        actions = act_fn(
            state.params, state.obs_planes, state.obs_moves, state.eff_mask,
            k_act, epsilon,
        )
        env_states, ts = batched_step(
            cfg, state.env_states, actions, eff_mask=state.eff_mask
        )
        nplanes, nmoves = _encode(cfg, env_states)
        # reward scale: proportional reward (`wrappers.py:71-77`)
        rewards = ts.reward / cfg.flat_size
        batch = (
            state.obs_planes,
            state.obs_moves,
            actions,
            rewards,
            ts.done.astype(jnp.float32),
            nplanes,
            nmoves,
            ts.info.effective_actions,
        )
        (loss, td), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.target_params, batch
        )
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        target_params = jax.tree.map(
            lambda p, t: jnp.where(
                state.step_count % target_period == 0, p, t
            ),
            params,
            state.target_params,
        )
        new_state = DQNState(
            params=params,
            target_params=target_params,
            opt_state=opt_state,
            env_states=env_states,
            obs_planes=nplanes,
            obs_moves=nmoves,
            eff_mask=ts.info.effective_actions,
            step_count=state.step_count + 1,
        )
        metrics = {
            "loss": loss,
            "td_abs": td,
            "reward_mean": rewards.mean(),
            "epsilon": epsilon,
        }
        return new_state, metrics

    return init_fn, train_step, act_fn


def train(
    cfg: EnvConfig,
    num_steps: int = 1000,
    batch_size: int = 256,
    seed: int = 0,
    log_every: int = 200,
    **kwargs,
):
    """Simple host loop over the jitted train step."""
    init_fn, train_step, _ = make_dqn(cfg, batch_size=batch_size, **kwargs)
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    state = init_fn(k_init)
    jstep = jax.jit(train_step)
    history = []
    for t in range(num_steps):
        key, k = jax.random.split(key)
        state, metrics = jstep(state, k)
        if (t + 1) % log_every == 0 or t == num_steps - 1:
            m = {k_: float(v) for k_, v in metrics.items()}
            m["step"] = t + 1
            history.append(m)
    return state, history
