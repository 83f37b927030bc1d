"""Native batched environment: vmap-first, auto-resetting, scan-rollable.

This is the batched counterpart of running thousands of independent
reference envs (the reference is strictly one env per process,
`tile_match_env.py`): a batch of `EnvState`s stepped in lockstep under one
``jit``.  Independent boards ⇒ no intra-step communication; the batch shards
trivially across devices and hosts (see ``parallel/``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import EnvConfig
from ..engine import generate_board, reset, step
from ..pytree import pytree_dataclass
from ..state import EnvState, StepInfo


@pytree_dataclass
class TimeStep:
    obs_board: jnp.ndarray  # i32[B, 2, R, C]
    obs_moves_left: jnp.ndarray  # i32[B]
    reward: jnp.ndarray  # f32[B]
    done: jnp.ndarray  # bool[B]
    info: StepInfo  # batched


def batched_reset(cfg: EnvConfig, key, batch_size: int) -> Tuple[EnvState, TimeStep]:
    keys = jax.random.split(key, batch_size)
    states, infos = jax.vmap(lambda k: reset(cfg, k))(keys)
    ts = TimeStep(
        obs_board=jnp.stack([states.colour, states.kind], axis=1),
        obs_moves_left=jnp.full((batch_size,), cfg.num_moves, jnp.int32)
        - states.timer,
        reward=jnp.zeros((batch_size,), jnp.float32),
        done=jnp.zeros((batch_size,), bool),
        info=infos,
    )
    return states, ts


def batched_step(
    cfg: EnvConfig,
    states: EnvState,
    actions,
    auto_reset: bool = True,
    eff_mask=None,
) -> Tuple[EnvState, TimeStep]:
    """Step every board; optionally regenerate finished episodes in place.

    With ``auto_reset``, a done board is replaced by a freshly generated one
    (new episode, timer 0) and the returned observation is the new episode's
    first observation — the standard vectorised-env convention; the terminal
    reward/done refer to the finishing episode.

    ``eff_mask``: optional bool[B, A] — the previous TimeStep's
    ``info.effective_actions`` — to skip recomputing the pre-move mask.
    """
    # With auto_reset the post-step mask must describe the POST-RESET board
    # (the returned obs is the new episode's first obs), so the mask is
    # computed once after resets rather than inside step().
    if eff_mask is None:
        next_states, rewards, dones, infos = jax.vmap(
            lambda s, a: step(cfg, s, a, compute_post_mask=not auto_reset)
        )(states, actions)
    else:
        next_states, rewards, dones, infos = jax.vmap(
            lambda s, a, m: step(
                cfg, s, a, eff_mask=m, compute_post_mask=not auto_reset
            )
        )(states, actions, eff_mask)

    if auto_reset:
        # The per-step mask for live boards is already in infos (a by-product
        # of the playability loop inside step); only freshly regenerated
        # boards need theirs substituted — and generate_board hands it back.
        def maybe_reset(s: EnvState, d, m):
            def regen(op):
                s, m = op
                key, k = jax.random.split(s.key)
                colour, kind, key, mask, _gave_up = generate_board(cfg, k)
                return (
                    EnvState(colour=colour, kind=kind, timer=jnp.int32(0), key=key),
                    mask,
                )

            return jax.lax.cond(d, regen, lambda op: op, (s, m))

        # Batch-level gate: under vmap the per-board cond lowers to a select
        # that executes BOTH branches, so the full generate_board rejection
        # loop would run for every board on every step.  Episodes share the
        # same timer under auto-reset (all boards finish together every
        # num_moves steps), so gating on the batch-scalar any(done) makes
        # regeneration a real branch that executes ~1/num_moves of the time.
        next_states, post_mask = jax.lax.cond(
            dones.any(),
            lambda op: jax.vmap(maybe_reset)(op[0], dones, op[1]),
            lambda op: op,
            (next_states, infos.effective_actions),
        )
        infos = infos.replace(effective_actions=post_mask)

    ts = TimeStep(
        obs_board=jnp.stack([next_states.colour, next_states.kind], axis=1),
        obs_moves_left=cfg.num_moves - next_states.timer,
        reward=rewards.astype(jnp.float32),
        done=dones,
        info=infos,
    )
    return next_states, ts


def rollout(
    cfg: EnvConfig,
    key,
    batch_size: int,
    num_steps: int,
    policy=None,
    auto_reset: bool = True,
):
    """Scan a whole batched rollout on device.

    ``policy(key, ts) -> actions`` defaults to uniform-random *effective*
    actions (masked by ``info.effective_actions``).  Returns the final state
    plus stacked per-step (rewards, dones).
    """

    def random_effective(k, ts: TimeStep):
        mask = ts.info.effective_actions
        logits = jnp.where(mask, 0.0, -jnp.inf)
        # Boards with no effective action (done & not auto-reset) fall back
        # to action 0.
        any_eff = mask.any(axis=-1)
        acts = jax.random.categorical(k, logits, axis=-1)
        return jnp.where(any_eff, acts, 0).astype(jnp.int32)

    policy = policy or random_effective
    key, k0 = jax.random.split(key)
    states, ts0 = batched_reset(cfg, k0, batch_size)

    def body(carry, _):
        states, ts, key = carry
        key, ka = jax.random.split(key)
        actions = policy(ka, ts)
        states, ts = batched_step(
            cfg, states, actions, auto_reset=auto_reset,
            eff_mask=ts.info.effective_actions,
        )
        return (states, ts, key), (ts.reward, ts.done)

    (states, ts, _), (rewards, dones) = jax.lax.scan(
        body, (states, ts0, key), None, length=num_steps
    )
    return states, rewards, dones


class BatchedTileMatchEnv:
    """Thin OO facade over the functional batched API."""

    def __init__(self, cfg: EnvConfig, batch_size: int, auto_reset: bool = True):
        self.cfg = cfg
        self.batch_size = batch_size
        self.auto_reset = auto_reset
        self._reset = jax.jit(
            lambda key: batched_reset(cfg, key, batch_size)
        )
        self._step = jax.jit(
            lambda s, a: batched_step(cfg, s, a, auto_reset=auto_reset)
        )

    def reset(self, key):
        return self._reset(key)

    def step(self, states, actions):
        return self._step(states, actions)
