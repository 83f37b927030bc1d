"""Device-resident ring replay buffer.

Transitions are stored compactly (raw int8 boards, not one-hot planes — a
100k-capacity buffer for 10x10 boards is ~25MB HBM) and encoded to network
inputs only at sample time.  Insertion and uniform sampling are pure
functions over the buffer PyTree, so the whole collect→store→sample→update
loop stays inside one jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import EnvConfig
from ..pytree import pytree_dataclass


@pytree_dataclass
class Replay:
    boards: jnp.ndarray  # i8[N, 2, R, C]
    moves: jnp.ndarray  # i8[N]
    actions: jnp.ndarray  # i32[N]
    rewards: jnp.ndarray  # f32[N]
    dones: jnp.ndarray  # bool[N]
    next_boards: jnp.ndarray  # i8[N, 2, R, C]
    next_moves: jnp.ndarray  # i8[N]
    next_eff: jnp.ndarray  # bool[N, A]
    ptr: jnp.ndarray  # i32
    size: jnp.ndarray  # i32


def replay_init(cfg: EnvConfig, capacity: int) -> Replay:
    R, C, A = cfg.num_rows, cfg.num_cols, cfg.num_actions
    return Replay(
        boards=jnp.zeros((capacity, 2, R, C), jnp.int8),
        moves=jnp.zeros((capacity,), jnp.int8),
        actions=jnp.zeros((capacity,), jnp.int32),
        rewards=jnp.zeros((capacity,), jnp.float32),
        dones=jnp.zeros((capacity,), bool),
        next_boards=jnp.zeros((capacity, 2, R, C), jnp.int8),
        next_moves=jnp.zeros((capacity,), jnp.int8),
        next_eff=jnp.zeros((capacity, A), bool),
        ptr=jnp.int32(0),
        size=jnp.int32(0),
    )


def replay_add(rb: Replay, batch: dict) -> Replay:
    """Insert a batch of B transitions at the ring pointer."""
    B = batch["actions"].shape[0]
    N = rb.boards.shape[0]
    idx = (rb.ptr + jnp.arange(B, dtype=jnp.int32)) % N
    return rb.replace(
        boards=rb.boards.at[idx].set(batch["boards"].astype(jnp.int8)),
        moves=rb.moves.at[idx].set(batch["moves"].astype(jnp.int8)),
        actions=rb.actions.at[idx].set(batch["actions"]),
        rewards=rb.rewards.at[idx].set(batch["rewards"]),
        dones=rb.dones.at[idx].set(batch["dones"]),
        next_boards=rb.next_boards.at[idx].set(
            batch["next_boards"].astype(jnp.int8)
        ),
        next_moves=rb.next_moves.at[idx].set(batch["next_moves"].astype(jnp.int8)),
        next_eff=rb.next_eff.at[idx].set(batch["next_eff"]),
        ptr=(rb.ptr + B) % N,
        size=jnp.minimum(rb.size + B, N),
    )


def replay_sample(rb: Replay, key, batch_size: int) -> dict:
    """Uniform sample of stored transitions (with replacement)."""
    idx = jax.random.randint(
        key, (batch_size,), 0, jnp.maximum(rb.size, 1), dtype=jnp.int32
    )
    return {
        "boards": rb.boards[idx].astype(jnp.int32),
        "moves": rb.moves[idx].astype(jnp.int32),
        "actions": rb.actions[idx],
        "rewards": rb.rewards[idx],
        "dones": rb.dones[idx],
        "next_boards": rb.next_boards[idx].astype(jnp.int32),
        "next_moves": rb.next_moves[idx].astype(jnp.int32),
        "next_eff": rb.next_eff[idx],
    }
