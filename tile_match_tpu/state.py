"""Environment state PyTree and the action↔coordinate table.

The reference keeps mutable state on a ``Board`` object (`board.py:41`); here
the full Markov state is an explicit immutable PyTree so that ``step`` is a
pure function usable under ``jit``/``vmap``/``shard_map`` and the state is
trivially checkpointable (SURVEY §5, checkpoint/resume).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .config import EnvConfig
from .pytree import pytree_dataclass


@pytree_dataclass
class EnvState:
    """Full per-environment Markov state.

    colour / kind: the two board channels (`board.py:96-97` contract).
    timer: moves taken this episode (`tile_match_env.py:88,100`).
    key: per-env threefry key (native RNG mode; unused in numpy-parity mode).
    """

    colour: jnp.ndarray  # i32[R, C]
    kind: jnp.ndarray  # i32[R, C]
    timer: jnp.ndarray  # i32 scalar
    key: jnp.ndarray  # uint32 PRNG key data

    @property
    def board(self) -> jnp.ndarray:
        """Reference-layout view: i32[2, R, C] (`board.py:96`)."""
        return jnp.stack([self.colour, self.kind], axis=0)


@pytree_dataclass
class StepInfo:
    """Batched counterpart of the reference info dict (`tile_match_env.py:103-109`)."""

    is_combination_match: jnp.ndarray  # bool
    num_new_specials: jnp.ndarray  # i32
    num_specials_activated: jnp.ndarray  # i32
    shuffled: jnp.ndarray  # bool
    effective_actions: jnp.ndarray  # bool[num_actions] mask
    # Sticky production-mode overflow flag (no reference counterpart): True
    # iff any capacity cap truncated this step — line queue, classify
    # append/emission, activation stack/step budget, cascade or regeneration
    # iteration cap.  The reference's structures are unbounded Python
    # lists/recursion; the caps are fuzz-sized to never fire in practice
    # (`config.py`), and this flag makes a cap ever firing observable
    # without ``debug_checks``/checkify overhead.
    truncated: jnp.ndarray = False  # bool
    # Cascade while_loop trips this step (0 for no-op moves).  Under vmap
    # each board reports its OWN trip count while the lockstep batch executes
    # the max over the batch — the gap between the two is the vmap
    # worst-case-serialisation cost, and per-shard maxima are what the
    # weak-scaling model needs (see parallel/sharding.py).
    cascade_trips: jnp.ndarray = 0  # i32


def action_table(cfg: EnvConfig) -> tuple[np.ndarray, np.ndarray]:
    """Static action → (coord1, coord2) table.

    Reproduces the exact enumeration order of `board.py:78-93`: the first
    C*(R-1) actions are down-swaps ((r,c),(r+1,c)) in row-major order; the
    remaining R*(C-1) are right-swaps ((r,c),(r,c+1)) in row-major order.
    This order is observable via effective-action indices
    (`tests/test_env.py:8,109` in the reference).
    """
    R, C = cfg.num_rows, cfg.num_cols
    c1 = []
    c2 = []
    for i in range(cfg.num_actions):
        if i < C * (R - 1):
            r, c = divmod(i, C)
            c1.append((r, c))
            c2.append((r + 1, c))
        else:
            j = i - C * (R - 1)
            r, c = divmod(j, C - 1)
            c1.append((r, c))
            c2.append((r, c + 1))
    return np.asarray(c1, dtype=np.int32), np.asarray(c2, dtype=np.int32)
