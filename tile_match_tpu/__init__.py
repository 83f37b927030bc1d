"""tile_match_tpu — a JAX/XLA tile-matching environment engine with the
capabilities of ``tile-match-gym``, rebuilt from scratch as pure functional,
batched, shardable array programs.
"""

from .config import EnvConfig, TILE_TYPES
from .state import EnvState, StepInfo, action_table
from .engine import reset, step, observe

__version__ = "0.1.0"

__all__ = [
    "EnvConfig",
    "EnvState",
    "StepInfo",
    "TILE_TYPES",
    "action_table",
    "reset",
    "step",
    "observe",
]

# Gymnasium registration (`src/tile_match_gym/__init__.py:1-3` counterpart).
try:  # pragma: no cover - optional dependency
    from gymnasium.envs.registration import register, registry

    if "TileMatchTpu-v0" not in registry:
        register(
            id="TileMatchTpu-v0",
            entry_point="tile_match_tpu.envs.gym_env:TileMatchEnv",
        )
    # Drop-in id used by the reference, unless something already claimed it.
    if "TileMatch-v0" not in registry:
        register(
            id="TileMatch-v0",
            entry_point="tile_match_tpu.envs.gym_env:TileMatchEnv",
        )
except ImportError:  # pragma: no cover
    pass
