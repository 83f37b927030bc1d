"""Environment APIs: Gymnasium single-env adapter + native batched env.

``TileMatchEnv`` needs gymnasium, which is optional, so it is imported on
first use and the batched env imports without it.
"""

from .batched import BatchedTileMatchEnv

__all__ = ["TileMatchEnv", "BatchedTileMatchEnv"]


def __getattr__(name):
    if name == "TileMatchEnv":
        from .gym_env import TileMatchEnv

        return TileMatchEnv
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
