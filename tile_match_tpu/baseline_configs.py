"""The five ``BASELINE.json`` configurations and the batch each runs at."""

from __future__ import annotations

from .config import EnvConfig

_COLOUR_SPECIALS = ("vertical_laser", "horizontal_laser", "bomb")

#: In ``BASELINE.json`` order: 5x5x3 and 10x10x4 without specials, 10x10x4
#: with colour specials, 10x10x4 with every special (the flagship), and
#: 20x20x6 with every special.
CONFIGS = (
    EnvConfig.create(5, 5, 3, 10, (), ()),
    EnvConfig.create(10, 10, 4, 30, (), ()),
    EnvConfig.create(10, 10, 4, 30, (), _COLOUR_SPECIALS),
    EnvConfig.create(10, 10, 4, 30, ("cookie",), _COLOUR_SPECIALS),
    EnvConfig.create(20, 20, 6, 100, ("cookie",), _COLOUR_SPECIALS),
)

#: Boards per batch for each config: starting sizes, not yet tuned on the GPU.
BATCHES = (32768, 16384, 16384, 16384, 8192)


def spec_label(cfg: EnvConfig) -> str:
    if not cfg.any_special:
        return "no_specials"
    return "full_specials" if cfg.cookie else "colour_specials"
