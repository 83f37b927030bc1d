"""Static environment configuration.

Counterpart of the reference's constructor kwargs
(`/root/reference/src/tile_match_gym/tile_match_env.py:17-27` and
`/root/reference/src/tile_match_gym/board.py:42-51`).  The reference passes
feature flags around as lists of special-name strings; here they become a
frozen, hashable dataclass so the whole config is a *static* argument to
``jax.jit`` — every field participates in trace-time specialisation and the
compiled step function contains no data-dependent shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

# Tile-kind encoding — identical contract to the reference TILE_TYPES dict
# (`board.py:18-25`).  Channel conventions (`board.py:96-97`):
#   colour channel: 0 = colourless (empty cell or cookie), 1..num_colours
#   kind  channel : 0 empty, 1 normal, 2 vertical laser, 3 horizontal laser,
#                   4 bomb, -1 cookie.
KIND_EMPTY = 0
KIND_NORMAL = 1
KIND_V_LASER = 2
KIND_H_LASER = 3
KIND_BOMB = 4
KIND_COOKIE = -1

TILE_TYPES = {
    "empty": KIND_EMPTY,
    "normal": KIND_NORMAL,
    "vertical_laser": KIND_V_LASER,
    "horizontal_laser": KIND_H_LASER,
    "bomb": KIND_BOMB,
    "cookie": KIND_COOKIE,
}

_COLOURLESS_SPECIAL_NAMES = ("cookie",)
_COLOUR_SPECIAL_NAMES = ("vertical_laser", "horizontal_laser", "bomb")

# Internal match-kind codes used by the classification kernel.  These are an
# implementation detail of the new engine (the reference uses strings,
# `board.py:288-324`).
MATCH_NONE = 0
MATCH_NORMAL = 1
MATCH_V_LASER = 2
MATCH_H_LASER = 3
MATCH_BOMB = 4
MATCH_COOKIE = 5

MATCH_KIND_TO_TILE_KIND = {
    MATCH_V_LASER: KIND_V_LASER,
    MATCH_H_LASER: KIND_H_LASER,
    MATCH_BOMB: KIND_BOMB,
    MATCH_COOKIE: KIND_COOKIE,
}


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Frozen, hashable static config. Mirrors reference constructor args."""

    num_rows: int
    num_cols: int
    num_colours: int
    num_moves: int = 30
    # Feature flags — the reference's colourless_specials / colour_specials
    # lists (`board.py:47-48`); enabled specials alter match classification
    # (`board.py:287-325`).
    cookie: bool = True
    vertical_laser: bool = True
    horizontal_laser: bool = True
    bomb: bool = True

    # --- bounded-iteration caps (new-engine only; the reference uses
    # unbounded Python while loops, `board.py:102-109, 367-376, 381-391`) ---
    max_cascades: int = 64
    max_regen_iters: int = 256
    max_activation_steps: int = 0  # 0 → auto (derived from board size)
    max_lines: int = 0  # 0 → auto; override of lines_max (tests/debug)
    max_stack: int = 0  # 0 → auto; override of stack_max (tests/debug)

    # Static debug flag: when True the kernels emit ``checkify.check`` calls
    # at every capacity-cap truncation point (line-queue overflow, classify
    # append drop, activation stack overflow, activation step budget), so
    # silent truncation becomes an observable error.  Code containing these
    # checks must run under ``checkify.checkify`` (see ``debug.checked_step``).
    debug_checks: bool = False

    # ------------------------------------------------------------------
    # Constructors / derived sizes
    # ------------------------------------------------------------------
    @classmethod
    def create(
        cls,
        num_rows: int,
        num_cols: int,
        num_colours: int,
        num_moves: int = 30,
        colourless_specials: Sequence[str] = ("cookie",),
        colour_specials: Sequence[str] = (
            "vertical_laser",
            "horizontal_laser",
            "bomb",
        ),
        **kwargs,
    ) -> "EnvConfig":
        """Reference-style constructor taking special-name lists."""
        specials = set(colourless_specials) | set(colour_specials)
        unknown = specials - set(_COLOURLESS_SPECIAL_NAMES) - set(_COLOUR_SPECIAL_NAMES)
        if unknown:
            raise ValueError(f"Unknown specials: {sorted(unknown)}")
        return cls(
            num_rows=num_rows,
            num_cols=num_cols,
            num_colours=num_colours,
            num_moves=num_moves,
            cookie="cookie" in specials,
            vertical_laser="vertical_laser" in specials,
            horizontal_laser="horizontal_laser" in specials,
            bomb="bomb" in specials,
            **kwargs,
        )

    # Names of enabled specials, reference-style.
    @property
    def colourless_specials(self) -> Tuple[str, ...]:
        return ("cookie",) if self.cookie else ()

    @property
    def colour_specials(self) -> Tuple[str, ...]:
        out = []
        if self.vertical_laser:
            out.append("vertical_laser")
        if self.horizontal_laser:
            out.append("horizontal_laser")
        if self.bomb:
            out.append("bomb")
        return tuple(out)

    @property
    def any_special(self) -> bool:
        return self.cookie or self.vertical_laser or self.horizontal_laser or self.bomb

    @property
    def flat_size(self) -> int:
        return self.num_rows * self.num_cols

    @property
    def num_actions(self) -> int:
        # `board.py:77` — identical action count: all vertical + horizontal
        # adjacent swaps.
        return 2 * self.num_rows * self.num_cols - self.num_rows - self.num_cols

    # --- fixed capacities for masked, static-shape intermediates ---
    @property
    def line_len_max(self) -> int:
        """A detected line is a straight run; never longer than max(R, C)."""
        return max(self.num_rows, self.num_cols)

    @property
    def lines_max(self) -> int:
        """Capacity of the line queue in the classification machine.

        Primary lines are anchored in a single (lowest) row: at most C
        vertical + C//3 horizontal (~13 at 10x10).  Extension lines add at
        most a handful in practice; R+C is still generous (a 45-minute
        differential fuzz campaign plus the golden/parity suites never
        approached it), and the queue's size directly scales the while-carry
        the classification machine copies every pop, so over-provisioning is
        a real per-step cost.  Overflow is checked when ``debug_checks`` is
        set (`ops/lines.py`); ``max_lines`` overrides the cap (tests force
        overflow through it; raise it for adversarial board shapes).
        """
        return self.max_lines or (self.num_rows + self.num_cols)

    @property
    def match_coords_max(self) -> int:
        # A bomb match is one full line plus up to 3 coords from another
        # (`board.py:312`).
        return self.line_len_max + 3

    @property
    def matches_max(self) -> int:
        # classify emits <= one match per pop and pops <= 2*lines_max total
        # queue slots (`ops/classify.py`)
        return 2 * self.lines_max

    @property
    def stack_max(self) -> int:
        """Activation stack depth bound: one frame per live special + slack.

        Overflow (a push at a full stack) is checked when ``debug_checks`` is
        set (`ops/activate.py`); ``max_stack`` overrides the bound.
        """
        return self.max_stack or (self.flat_size + 8)

    @property
    def activation_steps_max(self) -> int:
        """Micro-step budget for one run of the activation machine.

        Each micro-step either (a) batch-deletes a contiguous normal segment
        and pushes a recursion frame, or (b) pops a frame.  Both are charged
        to a specific special, and each special contributes at most
        O(region-fragments) steps, so specials * (max region fragments) is a
        safe bound.
        """
        if self.max_activation_steps:
            return self.max_activation_steps
        return 4 * self.flat_size + 16
