"""Batched effective-move mask.

Replaces the reference's per-action ``is_move_effective`` njit function
(`board.py:735-787`) — which is called O(num_actions) times per step from
``possible_move`` (`board.py:566-567`) and ``_get_effective_actions``
(`tile_match_env.py:122-123`) and dominates reference runtime — with ONE
gather + shifted-equality kernel producing the full bool[num_actions] mask.

Exact semantics replicated per action (coord1 above/left of coord2):
  * both coords special (kind ∉ {0,1})                      → effective
  * either coord a colourless special (kind < 0)            → effective
  * else swap, and look for any 3-run of equal colour inside the clipped
    window [min-2, max+2] around the swap, where the *last* cell of the run
    (rightmost / bottom) has kind >= 0 — including the reference's quirk of
    counting pre-existing runs in the window that don't involve the swap.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from ..config import EnvConfig
from ..state import action_table


@functools.lru_cache(maxsize=None)
def _window_tables(cfg: EnvConfig):
    """Static gather/compare tables, laid out **actions-on-lanes**.

    Each action's clipped 6x6 window is flattened to 36 positions and stored
    as column `a` of a [36, A] table, so the per-board gathered windows are
    [36, A] (A ≈ 2RC on the 128-lane axis) instead of [A, 6, 6] — the latter
    tiles as T(8,128) over the trailing 6x6 and pads 28x, which both blew HBM
    at large batch*scan and wasted >95% of every vector op.

    The 48 possible 3-runs inside a 6x6 window (24 horizontal + 24 vertical)
    become static index triples (a, b, c) into the 36 axis, with their
    validity (in-board and in the reference's clipped [min-2, max+2] window,
    `board.py:747-756`) precomputed per (triple, action).
    """
    R, C = cfg.num_rows, cfg.num_cols
    c1, c2 = action_table(cfg)
    A = len(c1)
    r_lo = np.minimum(c1[:, 0], c2[:, 0]) - 2
    c_lo = np.minimum(c1[:, 1], c2[:, 1]) - 2
    r_hi = np.maximum(c1[:, 0], c2[:, 0]) + 2
    c_hi = np.maximum(c1[:, 1], c2[:, 1]) + 2
    rows = r_lo[:, None, None] + np.arange(6)[None, :, None]
    cols = c_lo[:, None, None] + np.arange(6)[None, None, :]
    rows = np.broadcast_to(rows, (A, 6, 6))
    cols = np.broadcast_to(cols, (A, 6, 6))
    in_board = (rows >= 0) & (rows < R) & (cols >= 0) & (cols < C)
    in_win = (rows <= r_hi[:, None, None]) & (cols <= c_hi[:, None, None])
    valid = (in_board & in_win).reshape(A, 36)
    flat = (np.clip(rows, 0, R - 1) * C + np.clip(cols, 0, C - 1)).reshape(A, 36)

    # 3-run triples over the 6x6 window, as flat positions in 0..35.
    tri = []
    for i in range(6):
        for j in range(4):
            p = i * 6 + j
            tri.append((p, p + 1, p + 2))  # horizontal
    for i in range(4):
        for j in range(6):
            p = i * 6 + j
            tri.append((p, p + 6, p + 12))  # vertical
    tri = np.asarray(tri, np.int32)  # [48, 3]
    valid_tri = (
        valid[:, tri[:, 0]] & valid[:, tri[:, 1]] & valid[:, tri[:, 2]]
    ).T  # [48, A]

    flat1 = c1[:, 0] * C + c1[:, 1]
    flat2 = c2[:, 0] * C + c2[:, 1]
    n_down = C * (R - 1)

    # Selection matrix for the window gather as a matmul: board @ S (S
    # one-hot, [R*C, 36*A]) picks each action's 36 window cells.  Every
    # output is one tile value (colours <= 17, kinds -1..4), which bf16
    # holds exactly (integers below 256).
    sel = np.zeros((R * C, 36 * A), np.float32)
    flatT = flat.T  # [36, A]
    for w in range(36):
        sel[flatT[w], np.arange(A) + w * A] = 1.0
    # Swap-cell selectors, same trick: [R*C, A] one-hot columns.
    sel1 = np.zeros((R * C, A), np.float32)
    sel1[flat1, np.arange(A)] = 1.0
    sel2 = np.zeros((R * C, A), np.float32)
    sel2[flat2, np.arange(A)] = 1.0

    # NOTE: cache numpy, not jnp — device constants created inside one jit
    # trace must not leak into another.
    return (
        np.ascontiguousarray(flat.T.astype(np.int32)),  # [36, A]
        valid_tri,  # [48, A]
        tri,  # [48, 3]
        flat1.astype(np.int32),
        flat2.astype(np.int32),
        n_down,
        sel,
        sel1,
        sel2,
    )


def _swap_in_windows(w, n_down):
    """Exchange the two swapped cells inside each [36, A] window table.

    coord1 sits at window position (2,2)=14 for every action; coord2 at
    (3,2)=20 for down-swaps (the first n_down actions) and (2,3)=15 for
    right-swaps.
    """
    d14, d20 = w[14, :n_down], w[20, :n_down]
    r14, r15 = w[14, n_down:], w[15, n_down:]
    w = w.at[14].set(jnp.concatenate([d20, r15]))
    w = w.at[20, :n_down].set(d14)
    w = w.at[15, n_down:].set(r14)
    return w


def effective_mask(cfg: EnvConfig, colour, kind) -> jnp.ndarray:
    """bool[num_actions]: which swaps would do anything (`board.py:735-787`).

    The window "gather" runs as a one-hot selection matmul (board-vector x
    [R*C, 36*A] 0/1 matrix), exact in bf16 for the small integer tile
    values.
    """
    (
        _flat_np,
        valid_tri_np,
        tri_np,
        _f1,
        _f2,
        n_down,
        sel_np,
        sel1_np,
        sel2_np,
    ) = _window_tables(cfg)
    A = cfg.num_actions
    valid_tri = jnp.asarray(valid_tri_np)
    sel = jnp.asarray(sel_np, jnp.bfloat16)
    sel1 = jnp.asarray(sel1_np, jnp.bfloat16)
    sel2 = jnp.asarray(sel2_np, jnp.bfloat16)
    colf = colour.reshape(-1).astype(jnp.bfloat16)
    kinf = kind.reshape(-1).astype(jnp.bfloat16)

    k1 = (kinf @ sel1).astype(jnp.int32)
    k2 = (kinf @ sel2).astype(jnp.int32)
    both_special = ((k1 != 0) & (k1 != 1)) & ((k2 != 0) & (k2 != 1))
    any_cookie = (k1 < 0) | (k2 < 0)

    colw = _swap_in_windows(
        (colf @ sel).astype(jnp.int32).reshape(36, A), n_down
    )
    kinw = _swap_in_windows(
        (kinf @ sel).astype(jnp.int32).reshape(36, A), n_down
    )

    a, b, c = tri_np[:, 0], tri_np[:, 1], tri_np[:, 2]
    run3 = (
        (colw[a] == colw[b])
        & (colw[b] == colw[c])
        & valid_tri
        & (kinw[c] >= 0)
    )  # [48, A]
    win_match = jnp.any(run3, axis=0)
    return both_special | any_cookie | win_match


def possible_move(cfg: EnvConfig, colour, kind) -> jnp.ndarray:
    """``board.py:558-569`` — any action effective?"""
    return jnp.any(effective_mask(cfg, colour, kind))


def _pad_colour(colour, dr, dc):
    """colour shifted by (dr, dc), out-of-board cells = -1 (never matches)."""
    R, C = colour.shape
    p = jnp.pad(colour, 3, constant_values=-1)
    return p[3 + dr : 3 + dr + R, 3 + dc : 3 + dc + C]


def _pad_kind(kind, dr, dc):
    """kind shifted by (dr, dc); OOB value irrelevant (colour eq kills it)."""
    R, C = kind.shape
    p = jnp.pad(kind, 3, constant_values=1)
    return p[3 + dr : 3 + dr + R, 3 + dc : 3 + dc + C]


def effective_mask_settled(cfg: EnvConfig, colour, kind) -> jnp.ndarray:
    """bool[num_actions] — exact ``is_move_effective`` semantics **on
    line-free boards** (`board.py:735-787`), as ~20 shifted compares instead
    of the [R*C, 36*A] one-hot matmuls of :func:`effective_mask`.

    On a board with no existing >=3 run, any post-swap run inside the
    reference's clipped window must pass through a swapped cell (all other
    cells are unchanged) — and a run stencil containing BOTH swapped cells
    requires the two swapped colours to be equal, in which case the swap
    leaves the board unchanged and line-free, so such stencils can never
    fire.  That leaves, per swapped cell, the 3 perpendicular stencils and
    the 1 parallel stencil extending AWAY from the partner, all of whose
    other members hold their pre-swap values: 8 stencils per action, each a
    couple of shifted equality compares.

    The engine only ever *uses* the mask on line-free boards: the
    playability loop's exit requires ``~has_lines`` and its reroll/shuffle
    decision ignores the mask value while lines exist
    (`engine.make_playable`).  The adapter/parity path keeps the windowed
    kernel for arbitrary poked boards.  Equivalence on line-free boards
    (specials included) is asserted by tests/ops/test_effective_diff.py.

    Each stencil ANDs the *last* (rightmost/bottom) cell's kind >= 0 — the
    cookie-end quirk — using the post-swap kind when the last cell is a
    swapped cell, exactly as the window kernel does.
    """
    R, C = cfg.num_rows, cfg.num_cols
    col = colour
    kin = kind

    def sh(dr, dc):
        return _pad_colour(col, dr, dc)

    def shk(dr, dc):
        return _pad_kind(kin, dr, dc)

    def cell_terms(B, kB, dr, dc, away):
        """Stencils through the swapped cell at offset (dr, dc) holding
        post-swap colour ``B`` / post-swap kind ``kB``, excluding stencils
        containing the partner cell.  ``away``: the partner-free direction
        along the swap axis, 'up' / 'down' / 'left' / 'right'."""
        horiz = [
            # (dc-2, dc-1, dc): last cell is the swapped cell
            (sh(dr, dc - 2) == B) & (sh(dr, dc - 1) == B) & (kB >= 0),
            # (dc-1, dc, dc+1): last at dc+1
            (sh(dr, dc - 1) == B) & (sh(dr, dc + 1) == B)
            & (shk(dr, dc + 1) >= 0),
            # (dc, dc+1, dc+2): last at dc+2
            (sh(dr, dc + 1) == B) & (sh(dr, dc + 2) == B)
            & (shk(dr, dc + 2) >= 0),
        ]
        vert = [
            # (dr-2, dr-1, dr): last cell is the swapped cell
            (sh(dr - 2, dc) == B) & (sh(dr - 1, dc) == B) & (kB >= 0),
            # (dr-1, dr, dr+1): last at dr+1
            (sh(dr - 1, dc) == B) & (sh(dr + 1, dc) == B)
            & (shk(dr + 1, dc) >= 0),
            # (dr, dr+1, dr+2): last at dr+2
            (sh(dr + 1, dc) == B) & (sh(dr + 2, dc) == B)
            & (shk(dr + 2, dc) >= 0),
        ]
        if away == "up":  # vertical swap, partner below: only the up-run
            return horiz + [vert[0]]
        if away == "down":  # partner above: only the down-run
            return horiz + [vert[2]]
        if away == "left":  # horizontal swap, partner right: left-run
            return vert + [horiz[0]]
        return vert + [horiz[2]]  # partner left: right-run

    def special_terms(kA, kB):
        spec1 = (kA != 0) & (kA != 1)
        spec2 = (kB != 0) & (kB != 1)
        return (spec1 & spec2) | (kA < 0) | (kB < 0)

    def swap_mask(dr2, dc2, away1, away2):
        """bool[R, C] indexed by coord1 = (r, c); coord2 = (r+dr2, c+dc2)."""
        A = col  # coord1 pre-swap colour = coord2 post-swap colour
        B = sh(dr2, dc2)  # coord2 pre-swap colour = coord1 post-swap colour
        kA = kin
        kB = shk(dr2, dc2)
        terms = cell_terms(B, kB, 0, 0, away1) + cell_terms(
            A, kA, dr2, dc2, away2
        )
        m = terms[0]
        for t in terms[1:]:
            m = m | t
        if cfg.any_special:
            m = m | special_terms(kA, kB)
        return m

    down = swap_mask(1, 0, "up", "down")
    right = swap_mask(0, 1, "left", "right")

    return jnp.concatenate(
        [down[: R - 1, :].reshape(-1), right[:, : C - 1].reshape(-1)]
    )
