"""Elementary board operations as pure fixed-shape array transforms.

Counterparts of the reference's in-place mutators: ``swap_coords``
(`board.py:729-732`), ``gravity`` (`board.py:217-229`), ``refill``
(`board.py:231-241`), ``shuffle`` (`board.py:114-118`) and the row re-roll in
``remove_colour_lines`` (`board.py:126-130`).  Randomness is *injected* as
value grids so the same kernels serve both the native threefry path and the
numpy-bit-exact parity path (SURVEY §7, "ship both").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def swap_cells(colour, kind, coord1, coord2):
    """Swap both channels at two coordinates (`board.py:729-732`)."""
    r1, c1 = coord1[0], coord1[1]
    r2, c2 = coord2[0], coord2[1]

    def sw(ch):
        a = ch[r1, c1]
        b = ch[r2, c2]
        ch = ch.at[r1, c1].set(b)
        return ch.at[r2, c2].set(a)

    return sw(colour), sw(kind)


def gravity(colour, kind):
    """Push empty cells (both channels zero) to the top of each column.

    The reference does a per-column stable partition (`board.py:222-229`):
    zeros first (preserving order), then non-zeros (preserving order).  A
    stable argsort on the emptiness key reproduces this exactly, for all
    columns at once.
    """
    empty = (colour == 0) & (kind == 0)
    # Stable two-way partition via prefix sums: an empty cell at row r lands
    # at (number of empties above it); a tile lands at (total empties) +
    # (number of tiles above it).  The permutation is applied as a one-hot
    # multiply-reduce over the destination rows, without a scatter or
    # gather.
    n_empty = jnp.sum(empty, axis=0, keepdims=True)
    csum_e = jnp.cumsum(empty, axis=0)
    csum_t = jnp.cumsum(~empty, axis=0)
    dest = jnp.where(empty, csum_e - 1, n_empty + csum_t - 1)  # [R, C]
    R = colour.shape[0]
    out_rows = jax.lax.broadcasted_iota(jnp.int32, (R, R, 1), 0)
    hit = dest[None, :, :] == out_rows  # [R(out), R(src), C] permutation
    return (
        jnp.sum(hit * colour[None, :, :], axis=1),
        jnp.sum(hit * kind[None, :, :], axis=1),
    )


def apply_refill(colour, kind, fill_grid):
    """Replace empty cells with colours from ``fill_grid`` (kind becomes 1).

    `board.py:231-241`.  ``fill_grid`` is an i32[R,C] of colours in 1..K; in
    native mode it is drawn from threefry, in parity mode the host scatters
    the numpy draws (row-major over empty cells, matching numpy boolean
    assignment order) into the grid.
    """
    empty = (colour == 0) & (kind == 0)
    return (
        jnp.where(empty, fill_grid, colour),
        jnp.where(empty, jnp.ones_like(kind), kind),
    )


def num_empty(colour, kind):
    return jnp.sum((colour == 0) & (kind == 0))


def apply_shuffle(colour, kind, perm):
    """Permute both channels with one flat permutation (`board.py:114-118`)."""
    R, C = colour.shape
    rows = perm // C
    cols = perm % C
    rows = rows.reshape(R, C)
    cols = cols.reshape(R, C)
    return colour[rows, cols], kind[rows, cols]


def apply_reroll_rows(colour, bound_row, grid):
    """Overwrite the colour channel of rows 0..bound_row with ``grid`` rows.

    `board.py:126-130` (``remove_colour_lines``): the reference re-rolls *all*
    cells in those rows regardless of tile kind — including specials and
    cookies (a reference quirk we replicate for parity).  ``bound_row`` is
    dynamic; rows > bound_row keep their colours.
    """
    row_ids = jax.lax.broadcasted_iota(jnp.int32, colour.shape, 0)
    return jnp.where(row_ids <= bound_row, grid, colour)


def draw_colour_grid(key, cfg):
    """Native-mode uniform colour grid in 1..num_colours."""
    return jax.random.randint(
        key, (cfg.num_rows, cfg.num_cols), 1, cfg.num_colours + 1, dtype=jnp.int32
    )
