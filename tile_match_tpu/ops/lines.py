"""Colour-line detection: fixed-shape equivalent of ``get_colour_lines``.

Reference semantics (`board.py:149-215`) reproduced exactly:

* Scan bottom-up; only lines anchored in the *lowest* matching row are
  primary: horizontal runs >=3 lying in that row, and vertical runs >=3 whose
  bottom cell is in that row (`board.py:158-193`).
* Within the row, lines are ordered by column, vertical before horizontal at
  the same column (`board.py:161-193` loop order).
* A secondary "extension" pass (`board.py:195-215`) adds, for every coordinate
  of a primary line, the maximal perpendicular/parallel same-colour segment
  through it, truncated at other primary coordinates, if >=3 long.  Each
  distinct primary cell contributes at most one horizontal and one vertical
  extension line (duplicates from the 4-direction loop collapse under the
  reference's sorted-dedup); emission order follows first occurrence in the
  primary coordinate list, horizontal before vertical.

The result is a fixed-capacity LineSet; every line is stored as an
ascending-sorted coordinate list (matching the reference's sorted lines).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import EnvConfig
from ..pytree import pytree_dataclass
from .runs import BIG, colour_run_extents, true_run_extents, _shift


@pytree_dataclass
class LineSet:
    coords: jnp.ndarray  # i32[LM, L, 2]; (-1, -1) padded
    length: jnp.ndarray  # i32[LM]; 0 for unused slots
    count: jnp.ndarray  # i32 scalar
    ovf: jnp.ndarray = False  # bool: detected lines exceeded lines_max


def get_colour_lines(cfg: EnvConfig, colour, kind) -> LineSet:
    R, C = cfg.num_rows, cfg.num_cols
    LM, L = cfg.lines_max, cfg.line_len_max
    del kind  # kind>0 ⟺ colour>0 on well-formed boards; detection uses colour.

    valid = colour > 0
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (R, C), 0)
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (R, C), 1)

    hs, _he, hl = colour_run_extents(colour, axis=1)
    vs, ve, vl = colour_run_extents(colour, axis=0)

    # --- primary row -------------------------------------------------------
    v_bottom3 = valid & (vl >= 3) & (ve == row_ids)
    h_in3 = valid & (hl >= 3)
    row_flag = jnp.any(h_in3, axis=1) | jnp.any(v_bottom3, axis=1)
    exists = jnp.any(row_flag)
    r0 = jnp.max(jnp.where(row_flag, jnp.arange(R, dtype=jnp.int32), -1))
    sr0 = jnp.maximum(r0, 0)

    cols = jnp.arange(C, dtype=jnp.int32)
    vflag = v_bottom3[sr0] & exists  # [C]
    vtop = vs[sr0]
    vlen = sr0 - vtop + 1
    hflag = h_in3[sr0] & (hs[sr0] == cols) & exists  # [C] (run starts)
    hstart = cols
    hlen = hl[sr0]

    # Pre-slots: 2c → vertical at column c, 2c+1 → horizontal starting at c.
    def interleave(a, b):
        return jnp.stack([a, b], axis=1).reshape(-1)

    pre_flag = interleave(vflag, hflag)  # [2C]
    pre_vert = interleave(jnp.ones((C,), bool), jnp.zeros((C,), bool))
    pre_fix = interleave(cols, jnp.full((C,), 0, jnp.int32) + sr0)
    pre_start = interleave(vtop, hstart)
    pre_len = interleave(vlen, hlen)
    slot_pos = jnp.cumsum(pre_flag.astype(jnp.int32)) - 1
    n_primary = jnp.sum(pre_flag.astype(jnp.int32))

    # --- primary membership & first-occurrence key -------------------------
    member_v = vflag[None, :] & (vtop[None, :] <= row_ids) & (row_ids <= sr0) & exists
    member_h = (row_ids == sr0) & h_in3 & exists
    primary = member_v | member_h
    key_v = jnp.where(member_v, (2 * col_ids) * L + (row_ids - vtop[None, :]), BIG)
    key_h = jnp.where(member_h, (2 * hs + 1) * L + (col_ids - hs), BIG)
    key = jnp.minimum(key_v, key_h)

    # --- extension segments ------------------------------------------------
    nonprim = ~primary

    def ext(axis, pos_ids):
        # toward higher index ("fwd"): neighbour must be non-primary and equal
        # to its predecessor → chained equality back to the generator cell.
        ok_fwd = nonprim & valid & (colour == _shift(colour, axis, 1, -1))
        _, te = true_run_extents(ok_fwd, axis)
        ok_next = _shift(ok_fwd, axis, -1, False)
        te_next = _shift(te, axis, -1, -1)
        fwd = jnp.where(ok_next, te_next - pos_ids, 0)
        # toward lower index ("bwd"): neighbour equal to its successor.
        ok_bwd = nonprim & valid & (colour == _shift(colour, axis, -1, -1))
        ts, _ = true_run_extents(ok_bwd, axis)
        ok_prev = _shift(ok_bwd, axis, 1, False)
        ts_prev = _shift(ts, axis, 1, BIG)
        bwd = jnp.where(ok_prev, pos_ids - ts_prev, 0)
        return bwd, fwd

    lext, rext = ext(1, col_ids)  # horizontal extension through each cell
    uext, dext = ext(0, row_ids)  # vertical extension

    is_gen = key < BIG
    h_ext_len = 1 + lext + rext
    v_ext_len = 1 + uext + dext
    cand_h = is_gen & (h_ext_len >= 3)
    cand_v = is_gen & (v_ext_len >= 3)
    ord_h = jnp.where(cand_h, 2 * key, BIG).reshape(-1)
    ord_v = jnp.where(cand_v, 2 * key + 1, BIG).reshape(-1)

    # Flatten candidate descriptors: (order, vert, fix, start, len).
    e_ord = jnp.concatenate([ord_h, ord_v])
    e_vert = jnp.concatenate(
        [jnp.zeros((R * C,), bool), jnp.ones((R * C,), bool)]
    )
    e_fix = jnp.concatenate([row_ids.reshape(-1), col_ids.reshape(-1)])
    e_start = jnp.concatenate(
        [(col_ids - lext).reshape(-1), (row_ids - uext).reshape(-1)]
    )
    e_len = jnp.concatenate([h_ext_len.reshape(-1), v_ext_len.reshape(-1)])

    n_ext_all = jnp.sum((e_ord < BIG).astype(jnp.int32))
    ovf = n_primary + n_ext_all > LM  # sticky-flag signal (StepInfo.truncated)
    if cfg.debug_checks:
        from jax.experimental import checkify

        checkify.check(
            ~ovf,
            "lines_max overflow: {n} detected lines exceed capacity {cap}",
            n=n_primary + n_ext_all,
            cap=jnp.int32(LM),
        )

    # Top-LM extension candidates by order key, materialised through one-hot
    # multiply-reduces instead of permutation gathers / index scatters.
    perm = jnp.argsort(e_ord)[:LM]
    oh_perm = (
        jnp.arange(e_ord.shape[0], dtype=jnp.int32)[None, :] == perm[:, None]
    ).astype(jnp.int32)  # [LM, 2RC]

    def sel(field):
        return jnp.sum(oh_perm * field.astype(jnp.int32)[None, :], axis=1)

    e_ord_s = sel(jnp.where(e_ord < BIG, e_ord, BIG))
    # dead entries sum the BIG sentinel exactly (one-hot rows have one 1)
    n_ext = jnp.sum((e_ord_s < BIG).astype(jnp.int32))
    ext_slot = n_primary + jnp.arange(LM, dtype=jnp.int32)
    ext_ok = (e_ord_s < BIG) & (ext_slot < LM)

    # --- materialise slot descriptors --------------------------------------
    p_idx = jnp.where(pre_flag, slot_pos, LM)
    e_idx = jnp.where(ext_ok, ext_slot, LM)
    slot_arange = jnp.arange(LM, dtype=jnp.int32)
    oh_p = (p_idx[None, :] == slot_arange[:, None]).astype(jnp.int32)  # [LM, 2C]
    oh_e = (e_idx[None, :] == slot_arange[:, None]).astype(jnp.int32)  # [LM, LM]

    def build(field_p, field_e):
        return jnp.sum(
            oh_p * field_p.astype(jnp.int32)[None, :], axis=1
        ) + jnp.sum(oh_e * field_e.astype(jnp.int32)[None, :], axis=1)

    d_vert = build(pre_vert, sel(e_vert)) > 0
    d_fix = build(pre_fix, sel(e_fix))
    d_start = build(pre_start, sel(e_start))
    d_len = build(pre_len * pre_flag, sel(e_len) * ext_ok)

    count = jnp.minimum(n_primary + n_ext, LM)
    slot_ids = jnp.arange(LM, dtype=jnp.int32)
    slot_live = slot_ids < count
    d_len = jnp.where(slot_live, d_len, 0)

    j = jnp.arange(L, dtype=jnp.int32)
    rr = jnp.where(d_vert[:, None], d_start[:, None] + j[None, :], d_fix[:, None])
    cc = jnp.where(d_vert[:, None], d_fix[:, None], d_start[:, None] + j[None, :])
    in_len = (j[None, :] < d_len[:, None]) & slot_live[:, None]
    coords = jnp.stack(
        [jnp.where(in_len, rr, -1), jnp.where(in_len, cc, -1)], axis=-1
    ).astype(jnp.int32)

    return LineSet(coords=coords, length=d_len, count=count, ovf=ovf)


def line_union_mask(cfg: EnvConfig, colour) -> jnp.ndarray:
    """bool[R, C]: the union of all cells of the lines ``get_colour_lines``
    would return — primary lowest-row lines plus their >=3 extension
    segments (`board.py:149-215`).

    With every special disabled, one cascade trip deletes exactly this set
    (classification emits whole normal lines, resolution deletes their
    union), so the no-specials cascade body needs ONLY this mask — no
    LineSet slots, no argsort, no classify machine, no one-hot
    materialisation.  ~30 small per-trip fusions collapse to ~10 vector
    ops, which is what makes the no-specials configs fast (see BENCH.md).

    Extension coverage runs as reach scans: a generator cell g (primary,
    extension length >=3) covers [g-lext, g+rext] in its row — a cell q is
    covered from the left iff cummax over generators g<=q of (g + rext_g)
    reaches q, and symmetrically from the right with a reverse cummin of
    (g - lext_g).  Reaches cannot leak across colour changes or primary
    cells because rext/lext count exactly the contiguous non-primary
    same-colour chain.
    """
    R, C = cfg.num_rows, cfg.num_cols
    valid = colour > 0
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (R, C), 0)
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (R, C), 1)

    _hs, _he, hl = colour_run_extents(colour, axis=1)
    vs, ve, vl = colour_run_extents(colour, axis=0)

    # primary lowest-row membership (as in get_colour_lines)
    v_bottom3 = valid & (vl >= 3) & (ve == row_ids)
    h_in3 = valid & (hl >= 3)
    row_flag = jnp.any(h_in3, axis=1) | jnp.any(v_bottom3, axis=1)
    exists = jnp.any(row_flag)
    r0 = jnp.max(jnp.where(row_flag, jnp.arange(R, dtype=jnp.int32), -1))
    sr0 = jnp.maximum(r0, 0)
    vflag = v_bottom3[sr0]  # [C]
    vtop = vs[sr0]  # [C]
    member_v = vflag[None, :] & (vtop[None, :] <= row_ids) & (row_ids <= sr0)
    member_h = (row_ids == sr0) & h_in3
    primary = (member_v | member_h) & exists

    # extension chain lengths through each primary cell (as in lines.ext)
    nonprim = ~primary

    def ext(axis, pos_ids):
        ok_fwd = nonprim & valid & (colour == _shift(colour, axis, 1, -1))
        _, te = true_run_extents(ok_fwd, axis)
        ok_next = _shift(ok_fwd, axis, -1, False)
        te_next = _shift(te, axis, -1, -1)
        fwd = jnp.where(ok_next, te_next - pos_ids, 0)
        ok_bwd = nonprim & valid & (colour == _shift(colour, axis, -1, -1))
        ts, _ = true_run_extents(ok_bwd, axis)
        ok_prev = _shift(ok_bwd, axis, 1, False)
        ts_prev = _shift(ts, axis, 1, BIG)
        bwd = jnp.where(ok_prev, pos_ids - ts_prev, 0)
        return bwd, fwd

    lext, rext = ext(1, col_ids)
    uext, dext = ext(0, row_ids)
    cand_h = primary & (1 + lext + rext >= 3)
    cand_v = primary & (1 + uext + dext >= 3)

    right_reach = jax.lax.cummax(
        jnp.where(cand_h, col_ids + rext, -1), axis=1
    )
    left_reach = jax.lax.cummin(
        jnp.where(cand_h, col_ids - lext, BIG), axis=1, reverse=True
    )
    cover_h = (right_reach >= col_ids) | (left_reach <= col_ids)
    down_reach = jax.lax.cummax(
        jnp.where(cand_v, row_ids + dext, -1), axis=0
    )
    up_reach = jax.lax.cummin(
        jnp.where(cand_v, row_ids - uext, BIG), axis=0, reverse=True
    )
    cover_v = (down_reach >= row_ids) | (up_reach <= row_ids)

    return primary | ((cover_h | cover_v) & valid)


def run_member_mask(cfg: EnvConfig, colour) -> jnp.ndarray:
    """bool[R, C]: cells belonging to ANY >=3 same-colour run (not just the
    lowest-row detected lines) — the native board-generation redraw target
    (`engine.make_playable.clear_lines`)."""
    valid = colour > 0
    _, _, hl = colour_run_extents(colour, axis=1)
    _, _, vl = colour_run_extents(colour, axis=0)
    return valid & ((hl >= 3) | (vl >= 3))


def first_line_info(cfg: EnvConfig, colour):
    """(has_lines, top_row_of_first_line) without materialising the LineSet.

    Used by the regenerate/playability loops, which only need
    ``lines[0][0][0]`` (`board.py:126-129`): the first detected line is always
    a primary one — vertical before horizontal at the same column — and its
    first coordinate is its topmost/leftmost cell.
    """
    R, C = cfg.num_rows, cfg.num_cols
    valid = colour > 0
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (R, C), 0)
    _hs, _he, hl = colour_run_extents(colour, axis=1)
    vs, ve, vl = colour_run_extents(colour, axis=0)
    v_bottom3 = valid & (vl >= 3) & (ve == row_ids)
    h_in3 = valid & (hl >= 3)
    row_flag = jnp.any(h_in3, axis=1) | jnp.any(v_bottom3, axis=1)
    exists = jnp.any(row_flag)
    r0 = jnp.max(jnp.where(row_flag, jnp.arange(R, dtype=jnp.int32), -1))
    sr0 = jnp.maximum(r0, 0)
    cols = jnp.arange(C, dtype=jnp.int32)
    vflag = v_bottom3[sr0]
    hflag = h_in3[sr0] & (_hs[sr0] == cols)
    pre_flag = jnp.stack([vflag, hflag], axis=1).reshape(-1)
    pre_top = jnp.stack([vs[sr0], jnp.full((C,), 0, jnp.int32) + sr0], axis=1).reshape(-1)
    first = jnp.argmax(pre_flag)
    top = jnp.where(exists, pre_top[first], jnp.int32(0))
    return exists, top


def has_any_line(cfg: EnvConfig, colour, kind) -> jnp.ndarray:
    """Cheap predicate: does any colour line (>=3 run) exist anywhere?

    Equivalent to ``len(get_colour_lines()) > 0`` — a line exists somewhere
    iff a >=3 run exists somewhere (the lowest-row restriction only limits
    *which* lines are returned, not whether any exist).
    """
    del kind
    valid = colour > 0
    _, _, hl = colour_run_extents(colour, axis=1)
    _, _, vl = colour_run_extents(colour, axis=0)
    return jnp.any(valid & ((hl >= 3) | (vl >= 3)))
