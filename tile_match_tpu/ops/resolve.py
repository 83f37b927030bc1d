"""Match resolution: special-creation positions, tile elimination/activation,
special creation.

Counterpart of ``resolve_colour_matches`` (`board.py:397-427`),
``get_special_creation_pos`` (`board.py:429-458`), ``resolve_colour_match``
(`board.py:460-471`) and ``create_special`` (`board.py:572-597`), with the
recursive activation chains executed by the stack machine in ``activate.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import (
    EnvConfig,
    KIND_COOKIE,
    KIND_NORMAL,
    MATCH_COOKIE,
    MATCH_NORMAL,
)
from .activate import machine_init, machine_step, push_frame
from .classify import Matches
from .runs import BIG


def _match_union_mask(cfg: EnvConfig, matches: Matches):
    """bool[R, C]: union of all live match coordinates.

    Computed as a compare-any reduction against the flat cell index rather
    than a [MM*CM]-index scatter.
    """
    R, C = cfg.num_rows, cfg.num_cols
    MM, CM = matches.coords.shape[0], matches.coords.shape[1]
    jj = jnp.arange(CM, dtype=jnp.int32)[None, :]
    mm = jnp.arange(MM, dtype=jnp.int32)[:, None]
    live = (jj < matches.length[:, None]) & (mm < matches.count)
    ords = jnp.where(
        live,
        jnp.clip(matches.coords[..., 0], 0, R - 1) * C
        + jnp.clip(matches.coords[..., 1], 0, C - 1),
        -1,
    ).reshape(-1)  # [MM*CM]
    cell_ids = jnp.arange(R * C, dtype=jnp.int32)
    return jnp.any(ords[:, None] == cell_ids[None, :], axis=0).reshape(R, C)


def _resolve_all_normal(cfg: EnvConfig, colour, kind, matches: Matches):
    """No-specials fast path: delete every matched coordinate."""
    mask = _match_union_mask(cfg, matches)
    return (
        jnp.where(mask, 0, colour),
        jnp.where(mask, 0, kind),
        jnp.int32(0),
        jnp.int32(0),
        jnp.asarray(False),
    )


def _creation_pos(cfg: EnvConfig, match_coords, n, is_bomb, taken):
    """One match's special-creation coordinate (`board.py:429-458`).

    match_coords: i32[CM, 2]; n: live count; taken: bool[R, C].
    Straight matches take the middle (lower-middle when even) of the
    taken-filtered coords sorted ascending; bombs take the (mode-x, mode-y)
    corner if it is a valid coord, else the closest valid coord by squared
    distance with stable ties.
    """
    CM = cfg.match_coords_max
    R, C = cfg.num_rows, cfg.num_cols
    jj = jnp.arange(CM, dtype=jnp.int32)
    rr = jnp.clip(match_coords[:, 0], 0, R - 1)
    cc = jnp.clip(match_coords[:, 1], 0, C - 1)
    live = jj < n
    valid = live & ~taken[rr, cc]

    # --- straight: middle of valid coords ----------------------------------
    # Straight-match coords arrive ascending (line order, `lines.py`), so
    # "middle of sorted valid coords" is the k-th valid coord — selected via
    # cumsum+argmax instead of an argsort (sorts are the costly op in this
    # per-match pick loop).
    nv = jnp.sum(valid.astype(jnp.int32))
    pick = jnp.where(nv % 2 == 0, nv // 2 - 1, nv // 2)
    cum = jnp.cumsum(valid.astype(jnp.int32))
    sel_mid = valid & (cum == pick + 1)
    straight_pos = match_coords[jnp.argmax(sel_mid)]

    # --- bomb: mode corner then closest valid ------------------------------
    xs = match_coords[:, 0]
    ys = match_coords[:, 1]
    cnt_x = jnp.sum(
        (xs[None, :] == xs[:, None]) & live[None, :] & live[:, None], axis=1
    )
    cnt_y = jnp.sum(
        (ys[None, :] == ys[:, None]) & live[None, :] & live[:, None], axis=1
    )
    corner_x = xs[jnp.argmax(jnp.where(live, cnt_x, -1))]
    corner_y = ys[jnp.argmax(jnp.where(live, cnt_y, -1))]
    corner = jnp.stack([corner_x, corner_y])
    corner_valid = jnp.any(
        valid & (xs == corner_x) & (ys == corner_y)
    )
    d2 = (xs - corner_x) ** 2 + (ys - corner_y) ** 2
    dkey = jnp.where(valid, d2 * CM + jj, BIG)
    closest = match_coords[jnp.argmin(dkey)]
    bomb_pos = jnp.where(corner_valid, corner, closest)

    return jnp.where(is_bomb, bomb_pos, straight_pos)


def resolve_colour_matches(cfg: EnvConfig, colour, kind, matches: Matches):
    """Full resolution of one cascade iteration's matches.

    Returns (colour, kind, num_specials_activated_delta,
    num_new_specials_delta, ovf) — ``ovf`` is the activation machine's sticky
    truncation flag (a dropped stack frame; the phase-2 loop itself runs to
    completion).

    With every special disabled (static), resolution degenerates exactly to
    "delete the union of all match coordinates": no creation queue, no
    activation chains, no stats — so the whole driver/machine is skipped at
    trace time (classification emits only whole normal lines then, and the
    union of match coords equals the union of line coords).
    """
    if not cfg.any_special:
        return _resolve_all_normal(cfg, colour, kind, matches)
    R, C = cfg.num_rows, cfg.num_cols
    MM = matches.coords.shape[0]
    CM = cfg.match_coords_max

    # Per-match membership bitboards, computed once per resolution call:
    # mb[m, cell] ⟺ cell is one of match m's live coordinates.  They feed
    # the union fast-path mask AND the phase-2 scan below (gather-free).
    mm_ids = jnp.arange(MM, dtype=jnp.int32)
    jj_cm = jnp.arange(CM, dtype=jnp.int32)
    cell_ids = jnp.arange(R * C, dtype=jnp.int32)
    live_cm = (jj_cm[None, :] < matches.length[:, None]) & (
        mm_ids[:, None] < matches.count
    )
    ords_all = jnp.where(
        live_cm,
        jnp.clip(matches.coords[..., 0], 0, R - 1) * C
        + jnp.clip(matches.coords[..., 1], 0, C - 1),
        -1,
    )  # [MM, CM]
    mb = jnp.any(
        ords_all[:, :, None] == cell_ids[None, None, :], axis=1
    )  # [MM, R*C]

    # Per-board fast path: when no live match coordinate holds a special
    # tile, sequential resolution degenerates to "delete the union" (normals
    # have no side effects, so per-coord order is irrelevant), and the
    # phase-2 machine below contributes ZERO while-loop trips for this board
    # — under vmap the loop's trip count is the max over the batch, so boards
    # on the fast path no longer drag everyone through the machine.
    union = jnp.any(mb, axis=0).reshape(R, C)
    has_special_in_matches = jnp.any(
        union & (kind != 0) & (kind != KIND_NORMAL)
    )
    colour_fast = jnp.where(union, 0, colour)
    kind_fast = jnp.where(union, 0, kind)

    # ---- phase 1: pick special-creation positions (before any deletion,
    # `board.py:411-418`) ---------------------------------------------------
    # Only special matches pick a position; iterate over the k-th SPECIAL
    # match (via a rank lookup) instead of every match slot, so the loop's
    # vmap trip count is the worst board's special-match count (usually
    # 0-2) rather than its total match count.
    is_special_slot = (
        (mm_ids < matches.count)
        & (matches.mtype != MATCH_NORMAL)
        & (matches.mtype != 0)
    )  # [MM]
    tri_mm = mm_ids[:, None] >= mm_ids[None, :]  # [MM, MM]
    spec_rank = jnp.sum(
        tri_mm * is_special_slot.astype(jnp.int32)[None, :], axis=1
    )  # 1-based cumulative rank (triangular reduce: no reduce-window)
    n_special = spec_rank[-1] if MM > 0 else jnp.int32(0)

    def pick_body(k, carry):
        taken, q_r, q_c, q_ok = carry
        # slot of the (k+1)-th special match
        m = jnp.argmax(is_special_slot & (spec_rank == k + 1))
        pos = _creation_pos(
            cfg,
            matches.coords[m],
            matches.length[m],
            matches.mtype[m] == 4,  # MATCH_BOMB → not straight
            taken,
        )
        pr = jnp.clip(pos[0], 0, R - 1)
        pc = jnp.clip(pos[1], 0, C - 1)
        taken = taken.at[pr, pc].set(True)
        q_r = q_r.at[m].set(pr)
        q_c = q_c.at[m].set(pc)
        q_ok = q_ok.at[m].set(True)
        return taken, q_r, q_c, q_ok

    zi = jnp.zeros((MM,), jnp.int32)
    taken0 = jnp.zeros((R, C), bool)
    _, q_r, q_c, q_ok = jax.lax.fori_loop(
        0,
        n_special,
        pick_body,
        (taken0, zi, zi, jnp.zeros((MM,), bool)),
    )
    q_t = matches.mtype
    q_col = matches.mcolour

    # ---- phase 2: eliminate/activate, match by match, coord by coord
    # (`board.py:421-423` + `460-471`), via the activation machine ----------
    # The outer scan consumes ALL consecutive special-free matches in one
    # trip (their deletions are plain normal-cell removals that commute, so
    # batch-deleting them preserves the sequential semantics exactly), then
    # pushes the next special's activation frame.  Trip count becomes
    # O(#specials-in-matches + chain length) instead of O(#matches + ...).
    # Deletions are idempotent (already-empty cells), so a re-entered match
    # needs no coord-pointer bookkeeping: cells before the last activation
    # are empty and the special-mask lookup skips them naturally.

    def cond(carry):
        st, m, k = carry
        sp = st[-1]
        return (sp > 0) | (m < matches.count)

    def body(carry):
        st, m, k = carry
        sp = st[-1]

        def machine(args):
            st, m, k = args
            return machine_step(cfg, st), m, k

        def outer(args):
            st, m, k = args
            colour, kind = st[0], st[1]
            sp_flat = ((kind != 0) & (kind != KIND_NORMAL)).reshape(-1)
            alive_m = (mm_ids >= m) & (mm_ids < matches.count)
            has_sp = alive_m & jnp.any(mb & sp_flat[None, :], axis=1)
            exists = jnp.any(has_sp)
            ms = jnp.argmax(has_sp)  # first remaining match with a special
            msc = jnp.minimum(ms, MM - 1)
            row_ords = ords_all[msc]  # [CM]
            spv = jnp.any(
                (row_ords[:, None] == cell_ids[None, :]) & sp_flat[None, :],
                axis=1,
            )
            fs = jnp.where(exists, jnp.argmax(spv), 0)
            # delete: all coords of special-free matches before ms, plus
            # ms's list-prefix of normals before its first special
            del_rows = jnp.where(exists, alive_m & (mm_ids < ms), alive_m)
            dm = jnp.any(mb & del_rows[:, None], axis=0)
            prefix = jnp.any(
                (row_ords[:, None] == cell_ids[None, :])
                & (jj_cm < fs)[:, None]
                & exists,
                axis=0,
            )
            dmask = (dm | prefix).reshape(R, C)
            colour = jnp.where(dmask, 0, colour)
            kind = jnp.where(dmask, 0, kind)
            st = (colour, kind) + st[2:]
            fsc = jnp.minimum(fs, CM - 1)
            sr = jnp.clip(matches.coords[msc, fsc, 0], 0, R - 1)
            sc = jnp.clip(matches.coords[msc, fsc, 1], 0, C - 1)
            st = push_frame(
                st, kind[sr, sc], sr, sc, 1, pred=exists, idx=-1, fcolour=0
            )
            m2 = jnp.where(exists, ms, matches.count)
            k2 = jnp.where(exists, fs + 1, 0)
            return st, m2, k2

        return jax.lax.cond(sp > 0, machine, outer, (st, m, k))

    st0 = machine_init(cfg, colour, kind, 0)
    # Fast-path boards start with m = count → cond is False immediately.
    m0 = jnp.where(has_special_in_matches, 0, matches.count)
    (st, _, _) = jax.lax.while_loop(cond, body, (st0, m0, jnp.int32(0)))
    colour = jnp.where(has_special_in_matches, st[0], colour_fast)
    kind = jnp.where(has_special_in_matches, st[1], kind_fast)
    activated = st[2]
    ovf = has_special_in_matches & st[-2]

    # ---- phase 3: create the queued specials (`board.py:426-427`) ---------
    # Positions are unique (taken-set), so a one-hot multiply-reduce writes
    # them all at once, without a scatter.
    new_kind_code = jnp.where(q_t == MATCH_COOKIE, KIND_COOKIE, q_t)
    cell_ids = jnp.arange(R * C, dtype=jnp.int32)
    ordq = jnp.where(q_ok, q_r * C + q_c, -1)  # [MM]
    hit = ordq[:, None] == cell_ids[None, :]  # [MM, R*C] one-hot rows
    anyhit = jnp.any(hit, axis=0).reshape(R, C)
    hcol = jnp.sum(hit * q_col[:, None], axis=0).reshape(R, C)
    hkind = jnp.sum(hit * new_kind_code[:, None], axis=0).reshape(R, C)
    colour = jnp.where(anyhit, hcol, colour)
    kind = jnp.where(anyhit, hkind, kind)
    num_new = jnp.sum(q_ok.astype(jnp.int32))

    return colour, kind, activated, num_new, ovf
